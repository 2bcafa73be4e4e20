"""JSON-RPC service (ref: rpc/ + internal/rpc/).

A copy of the JAX package's rpc/: the same routes, JSON and wire; a
verifier fault met by a route is an internal error that halts the node
(rpc/core.py)."""

from .server import JSONRPCServer, RPCError
from .core import RPCEnvironment, build_routes

__all__ = ["JSONRPCServer", "RPCEnvironment", "RPCError", "build_routes"]
