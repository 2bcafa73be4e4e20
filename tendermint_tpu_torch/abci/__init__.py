"""The ABCI++ boundary (ref: abci/): the request and response types, the
Application interface, the in-process client, the kvstore example app,
and the socket and gRPC transports for an app in a process of its own
(abci/socket.py, abci/grpc.py, on the wire messages of abci/proto.py)."""

from .client import Client, LocalClient  # noqa: F401
from .types import Application, BaseApplication  # noqa: F401


def __getattr__(name):  # lazy: socket transport pulls in utils.log
    if name in ("SocketClient", "SocketServer", "serve_app"):
        from . import socket as _socket

        return getattr(_socket, name)
    raise AttributeError(name)
