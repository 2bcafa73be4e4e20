"""ABCI gRPC transport — client + server.

The reference treats gRPC as a first-class out-of-process deployment
mode alongside the socket transport (ref: abci/client/grpc_client.go:1,
abci/server/grpc_server.go:1, service `tendermint.abci.ABCIApplication`
in proto/tendermint/abci/types.proto:474-491).

Implementation note: we use grpc's *generic* handler/stub API with our
own proto runtime (abci/proto.py) as the (de)serializer — no generated
stubs, and the bytes on the wire are the same field-number-compatible
messages the socket transport uses, minus the Request/Response oneof
wrapper (gRPC carries the method in the HTTP/2 path instead).
"""

from __future__ import annotations

import threading

try:
    import grpc
except ImportError:  # pragma: no cover - grpcio is in the base image
    grpc = None

from ..utils.grpcutil import GenericGrpcServer
from ..utils.grpcutil import require_grpc as _require_grpc
from ..utils.grpcutil import strip_scheme as _strip_scheme
from . import proto as apb
from .client import Client
from .types import Application

SERVICE = "tendermint.abci.ABCIApplication"

# method (snake, our dispatch key) <-> rpc name (reference service def)
_METHODS = {
    "echo": "Echo",
    "flush": "Flush",
    "info": "Info",
    "check_tx": "CheckTx",
    "query": "Query",
    "commit": "Commit",
    "init_chain": "InitChain",
    "list_snapshots": "ListSnapshots",
    "offer_snapshot": "OfferSnapshot",
    "load_snapshot_chunk": "LoadSnapshotChunk",
    "apply_snapshot_chunk": "ApplySnapshotChunk",
    "prepare_proposal": "PrepareProposal",
    "process_proposal": "ProcessProposal",
    "extend_vote": "ExtendVote",
    "verify_vote_extension": "VerifyVoteExtension",
    "finalize_block": "FinalizeBlock",
}
_RPC_TO_METHOD = {v: k for k, v in _METHODS.items()}

# method -> (inner RequestXPB, inner ResponseXPB), derived from the
# oneof wrapper field tables so the classes stay in one place.
_REQ_CLS = {f.name: f.msg_cls for f in apb.RequestPB.fields}
_RES_CLS = {f.name: f.msg_cls for f in apb.ResponsePB.fields}


class _AppHandler(grpc.GenericRpcHandler if grpc else object):
    """Routes /tendermint.abci.ABCIApplication/<Rpc> to the Application.

    Calls are serialized with one mutex, preserving the app's
    single-threaded execution model (same rule as the socket server and
    the reference's local client)."""

    def __init__(self, app: Application, logger=None):
        self._app = app
        self._mtx = threading.Lock()
        self._logger = logger

    def service(self, handler_call_details):
        service, _, rpc = handler_call_details.method.lstrip("/").partition("/")
        method = _RPC_TO_METHOD.get(rpc)
        if service != SERVICE or method is None:
            return None

        def unary(req_bytes, context, method=method):
            return self._dispatch(method, req_bytes, context)

        # No serializers: grpc hands us raw bytes; abci/proto.py is the codec.
        return grpc.unary_unary_rpc_method_handler(unary)

    def _dispatch(self, method: str, req_bytes: bytes, context) -> bytes:
        try:
            inner = _REQ_CLS[method].decode(req_bytes)
            _, dc = apb.request_from_pb(apb.RequestPB(**{method: inner}))
            if method == "echo":
                res = dc
            elif method == "flush":
                res = None
            else:
                with self._mtx:
                    if method == "commit":
                        # tmcheck: ok[lock-blocking] _mtx exists to serialize app calls (ABCI single-threaded contract)
                        res = self._app.commit()
                    else:
                        res = getattr(self._app, method)(dc)
            return getattr(apb.response_to_pb(method, res), method).encode()
        except Exception as e:  # noqa: BLE001 — surface app errors as RPC errors
            if self._logger is not None:
                self._logger.error("ABCI gRPC handler error", err=repr(e))
            context.abort(grpc.StatusCode.INTERNAL, repr(e))


class GRPCServer(GenericGrpcServer):
    """gRPC ABCI server for out-of-process apps
    (ref: abci/server/grpc_server.go)."""

    def __init__(self, app: Application, addr: str, logger=None):
        super().__init__(_AppHandler(app, logger), addr,
                         max_workers=4, what="ABCI gRPC server")


class GRPCClient(Client):
    """Engine-side client dialing a gRPC app
    (ref: abci/client/grpc_client.go). gRPC multiplexes concurrent
    unary calls over one HTTP/2 connection, so no client-side pipeline
    machinery is needed — the transport is the pipeline."""

    def __init__(self, addr: str, timeout: float = 30.0):
        _require_grpc()
        self._addr = _strip_scheme(addr)
        self._timeout = timeout
        self._channel = None
        self._stubs = {}

    def start(self) -> None:
        self._channel = grpc.insecure_channel(self._addr)
        grpc.channel_ready_future(self._channel).result(timeout=self._timeout)
        for method, rpc in _METHODS.items():
            self._stubs[method] = self._channel.unary_unary(f"/{SERVICE}/{rpc}")

    def stop(self) -> None:
        if self._channel is not None:
            self._channel.close()
            self._channel = None

    def _call(self, method: str, req):
        if self._channel is None:
            self.start()
        req_pb = getattr(apb.request_to_pb(method, req), method)
        try:
            res_bytes = self._stubs[method](req_pb.encode(), timeout=self._timeout)
        except grpc.RpcError as e:
            if e.code() == grpc.StatusCode.INTERNAL:
                # app-level exception: same surface as the socket
                # transport's Response.exception oneof
                raise apb.ABCIRemoteError(e.details()) from None
            raise
        res_pb = apb.ResponsePB(**{method: _RES_CLS[method].decode(res_bytes)})
        method2, dc = apb.response_from_pb(res_pb)
        assert method2 == method
        return dc

    def echo(self, message: str) -> str:
        return self._call("echo", message)

    def flush(self) -> None:
        self._call("flush", None)

    def info(self, req):
        return self._call("info", req)

    def query(self, req):
        return self._call("query", req)

    def check_tx(self, req):
        return self._call("check_tx", req)

    def init_chain(self, req):
        return self._call("init_chain", req)

    def prepare_proposal(self, req):
        return self._call("prepare_proposal", req)

    def process_proposal(self, req):
        return self._call("process_proposal", req)

    def extend_vote(self, req):
        return self._call("extend_vote", req)

    def verify_vote_extension(self, req):
        return self._call("verify_vote_extension", req)

    def finalize_block(self, req):
        return self._call("finalize_block", req)

    def commit(self):
        return self._call("commit", None)

    def list_snapshots(self, req):
        return self._call("list_snapshots", req)

    def offer_snapshot(self, req):
        return self._call("offer_snapshot", req)

    def load_snapshot_chunk(self, req):
        return self._call("load_snapshot_chunk", req)

    def apply_snapshot_chunk(self, req):
        return self._call("apply_snapshot_chunk", req)


def serve_app(app: Application, addr: str, logger=None) -> GRPCServer:
    """Start a gRPC ABCI server; returns it (caller stops it)."""
    srv = GRPCServer(app, addr, logger=logger)
    srv.start()
    return srv
