"""Shared helpers for the gRPC transports (abci/grpc.py, privval/grpc.py)."""

from __future__ import annotations

try:
    import grpc
except ImportError:  # pragma: no cover - grpcio is in the base image
    grpc = None


def require_grpc() -> None:
    if grpc is None:
        raise RuntimeError("grpcio is not available; use the socket transport")


def strip_scheme(addr: str) -> str:
    for scheme in ("grpc://", "tcp://"):
        if addr.startswith(scheme):
            return addr[len(scheme):]
    return addr


def listen_addr(requested: str, bound_port: int) -> str:
    """grpc://<host-as-requested>:<actual port> — keeps the bind host
    (0.0.0.0, a LAN IP, ...) instead of assuming loopback."""
    hostport = strip_scheme(requested)
    host = hostport.rsplit(":", 1)[0] if ":" in hostport else hostport
    return f"grpc://{host or '127.0.0.1'}:{bound_port}"


class GenericGrpcServer:
    """Shared server shell for the generic-bytes gRPC transports: bind,
    port-0 failure check, listen address, start/stop lifecycle. The
    transport supplies its GenericRpcHandler."""

    def __init__(self, handler, addr: str, max_workers: int = 4,
                 what: str = "gRPC server"):
        require_grpc()
        from concurrent import futures

        self._server = grpc.server(futures.ThreadPoolExecutor(max_workers=max_workers))
        self._server.add_generic_rpc_handlers((handler,))
        self._port = self._server.add_insecure_port(strip_scheme(addr))
        if self._port == 0:
            raise OSError(f"cannot bind {what} to {addr!r}")
        self._requested_addr = addr

    @property
    def listen_addr(self) -> str:
        return listen_addr(self._requested_addr, self._port)

    def start(self) -> None:
        self._server.start()

    def stop(self) -> None:
        self._server.stop(grace=0.5)
