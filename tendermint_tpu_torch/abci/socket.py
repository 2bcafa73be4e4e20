"""Out-of-process ABCI: socket server + async pipelined client.

ref: abci/client/socket_client.go:110-160 (pipelined request queue,
FIFO response matching, flush batching) and abci/server/socket_server.go
(per-connection read→handle→respond loop). Wire format: varint
length-delimited Request/Response protos (protoio), byte-compatible
with the reference's `tcp://` and `unix://` ABCI transports.

The client is synchronous per call but pipelined across callers: each
call enqueues a (method, event) pair, writes the request, and waits;
one reader thread matches responses FIFO — so concurrent callers (e.g.
mempool CheckTx under RPC load while consensus drives FinalizeBlock on
its own connection) keep multiple requests in flight, like the
reference's reqQueue.
"""

from __future__ import annotations

import socket
import threading
from collections import deque
from urllib.parse import urlparse

from ..utils.log import new_logger
from . import proto as apb
from . import types as abci
from .client import Client
from .types import Application

from ..utils.varint import encode_uvarint as _encode_uvarint
from ..utils.varint import read_uvarint

MAX_MESSAGE_SIZE = 64 << 20  # generous; snapshots chunk at ~16 MB


def _read_uvarint(sock_file) -> int:
    result, shift = 0, 0
    while True:
        b = sock_file.read(1)
        if not b:
            raise ConnectionError("ABCI connection closed")
        result |= (b[0] & 0x7F) << shift
        if not (b[0] & 0x80):
            return result
        shift += 7
        if shift > 63:
            raise ValueError("uvarint overflow")


def _read_raw(sock_file) -> bytes:
    size = _read_uvarint(sock_file)
    if size > MAX_MESSAGE_SIZE:
        raise ValueError(f"ABCI message too large: {size}")
    body = sock_file.read(size)
    if len(body) != size:
        raise ConnectionError("short read on ABCI connection")
    return body


def _read_msg(sock_file, cls):
    return cls.decode(_read_raw(sock_file))


def _parse_addr(addr: str):
    """'unix:///path' | 'tcp://host:port' -> (family, sockaddr)."""
    u = urlparse(addr)
    if u.scheme == "unix":
        return socket.AF_UNIX, (u.netloc + u.path)
    if u.scheme == "tcp":
        # port 0 means "bind an ephemeral port" — only a *missing* port
        # falls back to the conventional ABCI default 26658.
        port = u.port if u.port is not None else 26658
        return socket.AF_INET, (u.hostname or "127.0.0.1", port)
    raise ValueError(f"unsupported ABCI address {addr!r} (want tcp:// or unix://)")


class SocketServer:
    """Serves an Application over unix/tcp
    (ref: abci/server/socket_server.go). Requests on one connection are
    handled strictly in order; responses are written in the same order;
    app calls across connections serialize on one mutex, preserving the
    reference's single-threaded app execution model."""

    def __init__(self, app: Application, addr: str, logger=None):
        self.app = app
        self.addr = addr
        self.logger = logger or new_logger("abci-server")
        self._app_mtx = threading.Lock()
        self._listener: socket.socket | None = None
        self._stop = threading.Event()
        self._conns: list[socket.socket] = []
        self._lock = threading.Lock()
        # bumped on every accept: lets the disconnect-path reload detect
        # that a new connection raced in between "last conn gone" and
        # the reload actually running (lock order: _app_mtx -> _lock)
        self._accept_gen = 0

    def start(self) -> None:
        family, sockaddr = _parse_addr(self.addr)
        if family == socket.AF_UNIX:
            import os

            try:
                os.unlink(sockaddr)
            except FileNotFoundError:
                pass
        self._listener = socket.socket(family, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind(sockaddr)
        self._listener.listen(8)
        if family == socket.AF_INET:
            host, port = self._listener.getsockname()[:2]
            self.addr = f"tcp://{host}:{port}"
        threading.Thread(target=self._accept_loop, daemon=True, name="abci-accept").start()

    @property
    def listen_addr(self) -> str:
        return self.addr

    def stop(self) -> None:
        self._stop.set()
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
        with self._lock:
            for c in self._conns:
                try:
                    c.close()
                except OSError:
                    pass

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            # A connecting client is a (possibly restarted) node whose
            # handshake trusts Info: drop any FinalizeBlock effects whose
            # Commit never arrived, so replay decisions see only
            # persisted state. Only the FIRST connection (no live conns)
            # triggers the reload — a secondary client (debug/monitoring
            # tool) attaching while the primary node has a block in
            # flight must not clear pending effects mid-block.
            with self._lock:
                is_primary = not self._conns
                self._conns.append(conn)
                self._accept_gen += 1
            if is_primary:
                self._reload_app()
            threading.Thread(
                target=self._serve_conn, args=(conn,), daemon=True, name="abci-conn"
            ).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        """Per-connection read→handle→respond loop with RESPONSE
        COALESCING: requests are parsed out of a hand-rolled recv
        buffer, responses accumulate in the write buffer, and the flush
        happens only when the input runs dry — so a pipelined CheckTx
        flood of N requests costs O(N/window) send syscalls instead of
        one per response (the reference's flush-on-RequestFlush
        batching, without needing the client to send Flush frames). A
        blocking caller that sent ONE request still gets its response
        immediately: its single frame drains the buffer, triggering the
        flush before the next blocking recv."""
        if conn.family == socket.AF_INET:
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        wfile = conn.makefile("wb")
        buf = bytearray()
        pos = 0
        try:
            while not self._stop.is_set():
                # try to parse one complete length-prefixed frame; an
                # IndexError from the shared codec means the varint
                # itself is still incomplete — recv more
                frame = None
                try:
                    size, p = read_uvarint(buf, pos)
                except IndexError:
                    pass
                else:
                    if size > MAX_MESSAGE_SIZE:
                        raise ValueError(f"ABCI message too large: {size}")
                    if p + size <= len(buf):
                        frame = bytes(buf[p : p + size])
                        pos = p + size
                if frame is None:
                    # input dry: answer everything buffered, then block
                    wfile.flush()
                    data = conn.recv(65536)
                    if not data:
                        return
                    if pos:
                        del buf[:pos]
                        pos = 0
                    buf += data
                    continue
                # CheckTx fast path: a tx flood is tens of thousands of
                # these per second, and the generic codec's ~50us per
                # round dwarfs the app call; the hand-rolled pair is
                # byte-identical on the wire
                ctreq = apb.try_decode_check_tx_request(frame)
                if ctreq is not None:
                    try:
                        with self._app_mtx:
                            # tmcheck: ok[lock-blocking] _app_mtx exists to serialize app calls (ABCI single-threaded contract)
                            res = self.app.check_tx(ctreq)
                        body = apb.encode_check_tx_response(res)
                    except Exception as e:  # noqa: BLE001
                        self.logger.error("ABCI handler error", err=repr(e))
                        body = apb.ResponsePB(
                            exception=apb.ResponseExceptionPB(error=repr(e))
                        ).encode()
                else:
                    resp = self._handle(apb.RequestPB.decode(frame))
                    body = resp.encode()
                wfile.write(_encode_uvarint(len(body)) + body)
        except (ConnectionError, OSError, ValueError):
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass
            with self._lock:
                if conn in self._conns:
                    self._conns.remove(conn)
                now_idle = not self._conns
                gen = self._accept_gen
            # Last connection gone (the node died or detached): return
            # the app to its persisted state so the next handshake sees
            # only committed effects, whichever connection arrives first.
            # The generation re-check under _app_mtx prevents a stale
            # cleanup thread from firing AFTER a reconnected node has
            # already replayed onto the app (which would clobber its
            # in-flight block). Together with the accept-time reload
            # this leaves one racy window (reconnect lands BEFORE the
            # dead conn's cleanup decides idle); apps close it by making
            # FinalizeBlock replay idempotent, as KVStoreApplication
            # does.
            if now_idle and not self._stop.is_set():
                self._reload_app(if_gen=gen)

    def _reload_app(self, if_gen: int | None = None) -> None:
        reload = getattr(self.app, "reload_committed", None)
        if reload is None:
            return
        # _app_mtx serializes the reload against in-flight app calls;
        # no other path acquires _lock while holding _app_mtx, so the
        # _app_mtx -> _lock order here cannot deadlock.
        with self._app_mtx:
            if if_gen is not None:
                with self._lock:
                    if self._accept_gen != if_gen or self._conns:
                        return  # a new connection raced in; not idle
            try:
                reload()
            except Exception:
                pass

    def _handle(self, req: apb.RequestPB) -> apb.ResponsePB:
        try:
            method, dc = apb.request_from_pb(req)
            if method == "echo":
                return apb.response_to_pb("echo", dc)
            if method == "flush":
                return apb.response_to_pb("flush", None)
            with self._app_mtx:
                if method == "commit":
                    # tmcheck: ok[lock-blocking] _app_mtx exists to serialize app calls (ABCI single-threaded contract)
                    res = self.app.commit()
                else:
                    res = getattr(self.app, method)(dc)
            return apb.response_to_pb(method, res)
        except Exception as e:  # noqa: BLE001 — exceptions cross the wire
            self.logger.error("ABCI handler error", err=repr(e))
            return apb.ResponsePB(exception=apb.ResponseExceptionPB(error=repr(e)))


class SocketClient(Client):
    """Engine-side client dialing an external app
    (ref: abci/client/socket_client.go). Pipelined: writes go out under
    a short lock, responses are matched FIFO by a reader thread."""

    def __init__(self, addr: str, timeout: float = 30.0):
        self.addr = addr
        self.timeout = timeout
        self._sock: socket.socket | None = None
        self._wfile = None
        self._write_lock = threading.Lock()
        self._pending: deque = deque()  # (method, event-slot dict)
        self._pending_lock = threading.Lock()
        self._stopped = threading.Event()
        self._err: Exception | None = None

    # ------------------------------------------------------------ lifecycle

    def start(self) -> None:
        family, sockaddr = _parse_addr(self.addr)
        self._sock = socket.socket(family, socket.SOCK_STREAM)
        self._sock.settimeout(self.timeout)
        self._sock.connect(sockaddr)
        self._sock.settimeout(None)
        if family == socket.AF_INET:
            self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._rfile = self._sock.makefile("rb")
        self._wfile = self._sock.makefile("wb")
        threading.Thread(target=self._recv_loop, daemon=True, name="abci-client-recv").start()
        # connection sanity: echo roundtrip (ref: client handshake usage)
        got = self._call("echo", "ping")
        if got != "ping":
            raise ConnectionError(f"ABCI echo mismatch: {got!r}")

    def stop(self) -> None:
        self._stopped.set()
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass

    # ------------------------------------------------------------- plumbing

    def _recv_loop(self) -> None:
        try:
            while not self._stopped.is_set():
                raw = _read_raw(self._rfile)
                with self._pending_lock:
                    if not self._pending:
                        raise ConnectionError("unsolicited ABCI response")
                    method, slot = self._pending.popleft()
                try:
                    dc = None
                    if method == "check_tx":
                        # hand-rolled fast decode for the flood-path
                        # message; None (exception frame, unexpected
                        # oneof) falls back to the generic decoder
                        dc = apb.try_decode_check_tx_response(raw)
                    if dc is not None:
                        slot["result"] = dc
                    else:
                        kind, dc = apb.response_from_pb(apb.ResponsePB.decode(raw))
                        if kind != method:
                            raise ConnectionError(
                                f"ABCI response type mismatch: want {method}, got {kind}"
                            )
                        slot["result"] = dc
                except Exception as e:  # ABCIRemoteError or protocol error
                    slot["error"] = e
                slot["event"].set()
        except (ConnectionError, OSError, ValueError) as e:
            self._fail_all(e)

    def _fail_all(self, err: Exception) -> None:
        with self._pending_lock:
            # under the pending lock so the error slot and the queue
            # drain publish together: a submitter that got past the
            # fast-path _err check either lands in `pending` here and
            # is failed below, or sees _err set
            self._err = err
            pending, self._pending = list(self._pending), deque()
        for _method, slot in pending:
            slot["error"] = err
            slot["event"].set()

    @staticmethod
    def _encode_req(method: str, req) -> bytes:
        if method == "check_tx":
            return apb.encode_check_tx_request(req)  # byte-identical fast path
        return apb.request_to_pb(method, req).encode()

    def _submit(self, method: str, req) -> dict:
        """Write+flush one request; returns the response slot to wait
        on. Splitting submit from await is what lets callers keep
        several requests in flight on one connection."""
        if self._err is not None:
            raise ConnectionError(f"ABCI client failed: {self._err}")
        body = self._encode_req(method, req)
        slot = {"event": threading.Event(), "result": None, "error": None}
        with self._write_lock:
            # enqueue under the write lock so queue order == wire order
            with self._pending_lock:
                self._pending.append((method, slot))
            try:
                self._wfile.write(_encode_uvarint(len(body)) + body)
                self._wfile.flush()
            except (OSError, ValueError) as e:
                self._fail_all(e)
                raise ConnectionError(str(e))
        return slot

    def _await(self, method: str, slot: dict):
        if not slot["event"].wait(self.timeout):
            raise TimeoutError(f"ABCI {method} timed out after {self.timeout}s")
        if slot["error"] is not None:
            raise slot["error"]
        return slot["result"]

    def _call(self, method: str, req):
        return self._await(method, self._submit(method, req))

    def _submit_batch(self, method: str, reqs) -> list[dict]:
        """Pipeline a homogeneous batch: ALL requests hit the wire under
        one write-lock hold with ONE flush (the reference's reqQueue +
        flush batching, socket_client.go:110-160), so a 50k-tx CheckTx
        flood pays one syscall burst instead of one write+flush+RTT per
        tx. Responses are matched FIFO by the reader thread as usual."""
        if self._err is not None:
            raise ConnectionError(f"ABCI client failed: {self._err}")
        slots = []
        with self._write_lock:
            try:
                for req in reqs:
                    body = self._encode_req(method, req)
                    slot = {"event": threading.Event(), "result": None, "error": None}
                    with self._pending_lock:
                        self._pending.append((method, slot))
                    self._wfile.write(_encode_uvarint(len(body)) + body)
                    slots.append(slot)
                self._wfile.flush()
            except (OSError, ValueError) as e:
                self._fail_all(e)
                raise ConnectionError(str(e))
        return slots

    def check_tx_batch(self, reqs):
        slots = self._submit_batch("check_tx", reqs)
        return [self._await("check_tx", s) for s in slots]

    # --------------------------------------------------------------- calls

    def echo(self, message: str) -> str:
        return self._call("echo", message)

    def flush(self) -> None:
        self._call("flush", None)

    def info(self, req: abci.RequestInfo):
        return self._call("info", req)

    def query(self, req: abci.RequestQuery):
        return self._call("query", req)

    def check_tx(self, req: abci.RequestCheckTx):
        return self._call("check_tx", req)

    def init_chain(self, req: abci.RequestInitChain):
        return self._call("init_chain", req)

    def prepare_proposal(self, req: abci.RequestPrepareProposal):
        return self._call("prepare_proposal", req)

    def process_proposal(self, req: abci.RequestProcessProposal):
        return self._call("process_proposal", req)

    def extend_vote(self, req: abci.RequestExtendVote):
        return self._call("extend_vote", req)

    def verify_vote_extension(self, req: abci.RequestVerifyVoteExtension):
        return self._call("verify_vote_extension", req)

    def finalize_block(self, req: abci.RequestFinalizeBlock):
        return self._call("finalize_block", req)

    def commit(self):
        return self._call("commit", None)

    def list_snapshots(self, req: abci.RequestListSnapshots):
        return self._call("list_snapshots", req)

    def offer_snapshot(self, req: abci.RequestOfferSnapshot):
        return self._call("offer_snapshot", req)

    def load_snapshot_chunk(self, req: abci.RequestLoadSnapshotChunk):
        return self._call("load_snapshot_chunk", req)

    def apply_snapshot_chunk(self, req: abci.RequestApplySnapshotChunk):
        return self._call("apply_snapshot_chunk", req)


def serve_app(app: Application, addr: str) -> SocketServer:
    """Convenience: start a socket server for `app` (the reference's
    `abci-cli kvstore`-style entry; used by `python -m
    tendermint_tpu_torch.abci.socket`)."""
    srv = SocketServer(app, addr)
    srv.start()
    return srv


def main(argv=None) -> int:
    """Run the builtin kvstore app as an external ABCI process:
    python -m tendermint_tpu_torch.abci.socket --addr tcp://127.0.0.1:26658"""
    import argparse
    import time

    from .kvstore import KVStoreApplication

    ap = argparse.ArgumentParser()
    ap.add_argument("--addr", default="tcp://127.0.0.1:26658")
    ap.add_argument("--snapshot-interval", type=int, default=0)
    args = ap.parse_args(argv)
    app = KVStoreApplication(snapshot_interval=args.snapshot_interval)
    if args.addr.startswith("grpc://"):
        from .grpc import serve_app as serve_grpc

        srv = serve_grpc(app, args.addr)
    else:
        srv = serve_app(app, args.addr)
    print(f"ABCI kvstore listening on {srv.listen_addr}", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        srv.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
