"""JSON-RPC 2.0 server over HTTP POST, GET-URI, and WebSocket
(ref: rpc/jsonrpc/server/).

Routes map method names to handler callables taking keyword args
(the reference's reflection-based RPCFunc, rpc/jsonrpc/server/rpc_func.go).
The WebSocket endpoint additionally supports `subscribe`/`unsubscribe`,
pushing matching events to the client as JSON-RPC notifications.
"""

from __future__ import annotations

import base64
import hashlib
import json
import queue
import socket
import struct
import threading
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qsl, urlparse

_WS_MAGIC = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"

# JSON-RPC error codes (rpc/jsonrpc/types/types.go)
ERR_PARSE = -32700
ERR_INVALID_REQUEST = -32600
ERR_METHOD_NOT_FOUND = -32601
ERR_INVALID_PARAMS = -32602
ERR_INTERNAL = -32603


class RPCError(Exception):
    def __init__(self, code: int, message: str, data: str | None = None):
        super().__init__(message)
        self.code = code
        self.message = message
        self.data = data


def _rpc_response(id_, result=None, error: RPCError | None = None) -> dict:
    resp = {"jsonrpc": "2.0", "id": id_}
    if error is not None:
        resp["error"] = {"code": error.code, "message": error.message}
        if error.data:
            resp["error"]["data"] = error.data
    else:
        resp["result"] = result
    return resp


class _WebSocketConnection:
    """Minimal RFC-6455 server-side connection (ref: gorilla/websocket
    usage in rpc/jsonrpc/server/ws_handler.go).

    Writes go through a bounded per-connection queue drained by one
    writer thread — subscription pushers never block on a slow client's
    socket. When the queue overflows, the connection is terminated, the
    reference's slow-consumer policy (ws_handler.go writeChan: a client
    that cannot keep up with its subscriptions is disconnected rather
    than allowed to stall the event pipeline)."""

    SEND_QUEUE_SIZE = 512
    _SENTINEL = object()

    def __init__(self, sock: socket.socket):
        self.sock = sock
        # live subscription queries, maintained by JSONRPCServer under
        # its lock: tracking the actual set (not a counter) means bogus
        # unsubscribes cannot drive the count below the number of real
        # live subscriptions and bypass max_subscriptions_per_client
        self.sub_queries: set[str] = set()
        self._send_lock = threading.Lock()
        self.closed = threading.Event()
        self._out: queue.Queue = queue.Queue(maxsize=self.SEND_QUEUE_SIZE)
        self.dropped_for_backpressure = False
        self._writer = threading.Thread(target=self._write_pump, daemon=True, name="ws-writer")
        self._writer.start()

    def send_json(self, obj) -> None:
        self.send_text(json.dumps(obj))

    def send_text(self, text: str) -> None:
        if self.closed.is_set():
            return
        try:
            self._out.put_nowait(text.encode())
        except queue.Full:
            # Slow consumer: terminate instead of stalling the pushers.
            self.dropped_for_backpressure = True
            self.close()

    def _write_pump(self) -> None:
        while True:
            item = self._out.get()
            if item is self._SENTINEL or self.closed.is_set():
                return
            payload = item
            header = bytearray([0x81])  # FIN + text
            n = len(payload)
            if n < 126:
                header.append(n)
            elif n < 1 << 16:
                header.append(126)
                header += struct.pack(">H", n)
            else:
                header.append(127)
                header += struct.pack(">Q", n)
            with self._send_lock:
                try:
                    # tmcheck: ok[lock-blocking] _send_lock exists to serialize writers on one websocket
                    self.sock.sendall(bytes(header) + payload)
                except OSError:
                    self.closed.set()
                    return

    def recv_text(self) -> str | None:
        """One text message (handles ping/close); None when closed."""
        while True:
            try:
                hdr = self._read_exact(2)
            except (OSError, ConnectionError):
                self.closed.set()
                return None
            if hdr is None:
                self.closed.set()
                return None
            opcode = hdr[0] & 0x0F
            masked = hdr[1] & 0x80
            length = hdr[1] & 0x7F
            if length in (126, 127):
                ext = self._read_exact(2 if length == 126 else 8)
                if ext is None:
                    self.closed.set()
                    return None
                length = struct.unpack(">H" if len(ext) == 2 else ">Q", ext)[0]
            mask = self._read_exact(4) if masked else b"\x00" * 4
            payload = self._read_exact(length) if length else b""
            if (masked and mask is None) or (length and payload is None):
                self.closed.set()
                return None
            if masked and payload:
                payload = bytes(b ^ mask[i % 4] for i, b in enumerate(payload))
            if opcode == 0x8:  # close
                self.closed.set()
                return None
            if opcode == 0x9:  # ping → pong
                with self._send_lock:
                    try:
                        # tmcheck: ok[lock-blocking] _send_lock exists to serialize writers on one websocket
                        self.sock.sendall(bytes([0x8A, len(payload)]) + payload)
                    except OSError:
                        self.closed.set()
                        return None
                continue
            if opcode in (0x1, 0x2):
                return payload.decode(errors="replace")
            # continuation/pong — skip

    def _read_exact(self, n: int) -> bytes | None:
        buf = b""
        while len(buf) < n:
            chunk = self.sock.recv(n - len(buf))
            if not chunk:
                return None
            buf += chunk
        return buf

    def close(self) -> None:
        self.closed.set()
        try:
            self._out.put_nowait(self._SENTINEL)  # release the writer
        except queue.Full:
            pass
        try:
            # unblock a mid-sendall writer and the reader thread
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass


class JSONRPCServer:
    """ref: rpc/jsonrpc/server/http_server.go."""

    def __init__(
        self,
        routes: dict,
        host: str = "127.0.0.1",
        port: int = 0,
        event_bus=None,
        max_body_bytes: int = 1_000_000,
        max_subscription_clients: int = 100,
        max_subscriptions_per_client: int = 5,
        cors_allowed_origins: tuple = (),
    ):
        self.routes = routes
        self.event_bus = event_bus
        # DoS guards (ref: rpc/jsonrpc/server/http_server.go DefaultConfig
        # MaxBodyBytes; config.go RPCConfig MaxSubscription*).
        self.max_body_bytes = max_body_bytes
        self.max_subscription_clients = max_subscription_clients
        self.max_subscriptions_per_client = max_subscriptions_per_client
        self.cors_allowed_origins = tuple(cors_allowed_origins)
        self._subscriber_clients: set[str] = set()
        self._ws_conns: set[_WebSocketConnection] = set()
        self._ws_lock = threading.Lock()
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # silence default stderr spam
                pass

            def _cors_origin(self):
                origin = self.headers.get("Origin")
                if not origin:
                    return None
                allowed = server.cors_allowed_origins
                if "*" in allowed or origin in allowed:
                    return origin
                return None

            def do_OPTIONS(self):  # noqa: N802 - CORS preflight
                self.send_response(204)
                origin = self._cors_origin()
                if origin:
                    self.send_header("Access-Control-Allow-Origin", origin)
                    self.send_header("Access-Control-Allow-Methods", "GET, POST")
                    self.send_header("Access-Control-Allow-Headers", "Content-Type")
                self.send_header("Content-Length", "0")
                self.end_headers()

            def do_POST(self):
                length = int(self.headers.get("Content-Length", 0))
                if length > server.max_body_bytes:
                    # ref: MaxBytesHandler — oversized bodies refused
                    # before reading (http_server.go:62)
                    self._send_json(
                        _rpc_response(
                            None,
                            error=RPCError(
                                ERR_INVALID_REQUEST,
                                f"request body too large ({length} > {server.max_body_bytes})",
                            ),
                        ),
                        status=413,
                    )
                    return
                body = self.rfile.read(length) if length else b""
                try:
                    req = json.loads(body)
                except Exception:
                    self._send_json(_rpc_response(None, error=RPCError(ERR_PARSE, "Parse error")))
                    return
                if isinstance(req, list):
                    resp = [server._dispatch(r) for r in req]
                else:
                    resp = server._dispatch(req)
                self._send_json(resp)

            def do_GET(self):
                parsed = urlparse(self.path)
                if parsed.path in ("/websocket", "/v1/websocket"):
                    self._upgrade_websocket()
                    return
                method = parsed.path.lstrip("/")
                if not method:
                    # route listing (ref: writeListOfEndpoints)
                    self._send_json({"routes": sorted(server.routes)})
                    return
                params = {}
                for k, v in parse_qsl(parsed.query):
                    params[k] = server._parse_uri_param(v)
                req = {"jsonrpc": "2.0", "id": -1, "method": method, "params": params}
                self._send_json(server._dispatch(req))

            def _send_json(self, obj, status: int = 200):
                data = json.dumps(obj).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                origin = self._cors_origin()
                if origin:
                    self.send_header("Access-Control-Allow-Origin", origin)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def _upgrade_websocket(self):
                key = self.headers.get("Sec-WebSocket-Key")
                if not key:
                    self.send_error(400, "missing Sec-WebSocket-Key")
                    return
                accept = base64.b64encode(
                    hashlib.sha1((key + _WS_MAGIC).encode()).digest()
                ).decode()
                self.send_response(101, "Switching Protocols")
                self.send_header("Upgrade", "websocket")
                self.send_header("Connection", "Upgrade")
                self.send_header("Sec-WebSocket-Accept", accept)
                self.end_headers()
                conn = _WebSocketConnection(self.connection)
                server._serve_websocket(conn)
                # prevent BaseHTTPRequestHandler from touching the socket again
                self.close_connection = True

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self._thread: threading.Thread | None = None

    # -------------------------------------------------------------- control

    @property
    def address(self) -> tuple[str, int]:
        return self._httpd.server_address[:2]

    def start(self) -> None:
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True, name="jsonrpc")
        self._thread.start()

    def stop(self) -> None:
        with self._ws_lock:
            conns = list(self._ws_conns)
        for c in conns:
            c.close()
        self._httpd.shutdown()
        self._httpd.server_close()

    # ------------------------------------------------------------- dispatch

    @staticmethod
    def _parse_uri_param(v: str):
        """URI params arrive as strings; JSON-decode where possible
        (ref: rpc/jsonrpc/server/uri.go)."""
        if v in ("true", "false"):
            return v == "true"
        try:
            return json.loads(v)
        except Exception:
            # strip the reference's quoted-string convention ("0x...", "\"str\"")
            return v.strip('"')

    def _dispatch(self, req) -> dict:
        if not isinstance(req, dict):
            return _rpc_response(None, error=RPCError(ERR_INVALID_REQUEST, "Invalid Request"))
        id_ = req.get("id")
        method = req.get("method")
        fn = self.routes.get(method)
        if fn is None:
            return _rpc_response(id_, error=RPCError(ERR_METHOD_NOT_FOUND, f"Method not found: {method}"))
        params = req.get("params") or {}
        if isinstance(params, list):
            return _rpc_response(id_, error=RPCError(ERR_INVALID_PARAMS, "positional params not supported; use named params"))
        try:
            result = fn(**params)
            return _rpc_response(id_, result=result)
        except RPCError as e:
            return _rpc_response(id_, error=e)
        except TypeError as e:
            return _rpc_response(id_, error=RPCError(ERR_INVALID_PARAMS, str(e)))
        except Exception as e:
            traceback.print_exc()
            return _rpc_response(id_, error=RPCError(ERR_INTERNAL, str(e)))

    # ------------------------------------------------------------ websocket

    def _serve_websocket(self, conn: _WebSocketConnection) -> None:
        """Per-connection loop: JSON-RPC over ws + subscription pushes
        (ref: rpc/jsonrpc/server/ws_handler.go)."""
        with self._ws_lock:
            self._ws_conns.add(conn)
        subscriber = f"ws-{id(conn)}"
        pushers: list[threading.Thread] = []
        try:
            while not conn.closed.is_set():
                text = conn.recv_text()
                if text is None:
                    return
                try:
                    req = json.loads(text)
                except Exception:
                    conn.send_json(_rpc_response(None, error=RPCError(ERR_PARSE, "Parse error")))
                    continue
                method = req.get("method")
                id_ = req.get("id")
                params = req.get("params") or {}
                if method == "subscribe":
                    t = self._start_subscription(conn, subscriber, id_, params.get("query", ""))
                    if t is not None:
                        pushers.append(t)
                elif method == "unsubscribe":
                    query = params.get("query", "")
                    with self._ws_lock:
                        known = query in conn.sub_queries
                        if known:
                            conn.sub_queries.discard(query)
                            if not conn.sub_queries:
                                self._subscriber_clients.discard(subscriber)
                    if not known:
                        conn.send_json(
                            _rpc_response(
                                id_,
                                error=RPCError(ERR_INVALID_PARAMS, f"subscription not found: {query}"),
                            )
                        )
                        continue
                    if self.event_bus is not None:
                        self.event_bus.unsubscribe(subscriber, query)
                    conn.send_json(_rpc_response(id_, result={}))
                elif method == "unsubscribe_all":
                    if self.event_bus is not None:
                        self.event_bus.unsubscribe_all(subscriber)
                    with self._ws_lock:
                        conn.sub_queries.clear()
                        self._subscriber_clients.discard(subscriber)
                    conn.send_json(_rpc_response(id_, result={}))
                else:
                    conn.send_json(self._dispatch(req))
        finally:
            if self.event_bus is not None:
                self.event_bus.unsubscribe_all(subscriber)
            with self._ws_lock:
                self._ws_conns.discard(conn)
                self._subscriber_clients.discard(subscriber)
            conn.close()

    def _start_subscription(self, conn, subscriber: str, id_, query: str):
        if self.event_bus is None:
            conn.send_json(_rpc_response(id_, error=RPCError(ERR_INTERNAL, "event bus not configured")))
            return None
        # Subscription caps (ref: config.go RPCConfig.MaxSubscriptionClients
        # / MaxSubscriptionsPerClient; enforced in the ws handler)
        with self._ws_lock:
            if (
                subscriber not in self._subscriber_clients
                and len(self._subscriber_clients) >= self.max_subscription_clients
            ):
                conn.send_json(
                    _rpc_response(
                        id_,
                        error=RPCError(
                            ERR_INTERNAL,
                            f"max_subscription_clients {self.max_subscription_clients} reached",
                        ),
                    )
                )
                return None
            if query in conn.sub_queries:
                conn.send_json(
                    _rpc_response(
                        id_,
                        error=RPCError(ERR_INVALID_PARAMS, f"already subscribed: {query}"),
                    )
                )
                return None
            if len(conn.sub_queries) >= self.max_subscriptions_per_client:
                conn.send_json(
                    _rpc_response(
                        id_,
                        error=RPCError(
                            ERR_INTERNAL,
                            f"max_subscriptions_per_client {self.max_subscriptions_per_client} reached",
                        ),
                    )
                )
                return None
            self._subscriber_clients.add(subscriber)
            conn.sub_queries.add(query)
        try:
            sub = self.event_bus.subscribe(subscriber, query, buffer_size=256)
        except Exception as e:
            with self._ws_lock:
                conn.sub_queries.discard(query)
                if not conn.sub_queries:
                    self._subscriber_clients.discard(subscriber)
            conn.send_json(_rpc_response(id_, error=RPCError(ERR_INTERNAL, str(e))))
            return None
        conn.send_json(_rpc_response(id_, result={}))

        def pusher():
            from .core import event_to_json

            while not conn.closed.is_set() and not sub.terminated.is_set():
                msg = sub.next(timeout=0.2)
                if msg is None:
                    continue
                conn.send_json(
                    _rpc_response(
                        id_,
                        result={
                            "query": query,
                            "data": event_to_json(msg.data),
                            "events": msg.events,
                        },
                    )
                )

        t = threading.Thread(target=pusher, daemon=True, name=f"ws-push:{subscriber}")
        t.start()
        return t
