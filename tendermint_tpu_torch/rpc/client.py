"""RPC clients (ref: rpc/client/http + eventstream).

HTTPClient speaks JSON-RPC over HTTP POST; WSClient implements a
minimal RFC-6455 client for /websocket subscriptions.
"""

from __future__ import annotations

import base64
import http.client
import itertools
import json
import os
import queue
import socket
import struct
import threading
from urllib.parse import urlsplit


class RPCClientError(Exception):
    def __init__(self, code, message, data=None):
        super().__init__(f"RPC error {code}: {message}" + (f" ({data})" if data else ""))
        self.code = code
        self.data = data


class HTTPClient:
    """ref: rpc/client/http/http.go.

    Keep-alive: calls ride ONE persistent `http.client.HTTPConnection`
    per calling thread instead of a fresh TCP connect (+ handshake) per
    request — the per-call `urllib.request.urlopen` setup used to
    dominate the proof gateway's serve time at high QPS (tmproof). A
    stale keep-alive socket (the server closed an idle connection
    between calls, or it died and restarted) is retried ONCE on a fresh
    connection; a request that timed out is NOT retried (re-waiting the
    full timeout would double every slow failure, and the caller's
    retry policy owns that decision). Connections are per-thread
    (threading.local), so concurrent callers never interleave on one
    socket."""

    def __init__(self, base_url: str, timeout: float = 30.0):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout
        self._ids = itertools.count(1)
        u = urlsplit(self.base_url if "//" in self.base_url else "//" + self.base_url)
        if u.scheme not in ("", "http"):
            # silently opening a plaintext port-80 connection to an
            # https:// URL would be a downgrade, not a fallback
            raise ValueError(
                f"HTTPClient speaks plain http only, got scheme {u.scheme!r}"
            )
        self._host = u.hostname or "127.0.0.1"
        self._port = u.port or 80
        self._path = u.path or "/"
        self._local = threading.local()

    def _conn(self) -> http.client.HTTPConnection:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = http.client.HTTPConnection(self._host, self._port, timeout=self.timeout)
            self._local.conn = conn
        return conn

    def close(self) -> None:
        """Drop this thread's persistent connection (idempotent)."""
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            self._local.conn = None
            try:
                conn.close()
            except OSError:
                pass

    def call(self, method: str, **params):
        req = {
            "jsonrpc": "2.0",
            "id": next(self._ids),
            "method": method,
            "params": params,
        }
        data = json.dumps(req).encode()
        headers = {"Content-Type": "application/json"}
        raw = None
        for attempt in (0, 1):
            conn = self._conn()
            reused = conn.sock is not None  # else request() connects fresh
            try:
                conn.request("POST", self._path, body=data, headers=headers)
            except TimeoutError:
                self.close()
                raise
            except (http.client.HTTPException, OSError):
                # send-phase failure: the request was never delivered,
                # so one retry on a fresh connection is always safe
                self.close()
                if attempt:
                    raise
                continue
            try:
                resp = conn.getresponse()
                raw = resp.read()
                break
            except TimeoutError:
                self.close()  # half-done exchange: the socket is unusable
                raise
            except (http.client.HTTPException, OSError):
                self.close()
                # response-phase failure: retry ONLY a reused keep-alive
                # socket (the server reaped it idle before reading our
                # bytes — the classic stale-socket shape). A FRESH
                # connection that died mid-exchange may have processed
                # the call; blindly re-POSTing would double-submit
                # non-idempotent methods (broadcast_tx_*).
                if attempt or not reused:
                    raise
        body = json.loads(raw)
        if "error" in body:
            e = body["error"]
            raise RPCClientError(e.get("code"), e.get("message"), e.get("data"))
        return body["result"]

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return lambda **params: self.call(name, **params)


class WSClient:
    """Minimal websocket JSON-RPC client (ref: rpc/client/http ws +
    eventstream)."""

    def __init__(self, host: str, port: int, path: str = "/websocket", timeout: float = 30.0):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        key = base64.b64encode(os.urandom(16)).decode()
        handshake = (
            f"GET {path} HTTP/1.1\r\n"
            f"Host: {host}:{port}\r\n"
            "Upgrade: websocket\r\n"
            "Connection: Upgrade\r\n"
            f"Sec-WebSocket-Key: {key}\r\n"
            "Sec-WebSocket-Version: 13\r\n\r\n"
        )
        self.sock.sendall(handshake.encode())
        # read response headers
        buf = b""
        while b"\r\n\r\n" not in buf:
            chunk = self.sock.recv(4096)
            if not chunk:
                raise ConnectionError("websocket handshake failed")
            buf += chunk
        status = buf.split(b"\r\n", 1)[0]
        if b"101" not in status:
            raise ConnectionError(f"websocket upgrade rejected: {status!r}")
        # connect timeout must not apply to the event stream: an idle
        # subscription would otherwise kill the reader after `timeout`
        self.sock.settimeout(None)
        self._ids = itertools.count(1)
        self._responses: dict[int, dict] = {}
        self._events: queue.Queue = queue.Queue(maxsize=1024)
        self._lock = threading.Lock()
        self._closed = threading.Event()
        self._reader = threading.Thread(target=self._read_loop, daemon=True, name="ws-client")
        self._reader.start()

    # --------------------------------------------------------------- frames

    def _send_text(self, text: str) -> None:
        payload = text.encode()
        mask = os.urandom(4)
        header = bytearray([0x81])
        n = len(payload)
        if n < 126:
            header.append(0x80 | n)
        elif n < 1 << 16:
            header.append(0x80 | 126)
            header += struct.pack(">H", n)
        else:
            header.append(0x80 | 127)
            header += struct.pack(">Q", n)
        header += mask
        masked = bytes(b ^ mask[i % 4] for i, b in enumerate(payload))
        self.sock.sendall(bytes(header) + masked)

    def _read_exact(self, n: int) -> bytes | None:
        buf = b""
        while len(buf) < n:
            try:
                chunk = self.sock.recv(n - len(buf))
            except OSError:
                return None
            if not chunk:
                return None
            buf += chunk
        return buf

    def _read_loop(self) -> None:
        try:
            self._read_loop_inner()
        finally:
            self._closed.set()  # fail fast for blocked call()/next_event()

    def _read_loop_inner(self) -> None:
        while not self._closed.is_set():
            hdr = self._read_exact(2)
            if hdr is None:
                return
            opcode = hdr[0] & 0x0F
            length = hdr[1] & 0x7F
            if length == 126:
                ext = self._read_exact(2)
                if ext is None:
                    return
                length = struct.unpack(">H", ext)[0]
            elif length == 127:
                ext = self._read_exact(8)
                if ext is None:
                    return
                length = struct.unpack(">Q", ext)[0]
            payload = self._read_exact(length) if length else b""
            if payload is None or opcode == 0x8:
                return
            if opcode == 0x9:  # ping → pong
                try:
                    self.sock.sendall(bytes([0x8A, 0x80]) + os.urandom(4))
                except OSError:
                    self._closed.set()
                    return
                continue
            if opcode not in (0x1, 0x2):
                continue
            try:
                msg = json.loads(payload)
            except Exception:
                continue
            result = msg.get("result") or {}
            if isinstance(result, dict) and "data" in result and "query" in result:
                try:
                    self._events.put_nowait(result)
                except queue.Full:
                    pass
            else:
                with self._lock:
                    self._responses[msg.get("id")] = msg

    # ----------------------------------------------------------------- API

    def call(self, method: str, timeout: float = 10.0, **params):
        id_ = next(self._ids)
        self._send_text(json.dumps({"jsonrpc": "2.0", "id": id_, "method": method, "params": params}))
        import time

        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                msg = self._responses.pop(id_, None)
            if msg is not None:
                if "error" in msg:
                    e = msg["error"]
                    raise RPCClientError(e.get("code"), e.get("message"), e.get("data"))
                return msg.get("result")
            if self._closed.is_set():
                raise ConnectionError("websocket closed")
            time.sleep(0.01)
        raise TimeoutError(f"no response for {method}")

    def subscribe(self, query: str) -> None:
        self.call("subscribe", query=query)

    def next_event(self, timeout: float = 10.0) -> dict | None:
        try:
            return self._events.get(timeout=timeout)
        except queue.Empty:
            return None

    def close(self) -> None:
        self._closed.set()
        try:
            self.sock.close()
        except OSError:
            pass


class EventStream:
    """Resumable event consumption over the polling /events RPC
    (ref: rpc/client/eventstream/eventstream.go).

    Tracks the newest-seen cursor and long-polls for newer items,
    yielding events oldest-first without a WebSocket; survives client
    restarts if the caller persists `cursor`."""

    def __init__(self, client: HTTPClient, query: str = "", batch_size: int = 32,
                 wait_time_s: float = 5.0, cursor: str = ""):
        self.client = client
        self.query = query
        self.batch_size = batch_size
        self.wait_time_s = wait_time_s
        self.cursor = cursor

    def _params(self, **extra):
        params = {"maxItems": self.batch_size, **extra}
        if self.query:
            params["filter"] = {"query": self.query}
        return params

    def next_batch(self) -> list[dict]:
        """All events newer than the cursor, oldest-first. Pages with
        `before` while the server reports more, so a burst larger than
        batch_size is never silently skipped (ref: eventstream.go:86
        fetches the tail pages before advancing its cursor)."""
        if not self.cursor:
            # start at the head: remember the newest cursor, yield nothing
            res = self.client.call("events", **self._params(maxItems=1))
            self.cursor = res.get("newest") or ""
            if not res.get("items"):
                return []
        res = self.client.call(
            "events",
            **self._params(after=self.cursor, waitTime=int(self.wait_time_s * 1e9)),
        )
        pages = [res.get("items") or []]
        while res.get("more") and pages[-1]:
            res = self.client.call(
                "events",
                **self._params(after=self.cursor, before=pages[-1][-1]["cursor"]),
            )
            pages.append(res.get("items") or [])
        items = [it for page in pages for it in page]
        items.reverse()  # newest-first pages -> oldest-first stream
        if items:
            self.cursor = items[-1]["cursor"]
        return items

    def __iter__(self):
        while True:
            yield from self.next_batch()


class LocalClient:
    """In-process client over an RPCEnvironment — no HTTP, same route
    surface and error mapping as HTTPClient (ref: rpc/client/local).
    Useful for embedding and for tools that run against a node object
    (the reference's e2e tests use the local client the same way)."""

    def __init__(self, env):
        from .core import build_routes

        self._routes = build_routes(env)

    def call(self, method: str, **params):
        from .server import RPCError

        fn = self._routes.get(method)
        if fn is None:
            raise RPCClientError(-32601, f"Method not found: {method}")
        try:
            return fn(**params)
        except RPCError as e:
            raise RPCClientError(e.code, e.message, e.data) from None
        except TypeError as e:
            raise RPCClientError(-32602, f"Invalid params: {e}") from None
        except Exception as e:  # parity with the HTTP server's ERR_INTERNAL
            raise RPCClientError(-32603, f"Internal error: {e}") from e

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return lambda **params: self.call(name, **params)
