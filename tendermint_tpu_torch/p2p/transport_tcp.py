"""TCP transport: SecretConnection + MConnection-style packetized
channel multiplexing with priorities and flow control
(ref: internal/p2p/transport_mconn.go + internal/p2p/conn/connection.go),
a copy of the JAX package's p2p/transport_tcp.py with the same wire bytes.
Its options are constructor arguments; no environment setting reads them.

Wire format after the SecretConnection handshake: messages are split
into packets `uvarint(1 + 1 + chunk_len) || channel_id || eof || chunk`
with chunks <= 1024 bytes (conn/connection.go maxPacketMsgPayloadSize).
A dedicated send loop per connection picks the next packet from
per-channel queues by least recently_sent/priority ratio — so a 64 KiB
block part never queues a vote behind it — and a token bucket throttles
the connection to `send_rate` bytes/sec (conn/connection.go:45-46,
default 500 KB/s each way). Channel codecs (ChannelDescriptor.encode/
decode) translate payload bytes ↔ message objects; unknown channels are
dropped by the router.

Liveness (ref: conn/connection.go pingRoutine / PacketPing/PacketPong):
frame IDs 0xFF (ping) and 0xFE (pong) are RESERVED control frames —
never registered as reactor channels. The send loop pings every
`ping_interval`; any received frame refreshes the liveness clock; a
link silent past `pong_timeout` after a ping is closed. This is what
detects a half-open peer (TCP ESTABLISHED, peer frozen), which would
otherwise hold its slot forever. The whole
handshake additionally runs under a hard wall-clock deadline (a
watchdog closes the socket), because per-operation socket timeouts let
a slow-dripping dialer hold a handshake thread indefinitely.
"""

from __future__ import annotations

import queue
import socket

import threading
import time
from typing import Any

from ..proto import messages as pb
from ..utils.varint import encode_uvarint as _encode_uvarint
from .secret_connection import SecretConnection
from .transport import Connection, ConnectionClosed, Endpoint, Transport
from .types import ChannelDescriptor, NodeInfo, node_id_from_pubkey

MAX_MSG_SIZE = 1 << 22  # 4 MiB, ref: conn/connection.go maxPacketMsgPayloadSize scaled
PACKET_PAYLOAD_SIZE = 1024  # ref: conn/connection.go:39 defaultMaxPacketMsgPayloadSize
DEFAULT_SEND_RATE = 512000  # bytes/sec, ref: conn/connection.go:45
DEFAULT_RECV_RATE = 512000  # ref: conn/connection.go:46
# Reserved control-frame IDs (never valid reactor channels; the node's
# channel IDs live well below 0xF0).
FRAME_PING = 0xFF
FRAME_PONG = 0xFE
DEFAULT_PING_INTERVAL = 15.0  # ref: conn/connection.go pingRoutine cadence
DEFAULT_PONG_TIMEOUT = 45.0  # silent-past-this after a ping => dead link
# A packet whose header arrived must complete within this window; a
# peer dripping one byte per poll interval would otherwise pin the
# receive path forever.
PACKET_FINISH_TIMEOUT = 20.0


class _TokenBucket:
    """Byte-rate throttle (ref: internal/libs/flowrate used at
    conn/connection.go:124). Capacity = one second's burst."""

    def __init__(self, rate: int):
        self.rate = float(rate)
        self._tokens = float(rate)
        self._last = time.monotonic()
        self._lock = threading.Lock()

    def consume(self, n: int) -> None:
        """Blocks until n tokens are available. Requests larger than the
        one-second capacity temporarily raise the cap (tokens go negative
        never — the burst just takes n/rate seconds to accumulate), so a
        frame bigger than a tiny configured rate still eventually sends
        instead of spinning forever.

        The throttle wait happens with the lock RELEASED: sleeping under
        the lock would park every other consumer of this bucket for the
        whole refill wait instead of letting them take the tokens that ARE
        available."""
        cap = max(self.rate, float(n))
        while True:
            with self._lock:
                now = time.monotonic()
                self._tokens = min(cap, self._tokens + (now - self._last) * self.rate)
                self._last = now
                if self._tokens >= n:
                    self._tokens -= n
                    return
                wait = (n - self._tokens) / self.rate
            time.sleep(min(0.1, wait))


class _ChannelSendState:
    """Per-channel outbound queue + fair-share accounting
    (ref: conn/connection.go:600 channel)."""

    __slots__ = ("desc", "queue", "sending", "offset", "recently_sent")

    def __init__(self, desc: ChannelDescriptor):
        self.desc = desc
        self.queue: queue.Queue = queue.Queue(maxsize=max(1, desc.send_queue_capacity))
        self.sending: bytes | None = None  # message currently being packetized
        self.offset = 0
        self.recently_sent = 0.0

    def next_packet(self) -> tuple[bytes, bool] | None:
        """(chunk, eof) or None when idle."""
        if self.sending is None:
            try:
                self.sending = self.queue.get_nowait()
                self.offset = 0
            except queue.Empty:
                return None
        chunk = self.sending[self.offset : self.offset + PACKET_PAYLOAD_SIZE]
        self.offset += len(chunk)
        eof = self.offset >= len(self.sending)
        if eof:
            self.sending = None
            self.offset = 0
        return chunk, eof

    def has_data(self) -> bool:
        return self.sending is not None or not self.queue.empty()


class TcpConnection(Connection):
    def __init__(
        self,
        sock: socket.socket,
        channel_descs: dict[int, ChannelDescriptor],
        send_rate: int = DEFAULT_SEND_RATE,
        recv_rate: int = DEFAULT_RECV_RATE,
        ping_interval: float = DEFAULT_PING_INTERVAL,
        pong_timeout: float = DEFAULT_PONG_TIMEOUT,
    ):
        self._sock = sock
        self._descs = channel_descs
        self._secret: SecretConnection | None = None
        self._send_lock = threading.Lock()
        self._recv_lock = threading.Lock()
        self._closed = threading.Event()
        self._varint_result = 0  # resumable length-prefix state
        self._varint_shift = 0
        self.on_traffic = None  # optional (direction, channel_id, nbytes) hook
        # -- packetized send plane (ref: conn/connection.go sendRoutine)
        self._channels: dict[int, _ChannelSendState] = {}
        self._channels_lock = threading.Lock()
        self._send_bucket = _TokenBucket(send_rate)
        self._recv_bucket = _TokenBucket(recv_rate)
        self._send_wake = threading.Event()
        self._send_thread: threading.Thread | None = None
        self._send_error: Exception | None = None
        # -- liveness (ref: conn/connection.go pingRoutine). _last_recv
        # advances whenever receive_message pulls a frame — the router
        # polls continuously, so stale _last_recv means a silent link.
        self._ping_interval = ping_interval
        self._pong_timeout = pong_timeout
        self._last_recv = time.monotonic()
        self._last_ping = 0.0
        self._last_ping_attempt = 0.0
        self._liveness_thread: threading.Thread | None = None
        # wall-clock deadline for an in-flight packet body; enforced by
        # the liveness monitor (per-op socket timeouts reset on every
        # received byte, so a dripper could otherwise stretch one packet
        # indefinitely, and SecretConnection reads are not resumable)
        self._body_deadline: float | None = None
        # -- receive reassembly (per-channel partial messages)
        self._recv_partial: dict[int, bytearray] = {}
        try:
            self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass

    def handshake(self, node_info: NodeInfo, priv_key, timeout: float | None = None) -> tuple[NodeInfo, Any]:
        """SecretConnection handshake authenticates keys; then proto
        NodeInfo exchange, uvarint-length-delimited like the reference's
        protoio (ref: transport_mconn.go:116 Handshake).

        `timeout` bounds the WHOLE handshake, not each socket op: a
        watchdog closes the socket at the wall-clock deadline, so a
        black-holed or byte-dripping peer costs exactly `timeout` before
        the caller fails over to the next peer. Per-op timeouts alone
        reset on every received byte — one byte per interval holds a
        handshake thread forever."""
        done = threading.Event()
        expired = threading.Event()
        if timeout is not None and timeout > 0:
            def _watchdog():
                if not done.wait(timeout):
                    expired.set()
                    try:
                        self._sock.shutdown(socket.SHUT_RDWR)
                    except OSError:
                        pass
                    try:
                        self._sock.close()
                    except OSError:
                        pass
            threading.Thread(target=_watchdog, daemon=True, name="mconn-hs-watchdog").start()
        self._sock.settimeout(timeout)
        try:
            self._secret = SecretConnection(self._sock, priv_key)
            payload = node_info.to_proto().encode()
            self._secret.write(_encode_uvarint(len(payload)) + payload)
            peer_info = NodeInfo.from_proto(
                pb.NodeInfoProto.decode(self._secret._read_delimited(1 << 20))
            )
        except Exception:
            if expired.is_set():
                raise TimeoutError(f"handshake timed out after {timeout}s") from None
            raise
        finally:
            done.set()
        peer_key = self._secret.remote_pub_key
        if node_id_from_pubkey(peer_key) != peer_info.node_id:
            raise ValueError("peer's public key does not match its node ID")
        self._sock.settimeout(None)
        self._last_recv = time.monotonic()
        # keepalive runs from handshake completion even on quiet links
        self._ensure_send_thread()
        return peer_info, peer_key

    def send_message(self, channel_id: int, message) -> None:
        """Enqueue on the channel's send queue; the connection's send loop
        packetizes and interleaves by priority (ref: conn/connection.go:370
        Send). Blocks briefly on a full queue (backpressure), then drops —
        gossip is idempotent, matching the reference's timeout-drop."""
        if self._closed.is_set():
            raise ConnectionClosed(str(self._send_error or "connection closed"))
        desc = self._descs.get(channel_id)
        if desc is None or desc.encode is None:
            raise ValueError(f"no codec for channel {channel_id:#x}")
        payload = desc.encode(message)
        if len(payload) > MAX_MSG_SIZE:
            raise ValueError("message exceeds maximum size")
        with self._channels_lock:
            ch = self._channels.get(channel_id)
            if ch is None:
                ch = self._channels[channel_id] = _ChannelSendState(desc)
        self._ensure_send_thread()
        try:
            ch.queue.put(payload, timeout=2.0)
        except queue.Full:
            return  # dropped under sustained backpressure
        self._send_wake.set()
        if self.on_traffic is not None:
            self.on_traffic("send", channel_id, len(payload))

    def _ensure_send_thread(self) -> None:
        with self._channels_lock:
            if self._send_thread is None and not self._closed.is_set():
                self._send_thread = threading.Thread(
                    target=self._send_loop, daemon=True, name="mconn-send"
                )
                self._send_thread.start()
            # the monitor always runs: even with pings disabled it
            # enforces the mid-packet completion deadline
            if self._liveness_thread is None and not self._closed.is_set():
                self._liveness_thread = threading.Thread(
                    target=self._liveness_loop, daemon=True, name="mconn-liveness"
                )
                self._liveness_thread.start()

    def _write_control(self, frame_id: int, lock_timeout: float | None = None) -> bool:
        """Write a ping/pong control frame (empty chunk, eof=1). With
        lock_timeout, gives up (True) if the send lock is busy rather
        than queueing behind a bulk write."""
        frame = _encode_uvarint(2) + bytes([frame_id, 1])
        if lock_timeout is not None:
            if not self._send_lock.acquire(timeout=lock_timeout):
                return True  # send plane busy; liveness reap covers wedged
        else:
            self._send_lock.acquire()
        try:
            self._secret.write(frame)
            return True
        except (OSError, ConnectionError) as e:
            self._send_error = e
            self.close()
            return False
        finally:
            self._send_lock.release()

    def _liveness_loop(self) -> None:
        """Dedicated heartbeat (ref: conn/connection.go pingRoutine),
        deliberately NOT the send loop: a bulk write wedged against a
        frozen peer blocks the send loop in sendall forever, and that is
        precisely when the reap must still fire. Pings go out on
        `ping_interval` cadence; the link dies when it stays silent past
        `pong_timeout` after a ping was sent OR attempted (an attempt
        that could not take the send lock means the send plane is wedged
        — silent + wedged is equally dead)."""
        tick = max(0.05, min(1.0, self._ping_interval / 3.0)) if self._ping_interval > 0 else 1.0
        while not self._closed.is_set():
            time.sleep(tick)
            if self._closed.is_set():
                return
            now = time.monotonic()
            # mid-packet completion bound: the receive path publishes a
            # wall-clock deadline when a packet header has arrived; a
            # body still unfinished past it means the stream is dripping
            # — close, which unblocks the receive thread with an error
            bd = self._body_deadline
            if bd is not None and now > bd:
                # a lock-free error slot: the reap must fire while the send
                # plane is wedged holding the send lock; the last error wins
                self._send_error = TimeoutError("packet stalled mid-flight")
                self.close()
                return
            if self._secret is None or self._ping_interval <= 0:
                continue  # pre-handshake, or keepalive disabled
            if (
                self._pong_timeout > 0
                and now - self._last_recv > self._pong_timeout
                and max(self._last_ping, self._last_ping_attempt) > self._last_recv
            ):
                self._send_error = TimeoutError(
                    f"no data for {now - self._last_recv:.1f}s after ping (pong timeout)"
                )
                self.close()
                return
            if now - self._last_ping_attempt >= self._ping_interval:
                self._last_ping_attempt = now
                if self._write_control(FRAME_PING, lock_timeout=0.5):
                    self._last_ping = now
                else:
                    return  # write failed; connection closed

    def _pick_channel(self) -> _ChannelSendState | None:
        """Least recently_sent/priority among channels with data
        (ref: conn/connection.go:478 sendPacketMsg channel selection)."""
        best, best_ratio = None, None
        with self._channels_lock:
            states = list(self._channels.values())
        for ch in states:
            if not ch.has_data():
                continue
            ratio = ch.recently_sent / max(1, ch.desc.priority)
            if best_ratio is None or ratio < best_ratio:
                best, best_ratio = ch, ratio
        return best

    def _send_loop(self) -> None:
        """ref: conn/connection.go:420 sendRoutine."""
        idle_since = None
        while not self._closed.is_set():
            ch = self._pick_channel()
            if ch is None:
                # decay fair-share counters while idle so a long-quiet
                # channel doesn't start permanently favored
                if idle_since is None:
                    idle_since = time.monotonic()
                elif time.monotonic() - idle_since > 2.0:
                    with self._channels_lock:
                        for st in self._channels.values():
                            st.recently_sent *= 0.5
                    idle_since = time.monotonic()
                self._send_wake.wait(timeout=0.05)
                self._send_wake.clear()
                continue
            idle_since = None
            nxt = ch.next_packet()
            if nxt is None:
                continue
            chunk, eof = nxt
            frame = (
                _encode_uvarint(2 + len(chunk))
                + bytes([ch.desc.id, 1 if eof else 0])
                + chunk
            )
            self._send_bucket.consume(len(frame))
            ch.recently_sent += len(frame)
            with self._send_lock:
                try:
                    self._secret.write(frame)
                except (OSError, ConnectionError) as e:
                    self._send_error = e
                    self._closed.set()
                    return

    def _read_uvarint(self) -> int:
        """Resumable uvarint read: bytes consumed before a poll timeout
        are kept in (_varint_result, _varint_shift) so the next call
        continues the prefix instead of desynchronizing the plaintext
        stream (a multi-byte prefix can straddle two SecretConnection
        frames; cf. SecretConnection's own resumable _raw_buf)."""
        while True:
            b = self._secret.read_exact(1)[0]
            # one reader thread a connection owns the resumable varint
            # state (receive_message has a single consumer)
            self._varint_result |= (b & 0x7F) << self._varint_shift
            if not (b & 0x80):
                result = self._varint_result
                self._varint_result, self._varint_shift = 0, 0
                return result
            self._varint_shift += 7
            if self._varint_shift > 63:
                raise ValueError("uvarint overflow")

    def receive_message(self, timeout: float | None = None) -> tuple[int, Any]:
        """Read packets, reassembling per-channel until one message
        completes (ref: conn/connection.go:545 recvRoutine)."""
        if self._closed.is_set():
            raise ConnectionClosed("connection closed")
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._recv_lock:
            while True:
                in_body = False
                try:
                    remaining = None if deadline is None else max(0.01, deadline - time.monotonic())
                    self._sock.settimeout(remaining)
                    total = self._read_uvarint()
                    if total < 2 or total > PACKET_PAYLOAD_SIZE + 2:
                        raise ValueError(f"invalid packet length {total}")
                    # got a header: the rest of the packet must land
                    # within a bounded WALL-CLOCK window. The socket
                    # timeout alone cannot enforce that (it resets on
                    # every received byte, so a dripper stretches it
                    # forever) — the liveness monitor closes the socket
                    # at _body_deadline, failing this read.
                    in_body = True
                    self._body_deadline = time.monotonic() + PACKET_FINISH_TIMEOUT
                    self._sock.settimeout(PACKET_FINISH_TIMEOUT)
                    try:
                        body = self._secret.read_exact(total)
                    finally:
                        self._body_deadline = None
                    self._sock.settimeout(None)
                except socket.timeout:
                    if in_body:
                        # a packet stalled mid-flight past the bound: the
                        # link is dead or adversarial — drop it (failing
                        # over beats resuming a byte-drip)
                        self._send_error = TimeoutError("packet stalled mid-flight")
                        self.close()
                        raise ConnectionClosed("packet stalled mid-flight")
                    raise TimeoutError("receive timed out")
                except (OSError, ConnectionError, ValueError) as e:
                    self._closed.set()
                    # surface the monitor's verdict (pong timeout /
                    # packet stall) instead of the raw EBADF it caused
                    if isinstance(self._send_error, TimeoutError):
                        raise ConnectionClosed(str(self._send_error))
                    raise ConnectionClosed(str(e))
                self._last_recv = time.monotonic()
                channel_id, eof, chunk = body[0], body[1], body[2:]
                if channel_id == FRAME_PING:
                    # control frame: answer from the receive path so a
                    # pong never queues behind bulk traffic. Bounded
                    # lock wait — if the send plane is wedged against a
                    # frozen peer, parking the RECEIVE thread behind it
                    # would stall healthy inbound traffic too (the next
                    # ping retries; any data we send also counts as
                    # liveness for the peer)
                    self._write_control(FRAME_PONG, lock_timeout=0.5)
                    continue
                if channel_id == FRAME_PONG:
                    continue  # _last_recv refresh was the payload
                # inbound flow control (ref: conn/connection.go:46 recvRate):
                # throttling our read drains the peer via TCP backpressure
                self._recv_bucket.consume(len(body))
                buf = self._recv_partial.setdefault(channel_id, bytearray())
                buf += chunk
                if len(buf) > MAX_MSG_SIZE:
                    self._closed.set()
                    raise ConnectionClosed(f"peer message exceeds maximum size on channel {channel_id:#x}")
                if not eof:
                    continue
                payload = bytes(self._recv_partial.pop(channel_id))
                if self.on_traffic is not None:
                    self.on_traffic("recv", channel_id, len(payload))
                desc = self._descs.get(channel_id)
                if desc is None or desc.decode is None:
                    return channel_id, payload  # router drops unknown channels
                return channel_id, desc.decode(payload)

    def local_endpoint(self) -> Endpoint:
        try:
            host, port = self._sock.getsockname()[:2]
        except OSError:
            host, port = "", 0
        return Endpoint(protocol="mconn", host=host, port=port)

    def remote_endpoint(self) -> Endpoint:
        try:
            host, port = self._sock.getpeername()[:2]
        except OSError:
            host, port = "", 0
        return Endpoint(protocol="mconn", host=host, port=port)

    def close(self) -> None:
        self._closed.set()
        self._send_wake.set()
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass


class TcpTransport(Transport):
    """ref: transport_mconn.go MConnTransport."""

    protocol = "mconn"

    def __init__(
        self,
        channel_descs: list[ChannelDescriptor],
        bind_host: str = "127.0.0.1",
        bind_port: int = 0,
        send_rate: int = DEFAULT_SEND_RATE,
        recv_rate: int = DEFAULT_RECV_RATE,
        ping_interval: float = DEFAULT_PING_INTERVAL,
        pong_timeout: float = DEFAULT_PONG_TIMEOUT,
        dial_through: Any = None,
    ):
        for d in channel_descs:
            if d.id in (FRAME_PING, FRAME_PONG):
                raise ValueError(
                    f"channel id {d.id:#x} is reserved for keepalive control frames"
                )
        self._send_rate = send_rate
        self._recv_rate = recv_rate
        self._ping_interval = ping_interval
        self._pong_timeout = pong_timeout
        # Optional (host, port) -> (host, port) rewrite applied to every
        # outbound dial: the seam a fault-injection proxy uses to route
        # dials through per-link proxies without the router or reactors
        # knowing (the fault lands below the socket API).
        self.dial_through = dial_through
        self._descs = {d.id: d for d in channel_descs}
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((bind_host, bind_port))
        self._listener.listen(64)
        self._closed = threading.Event()

    def add_channel_descriptors(self, descs: list[ChannelDescriptor]) -> None:
        for d in descs:
            if d.id in (FRAME_PING, FRAME_PONG):
                raise ValueError(
                    f"channel id {d.id:#x} is reserved for keepalive control frames"
                )
            self._descs[d.id] = d

    def endpoint(self) -> Endpoint:
        host, port = self._listener.getsockname()[:2]
        return Endpoint(protocol="mconn", host=host, port=port)

    def accept(self, timeout: float | None = None) -> Connection:
        if self._closed.is_set():
            raise ConnectionClosed("transport closed")
        self._listener.settimeout(timeout)
        try:
            sock, _ = self._listener.accept()
        except socket.timeout:
            raise TimeoutError("accept timed out")
        except OSError as e:
            raise ConnectionClosed(str(e))
        return self._make_conn(sock)

    def dial(self, endpoint: Endpoint, timeout: float | None = None) -> Connection:
        host, port = endpoint.host, endpoint.port
        if self.dial_through is not None:
            host, port = self.dial_through(host, port)
        sock = socket.create_connection((host, port), timeout=timeout)
        sock.settimeout(None)
        return self._make_conn(sock)

    def _make_conn(self, sock: socket.socket) -> "TcpConnection":
        return TcpConnection(
            sock,
            self._descs,
            send_rate=self._send_rate,
            recv_rate=self._recv_rate,
            ping_interval=self._ping_interval,
            pong_timeout=self._pong_timeout,
        )

    def close(self) -> None:
        self._closed.set()
        try:
            self._listener.close()
        except OSError:
            pass
