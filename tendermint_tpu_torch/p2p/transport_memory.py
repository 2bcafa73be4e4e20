"""In-process memory transport for tests
(ref: internal/p2p/transport_memory.go).

A MemoryNetwork holds one MemoryTransport per node; dialing creates a
pair of queue-connected MemoryConnections. Messages are passed as
objects (no serialization) — reactor tests exercise real routing logic
over buffered queues, exactly the reference's approach.
"""

from __future__ import annotations

import queue
import threading
from typing import Any

from .transport import Connection, ConnectionClosed, Endpoint, Transport
from .types import NodeInfo, node_id_from_pubkey


class MemoryNetwork:
    """ref: transport_memory.go MemoryNetwork — a registry of in-process
    transports addressable by node ID."""

    def __init__(self, buffer_size: int = 128):
        self.buffer_size = buffer_size
        self._transports: dict[str, MemoryTransport] = {}
        self._lock = threading.Lock()

    def create_transport(self, node_id: str) -> "MemoryTransport":
        with self._lock:
            if node_id in self._transports:
                raise ValueError(f"transport for {node_id} already exists")
            t = MemoryTransport(self, node_id, self.buffer_size)
            self._transports[node_id] = t
            return t

    def get_transport(self, node_id: str) -> "MemoryTransport | None":
        with self._lock:
            return self._transports.get(node_id)

    def remove_transport(self, node_id: str) -> None:
        with self._lock:
            self._transports.pop(node_id, None)


class MemoryTransport(Transport):
    protocol = "memory"

    def __init__(self, network: MemoryNetwork, node_id: str, buffer_size: int):
        self.network = network
        self.node_id = node_id
        self.buffer_size = buffer_size
        self._accept_queue: queue.Queue = queue.Queue()
        self._closed = threading.Event()

    def endpoint(self) -> Endpoint:
        return Endpoint(protocol="memory", host=self.node_id, node_id=self.node_id)

    def accept(self, timeout: float | None = None) -> Connection:
        try:
            conn = self._accept_queue.get(timeout=timeout)
        except queue.Empty:
            raise TimeoutError("accept timed out")
        if conn is None or self._closed.is_set():
            raise ConnectionClosed("transport closed")
        return conn

    def dial(self, endpoint: Endpoint, timeout: float | None = None) -> Connection:
        if endpoint.protocol != "memory":
            raise ValueError(f"memory transport cannot dial {endpoint.protocol}")
        peer = self.network.get_transport(endpoint.host)
        if peer is None or peer._closed.is_set():
            raise ConnectionError(f"no memory transport for {endpoint.host}")
        a2b: queue.Queue = queue.Queue(maxsize=self.buffer_size)
        b2a: queue.Queue = queue.Queue(maxsize=self.buffer_size)
        local = MemoryConnection(self.node_id, endpoint.host, send_q=a2b, recv_q=b2a)
        remote = MemoryConnection(endpoint.host, self.node_id, send_q=b2a, recv_q=a2b)
        peer._accept_queue.put(remote)
        return local

    def close(self) -> None:
        self._closed.set()
        self.network.remove_transport(self.node_id)
        self._accept_queue.put(None)


class MemoryConnection(Connection):
    _CLOSE = ("__close__", None)

    def __init__(self, local_id: str, remote_id: str, send_q: queue.Queue, recv_q: queue.Queue):
        self.local_id = local_id
        self.remote_id = remote_id
        self._send_q = send_q
        self._recv_q = recv_q
        self._closed = threading.Event()
        self.on_traffic = None  # the router's traffic hook (unused in-process)

    def handshake(self, node_info: NodeInfo, priv_key, timeout: float | None = None) -> tuple[NodeInfo, Any]:
        """Symmetric NodeInfo/pubkey exchange (ref: transport_memory.go
        Handshake). No encryption — in-process."""
        pub = priv_key.pub_key()
        self._send_q.put(("__handshake__", (node_info, pub)), timeout=timeout)
        try:
            kind, payload = self._recv_q.get(timeout=timeout)
        except queue.Empty:
            raise TimeoutError("handshake timed out")
        if kind != "__handshake__":
            raise ConnectionClosed("unexpected frame during handshake")
        peer_info, peer_key = payload
        if node_id_from_pubkey(peer_key) != peer_info.node_id:
            raise ValueError("peer's public key does not match its node ID")
        return peer_info, peer_key

    def send_message(self, channel_id: int, message) -> None:
        if self._closed.is_set():
            raise ConnectionClosed("connection closed")
        self._send_q.put((channel_id, message))

    def receive_message(self, timeout: float | None = None) -> tuple[int, Any]:
        if self._closed.is_set():
            raise ConnectionClosed("connection closed")
        try:
            frame = self._recv_q.get(timeout=timeout)
        except queue.Empty:
            raise TimeoutError("receive timed out")
        if frame == self._CLOSE:
            self._closed.set()
            raise ConnectionClosed("connection closed by peer")
        return frame

    def local_endpoint(self) -> Endpoint:
        return Endpoint(protocol="memory", host=self.local_id, node_id=self.local_id)

    def remote_endpoint(self) -> Endpoint:
        return Endpoint(protocol="memory", host=self.remote_id, node_id=self.remote_id)

    def close(self) -> None:
        if not self._closed.is_set():
            self._closed.set()
            try:
                self._send_q.put_nowait(self._CLOSE)
            except queue.Full:
                pass
