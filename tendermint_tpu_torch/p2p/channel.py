"""Channel — a typed duplex pipe between reactors and the router
(ref: internal/p2p/channel.go:41-230).

Reactors call `send` / `broadcast` / `send_error` and iterate `receive`.
The router owns the other ends of the queues.
"""

from __future__ import annotations

import queue
from typing import Iterator

from .types import ChannelDescriptor, Envelope, PeerError

_SENTINEL = object()


class Channel:
    def __init__(self, desc: ChannelDescriptor):
        self.desc = desc
        self.id = desc.id
        self.name = desc.name or f"ch{desc.id:#x}"
        # reactor → router
        self.out_queue: queue.Queue = queue.Queue(maxsize=desc.send_queue_capacity)
        # router → reactor
        self.in_queue: queue.Queue = queue.Queue(maxsize=desc.recv_buffer_capacity)
        # reactor → router peer errors
        self.error_queue: queue.Queue = queue.Queue(maxsize=64)
        self._closed = False

    # ---------------------------------------------------------- reactor API

    def send(self, envelope: Envelope, timeout: float | None = None) -> bool:
        """Enqueue an outbound envelope (ref: channel.go Send). Blocks when
        the send queue is full, mirroring backpressure semantics."""
        envelope.channel_id = self.id
        try:
            self.out_queue.put(envelope, timeout=timeout)
            return True
        except queue.Full:
            return False

    def broadcast(self, message, timeout: float | None = None) -> bool:
        return self.send(Envelope(message=message, broadcast=True), timeout=timeout)

    def send_to(self, peer_id: str, message, timeout: float | None = None) -> bool:
        return self.send(Envelope(message=message, to=peer_id), timeout=timeout)

    def send_error(self, peer_error: PeerError) -> None:
        """Report peer misbehavior → router evicts (ref: channel.go SendError)."""
        try:
            self.error_queue.put_nowait(peer_error)
        except queue.Full:
            pass

    def receive(self, timeout: float | None = None) -> Iterator[Envelope]:
        """Iterate inbound envelopes until the channel closes
        (ref: channel.go Receive iterator). With a timeout, stops
        iterating when no message arrives in time."""
        while not self._closed:
            try:
                item = self.in_queue.get(timeout=timeout)
            except queue.Empty:
                return
            if item is _SENTINEL:
                return
            yield item

    def receive_one(self, timeout: float | None = None) -> Envelope | None:
        try:
            item = self.in_queue.get(timeout=timeout)
        except queue.Empty:
            return None
        return None if item is _SENTINEL else item

    # ----------------------------------------------------------- router API

    def deliver(self, envelope: Envelope, timeout: float | None = 1.0) -> bool:
        """Router-side: push an inbound envelope to the reactor. Drops on
        sustained backpressure (the reference drops + logs too)."""
        if self._closed:
            return False
        try:
            self.in_queue.put(envelope, timeout=timeout)
            return True
        except queue.Full:
            return False

    def close(self) -> None:
        self._closed = True
        try:
            self.in_queue.put_nowait(_SENTINEL)
        except queue.Full:
            pass

    @property
    def closed(self) -> bool:
        return self._closed
