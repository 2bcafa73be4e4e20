"""Pub/sub server (ref: internal/pubsub/pubsub.go).

Subscribers register a Query; published messages carry a flattened
event map and are delivered to every subscription whose query matches.
Bounded per-subscriber buffers: a full buffer terminates the
subscription (the reference's ErrTerminated semantics) so one slow
consumer cannot wedge the publisher.
"""

from __future__ import annotations

import itertools
import queue
import threading
from dataclasses import dataclass, field
from typing import Any

from .query import Query


@dataclass
class Message:
    data: Any = None
    events: dict[str, list[str]] = field(default_factory=dict)


class Subscription:
    """ref: internal/pubsub/subscription.go."""

    _ids = itertools.count(1)

    def __init__(self, subscriber: str, query: Query, buffer_size: int):
        self.id = f"sub-{next(self._ids)}"
        self.subscriber = subscriber
        self.query = query
        self._queue: queue.Queue = queue.Queue(maxsize=buffer_size)
        self.terminated = threading.Event()
        self.termination_reason: str | None = None

    _SENTINEL = object()

    def next(self, timeout: float | None = None) -> Message | None:
        """Block for the next message; None on timeout/termination."""
        if self.terminated.is_set() and self._queue.empty():
            return None
        try:
            item = self._queue.get(timeout=timeout)
        except queue.Empty:
            return None
        if item is self._SENTINEL:
            return None
        return item

    def _publish(self, msg: Message) -> bool:
        try:
            self._queue.put_nowait(msg)
            return True
        except queue.Full:
            return False

    def _terminate(self, reason: str) -> None:
        self.termination_reason = reason
        self.terminated.set()
        # wake any consumer blocked in next(timeout=None)
        try:
            self._queue.put_nowait(self._SENTINEL)
        except queue.Full:
            pass  # consumer isn't blocked; it will see `terminated` after draining


class Server:
    """ref: pubsub.go Server."""

    DEFAULT_BUFFER = 128

    def __init__(self):
        self._subs: dict[tuple[str, str], Subscription] = {}  # (subscriber, query-str)
        self._lock = threading.RLock()

    def subscribe(self, subscriber: str, query: Query, buffer_size: int | None = None) -> Subscription:
        with self._lock:
            key = (subscriber, str(query))
            if key in self._subs:
                raise ValueError(f"{subscriber} already subscribed to {query}")
            sub = Subscription(subscriber, query, buffer_size or self.DEFAULT_BUFFER)
            self._subs[key] = sub
            return sub

    def unsubscribe(self, subscriber: str, query: Query) -> None:
        with self._lock:
            sub = self._subs.pop((subscriber, str(query)), None)
        if sub is not None:
            sub._terminate("unsubscribed")

    def unsubscribe_all(self, subscriber: str) -> None:
        with self._lock:
            doomed = [k for k in self._subs if k[0] == subscriber]
            subs = [self._subs.pop(k) for k in doomed]
        for sub in subs:
            sub._terminate("unsubscribed")

    def num_clients(self) -> int:
        with self._lock:
            return len({k[0] for k in self._subs})

    def num_subscriptions(self) -> int:
        with self._lock:
            return len(self._subs)

    def publish(self, data: Any, events: dict[str, list[str]] | None = None) -> None:
        """Deliver to all matching subscriptions (ref: pubsub.go
        PublishWithEvents). Slow subscribers are terminated, not waited on."""
        events = events or {}
        msg = Message(data=data, events=events)
        with self._lock:
            matches = [s for s in self._subs.values() if s.query.matches(events)]
        dead = []
        for sub in matches:
            if not sub._publish(msg):
                dead.append(sub)
        if dead:
            with self._lock:
                for sub in dead:
                    self._subs.pop((sub.subscriber, str(sub.query)), None)
            for sub in dead:
                sub._terminate("slow subscriber")
