"""Event log — a reverse time-ordered sliding window of events backing
the polling `/events` RPC (ref: internal/eventlog/eventlog.go +
internal/eventlog/cursor/cursor.go).

New items enter at the head; items older than `window_ns` (or beyond
`max_items`) are pruned from the tail. Items are indexed by cursors
`<unix-microseconds>-<sequence>` which order lexicographically within a
log, exactly the reference's cursor format.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable


@dataclass(frozen=True, order=True)
class Cursor:
    """ref: eventlog/cursor/cursor.go Cursor."""

    timestamp: int = 0  # microseconds since epoch
    sequence: int = 0

    def __str__(self) -> str:
        return f"{self.timestamp:016x}-{self.sequence:04x}"

    @classmethod
    def parse(cls, s: str) -> "Cursor":
        if not s:
            return cls()
        ts, _, seq = s.partition("-")
        return cls(timestamp=int(ts, 16), sequence=int(seq, 16))

    def is_zero(self) -> bool:
        return self.timestamp == 0 and self.sequence == 0


@dataclass
class Item:
    """ref: eventlog.Item."""

    cursor: Cursor
    type: str  # event type key (e.g. "tm.event='NewBlock'" value)
    data: Any  # JSON-compatible payload
    events: dict[str, list[str]] = field(default_factory=dict)  # for query matching


class EventLog:
    """ref: eventlog.Log. One writer, many readers."""

    def __init__(self, window_ns: int = 30_000_000_000, max_items: int = 2000,
                 now: Callable[[], int] | None = None):
        self.window_ns = window_ns
        self.max_items = max_items
        self._now = now or time.time_ns
        self._lock = threading.Lock()
        self._items: list[Item] = []  # newest LAST (reversed on scan)
        self._seq = 0
        self._last_ts = 0
        self._ready = threading.Condition(self._lock)

    # --------------------------------------------------------------- write

    def add(self, etype: str, data: Any, events: dict[str, list[str]] | None = None) -> None:
        """ref: Log.Add — assigns the next cursor, prunes the window."""
        with self._lock:
            ts = self._now() // 1000  # microseconds
            if ts == self._last_ts:
                self._seq += 1
            else:
                self._last_ts, self._seq = ts, 0
            item = Item(cursor=Cursor(ts, self._seq), type=etype, data=data,
                        events=dict(events or {}))
            self._items.append(item)
            self._prune_locked(ts)
            self._ready.notify_all()

    def _prune_locked(self, newest_ts_us: int) -> None:
        min_ts = newest_ts_us - self.window_ns // 1000
        keep = [it for it in self._items if it.cursor.timestamp >= min_ts]
        if self.max_items and len(keep) > self.max_items:
            keep = keep[-self.max_items:]
        self._items = keep

    # ---------------------------------------------------------------- read

    def scan(self, *, before: Cursor | None = None, after: Cursor | None = None,
             max_items: int = 100, match: Callable[[Item], bool] | None = None
             ) -> tuple[list[Item], bool, Cursor, Cursor]:
        """Newest-first page of matching items.

        Returns (items, more, oldest, newest) like the reference's
        /events result: `more` = true when older matching items exist
        beyond the page (ref: rpc/core/events.go:40-96)."""
        with self._lock:
            snapshot = list(self._items)
        oldest = snapshot[0].cursor if snapshot else Cursor()
        newest = snapshot[-1].cursor if snapshot else Cursor()
        out: list[Item] = []
        more = False
        for it in reversed(snapshot):  # newest first
            if before is not None and not before.is_zero() and it.cursor >= before:
                continue
            if after is not None and not after.is_zero() and it.cursor <= after:
                break  # older than the after-cursor: done
            if match is not None and not match(it):
                continue
            if len(out) >= max_items > 0:
                more = True
                break
            out.append(it)
        return out, more, oldest, newest

    def wait_scan(self, *, after: Cursor | None = None, max_items: int = 100,
                  match: Callable[[Item], bool] | None = None, timeout: float = 0.0
                  ) -> tuple[list[Item], bool, Cursor, Cursor]:
        """Long-poll variant: if the page is empty, wait up to `timeout`
        for a new matching item (ref: Log.WaitScan)."""
        deadline = time.monotonic() + timeout
        while True:
            items, more, oldest, newest = self.scan(after=after, max_items=max_items, match=match)
            if items or timeout <= 0:
                return items, more, oldest, newest
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return items, more, oldest, newest
            with self._ready:
                self._ready.wait(timeout=min(remaining, 0.5))
