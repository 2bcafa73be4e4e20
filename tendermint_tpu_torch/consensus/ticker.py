"""Timeout ticker (ref: internal/consensus/ticker.go:18-135).

One pending timeout at a time, and — the load-bearing subtlety — a new
schedule is IGNORED unless its (height, round, step) is strictly newer
than the last one scheduled (ticker.go:99-110 "ignore tickers for old
height/round/step"). Without the gate, a stale re-schedule (e.g.
scheduleRound0 after a WAL catchup replay that already advanced into
the propose step) replaces the armed later-step timer with one the
state machine's own HRS gate then discards — leaving NO timer armed and
the node wedged mid-height. The last-scheduled HRS persists across
fires, exactly as the reference's timeoutRoutine keeps `ti` after
relaying to tockChan.
"""

from __future__ import annotations

import threading
from typing import Callable

from .wal import TimeoutInfo


class TimeoutTicker:
    def __init__(self, fire: Callable[[TimeoutInfo], None]):
        self._fire = fire
        self._lock = threading.Lock()
        self._timer: threading.Timer | None = None
        self._last: TimeoutInfo | None = None

    def schedule_timeout(self, ti: TimeoutInfo) -> None:
        with self._lock:
            old = self._last
            if old is not None:
                # ref ticker.go:99-110: ignore older height/round/step
                if ti.height < old.height:
                    return
                if ti.height == old.height:
                    if ti.round < old.round:
                        return
                    if ti.round == old.round and old.step > 0 and ti.step <= old.step:
                        return
            if self._timer is not None:
                self._timer.cancel()
            t = threading.Timer(ti.duration_s, self._fire, args=(ti,))
            t.daemon = True
            self._timer = t
            self._last = ti
            t.start()

    def stop(self) -> None:
        with self._lock:
            if self._timer is not None:
                self._timer.cancel()
                self._timer = None
