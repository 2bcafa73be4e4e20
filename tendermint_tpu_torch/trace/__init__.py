"""In-process span tracing for the port's dispatch plane.

A copy of the JAX package's tracer (tendermint_tpu/trace/__init__.py),
standard library only. The verification engine (ops/engine.py) and the
device dispatch it fronts decide, batch by batch, which callers share a
launch, which plane runs it and how much of one batch's host work overlaps
another's kernels; aggregate metrics cannot show that. This module records
named spans into a process-wide, thread-safe ring buffer and exports them
as Chrome-trace / Perfetto JSON ("trace event format").

  - Disabled (the default), span() returns a shared no-op context manager
    after one dict lookup: no allocation, no clock read, no lock.
    TM_TPU_TRACE=1 (on/true/yes) enables it at import; set_enabled() flips
    it at run time.
  - Events land in a deque(maxlen=N) (TM_TPU_TRACE_BUF, default 65536)
    under a lock taken only on the enabled path, at span exit. A malformed
    value of either knob is forgiven (the defaults hold).
  - Spans accept a `flow` id (new_flow()): the engine stamps each submitted
    job with one, so the caller's submit span and the workers' dispatch and
    collect spans share it, and export() draws the arrows between them.

Span catalog of the port: verify.commit_dispatch / verify.commit_collect /
verify.direct_host (types/validation.py, crypto/), engine.submit /
engine.coalesce / engine.dispatch / engine.host_verify / engine.collect
(ops/engine.py), ops.verify_dispatch / ops.msm_dispatch / ops.pk_cache_fill
(ops/), sharded.verify (parallel/), device.h2d / device.d2h /
device.compile (devobs/).

journey_key() derives a deterministic id for one chain event from (height,
round, kind, originator), so spans of one event stay attributable across
coalesced launches.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from collections import deque

__all__ = [
    "enabled",
    "set_enabled",
    "span",
    "instant",
    "annotate",
    "new_flow",
    "journey_key",
    "now_us",
    "complete",
    "counter",
    "clear",
    "export",
    "export_json",
    "save",
]

_STATE = {
    "on": os.environ.get("TM_TPU_TRACE", "").strip().lower() in ("1", "on", "true", "yes"),
}
try:
    _CAPACITY = int(os.environ.get("TM_TPU_TRACE_BUF", "65536"))
    if _CAPACITY < 0:
        raise ValueError(_CAPACITY)
except ValueError:
    # forgiving like TM_TPU_TRACE itself: a malformed observability
    # knob must not stop the node from importing/booting
    _CAPACITY = 65536

# Ring of finished events. Each entry is a dict already shaped like a
# Chrome-trace event minus pid (stamped at export). deque.append is
# atomic, but the lock also guards clear()/export() snapshots.
_EVENTS: deque = deque(maxlen=_CAPACITY)
_LOCK = threading.Lock()
_FLOW_IDS = itertools.count(1)
_LOCAL = threading.local()


def enabled() -> bool:
    return _STATE["on"]


def set_enabled(on: bool) -> None:
    """Flip tracing at runtime (tests, bench stages, RPC debug)."""
    _STATE["on"] = bool(on)


def new_flow() -> int:
    """Fresh correlation id for spans that cross threads."""
    return next(_FLOW_IDS)


def journey_key(height: int, round_: int, kind: str, origin: str = "") -> str:
    """Deterministic cross-node journey id for one chain event: every
    node derives the same key from (height, round, kind, originator
    node id) with no clock alignment or coordination. `origin` is the
    node id of whichever node ORIGINATED the event (frame sender,
    proposer); pass "" for events whose identity is already unique per
    (height, round, kind) — e.g. a commit's verification — so all
    nodes share one key. Spans/instants carry it as args.journey."""
    return f"{int(height)}/{int(round_)}/{kind}@{(origin or '-')[:16]}"


def _now_us() -> float:
    return time.perf_counter_ns() / 1000.0


def now_us() -> float:
    """Current trace-clock timestamp (µs). Callers that need to emit a
    RETROSPECTIVE span (see complete()) capture this at the event's
    start — e.g. the first vote of a (height, round, type) — and emit
    once the end is known."""
    return _now_us()


def _stack() -> list:
    st = getattr(_LOCAL, "stack", None)
    if st is None:
        st = _LOCAL.stack = []
    return st


class _NoopSpan:
    """Shared disabled-path span: no state, no clock, no lock."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def annotate(self, **kv):
        pass


_NOOP = _NoopSpan()


class _Span:
    __slots__ = ("name", "cat", "args", "_t0", "_tid", "_tname")

    def __init__(self, name: str, cat: str, args: dict):
        self.name = name
        self.cat = cat
        self.args = args

    def __enter__(self):
        t = threading.current_thread()
        self._tid = t.ident or 0
        self._tname = t.name
        _stack().append(self)
        self._t0 = _now_us()
        return self

    def __exit__(self, *exc):
        t1 = _now_us()
        st = _stack()
        if st and st[-1] is self:
            st.pop()
        ev = {
            "name": self.name,
            "cat": self.cat or "tm",
            "ph": "X",
            "ts": self._t0,
            "dur": t1 - self._t0,
            "tid": self._tid,
            "tname": self._tname,
        }
        if self.args:
            ev["args"] = self.args
        with _LOCK:
            _EVENTS.append(ev)
        return False

    def annotate(self, **kv):
        self.args.update(kv)


def span(name: str, cat: str = "", **args):
    """Context manager recording one complete ("X") event. Disabled
    path returns the shared no-op after a single dict lookup."""
    if not _STATE["on"]:
        return _NOOP
    return _Span(name, cat, args)


def annotate(**kv) -> None:
    """Attach args to the innermost open span on THIS thread."""
    if not _STATE["on"]:
        return
    st = _stack()
    if st:
        st[-1].args.update(kv)


def instant(name: str, cat: str = "", **args) -> None:
    """One instant ("i") event — step transitions, demux wakeups."""
    if not _STATE["on"]:
        return
    t = threading.current_thread()
    ev = {
        "name": name,
        "cat": cat or "tm",
        "ph": "i",
        "s": "t",  # thread-scoped instant
        "ts": _now_us(),
        "tid": t.ident or 0,
        "tname": t.name,
    }
    if args:
        ev["args"] = args
    with _LOCK:
        _EVENTS.append(ev)


def complete(name: str, cat: str, ts_us: float, dur_us: float, **args) -> None:
    """One complete ("X") event with EXPLICIT timestamps — for spans
    whose start is only recognized in hindsight (quorum assembly: the
    first vote's arrival becomes the span start once 2/3 is reached;
    part reassembly: the first part's arrival once the set completes).
    `ts_us` must come from now_us() so the event shares the ring's
    clock."""
    if not _STATE["on"]:
        return
    t = threading.current_thread()
    ev = {
        "name": name,
        "cat": cat or "tm",
        "ph": "X",
        "ts": ts_us,
        "dur": max(0.0, dur_us),
        "tid": t.ident or 0,
        "tname": t.name,
    }
    if args:
        ev["args"] = args
    with _LOCK:
        _EVENTS.append(ev)


def counter(name: str, value: float, cat: str = "") -> None:
    """One counter ("C") sample — queue depths over time."""
    if not _STATE["on"]:
        return
    t = threading.current_thread()
    with _LOCK:
        _EVENTS.append({
            "name": name,
            "cat": cat or "tm",
            "ph": "C",
            "ts": _now_us(),
            "tid": t.ident or 0,
            "tname": t.name,
            "args": {"value": value},
        })


def clear() -> None:
    with _LOCK:
        _EVENTS.clear()


def export() -> dict:
    """Snapshot the ring as a Chrome-trace JSON object (the
    `traceEvents` array format Perfetto and chrome://tracing open
    directly). Thread-name metadata events and per-flow s/f arrows are
    synthesized here so the hot path never pays for them."""
    pid = os.getpid()
    with _LOCK:
        events = list(_EVENTS)
    out = []
    tnames: dict[int, str] = {}
    flows: dict[int, list] = {}
    for ev in events:
        e = dict(ev)
        tname = e.pop("tname", None)
        if tname and e["tid"] not in tnames:
            tnames[e["tid"]] = tname
        e["pid"] = pid
        # fid 0 is the "tracing was off at submit" sentinel (jobs in
        # flight across a live-enable): never synthesize arrows for it —
        # it would draw one false causality chain across unrelated spans
        fid = (e.get("args") or {}).get("flow")
        if fid and e["ph"] == "X":
            flows.setdefault(fid, []).append(e)
        out.append(e)
    for tid, name in tnames.items():
        out.append({
            "name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
            "args": {"name": name},
        })
    # Flow arrows: one s at the first span's start, one f at the last
    # span's end, binding the enclosing slices (bp: "e").
    for fid, evs in flows.items():
        if len(evs) < 2:
            continue
        evs.sort(key=lambda e: e["ts"])
        first, last = evs[0], evs[-1]
        out.append({
            "name": "flow", "cat": "tm.flow", "ph": "s", "id": fid,
            "pid": pid, "tid": first["tid"], "ts": first["ts"],
        })
        out.append({
            "name": "flow", "cat": "tm.flow", "ph": "f", "bp": "e", "id": fid,
            "pid": pid, "tid": last["tid"], "ts": last["ts"] + last.get("dur", 0),
        })
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def export_json() -> str:
    return json.dumps(export())


def save(path: str) -> int:
    """Write the Chrome-trace JSON to path; returns the event count."""
    doc = export()
    with open(path, "w") as f:
        json.dump(doc, f)
    return len(doc["traceEvents"])
