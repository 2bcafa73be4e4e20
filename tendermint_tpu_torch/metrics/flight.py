"""In-run flight recorder: streamed time-series telemetry.

Everything else in the observability plane is scrape-or-die: /metrics
is sampled by an external scraper while the node lives, and the e2e
runner persists ONE final exposition at shutdown — a SIGKILL'd node
leaves cumulative totals with no way to recover *rates over time*
(was the churn steady, or a storm in the last 20 seconds?). The
FlightRecorder closes that gap from inside the process: a daemon
thread samples the node's registries on `instrumentation.flight-interval`
and APPENDS one compact delta record per tick to `timeseries.jsonl`
in the node home, flushing each line — whatever survives a SIGKILL is
a well-formed prefix plus at most one truncated tail line, which
the reference's lens/series.py tolerates.

Record stream (one JSON object per line):

    {"t": <unix>, "seq": 0, "c": {key: total}, "g": {key: value}}   # full anchor
    {"t": <unix>, "seq": n, "d": {key: delta}, "g": {key: value}}   # delta tick
    {"t": <unix>, "mark": "<label>"}                                 # bench stage marker

  - `c` / `d` carry CUMULATIVE series: counters, and histograms as
    `<name>_sum` / `<name>_count` (rates need sums and counts over
    time, not bucket vectors — windowed quantiles come from the live
    /metrics scrapes, lens/series.py).
  - `g` carries gauges, re-emitted only when the value changed (an
    AgeGauge changes every tick by construction — the head-age
    timeline is the point).
  - keys render as `name` or `name{k="v",...}` with exposition
    escaping, so the lens label parser reads them unchanged.
  - a full anchor is re-emitted every `full_every` ticks and whenever
    the recorder (re)starts, so a reader appending across restarts —
    or one that lost the head — can still reconstruct.

Disabled (`flight-interval = 0`, the production default) the recorder
is never constructed: zero threads, zero allocations, zero cost.
Enabled, one tick costs well under a millisecond against a full node
registry (FlightMetrics.sample_seconds carries the evidence; budget
documented in docs/observability.md#flight).
"""

from __future__ import annotations

import collections
import json
import threading
import time

from . import FlightMetrics, Histogram, Registry, _escape_label

__all__ = ["FlightRecorder", "TIMESERIES_NAME", "render_key"]

TIMESERIES_NAME = "timeseries.jsonl"


def render_key(name: str, labels: dict) -> str:
    """`name` or `name{k="v",...}` — exactly the exposition sample
    prefix, so lens parses flight keys with its existing label parser."""
    if not labels:
        return name
    lbl = ",".join(f'{k}="{_escape_label(v)}"' for k, v in labels.items())
    return f"{name}{{{lbl}}}"


class FlightRecorder:
    """Samples one or more registries on an interval into a JSONL
    time-series file. Thread-safe; `mark()` and `sample_once()` may be
    called from any thread (bench stages mark stage boundaries)."""

    def __init__(
        self,
        registries,
        path: str,
        interval: float = 1.0,
        metrics: FlightMetrics | None = None,
        full_every: int = 120,
        tail_keep: int = 256,
        samplers=(),
    ):
        if interval <= 0:
            raise ValueError("flight interval must be positive (0 disables at the call site)")
        self.registries: list[Registry] = list(registries)
        # opaque callables invoked before each registry sweep so other
        # planes can refresh gauges on the recorder's cadence (the
        # devobs HBM-residency sampler rides here). Callables keep this
        # module import-isolated from whatever plane supplies them.
        self.samplers = list(samplers)
        self.path = path
        self.interval = float(interval)
        self.metrics = metrics
        self.full_every = max(1, int(full_every))
        self._file = None
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._seq = 0
        self._prev_c: dict[str, float] = {}
        self._prev_g: dict[str, float] = {}
        # recent records for the flight_recorder RPC route (live tail
        # without re-reading the file)
        self.recent: collections.deque = collections.deque(maxlen=tail_keep)
        self.records_written = 0

    # ------------------------------------------------------------ sampling

    def _collect(self) -> tuple[dict[str, float], dict[str, float]]:
        """(cumulative, gauges) maps over every registry. Never raises:
        a broken metric must not kill the recorder thread."""
        cum: dict[str, float] = {}
        gauges: dict[str, float] = {}
        for reg in self.registries:
            for m in reg.metrics():
                try:
                    if isinstance(m, Histogram):
                        # exposition-style _sum/_count keys (same names
                        # lens already knows from metrics.txt scrapes)
                        for labels, total, count in m.totals():
                            cum[render_key(m.name + "_sum", labels)] = total
                            cum[render_key(m.name + "_count", labels)] = count
                        continue
                    samples = m.samples()
                    target = cum if m.kind == "counter" else gauges
                    for name, labels, value in samples:
                        target[render_key(name, labels)] = float(value)
                except Exception:  # noqa: BLE001 - telemetry never fails the node
                    continue
        return cum, gauges

    def sample_once(self) -> dict | None:
        """Take one sample and append the record. Returns the record
        (None when an I/O failure dropped it)."""
        t0 = time.perf_counter()
        for sampler in self.samplers:
            try:
                sampler()
            except Exception:  # noqa: BLE001 - a broken sampler must not kill the tick
                continue
        cum, gauges = self._collect()
        with self._lock:
            now = time.time()
            if self._seq % self.full_every == 0:
                rec = {"t": round(now, 3), "seq": self._seq, "c": cum, "g": gauges}
            else:
                deltas = {
                    k: v - self._prev_c.get(k, 0.0)
                    for k, v in cum.items()
                    if v != self._prev_c.get(k, 0.0)
                }
                changed = {
                    k: v for k, v in gauges.items() if v != self._prev_g.get(k)
                }
                rec = {"t": round(now, 3), "seq": self._seq}
                if deltas:
                    rec["d"] = deltas
                if changed:
                    rec["g"] = changed
            ok = self._append(rec)
            if ok:
                # only advance the baselines when the record actually
                # landed — otherwise the dropped tick's deltas would
                # vanish from the stream (the next tick would diff
                # against a snapshot no reader ever saw)
                self._seq += 1
                self._prev_c = cum
                self._prev_g = gauges
        if self.metrics is not None:
            self.metrics.sample_seconds.observe(time.perf_counter() - t0)
            if ok:
                self.metrics.records.add(1)
            else:
                self.metrics.dropped_samples.add(1)
        return rec if ok else None

    def tail(self, n: int) -> list[dict]:
        """The most recent `n` records from the in-memory ring,
        snapshotted under the lock (the sampler thread appends
        concurrently, and iterating a mutating deque raises in
        CPython). The RPC route's live-tail accessor."""
        if n <= 0:
            return []
        with self._lock:
            recent = list(self.recent)
        return recent[len(recent) - min(n, len(recent)):]

    def mark(self, label: str) -> None:
        """Append an instantaneous marker record (bench stage
        boundaries; the lens timeline surfaces them)."""
        with self._lock:
            self._append({"t": round(time.time(), 3), "mark": str(label)})

    def _append(self, rec: dict) -> bool:
        """Write + flush one line; caller holds the lock."""
        try:
            if self._file is None:
                self._file = open(self.path, "a", encoding="utf-8")
            self._file.write(json.dumps(rec, separators=(",", ":")) + "\n")
            self._file.flush()
            self.recent.append(rec)
            self.records_written += 1
            return True
        except OSError:
            return False

    # ----------------------------------------------------------- lifecycle

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="flight-recorder"
        )
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.sample_once()
            except Exception:  # noqa: BLE001 - recorder must outlive bugs
                if self.metrics is not None:
                    self.metrics.dropped_samples.add(1)

    def stop(self) -> None:
        """Stop the thread, take one final sample (the shutdown state
        is part of the timeline), and close the file."""
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0)
            self._thread = None
        try:
            self.sample_once()
        except Exception:  # noqa: BLE001
            pass
        with self._lock:
            if self._file is not None:
                try:
                    self._file.close()
                except OSError:
                    pass
                self._file = None
