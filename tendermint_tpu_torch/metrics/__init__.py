"""Prometheus-compatible metrics for the port's dispatch plane.

A trimmed copy of the JAX package's metrics module
(tendermint_tpu/metrics/__init__.py): the Counter / Gauge / Histogram
primitives with label support, the Registry that renders the Prometheus
text exposition format (`gather()`), the two process-wide metric groups of
the verification plane, EngineMetrics (tendermint_engine_*: the coalescing
engine of ops/engine.py, the direct dispatch of crypto/, the kernel
launches of ops/ and the sharded launches of parallel/) and DeviceMetrics
(tendermint_device_*: devobs/), and the two of the hash plane, HashMetrics
(tendermint_hash_*: the merkle builds of crypto/merkle.py and the hash
memos of types/) and ProofMetrics (tendermint_proofs_*: the multiproof
builds and the tree cache), the evidence plane's EvidenceMetrics
(tendermint_evidence_*: evidence/verify.py and evidence/pool.py), the
state layer's StateMetrics (tendermint_state_*: state/execution.py), and
the P2PMetrics (tendermint_p2p_*: p2p/router.py, p2p/peermanager.py) and
BlockSyncMetrics (tendermint_blocksync_*: blocksync/reactor.py) of
blocksync and the p2p layer beneath it, and ConsensusMetrics
(tendermint_consensus_*: consensus/state.py) and MempoolMetrics
(tendermint_mempool_*: mempool/mempool.py) of consensus on one node,
FlightMetrics (tendermint_flight_*: the node's flight recorder,
metrics/flight.py), StateSyncMetrics (tendermint_statesync_*:
statesync/reactor.py, statesync/syncer.py), and the node's PrometheusServer, which serves a node's
registry and the process-global one over HTTP. Names,
labels, help strings and buckets are the reference's, so one scrape reads
both packages alike.

Metric writes never raise (`_never_raise`): a telemetry fault must not
kill the engine's workers. Reads (`samples`, `gather`) stay loud.
"""

from __future__ import annotations

import functools
import sys
import threading
import time
from typing import Sequence

NAMESPACE = "tendermint"  # ref: config.Instrumentation.Namespace default

# Metric writes sit on hot paths whose real work must never be failed
# by telemetry (a metrics bug in the verify engine's dispatch/collect
# workers would kill a daemon thread and hang every caller). The write
# methods therefore swallow everything, logging once per metric
# instance so a misuse bug is still visible without flooding. Read
# paths (samples/gather) stay loud — a broken scrape should be seen at
# the scraper.
def _never_raise(fn):
    @functools.wraps(fn)
    def wrapped(self, *args, **kwargs):
        try:
            fn(self, *args, **kwargs)
        except Exception as e:  # noqa: BLE001
            # racing threads may warn twice for one instance; harmless
            if getattr(self, "_warned_drop", False):
                return
            self._warned_drop = True
            try:
                sys.stderr.write(
                    f"metrics: dropped {fn.__name__} on {self.name} "
                    f"({type(e).__name__}: {e}); further errors for this "
                    "metric are silent\n"
                )
            except Exception:  # noqa: BLE001
                pass
    return wrapped


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help_: str, labels: Sequence[str] = ()):
        self.name = name
        self.help = help_
        self.label_names = tuple(labels)
        self._lock = threading.Lock()
        self._children: dict[tuple, float] = {}

    def _key(self, label_values: tuple) -> tuple:
        if len(label_values) != len(self.label_names):
            raise ValueError(f"{self.name}: expected labels {self.label_names}")
        return label_values

    def samples(self) -> list[tuple[str, dict, float]]:
        with self._lock:
            return [
                (self.name, dict(zip(self.label_names, k)), v)
                for k, v in self._children.items()
            ]

    @_never_raise
    def remove(self, *label_values: str) -> None:
        """Drop one labeled child (a disconnected peer's gauge would
        otherwise linger on the scrape forever)."""
        k = self._key(label_values)
        with self._lock:
            self._children.pop(k, None)


class Counter(_Metric):
    kind = "counter"

    @_never_raise
    def add(self, delta: float = 1.0, *label_values: str) -> None:
        k = self._key(label_values)
        with self._lock:
            self._children[k] = self._children.get(k, 0.0) + delta


class Gauge(_Metric):
    kind = "gauge"

    @_never_raise
    def set(self, value: float, *label_values: str) -> None:
        k = self._key(label_values)
        with self._lock:
            self._children[k] = float(value)

    @_never_raise
    def add(self, delta: float, *label_values: str) -> None:
        k = self._key(label_values)
        with self._lock:
            self._children[k] = self._children.get(k, 0.0) + delta


class AgeGauge(Gauge):
    """Gauge whose exported value is the seconds since the last mark().

    The freshness-at-scrape-time problem: a plain "last block committed
    at T" gauge needs the scraper to know its own wall clock AND trust
    the node's, while "seconds since" computed at sample time needs
    neither — tmlens reads a persisted exposition long after the run
    and still sees how stale the chain head was when the scrape
    happened (the liveness-stall gate keys off exactly this)."""

    @_never_raise
    def mark(self, ts: float | None = None) -> None:
        """Record the event (default: now, wall clock)."""
        with self._lock:
            self._children[()] = float(ts if ts is not None else time.time())

    def samples(self):
        with self._lock:
            marked = self._children.get(())
        if marked is None:
            return []
        return [(self.name, {}, max(0.0, time.time() - marked))]


def bucket_quantile(q: float, bounds, cumulative, total) -> float | None:
    """Estimate the q-quantile from cumulative histogram bucket counts
    (Prometheus `histogram_quantile` semantics: linear interpolation
    inside the first bucket whose cumulative count reaches rank q*total;
    ranks past the last finite bound clamp to that bound — the estimate
    can never exceed the histogram's top bucket).

    `bounds` are the FINITE upper bounds in ascending order, `cumulative`
    the matching cumulative counts (each bucket counts every observation
    <= its bound), `total` the +Inf count. Returns None on an empty
    histogram. Both the live `Histogram.quantile` method and the tmlens
    exposition analyzer route through here so a p99 computed from a
    node's in-memory state and one computed from its scraped metrics.txt
    agree."""
    if total <= 0 or not bounds:
        return None
    rank = q * total
    prev_ub, prev_cum = 0.0, 0.0
    for ub, cum in zip(bounds, cumulative):
        if cum >= rank:
            if ub <= prev_ub:  # degenerate/negative bounds: no interpolation
                return float(ub)
            span = cum - prev_cum
            frac = (rank - prev_cum) / span if span > 0 else 1.0
            return float(prev_ub + (ub - prev_ub) * frac)
        prev_ub, prev_cum = ub, cum
    return float(bounds[-1])


class Histogram(_Metric):
    kind = "histogram"

    DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 2.5, 5.0, 10.0)

    def __init__(self, name, help_, labels=(), buckets: Sequence[float] | None = None):
        super().__init__(name, help_, labels)
        self.buckets = tuple(buckets) if buckets is not None else self.DEFAULT_BUCKETS
        self._hist: dict[tuple, list] = {}  # key -> [bucket_counts, sum, count]

    @_never_raise
    def observe(self, value: float, *label_values: str) -> None:
        k = self._key(label_values)
        with self._lock:
            h = self._hist.get(k)
            if h is None:
                h = [[0] * len(self.buckets), 0.0, 0]
                self._hist[k] = h
            for i, ub in enumerate(self.buckets):
                if value <= ub:
                    h[0][i] += 1
            h[1] += value
            h[2] += 1

    @_never_raise
    def observe_many(self, values, *label_values: str) -> None:
        """Fold a whole batch of observations under ONE lock hold —
        batched admission records per-tx sizes without paying a lock
        handoff plus bucket walk wrapper per tx."""
        k = self._key(label_values)
        with self._lock:
            h = self._hist.get(k)
            if h is None:
                h = [[0] * len(self.buckets), 0.0, 0]
                self._hist[k] = h
            counts = h[0]
            total = 0.0
            for value in values:
                for i, ub in enumerate(self.buckets):
                    if value <= ub:
                        counts[i] += 1
                total += value
            h[1] += total
            h[2] += len(values)

    def totals(self) -> list[tuple[dict, float, float]]:
        """[(labels, sum, count)] per child — the flight recorder's
        compact cumulative view of a histogram (windowed rates need
        sums/counts over time, not the bucket vector)."""
        with self._lock:
            return [
                (dict(zip(self.label_names, k)), h[1], float(h[2]))
                for k, h in self._hist.items()
            ]

    def quantile(self, q: float, *label_values: str) -> float | None:
        """Bucket-interpolated quantile estimate for one labeled child
        (observe() keeps per-bucket counts cumulative, so they feed
        bucket_quantile directly). None for an empty/unknown child or a
        q outside [0, 1] — a read path, so bad args raise like
        samples() does."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} outside [0, 1]")
        k = self._key(label_values)
        with self._lock:
            h = self._hist.get(k)
            if h is None:
                return None
            counts, _total, n = list(h[0]), h[1], h[2]
        return bucket_quantile(q, self.buckets, counts, n)

    def samples(self):
        out = []
        with self._lock:
            for k, (counts, total, n) in self._hist.items():
                labels = dict(zip(self.label_names, k))
                cum = 0
                for i, ub in enumerate(self.buckets):
                    cum = counts[i]
                    out.append((self.name + "_bucket", {**labels, "le": _fmt(ub)}, cum))
                out.append((self.name + "_bucket", {**labels, "le": "+Inf"}, n))
                out.append((self.name + "_sum", labels, total))
                out.append((self.name + "_count", labels, n))
        return out


def _fmt(v: float) -> str:
    return repr(v) if v != int(v) else str(int(v))


class Registry:
    def __init__(self):
        self._metrics: list[_Metric] = []
        self._lock = threading.Lock()

    def register(self, metric: _Metric) -> _Metric:
        with self._lock:
            self._metrics.append(metric)
        return metric

    def metrics(self) -> list[_Metric]:
        """Snapshot of the registered metric objects (the flight
        recorder walks these directly instead of re-parsing gather()
        text every sample tick)."""
        with self._lock:
            return list(self._metrics)

    def counter(self, name, help_="", labels=()) -> Counter:
        return self.register(Counter(name, help_, labels))

    def gauge(self, name, help_="", labels=()) -> Gauge:
        return self.register(Gauge(name, help_, labels))

    def histogram(self, name, help_="", labels=(), buckets=None) -> Histogram:
        return self.register(Histogram(name, help_, labels, buckets))

    def gather(self) -> str:
        """Prometheus text exposition format."""
        lines: list[str] = []
        with self._lock:
            metrics = list(self._metrics)
        for m in metrics:
            lines.append(f"# HELP {m.name} {_escape_help(m.help)}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            for name, labels, value in m.samples():
                if labels:
                    lbl = ",".join(
                        f'{k}="{_escape_label(v)}"' for k, v in labels.items()
                    )
                    lines.append(f"{name}{{{lbl}}} {_num(value)}")
                else:
                    lines.append(f"{name} {_num(value)}")
        return "\n".join(lines) + "\n" if lines else ""


def _num(v: float) -> str:
    return str(int(v)) if float(v).is_integer() else repr(float(v))


def _escape_label(v) -> str:
    """Label-value escaping per the text exposition format: backslash,
    double-quote, and line feed. Faultnet link names ("a->b") and any
    future free-form label would otherwise corrupt the exposition."""
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _escape_help(v: str) -> str:
    """HELP-line escaping: backslash and line feed (quotes are legal)."""
    return str(v).replace("\\", "\\\\").replace("\n", "\\n")


# ---------------------------------------------------------- groups


class EngineMetrics:
    """Telemetry for the coalescing verification engine (ops/engine.py)
    and the device dispatch it fronts (ops/verify.py, ops/verify_sr.py,
    ops/msm.py, parallel/sharded_verify.py, the crypto batch
    verifiers): queue depth and wait, the rows and jobs each coalesced
    launch carries, dispatch and collect latency, their overlap, rows by
    path and outcome, the live cutovers and the kernel launches by kernel.
    The same series as the JAX package's EngineMetrics. Registered on the
    process-global registry (global_registry()): the engine is
    process-wide."""

    def __init__(self, reg: Registry):
        ns = f"{NAMESPACE}_engine"
        self.queue_depth = reg.gauge(
            f"{ns}_queue_depth", "Jobs pending in the engine submission queue"
        )
        self.inflight_batches = reg.gauge(
            f"{ns}_inflight_batches", "Dispatched batches awaiting collect"
        )
        self.submitted_jobs = reg.counter(
            f"{ns}_submitted_jobs_total", "Jobs submitted to the engine", labels=("plane",)
        )
        self.submitted_sigs = reg.counter(
            f"{ns}_submitted_sigs_total", "Signatures submitted to the engine", labels=("plane",)
        )
        self.coalesced_group_size = reg.histogram(
            f"{ns}_coalesced_group_size",
            "Caller jobs merged per coalesced launch",
            buckets=(1, 2, 3, 4, 6, 8, 12, 16, 24, 32),
        )
        self.coalesce_factor = reg.histogram(
            f"{ns}_coalesce_factor_rows",
            "Signature rows per coalesced launch",
            buckets=(1, 4, 16, 64, 256, 1024, 4096, 8192),
        )
        self.queue_wait = reg.histogram(
            f"{ns}_queue_wait_seconds",
            "submit-to-dispatch wait of the oldest job in each group",
            buckets=(0.0001, 0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1),
        )
        self.launch_latency = reg.histogram(
            f"{ns}_launch_latency_seconds",
            "Dispatch-stage wall time per batch (host prep + async launch)",
            buckets=(0.0001, 0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1, 5),
        )
        self.collect_latency = reg.histogram(
            f"{ns}_collect_latency_seconds",
            "Collect-stage wall time per batch (device block + demux)",
            buckets=(0.0001, 0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1, 5),
        )
        self.overlap_seconds = reg.counter(
            f"{ns}_overlap_seconds_total",
            "Seconds the dispatch stage ran concurrently with a collect",
        )
        self.overlap_ratio = reg.gauge(
            f"{ns}_overlap_ratio",
            "Cumulative dispatch/collect overlap over cumulative collect time",
        )
        self.path_rows = reg.counter(
            f"{ns}_path_rows_total",
            "Signature rows by verification path and outcome",
            labels=("plane", "path", "status"),
        )
        self.launches = reg.counter(
            f"{ns}_launches_total",
            "Verification launches by path",
            labels=("plane", "path"),
        )
        self.device_batch_cutover = reg.gauge(
            f"{ns}_device_batch_cutover",
            "Live device-launch cutover (env pin or autotune result)",
        )
        self.msm_batch_cutover = reg.gauge(
            f"{ns}_msm_batch_cutover",
            "Live two-phase-MSM cutover (env pin or autotune result)",
        )
        self.autotuned = reg.gauge(
            f"{ns}_autotuned", "1 after the autotune microprobe updated a cutover"
        )
        self.host_pool_active = reg.gauge(
            f"{ns}_host_pool_active", "Host-plane verifies currently executing"
        )
        self.host_pool_busy_seconds = reg.counter(
            f"{ns}_host_pool_busy_seconds_total", "Cumulative host-plane verify time"
        )
        self.sharded_launches = reg.counter(
            f"{ns}_sharded_launches_total",
            "Mesh-sharded launches by path",
            labels=("path",),
        )
        self.kernel_launches = reg.counter(
            f"{ns}_kernel_launches_total",
            "Device kernel dispatches by kernel (cache fills included)",
            labels=("kernel",),
        )

    def observe_path(self, plane: str, path: str, bools) -> None:
        """Fold one launch's per-row outcomes into the path counters."""
        self.observe_path_counts(plane, path, len(bools), sum(1 for b in bools if b))

    def observe_path_counts(self, plane: str, path: str, n: int, accepted: int) -> None:
        self.launches.add(1, plane, path)
        if accepted:
            self.path_rows.add(accepted, plane, path, "accept")
        if n - accepted:
            self.path_rows.add(n - accepted, plane, path, "reject")

    def observe_direct(self, plane: str, path: str, n: int, accepted: int) -> None:
        """A direct-dispatch (TM_TPU_ENGINE=off) launch, labeled
        direct_* so the scheduler's coalesced launches stay
        distinguishable from per-caller ones."""
        self.observe_path_counts(plane, f"direct_{path}", n, accepted)


class FlightMetrics:
    """Self-telemetry for the in-run flight recorder
    (metrics/flight.py): how many timeseries.jsonl records this node
    appended and what one sample tick costs. The sample-cost histogram
    is the overhead evidence — docs/observability.md#flight documents
    the enabled-cost budget (<=1% of a bench mempool stage) against it.

    No reference analog — the reference has no in-process recorder;
    operators scrape externally. Registered on the NODE registry (the
    recorder is per-node state, not process-global)."""

    def __init__(self, reg: Registry):
        ns = f"{NAMESPACE}_flight"
        self.records = reg.counter(
            f"{ns}_records_total", "Timeseries records appended since boot"
        )
        self.sample_seconds = reg.histogram(
            f"{ns}_sample_seconds",
            "Wall time of one flight-recorder sample tick (gather + diff + append)",
            buckets=(0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.05, 0.25),
        )
        self.dropped_samples = reg.counter(
            f"{ns}_dropped_samples_total",
            "Sample ticks that failed to append (I/O errors; recorder keeps running)",
        )


class DeviceMetrics:
    """Telemetry for the device itself (devobs/): kernel builds and loads
    (the compile series; the help strings are the reference's, whose
    compiles were XLA's), host<->device transfer bytes and counts by
    direction, and device-memory residency with its high-water mark and
    the resident bytes of each cache plane. The same series as the JAX
    package's DeviceMetrics. Registered on the process-global registry:
    the dispatch plane is process-wide."""

    def __init__(self, reg: Registry):
        ns = f"{NAMESPACE}_device"
        self.compiles = reg.counter(
            f"{ns}_compiles_total",
            "XLA backend compiles by dispatching kernel fn",
            labels=("fn",),
        )
        self.bucket_compiles = reg.counter(
            f"{ns}_bucket_compiles_total",
            "Backend compiles by kernel fn and intended batch bucket (rows)",
            labels=("fn", "rows"),
        )
        self.compile_seconds = reg.histogram(
            f"{ns}_compile_seconds",
            "Wall time of one XLA backend compile",
            buckets=(0.01, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10, 30, 60),
        )
        self.compile_cache_events = reg.counter(
            f"{ns}_compile_cache_events_total",
            "Persistent compilation-cache events (hit/miss/task)",
            labels=("event",),
        )
        self.transfer_bytes = reg.counter(
            f"{ns}_transfer_bytes_total",
            "Host<->device transfer bytes by direction (h2d/d2h)",
            labels=("dir",),
        )
        self.transfers = reg.counter(
            f"{ns}_transfers_total",
            "Host<->device transfers by direction (h2d/d2h)",
            labels=("dir",),
        )
        self.live_buffer_bytes = reg.gauge(
            f"{ns}_live_buffer_bytes",
            "Device-resident bytes at last residency sample "
            "(memory_stats bytes_in_use, else sum of live-array nbytes)",
        )
        self.live_buffers = reg.gauge(
            f"{ns}_live_buffers", "Live device arrays at last residency sample"
        )
        self.live_buffer_high_water = reg.gauge(
            f"{ns}_live_buffer_high_water_bytes",
            "Peak device-resident bytes observed by any residency sample",
        )
        self.cache_resident_bytes = reg.gauge(
            f"{ns}_cache_resident_bytes",
            "Device bytes held by a cache plane's resident tables",
            labels=("plane",),
        )
        self.cache_resident_entries = reg.gauge(
            f"{ns}_cache_resident_entries",
            "Occupied LRU slots in a cache plane's resident tables",
            labels=("plane",),
        )
        self.residency_samples = reg.counter(
            f"{ns}_residency_samples_total",
            "HBM-residency sampler ticks taken",
        )


class HashMetrics:
    """Telemetry for the structural-hash plane: the batched SHA-256 and
    merkle builders (native/prep.c tm_merkle_root / tm_sha256_batch and
    the iterative crypto/merkle.py fallback) and the memoized hashes of
    the block types (ValidatorSet.hash, Header.hash, Commit.hash). Per-site
    build counters show where hash work goes (header / txs / commit /
    validator_set); the backend label says which plane served it (native
    or python); the cache counters make memo hits and invalidations
    visible. The reference's series; registered on the process-global
    registry, as the types are process-wide."""

    def __init__(self, reg: Registry):
        ns = f"{NAMESPACE}_hash"
        self.merkle_builds = reg.counter(
            f"{ns}_merkle_builds_total",
            "Merkle tree builds by call site and backend",
            labels=("site", "backend"),
        )
        self.merkle_leaves = reg.histogram(
            f"{ns}_merkle_leaves",
            "Leaves per merkle build",
            labels=("site",),
            buckets=(1, 2, 4, 8, 16, 64, 256, 1024, 4096, 16384),
        )
        self.merkle_build_seconds = reg.histogram(
            f"{ns}_merkle_build_seconds",
            "Wall time per merkle build (leaf hashing included)",
            labels=("backend",),
            buckets=(0.000005, 0.00002, 0.0001, 0.0005, 0.002, 0.01, 0.05, 0.25, 1),
        )
        self.sha256_batches = reg.counter(
            f"{ns}_sha256_batches_total",
            "Batched leaf/tx SHA-256 calls by backend",
            labels=("backend",),
        )
        self.cache_events = reg.counter(
            f"{ns}_cache_events_total",
            "Structural-hash memo events (hit/miss/invalidate) by site",
            labels=("site", "event"),
        )


class ProofMetrics:
    """Telemetry for the batched proof plane: the multiproof builders
    (crypto/merkle.py, prep.c tm_merkle_multiproof) and the hot-tree LRU
    (crypto/merkle.TreeCache). The reference's series, whose served and
    serve-time families its proof gateway writes (the port has no gateway
    yet, so they stay empty here); registered on the process-global
    registry, as the merkle plane is process-wide."""

    def __init__(self, reg: Registry):
        ns = f"{NAMESPACE}_proofs"
        self.served = reg.counter(
            f"{ns}_served_total",
            "Proofs served by gateway route and answering backend",
            labels=("route", "backend"),
        )
        self.batch_size = reg.histogram(
            f"{ns}_multiproof_batch_size",
            "Indices proven per multiproof request",
            buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 4096),
        )
        self.serve_seconds = reg.histogram(
            f"{ns}_serve_seconds",
            "Wall time serving one proof-gateway request",
            labels=("route",),
            buckets=(0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
                     0.025, 0.05, 0.1, 0.25, 0.5, 1.0),
        )
        self.tree_cache_events = reg.counter(
            f"{ns}_tree_cache_events_total",
            "Hot-tree LRU events (hit/miss/evict)",
            labels=("event",),
        )


class StateSyncMetrics:
    """ref: internal/statesync/metrics.go."""

    def __init__(self, reg: Registry):
        ns = f"{NAMESPACE}_statesync"
        self.snapshots_discovered = reg.counter(
            f"{ns}_total_snapshots", "Snapshots discovered from peers"
        )
        self.chunks_applied = reg.counter(f"{ns}_chunks_applied", "Snapshot chunks applied")
        self.chunk_process_time = reg.histogram(
            f"{ns}_chunk_process_seconds", "Fetch-to-apply time per chunk",
            buckets=(0.01, 0.05, 0.1, 0.5, 1, 5, 30),
        )
        self.backfilled_blocks = reg.counter(
            f"{ns}_backfilled_blocks", "Light blocks backfilled after restore"
        )
        # chunk re-requests by cause (no reference analog): "timeout", an
        # outstanding request expired; "refetch", the app rejected a
        # delivered chunk; "peer_rotated", the fetch scheduler moved away
        # from a peer after repeated expiries
        self.chunk_retries = reg.counter(
            f"{ns}_chunk_retries_total",
            "Snapshot chunk re-requests by cause",
            labels=("result",),
        )


class EvidenceMetrics:
    """ref: internal/evidence/metrics.go (num_evidence and committed are the
    reference node's pair; the rest are the JAX package's evidence-plane
    series). verify_evidence(..., metrics=) observes verify_seconds, the
    pool the rest; gossiped stays empty until the reactor is ported."""

    def __init__(self, reg: Registry):
        ns = f"{NAMESPACE}_evidence"
        self.num_evidence = reg.gauge(f"{ns}_pool_num_evidence", "Pending evidence")
        self.committed = reg.counter(f"{ns}_committed", "Evidence committed in blocks")
        self.pending = reg.gauge(
            f"{ns}_pending",
            "Pending evidence items in the pool by type",
            labels=("evidence_type",),
        )
        self.total = reg.counter(
            f"{ns}_total",
            "Evidence observed by the pool, by type and outcome "
            "(verified / rejected / committed / expired)",
            labels=("evidence_type", "outcome"),
        )
        self.verify_seconds = reg.histogram(
            f"{ns}_verify_seconds",
            "Full contextual evidence verification latency",
            buckets=(0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1),
        )
        self.gossiped = reg.counter(
            f"{ns}_gossiped_total", "Evidence items sent to peers by the reactor"
        )


class StateMetrics:
    """ref: internal/state/metrics.go: the block timing that BlockExecutor
    observes (the reference's tmstate series come with its app-state
    plane)."""

    def __init__(self, reg: Registry):
        ns = f"{NAMESPACE}_state"
        self.block_processing_time = reg.histogram(
            f"{ns}_block_processing_time", "Time of ApplyBlock", buckets=(0.01, 0.05, 0.1, 0.5, 1, 5)
        )

    def observe(self, name: str, value: float) -> None:
        """The hook BlockExecutor calls by name (the state layer does not
        import this package)."""
        h = getattr(self, name, None)
        if h is not None:
            h.observe(value)


class P2PMetrics:
    """ref: internal/p2p/metrics.go: the series the router and the peer
    manager write (p2p/router.py, p2p/peermanager.py)."""

    def __init__(self, reg: Registry):
        ns = f"{NAMESPACE}_p2p"
        self.peers = reg.gauge(f"{ns}_peers", "Connected peers")
        self.message_send_bytes_total = reg.counter(
            f"{ns}_message_send_bytes_total", "Bytes sent", labels=("chID",)
        )
        self.message_receive_bytes_total = reg.counter(
            f"{ns}_message_receive_bytes_total", "Bytes received", labels=("chID",)
        )
        self.peer_queue_dropped_msgs = reg.counter(
            f"{ns}_peer_queue_dropped_msgs",
            "Envelopes dropped from full per-peer send queues",
            labels=("chID",),
        )
        # the JAX package's backpressure and churn series, which the Go
        # reference lacks
        self.peer_send_queue_depth = reg.gauge(
            f"{ns}_peer_send_queue_depth",
            "Envelopes queued toward one peer (child removed on disconnect)",
            labels=("peer",),
        )
        self.peer_connections = reg.counter(
            f"{ns}_peer_connections_total",
            "Peer connections registered since boot",
            labels=("dir",),
        )
        self.dial_attempts = reg.counter(
            f"{ns}_dial_attempts_total",
            "Outbound dial attempts by outcome (ok = handshake registered)",
            labels=("result",),
        )


class BlockSyncMetrics:
    """ref: internal/blocksync/metrics.go: the series the blocksync reactor
    writes (blocksync/reactor.py)."""

    def __init__(self, reg: Registry):
        ns = f"{NAMESPACE}_blocksync"
        self.syncing = reg.gauge(f"{ns}_syncing", "1 while block-syncing")
        self.num_blocks = reg.counter(f"{ns}_num_blocks", "Blocks synced and applied")
        self.latest_height = reg.gauge(f"{ns}_latest_block_height", "Pool verify height")
        self.sync_rate = reg.gauge(f"{ns}_sync_rate", "Recent blocks/sec estimate")


class ConsensusMetrics:
    """ref: internal/consensus/metrics.go:20 (metricsgen struct)."""

    def __init__(self, reg: Registry):
        ns = f"{NAMESPACE}_consensus"
        self.height = reg.gauge(f"{ns}_height", "Height of the chain")
        self.rounds = reg.gauge(f"{ns}_rounds", "Round of the current height")
        self.round_duration = reg.histogram(
            f"{ns}_round_duration_seconds", "Time spent in a round"
        )
        self.step_duration = reg.histogram(
            f"{ns}_step_duration_seconds", "Time spent per step", labels=("step",)
        )
        self.block_interval = reg.histogram(
            f"{ns}_block_interval_seconds",
            "Time between this and the last block",
            buckets=(0.1, 0.25, 0.5, 1, 2, 5, 10, 30),
        )
        self.validators = reg.gauge(f"{ns}_validators", "Number of validators")
        self.validators_power = reg.gauge(f"{ns}_validators_power", "Total voting power")
        self.num_txs = reg.gauge(f"{ns}_num_txs", "Transactions in the latest block")
        self.block_size = reg.gauge(f"{ns}_block_size_bytes", "Size of the latest block")
        self.total_txs = reg.counter(f"{ns}_total_txs", "Total committed transactions")
        self.commit_sigs = reg.gauge(
            f"{ns}_commit_signatures", "Signatures in the latest commit"
        )
        self.proposal_receive_count = reg.counter(
            f"{ns}_proposal_receive_count", "Proposals received", labels=("status",)
        )
        self.proposal_create_count = reg.counter(
            f"{ns}_proposal_create_count", "Proposals created by this node"
        )
        # Per-commit validator participation (ref: metrics.go
        # MissingValidators/ByzantineValidators and their power gauges).
        self.missing_validators = reg.gauge(
            f"{ns}_missing_validators", "Validators absent from the last commit"
        )
        self.missing_validators_power = reg.gauge(
            f"{ns}_missing_validators_power", "Voting power absent from the last commit"
        )
        self.byzantine_validators = reg.gauge(
            f"{ns}_byzantine_validators", "Validators with committed evidence this block"
        )
        self.byzantine_validators_power = reg.gauge(
            f"{ns}_byzantine_validators_power", "Voting power with committed evidence"
        )
        self.late_votes = reg.counter(
            f"{ns}_late_votes", "Votes for earlier rounds/heights", labels=("vote_type",)
        )
        self.duplicate_vote = reg.counter(f"{ns}_duplicate_vote", "Exact-duplicate votes")
        self.duplicate_block_part = reg.counter(
            f"{ns}_duplicate_block_part", "Block parts already held"
        )
        self.vote_extension_receive_count = reg.counter(
            f"{ns}_vote_extension_receive_count",
            "Precommit vote extensions received",
            labels=("status",),
        )
        # Gossip propagation latency (no reference analog): senders
        # stamp origin wall-clock on proposal/vote/block-part frames
        # (consensus/reactor.py) and the receive side observes
        # now - origin here. Meaningful on shared-clock local testnets
        # (e2e/bench); splits a slow consensus step into network
        # propagation vs local compute (docs/observability.md#flight).
        self.msg_propagation = reg.histogram(
            f"{ns}_msg_propagation_seconds",
            "Origin-to-receive latency of gossiped consensus messages (shared-clock testnets)",
            labels=("type",),
            buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                     0.1, 0.25, 0.5, 1.0, 2.5, 5.0),
        )
        # tmpath journey plane (docs/observability.md#tmpath): stamped
        # data-plane frames by direction, and journey span emissions by
        # stage — the counters that prove the journey plane is live on
        # a node even when span tracing itself is off.
        self.journey_frames = reg.counter(
            f"{ns}_journey_frames_total",
            "Journey-stamped consensus frames (proposal/block_part/vote) by direction",
            labels=("type", "dir"),
        )
        self.journey_spans = reg.counter(
            f"{ns}_journey_spans_total",
            "tmpath journey span emissions by stage",
            labels=("stage",),
        )
        # First vote seen for (height, round, type) -> 2/3 majority
        # assembled — the quorum-formation half of a step's wall time
        # (the other half is msg_propagation + verify compute).
        self.quorum_assembly = reg.histogram(
            f"{ns}_quorum_assembly_seconds",
            "First vote to 2/3 majority per (height, round, vote type)",
            labels=("type",),
            buckets=(0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0),
        )
        # Chain-head freshness at scrape time (no reference analog; the
        # tmlens liveness-stall gate reads this from persisted
        # artifacts — docs/observability.md). Marked at every
        # finalize_commit; the exported value is seconds-since.
        self.last_block_age = reg.register(AgeGauge(
            f"{ns}_last_block_age_seconds",
            "Seconds since this node last committed a block (computed at scrape)",
        ))
        self._step_start = time.monotonic()
        self._round_start = time.monotonic()
        self._last_step: str | None = None

    def mark_step(self, step: str) -> None:
        """Observe the duration of the step we're leaving (ref:
        metrics.go MarkStep)."""
        now = time.monotonic()
        if self._last_step is not None:
            self.step_duration.observe(now - self._step_start, self._last_step)
        self._step_start = now
        self._last_step = step

    def mark_round(self) -> None:
        now = time.monotonic()
        self.round_duration.observe(now - self._round_start)
        self._round_start = now


class MempoolMetrics:
    """ref: internal/mempool/metrics.go."""

    def __init__(self, reg: Registry):
        ns = f"{NAMESPACE}_mempool"
        self.size = reg.gauge(f"{ns}_size", "Number of uncommitted transactions")
        self.tx_size_bytes = reg.histogram(
            f"{ns}_tx_size_bytes", "Transaction sizes", buckets=(32, 256, 1024, 65536, 1048576)
        )
        self.failed_txs = reg.counter(f"{ns}_failed_txs", "Rejected transactions")
        self.evicted_txs = reg.counter(f"{ns}_evicted_txs", "Evicted transactions")
        self.recheck_times = reg.counter(f"{ns}_recheck_times", "Recheck runs")
        self.recheck_duration = reg.histogram(
            f"{ns}_recheck_duration_seconds",
            "Wall time of one post-commit recheck sweep",
            buckets=(0.001, 0.01, 0.05, 0.1, 0.5, 1, 5),
        )
        # Coalesced admission pipeline (docs/mempool.md): batch shape,
        # per-batch latency, and how deep the pipelined ABCI CheckTx
        # window / async-RPC admission queue run under flood.
        self.admit_batch_size = reg.histogram(
            f"{ns}_admit_batch_size",
            "Txs per check_tx_batch admission",
            buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 4096),
        )
        self.admit_seconds = reg.histogram(
            f"{ns}_admit_seconds",
            "Wall time of one batched admission (hash + pre-verify + pipelined CheckTx + settle)",
            buckets=(0.0001, 0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1, 5),
        )
        self.admit_pipeline_depth = reg.gauge(
            f"{ns}_admit_pipeline_depth",
            "CheckTx requests currently in flight on the ABCI client",
        )
        self.admit_queue_depth = reg.gauge(
            f"{ns}_admit_queue_depth",
            "Txs waiting in the bounded async-RPC admission queue",
        )


# Process-global registry: the engine, the device plane and the hash plane
# are process-wide, so their groups register here.
_GLOBAL_REGISTRY = Registry()
_ENGINE_METRICS: EngineMetrics | None = None
_DEVICE_METRICS: DeviceMetrics | None = None
_HASH_METRICS: HashMetrics | None = None
_PROOF_METRICS: ProofMetrics | None = None
_EVIDENCE_METRICS: EvidenceMetrics | None = None
_ENGINE_LOCK = threading.Lock()


def global_registry() -> Registry:
    return _GLOBAL_REGISTRY


def engine_metrics() -> EngineMetrics:
    """Lazy process-wide EngineMetrics singleton (the families first
    appear on the scrape once any verification plane is touched)."""
    global _ENGINE_METRICS
    if _ENGINE_METRICS is None:
        with _ENGINE_LOCK:
            if _ENGINE_METRICS is None:
                _ENGINE_METRICS = EngineMetrics(_GLOBAL_REGISTRY)
    return _ENGINE_METRICS


def device_metrics() -> DeviceMetrics:
    """Lazy process-wide DeviceMetrics singleton (first devobs install or
    residency sample registers the families)."""
    global _DEVICE_METRICS
    if _DEVICE_METRICS is None:
        with _ENGINE_LOCK:
            if _DEVICE_METRICS is None:
                _DEVICE_METRICS = DeviceMetrics(_GLOBAL_REGISTRY)
    return _DEVICE_METRICS


def hash_metrics() -> HashMetrics:
    """Lazy process-wide HashMetrics singleton (the first merkle build or
    hash-memo event registers the families)."""
    global _HASH_METRICS
    if _HASH_METRICS is None:
        with _ENGINE_LOCK:
            if _HASH_METRICS is None:
                _HASH_METRICS = HashMetrics(_GLOBAL_REGISTRY)
    return _HASH_METRICS


def proof_metrics() -> ProofMetrics:
    """Lazy process-wide ProofMetrics singleton (the first tree-cache event
    registers the families)."""
    global _PROOF_METRICS
    if _PROOF_METRICS is None:
        with _ENGINE_LOCK:
            if _PROOF_METRICS is None:
                _PROOF_METRICS = ProofMetrics(_GLOBAL_REGISTRY)
    return _PROOF_METRICS


def evidence_metrics() -> EvidenceMetrics:
    """Lazy process-wide EvidenceMetrics singleton (the first caller that
    hands it to verify_evidence registers the families)."""
    global _EVIDENCE_METRICS
    if _EVIDENCE_METRICS is None:
        with _ENGINE_LOCK:
            if _EVIDENCE_METRICS is None:
                _EVIDENCE_METRICS = EvidenceMetrics(_GLOBAL_REGISTRY)
    return _EVIDENCE_METRICS


class PrometheusServer:
    """Minimal /metrics HTTP endpoint (ref: node/node.go:575). Serves
    the node's registry plus the process-global one (engine plane)."""

    def __init__(self, registry: Registry, addr: str = "127.0.0.1:26660"):
        self.registry = registry
        host, _, port = addr.rpartition(":")
        self.host = host.lstrip("/") or "127.0.0.1"
        self.port = int(port)
        self._httpd = None

    def start(self) -> None:
        import http.server

        registry = self.registry

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802
                if self.path not in ("/metrics", "/"):
                    self.send_error(404)
                    return
                text = registry.gather()
                if registry is not _GLOBAL_REGISTRY:
                    text += _GLOBAL_REGISTRY.gather()
                body = text.encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # silence
                pass

        self._httpd = http.server.ThreadingHTTPServer((self.host, self.port), Handler)
        self.port = self._httpd.server_address[1]
        threading.Thread(target=self._httpd.serve_forever, daemon=True, name="prometheus").start()

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd = None
