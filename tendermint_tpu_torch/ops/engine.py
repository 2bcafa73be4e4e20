"""The process-wide verification engine: the coalescing dispatch plane
and its cutover autotune, the port of tendermint_tpu/ops/engine.py.

Every batch caller (commit checks, and the blocksync verify-ahead and the
light-client server the reference runs on it) submits its batch here
instead of launching on its own:

  coalescing    concurrent callers' jobs of one plane and one device merge
                into ONE launch, up to MAX_COALESCE_ROWS rows
                (TM_TPU_ENGINE_MAX_ROWS, default 8192), and each caller gets
                back its own slice: three 67-signature commits become one
                201-row launch instead of three.
  double buffer a dispatch worker runs a group's host prep and launches its
                kernels asynchronously; a collect worker blocks on the
                results and demuxes them, so batch i + 1's prep overlaps
                batch i's kernels.
  host plane    a group below DEVICE_BATCH_CUTOVER (or under
                TM_TPU_CRYPTO=off) runs on a two-worker pool: ed25519
                through libcrypto in one C call (native.host_verify_batch)
                with the ZIP-215 oracle on the rows it rejects, sr25519 row
                by row; acceptance is the serial path's.
  autotune      DEVICE_BATCH_CUTOVER and MSM_BATCH_CUTOVER come from a
                one-shot probe on the card (below).

The device routing is crypto/ed25519.device_dispatch, the direct
dispatch's own branch, so the two cannot drift apart. Four things belong
to the card: a job carries the device it resolved in the caller's thread at
submit (the current CUDA device is per thread) and groups never mix
devices; the dispatch worker launches under that device; the collect waits
on a CUDA event recorded after the launch, and reads back on the stream the
dispatch launched on; and nothing falls back to the host on a device
failure. With no card and TM_TPU_CRYPTO=auto a group at or above the cutover
raises (resolve_device), and every caller of the group gets a copy of the
error; the engine lives on.

TM_TPU_ENGINE = auto (the default), unset or on runs the engine; off runs
the direct dispatch of crypto/ed25519.py per caller. Verdicts are the same.
Every stage writes the reference's spans (engine.submit, engine.coalesce,
engine.dispatch, engine.host_verify, engine.collect; trace/) and
EngineMetrics series (metrics/).

The autotune: DEVICE_BATCH_CUTOVER and MSM_BATCH_CUTOVER
(crypto/ed25519.py) are defaults of 64 and 256 signatures. When a CUDA
device is present and the environment pins neither TM_TPU_BATCH_CUTOVER nor
TM_TPU_MSM_CUTOVER, the first batch starts a daemon thread that times 16
host verifies and a warm 8-signature bitmap launch on the card (kernel 1)
and sets the cutovers to the batch size where the launch pays for itself,
by the reference's formula (`cutovers`). The defaults stay in effect until
the probe lands. TM_TPU_AUTOTUNE=off, or no CUDA device, leaves them as
they are, so the CPU tests stay deterministic. A probe that raises keeps the
defaults, as the reference's does; the port also records the exception.
`_AUTOTUNE` holds what the probe did: the thread (`join` it to wait for the
probe), the two timings in seconds, the cutovers it set and the exception,
if any.
"""

from __future__ import annotations

import contextlib
import copy
import os
import threading
import time
from collections import deque

from .. import trace as _trace
from ..metrics import engine_metrics as _engine_metrics

# Rows per coalesced launch: jobs beyond it form the next batch, which the
# double buffer absorbs.
MAX_COALESCE_ROWS = int(os.environ.get("TM_TPU_ENGINE_MAX_ROWS", "8192"))


def engine_enabled() -> bool:
    """TM_TPU_ENGINE: auto (the default), unset or on is the engine; off
    (0/false/no) is direct dispatch."""
    return os.environ.get("TM_TPU_ENGINE", "auto").strip().lower() not in (
        "off", "0", "false", "no",
    )


# ------------------------------------------------------------------ autotune


_AUTOTUNE: dict = {"done": False}
_AUTOTUNE_LOCK = threading.Lock()


def _autotune_enabled() -> bool:
    return os.environ.get("TM_TPU_AUTOTUNE", "auto").strip().lower() not in (
        "off", "0", "false", "no",
    )


def _accelerator_present() -> bool:
    """The port's accelerator is a CUDA device."""
    import torch

    return torch.cuda.is_available()


def cutovers(t_host: float, t_launch: float) -> tuple[int, int]:
    """(device cutover, MSM cutover) from the seconds of one host verify and
    of one warm 8-signature launch: the smallest 8 * 2^k signatures, at
    most 4096, whose host time covers the launch; the RLC's at four times
    that, within [64, 8192]."""
    cutover = 8
    while cutover * t_host < t_launch and cutover < 4096:
        cutover *= 2
    return cutover, max(64, min(4 * cutover, 8192))


def maybe_autotune() -> None:
    """Start the one-shot cutover probe (once a process, under a lock)
    when a CUDA device is present, TM_TPU_AUTOTUNE is not off and at least
    one of the two cutovers is not pinned by its environment variable."""
    if _AUTOTUNE["done"]:
        return
    with _AUTOTUNE_LOCK:
        if _AUTOTUNE["done"]:
            return
        _AUTOTUNE["done"] = True
        if not _autotune_enabled():
            return
        dev_pinned = "TM_TPU_BATCH_CUTOVER" in os.environ
        msm_pinned = "TM_TPU_MSM_CUTOVER" in os.environ
        if (dev_pinned and msm_pinned) or not _accelerator_present():
            return
        t = threading.Thread(target=_autotune_probe, args=(dev_pinned, msm_pinned),
                             daemon=True, name="tm-engine-autotune")
        _AUTOTUNE["thread"] = t
        t.start()


def _autotune_probe(dev_pinned: bool, msm_pinned: bool) -> None:
    """Time the host and the card, then set the cutovers not pinned."""
    try:
        from ..crypto import ed25519 as ed
        from ..crypto import ed25519_ref as ref
        from . import verify as V

        sk = ref.gen_privkey(b"\x5a" * 32)
        pk, msg = sk[32:], b"tm-engine-autotune-probe"
        sig = ref.sign(sk, msg)
        t0 = time.perf_counter()
        for _ in range(16):
            ed._single_verify(pk, msg, sig)
        t_host = (time.perf_counter() - t0) / 16
        jobs = ([pk] * 8, [msg] * 8, [sig] * 8)
        V.verify_batch(*jobs)  # build and warm
        t0 = time.perf_counter()
        for _ in range(3):
            V.verify_batch(*jobs)
        t_launch = (time.perf_counter() - t0) / 3
        _AUTOTUNE.update(t_host=t_host, t_launch=t_launch)
        dev_cut, msm_cut = cutovers(t_host, t_launch)
        if not dev_pinned:
            ed.DEVICE_BATCH_CUTOVER = dev_cut
        if not msm_pinned:
            ed.MSM_BATCH_CUTOVER = msm_cut
        _AUTOTUNE.update(device_batch_cutover=ed.DEVICE_BATCH_CUTOVER,
                         msm_batch_cutover=ed.MSM_BATCH_CUTOVER)
        m = _engine_metrics()
        m.autotuned.set(1)
        m.device_batch_cutover.set(ed.DEVICE_BATCH_CUTOVER)
        m.msm_batch_cutover.set(ed.MSM_BATCH_CUTOVER)
    except Exception as e:  # noqa: BLE001 - the defaults stay; the failure is recorded
        _AUTOTUNE["error"] = e


# -------------------------------------------------------------------- engine


class _Job:
    __slots__ = (
        "plane", "pks", "msgs", "sigs", "n", "device", "event", "result", "error",
        "flow", "t_submit", "journey",
    )

    def __init__(self, plane, pks, msgs, sigs, journey=None, device=None):
        self.plane = plane
        self.pks = pks
        self.msgs = msgs
        self.sigs = sigs
        self.n = len(sigs)
        # the torch.device resolved in the caller's thread, or None (no card
        # and none named: a device group raises at dispatch)
        self.device = device
        self.event = threading.Event()
        self.result: list[bool] | None = None
        self.error: BaseException | None = None
        # trace flow id linking this job's submit span to the dispatch and
        # collect spans of the launch that carries it (0: tracing was off)
        self.flow = 0
        self.t_submit = 0.0
        # journey tag (trace.journey_key) carried through coalescing, so the
        # launch's spans list the chain events it verified
        self.journey = journey


class JobHandle:
    """Returned by VerifyEngine.submit; result() blocks until the coalesced
    launch carrying this job completes and returns the job's own
    per-signature bools."""

    __slots__ = ("_job",)

    def __init__(self, job: _Job):
        self._job = job

    def done(self) -> bool:
        return self._job.event.is_set()

    def result(self, timeout: float | None = None) -> list[bool]:
        if not self._job.event.wait(timeout):
            raise TimeoutError("verification engine result timed out")
        if self._job.error is not None:
            # raise a copy: the callers of a group share one exception, and
            # raising one object from several threads at once mixes their
            # tracebacks
            try:
                err = copy.copy(self._job.error)
            except Exception:  # noqa: BLE001 - an uncopyable exception is shared
                err = self._job.error
            raise err
        return self._job.result


def _fail_jobs(jobs, exc: BaseException) -> None:
    for j in jobs:
        j.error = exc
        j.event.set()


def _host_verify_ed25519(pks, msgs, sigs) -> list[bool]:
    """A coalesced ed25519 group on the host: libcrypto in one C call
    (GIL-free, threaded), the ZIP-215 oracle on the rows it rejects; the
    acceptance of _single_verify, batched. host_verify_batch returns None
    only for non-standard lengths or TM_TPU_NATIVE=0 (then row by row)."""
    from ..crypto import ed25519_ref as ref
    from ..crypto.ed25519 import _single_verify
    from ..native import host_verify_batch

    bitmap = host_verify_batch(pks, msgs, sigs)
    if bitmap is None:
        return [_single_verify(p, m, s) for p, m, s in zip(pks, msgs, sigs)]
    out = bitmap.tolist()
    for i, ok in enumerate(out):
        if not ok:
            # OpenSSL rejected it; only the oracle can still accept it
            out[i] = ref.verify(pks[i], msgs[i], sigs[i], zip215=True)
    return out


def _host_verify_sr25519(pks, msgs, sigs) -> list[bool]:
    from ..crypto import sr25519 as sr

    return [sr.verify(p, m, s) for p, m, s in zip(pks, msgs, sigs)]


_HOST_VERIFY = {"ed25519": _host_verify_ed25519, "sr25519": _host_verify_sr25519}

_HOST_POOL = None
_HOST_POOL_LOCK = threading.Lock()


def _host_pool():
    """The host plane's two workers: a host group starts at dispatch time,
    so a slow sr25519 loop never holds a finished device group's collect
    behind it."""
    global _HOST_POOL
    if _HOST_POOL is None:
        with _HOST_POOL_LOCK:
            if _HOST_POOL is None:
                from concurrent.futures import ThreadPoolExecutor

                _HOST_POOL = ThreadPoolExecutor(max_workers=2,
                                                thread_name_prefix="tm-engine-host")
    return _HOST_POOL


def _submit_device(device):
    """The device a job runs on if its group goes to the card, resolved in
    the caller's thread: the one named (a bare "cuda" is the current CUDA
    device), else the current CUDA device, else None (no card)."""
    import torch

    if device is None:
        if not torch.cuda.is_available():
            return None
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _on_device(dev):
    """The launching device current for the work inside (a CPU device:
    nothing to set)."""
    import torch

    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def _launch_fence(dev):
    """After a group's launches, in the dispatch worker: the stream they
    went to and a CUDA event recorded on it, or None on the CPU."""
    import torch

    if dev.type != "cuda":
        return None
    stream = torch.cuda.current_stream(dev)
    event = torch.cuda.Event()
    event.record(stream)
    return stream, event


@contextlib.contextmanager
def _collect_on(dev, fence):
    """The collect of a device group, in the collect worker: wait for the
    launches (the event), then read back on the stream they went to, so a
    second-phase launch and every copy queue behind them."""
    import torch

    if fence is None:
        yield
        return
    stream, event = fence
    with torch.cuda.device(dev), torch.cuda.stream(stream):
        event.synchronize()
        yield


class VerifyEngine:
    """Process-wide coalescing verification pipeline.

    Two worker threads form the double buffer:
      dispatch  drains the submission queue, coalesces jobs of one plane on
                one device (up to MAX_COALESCE_ROWS rows), runs host prep
                and the asynchronous launch (or hands a host group to the
                pool), and passes the batch in flight to the collector;
      collect   blocks on the device result (or the host future), demuxes
                the combined bitmap into per-caller slices and wakes the
                callers.

    The threads are daemons, started at the first submit, named tm-engine-*.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._have_jobs = threading.Condition(self._lock)
        self._pending: list[_Job] = []
        self._inflight: list = []  # (jobs, collect thunk, path, seq)
        self._have_inflight = threading.Condition()
        self._started = False
        # Overlap accounting: the dispatch stages' and host verifies' wall
        # intervals (bounded); each collect sums its interval's intersection
        # with other batches' intervals: the overlap the double buffer makes.
        self._stage_ivs: deque = deque(maxlen=64)  # (batch seq, t0, t1)
        # the dispatch worker and the host pool append while the collect
        # worker snapshots
        self._stage_ivs_lock = threading.Lock()
        self._overlap_total = 0.0
        self._collect_total = 0.0
        self._seq = 0  # batch counter, dispatch worker only

    # ------------------------------------------------------------ lifecycle

    def _ensure_started(self) -> None:
        if self._started:
            return
        with self._lock:
            if self._started:
                return
            self._started = True
            for name, fn in (("tm-engine-dispatch", self._dispatch_loop),
                             ("tm-engine-collect", self._collect_loop)):
                threading.Thread(target=fn, daemon=True, name=name).start()

    # -------------------------------------------------------------- submit

    def submit(self, plane: str, pubkeys, msgs, sigs, journey=None, device=None) -> JobHandle:
        """Queue one caller's batch for the next coalesced launch. plane is
        "ed25519" or "sr25519"; device is where a device group runs (None:
        the card); returns a JobHandle whose result() yields this caller's
        bools in input order. `journey` tags the job (trace.journey_key)."""
        if plane not in _HOST_VERIFY:
            raise ValueError(f"unknown verification plane {plane!r}")
        job = _Job(plane, list(pubkeys), list(msgs), list(sigs), journey=journey)
        if len(job.pks) != job.n or len(job.msgs) != job.n:
            # a ragged batch would be cut short by the planes' zip()s,
            # reporting unverified rows as accepted and shifting the later
            # callers' slices
            raise ValueError(
                f"ragged batch: {len(job.pks)} pubkeys / {len(job.msgs)} msgs / {job.n} sigs"
            )
        if job.n == 0:
            job.result = []
            job.event.set()
            return JobHandle(job)
        job.device = _submit_device(device)
        maybe_autotune()
        self._ensure_started()
        job.t_submit = time.monotonic()
        if _trace.enabled():
            job.flow = _trace.new_flow()
            sub_args = {"plane": plane, "rows": job.n, "flow": job.flow}
            if journey:
                sub_args["journey"] = journey
            with _trace.span("engine.submit", "engine", **sub_args):
                pass
        m = _engine_metrics()
        m.submitted_jobs.add(1, plane)
        m.submitted_sigs.add(job.n, plane)
        with self._lock:
            self._pending.append(job)
            # set under the lock, so it never loses a race with the
            # dispatch worker's set
            m.queue_depth.set(len(self._pending))
            self._have_jobs.notify()
        return JobHandle(job)

    # ------------------------------------------------------------ dispatch

    def _take_group(self):
        """Pop a coalescable group: the oldest pending job and every other
        queued job of the same plane on the same device, up to
        MAX_COALESCE_ROWS rows, in submit order. Called with the lock
        held."""
        first = self._pending.pop(0)
        group, rows = [first], first.n
        keep = []
        for j in self._pending:
            if (j.plane == first.plane and j.device == first.device
                    and rows + j.n <= MAX_COALESCE_ROWS):
                group.append(j)
                rows += j.n
            else:
                keep.append(j)
        self._pending = keep
        return group

    def _dispatch_loop(self) -> None:
        while True:
            m = _engine_metrics()
            with self._lock:
                while not self._pending:
                    self._have_jobs.wait()
                with _trace.span("engine.coalesce", "engine"):
                    group = self._take_group()
                m.queue_depth.set(len(self._pending))
            rows = sum(j.n for j in group)
            t0 = time.monotonic()
            # metric writes never raise: none of these can kill the worker
            m.coalesced_group_size.observe(len(group))
            m.coalesce_factor.observe(rows)
            m.queue_wait.observe(t0 - group[0].t_submit)
            self._seq += 1
            seq = self._seq
            sp = _trace.span(
                "engine.dispatch", "engine",
                plane=group[0].plane, jobs=len(group), rows=rows, flow=group[0].flow,
            )
            journeys = sorted({j.journey for j in group if j.journey})
            if journeys:
                sp.annotate(journeys=journeys)
            try:
                with sp:
                    thunk, path = self._dispatch_group(group, seq)
                    sp.annotate(path=path)
            except BaseException as e:  # noqa: BLE001 - deliver to the callers, keep serving
                _fail_jobs(group, e)
                continue
            t1 = time.monotonic()
            m.launch_latency.observe(t1 - t0)
            with self._stage_ivs_lock:
                self._stage_ivs.append((seq, t0, t1))
            with self._have_inflight:
                self._inflight.append((group, thunk, path, seq))
                m.inflight_batches.set(len(self._inflight))
                self._have_inflight.notify()

    def _dispatch_group(self, group, seq: int = 0):
        """Coalesce one group's rows, pick its plane (host, bitmap or
        two-phase RLC), run the prep and the asynchronous launch now, and
        return (collect thunk giving the combined (rows,) bools, path).
        seq tags this batch's stage intervals, which its own collect does
        not count as overlap."""
        from ..crypto import ed25519 as ed

        plane, flow, device = group[0].plane, group[0].flow, group[0].device
        pks, msgs, sigs = [], [], []
        for j in group:
            pks += j.pks
            msgs += j.msgs
            sigs += j.sigs
        total = len(sigs)

        if not (ed._use_device() and total >= ed.DEVICE_BATCH_CUTOVER):
            host_fn = _HOST_VERIFY[plane]

            def host_verify():
                m = _engine_metrics()
                m.host_pool_active.add(1)
                t0 = time.monotonic()
                try:
                    with _trace.span("engine.host_verify", "engine",
                                     plane=plane, rows=total, flow=flow):
                        return host_fn(pks, msgs, sigs)
                finally:
                    t1 = time.monotonic()
                    m.host_pool_active.add(-1)
                    m.host_pool_busy_seconds.add(t1 - t0)
                    with self._stage_ivs_lock:
                        self._stage_ivs.append((seq, t0, t1))

            future = _host_pool().submit(host_verify)
            return future.result, "host"  # .result raises the worker's exception

        bitmap, rlc_async, _ = ed.plane_ops(plane)
        dev = bitmap.resolve_device(device)  # raises with no card and none named
        with _on_device(dev):
            collect, path = ed.device_dispatch(pks, msgs, sigs, dev, bitmap, rlc_async)
            fence = _launch_fence(dev)

        def collect_on_device():
            with _collect_on(dev, fence):
                return collect()

        return collect_on_device, path

    # ------------------------------------------------------------- collect

    def _collect_loop(self) -> None:
        while True:
            m = _engine_metrics()
            with self._have_inflight:
                while not self._inflight:
                    self._have_inflight.wait()
                group, thunk, path, seq = self._inflight.pop(0)
                m.inflight_batches.set(len(self._inflight))
            rows = sum(j.n for j in group)
            t0 = time.monotonic()
            try:
                c_args = {"plane": group[0].plane, "jobs": len(group), "rows": rows,
                          "path": path, "flow": group[0].flow}
                journeys = sorted({j.journey for j in group if j.journey})
                if journeys:
                    c_args["journeys"] = journeys
                with _trace.span("engine.collect", "engine", **c_args):
                    bools = thunk()
                # validated inside the guard: a short or malformed result
                # fails the group (a short slice would report unverified
                # rows as accepted) instead of killing this worker
                bools = list(bools)
                if len(bools) != rows:
                    raise RuntimeError(
                        f"verify path {path!r} returned {len(bools)} results for {rows} rows")
            except BaseException as e:  # noqa: BLE001 - deliver to the callers, keep serving
                _fail_jobs(group, e)
                continue
            t1 = time.monotonic()
            lo = 0
            for j in group:
                j.result = bools[lo:lo + j.n]
                lo += j.n
                j.event.set()
            # telemetry only after every caller is woken: a bookkeeping bug
            # must neither strand a verified group nor kill this worker
            try:
                m.collect_latency.observe(t1 - t0)
                self._account_overlap(m, seq, t0, t1)
                m.observe_path(group[0].plane, path, bools)
            except Exception:  # noqa: BLE001
                pass

    def _account_overlap(self, m, seq: int, c0: float, c1: float) -> None:
        """Fold one collect interval's intersection with OTHER batches'
        dispatch and host-verify intervals into the overlap telemetry (its
        own batch's are latency, not overlap). The other intervals are
        unioned first, so the ratio stays <= 1; stages still running when
        the collect ends are not counted yet, so overlap is a floor. Runs on
        the collect worker only."""
        with self._stage_ivs_lock:
            ivs = list(self._stage_ivs)
        clipped = sorted(
            (max(c0, s), min(c1, e))
            for iv_seq, s, e in ivs
            if iv_seq != seq and s < c1 and e > c0
        )
        overlap = 0.0
        cur_s = cur_e = None
        for s, e in clipped:
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    overlap += cur_e - cur_s
                cur_s, cur_e = s, e
            elif e > cur_e:
                cur_e = e
        if cur_e is not None:
            overlap += cur_e - cur_s
        self._overlap_total += overlap
        self._collect_total += c1 - c0
        if overlap:
            m.overlap_seconds.add(overlap)
        if self._collect_total > 0:
            m.overlap_ratio.set(self._overlap_total / self._collect_total)


_ENGINE: VerifyEngine | None = None
_ENGINE_LOCK = threading.Lock()


def get_engine() -> VerifyEngine:
    global _ENGINE
    if _ENGINE is None:
        with _ENGINE_LOCK:
            if _ENGINE is None:
                _ENGINE = VerifyEngine()
    return _ENGINE


def verify_async_via_engine(plane: str, pubkeys, msgs, sigs, journey=None, device=None):
    """The batch verifiers' seam into the engine, for both planes: submit,
    return a completion callable giving (all_ok, per-signature bools)."""
    handle = get_engine().submit(plane, pubkeys, msgs, sigs, journey=journey, device=device)

    def complete():
        bools = handle.result()
        return all(bools), bools

    return complete
