"""The device observatory for CUDA: what the card did between a dispatch
and its collect.

The CUDA form of the JAX package's devobs (tendermint_tpu/devobs/__init__.py),
under the same gate (TM_TPU_DEVOBS=1, also on/true/yes) and with the same
DeviceMetrics series (tendermint_device_*, metrics/). Three feeds:

  compiles    The port compiles no kernel per shape: each csrc/<name>.cu is
              built once by nvcc into a library and loaded with ctypes
              (ops/_build.py). Each nvcc run and each load of a built
              library is one event (`record_build(fn=<library>, seconds,
              kind="nvcc"|"load")`): `compiles_total{fn}`,
              `compile_seconds`, and a retrospective `device.compile` span
              flow-linked to the launch that waited on it (the thread-local
              `attribution(flow=...)` the ops dispatch sites set). A CUDA
              kernel has no per-shape compile, so `bucket_compiles_total`
              stays at zero, and `compile_cache_events_total` too.
  transfers   `transfer_span(dir, nbytes, flow=...)` wraps the port's own
              h2d copies (the rows each launch copies to the device) and
              d2h reads (each collect): `transfer_bytes_total{dir}`,
              `transfers_total{dir}`, and `device.h2d`/`device.d2h` spans.
  residency   `sample_residency()`: the bytes PyTorch's caching allocator
              holds for live tensors (`torch.cuda.memory_allocated`, summed
              over the devices CUDA has initialized), the live allocations
              (`active.all.current`), the high-water mark (the larger of
              the samples' and `torch.cuda.max_memory_allocated`), and the
              resident bytes and entries of each cache plane, read from the
              ops module globals without building anything: the pubkey
              caches of ops/verify.py `_PK_CACHES` ("ed25519_pk",
              "sr25519_pk") and the base-point tables the bitmap, hit and
              RLC kernels read, ops/verify.py `_DEVICE_TABLES`
              ("base_tables").

`install()` never raises: a fault degrades to a warn-once no-op. Disabled,
nothing is registered and every hook is one bool check. `maybe_install()`
reads the gate; this module calls it once at import, so TM_TPU_DEVOBS=1 in
the environment turns the observatory on for the whole process.
"""

from __future__ import annotations

import collections
import contextlib
import os
import sys
import threading
import time
import warnings

__all__ = [
    "attribution",
    "current_attribution",
    "enabled",
    "install",
    "maybe_install",
    "next_flow",
    "record_build",
    "sample_residency",
    "status",
    "transfer_span",
    "uninstall",
]

_OPS_VERIFY = "tendermint_tpu_torch.ops.verify"

_LOCK = threading.Lock()
_STATE = {
    "installed": False,
    "warned": False,
    # plain counters mirrored from DeviceMetrics for a lock-cheap snapshot
    "compiles": 0,
    "compile_seconds": 0.0,
    "transfers": {"h2d": 0, "d2h": 0},
    "transfer_bytes": {"h2d": 0, "d2h": 0},
    "residency_samples": 0,
    "live_buffer_bytes": 0,
    "high_water_bytes": 0,
}
# recent build events for status()
_COMPILE_TAIL: collections.deque = collections.deque(maxlen=256)
_TLS = threading.local()


def _warn_once(msg: str) -> None:
    with _LOCK:
        if _STATE["warned"]:
            return
        _STATE["warned"] = True
    warnings.warn(msg, RuntimeWarning, stacklevel=3)


def _metrics():
    from ..metrics import device_metrics

    return device_metrics()


def enabled() -> bool:
    return _STATE["installed"]


def next_flow() -> int:
    """A trace flow id tying a launch span to the transfer and build spans
    that fed it, from the trace ring's own allocator (0 is the no-arrow
    sentinel)."""
    from .. import trace as _trace

    return _trace.new_flow()


# ---------------------------------------------------------------- attribution


@contextlib.contextmanager
def attribution(**ctx):
    """Thread-local attribution context: dispatch sites wrap their kernel
    call in `attribution(fn="ed25519_bitmap", rows=512, flow=fid)`, and a
    library build or load fired inside (the kernel's first use) inherits
    the flow and the site. Nested contexts merge (inner wins). A no-op
    while devobs is disabled."""
    if not _STATE["installed"]:
        yield
        return
    stack = getattr(_TLS, "stack", None)
    if stack is None:
        stack = _TLS.stack = []
    stack.append(ctx)
    try:
        yield
    finally:
        stack.pop()


def current_attribution() -> dict:
    merged: dict = {}
    for ctx in getattr(_TLS, "stack", ()) or ():
        merged.update(ctx)
    return merged


# --------------------------------------------------------------------- builds


def record_build(fn: str, seconds: float, kind: str) -> None:
    """One kernel-library event from ops/_build.py: `kind` "nvcc" (a build)
    or "load" (a built library loaded into the process), `fn` the library
    (csrc/<fn>.cu). Never raises."""
    try:
        if not _STATE["installed"]:
            return
        dur = float(seconds)
        ctx = current_attribution()
        m = _metrics()
        m.compiles.add(1, fn)
        m.compile_seconds.observe(dur)
        with _LOCK:
            _STATE["compiles"] += 1
            _STATE["compile_seconds"] += dur
            _COMPILE_TAIL.append({
                "t": round(time.time(), 3),
                "fn": fn,
                "kind": kind,
                "site": ctx.get("fn"),
                "dur_s": round(dur, 6),
            })
        from .. import trace as _trace

        dur_us = int(dur * 1e6)
        _trace.complete(
            "device.compile", "device",
            ts_us=_trace.now_us() - dur_us, dur_us=dur_us,
            fn=fn, kind=kind, flow=int(ctx.get("flow") or 0),
        )
    except Exception:  # noqa: BLE001 - observability never fails the host
        pass


# ------------------------------------------------------------------ transfers


@contextlib.contextmanager
def transfer_span(direction: str, nbytes: int, flow: int = 0):
    """Wrap one launch's h2d copies or one collect's d2h read: counts the
    bytes and emits a `device.h2d`/`device.d2h` span flow-linked to the
    launch. Plain passthrough while disabled."""
    if not _STATE["installed"]:
        yield
        return
    try:
        m = _metrics()
        m.transfer_bytes.add(int(nbytes), direction)
        m.transfers.add(1, direction)
        with _LOCK:
            _STATE["transfers"][direction] = _STATE["transfers"].get(direction, 0) + 1
            _STATE["transfer_bytes"][direction] = (
                _STATE["transfer_bytes"].get(direction, 0) + int(nbytes)
            )
        from .. import trace as _trace
    except Exception:  # noqa: BLE001
        yield
        return
    with _trace.span(f"device.{direction}", "device", bytes=int(nbytes), flow=int(flow)):
        yield


# ------------------------------------------------------------------ residency


def _nbytes(t) -> int:
    return int(t.numel() * t.element_size()) if t is not None else 0


def _cache_planes() -> dict:
    """{plane: (bytes, entries)} of the resident tables the ops modules
    hold, read from their globals; an ops module never imported reports
    nothing."""
    planes: dict = {}
    mod = sys.modules.get(_OPS_VERIFY)
    if mod is None:
        return planes
    for (plane, _splits, _dev), cache in list(getattr(mod, "_PK_CACHES", {}).items()):
        b, e = planes.get(f"{plane}_pk", (0, 0))
        planes[f"{plane}_pk"] = (b + _nbytes(cache.tables) + _nbytes(cache.oks),
                                 e + len(cache._lru))
    tables = list(getattr(mod, "_DEVICE_TABLES", {}).values())
    if tables:
        planes["base_tables"] = (sum(_nbytes(t) for t in tables), len(tables))
    return planes


def sample_residency() -> dict | None:
    """One residency sample: live device bytes and allocations, the
    high-water mark and each cache plane's resident bytes and entries.
    None while devobs is disabled. Never raises (None on a fault)."""
    if not _STATE["installed"]:
        return None
    try:
        import torch

        total = count = peak = 0
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            for d in range(torch.cuda.device_count()):
                total += int(torch.cuda.memory_allocated(d))
                peak += int(torch.cuda.max_memory_allocated(d))
                count += int(torch.cuda.memory_stats(d).get("active.all.current", 0))
        m = _metrics()
        m.live_buffer_bytes.set(total)
        m.live_buffers.set(count)
        m.residency_samples.add(1)
        planes = {}
        for plane, (nbytes, entries) in _cache_planes().items():
            m.cache_resident_bytes.set(nbytes, plane)
            m.cache_resident_entries.set(entries, plane)
            planes[plane] = {"bytes": nbytes, "entries": entries}
        with _LOCK:
            _STATE["residency_samples"] += 1
            _STATE["live_buffer_bytes"] = total
            _STATE["high_water_bytes"] = max(_STATE["high_water_bytes"], total, peak)
            high = _STATE["high_water_bytes"]
        m.live_buffer_high_water.set(high)
        return {
            "live_buffer_bytes": total,
            "live_buffers": count,
            "high_water_bytes": high,
            "planes": planes,
        }
    except Exception:  # noqa: BLE001 - telemetry never fails the caller
        return None


# ------------------------------------------------------------------ lifecycle


def install():
    """Turn the observatory on. Idempotent; never raises: returns True when
    it is live, None (with a one-time warning) if it could not start."""
    with _LOCK:
        if _STATE["installed"]:
            return True
    try:
        # register the families so an enabled run always exposes the
        # tendermint_device_* series, even before the first transfer
        m = _metrics()
        m.transfer_bytes.add(0, "h2d")
        m.transfer_bytes.add(0, "d2h")
    except Exception as exc:  # noqa: BLE001 - degrade, never break the caller
        _warn_once(f"devobs: device metrics unavailable ({exc!r}); device observatory disabled")
        return None
    with _LOCK:
        _STATE["installed"] = True
    return True


def maybe_install():
    """The TM_TPU_DEVOBS=1 gate."""
    if os.environ.get("TM_TPU_DEVOBS", "").strip().lower() not in ("1", "on", "true", "yes"):
        return None
    return install()


def uninstall() -> None:
    """Turn the observatory off; every hook is inert again."""
    with _LOCK:
        _STATE["installed"] = False


def status(tail: int = 32) -> dict:
    """Snapshot: the counters plus the recent build-event tail, copied under
    the lock."""
    n = max(0, int(tail))
    with _LOCK:
        if not _STATE["installed"]:
            return {"enabled": False, "compiles": 0, "tail": []}
        recent = list(_COMPILE_TAIL)
        return {
            "enabled": True,
            "compiles": _STATE["compiles"],
            "compile_seconds": round(_STATE["compile_seconds"], 6),
            "transfers": dict(_STATE["transfers"]),
            "transfer_bytes": dict(_STATE["transfer_bytes"]),
            "residency_samples": _STATE["residency_samples"],
            "live_buffer_bytes": _STATE["live_buffer_bytes"],
            "high_water_bytes": _STATE["high_water_bytes"],
            "tail": recent[len(recent) - min(n, len(recent)):],
        }


maybe_install()
