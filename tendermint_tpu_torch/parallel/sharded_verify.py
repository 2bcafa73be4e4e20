"""Sharded batch verification over a mesh of devices.

The 10,000-validator mega-commit path (BASELINE.md config 5), the port of
tendermint_tpu/parallel/sharded_verify.py: the signatures are cut into
equal shards along the mesh's batch axis, each device runs its plane's
kernel on its shard and counts the shard's invalid rows with `fail_count`
(csrc/fail_count.cu), and the all-valid verdict is the AND-reduce
`sum(fail counts) == 0`. One entry point for each shard_map program of the
reference:

  verify_batch_sharded         row 14  the bitmap kernel (1 or 9) a shard
  verify_batch_sharded_cached  row 15  a cache-hit kernel (3, 6, 11 or 13) a shard
  verify_batch_sharded_rlc     row 16  the RLC kernel (4) a shard, with its own zs

Every shard launches, a shard that holds only padding included, as under
shard_map. The shards' counts are copied to the mesh's first device and
summed there by fail_count's int32 mode (the psum of one controller); the
host reads the bitmap and the verdict once a call. Each entry point counts
its calls in `.launches` and in EngineMetrics `sharded_launches`, under the
reference's labels (bitmap, cached and rlc), and writes the reference's
`sharded.verify` span (path, rows, shards).

A mesh may repeat one device (make_mesh(n, device=...)): its shards then
run one after another there, which is how the host runs the plain
versions over a mesh of n and how one card rehearses a mesh of n cards.
"""

from __future__ import annotations

import contextlib
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import trace as _trace
from ..metrics import engine_metrics as _engine_metrics
from ..ops import _build
from ..ops import msm as M
from ..ops import verify as V
from ..ops import verify_sr as VS

# key type -> (host prep, uncached bitmap kernel, the pubkey cache of a
# device, split cache hit, single-table cache hit); secp256k1 has no batch
# equation, as in the reference
_PLANES = {
    "ed25519": (V.prepare_batch, V.verify_kernel, V.pubkey_cache,
                V.verify_kernel_cached_split, V.verify_kernel_cached),
    "sr25519": (VS.prepare_batch, VS.verify_sr_kernel, VS.sr_pubkey_cache,
                VS.verify_sr_kernel_cached_split, VS.verify_sr_kernel_cached),
}


_SCALAR_POOL = None
_SCALAR_POOL_LOCK = threading.Lock()


def _scalar_pool() -> ThreadPoolExecutor:
    """The shared executor of the sharded RLC's per-shard scalars (the
    reference's): a commit check must not pay for creating threads, so
    the pool lives for the process; the lock keeps concurrent first
    callers from each building one."""
    global _SCALAR_POOL
    if _SCALAR_POOL is None:
        with _SCALAR_POOL_LOCK:
            if _SCALAR_POOL is None:
                _SCALAR_POOL = ThreadPoolExecutor(max_workers=8, thread_name_prefix="ThreadPoolExecutor-rlc")
    return _SCALAR_POOL


def _plane(key_type: str):
    try:
        return _PLANES[key_type]
    except KeyError:
        raise ValueError(
            f"unsupported key_type {key_type!r} for sharded verification "
            f"(batch-capable: {sorted(_PLANES)})"
        ) from None


# -- the mesh -----------------------------------------------------------------


class Mesh:
    """A 1-D mesh: the devices of the batch axis in order (a device may
    repeat), and the process group that joins this process's mesh to the
    other processes' (None on one controller; multihost.global_mesh sets
    it)."""

    def __init__(self, devices, group=None):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.group = group

    @property
    def size(self) -> int:
        return len(self.devices)

    def distinct(self) -> tuple:
        """The mesh's devices, each once, in mesh order."""
        return tuple(dict.fromkeys(self.devices))


def make_mesh(n_devices: int | None = None, device=None) -> Mesh:
    """The first n_devices CUDA devices (every one when None); raises when
    fewer exist, where JAX would slice silently. device= repeats that one
    device n_devices times (once when None): "cpu" runs the plain versions
    on the host, "cuda:0" rehearses a mesh of n cards on one."""
    if n_devices is not None and n_devices < 1:
        raise ValueError(f"make_mesh: n_devices must be at least 1, got {n_devices}")
    if device is not None:
        dev = V.resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return Mesh([dev] * (n_devices or 1))
    if not torch.cuda.is_available():
        V.resolve_device()  # raises: no card, and the host only when asked for
    count = torch.cuda.device_count()
    n = count if n_devices is None else n_devices
    if n > count:
        raise ValueError(f"make_mesh({n}): only {count} CUDA device(s); pass device= to run "
                         f"a mesh of {n} on one device")
    return Mesh([torch.device("cuda", i) for i in range(n)])


def shard_rows(n: int, n_shards: int) -> int:
    """Rows a shard holds for n rows over n_shards: powers of two (at least
    8) up to 256, then multiples of 256. Few shapes, and at 10,000 rows on
    one device 240 rows of padding, where a power of two would add 6,384."""
    per = -(-n // n_shards)
    return V._pad_pow2(per, floor=8) if per <= 256 else -(-per // 256) * 256


# -- the one kernel of this slice ---------------------------------------------


def fail_count_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version: the number of false rows of a bool/uint8 bitmap or
    verdict, or the sum of an int32 vector, as a (1,) int32 tensor."""
    if x.dtype == torch.int32:
        return x.sum(dtype=torch.int32).reshape(1)
    return (x == 0).sum(dtype=torch.int32).reshape(1)


def fail_count(x: torch.Tensor) -> torch.Tensor:
    """Per-shard fail count and cross-shard sum: csrc/fail_count.cu on CUDA
    tensors, the plain version on CPU tensors. x is a (B,) or () bool or
    uint8 tensor, whose zero rows it counts, or a (B,) int32 tensor, which
    it sums; returns a (1,) int32 tensor on x's device."""
    if x.dtype not in (torch.bool, torch.uint8, torch.int32) or x.ndim > 1:
        raise ValueError(f"fail_count: expected a (B,) or () bool, uint8 or int32 tensor, "
                         f"got {x.dtype} {tuple(x.shape)}")
    if not V._route("fail_count", x):
        return fail_count_plain(x)
    x = x.contiguous()
    out = torch.empty(1, dtype=torch.int32, device=x.device)
    rc = _build.load("fail_count").tm_fail_count(
        x.data_ptr(), x.numel(), 1 if x.dtype == torch.int32 else 0, out.data_ptr(),
        _build.stream_of(x),
    )
    _build.check(rc, "fail_count")
    fail_count.launches += 1
    return out


fail_count.launches = 0


# -- shards -------------------------------------------------------------------


def _on(dev: torch.device):
    """Make dev the current CUDA device for the launches inside (nothing on
    the host)."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def _pad_rows(arrays, size: int):
    return [np.pad(a, ((0, size - len(a)), (0, 0))) for a in arrays]


def _run_shards(mesh: Mesh, per: int, rows, launch):
    """Each shard on its device: its slice of each (mesh.size * per, w)
    array copied there, launch(d, dev, shard) -> its bitmap or verdict, and
    its fail count. Returns the shards' outputs and counts."""
    outs, counts = [], []
    for d, dev in enumerate(mesh.devices):
        with _on(dev):
            shard = V._to_device([x[d * per:(d + 1) * per] for x in rows], dev)
            ok = launch(d, dev, shard)
            outs.append(ok)
            counts.append(fail_count(ok))
    return outs, counts


def _gather(mesh: Mesh, tensors) -> torch.Tensor:
    """The tensors concatenated on the mesh's first device. A copy from
    another device waits for the kernels that made its tensor: the first
    device's stream waits on the source device's stream first."""
    dev0 = mesh.devices[0]
    moved = []
    for t in tensors:
        if t.device != dev0:
            torch.cuda.current_stream(dev0).wait_stream(torch.cuda.current_stream(t.device))
        moved.append(t.to(dev0))
    return torch.cat(moved)


def _collect(mesh: Mesh, oks, counts, precheck: np.ndarray, n: int):
    """The host's one read of a call: the cross-shard sum of the counts on
    the first device, then (bitmap of the n real rows ANDed with the host
    precheck, all-valid verdict)."""
    with _on(mesh.devices[0]):
        total = fail_count(_gather(mesh, counts))
        host = torch.cat([_gather(mesh, oks), total == 0]).cpu().numpy()
    return host[:n] & precheck, bool(host[-1]) and bool(precheck.all())


def _bitmap_shards(mesh: Mesh, pubkeys, msgs, sigs, key_type: str):
    """Host prep, padding to the shard schedule, then one bitmap kernel and
    one fail count a shard: (shard bitmaps, shard counts, host precheck)."""
    prepare, kernel, *_ = _plane(key_type)
    a, r, s, k, precheck = prepare(pubkeys, msgs, sigs)
    per = shard_rows(len(sigs), mesh.size)
    rows = _pad_rows([a, r, s, k], per * mesh.size)
    oks, counts = _run_shards(mesh, per, rows, lambda d, dev, shard: kernel(*shard))
    return oks, counts, precheck


# -- the three entry points ---------------------------------------------------


def verify_batch_sharded(mesh: Mesh, pubkeys, msgs, sigs, key_type: str = "ed25519"):
    """Batch verification sharded over the mesh (row 14): (bitmap numpy
    (n,), all-valid bool). key_type selects the plane; both batch-capable
    key types shard the same way, and padded rows verify true on both."""
    n = len(sigs)
    if n == 0:
        return np.zeros((0,), bool), False
    _plane(key_type)
    verify_batch_sharded.launches += 1
    _engine_metrics().sharded_launches.add(1, "bitmap")
    with _trace.span("sharded.verify", "parallel", path="bitmap", rows=n, shards=mesh.size):
        oks, counts, precheck = _bitmap_shards(mesh, pubkeys, msgs, sigs, key_type)
        return _collect(mesh, oks, counts, precheck, n)


verify_batch_sharded.launches = 0  # label "bitmap"


def verify_batch_sharded_cached(mesh: Mesh, pubkeys, msgs, sigs, key_type: str = "ed25519"):
    """verify_batch_sharded through the pubkey caches (row 15): each
    distinct device of the mesh looks the whole batch's keys up in its own
    cache (filling the misses), and each shard takes its rows' slots in its
    device's cache and the hit kernel of that cache's entry shape. A batch
    with more distinct keys than the cache holds takes the uncached
    sharded path."""
    n = len(sigs)
    if n == 0:
        return np.zeros((0,), bool), False
    prepare, _, cache_of, split_hit, single_hit = _plane(key_type)
    keys = [pk if len(pk) == 32 else b"\x00" * 32 for pk in pubkeys]
    snapshots = {}
    for dev in mesh.distinct():
        with _on(dev):
            slots, tables, oks = cache_of(dev).ensure_snapshot(keys)
        if slots is None:
            return verify_batch_sharded(mesh, pubkeys, msgs, sigs, key_type)
        snapshots[dev] = slots, tables, oks
    verify_batch_sharded_cached.launches += 1
    _engine_metrics().sharded_launches.add(1, "cached")
    with _trace.span("sharded.verify", "parallel", path="cached", rows=n, shards=mesh.size):
        _, r, s, k, precheck = prepare(pubkeys, msgs, sigs)
        per = shard_rows(n, mesh.size)
        size = per * mesh.size
        # Pad slots with THIS batch's last slot, not slot 0: padded rows
        # (s = k = 0) verify true against any VALID key's table, and if
        # that key's encoding is invalid its own real row already fails the
        # verdict, whereas slot 0 may hold an unrelated invalid key and fail
        # the verdict of an all-valid batch.
        slots = {dev: np.pad(snap[0], (0, size - n), mode="edge")
                 for dev, snap in snapshots.items()}

        def launch(d, dev, shard):
            _, tables, oks = snapshots[dev]
            (sl,) = V._to_device([slots[dev][d * per:(d + 1) * per]], dev)
            hit = split_hit if tables.ndim == 5 else single_hit
            return hit(tables, oks, sl, *shard)

        bitmaps, counts = _run_shards(mesh, per, _pad_rows([r, s, k], size), launch)
        return _collect(mesh, bitmaps, counts, precheck, n)


verify_batch_sharded_cached.launches = 0  # label "cached"


def verify_batch_sharded_rlc(mesh: Mesh, pubkeys, msgs, sigs, z_raw: bytes | None = None) -> bool:
    """All-valid fast path over the mesh (row 16), ed25519 only: True iff
    every signature is valid; False sends the caller to a bitmap plane to
    find which. Each shard checks the combined equation over its own rows
    (any subset of valid signatures sums to the identity, so each shard's
    check is sound alone), with its own zs partial sum."""
    n = len(sigs)
    if n == 0:
        return False
    a, r, s_rows, k_rows, precheck = V.prepare_batch(pubkeys, msgs, sigs)
    if not precheck.all():
        return False
    verify_batch_sharded_rlc.launches += 1
    _engine_metrics().sharded_launches.add(1, "rlc")
    z_raw = M._ensure_z_raw(n, z_raw)
    per = shard_rows(n, mesh.size)
    size = per * mesh.size
    # Each shard's scalars, its zs partial sum included, come from its own
    # slice; a shard of padding only keeps zero scalars and zs = 0. The
    # shards run on the scalar pool: the native call releases the GIL, so
    # they spread across cores.
    zk = np.zeros((size, 32), np.uint8)
    z = np.zeros((size, 16), np.uint8)
    zs = np.zeros((mesh.size, 1, 32), np.uint8)

    def shard_scalars(d):
        lo, hi = d * per, min((d + 1) * per, n)
        zk[lo:hi], z[lo:hi], zs[d] = M._rlc_scalars(
            s_rows[lo:hi], k_rows[lo:hi], hi - lo, z_raw[16 * lo:16 * hi])

    live = [d for d in range(mesh.size) if d * per < n]
    if len(live) > 1:
        list(_scalar_pool().map(shard_scalars, live))  # raises a shard's exception
    else:
        shard_scalars(0)

    def launch(d, dev, shard):
        (zs_d,) = V._to_device([zs[d]], dev)
        return M.msm_verify_kernel(*shard, zs_d)

    with _trace.span("sharded.verify", "parallel", path="rlc", rows=n, shards=mesh.size):
        _, counts = _run_shards(mesh, per, _pad_rows([a, r], size) + [zk, z], launch)
        with _on(mesh.devices[0]):
            return int(fail_count(_gather(mesh, counts)).item()) == 0


verify_batch_sharded_rlc.launches = 0  # label "rlc"
