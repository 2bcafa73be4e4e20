"""Batched ed25519 verification: the per-signature bitmap plane.

Every signature's cofactored ZIP-215 equation

    [8]([s]B - [k]A - R) == identity,  k = SHA512(R || A || M) mod L

is evaluated data-parallel across the batch and yields the per-signature
validity bitmap directly, with exactly the acceptance of the JAX package
(tendermint_tpu/ops/verify.py) and of its pure-Python oracle.

Five kernels live here, each a hand-written CUDA kernel for Hopper
(csrc/*.cu) beside its plain PyTorch version (the sr25519 plane's five
are in ops/verify_sr.py and share the pubkey cache and the dispatch
below):

  verify_kernel               csrc/verify.cu                uncached bitmap
  build_pk_tables_split       csrc/pk_tables.cu             split cache fill
  verify_kernel_cached_split  csrc/verify_cached.cu         split cache hit
  build_pk_tables             csrc/pk_tables_single.cu      single-table fill
  verify_kernel_cached        csrc/verify_cached_single.cu  single-table hit

The pubkey cache has the reference's geometries (TM_TPU_PK_SPLIT): at
S = 2, 4 (the default) or 8 an entry holds S power tables, (S, 16, 4, 32),
and the cache hit runs the split ladder; at S = 1 it holds one table,
(16, 4, 32), and the hit runs the 252-doubling ladder. The cache-hit
kernel is picked from a cache's entry shape, never from the setting.

A wrapper launches its kernel for CUDA tensors and runs the plain version
only for tensors on the CPU; anything else raises. Each wrapper counts its
kernel launches in `<wrapper>.launches`. Kernels run on the current
stream; the scratch a wrapper allocates may be freed as soon as it
returns, because PyTorch's caching allocator hands that memory only to
work queued after the kernel on the same stream.

Split of labor: the host computes the SHA-512 challenges, checks s < L
and the lengths (native/prep.c unless TM_TPU_NATIVE=0), and pads the
batch to a power of two; the device decodes the points, runs the ladders
and the cofactored equality.

Telemetry, at the reference's sites and under its names: the
`ops.verify_dispatch` and `ops.pk_cache_fill` spans, EngineMetrics
`kernel_launches` by the reference's labels ("bitmap", "bitmap_cached",
"pk_table_build"), and devobs spans over each launch's h2d copies and
each collect's d2h read. The per-wrapper `.launches` counts stay as they
are.
"""

from __future__ import annotations

import collections
import hashlib
import os
import threading

import numpy as np
import torch

from .. import devobs as _devobs
from .. import native
from .. import trace as _trace
from ..metrics import engine_metrics as _engine_metrics
from . import _build
from . import curve as C

L = 2**252 + 27742317777372353535851937790883648493

# The split of the cache's power tables (TM_TPU_PK_SPLIT): the default, and
# the splits the reference accepts.
PK_SPLITS = 4
SPLITS = (1, 2, 4, 8)


def pk_splits() -> int:
    """TM_TPU_PK_SPLIT, checked as the reference checks it. The module
    calls this once at import, so an invalid split fails there, as the
    reference's import does; each cache lookup reads it again."""
    splits = int(os.environ.get("TM_TPU_PK_SPLIT", str(PK_SPLITS)))
    if splits not in SPLITS:
        raise ValueError(f"TM_TPU_PK_SPLIT must be 1, 2, 4 or 8, got {splits}")
    return splits


pk_splits()


def cache_entry_shape(splits: int) -> tuple:
    """One cache entry: a single table (16, 4, 32) at S = 1, S power tables
    (S, 16, 4, 32) above."""
    return (16, 4, 32) if splits == 1 else (splits, 16, 4, 32)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller names
    another. There is no quiet fallback to the host."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port verifies on the card by default; pass "
                "device='cpu' to run the plain PyTorch versions on the host, or set "
                "TM_TPU_CRYPTO=off for serial host verification"
            )
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


_DEVICE_TABLES: dict = {}


def device_table(name: str, device: torch.device) -> torch.Tensor:
    """The host base-point tables as int32 radix-2^8 limbs on `device`:
    'base' (16, 4, 32) and 'fixed' (64, 16, 4, 32)."""
    key = (name, str(device))
    t = _DEVICE_TABLES.get(key)
    if t is None:
        src = C.base_table() if name == "base" else C.fixed_base_table()
        t = _DEVICE_TABLES[key] = torch.as_tensor(src, dtype=torch.int32).contiguous().to(device)
    return t


def _route(name: str, *tensors) -> bool:
    """True for the kernel (CUDA tensors), False for the plain version
    (CPU tensors); raises on anything else or on mixed devices."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"{name}: inputs on several devices {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    return True


def _check_rows(name: str, n: int, width: int, *tensors) -> None:
    for t in tensors:
        if t.dtype != torch.uint8 or tuple(t.shape) != (n, width) or not t.is_contiguous():
            raise ValueError(
                f"{name}: expected contiguous uint8 ({n}, {width}), got {t.dtype} {tuple(t.shape)}"
            )


def table_splits(tables) -> int:
    """The split S of a cache's tables, from their entry shape (0 for no
    cache shape)."""
    return 1 if tables.ndim == 4 else (tables.shape[1] if tables.ndim == 5 else 0)


def _check_tables(name: str, tables, splits) -> None:
    """tables (C, *entry) int16, contiguous, of an entry shape `splits`
    allows."""
    s = table_splits(tables)
    if (tables.dtype != torch.int16 or s not in splits
            or tuple(tables.shape[1:]) != cache_entry_shape(s) or not tables.is_contiguous()):
        raise ValueError(f"{name}: bad tables {tables.dtype} {tuple(tables.shape)}")


def _check_cache_args(name: str, n: int, splits, tables, oks, slots) -> None:
    """A cache kernel's view of the cache: tables (C, *entry) int16 of a
    split in `splits`, oks (C,) bool and slots (n,) int32, all contiguous."""
    _check_tables(name, tables, splits)
    if oks.dtype != torch.bool or oks.shape != (tables.shape[0],) or not oks.is_contiguous():
        raise ValueError(f"{name}: bad oks {oks.dtype} {tuple(oks.shape)}")
    if slots.dtype != torch.int32 or slots.shape != (n,) or not slots.is_contiguous():
        raise ValueError(f"{name}: bad slots {slots.dtype} {tuple(slots.shape)}")


def _limb_major(x: torch.Tensor) -> torch.Tensor:
    """(B, n) byte rows -> (n, B) int32, the field layout."""
    return x.t().to(torch.int32)


def _cofactored_accept(q, r_pt, a_ok, r_ok, n):
    """[8]([s]B - [k]A) == [8]R as a projective equality, both sides'
    cofactor doublings stacked; shared by every bitmap plane."""
    both = torch.cat([q, r_pt], dim=-1)
    for _ in range(3):
        both = C.point_double(both, out_t=False)
    return a_ok & r_ok & C.point_equal(both[..., :n], both[..., n:])


# -- kernel 1: uncached bitmap ---------------------------------------------


def verify_kernel_plain(a_enc, r_enc, s_bytes, k_bytes):
    """Plain version: (B, 32) uint8 rows -> (B,) bool validity. s must be
    prechecked < L on the host; k is the challenge reduced mod L."""
    a, r = _limb_major(a_enc), _limb_major(r_enc)
    s, k = _limb_major(s_bytes), _limb_major(k_bytes)
    n = a.shape[1]
    pts, oks = C.decompress(torch.cat([a, r], dim=1))
    a_pt, r_pt = pts[..., :n], pts[..., n:]
    q = C.double_scalar_mul_base(s, k, C.point_neg(a_pt), final_t=False)
    return _cofactored_accept(q, r_pt, oks[:n], oks[n:], n)


def verify_kernel(a_enc, r_enc, s_bytes, k_bytes):
    """Uncached bitmap: csrc/verify.cu on CUDA tensors (two launches from
    one entry point, counted once: the decode and tables step, then the
    four-lane ladder), the plain version on CPU tensors."""
    if not _route("verify_kernel", a_enc, r_enc, s_bytes, k_bytes):
        return verify_kernel_plain(a_enc, r_enc, s_bytes, k_bytes)
    n = a_enc.shape[0]
    _check_rows("verify_kernel", n, 32, a_enc, r_enc, s_bytes, k_bytes)
    dev = a_enc.device
    out = torch.empty(n, dtype=torch.bool, device=dev)
    # 17 points of 40 int32 a row (-A's 16 multiples, -R), then 2 n decode bytes
    scratch = torch.empty(17 * 40 * n + (n + 1) // 2, dtype=torch.int32, device=dev)
    lib = _build.load("verify")
    rc = lib.tm_verify(
        a_enc.data_ptr(), r_enc.data_ptr(), s_bytes.data_ptr(), k_bytes.data_ptr(),
        device_table("base", dev).data_ptr(), scratch.data_ptr(), out.data_ptr(), n,
        _build.stream_of(a_enc),
    )
    _build.check(rc, "verify_kernel")
    verify_kernel.launches += 1
    return out


verify_kernel.launches = 0


# -- kernel 2: pubkey-cache fill --------------------------------------------


def _power_tables_plain(a_pt, splits):
    """(B, *cache_entry_shape(splits)) int16 power tables of the point a_pt
    (4, 32, B), the fills' shared tail: limbs are fe_mul outputs
    (|limb| < 2^9), exactly the JAX programs'."""
    tabs = C.build_power_tables(a_pt, splits=splits).permute(4, 0, 1, 2, 3)
    if splits == 1:
        tabs = tabs[:, 0]
    return tabs.to(torch.int16).contiguous()


def _check_splits(name: str, splits: int, allowed=SPLITS[1:]) -> None:
    if splits not in allowed:
        raise ValueError(f"{name}: splits must be one of {allowed}, got {splits}")


def _launch_fill(name: str, lib_name: str, entry: str, a_enc, splits=None):
    """Allocate a fill's outputs and launch it; splits=None is the
    single-table entry point (no splits argument)."""
    n = a_enc.shape[0]
    _check_rows(name, n, 32, a_enc)
    dev = a_enc.device
    tables = torch.empty((n,) + cache_entry_shape(splits or 1), dtype=torch.int16, device=dev)
    oks = torch.empty(n, dtype=torch.bool, device=dev)
    args = (a_enc.data_ptr(), tables.data_ptr(), oks.data_ptr(), n)
    if splits is not None:
        args += (splits,)
    rc = getattr(_build.load(lib_name), entry)(*args, _build.stream_of(a_enc))
    _build.check(rc, name)
    return tables, oks


def build_pk_tables_split_plain(a_enc, splits: int = PK_SPLITS):
    """Plain version: (B, 32) uint8 pubkeys -> ((B, S, 16, 4, 32) int16
    power tables of -A, (B,) bool decode bits)."""
    a_pt, ok = C.decompress(_limb_major(a_enc))
    return _power_tables_plain(C.point_neg(a_pt), splits), ok


def build_pk_tables_split(a_enc, splits: int = PK_SPLITS):
    """Split cache fill at S = splits (2, 4 or 8): csrc/pk_tables.cu on CUDA
    tensors (coordinates written canonical), the plain version on CPU
    tensors."""
    _check_splits("build_pk_tables_split", splits)
    if not _route("build_pk_tables_split", a_enc):
        return build_pk_tables_split_plain(a_enc, splits)
    out = _launch_fill("build_pk_tables_split", "pk_tables", "tm_build_pk_tables", a_enc, splits)
    build_pk_tables_split.launches += 1
    return out


build_pk_tables_split.launches = 0


# -- kernel 3: cache-hit bitmap ---------------------------------------------


def cache_slots(slots, capacity: int) -> torch.Tensor:
    """The cache entries int32 slots read, as int64 indices, mapped as the
    reference's `tables[slots]` under jnp indexing maps them (and the
    kernels' cache_slot, csrc/ladder.cuh): a negative slot counts from the
    end (slot + C), then the index clamps into [0, C - 1]."""
    s = slots.long()
    return torch.where(s < 0, s + capacity, s).clamp_(0, capacity - 1)


def _cached_a_tables(tables, slots):
    """The slots' cache entries as int32 limbs, batch last: (S, 16, 4, 32,
    B) for a split cache, (16, 4, 32, B) for a single-table one."""
    a = tables[cache_slots(slots, tables.shape[0])].to(torch.int32)
    return a.permute(*range(1, a.ndim), 0)


def verify_kernel_cached_split_plain(tables, oks, slots, r_enc, s_bytes, k_bytes):
    """Plain version: cache tables (C, S, 16, 4, 32) int16, oks (C,) bool,
    slots (B,) int32, rows (B, 32) uint8 -> (B,) bool; S is the tables'."""
    r = _limb_major(r_enc)
    s, k = _limb_major(s_bytes), _limb_major(k_bytes)
    r_pt, r_ok = C.decompress(r)
    q = C.double_scalar_mul_split(s, k, _cached_a_tables(tables, slots), splits=tables.shape[1])
    return _cofactored_accept(q, r_pt, oks[cache_slots(slots, len(oks))], r_ok, r.shape[1])


def _launch_hit(name: str, lib_name: str, entry: str, table: str, splits, args):
    """Check a cache-hit kernel's inputs and launch it: `splits` are the
    entry geometries it takes, `table` the base-point table it reads."""
    tables, oks, slots, r_enc, s_bytes, k_bytes = args
    n = r_enc.shape[0]
    _check_rows(name, n, 32, r_enc, s_bytes, k_bytes)
    _check_cache_args(name, n, splits, tables, oks, slots)
    dev = r_enc.device
    out = torch.empty(n, dtype=torch.bool, device=dev)
    extra = (tables.shape[1],) if splits != (1,) else ()
    rc = getattr(_build.load(lib_name), entry)(
        tables.data_ptr(), oks.data_ptr(), slots.data_ptr(), r_enc.data_ptr(),
        s_bytes.data_ptr(), k_bytes.data_ptr(), device_table(table, dev).data_ptr(),
        out.data_ptr(), n, tables.shape[0], *extra, _build.stream_of(r_enc),
    )
    _build.check(rc, name)
    return out


def verify_kernel_cached_split(tables, oks, slots, r_enc, s_bytes, k_bytes):
    """Split cache-hit bitmap: csrc/verify_cached.cu on CUDA tensors, the
    plain version on CPU tensors."""
    args = (tables, oks, slots, r_enc, s_bytes, k_bytes)
    if not _route("verify_kernel_cached_split", *args):
        return verify_kernel_cached_split_plain(*args)
    out = _launch_hit("verify_kernel_cached_split", "verify_cached", "tm_verify_cached_split",
                      "fixed", SPLITS[1:], args)
    verify_kernel_cached_split.launches += 1
    return out


verify_kernel_cached_split.launches = 0


# -- kernel 5: single-table pubkey-cache fill -------------------------------


def build_pk_tables_plain(a_enc):
    """Plain version: (B, 32) uint8 pubkeys -> ((B, 16, 4, 32) int16 table
    of -A, (B,) bool decode bits); the JAX program's _build_var_table, which
    is build_power_tables at one split."""
    a_pt, ok = C.decompress(_limb_major(a_enc))
    return _power_tables_plain(C.point_neg(a_pt), 1), ok


def build_pk_tables(a_enc):
    """Single-table cache fill: csrc/pk_tables_single.cu on CUDA tensors
    (coordinates written canonical), the plain version on CPU tensors."""
    if not _route("build_pk_tables", a_enc):
        return build_pk_tables_plain(a_enc)
    out = _launch_fill("build_pk_tables", "pk_tables_single", "tm_build_pk_tables_single", a_enc)
    build_pk_tables.launches += 1
    return out


build_pk_tables.launches = 0


# -- kernel 6: single-table cache-hit bitmap --------------------------------


def verify_kernel_cached_plain(tables, oks, slots, r_enc, s_bytes, k_bytes):
    """Plain version: cache tables (C, 16, 4, 32) int16, oks (C,) bool,
    slots (B,) int32, rows (B, 32) uint8 -> (B,) bool, by the 252-doubling
    ladder on the cached table (double_scalar_mul_base(..., a_table=))."""
    r = _limb_major(r_enc)
    s, k = _limb_major(s_bytes), _limb_major(k_bytes)
    r_pt, r_ok = C.decompress(r)
    q = C.double_scalar_mul_base(s, k, final_t=False, a_table=_cached_a_tables(tables, slots))
    return _cofactored_accept(q, r_pt, oks[cache_slots(slots, len(oks))], r_ok, r.shape[1])


def verify_kernel_cached(tables, oks, slots, r_enc, s_bytes, k_bytes):
    """Single-table cache-hit bitmap: csrc/verify_cached_single.cu on CUDA
    tensors, the plain version on CPU tensors."""
    args = (tables, oks, slots, r_enc, s_bytes, k_bytes)
    if not _route("verify_kernel_cached", *args):
        return verify_kernel_cached_plain(*args)
    out = _launch_hit("verify_kernel_cached", "verify_cached_single", "tm_verify_cached",
                      "base", (1,), args)
    verify_kernel_cached.launches += 1
    return out


verify_kernel_cached.launches = 0


# -- the device-resident pubkey cache ---------------------------------------


def _plane_build(plane: str, splits: int):
    """The cache-fill kernel of a signature plane at a split."""
    if plane == "ed25519":
        single, split = build_pk_tables, build_pk_tables_split
    elif plane == "sr25519":
        from .verify_sr import build_sr_tables, build_sr_tables_split

        single, split = build_sr_tables, build_sr_tables_split
    else:
        raise ValueError(f"no pubkey-cache plane {plane!r}")
    if splits == 1:
        return single
    return lambda a_enc: split(a_enc, splits)


class PubkeyCache:
    """Device-resident decompressed-pubkey cache: each key's power tables
    of -A, so cache hits skip decoding and the table build (the device
    analog of the reference node's 4096-entry expanded-key LRU). `splits`
    is the geometry: S power tables an entry at S = 2, 4 or 8, one table
    at S = 1 (cache_entry_shape). At the default capacity and S = 4 the
    tables take (4096, 4, 16, 4, 32) int16, 64 MiB of device memory (16 MiB
    a split).

    A cache belongs to one signature plane (`plane`, "ed25519" or
    "sr25519"): the same 32 bytes decode to different points under ZIP-215
    and under ristretto, so each plane has its own cache per device and
    never shares slots with the other.

    Fills reserve slots under the lock, build the tables with the lock
    released, and publish under the lock (the JAX package's protocol).

    Publishing is copy-on-write: `index_copy` (out of place) makes a new
    tables tensor, so a launch already queued against an earlier snapshot
    keeps reading the tables it was given; the old tensor's memory returns
    to PyTorch's stream-ordered allocator only after that launch on the
    same stream. A fill thus costs one copy of the cache (two 64 MiB
    passes at the default capacity) besides the build."""

    def __init__(self, capacity: int = 4096, device=None, build_fn=None, plane: str = "ed25519",
                 splits: int = PK_SPLITS):
        _check_splits("PubkeyCache", splits, SPLITS)
        self.capacity = capacity
        self.device = resolve_device(device)
        self.plane = plane
        self._build = build_fn or _plane_build(plane, splits)
        self._lock = threading.Lock()
        self._lru: "collections.OrderedDict[bytes, int]" = collections.OrderedDict()
        # keys reserved but not yet published (key -> Event set at publish)
        self._pending: "dict[bytes, threading.Event]" = {}
        # eviction pin counts for every key an in-flight fill depends on
        self._pinned: "dict[bytes, int]" = {}
        self.tables = torch.zeros((capacity,) + cache_entry_shape(splits), dtype=torch.int16,
                                  device=self.device)
        self.oks = torch.zeros((capacity,), dtype=torch.bool, device=self.device)

    def ensure(self, pubkeys):
        """Map pubkeys -> (B,) int32 slots, filling misses in one batched
        kernel launch; None when the batch has more distinct keys than the
        cache holds (the caller then takes the uncached kernel)."""
        slots, _tables, _oks = self.ensure_snapshot(pubkeys)
        return slots

    def ensure_snapshot(self, pubkeys):
        """(slots, tables, oks) as one consistent view: the tensors the
        slot computation published against."""
        while True:
            with self._lock:
                distinct = list(dict.fromkeys(pubkeys))
                if len(distinct) > self.capacity:
                    return None, self.tables, self.oks
                waits = {self._pending[pk] for pk in distinct if pk in self._pending}
                if not waits:
                    # refresh present keys first so eviction below never
                    # pops a key this batch is about to use
                    for pk in distinct:
                        if pk in self._lru:
                            self._lru.move_to_end(pk)
                    missing = [pk for pk in distinct if pk not in self._lru]
                    if not missing:
                        slots = np.fromiter((self._lru[pk] for pk in pubkeys), np.int32)
                        return slots, self.tables, self.oks
                    free = self.capacity - len(self._lru)
                    evictable = [
                        pk for pk in self._lru if pk not in self._pending and pk not in self._pinned
                    ]  # least recent first
                    need = max(0, len(missing) - free)
                    if need > len(evictable):
                        # every eviction candidate is mid-fill elsewhere
                        return None, self.tables, self.oks
                    for pk in evictable[:need]:
                        del self._lru[pk]
                    used = set(self._lru.values())
                    free_slots = iter(i for i in range(self.capacity) if i not in used)
                    idx = np.fromiter((next(free_slots) for _ in missing), np.int32)
                    event = threading.Event()
                    for pk, slot in zip(missing, idx):
                        self._lru[pk] = int(slot)
                        self._pending[pk] = event
                    for pk in distinct:
                        self._pinned[pk] = self._pinned.get(pk, 0) + 1
            if waits:
                for ev in waits:
                    ev.wait()
                continue  # the fills we waited on moved the LRU
            # ---- build outside the lock
            try:
                enc = np.frombuffer(b"".join(missing), np.uint8).reshape(-1, 32)
                (enc_p,) = pad_pow2_rows([enc], len(missing))
                fid = _devobs.next_flow() if _devobs.enabled() else 0
                with _trace.span("ops.pk_cache_fill", "ops", misses=len(missing), flow=fid):
                    (enc_dev,) = _h2d([enc_p], self.device, fid)
                    with _devobs.attribution(fn=f"{self.plane}_table_build",
                                             rows=_pad_pow2(len(missing)), flow=fid):
                        new_tables, new_oks = self._build(enc_dev)
                _engine_metrics().kernel_launches.add(1, "pk_table_build")
            except BaseException:
                with self._lock:
                    for pk in missing:
                        self._lru.pop(pk, None)
                        if self._pending.get(pk) is event:
                            del self._pending[pk]
                    self._unpin(distinct)
                event.set()  # waiters retry against the rolled-back state
                raise
            m = len(missing)
            idx_dev = torch.from_numpy(idx.astype(np.int64)).to(self.device)
            with self._lock:
                self.tables = self.tables.index_copy(0, idx_dev, new_tables[:m])
                self.oks = self.oks.index_copy(0, idx_dev, new_oks[:m])
                for pk in missing:
                    if self._pending.get(pk) is event:
                        del self._pending[pk]
                self._unpin(distinct)
                slots = np.fromiter((self._lru[pk] for pk in pubkeys), np.int32)
                tables, oks = self.tables, self.oks
            event.set()
            return slots, tables, oks

    def _unpin(self, keys) -> None:
        """Drop one eviction pin per key (lock held by caller)."""
        for pk in keys:
            n = self._pinned.get(pk, 0) - 1
            if n > 0:
                self._pinned[pk] = n
            else:
                self._pinned.pop(pk, None)


def cache_from_reference(tables: np.ndarray, oks: np.ndarray, slots: dict, device=None,
                         plane: str = "ed25519") -> PubkeyCache:
    """A port cache from a snapshot of one of the JAX package's
    PubkeyCaches, of any geometry it builds: its tables, (C, 16, 4, 32)
    (TM_TPU_PK_SPLIT=1) or (C, S, 16, 4, 32) int16 for S = 2, 4 or 8, and
    oks (C,) bool as numpy arrays, and its key -> slot map (least recent
    first, as the reference's LRU iterates). `plane` names the cache it
    came from: "ed25519" (ops/verify.py pubkey_cache) or "sr25519"
    (ops/verify_sr.py sr_pubkey_cache); later misses are filled by that
    plane's kernel at the same split. The reference's signed limbs are
    taken as they are; the cache-hit paths read them modulo p."""
    tables = np.asarray(tables)
    splits = table_splits(tables)
    if splits not in SPLITS or tables.shape[1:] != cache_entry_shape(splits):
        raise ValueError(f"cache tables of entry shape {tables.shape[1:]}: the reference's "
                         "caches hold (16, 4, 32) or (S, 16, 4, 32) entries, S in 2, 4, 8")
    cache = PubkeyCache(capacity=tables.shape[0], device=device, plane=plane, splits=splits)
    cache.tables = torch.as_tensor(tables.astype(np.int16)).to(cache.device)
    cache.oks = torch.from_numpy(np.array(oks, dtype=bool)).to(cache.device)
    cache._lru.update((bytes(pk), int(slot)) for pk, slot in slots.items())
    return cache


_PK_CACHES: dict[tuple[str, int, str], PubkeyCache] = {}
_PK_CACHES_LOCK = threading.Lock()


def plane_cache(plane: str, device=None) -> PubkeyCache:
    """The process-wide pubkey cache of one plane, at the split
    TM_TPU_PK_SPLIT names, on one device: a cache of one geometry never
    reaches a kernel of another."""
    splits = pk_splits()
    dev = resolve_device(device)
    key = (plane, splits, str(dev))
    with _PK_CACHES_LOCK:
        cache = _PK_CACHES.get(key)
        if cache is None:
            cache = _PK_CACHES[key] = PubkeyCache(device=dev, plane=plane, splits=splits)
    return cache


def pubkey_cache(device=None) -> PubkeyCache:
    """The process-wide ed25519 pubkey cache of a device."""
    return plane_cache("ed25519", device)


# -- host shaping and dispatch ----------------------------------------------


def _pad_pow2(n: int, floor: int = 8) -> int:
    size = floor
    while size < n:
        size *= 2
    return size


def pad_pow2_rows(arrays, n: int):
    """Pad (n, w) uint8 arrays with zero rows up to the next power of two
    (at least 8). Zero rows decode (y = 0 has a root), which the RLC's
    all-decode test relies on."""
    size = _pad_pow2(n)
    if size == n:
        return arrays
    return [np.pad(a, ((0, size - n), (0, 0))) for a in arrays]


def _prepare_batch_py(pubkeys, msgs, sigs):
    """Pure-Python prep: the TM_TPU_NATIVE=0 path, the route for
    non-standard lengths, and the oracle of the native path."""
    n = len(sigs)
    raw = np.zeros((4, n, 32), np.uint8)  # a, r, s, k rows
    precheck = np.zeros((n,), bool)
    sha512 = hashlib.sha512
    from_bytes = int.from_bytes
    for i in range(n):
        pk, sig = pubkeys[i], sigs[i]
        if len(pk) != 32 or len(sig) != 64:
            continue
        s = from_bytes(sig[32:], "little")
        if s >= L:
            continue
        k = from_bytes(sha512(sig[:32] + pk + msgs[i]).digest(), "little") % L
        raw[0, i] = np.frombuffer(pk, np.uint8)
        raw[1, i] = np.frombuffer(sig, np.uint8, count=32)
        raw[2, i] = np.frombuffer(sig, np.uint8, count=32, offset=32)
        raw[3, i] = np.frombuffer(k.to_bytes(32, "little"), np.uint8)
        precheck[i] = True
    return raw[0], raw[1], raw[2], raw[3], precheck


def _prepare_batch_native(lib, pubkeys, msgs, sigs):
    """The C path (native/prep.c prepare_batch): one call hashes, reduces
    and shapes the whole batch, on up to 8 threads. Keys must be 32 bytes
    and signatures 64."""
    import ctypes

    n = len(sigs)
    offsets = native.offsets_of(msgs)
    rows = np.zeros((4, n, 32), np.uint8)  # a, r, s, k rows
    pre = np.zeros(n, np.uint8)
    as_u8 = lambda arr: arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))  # noqa: E731
    rc = lib.prepare_batch(
        b"".join(pubkeys), b"".join(sigs), b"".join(msgs),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n,
        as_u8(rows[0]), as_u8(rows[1]), as_u8(rows[2]), as_u8(rows[3]),
        pre.ctypes.data_as(ctypes.c_char_p),
    )
    if rc != 0:
        raise MemoryError(f"native prepare_batch failed (status {rc}): a message buffer "
                          "could not be allocated")
    return rows[0], rows[1], rows[2], rows[3], pre.astype(bool)


def prepare_batch(pubkeys, msgs, sigs):
    """Host-side shaping: (a_enc, r_enc, s_bytes, k_bytes, precheck) as
    numpy uint8 (B, 32) rows and a (B,) bool precheck. Malformed lengths
    and s >= L fail the precheck (their rows stay zero) instead of
    raising. The native library runs it unless TM_TPU_NATIVE=0; a batch
    with a key or signature of another length takes the Python path (the
    C ABI packs 32-byte keys and 64-byte signatures)."""
    n = len(sigs)
    if (
        n
        and len(pubkeys) == n
        and len(msgs) == n
        and all(len(pk) == 32 for pk in pubkeys)
        and all(len(sg) == 64 for sg in sigs)
        and not native.native_disabled()
    ):
        return _prepare_batch_native(native.load_prep(), pubkeys, msgs, sigs)
    return _prepare_batch_py(pubkeys, msgs, sigs)


def _to_device(arrays, device):
    return [torch.from_numpy(np.require(a, requirements=["C", "W"])).to(device) for a in arrays]


def _h2d(arrays, device, flow: int = 0):
    """_to_device under one devobs h2d span of the arrays' bytes: a launch's
    copies to the device."""
    with _devobs.transfer_span("h2d", sum(a.nbytes for a in arrays), flow=flow):
        return _to_device(arrays, device)


def verify_batch_async(pubkeys, msgs, sigs, device=None):
    """Dispatch one batch without blocking: host prep, copy to the device,
    kernel launch. Returns (device_bitmap, precheck, n, flow) for
    `collect`."""
    n = len(sigs)
    if n == 0:
        return None, np.zeros((0,), bool), 0, 0
    dev = resolve_device(device)
    fid = _devobs.next_flow() if _devobs.enabled() else 0
    with _trace.span("ops.verify_dispatch", "ops", kernel="bitmap", rows=n, flow=fid):
        a_enc, r_enc, s_bytes, k_bytes, precheck = prepare_batch(pubkeys, msgs, sigs)
        rows = pad_pow2_rows([a_enc, r_enc, s_bytes, k_bytes], n)
        dev_rows = _h2d(rows, dev, fid)
        with _devobs.attribution(fn="ed25519_bitmap", rows=_pad_pow2(n), flow=fid):
            ok_dev = verify_kernel(*dev_rows)
    _engine_metrics().kernel_launches.add(1, "bitmap")
    return ok_dev, precheck, n, fid


def collect(dispatched) -> np.ndarray:
    """Block on a dispatched bitmap and fold in the host precheck."""
    ok_dev, precheck, n = dispatched[:3]
    if n == 0:
        return np.zeros((0,), bool)
    fid = dispatched[3] if len(dispatched) > 3 else 0
    with _devobs.transfer_span("d2h", ok_dev.numel() * ok_dev.element_size(), flow=fid):
        host = ok_dev.cpu().numpy()
    return host[:n] & precheck


def verify_batch(pubkeys, msgs, sigs, device=None) -> np.ndarray:
    """End-to-end batched verification -> (n,) bool numpy bitmap."""
    return collect(verify_batch_async(pubkeys, msgs, sigs, device))


def dispatch_cached(cache: PubkeyCache, prepare, cached_kernel, uncached_async, pubkeys, msgs, sigs,
                    fn_label: str = "bitmap_cached"):
    """Bitmap through a pubkey cache, for either signature plane (its host
    prep, its cache-hit kernel, its uncached dispatch): slot lookup and
    fill (one consistent snapshot), the uncached dispatch when the batch
    has more distinct keys than the cache holds, padding, launch.
    Malformed pubkeys are keyed as zeros; they already fail the precheck,
    which masks them at collect. `fn_label` names the site to devobs."""
    n = len(sigs)
    if n == 0:
        return None, np.zeros((0,), bool), 0, 0
    fid = _devobs.next_flow() if _devobs.enabled() else 0
    with _trace.span("ops.verify_dispatch", "ops", kernel="bitmap_cached", rows=n, flow=fid) as sp:
        keys = [pk if len(pk) == 32 else b"\x00" * 32 for pk in pubkeys]
        slots, tables, oks = cache.ensure_snapshot(keys)
        if slots is None:
            sp.annotate(cache="overflow")
            return uncached_async(pubkeys, msgs, sigs, cache.device)
        _, r_enc, s_bytes, k_bytes, precheck = prepare(pubkeys, msgs, sigs)
        r_enc, s_bytes, k_bytes = pad_pow2_rows([r_enc, s_bytes, k_bytes], n)
        # padded rows copy the edge slot: a valid key, never a stale one
        slots = np.pad(slots, (0, len(r_enc) - n), mode="edge")
        slots_dev, r_dev, s_dev, k_dev = _h2d([slots, r_enc, s_bytes, k_bytes], cache.device, fid)
        with _devobs.attribution(fn=fn_label, rows=_pad_pow2(n), flow=fid):
            ok_dev = cached_kernel(tables, oks, slots_dev, r_dev, s_dev, k_dev)
    _engine_metrics().kernel_launches.add(1, "bitmap_cached")
    return ok_dev, precheck, n, fid


def verify_batch_cached_async(pubkeys, msgs, sigs, device=None):
    """verify_batch_async through the device's pubkey cache: repeated
    validator sets skip decoding and the table build. The kernel is picked
    from the cache's entry shape."""
    cache = pubkey_cache(device)
    kern = verify_kernel_cached_split if cache.tables.ndim == 5 else verify_kernel_cached
    return dispatch_cached(cache, prepare_batch, kern, verify_batch_async, pubkeys, msgs, sigs,
                           fn_label="ed25519_bitmap_cached")

