"""Randomized-linear-combination batched ed25519 verification (MSM).

One equation checks a whole batch,

    [8](-[sum z_i s_i mod L]B + sum [z_i]R_i + sum [z_i h_i mod L]A_i) == 0

with per-batch random 128-bit z_i (the reference node's batch verifier).
All-valid batches accept deterministically; any invalid signature makes
the check fail except with probability about 2^-128 over z, and the
caller then localizes with the bitmap plane (ops/verify.py), so the
end-to-end acceptance equals the per-signature plane's.

`msm_verify_kernel` launches csrc/msm.cu for CUDA tensors and runs its
plain PyTorch version (the JAX package's window-parallel Straus
formulation, tendermint_tpu/ops/msm.py) for CPU tensors; its launch count
is `msm_verify_kernel.launches`.

The sr25519 plane's equation is the same sum over ristretto255, which has
prime order: sum z_i ([s_i]B - [k_i]A_i - R_i) must be the group identity,
decided by its ristretto encoding being 32 zero bytes, with no cofactor
doublings. `msm_verify_sr_kernel` (csrc/msm_sr.cu, sharing csrc/msm.cuh
with the ed25519 kernel) decodes with the ristretto codec.

`msm_verify_kernel_cached` (csrc/msm_cached.cu) is the ed25519 check with
A read from the split pubkey cache (TM_TPU_MSM_CACHE=on, the reference's
default off): no A decode and no A table, and A's 64 nibbles ride the S
power tables of its cache entry in 64/S windows, so the Horner tail runs
over max(32, 64/S) windows instead of 64.

The dispatches write the reference's `ops.msm_dispatch` span (kernel "rlc"
or "rlc_cached", annotated refused="precheck" or cache="overflow"),
EngineMetrics `kernel_launches` by the same labels, and devobs spans over
the h2d copies and the verdict's d2h read.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .. import devobs as _devobs
from .. import native
from .. import trace as _trace
from ..metrics import engine_metrics as _engine_metrics
from . import _build
from . import curve as C
from . import ristretto as R
from .verify import (
    L, SPLITS, _check_cache_args, _check_rows, _h2d, _limb_major, _pad_pow2, _route, cache_slots,
    device_table, pad_pow2_rows, prepare_batch, pubkey_cache, resolve_device,
)
from .verify_sr import prepare_batch as prepare_batch_sr

# Parallel point streams, rounded down to a power of two: padded batches
# are powers of two, so a power-of-two G always divides them.
G_STREAMS = 1 << max(0, int(os.environ.get("TM_TPU_MSM_STREAMS", "128")).bit_length() - 1)


def _streams(n: int) -> int:
    """Stream count for a batch of n rows, with the loud divisibility guard:
    rounds = n // g would silently drop the tail rows from the sum, and a
    tail row holding the only invalid signature would be accepted."""
    g = min(G_STREAMS, n)
    if n % g:
        raise ValueError(
            f"MSM batch size {n} is not a multiple of the stream count {g}; "
            f"pad the batch (pad_pow2_rows) so no rows drop from the RLC sum"
        )
    return g


# The windows step's grid (csrc/msm.cuh msm_windows): 96 columns (64 A
# windows, 32 R windows) x G streams x K chunks, blocks of up to 128
# threads, two blocks resident on an SM at 255 registers a thread.
MSM_COLS = 96
WINDOW_BLOCK = 128
RESIDENT_PER_SM = 2 * WINDOW_BLOCK
# Rows a windows-step thread walks at most, where K allows.
MAX_CHUNK_ROUNDS = 32


def _window_chunks(n: int, g: int, sms: int) -> int:
    """K, the chunks each stream's n // g rounds are split into: the least
    power of two that gives the windows grid two resident waves on `sms`
    SMs and each thread at most MAX_CHUNK_ROUNDS rows, within K <= n // g
    (no chunk is empty) and K <= WINDOW_BLOCK (a stream's chunks share a
    block)."""
    rounds = n // g
    k = 1
    while 2 * k <= min(rounds, WINDOW_BLOCK) and (
            MSM_COLS * g * k < 2 * RESIDENT_PER_SM * sms or rounds > MAX_CHUNK_ROUNDS * k):
        k *= 2
    return k


def _select_windows(table: torch.Tensor, nibs: torch.Tensor) -> torch.Tensor:
    """table (16, 4, 32, G), nibs (W, G) -> (4, 32, W, G): entry nibs[w, g]
    of column g for every window."""
    w, g = nibs.shape
    idx = nibs.long().reshape(1, 1, w, g).expand(4, 32, w, g)
    return torch.gather(table.permute(1, 2, 0, 3), 2, idx)


def _tree_reduce_points(p: torch.Tensor) -> torch.Tensor:
    """Sum a (4, 32, G) stack of points down to (4, 32, 1)."""
    g = p.shape[-1]
    while g > 1:
        half = g // 2
        p = C.point_add(p[..., :half], p[..., half:2 * half], out_t=True)
        g = half
    return p


def _accumulate_windows(neg, nibs_zk, nibs_z, n):
    """Window-parallel Straus accumulation, Horner over the windows and the
    stream reduction: neg holds -A | -R stacked, (4, 32, 2n); returns the
    (4, 32, 1) sum of zk_i (-A_i) + z_i (-R_i) with a valid T."""
    g = _streams(n)
    w_acc = C.identity_point((64, g), neg.device)
    for t in range(n // g):
        col_a = neg[:, :, t * g:(t + 1) * g]
        col_r = neg[:, :, n + t * g:n + (t + 1) * g]
        tables = C._build_var_table(torch.cat([col_a, col_r], dim=2))
        entry_a = _select_windows(tables[..., :g], nibs_zk[:, t * g:(t + 1) * g])
        entry_r = _select_windows(tables[..., g:], nibs_z[:, t * g:(t + 1) * g])
        w_acc = C.point_add(w_acc, entry_a, out_t=True)
        lo = C.point_add(w_acc[:, :, :32], entry_r, out_t=True)
        w_acc = torch.cat([lo, w_acc[:, :, 32:]], dim=2)
    return _horner_reduce(w_acc)


def _horner_reduce(w_acc):
    """Horner over the windows of the (4, 32, W, G) window sums (4
    doublings and one addition a window, from the top) and the stream
    reduction: the (4, 32, 1) total with a valid T."""
    wn = w_acc.shape[2]
    acc = w_acc[:, :, wn - 1]
    for w in range(wn - 2, -1, -1):
        for _ in range(3):
            acc = C.point_double(acc, out_t=False)
        acc = C.point_double(acc, out_t=True)
        acc = C.point_add(acc, w_acc[:, :, w], out_t=True)
    return _tree_reduce_points(acc)


def _cofactored_identity(total, sb):
    """[8](total + sb) is the identity: the ed25519 RLC's decision."""
    total = C.point_add(total, sb, out_t=False)
    for _ in range(3):
        total = C.point_double(total, out_t=False)
    return C.point_is_identity(total)[0]


def msm_verify_kernel_plain(a_enc, r_enc, zk_bytes, z_bytes, zs_bytes):
    """Plain version. a_enc/r_enc (B, 32) uint8 encodings; zk_bytes (B, 32)
    with z_i h_i mod L; z_bytes (B, 16) with z_i; zs_bytes (1, 32) with
    sum z_i s_i mod L. Padding rows carry z = zk = 0 and a decodable
    encoding. Returns a () bool: every encoding decodes and the combined
    equation holds."""
    a, r = _limb_major(a_enc), _limb_major(r_enc)
    n = a.shape[1]
    pts, oks = C.decompress(torch.cat([a, r], dim=1))
    neg = C.point_neg(pts)
    all_ok = torch.all(oks)
    nibs_zk = C.scalar_to_nibbles(_limb_major(zk_bytes))  # (64, B)
    nibs_z = C.scalar_to_nibbles(_limb_major(z_bytes))  # (32, B)
    total = _accumulate_windows(neg, nibs_zk, nibs_z, n)
    sb = C.fixed_base_mul(_limb_major(zs_bytes))  # (4, 32, 1)
    return all_ok & _cofactored_identity(total, sb)


def _msm_scratch(n: int, g: int, dev):
    """The RLC kernels' scratch for n rows of g streams: the 16 multiples of
    each of the 2n points (160-byte rows), their decode bits, the partial
    sum of each (column, stream) and the 64 window sums, 4 x 10 int32 limbs
    a point."""
    return (torch.empty((2 * n, 16, 4 * 10), dtype=torch.int32, device=dev),
            torch.empty(2 * n, dtype=torch.uint8, device=dev),
            torch.empty((4 * 10, MSM_COLS * g), dtype=torch.int32, device=dev),
            torch.empty((4 * 10, 64), dtype=torch.int32, device=dev))


def _launch_msm(name: str, lib_name: str, entry: str, a_enc, r_enc, zk_bytes, z_bytes, zs_bytes):
    """Check the RLC inputs, allocate the scratch and launch one of the RLC
    libraries (four kernels from one C entry point); returns the () bool
    verdict on the device."""
    n = a_enc.shape[0]
    g = _streams(n)
    _check_rows(name, n, 32, a_enc, r_enc, zk_bytes)
    _check_rows(name, n, 16, z_bytes)
    _check_rows(name, 1, 32, zs_bytes)
    dev = a_enc.device
    chunks = _window_chunks(n, g, torch.cuda.get_device_properties(dev).multi_processor_count)
    tabs, oks, part, ws = _msm_scratch(n, g, dev)
    out = torch.empty((), dtype=torch.bool, device=dev)
    rc = getattr(_build.load(lib_name), entry)(
        a_enc.data_ptr(), r_enc.data_ptr(), zk_bytes.data_ptr(), z_bytes.data_ptr(),
        zs_bytes.data_ptr(), device_table("fixed", dev).data_ptr(), tabs.data_ptr(),
        oks.data_ptr(), part.data_ptr(), ws.data_ptr(), out.data_ptr(), n, g, chunks,
        _build.stream_of(a_enc),
    )
    _build.check(rc, name)
    return out


def msm_verify_kernel(a_enc, r_enc, zk_bytes, z_bytes, zs_bytes):
    """RLC check: csrc/msm.cu on CUDA tensors (four launches from one entry
    point, counted once), the plain version on CPU tensors."""
    args = (a_enc, r_enc, zk_bytes, z_bytes, zs_bytes)
    if not _route("msm_verify_kernel", *args):
        return msm_verify_kernel_plain(*args)
    out = _launch_msm("msm_verify_kernel", "msm", "tm_msm_verify", *args)
    msm_verify_kernel.launches += 1
    return out


msm_verify_kernel.launches = 0


def msm_verify_kernel_cached_plain(tables, oks, slots, r_enc, zk_bytes, z_bytes, zs_bytes):
    """Plain version of the cached RLC check: split cache tables
    (C, S, 16, 4, 32) int16 (S = 2, 4 or 8), oks (C,) bool, slots (B,)
    int32 of the rows' keys; r_enc, zk_bytes, z_bytes, zs_bytes as
    msm_verify_kernel_plain's (padding rows carry zero scalars and a valid
    slot). Returns a () bool: every R decodes, every key's entry decoded,
    and the combined equation holds. The JAX program's rounds: each adds
    R's entry for nibble w of z to window w < 32, and cache row c's entry
    for nibble c * 64/S + w of zk to window w < 64/S."""
    r = _limb_major(r_enc)
    n = r.shape[1]
    r_pt, r_oks = C.decompress(r)
    neg_r = C.point_neg(r_pt)
    sl = cache_slots(slots, tables.shape[0])
    all_ok = torch.all(oks[sl]) & torch.all(r_oks)
    splits = tables.shape[1]
    per = 64 // splits  # zk nibbles per cache row
    nibs_zk = C.scalar_to_nibbles(_limb_major(zk_bytes))  # (64, B)
    nibs_z = C.scalar_to_nibbles(_limb_major(z_bytes))  # (32, B)
    g = _streams(n)
    wn = max(32, per)
    w_acc = C.identity_point((wn, g), r.device)
    tabs_a = tables[sl].to(torch.int32).permute(1, 2, 3, 4, 0)  # (S, 16, 4, 32, B)
    for t in range(n // g):
        cols = slice(t * g, (t + 1) * g)
        entry_r = _select_windows(C._build_var_table(neg_r[:, :, cols]), nibs_z[:, cols])
        if wn > 32:
            ident = C.identity_point((wn - 32, g), r.device)
            entry_r = torch.cat([entry_r, ident], dim=2)
        w_acc = C.point_add(w_acc, entry_r, out_t=True)
        lo = w_acc[:, :, :per]
        for c in range(splits):
            entry_c = _select_windows(tabs_a[c][..., cols], nibs_zk[c * per:(c + 1) * per, cols])
            lo = C.point_add(lo, entry_c, out_t=True)
        w_acc = torch.cat([lo, w_acc[:, :, per:]], dim=2)
    total = _horner_reduce(w_acc)
    sb = C.fixed_base_mul(_limb_major(zs_bytes))
    return all_ok & _cofactored_identity(total, sb)


def msm_verify_kernel_cached(tables, oks, slots, r_enc, zk_bytes, z_bytes, zs_bytes):
    """Cached RLC check: csrc/msm_cached.cu on CUDA tensors (four launches
    from one entry point, counted once), the plain version on CPU tensors."""
    args = (tables, oks, slots, r_enc, zk_bytes, z_bytes, zs_bytes)
    if not _route("msm_verify_kernel_cached", *args):
        return msm_verify_kernel_cached_plain(*args)
    name = "msm_verify_kernel_cached"
    n = r_enc.shape[0]
    g = _streams(n)
    _check_rows(name, n, 32, r_enc, zk_bytes)
    _check_rows(name, n, 16, z_bytes)
    _check_rows(name, 1, 32, zs_bytes)
    _check_cache_args(name, n, SPLITS[1:], tables, oks, slots)
    splits = tables.shape[1]
    wn = max(32, 64 // splits)
    dev = r_enc.device
    tabs = torch.empty((16 * 4 * 10, n), dtype=torch.int32, device=dev)
    row_oks = torch.empty(n, dtype=torch.uint8, device=dev)
    wsum = torch.empty((4 * 10, wn * g), dtype=torch.int32, device=dev)
    ws = torch.empty((4 * 10, wn), dtype=torch.int32, device=dev)
    out = torch.empty((), dtype=torch.bool, device=dev)
    rc = _build.load("msm_cached").tm_msm_verify_cached(
        tables.data_ptr(), oks.data_ptr(), slots.data_ptr(), r_enc.data_ptr(),
        zk_bytes.data_ptr(), z_bytes.data_ptr(), zs_bytes.data_ptr(),
        device_table("fixed", dev).data_ptr(), tabs.data_ptr(), row_oks.data_ptr(),
        wsum.data_ptr(), ws.data_ptr(), out.data_ptr(), n, g, tables.shape[0], splits,
        _build.stream_of(r_enc),
    )
    _build.check(rc, name)
    msm_verify_kernel_cached.launches += 1
    return out


msm_verify_kernel_cached.launches = 0


def msm_verify_sr_kernel_plain(a_enc, r_enc, zk_bytes, z_bytes, zs_bytes):
    """Plain version of the sr25519 RLC check, inputs as
    msm_verify_kernel_plain's with ristretto encodings; zero padding rows
    are the ristretto identity and carry zero scalars. Returns a () bool:
    every encoding decodes and the sum's ristretto encoding is zero."""
    a, r = _limb_major(a_enc), _limb_major(r_enc)
    n = a.shape[1]
    pts, oks = R.decode(torch.cat([a, r], dim=1))
    neg = C.point_neg(pts)
    all_ok = torch.all(oks)
    nibs_zk = C.scalar_to_nibbles(_limb_major(zk_bytes))  # (64, B)
    nibs_z = C.scalar_to_nibbles(_limb_major(z_bytes))  # (32, B)
    total = _accumulate_windows(neg, nibs_zk, nibs_z, n)
    sb = C.fixed_base_mul(_limb_major(zs_bytes))
    total = C.point_add(total, sb, out_t=True)  # the encoder reads T
    return all_ok & torch.all(R.encode(total) == 0)


def msm_verify_sr_kernel(a_enc, r_enc, zk_bytes, z_bytes, zs_bytes):
    """sr25519 RLC check: csrc/msm_sr.cu on CUDA tensors (four launches
    from one entry point, counted once), the plain version on CPU tensors."""
    args = (a_enc, r_enc, zk_bytes, z_bytes, zs_bytes)
    if not _route("msm_verify_sr_kernel", *args):
        return msm_verify_sr_kernel_plain(*args)
    out = _launch_msm("msm_verify_sr_kernel", "msm_sr", "tm_msm_verify_sr", *args)
    msm_verify_sr_kernel.launches += 1
    return out


msm_verify_sr_kernel.launches = 0


def _rlc_scalars_py(s_rows, k_rows, n, z_raw):
    """Randomizer math in Python (the TM_TPU_NATIVE=0 path and the native
    path's oracle): per-signature zk = z*h mod L rows, the z rows, and
    zs = sum z*s mod L."""
    zk = np.zeros((len(k_rows), 32), np.uint8)
    z_out = np.zeros((len(k_rows), 16), np.uint8)
    zs = 0
    from_bytes = int.from_bytes
    for i in range(n):
        z = from_bytes(z_raw[16 * i:16 * i + 16], "little")
        h = from_bytes(k_rows[i].tobytes(), "little")
        s = from_bytes(s_rows[i].tobytes(), "little")
        zk[i] = np.frombuffer(((z * h) % L).to_bytes(32, "little"), np.uint8)
        z_out[i] = np.frombuffer(z.to_bytes(16, "little"), np.uint8)
        zs = (zs + z * s) % L
    zs_row = np.frombuffer(zs.to_bytes(32, "little"), np.uint8).reshape(1, 32)
    return zk, z_out, zs_row


def _rlc_scalars(s_rows, k_rows, n, z_raw):
    """The randomizer math, in C (native/prep.c tm_rlc_scalars) unless
    TM_TPU_NATIVE=0; the same bytes as _rlc_scalars_py. s_rows and k_rows
    are (B, 32) uint8 rows of which the first n are real jobs."""
    if native.native_disabled():
        return _rlc_scalars_py(s_rows, k_rows, n, z_raw)
    import ctypes

    lib = native.load_prep()
    zk = np.zeros((len(k_rows), 32), np.uint8)
    zs_row = np.zeros((1, 32), np.uint8)
    s_c = np.ascontiguousarray(s_rows[:n])
    k_c = np.ascontiguousarray(k_rows[:n])
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.tm_rlc_scalars(bytes(z_raw[:16 * n]), s_c.ctypes.data_as(u8p), k_c.ctypes.data_as(u8p), n,
                       zk.ctypes.data_as(u8p), zs_row.ctypes.data_as(u8p))
    z_out = np.zeros((len(k_rows), 16), np.uint8)
    z_out[:n] = np.frombuffer(z_raw[:16 * n], np.uint8).reshape(n, 16)
    return zk, z_out, zs_row


def _ensure_z_raw(n: int, z_raw: bytes | None) -> bytes:
    """Sample (or validate) the per-batch randomizers. They come from
    os.urandom: their unpredictability is the soundness argument. A zero
    z_i would null that signature's contribution, so it is redrawn; a
    short caller buffer would leave tail rows out of the sum."""
    if z_raw is None:
        z_raw = os.urandom(16 * n)
        while any(z_raw[16 * i:16 * i + 16] == b"\x00" * 16 for i in range(n)):  # pragma: no cover
            z_raw = os.urandom(16 * n)
    elif len(z_raw) != 16 * n:
        raise ValueError(f"z_raw must be {16 * n} bytes, got {len(z_raw)}")
    return z_raw


def _dispatch_rlc(prepare, kernel, pubkeys, msgs, sigs, z_raw, device):
    """The RLC dispatch of either signature plane (its host prep, its
    kernel): prep, precheck refusal (None: the caller goes straight to the
    bitmap plane), randomizer math, padding with zero scalars, launch."""
    n = len(sigs)
    if n == 0:
        return None
    dev = resolve_device(device)
    fid = _devobs.next_flow() if _devobs.enabled() else 0
    with _trace.span("ops.msm_dispatch", "ops", kernel="rlc", rows=n, flow=fid) as sp:
        a_enc, r_enc, s_rows, k_rows, precheck = prepare(pubkeys, msgs, sigs)
        if not precheck.all():
            sp.annotate(refused="precheck")
            return None
        z_raw = _ensure_z_raw(n, z_raw)
        handle = _launch_rlc(kernel, a_enc, r_enc, *_rlc_scalars(s_rows, k_rows, n, z_raw), n,
                             dev, fid)
    _engine_metrics().kernel_launches.add(1, "rlc")
    return handle


def _launch_rlc(kernel, a_enc, r_enc, zk, z_out, zs_row, n, dev, fid):
    """Pad the RLC rows with zero scalars, copy them to the device, launch."""
    rows = pad_pow2_rows([a_enc, r_enc, zk, z_out], n)
    dev_rows = _h2d(rows + [zs_row], dev, fid)
    with _devobs.attribution(fn="rlc", rows=_pad_pow2(n), flow=fid):
        return kernel(*dev_rows)


def verify_batch_rlc_async(pubkeys, msgs, sigs, z_raw: bytes | None = None, device=None):
    """Dispatch the ed25519 RLC check without blocking. Returns a handle for
    collect_rlc, or None on precheck refusal."""
    return _dispatch_rlc(prepare_batch, msm_verify_kernel, pubkeys, msgs, sigs, z_raw, device)


def verify_batch_rlc_cached_async(pubkeys, msgs, sigs, z_raw: bytes | None = None, device=None):
    """The ed25519 RLC check through the device's pubkey cache (same
    contract as verify_batch_rlc_async): cache hits skip A's decode and
    table, and A rides the split power tables. Three refusals, as the
    reference's: a batch that fails the precheck returns None before the
    cache is touched (its keys are never inserted); a batch with more
    distinct keys than the cache holds takes the uncached kernel, reusing
    the prep and scalars already made; a single-table cache (S = 1) takes
    verify_batch_rlc_async."""
    n = len(sigs)
    if n == 0:
        return None
    cache = pubkey_cache(device)
    if cache.tables.ndim != 5:
        return verify_batch_rlc_async(pubkeys, msgs, sigs, z_raw, device)
    fid = _devobs.next_flow() if _devobs.enabled() else 0
    with _trace.span("ops.msm_dispatch", "ops", kernel="rlc_cached", rows=n, flow=fid) as sp:
        a_enc, r_enc, s_rows, k_rows, precheck = prepare_batch(pubkeys, msgs, sigs)
        if not precheck.all():
            sp.annotate(refused="precheck")
            return None
        slots, tables, oks = cache.ensure_snapshot(pubkeys)  # all 32 bytes: the precheck passed
        z_raw = _ensure_z_raw(n, z_raw)
        zk, z_out, zs_row = _rlc_scalars(s_rows, k_rows, n, z_raw)
        if slots is None:
            sp.annotate(cache="overflow")
            handle = _launch_rlc(msm_verify_kernel, a_enc, r_enc, zk, z_out, zs_row, n,
                                 cache.device, fid)
            _engine_metrics().kernel_launches.add(1, "rlc")
            return handle
        r_enc, zk, z_out = pad_pow2_rows([r_enc, zk, z_out], n)
        # padded rows carry zero scalars; their slot copies the edge slot, a
        # key of this batch, so a stale entry never sinks the decode test
        slots = np.pad(slots, (0, len(r_enc) - n), mode="edge")
        dev_rows = _h2d([slots, r_enc, zk, z_out, zs_row], cache.device, fid)
        with _devobs.attribution(fn="rlc_cached", rows=_pad_pow2(n), flow=fid):
            handle = msm_verify_kernel_cached(tables, oks, *dev_rows)
    _engine_metrics().kernel_launches.add(1, "rlc_cached")
    return handle


def verify_batch_rlc_sr_async(pubkeys, msgs, sigs, z_raw: bytes | None = None, device=None):
    """Dispatch the sr25519 RLC check without blocking (same contract as
    verify_batch_rlc_async; ops/verify_sr.py is the localizing plane)."""
    return _dispatch_rlc(prepare_batch_sr, msm_verify_sr_kernel, pubkeys, msgs, sigs, z_raw, device)


def collect_rlc(dispatched) -> bool:
    """Block on a verify_batch_rlc_async handle -> all-valid bool."""
    if dispatched is None:
        return False
    with _devobs.transfer_span("d2h", dispatched.numel() * dispatched.element_size()):
        return bool(dispatched.item())

