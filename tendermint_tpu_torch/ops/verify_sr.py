"""Batched sr25519 (schnorrkel) verification: the per-signature bitmap plane.

Every signature's equation

    R == encode([s]B - [k]A),  k = Merlin challenge of (pk, msg, R) mod L

is evaluated data-parallel across the batch with exactly the acceptance of
the JAX package (tendermint_tpu/ops/verify_sr.py) and of the host verifier
(crypto/sr25519.py). Ristretto255 has prime order: there is no cofactor,
and equality is equality of encodings. The plain versions encode the
ladder's result and compare it byte for byte with the wire R, as the
reference does; the uncached and split-hit kernels decode R instead and
decide by RFC 9496's equality, the same function (csrc/verify_sr_cached.cu
gives the proof).

Five kernels live here, each a hand-written CUDA kernel for Hopper
(csrc/*.cu) beside its plain PyTorch version:

  verify_sr_kernel               csrc/verify_sr.cu                uncached bitmap
  build_sr_tables_split          csrc/sr_tables.cu                split cache fill
  verify_sr_kernel_cached_split  csrc/verify_sr_cached.cu         split cache hit
  build_sr_tables                csrc/sr_tables_single.cu         single-table fill
  verify_sr_kernel_cached        csrc/verify_sr_cached_single.cu  single-table hit

The sr25519 pubkey cache has the ed25519 cache's geometries
(TM_TPU_PK_SPLIT, ops/verify.py), in a cache of its own.

Wrappers route as the ed25519 plane's do (ops/verify.py): the kernel for
CUDA tensors, the plain version for CPU tensors, a raise otherwise, and a
`.launches` count of kernel launches.

Split of labor: the host checks the marker bit, clears it, checks s < L,
and computes the Merlin challenges (crypto/sr25519.challenges_batch); the
device decodes A, runs the ladder and decides.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import devobs as _devobs
from ..crypto.sr25519 import SIG_SIZE, challenges_batch
from . import _build
from . import curve as C
from . import ristretto as R
from .verify import (  # collect: the bitmap planes share it
    L, PK_SPLITS, SPLITS, _cached_a_tables, _check_rows, _check_splits, _h2d, _launch_fill,
    _launch_hit, _limb_major, _pad_pow2, _power_tables_plain, _route, cache_slots, collect,
    device_table, dispatch_cached, pad_pow2_rows, plane_cache, resolve_device,
)


def _encoding_equal(q, r_enc_limbs):
    """(B,) bool: the ristretto encoding of q equals the wire bytes."""
    return torch.all(R.encode(q) == r_enc_limbs, dim=0)


# -- kernel 9: uncached bitmap ----------------------------------------------


def verify_sr_kernel_plain(a_enc, r_enc, s_bytes, k_bytes):
    """Plain version: (B, 32) uint8 rows -> (B,) bool. a_enc/r_enc are
    ristretto encodings; s has the marker bit cleared and is prechecked
    < L on the host; k is the Merlin challenge mod L."""
    a, r = _limb_major(a_enc), _limb_major(r_enc)
    s, k = _limb_major(s_bytes), _limb_major(k_bytes)
    a_pt, a_ok = R.decode(a)
    q = C.double_scalar_mul_base(s, k, C.point_neg(a_pt))  # [s]B - [k]A, with T
    return a_ok & _encoding_equal(q, r)


def verify_sr_kernel(a_enc, r_enc, s_bytes, k_bytes):
    """Uncached sr25519 bitmap: csrc/verify_sr.cu on CUDA tensors (two
    launches from one entry point, counted once: the decode step, then the
    four-lane ladder), the plain version on CPU tensors."""
    if not _route("verify_sr_kernel", a_enc, r_enc, s_bytes, k_bytes):
        return verify_sr_kernel_plain(a_enc, r_enc, s_bytes, k_bytes)
    n = a_enc.shape[0]
    _check_rows("verify_sr_kernel", n, 32, a_enc, r_enc, s_bytes, k_bytes)
    dev = a_enc.device
    out = torch.empty(n, dtype=torch.bool, device=dev)
    # 17 points of 40 int32 a row (-A's 16 multiples, R), then 2 n decode bytes
    scratch = torch.empty(17 * 40 * n + (n + 1) // 2, dtype=torch.int32, device=dev)
    lib = _build.load("verify_sr")
    rc = lib.tm_verify_sr(
        a_enc.data_ptr(), r_enc.data_ptr(), s_bytes.data_ptr(), k_bytes.data_ptr(),
        device_table("base", dev).data_ptr(), scratch.data_ptr(), out.data_ptr(), n,
        _build.stream_of(a_enc),
    )
    _build.check(rc, "verify_sr_kernel")
    verify_sr_kernel.launches += 1
    return out


verify_sr_kernel.launches = 0


# -- kernel 12: sr pubkey-cache fill ----------------------------------------


def build_sr_tables_split_plain(a_enc, splits: int = PK_SPLITS):
    """Plain version: (B, 32) uint8 ristretto pubkeys -> ((B, S, 16, 4, 32)
    int16 power tables of -A, (B,) bool decode bits). Limbs are fe_mul
    outputs (|limb| < 2^9), exactly the JAX program's."""
    a_pt, ok = R.decode(_limb_major(a_enc))
    return _power_tables_plain(C.point_neg(a_pt), splits), ok


def build_sr_tables_split(a_enc, splits: int = PK_SPLITS):
    """sr25519 split cache fill at S = splits (2, 4 or 8): csrc/sr_tables.cu
    on CUDA tensors (coordinates written canonical), the plain version on
    CPU tensors."""
    _check_splits("build_sr_tables_split", splits)
    if not _route("build_sr_tables_split", a_enc):
        return build_sr_tables_split_plain(a_enc, splits)
    out = _launch_fill("build_sr_tables_split", "sr_tables", "tm_build_sr_tables", a_enc, splits)
    build_sr_tables_split.launches += 1
    return out


build_sr_tables_split.launches = 0


# -- kernel 13: cache-hit bitmap --------------------------------------------


def verify_sr_kernel_cached_split_plain(tables, oks, slots, r_enc, s_bytes, k_bytes):
    """Plain version: sr cache tables (C, S, 16, 4, 32) int16, oks (C,)
    bool, slots (B,) int32, rows (B, 32) uint8 -> (B,) bool; S is the
    tables'. The split ladder's result carries no T, and the encoder reads
    it: adding the identity regenerates a consistent T in one addition, as
    the JAX program does."""
    r = _limb_major(r_enc)
    s, k = _limb_major(s_bytes), _limb_major(k_bytes)
    q = C.double_scalar_mul_split(s, k, _cached_a_tables(tables, slots), splits=tables.shape[1])
    q = C.point_add(q, C.identity_point(q.shape[2:], q.device), out_t=True)
    return oks[cache_slots(slots, len(oks))] & _encoding_equal(q, r)


def verify_sr_kernel_cached_split(tables, oks, slots, r_enc, s_bytes, k_bytes):
    """sr25519 split cache-hit bitmap: csrc/verify_sr_cached.cu on CUDA
    tensors, the plain version on CPU tensors."""
    args = (tables, oks, slots, r_enc, s_bytes, k_bytes)
    if not _route("verify_sr_kernel_cached_split", *args):
        return verify_sr_kernel_cached_split_plain(*args)
    out = _launch_hit("verify_sr_kernel_cached_split", "verify_sr_cached",
                      "tm_verify_sr_cached_split", "fixed", SPLITS[1:], args)
    verify_sr_kernel_cached_split.launches += 1
    return out


verify_sr_kernel_cached_split.launches = 0


# -- kernel 10: single-table sr pubkey-cache fill ---------------------------


def build_sr_tables_plain(a_enc):
    """Plain version: (B, 32) uint8 ristretto pubkeys -> ((B, 16, 4, 32)
    int16 table of -A, (B,) bool decode bits)."""
    a_pt, ok = R.decode(_limb_major(a_enc))
    return _power_tables_plain(C.point_neg(a_pt), 1), ok


def build_sr_tables(a_enc):
    """sr25519 single-table cache fill: csrc/sr_tables_single.cu on CUDA
    tensors (coordinates written canonical), the plain version on CPU
    tensors."""
    if not _route("build_sr_tables", a_enc):
        return build_sr_tables_plain(a_enc)
    out = _launch_fill("build_sr_tables", "sr_tables_single", "tm_build_sr_tables_single", a_enc)
    build_sr_tables.launches += 1
    return out


build_sr_tables.launches = 0


# -- kernel 11: single-table cache-hit bitmap -------------------------------


def verify_sr_kernel_cached_plain(tables, oks, slots, r_enc, s_bytes, k_bytes):
    """Plain version: sr cache tables (C, 16, 4, 32) int16, oks (C,) bool,
    slots (B,) int32, rows (B, 32) uint8 -> (B,) bool: the 252-doubling
    ladder on the cached table, its last addition with T for the encoder."""
    r = _limb_major(r_enc)
    s, k = _limb_major(s_bytes), _limb_major(k_bytes)
    q = C.double_scalar_mul_base(s, k, a_table=_cached_a_tables(tables, slots))
    return oks[cache_slots(slots, len(oks))] & _encoding_equal(q, r)


def verify_sr_kernel_cached(tables, oks, slots, r_enc, s_bytes, k_bytes):
    """sr25519 single-table cache-hit bitmap: csrc/verify_sr_cached_single.cu
    on CUDA tensors, the plain version on CPU tensors."""
    args = (tables, oks, slots, r_enc, s_bytes, k_bytes)
    if not _route("verify_sr_kernel_cached", *args):
        return verify_sr_kernel_cached_plain(*args)
    out = _launch_hit("verify_sr_kernel_cached", "verify_sr_cached_single", "tm_verify_sr_cached",
                      "base", (1,), args)
    verify_sr_kernel_cached.launches += 1
    return out


verify_sr_kernel_cached.launches = 0


# -- host shaping and dispatch ----------------------------------------------


def sr_pubkey_cache(device=None):
    """The process-wide sr25519 pubkey cache of a device: its own cache,
    apart from the ed25519 plane's (the reference's plane "sr25519_pk")."""
    return plane_cache("sr25519", device)


def prepare_batch(pubkeys, msgs, sigs):
    """Host prep: (a_enc, r_enc, s_bytes, k_bytes, precheck) as numpy uint8
    (B, 32) rows and a (B,) bool precheck. A row fails the precheck (its
    rows stay zero) for a malformed length, a missing marker bit, or s >= L
    once the marker bit is cleared. Challenges of the rows that pass run
    through the vectorized Merlin transcript."""
    n = len(sigs)
    raw = np.zeros((4, n, 32), np.uint8)
    precheck = np.zeros((n,), bool)
    for i in range(n):
        pk, sig = pubkeys[i], sigs[i]
        if len(pk) != 32 or len(sig) != SIG_SIZE or not sig[63] & 0x80:
            continue
        s_buf = bytearray(sig[32:64])
        s_buf[31] &= 0x7F
        if int.from_bytes(bytes(s_buf), "little") >= L:
            continue
        raw[0, i] = np.frombuffer(pk, np.uint8)
        raw[1, i] = np.frombuffer(sig, np.uint8, count=32)
        raw[2, i] = np.frombuffer(bytes(s_buf), np.uint8)
        precheck[i] = True
    valid = np.flatnonzero(precheck)
    if len(valid):
        ks = challenges_batch(
            [pubkeys[i] for i in valid],
            [msgs[i] for i in valid],
            [sigs[i][:32] for i in valid],
        )
        for i, k in zip(valid, ks):
            raw[3, i] = np.frombuffer(k.to_bytes(32, "little"), np.uint8)
    return raw[0], raw[1], raw[2], raw[3], precheck


def verify_batch_async(pubkeys, msgs, sigs, device=None):
    """Dispatch one batch without blocking: host prep, copy to the device,
    kernel launch. Returns (device_bitmap, precheck, n, flow) for
    `collect`. Padding rows are zero encodings, the ristretto identity:
    they decode and are trimmed by `collect`. As in the reference, this
    dispatch writes no span and no kernel_launches; its copies and
    collect report to devobs."""
    n = len(sigs)
    if n == 0:
        return None, np.zeros((0,), bool), 0, 0
    dev = resolve_device(device)
    fid = _devobs.next_flow() if _devobs.enabled() else 0
    a_enc, r_enc, s_bytes, k_bytes, precheck = prepare_batch(pubkeys, msgs, sigs)
    rows = pad_pow2_rows([a_enc, r_enc, s_bytes, k_bytes], n)
    dev_rows = _h2d(rows, dev, fid)
    with _devobs.attribution(fn="sr25519_bitmap", rows=_pad_pow2(n), flow=fid):
        ok_dev = verify_sr_kernel(*dev_rows)
    return ok_dev, precheck, n, fid


def verify_batch_cached_async(pubkeys, msgs, sigs, device=None):
    """verify_batch_async through the device's sr25519 pubkey cache, the
    kernel picked from the cache's entry shape; more distinct keys than the
    cache holds take the uncached kernel."""
    cache = sr_pubkey_cache(device)
    kern = verify_sr_kernel_cached_split if cache.tables.ndim == 5 else verify_sr_kernel_cached
    return dispatch_cached(cache, prepare_batch, kern, verify_batch_async, pubkeys, msgs, sigs,
                           fn_label="sr25519_bitmap_cached")


def verify_batch(pubkeys, msgs, sigs, device=None) -> np.ndarray:
    """End-to-end batched sr25519 verification -> (n,) bool numpy bitmap."""
    return collect(verify_batch_async(pubkeys, msgs, sigs, device))
