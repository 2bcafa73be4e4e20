#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (tendermint_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--kernels-only]

Phases, each fatal on failure:
  1. build every CUDA kernel from csrc/ (one nvcc per source, in parallel)
     and print the card's name and power limit;
  2. hold each kernel against its plain PyTorch version on the card at 64
     rows with tampered rows and the ZIP-215 edge encodings (exact
     equality: the arithmetic is integer), and the bitmap against the
     pure-Python oracle;
  3. the main path: verify_commit on commits of 150, 1,000 and 10,000
     validators (valid, and with one tampered signature that must be
     reported at its index), every kernel's launch counter set to 0 just
     before each call and read just after, and held to the launches that
     call must make;
  4. each kernel against its plain version again, on the rows phase 3's
     commits give it (16384 rows for the uncached bitmap, 1024 for the
     cache fill and the cache hit through the main path's own cache, both
     for the RLC, in both verdicts with one z_raw), exact equality and the
     tampered row alone invalid; the same calls timed with CUDA events
     beside the plain version, the bound and the launches, and the
     end-to-end verify_commit wall times.

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. Exits nonzero, printing no result, when
there is no CUDA device or the package is missing.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# Published H100 SXM memory rate (NVIDIA data sheet).
HBM_BYTES_PER_S = 3.35e12
# 32-bit integer multiply lanes per SM per clock on Hopper.
INT32_LANES_PER_SM = 64
# Least 32-bit multiply instructions per 255-bit modular product: the 8x8
# partial products of a schoolbook multiply over 32-bit limbs (36 for a
# square), counting a 32x32->64-bit wide multiply as one instruction and
# nothing for the reduction or the additions.
MULS_PER_FE_MUL = 64
MULS_PER_FE_SQ = 36

# Field multiplications (M) and squarings (S) of each formula, counted from
# csrc/ge25519.cuh: decode 256S+19M, addition 8M (+1 for T), doubling
# 4S+3M (+1 for T), cofactored equality tail 24S+22M.
DECODE = (256, 19)

def _ops(squares: int, mults: int) -> int:
    return squares * MULS_PER_FE_SQ + mults * MULS_PER_FE_MUL


def ops_verify(n: int) -> int:
    # 2 decodes, 14 table additions, top window add, 63 windows
    # (4 doublings + 2 additions), tail
    return n * _ops(2 * DECODE[0] + 63 * 16 + 24,
                    2 * DECODE[1] + 14 * 9 + 8 + 63 * (13 + 9 + 8) + 22)


def ops_pk_tables(n: int) -> int:
    # decode, 3 power chains of 64 doublings, 4 tables of 14 additions
    return n * _ops(DECODE[0] + 3 * 64 * 4, DECODE[1] + 3 * (64 * 3 + 1) + 4 * 14 * 9)


def ops_verify_cached(n: int) -> int:
    # decode R, 16 steps of 4 doublings and 8 additions (7 with T), tail
    return n * _ops(DECODE[0] + 16 * 16 + 24, DECODE[1] + 16 * (13 + 8 * 8 + 7) + 22)


def ops_msm(n: int, g: int) -> int:
    per_row = _ops(2 * DECODE[0], 2 * DECODE[1] + 2 * 14 * 9 + 96 * 9)
    horner = _ops(63 * 16, 63 * (13 + 9))
    fixed = _ops(12, (g - 1) * 9 + 64 * 9 + 8 + 9)
    return n * per_row + g * horner + fixed


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def log(msg: str) -> None:
    print(msg, flush=True)


# -- keys and signatures (set-up, not timed) ---------------------------------


def _sign_worker(job):
    seed, msgs = job
    try:
        from cryptography.hazmat.primitives import serialization
        from cryptography.hazmat.primitives.asymmetric.ed25519 import Ed25519PrivateKey

        key = Ed25519PrivateKey.from_private_bytes(seed)
        pub = key.public_key().public_bytes(serialization.Encoding.Raw, serialization.PublicFormat.Raw)
        return pub, [key.sign(m) for m in msgs]
    except ImportError:
        from tendermint_tpu_torch.crypto import ed25519_ref as ref

        priv = ref.gen_privkey(seed)
        return priv[32:], [ref.sign(priv, m) for m in msgs]


def make_keys(pool, seeds):
    return [pub for pub, _ in pool.map(_sign_worker, [(s, []) for s in seeds], chunksize=64)]


def sign_all(pool, seeds, msg_lists):
    return [sigs for _, sigs in pool.map(_sign_worker, list(zip(seeds, msg_lists)), chunksize=64)]


def build_commit(pool, seeds, pubs, rng, n, chain_id, height):
    """A commit of n validators of equal power, every one voting for the
    block, signed over the canonical vote sign bytes."""
    from tendermint_tpu_torch.crypto.ed25519 import Ed25519PubKey
    from tendermint_tpu_torch.types.block import BlockID, Commit, CommitSig, PartSetHeader
    from tendermint_tpu_torch.types.validator_set import Validator, ValidatorSet
    from tendermint_tpu_torch.utils.tmtime import Time

    vals = ValidatorSet.new([Validator.new(Ed25519PubKey(pubs[i]), 10) for i in range(n)])
    seed_of = {Ed25519PubKey(pubs[i]).address(): seeds[i] for i in range(n)}
    block_id = BlockID(rng.bytes(32), PartSetHeader(1, rng.bytes(32)))
    commit = Commit(height=height, round=0, block_id=block_id, signatures=[
        CommitSig.new_commit(v.address, Time(1_700_000_000 + i, 1000 * i + 7), b"")
        for i, v in enumerate(vals.validators)
    ])
    msgs = [commit.vote_sign_bytes(chain_id, i) for i in range(n)]
    order = [seed_of[v.address] for v in vals.validators]
    for cs, sigs in zip(commit.signatures, sign_all(pool, order, [[m] for m in msgs])):
        cs.signature = sigs[0]
    return vals, block_id, commit


def tamper(sig: bytes) -> bytes:
    return sig[:40] + bytes([sig[40] ^ 0x01]) + sig[41:]


# -- phase 2: kernels against their plain versions ---------------------------


def edge_batch(rng, n=64):
    """n rows: honest signatures, tampered ones, and the ZIP-215 edges."""
    from tendermint_tpu_torch.crypto import ed25519_ref as ref

    pks, msgs, sigs = [], [], []
    for i in range(n - 6):
        priv = ref.gen_privkey(rng.bytes(32))
        msg = b"chip-smoke-%d" % i + rng.bytes(16)
        sig = ref.sign(priv, msg)
        if i % 9 == 4:
            sig = tamper(sig)
        pks.append(priv[32:])
        msgs.append(msg)
        sigs.append(sig)
    so = ref.small_order_points()
    ident = ref.compress(ref.IDENTITY)
    # small-order key, identity R, s = 0: valid under the cofactored equation
    pks.append(so[1]); msgs.append(b"anything"); sigs.append(ident + b"\x00" * 32)
    # s + L: fails the host precheck
    s = int.from_bytes(sigs[0][32:], "little")
    pks.append(pks[0]); msgs.append(msgs[0]); sigs.append(sigs[0][:32] + (s + ref.L).to_bytes(32, "little"))
    # a non-point key
    y = 2
    while ref.decompress(y.to_bytes(32, "little")) is not None:
        y += 1
    pks.append(y.to_bytes(32, "little")); msgs.append(b"x"); sigs.append(sigs[0])
    # y >= p (y = p + 1 decodes as y = 1), and x = 0 with the sign bit set
    pks.append((ref.P + 1).to_bytes(32, "little")); msgs.append(b"y>=p"); sigs.append(ident + b"\x00" * 32)
    neg_zero = bytearray(ident); neg_zero[31] |= 0x80
    pks.append(bytes(neg_zero)); msgs.append(b"-0"); sigs.append(bytes(neg_zero) + b"\x00" * 32)
    # a small-order R on an honest key
    priv = ref.gen_privkey(rng.bytes(32))
    pks.append(priv[32:]); msgs.append(b"so-R"); sigs.append(so[2] + ref.sign(priv, b"so-R")[32:])
    return pks, msgs, sigs


def check_kernels(rng, dev):
    import numpy as np
    import torch

    from tendermint_tpu_torch.crypto import ed25519_ref as ref
    from tendermint_tpu_torch.ops import field as F
    from tendermint_tpu_torch.ops import msm as M
    from tendermint_tpu_torch.ops import verify as V

    def cuda(*arrays):
        return [torch.from_numpy(np.require(a, requirements=["C", "W"])).to(dev) for a in arrays]

    errs = {}
    pks, msgs, sigs = edge_batch(rng)
    n = len(sigs)
    a, r, s, k, pre = V.prepare_batch(pks, msgs, sigs)
    a_d, r_d, s_d, k_d = cuda(a, r, s, k)

    got = V.verify_kernel(a_d, r_d, s_d, k_d)
    want = V.verify_kernel_plain(a_d, r_d, s_d, k_d)
    torch.cuda.synchronize()
    oracle = np.array([ref.verify(p, m, g) for p, m, g in zip(pks, msgs, sigs)])
    bitmap = got.cpu().numpy() & pre
    if not torch.equal(got, want) or not (bitmap == oracle).all():
        raise AssertionError(f"verify_kernel: kernel {got.tolist()} plain {want.tolist()} "
                             f"oracle {oracle.tolist()}")
    errs["verify_kernel"] = 0
    log(f"phase 2: verify_kernel == plain == oracle on {n} rows ({int(oracle.sum())} valid)")

    tabs, oks = V.build_pk_tables_split(a_d)
    ptabs, poks = V.build_pk_tables_split_plain(a_d)
    torch.cuda.synchronize()

    def canonical(t):  # limb axis first for fe_canonical, and back
        return F.fe_canonical(t.to(torch.int32).permute(4, 0, 1, 2, 3)).permute(1, 2, 3, 4, 0)

    err = int((canonical(tabs) - canonical(ptabs)).abs().max())
    if err or not torch.equal(oks, poks):
        raise AssertionError(f"build_pk_tables_split: max |kernel - plain| after fe_canonical = {err}")
    if tabs.is_cuda and not torch.equal(tabs.to(torch.int32), canonical(tabs)):
        raise AssertionError("build_pk_tables_split: the kernel wrote non-canonical coordinates")
    errs["build_pk_tables_split"] = err
    log(f"phase 2: build_pk_tables_split == canonical(plain) on {n} keys, "
        f"{tabs.numel() // 32} coordinates")

    perm = torch.from_numpy(rng.permutation(n).astype(np.int64)).to(dev)
    cache_t = torch.empty_like(tabs).index_copy_(0, perm, tabs)
    cache_o = torch.empty_like(oks).index_copy_(0, perm, oks)
    slots = perm.to(torch.int32)
    got = V.verify_kernel_cached_split(cache_t, cache_o, slots, r_d, s_d, k_d)
    want = V.verify_kernel_cached_split_plain(cache_t, cache_o, slots, r_d, s_d, k_d)
    # the plain fill's signed limbs through the kernel (the carried-across cache)
    plain_cache = torch.empty_like(ptabs).index_copy_(0, perm, ptabs)
    got_signed = V.verify_kernel_cached_split(plain_cache, cache_o, slots, r_d, s_d, k_d)
    torch.cuda.synchronize()
    if not (torch.equal(got, want) and torch.equal(got, got_signed)) or not (
            (got.cpu().numpy() & pre) == oracle).all():
        raise AssertionError(f"verify_kernel_cached_split: kernel {got.tolist()} plain {want.tolist()}")
    errs["verify_kernel_cached_split"] = 0
    log(f"phase 2: verify_kernel_cached_split == plain == oracle on {n} rows (both table forms)")

    keep = [i for i in range(n) if oracle[i]]
    bad = next(i for i in range(n) if pre[i] and not oracle[i])  # a tampered row
    for label, idx in (("valid", keep), ("tampered", keep[:-1] + [bad])):
        bp, bm, bs = [pks[i] for i in idx], [msgs[i] for i in idx], [sigs[i] for i in idx]
        a2, r2, s2, k2, pre2 = V.prepare_batch(bp, bm, bs)
        z_raw = rng.bytes(16 * len(idx))
        zk, z, zs = M._rlc_scalars_py(s2, k2, len(idx), z_raw)
        rows = cuda(*V.pad_pow2_rows([a2, r2, zk, z], len(idx)), zs)
        got = M.msm_verify_kernel(*rows)
        want = M.msm_verify_kernel_plain(*rows)
        torch.cuda.synchronize()
        expect = label == "valid"
        if bool(got) != bool(want) or bool(got) != expect:
            raise AssertionError(f"msm_verify_kernel ({label}): kernel {bool(got)} plain {bool(want)}")
        log(f"phase 2: msm_verify_kernel == plain == {expect} on a {label} batch of {len(idx)} rows")
    errs["msm_verify_kernel"] = 0
    return errs


# -- phase 3: the main path ---------------------------------------------------


def kernel_wrappers():
    from tendermint_tpu_torch.ops import msm as M
    from tendermint_tpu_torch.ops import verify as V

    return (V.verify_kernel, V.build_pk_tables_split, V.verify_kernel_cached_split,
            M.msm_verify_kernel)


def reset_counts():
    for fn in kernel_wrappers():
        fn.launches = 0


def read_counts():
    return {fn.__name__: fn.launches for fn in kernel_wrappers()}


def timed(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def expect_wrong_signature(fn, idx):
    try:
        fn()
    except ValueError as e:
        if not str(e).startswith(f"wrong signature (#{idx}):"):
            raise AssertionError(f"tampered commit raised the wrong error: {e}") from e
        return str(e)
    raise AssertionError(f"tampered signature #{idx} was accepted")


# The launches each main-path call must make, in the order of the calls. The
# pubkey cache starts empty, and the 150 validators' keys are among the
# 1,000's: a valid commit of 256 or more signatures runs the RLC alone; a
# tampered one then runs the bitmap plane, through the cache (fill, then
# hit) up to 4,096 distinct keys and uncached beyond; the 150-validator
# commit goes straight to the cached bitmap, and the trusting check stops
# at 51 signatures, below the 64-signature cutover, so it runs on the host.
EXPECTED_LAUNCHES = {
    (150, "valid"): {"build_pk_tables_split": 1, "verify_kernel_cached_split": 1},
    (150, "trusting"): {},
    (1000, "valid"): {"msm_verify_kernel": 1},
    (1000, "tampered"): {"msm_verify_kernel": 1, "build_pk_tables_split": 1,
                         "verify_kernel_cached_split": 1},
    (10000, "valid"): {"msm_verify_kernel": 1},
    (10000, "tampered"): {"msm_verify_kernel": 1, "verify_kernel": 1},
}
SIZES = (150, 1000, 10000)


def main_path(pool, rng, seeds, pubs, chain_id):
    """verify_commit on each commit, with every launch counter set to 0 just
    before each call and read just after; returns the commits, the tampered
    index of each, the summed launches and the wall times."""
    from tendermint_tpu_torch.types.validation import (
        Fraction, verify_commit, verify_commit_light_trusting,
    )

    commits = {n: build_commit(pool, seeds, pubs, rng, n, chain_id, 100 + n) for n in SIZES}
    bad_index = {n: (n * 5) // 12 for n in SIZES}
    totals = dict.fromkeys(read_counts(), 0)
    runs = []

    def drive(n, kind, fn):
        reset_counts()
        out, t = timed(fn)
        got = read_counts()
        want = {name: EXPECTED_LAUNCHES[n, kind].get(name, 0) for name in got}
        if got != want:
            raise AssertionError(f"{kind} call on {n} validators launched {got}, expected {want}")
        for name, c in got.items():
            totals[name] += c
        return out, t

    for n, (vals, bid, commit) in commits.items():
        _, t = drive(n, "valid", lambda: verify_commit(chain_id, vals, bid, commit.height, commit))
        runs.append({"commit": n, "run": "verify_commit valid", "s": t, "sigs_per_s": n / t})
        if n == SIZES[0]:
            _, t = drive(n, "trusting", lambda: verify_commit_light_trusting(
                chain_id, vals, commit, Fraction(1, 3)))
            runs.append({"commit": n, "run": "verify_commit_light_trusting 1/3", "s": t})
            continue
        bad = bad_index[n]
        good = commit.signatures[bad].signature
        commit.signatures[bad].signature = tamper(good)
        msg, t = drive(n, "tampered", lambda: expect_wrong_signature(
            lambda: verify_commit(chain_id, vals, bid, commit.height, commit), bad))
        commit.signatures[bad].signature = good
        runs.append({"commit": n, "run": f"verify_commit tampered #{bad}", "s": t, "sigs_per_s": n / t,
                     "error": msg[:40]})
    for r in runs:
        log("phase 3: " + json.dumps(r))
    log(f"phase 3: launches {json.dumps(totals)}")
    idle = [k for k, v in totals.items() if v == 0]
    if idle:
        raise AssertionError(f"main path never launched {idle}")
    return commits, bad_index, totals, runs


# -- phase 4: kernels at the main path's shapes, and times --------------------


def event_ms(fn, reps: int):
    """(first output, mean ms of reps launches after two warm-up launches)."""
    import torch

    out = fn()
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end) / reps


def plain_ms(fn, warm: bool = True):
    """(output, ms) of one timed run, after one warm run unless the caller
    has just run the same shapes (the plain versions take seconds)."""
    import torch

    if warm:
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def bound_ms(ops: int, nbytes: int, int32_rate: float):
    t_ops = ops / int32_rate * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def commit_jobs(commit_entry, chain_id, bad=None):
    """The (pubkeys, messages, signatures) verify_commit hands the batch
    verifier, with signature #bad tampered when bad is given."""
    vals, _, commit = commit_entry
    sigs = [cs.signature for cs in commit.signatures]
    if bad is not None:
        sigs[bad] = tamper(sigs[bad])
    return ([v.pub_key.bytes() for v in vals.validators],
            [commit.vote_sign_bytes(chain_id, i) for i in range(len(sigs))], sigs)


def kernels_at_main_path(rng, dev, chain_id, commits, bad_index, counts, errs, int32_rate, runs):
    """Hold each kernel against its plain version on the rows phase 3's
    commits give it (exact equality), check the verdicts, and time those
    same calls."""
    import numpy as np
    import torch

    from tendermint_tpu_torch.ops import field as F
    from tendermint_tpu_torch.ops import msm as M
    from tendermint_tpu_torch.ops import verify as V

    def cuda(arrays):
        return V._to_device(arrays, dev)

    def expect_bitmap(name, out, pre, n, bad):
        ok = out[:n].cpu().numpy() & pre
        if ok[bad] or int(ok.sum()) != n - 1:
            raise AssertionError(f"{name}: bitmap on the tampered {n}-validator commit has "
                                 f"{n - int(ok.sum())} invalid rows, #{bad} valid={bool(ok[bad])}")

    records = {}

    def record(name, src, replaces, n, ms, p_ms, err, ops, nbytes):
        b_ms, b_by = bound_ms(ops, nbytes, int32_rate)
        log(f"phase 4: {name} rows={n} == plain; kernel {ms:.3f} ms, plain {p_ms:.1f} ms, "
            f"bound {b_ms:.4f} ms ({b_by}), {counts[name]} launches on the main path")
        records[name] = {  # the largest main-path shape is kept
            "name": name, "route": "cuda", "source": f"tendermint_tpu_torch/{src}",
            "replaces": replaces, "launches": counts[name], "max_abs_err": max(errs[name], err),
            "ms": ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "rows": n}

    # verify_kernel: the tampered 10,000-validator commit (16384 rows)
    n, bad = 10000, bad_index[10000]
    a, r, s, k, pre = V.prepare_batch(*commit_jobs(commits[n], chain_id, bad))
    rows = cuda(V.pad_pow2_rows([a, r, s, k], n))
    got, ms = event_ms(lambda: V.verify_kernel(*rows), 5)
    want, p_ms = plain_ms(lambda: V.verify_kernel_plain(*rows))
    if not torch.equal(got, want):
        raise AssertionError(f"verify_kernel: {int((got != want).sum())} rows differ from plain")
    expect_bitmap("verify_kernel", got, pre, n, bad)
    record("verify_kernel", "csrc/verify.cu", "tendermint_tpu/ops/verify.py:81", len(rows[0]),
           ms, p_ms, 0, ops_verify(len(rows[0])), 129 * len(rows[0]))

    # build_pk_tables_split and verify_kernel_cached_split: the tampered
    # 1,000-validator commit (1024 rows)
    n, bad = 1000, bad_index[1000]
    jobs = commit_jobs(commits[n], chain_id, bad)
    a, r, s, k, pre = V.prepare_batch(*jobs)
    a, r, s, k = cuda(V.pad_pow2_rows([a, r, s, k], n))
    m = len(a)
    (tabs, oks), ms = event_ms(lambda: V.build_pk_tables_split(a), 10)
    (ptabs, poks), p_ms = plain_ms(lambda: V.build_pk_tables_split_plain(a))

    def canonical(t):  # limb axis first for fe_canonical, and back
        return F.fe_canonical(t.to(torch.int32).permute(4, 0, 1, 2, 3)).permute(1, 2, 3, 4, 0)

    err = int((canonical(tabs) - canonical(ptabs)).abs().max())
    if err or not torch.equal(oks, poks) or not bool(oks.all()):
        raise AssertionError(f"build_pk_tables_split: max |kernel - plain| after fe_canonical = {err}, "
                             f"{int((oks != poks).sum())} decode bits differ")
    if not torch.equal(tabs.to(torch.int32), canonical(tabs)):
        raise AssertionError("build_pk_tables_split: the kernel wrote non-canonical coordinates")
    record("build_pk_tables_split", "csrc/pk_tables.cu", "tendermint_tpu/ops/verify.py:141", m,
           ms, p_ms, err, ops_pk_tables(m), m * (32 + 4 * 16 * 4 * 32 * 2 + 1))

    # the main path's own cache, which phase 3 filled with these keys: its
    # slots and tables as dispatch_cached hands them to the kernel
    slots, cache_t, cache_o = V.pubkey_cache(dev).ensure_snapshot(jobs[0])
    (slots,) = cuda([np.pad(slots, (0, m - n))])
    args = (cache_t, cache_o, slots, r, s, k)
    got, ms = event_ms(lambda: V.verify_kernel_cached_split(*args), 10)
    want, p_ms = plain_ms(lambda: V.verify_kernel_cached_split_plain(*args))
    if not torch.equal(got, want):
        raise AssertionError(f"verify_kernel_cached_split: {int((got != want).sum())} rows differ from plain")
    expect_bitmap("verify_kernel_cached_split", got, pre, n, bad)
    record("verify_kernel_cached_split", "csrc/verify_cached.cu", "tendermint_tpu/ops/verify.py:157",
           m, ms, p_ms, 0, ops_verify_cached(m), m * (4 + 96 + 1 + 1 + 4 * 16 * 4 * 32 * 2))

    # msm_verify_kernel: the 1,000- and 10,000-validator commits, valid and
    # tampered, with one z_raw for both verdicts
    for n in (1000, 10000):
        z_raw = M._ensure_z_raw(n, rng.bytes(16 * n))
        verdicts = {}
        for label, bad in (("valid", None), ("tampered", bad_index[n])):
            jobs = commit_jobs(commits[n], chain_id, bad)
            t0 = time.perf_counter()
            a, r, s_rows, k_rows, pre = V.prepare_batch(*jobs)
            t1 = time.perf_counter()
            zk, z, zs = M._rlc_scalars_py(s_rows, k_rows, n, z_raw)
            t2 = time.perf_counter()
            if n == SIZES[-1] and bad is None:
                runs.append({"commit": n, "run": "host prep: challenges, RLC scalars", "s": t2 - t0,
                             "prepare_batch_s": t1 - t0, "rlc_scalars_s": t2 - t1})
            if not pre.all():
                raise AssertionError(f"msm_verify_kernel: the {label} {n}-validator commit fails the precheck")
            rows = cuda(V.pad_pow2_rows([a, r, zk, z], n) + [zs])
            if bad is None:  # time the valid polarity; it warms the plain version's shapes
                got, ms = event_ms(lambda: M.msm_verify_kernel(*rows), 5)
                want = M.msm_verify_kernel_plain(*rows)
            else:
                got = M.msm_verify_kernel(*rows)
                want, p_ms = plain_ms(lambda: M.msm_verify_kernel_plain(*rows), warm=False)
            if bool(got) != bool(want) or bool(got) != (bad is None):
                raise AssertionError(f"msm_verify_kernel ({label}, {n} validators): "
                                     f"kernel {bool(got)} plain {bool(want)}")
            verdicts[label] = bool(got)
        m = len(rows[0])
        log(f"phase 4: msm_verify_kernel verdicts at {m} rows, same z_raw: {json.dumps(verdicts)}")
        record("msm_verify_kernel", "csrc/msm.cu", "tendermint_tpu/ops/msm.py:162", m, ms, p_ms, 0,
               ops_msm(m, M._streams(m)), m * (32 + 32 + 32 + 16) + 32 + 1)
    return list(records.values())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0, help="seed of every key, message and scalar")
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after holding the kernels against their plain versions")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        from tendermint_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: the port package is missing: {e}", file=sys.stderr)
        return 2

    import multiprocessing

    import numpy as np

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    card_line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    clock_mhz = float(nvidia_smi("clocks.max.sm"))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    int32_rate = sms * INT32_LANES_PER_SM * clock_mhz * 1e6
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; {sms} SMs at {clock_mhz:.0f} MHz max")

    # phase 1
    t0 = time.perf_counter()
    reports = _build.build_all()
    log(f"phase 1: built {sorted(reports) or 'nothing (cached)'} in {time.perf_counter() - t0:.1f} s")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                log(f"phase 1: {name}: {line.strip()}")

    rng = np.random.default_rng(args.seed)
    errs = check_kernels(rng, dev)
    if args.kernels_only:
        log(f"kernels only: stopping after phase 2 on {card_line}")
        return 0

    t0 = time.perf_counter()
    seeds = [rng.bytes(32) for _ in range(SIZES[-1])]
    chain_id = "chip-smoke"
    workers = max(1, min(8, os.cpu_count() or 1))
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(workers) as pool:
        pubs = make_keys(pool, seeds)
        log(f"phase 3: {len(pubs)} validator keys in {time.perf_counter() - t0:.1f} s")
        commits, bad_index, counts, runs = main_path(pool, rng, seeds, pubs, chain_id)
    kernels = kernels_at_main_path(rng, dev, chain_id, commits, bad_index, counts, errs,
                                   int32_rate, runs)
    for r in runs:
        log(f"phase 4: {r['run']} on {r['commit']} validators: {r['s'] * 1e3:.1f} ms"
            + (f", {r['sigs_per_s']:.0f} sigs/s" if "sigs_per_s" in r else ""))
    log(f"phase 4: card {card_line}; total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card_line)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
