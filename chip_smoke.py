#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (tendermint_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--kernels-only] [--ab-parent DIR]

Both signature planes run the same phases, each fatal on failure:
  1. build every CUDA kernel from csrc/ (one nvcc per source, in parallel),
     print each kernel function's registers and spills as ptxas reports
     them, and the card's name and power limit; build the native host prep
     (native/prep.c, with cc) and print its cc line;
  2. hold each kernel against its plain PyTorch version on the card on an
     edge batch (exact equality: the arithmetic is integer): tampered
     rows, the ZIP-215 edge encodings for ed25519 (small-order, undecodable
     and non-canonical R, R plus a point of order 8), the RFC 9496 bad
     encodings, a missing marker bit, s >= L, an honest R made
     non-canonical, negated or random, and a zero row for sr25519; the
     cache hits also with a tampered k, a slot whose oks is false, slots
     counted from the end (slot - C) and the edge slots -1, -5, -C,
     -C - 1, INT32_MIN, C, C + 3, INT32_MAX, the plain version handed the
     same raw slots (both wrap, then clamp, as the reference's gather),
     and on sr25519 an honest R made odd and non-canonical after the host
     prep (the bitmap and every hit); and the bitmap against the plane's
     pure-Python oracle; the cache fill
     and hit at every pubkey-cache split (TM_TPU_PK_SPLIT 4, 1, 2, 8), and
     the cached RLC at S = 2, 4, 8; fail_count (the sharded path's fail
     count) on edge bitmaps of 1 to 10,240 rows, verdicts and 1-8 counts;
  3. the main path: verify_commit on ed25519 and on sr25519 validator sets
     of 150, 1,000 and 10,000 validators (valid, and with one tampered
     signature that must be reported at its index), every kernel's launch
     counter set to 0 just before each call and read just after, and held
     to the launches that call must make;
  4. each kernel against its plain version again, on the rows phase 3's
     commits give it (16384 rows for the uncached bitmap, 1024 for the
     cache fill and the cache hit through the main path's own cache, both
     for the RLC, in both verdicts with one z_raw), exact equality and the
     tampered row alone invalid; the same calls timed with CUDA events
     beside the plain version, the bound and the launches, the RLC's
     device time by step (tables, windows, reduce, tail: torch.profiler
     by kernel name) and each uncached bitmap's (tables, ladder); the
     host prep of the 1,000- and 10,000-validator commits on both routes,
     the native C and the Python that TM_TPU_NATIVE=0 selects, which must
     give the same rows, precheck and RLC scalars, timed by part at 10,000
     in turns; the valid 10,000-validator verify_commit split into the
     commit loop, the host prep, the copies and the kernel with its sync,
     on both routes in turns, each call held to its one RLC launch; and
     the end-to-end verify_commit wall times; that call through the engine
     against direct dispatch, in turns; with --ab-parent DIR (a git
     archive of another commit, unpacked inside the repo), the RLC kernels, the
     uncached bitmaps (8, 2,560, 10,240 and 16,384 rows, with their
     steps), the split fills (1,024 keys at S = 2, 4, 8 and 10,240 at S =
     4) and the single-table fills (1,024, 4,096 and 10,240 keys), whose
     tables must hash the same in every turn, and the cache hits (1,024
     rows at S = 1, 2, 4, 8, and row 15's 10,240 and 2,560 rows at S = 1
     and 4) of that tree against this one's on the same rows, in turns
     parent, new, new, parent, each a process of its own ("ab:" lines), and
     in this tree's turns the single-table hits' two-launch layout and
     their kernels at every block shape, and both designs of the
     single-table fills (one-lane and quad-split decoders), whose bytes
     must equal the entry point's, with the SASS instruction counts of one
     field product each way;
  5. the other cache geometries, S = 1, 2 and 8, each through a new cache
     of that split: verify_commit on the 150-validator commit and on the
     tampered 1,000-validator one, exact launches (the single-table
     kernels at S = 1), and the split's fill and hit against their plain
     versions on the rows that commit gives them, timed;
  6. the cached RLC (TM_TPU_MSM_CACHE=on, ed25519) at S = 2, 4 and 8: the
     valid 1,000-validator commit with the knob off, then on (fill and
     cached RLC, then the cached RLC alone), the tampered one (cached RLC,
     then the cache hit), the 10,000-validator one (its keys overflow the
     cache: the uncached RLC), exact launches; at S = 1 the knob takes the
     uncached RLC; the cached RLC against its plain version at 1024 rows
     in both verdicts with one z_raw, timed;
  7. the sharded path (parallel/) on two meshes, make_mesh() (the card) and
     make_mesh(4, device="cuda:0") (four shards on it): verify_batch_sharded
     on the 10,000-validator commits of both planes (the bitmap equal to the
     single-card one, the tampered row alone false, the verdict flipped);
     verify_batch_sharded_cached on the 1,000-validator commits at S = 4 and
     S = 1 (the fill once, on the first call, then a hit a shard) and on the
     10,000-validator one, whose keys overflow the cache (the uncached path);
     verify_batch_sharded_rlc on the ed25519 1,000- and 10,000-validator
     commits and on 10 signatures over four shards, two of padding only;
     verify_batch_sharded_local in subprocesses, one rank on NCCL and four
     ranks on gloo with their kernels on the card, each rank holding a
     quarter of the tampered 10,000-validator commit; then each kernel of the
     path against its plain version at the sharded shapes, 10,240 rows and a
     shard of 2,560, exact and timed, fail_count beside torch.sum, and
     verify_batch_sharded against the single-card verify_batch end to end;
  8. the cutover autotune (ops/engine.py) in a fresh process with the
     cutovers unpinned: a 4-signature batch verify starts the probe on
     the card, its thread is joined, and its cutovers must follow the
     reference's formula from its two timings, with no recorded
     exception and exactly its 4 bitmap launches;
  9. the coalescing engine (ops/engine.py) on the card: (a) on each plane,
     three 67-validator commits, then four 1,000-validator ones with one
     tampered, each set verified by concurrent verify_commit callers
     queued behind a first job that holds the dispatch worker, so they
     form one group (coalesced_group_size must show it): every caller's
     verdict and tampered index equal direct dispatch's
     (TM_TPU_ENGINE=off), and the launches exactly those of one call over
     the combined rows; (b) three 20-signature jobs, 60 rows, one host
     group, no launch; (c) in a fresh process with TM_TPU_DEVOBS=1, a valid
     1,000-validator call copies to the card exactly its inputs' bytes,
     residency is above zero after a cache fill, and the build events are
     one load of each library loaded and one nvcc run and load of the one
     kernel built; (d) wall times, engine against direct dispatch in turns,
     beside the card's name and power limit: 8 threads x 150-validator
     ed25519 commits (a light-client server), 4 threads x 1,000-validator
     ones (blocksync's verify-ahead) and one 10,000-validator call, with
     the launches a commit and the engine's overlap_ratio;
 10. the light client and the hashes on the card: (a) on each plane, a
     light chain of 16 heights over 150 validators of equal power (the
     Cosmos Hub's active set), fully populated headers whose commits sign
     header.hash(), the set changing once at height 9 (one key swapped
     by update_with_change_set); verify_adjacent on every consecutive
     pair, verify_non_adjacent and verify from 1 to 16 at the default trust
     level of 1/3, each held to the launches its routing gives (the
     101-signature commit check a cache fill on the first sight of a key,
     then hits; the 51-signature trusting check below the device cutover,
     none), and the rejections with the reference's error classes: a
     data_hash forged after signing and the old set supplied
     (ErrInvalidHeader), a tampered signature (ErrInvalidHeader naming its
     index), an expired trusted header (ErrOldHeaderExpired) and a rival
     set in which the trusted validators hold a third of their power
     (ErrNewValSetCantBeTrusted); (b) the 10,000-validator set's hash()
     cold and memoized, and its leaves' root, proofs and a 64-index
     multiproof on the native route and under TM_TPU_NATIVE=0 in turns,
     the same bytes on both, every proof verifying and a tampered one
     failing; (c) BASELINE.json config 4, mixed key types: verify_commit
     on 100 ed25519 and 50 secp256k1 validators under an ed25519 and a
     secp256k1 proposer, the valid commit accepted and a tampered
     secp256k1 and a tampered ed25519 signature reported at their index,
     serially, so with no launch; the secp256k1 route ("cryptography" or
     "softcrypto") printed beside the wall times;
 11. the light client (light/client.py), its stores and providers, and
     evidence verification (evidence/verify.py) on the card: on each plane
     a chain of 32 heights over 150 validators of which a third (50) is
     swapped out at heights 9, 17 and 25, served by LocalProvider over
     stand-in stores (ChainStore); from trust at height 1 a LightClient
     verifies to 32 skipping (the bisection 1 -> 32 failing the trusting
     check, 1 -> 16, 16 -> 32 failing at exactly a third, 16 -> 24,
     24 -> 32, as bisection_model works out from the sets), sequentially
     (31 adjacent checks) and backwards from 32 to 20 (a hash-chain walk),
     over a MemLightStore and over DBLightStore(MemDB()), each held to the
     heights it fetches and persists; then with an honest, a lunatic (the
     common set re-signs height 32 with a forged app_hash) and an
     equivocating (the same set signs another data_hash) witness: each
     lying one raises ErrLightClientAttack, leaves only the trust root
     persisted and reports its evidence to both providers; then a full
     node's verify_evidence accepts both pieces of evidence and a
     duplicate vote, and refuses a tampered total power (accepted after
     regenerate()), a header rewritten after signing, an unknown common
     height, a forged vote signature and a forged commit signature. Each
     call is held to its outcome and its launches (the 101-signature checks
     on the card, the 51-signature trusting checks on the host); each
     sync's verifier calls, the detections and the evidence checks are
     timed beside the card's name and power limit.

Phases 3, 5, 6, 7, 10 and 11 are each a main path: every call in them runs
with the launch counters set to 0 just before it and read just after, and
each phase fails if one of its kernels never launched. They run at the
defaults, so through the engine (TM_TPU_ENGINE unset), but with
TM_TPU_AUTOTUNE=off, so the probe's launches, which land from a thread at
an unknown time, stay out of their counts. Phase 4's split of the valid
10,000-validator call instruments direct dispatch (TM_TPU_ENGINE=off) and
then times the same call through the engine against it.

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. Exits nonzero, printing no result, when
there is no CUDA device or the package is missing.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import re
import subprocess
import sys
import time
from types import SimpleNamespace

ROOT = os.path.dirname(os.path.abspath(__file__))
PLANES = ("ed25519", "sr25519")

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

# Field squarings (S) and multiplications (M) of each formula, counted from
# csrc/ge25519.cuh and csrc/ristretto.cuh: ZIP-215 decode 256S+19M,
# ristretto decode 256S+18M, ristretto encode 255S+21M, addition 8M (+1
# for T), doubling 4S+3M (+1 for T), cofactored equality tail 24S+22M.
DECODE = (256, 19)
RDECODE = (256, 18)
RENCODE = (255, 21)


def _ops(squares: int, mults: int) -> int:
    return squares * MULS_PER_FE_SQ + mults * MULS_PER_FE_MUL


def ops_verify(n: int) -> int:
    # 2 decodes, 14 table additions, top window add, 63 windows
    # (4 doublings + 2 additions), tail
    return n * _ops(2 * DECODE[0] + 63 * 16 + 24,
                    2 * DECODE[1] + 14 * 9 + 8 + 63 * (13 + 9 + 8) + 22)


def ops_verify_sr(n: int) -> int:
    # 2 ristretto decodes (A and R), 14 table additions, top window add, 63
    # windows (4 doublings + 2 additions), ristretto_equal's 4 products
    return n * _ops(2 * RDECODE[0] + 63 * 16,
                    2 * RDECODE[1] + 14 * 9 + 8 + 63 * (13 + 9 + 8) + 4)


def ops_pk_tables(n: int, decode=DECODE, splits: int = 4) -> int:
    # decode, S - 1 power chains of 256/S doublings (the last with T), S
    # tables of 14 additions; S = 1 is the single table
    chain = 256 // splits
    return n * _ops(decode[0] + (splits - 1) * chain * 4,
                    decode[1] + (splits - 1) * (chain * 3 + 1) + splits * 14 * 9)


def _split_ladder(splits: int) -> int:
    # 64/S steps of 4 doublings (the last with T) and 2 S additions: S comb
    # rows with T, S - 1 cache rows with T and the last without
    return (64 // splits) * (13 + splits * 9 + (splits - 1) * 9 + 8)


def ops_verify_cached(n: int, splits: int = 4) -> int:
    # decode R, the split ladder, the cofactored tail
    return n * _ops(DECODE[0] + (64 // splits) * 16 + 24, DECODE[1] + _split_ladder(splits) + 22)


def ops_verify_sr_cached(n: int, splits: int = 4) -> int:
    # the split ladder (its last addition with T), encode
    return n * _ops((64 // splits) * 16 + RENCODE[0], _split_ladder(splits) + 1 + RENCODE[1])


def ops_verify_cached_single(n: int) -> int:
    # decode R, top window add, 63 windows (4 doublings + 2 additions), tail
    return n * _ops(DECODE[0] + 63 * 16 + 24, DECODE[1] + 8 + 63 * (13 + 9 + 8) + 22)


def ops_verify_sr_cached_single(n: int) -> int:
    # ristretto decode of R, top window add, 63 windows (4 doublings + 2
    # additions), ristretto_equal's 4 products
    return n * _ops(RDECODE[0] + 63 * 16, RDECODE[1] + 8 + 63 * (13 + 9 + 8) + 4)


def ops_msm(n: int, g: int, sr: bool = False) -> int:
    dec = RDECODE if sr else DECODE
    per_row = _ops(2 * dec[0], 2 * dec[1] + 2 * 14 * 9 + 96 * 9)
    horner = _ops(63 * 16, 63 * (13 + 9))
    # the stream tree and the comb, then [zs]B added with T and one encode
    # (sr25519), or added without T and 3 doublings (ed25519)
    decide = _ops(RENCODE[0], 9 + RENCODE[1]) if sr else _ops(12, 8 + 9)
    return n * per_row + g * horner + _ops(0, (g - 1) * 9 + 64 * 9) + decide


def ops_msm_cached(n: int, g: int, splits: int) -> int:
    # per row: decode R, R's table and 96 window additions (32 of R's, 64 of
    # A's from the cache); the tail over max(32, 64/S) windows
    wn = max(32, 64 // splits)
    per_row = _ops(DECODE[0], DECODE[1] + 14 * 9 + 96 * 9)
    horner = _ops((wn - 1) * 16, (wn - 1) * (13 + 9))
    return n * per_row + g * horner + _ops(0, (g - 1) * 9 + 64 * 9) + _ops(12, 8 + 9)


def cache_read_bytes(scalar_rows, splits: int) -> int:
    """Bytes of cache entries the ladder of each row reads, once each: the
    distinct (power table, nibble) entries its scalar's 64 nibbles select,
    256 bytes an entry."""
    import numpy as np

    b = np.asarray(scalar_rows, np.uint8)
    nibs = np.stack([b & 15, b >> 4], axis=2).reshape(len(b), 64).astype(np.int64)
    ids = (np.arange(64) // (64 // splits)) * 16 + nibs if splits > 1 else nibs
    return 256 * sum(len(np.unique(row)) for row in ids)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def ptxas_functions(report: str):
    """(kernel, registers, spill line) for each entry function in an
    `nvcc -Xptxas -v` report, the mangled name shortened to its identifier
    and its integer or bool template arguments."""
    out, fn, spills = [], None, ""
    for line in report.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = m.group(1)
            ident = re.match(r"_Z(\d+)(\w+)", fn)
            if ident:
                size = int(ident.group(1))
                name, rest = ident.group(2)[:size], ident.group(2)[size:]
                targs = re.match(r"I((?:L[bi]\d+E)+)E", rest)
                if targs:
                    vals = [{"b0": "false", "b1": "true"}.get(t + v, v)
                            for t, v in re.findall(r"L([bi])(\d+)E", targs.group(1))]
                    name += f"<{','.join(vals)}>"
                fn = name
            continue
        if "spill stores" in line:
            spills = line.strip()
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            out.append((fn, int(m.group(1)), spills))
            fn, spills = None, ""
    return out


def log(msg: str) -> None:
    print(msg, flush=True)


# -- the two signature planes -------------------------------------------------


def plane(kind: str) -> SimpleNamespace:
    """One signature plane's host pieces, kernels, plain versions and
    bound model, under shared names."""
    from tendermint_tpu_torch.crypto import ed25519_ref as ref
    from tendermint_tpu_torch.crypto import sr25519 as sr
    from tendermint_tpu_torch.ops import msm as M
    from tendermint_tpu_torch.ops import verify as V
    from tendermint_tpu_torch.ops import verify_sr as VS

    if kind == "ed25519":
        return SimpleNamespace(
            kind=kind, prepare=V.prepare_batch, oracle=ref.verify, cache=V.pubkey_cache,
            edges=edge_batch, batch=V.verify_batch,
            bitmap=V.verify_kernel, bitmap_plain=V.verify_kernel_plain, bitmap_steps=BITMAP_STEPS,
            fill=V.build_pk_tables_split, fill_plain=V.build_pk_tables_split_plain,
            hit=V.verify_kernel_cached_split, hit_plain=V.verify_kernel_cached_split_plain,
            fill1=V.build_pk_tables, fill1_plain=V.build_pk_tables_plain,
            hit1=V.verify_kernel_cached, hit1_plain=V.verify_kernel_cached_plain,
            rlc=M.msm_verify_kernel, rlc_plain=M.msm_verify_kernel_plain,
            ops_bitmap=ops_verify, ops_fill=lambda n, s: ops_pk_tables(n, DECODE, s),
            ops_hit=lambda n, s: ops_verify_cached_single(n) if s == 1 else ops_verify_cached(n, s),
            ops_rlc=lambda n, g: ops_msm(n, g),
        )
    return SimpleNamespace(
        kind=kind, prepare=VS.prepare_batch, oracle=sr.verify, cache=VS.sr_pubkey_cache,
        edges=sr_edge_batch, batch=VS.verify_batch,
        bitmap=VS.verify_sr_kernel, bitmap_plain=VS.verify_sr_kernel_plain,
        bitmap_steps=SR_BITMAP_STEPS,
        fill=VS.build_sr_tables_split, fill_plain=VS.build_sr_tables_split_plain,
        hit=VS.verify_sr_kernel_cached_split, hit_plain=VS.verify_sr_kernel_cached_split_plain,
        fill1=VS.build_sr_tables, fill1_plain=VS.build_sr_tables_plain,
        hit1=VS.verify_sr_kernel_cached, hit1_plain=VS.verify_sr_kernel_cached_plain,
        rlc=M.msm_verify_sr_kernel, rlc_plain=M.msm_verify_sr_kernel_plain,
        ops_bitmap=ops_verify_sr, ops_fill=lambda n, s: ops_pk_tables(n, RDECODE, s),
        ops_hit=lambda n, s: ops_verify_sr_cached_single(n) if s == 1 else ops_verify_sr_cached(n, s),
        ops_rlc=lambda n, g: ops_msm(n, g, sr=True),
    )


def cache_pair(P, splits: int):
    """(fill, fill_plain, hit, hit_plain) of a plane at a split, each taking
    what the main path hands it: the single-table kernels at S = 1, the
    split ones (the fill told S, the hit reading it from the tables) above."""
    if splits == 1:
        return P.fill1, P.fill1_plain, P.hit1, P.hit1_plain
    return (lambda a: P.fill(a, splits)), (lambda a: P.fill_plain(a, splits)), P.hit, P.hit_plain


# kernel -> (its source, the JAX program it replaces)
KERNEL_SOURCES = {
    "verify_kernel": ("csrc/verify.cu", "tendermint_tpu/ops/verify.py:81"),
    "build_pk_tables_split": ("csrc/pk_tables.cu", "tendermint_tpu/ops/verify.py:141"),
    "verify_kernel_cached_split": ("csrc/verify_cached.cu", "tendermint_tpu/ops/verify.py:157"),
    "msm_verify_kernel": ("csrc/msm.cu", "tendermint_tpu/ops/msm.py:162"),
    "verify_sr_kernel": ("csrc/verify_sr.cu", "tendermint_tpu/ops/verify_sr.py:46"),
    "build_sr_tables_split": ("csrc/sr_tables.cu", "tendermint_tpu/ops/verify_sr.py:89"),
    "verify_sr_kernel_cached_split": ("csrc/verify_sr_cached.cu", "tendermint_tpu/ops/verify_sr.py:112"),
    "msm_verify_sr_kernel": ("csrc/msm_sr.cu", "tendermint_tpu/ops/msm.py:272"),
    "build_pk_tables": ("csrc/pk_tables_single.cu", "tendermint_tpu/ops/verify.py:95"),
    "verify_kernel_cached": ("csrc/verify_cached_single.cu", "tendermint_tpu/ops/verify.py:113"),
    "msm_verify_kernel_cached": ("csrc/msm_cached.cu", "tendermint_tpu/ops/msm.py:241"),
    "build_sr_tables": ("csrc/sr_tables_single.cu", "tendermint_tpu/ops/verify_sr.py:59"),
    "verify_sr_kernel_cached": ("csrc/verify_sr_cached_single.cu", "tendermint_tpu/ops/verify_sr.py:75"),
    "fail_count": ("csrc/fail_count.cu", "tendermint_tpu/parallel/sharded_verify.py:46"),
}
# The pubkey-cache geometries (TM_TPU_PK_SPLIT): the default and the others.
DEFAULT_SPLITS = 4
OTHER_SPLITS = (1, 2, 8)
RLC_CACHE_SPLITS = (2, 4, 8)


# -- keys and signatures (set-up, not timed) ---------------------------------


def _sign_worker(job):
    kind, seed, msgs = job
    if kind == "sr25519":
        from tendermint_tpu_torch.crypto.sr25519 import Sr25519PrivKey

        priv = Sr25519PrivKey(seed)
        return priv.pub_key().bytes(), [priv.sign(m) for m in msgs]
    if kind == "secp256k1":
        from tendermint_tpu_torch.crypto.secp256k1 import Secp256k1PrivKey

        priv = Secp256k1PrivKey.generate(seed)
        return priv.pub_key().bytes(), [priv.sign(m) for m in msgs]
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


def make_keys(pool, kind, seeds):
    return [pub for pub, _ in pool.map(_sign_worker, [(kind, s, []) for s in seeds], chunksize=64)]


def sign_all(pool, kind, seeds, msg_lists):
    jobs = [(kind, s, m) for s, m in zip(seeds, msg_lists)]
    return [sigs for _, sigs in pool.map(_sign_worker, jobs, chunksize=64)]


def build_commit(pool, kind, seeds, pubs, rng, n, chain_id, height):
    """A commit of n validators of equal power, every one voting for the
    block, signed over the canonical vote sign bytes."""
    from tendermint_tpu_torch.crypto.ed25519 import Ed25519PubKey
    from tendermint_tpu_torch.crypto.sr25519 import Sr25519PubKey
    from tendermint_tpu_torch.types.block import BlockID, Commit, CommitSig, PartSetHeader
    from tendermint_tpu_torch.types.validator_set import Validator, ValidatorSet
    from tendermint_tpu_torch.utils.tmtime import Time

    key = Sr25519PubKey if kind == "sr25519" else Ed25519PubKey
    vals = ValidatorSet.new([Validator.new(key(pubs[i]), 10) for i in range(n)])
    seed_of = {key(pubs[i]).address(): seeds[i] for i in range(n)}
    block_id = BlockID(rng.bytes(32), PartSetHeader(1, rng.bytes(32)))
    commit = Commit(height=height, round=0, block_id=block_id, signatures=[
        CommitSig.new_commit(v.address, Time(1_700_000_000 + i, 1000 * i + 7), b"")
        for i, v in enumerate(vals.validators)
    ])
    msgs = [commit.vote_sign_bytes(chain_id, i) for i in range(n)]
    order = [seed_of[v.address] for v in vals.validators]
    for cs, sigs in zip(commit.signatures, sign_all(pool, kind, order, [[m] for m in msgs])):
        cs.signature = sigs[0]
    return vals, block_id, commit


def tamper(sig: bytes) -> bytes:
    return sig[:40] + bytes([sig[40] ^ 0x01]) + sig[41:]


# -- phase 2: kernels against their plain versions ---------------------------


def sign_torsion_r(priv: bytes, msg: bytes, rng) -> bytes:
    """An ed25519 signature whose R is [r]B plus a point of order 8, the
    challenge taken over that R: valid under the cofactored equation only."""
    from tendermint_tpu_torch.crypto import ed25519_ref as ref

    t8 = next(p for p in map(ref.decompress, ref.small_order_points())
              if not ref.point_is_identity(ref.scalar_mult(4, p)))
    a = ref._clamp(ref._sha512(priv[:32]))
    r = int.from_bytes(rng.bytes(64), "little") % ref.L
    r_enc = ref.compress(ref.point_add(ref.scalar_mult(r, ref.BASE), t8))
    s = (r + ref.challenge_scalar(r_enc, priv[32:], msg) * a) % ref.L
    return r_enc + s.to_bytes(32, "little")


def edge_batch(rng, n=64):
    """n rows: honest signatures, tampered ones, and the ZIP-215 edges."""
    from tendermint_tpu_torch.crypto import ed25519_ref as ref

    pks, msgs, sigs = [], [], []
    for i in range(n - 9):
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
    # an R that does not decode, on the same key
    pks.append(priv[32:]); msgs.append(b"bad-R"); sigs.append(y.to_bytes(32, "little") + ref.sign(priv, b"bad-R")[32:])
    # a non-canonical R (y = p + 1, the identity) over a small-order key, s = 0: valid
    pks.append(so[1]); msgs.append(b"R>=p"); sigs.append((ref.P + 1).to_bytes(32, "little") + b"\x00" * 32)
    # R = [r]B + a point of order 8: valid after the cofactor
    pks.append(priv[32:]); msgs.append(b"R+T8"); sigs.append(sign_torsion_r(priv, b"R+T8", rng))
    return pks, msgs, sigs


# RFC 9496 appendix A.2: encodings every ristretto255 decoder rejects
# (non-canonical s, negative s, non-square x^2, negative xy, s = -1).
RISTRETTO_BAD_ENCODINGS = [
    "00ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff",
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff7f",
    "f3ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff7f",
    "edffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff7f",
    "0100000000000000000000000000000000000000000000000000000000000000",
    "01ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff7f",
    "ed57ffd8c914fb201471d1c3d245ce3c746fcbe63a3679d51b6a516ebebe0e20",
    "26948d35ca62e643e26a83177332e6b6afeb9d08e4268b650f1f5bbd8d81d371",
    "4eac077a713c57b4f4397629a4145982c661f48044dd3f96427d40b147d9742f",
    "3eb858e78f5a7254d8c9731174a94f76755fd3941c0ac93735c07ba14579630e",
    "ecffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff7f",
    "c7176a703d4dd84fba3c0b760d10670f2a2053fa2c39ccc64ec7fd7792ac037a",
]


def sr_edge_batch(rng, n=64):
    """n rows: honest sr25519 signatures, tampered s and tampered R, the RFC
    9496 bad encodings as keys, a missing marker bit, s >= L, an honest R
    made non-canonical (s + p), negated and replaced by random bytes, and
    the zero row (identity key, identity R, s = 0: valid)."""
    from tendermint_tpu_torch.crypto import sr25519 as sr

    pks, msgs, sigs = [], [], []
    for i in range(n - len(RISTRETTO_BAD_ENCODINGS) - 7):
        priv = sr.Sr25519PrivKey(rng.bytes(32))
        msg = b"chip-smoke-sr-%d" % i + rng.bytes(16)
        sig = priv.sign(msg)
        if i % 9 == 4:
            sig = tamper(sig)
        elif i % 9 == 7:
            sig = bytes([sig[0] ^ 0x04]) + sig[1:]  # R
        pks.append(priv.pub_key().bytes())
        msgs.append(msg)
        sigs.append(sig)
    for enc in RISTRETTO_BAD_ENCODINGS:
        pks.append(bytes.fromhex(enc)); msgs.append(msgs[0]); sigs.append(sigs[0])
    # a bad R encoding on an honest key
    pks.append(pks[0]); msgs.append(msgs[0]); sigs.append(bytes.fromhex(RISTRETTO_BAD_ENCODINGS[7]) + sigs[0][32:])
    # the marker bit cleared
    nomark = bytearray(sigs[0]); nomark[63] &= 0x7F
    pks.append(pks[0]); msgs.append(msgs[0]); sigs.append(bytes(nomark))
    # s + L with the marker bit: fails the host precheck
    s = int.from_bytes(sigs[0][32:], "little") & ((1 << 255) - 1)
    big = bytearray((s + sr.L).to_bytes(32, "little")); big[31] |= 0x80
    pks.append(pks[0]); msgs.append(msgs[0]); sigs.append(sigs[0][:32] + bytes(big))
    # row 1's honest R non-canonical (s + p), negated, and random bytes
    r_enc, rest = sigs[1][:32], sigs[1][32:]
    neg_r = sr.ristretto_encode(sr.point_neg(sr.ristretto_decode(r_enc)))
    for r_bad in ((int.from_bytes(r_enc, "little") + sr.P).to_bytes(32, "little"), neg_r, rng.bytes(32)):
        pks.append(pks[1]); msgs.append(msgs[1]); sigs.append(r_bad + rest)
    # the zero row, marked
    pks.append(bytes(32)); msgs.append(b"zero"); sigs.append(bytes(63) + b"\x80")
    return pks, msgs, sigs


def canonical_tables(t):
    """Cache tables with every coordinate made canonical (limb axis first
    for fe_canonical, and back)."""
    import torch

    from tendermint_tpu_torch.ops import field as F

    return F.fe_canonical(t.to(torch.int32).movedim(-1, 0)).movedim(0, -1)


def kernel_label(fn, splits: int) -> str:
    """A kernel's name in the record: the wrapper's, with the split for a
    wrapper that serves several (S = 2 and 8; S = 4 is the default)."""
    return fn.__name__ if splits in (None, 1, DEFAULT_SPLITS) else f"{fn.__name__}[S={splits}]"


def check_fill(name, tabs, oks, ptabs, poks, all_decode: bool = False) -> int:
    """A fill against its plain version: equal tables after fe_canonical,
    equal decode bits, and canonical coordinates from the kernel; returns
    the max |error|."""
    import torch

    err = int((canonical_tables(tabs) - canonical_tables(ptabs)).abs().max())
    if err or not torch.equal(oks, poks) or (all_decode and not bool(oks.all())):
        raise AssertionError(f"{name}: max |kernel - plain| after fe_canonical = {err}, "
                             f"{int((oks != poks).sum())} decode bits differ")
    if tabs.is_cuda and not torch.equal(tabs.to(torch.int32), canonical_tables(tabs)):
        raise AssertionError(f"{name}: the kernel wrote non-canonical coordinates")
    return err


def check_kernels(rng, dev, P):
    """One plane's four kernels against their plain versions and its oracle
    on the plane's edge batch; returns each kernel's max |error|."""
    import numpy as np
    import torch

    from tendermint_tpu_torch.ops import msm as M
    from tendermint_tpu_torch.ops import verify as V

    def cuda(*arrays):
        return V._to_device(list(arrays), dev)

    errs = {}
    pks, msgs, sigs = P.edges(rng)
    n = len(sigs)
    a, r, s, k, pre = P.prepare(pks, msgs, sigs)
    a_d, r_d, s_d, k_d = cuda(a, r, s, k)
    name = P.bitmap.__name__

    got = P.bitmap(a_d, r_d, s_d, k_d)
    want = P.bitmap_plain(a_d, r_d, s_d, k_d)
    torch.cuda.synchronize()
    oracle = np.array([P.oracle(p, m, g) for p, m, g in zip(pks, msgs, sigs)])
    bitmap = got.cpu().numpy() & pre
    if not torch.equal(got, want) or not (bitmap == oracle).all():
        raise AssertionError(f"{name}: kernel {got.tolist()} plain {want.tolist()} "
                             f"oracle {oracle.tolist()}")
    errs[name] = 0
    log(f"phase 2: {name} == plain == oracle on {n} rows ({int(oracle.sum())} valid)")
    if P.kind == "sr25519":
        # an honest row's R made odd (p - R) and non-canonical (R + p) after
        # the host prep, so k stays R's: decode rejects both, and the odd
        # encoding's decode candidate is R's point, so only R's decode bit
        # makes that row false
        from tendermint_tpu_torch.crypto import sr25519 as sr

        h = int(np.flatnonzero(oracle)[0])
        r_int = int.from_bytes(r[h].tobytes(), "little")
        bad_r = np.frombuffer(b"".join(x.to_bytes(32, "little") for x in (sr.P - r_int, r_int + sr.P)),
                              np.uint8).reshape(2, 32)
        rows = cuda(a[[h, h]], bad_r, s[[h, h]], k[[h, h]])
        got, want = P.bitmap(*rows), P.bitmap_plain(*rows)
        torch.cuda.synchronize()
        if not torch.equal(got, want) or bool(got.any()):
            raise AssertionError(f"{name} on R made odd and non-canonical: kernel {got.tolist()} "
                                 f"plain {want.tolist()}")
        log(f"phase 2: {name} == plain == False on an honest row with R made odd and non-canonical")

    caches = {}
    for splits in (DEFAULT_SPLITS,) + OTHER_SPLITS:
        fill, fill_plain, hit, hit_plain = cache_pair(P, splits)
        name = kernel_label(P.fill1 if splits == 1 else P.fill, splits)
        tabs, oks = fill(a_d)
        ptabs, poks = fill_plain(a_d)
        torch.cuda.synchronize()
        errs[name] = check_fill(name, tabs, oks, ptabs, poks)
        log(f"phase 2: {name} == canonical(plain) on {n} keys, {tabs.numel() // 32} coordinates "
            f"({int(oks.sum())} decode)")

        name = kernel_label(P.hit1 if splits == 1 else P.hit, splits)
        perm = torch.from_numpy(rng.permutation(n).astype(np.int64)).to(dev)
        cache_t = torch.empty_like(tabs).index_copy_(0, perm, tabs)
        cache_o = torch.empty_like(oks).index_copy_(0, perm, oks)
        slots = perm.to(torch.int32)
        got = hit(cache_t, cache_o, slots, r_d, s_d, k_d)
        want = hit_plain(cache_t, cache_o, slots, r_d, s_d, k_d)
        # the plain fill's signed limbs through the kernel (the carried-across cache)
        plain_cache = torch.empty_like(ptabs).index_copy_(0, perm, ptabs)
        got_signed = hit(plain_cache, cache_o, slots, r_d, s_d, k_d)
        torch.cuda.synchronize()
        if not (torch.equal(got, want) and torch.equal(got, got_signed)) or not (
                (got.cpu().numpy() & pre) == oracle).all():
            raise AssertionError(f"{name}: kernel {got.tolist()} plain {want.tolist()}")
        _, _, rows = hit_edges(hit, hit_plain, oracle, cache_t, cache_o, slots, r_d, s_d, k_d)
        if P.kind == "sr25519":
            # the hits decide by R's decode bit too: the odd and non-canonical R above
            got = hit(cache_t, cache_o, slots[[h, h]], *cuda(bad_r, s[[h, h]], k[[h, h]]))
            want = hit_plain(cache_t, cache_o, slots[[h, h]], *cuda(bad_r, s[[h, h]], k[[h, h]]))
            torch.cuda.synchronize()
            if not torch.equal(got, want) or bool(got.any()):
                raise AssertionError(f"{name} on R made odd and non-canonical: kernel {got.tolist()} "
                                     f"plain {want.tolist()}")
        errs[name] = 0
        log(f"phase 2: {name} == plain == oracle on {n} rows (both table forms); == plain with a "
            f"tampered k, oks false and slots - C wrapped at valid rows {rows}, and slots "
            f"{edge_slots(len(cache_t))}" + (", and == plain == False with R made odd and non-canonical"
                                             if P.kind == "sr25519" else ""))
        caches[splits] = cache_t, cache_o, slots

    name = P.rlc.__name__
    keep = [i for i in range(n) if oracle[i]]
    bad = next(i for i in range(n) if pre[i] and not oracle[i])  # a tampered row
    for label, idx in (("valid", keep), ("tampered", keep[:-1] + [bad])):
        bp, bm, bs = [pks[i] for i in idx], [msgs[i] for i in idx], [sigs[i] for i in idx]
        a2, r2, s2, k2, pre2 = P.prepare(bp, bm, bs)
        z_raw = rng.bytes(16 * len(idx))
        zk, z, zs = M._rlc_scalars(s2, k2, len(idx), z_raw)
        rows = cuda(*V.pad_pow2_rows([a2, r2, zk, z], len(idx)), zs)
        got = P.rlc(*rows)
        want = P.rlc_plain(*rows)
        torch.cuda.synchronize()
        expect = label == "valid"
        if bool(got) != bool(want) or bool(got) != expect:
            raise AssertionError(f"{name} ({label}): kernel {bool(got)} plain {bool(want)}")
        log(f"phase 2: {name} == plain == {expect} on a {label} batch of {len(idx)} rows")
    errs[name] = 0
    if P.kind == "ed25519":
        check_rlc_cached(rng, dev, P, caches, pks, msgs, sigs, oracle, pre, errs)
    return errs


# Slots no real path hands out, held as the reference's jnp gather maps
# them (a negative slot counts from the end, then the index clamps):
# -1, -5, -C, -C - 1, INT32_MIN, C, C + 3 and INT32_MAX.
def edge_slots(cap: int):
    return [-1, -5, -cap, -cap - 1, -2**31, cap, cap + 3, 2**31 - 1]


def hit_edges(hit, hit_plain, oracle, cache_t, cache_o, slots, r, s, k):
    """A cache hit on the cache's own edges: a tampered k and a slot whose
    oks is false, each at a valid row; four valid rows whose slots are
    given counted from the end (slot - C, which must wrap back to the
    key's own entry and stay valid); and the edge_slots at other rows. The
    plain version gets the same raw slots. The kernel must equal it,
    reject the tampered and the oks-false rows and accept the wrapped
    ones."""
    import torch

    valid = [i for i in range(len(oracle)) if oracle[i]]
    ka, od, *wrapped = valid[:6]
    cap = len(cache_t)
    edges = [i for i in range(len(oracle)) if i not in valid[:6]][:len(edge_slots(cap))]
    k_x = k.clone()
    k_x[ka, 3] ^= 0x20
    slots_x = slots.clone()
    for i in wrapped:
        slots_x[i] -= cap
    for i, v in zip(edges, edge_slots(cap)):
        slots_x[i] = v
    oks_x = cache_o.clone()
    oks_x[slots[od].long()] = False
    got = hit(cache_t, oks_x, slots_x, r, s, k_x)
    want = hit_plain(cache_t, oks_x, slots_x, r, s, k_x)
    torch.cuda.synchronize()
    if (not torch.equal(got, want) or bool(got[ka]) or bool(got[od])
            or not all(bool(got[i]) for i in wrapped)):
        raise AssertionError(f"{hit.__name__} on the cache edges (tampered k #{ka}, oks false #{od}, "
                             f"slots - C at {wrapped}, edge slots at {edges}): kernel {got.tolist()} "
                             f"plain {want.tolist()}")
    return got, want, (ka, od, *wrapped)


def check_rlc_cached(rng, dev, P, caches, pks, msgs, sigs, oracle, pre, errs):
    """The cached RLC (kernel 7) against its plain version on the edge
    batch's valid rows and on them with one tampered row, through the edge
    caches of every split it takes."""
    import numpy as np
    import torch

    from tendermint_tpu_torch.ops import msm as M
    from tendermint_tpu_torch.ops import verify as V

    n = len(sigs)
    keep = [i for i in range(n) if oracle[i]]
    bad = next(i for i in range(n) if pre[i] and not oracle[i])
    for splits in RLC_CACHE_SPLITS:
        cache_t, cache_o, slots = caches[splits]
        name = kernel_label(M.msm_verify_kernel_cached, splits)
        for verdict, idx in (("valid", keep), ("tampered", keep[:-1] + [bad])):
            _, r2, s2, k2, _ = P.prepare([pks[i] for i in idx], [msgs[i] for i in idx],
                                         [sigs[i] for i in idx])
            zk, z, zs = M._rlc_scalars(s2, k2, len(idx), rng.bytes(16 * len(idx)))
            r2, zk, z = V.pad_pow2_rows([r2, zk, z], len(idx))
            sl = slots[torch.tensor(idx + [idx[-1]] * (len(r2) - len(idx)), device=dev)]
            rows = V._to_device([r2, zk, z, zs], dev)
            got = M.msm_verify_kernel_cached(cache_t, cache_o, sl, *rows)
            want = M.msm_verify_kernel_cached_plain(cache_t, cache_o, sl, *rows)
            torch.cuda.synchronize()
            if bool(got) != bool(want) or bool(got) != (verdict == "valid"):
                raise AssertionError(f"{name} ({verdict}): kernel {bool(got)} plain {bool(want)}")
            log(f"phase 2: {name} == plain == {verdict == 'valid'} on a {verdict} batch of "
                f"{len(idx)} rows")
        errs[name] = 0


# -- phase 3: the main path ---------------------------------------------------


def kernel_wrappers():
    from tendermint_tpu_torch.ops import msm as M
    from tendermint_tpu_torch.ops import verify as V
    from tendermint_tpu_torch.ops import verify_sr as VS
    from tendermint_tpu_torch.parallel import sharded_verify as SV

    return (V.verify_kernel, V.build_pk_tables_split, V.verify_kernel_cached_split,
            M.msm_verify_kernel, VS.verify_sr_kernel, VS.build_sr_tables_split,
            VS.verify_sr_kernel_cached_split, M.msm_verify_sr_kernel, V.build_pk_tables,
            V.verify_kernel_cached, M.msm_verify_kernel_cached, VS.build_sr_tables,
            VS.verify_sr_kernel_cached, SV.fail_count)


def sharded_entries():
    """The sharded entry points, by the reference's sharded_launches label."""
    from tendermint_tpu_torch.parallel import sharded_verify as SV

    return {"bitmap": SV.verify_batch_sharded, "cached": SV.verify_batch_sharded_cached,
            "rlc": SV.verify_batch_sharded_rlc}


def reset_counts():
    for fn in kernel_wrappers() + tuple(sharded_entries().values()):
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


def drive(what, fn, want, totals, entries=None):
    """One main-path call with every launch counter set to 0 just before it
    and read just after; fails unless it made exactly the launches `want`
    names (and, where `entries` is given, took exactly those sharded entry
    points). Adds them to `totals`; returns (output, wall seconds)."""
    reset_counts()
    out, t = timed(fn)
    got = {name: c for name, c in read_counts().items() if c}
    if got != want:
        raise AssertionError(f"{what} launched {got}, expected {want}")
    took = {label: entry.launches for label, entry in sharded_entries().items() if entry.launches}
    if entries is not None and took != entries:
        raise AssertionError(f"{what} took the sharded entries {took}, expected {entries}")
    for name, c in got.items():
        totals[name] = totals.get(name, 0) + c
    return out, t


def check_path(what, totals, expected):
    """Fail if a kernel of a path's expected launches never ran in it."""
    idle = sorted({name for want in expected for name in want} - set(totals))
    if idle:
        raise AssertionError(f"{what} never launched {idle}")
    log(f"{what}: launches {json.dumps(totals)}")


def _expected(bitmap, fill, hit, rlc):
    """The launches each main-path call of one plane must make. Each plane
    has its own pubkey cache, which starts empty, and the 150 validators'
    keys are among the 1,000's: a valid commit of 256 or more signatures
    runs the RLC alone; a tampered one then runs the bitmap plane, through
    the cache (fill, then hit) up to 4,096 distinct keys and uncached
    beyond; the 150-validator commit goes straight to the cached bitmap,
    and the trusting check stops at 51 signatures, below the 64-signature
    cutover, so it runs on the host."""
    small, mid, large = SIZES
    return {
        (small, "valid"): {fill: 1, hit: 1},
        (small, "trusting"): {},
        (mid, "valid"): {rlc: 1},
        (mid, "tampered"): {rlc: 1, fill: 1, hit: 1},
        (large, "valid"): {rlc: 1},
        (large, "tampered"): {rlc: 1, bitmap: 1},
    }


SIZES = (150, 1000, 10000)
EXPECTED_LAUNCHES = {
    "ed25519": _expected("verify_kernel", "build_pk_tables_split", "verify_kernel_cached_split",
                         "msm_verify_kernel"),
    "sr25519": _expected("verify_sr_kernel", "build_sr_tables_split",
                         "verify_sr_kernel_cached_split", "msm_verify_sr_kernel"),
}


def main_path(pool, rng, keys, chain_id):
    """verify_commit on each plane's commits, with every launch counter set
    to 0 just before each call and read just after; returns the commits,
    the tampered index of each, the summed launches and the wall times."""
    from tendermint_tpu_torch.types.validation import (
        Fraction, verify_commit, verify_commit_light_trusting,
    )

    commits = {}
    for kind in PLANES:
        t0 = time.perf_counter()
        seeds, pubs = keys[kind]
        commits[kind] = {n: build_commit(pool, kind, seeds, pubs, rng, n, chain_id, 100 + n)
                         for n in SIZES}
        log(f"phase 3: {kind} commits signed in {time.perf_counter() - t0:.1f} s")
    bad_index = {n: (n * 5) // 12 for n in SIZES}
    totals = {}
    runs = []

    def run(kind, n, label, fn):
        return drive(f"{kind} {label} call on {n} validators", fn,
                     EXPECTED_LAUNCHES[kind][n, label], totals)

    for kind in PLANES:
        for n, (vals, bid, commit) in commits[kind].items():
            _, t = run(kind, n, "valid", lambda: verify_commit(chain_id, vals, bid, commit.height, commit))
            runs.append({"plane": kind, "commit": n, "run": "verify_commit valid", "s": t,
                         "sigs_per_s": n / t})
            if n == SIZES[0]:
                _, t = run(kind, n, "trusting", lambda: verify_commit_light_trusting(
                    chain_id, vals, commit, Fraction(1, 3)))
                runs.append({"plane": kind, "commit": n, "run": "verify_commit_light_trusting 1/3",
                             "s": t})
                continue
            msg, t = verify_tampered(chain_id, commits[kind][n], bad_index[n], lambda fn: run(
                kind, n, "tampered", fn))
            runs.append({"plane": kind, "commit": n, "run": f"verify_commit tampered #{bad_index[n]}",
                         "s": t, "sigs_per_s": n / t, "error": msg[:40]})
    for r in runs:
        log("phase 3: " + json.dumps(r))
    check_path("phase 3", totals, [w for kind in PLANES for w in EXPECTED_LAUNCHES[kind].values()])
    return commits, bad_index, totals, runs


def verify_tampered(chain_id, commit_entry, bad, run):
    """verify_commit on the commit with signature #bad tampered, through
    run(fn), which must report it at its index; the commit is restored."""
    from tendermint_tpu_torch.types.validation import verify_commit

    vals, bid, commit = commit_entry
    good = commit.signatures[bad].signature
    commit.signatures[bad].signature = tamper(good)
    try:
        return run(lambda: expect_wrong_signature(
            lambda: verify_commit(chain_id, vals, bid, commit.height, commit), bad))
    finally:
        commit.signatures[bad].signature = good


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


# The launches of kernels 4 and 8 by kernel name (the earlier, three-launch
# design has no reduce).
RLC_STEPS = ("msm_tables", "msm_windows", "msm_reduce", "msm_tail")
# The launches of kernels 1 and 9: the decode step, then the four-lane ladder.
BITMAP_STEPS = ("verify_tables", "verify_ladder")
SR_BITMAP_STEPS = ("verify_sr_tables", "verify_sr_ladder")


def step_times(fn, reps: int = 5, names=RLC_STEPS):
    """Device ms a call of each step (the RLC's by default), by kernel
    name, from torch.profiler over reps calls after one warm-up call; {}
    when the profiler reports no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    steps = {}
    for evt in prof.key_averages():
        us = getattr(evt, "device_time_total", None) or getattr(evt, "cuda_time_total", 0)
        name = evt.key.split("(")[0]
        for step in names:
            if us and re.search(rf"\b{step}\b", name):
                steps[step] = steps.get(step, 0.0) + us / 1e3 / reps
    return steps


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


@contextlib.contextmanager
def native_setting(python: bool):
    """TM_TPU_NATIVE=0 (the Python host prep) inside the block when python
    is true, unset (the native C) otherwise; restored after."""
    before = os.environ.pop("TM_TPU_NATIVE", None)
    if python:
        os.environ["TM_TPU_NATIVE"] = "0"
    try:
        yield
    finally:
        os.environ.pop("TM_TPU_NATIVE", None)
        if before is not None:
            os.environ["TM_TPU_NATIVE"] = before


@functools.lru_cache(maxsize=None)
def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


HOST_PREP_TURNS = ("python", "native", "native", "python")


def host_prep_route(P, jobs, n, z_raw, python: bool):
    """One plane's host prep of a commit on one route, timed by part:
    prepare_batch and the RLC scalars; on the Python route also the
    challenges alone (a separate call), on the native one (ed25519) the
    C call alone, on buffers joined before it (challenges, s < L and
    shaping, threaded)."""
    import ctypes
    import hashlib

    import numpy as np

    from tendermint_tpu_torch import native
    from tendermint_tpu_torch.crypto import sr25519 as sr
    from tendermint_tpu_torch.ops import msm as M

    pks, msgs, sigs = jobs
    split = {}
    with native_setting(python):
        if python:
            t0 = time.perf_counter()
            if P.kind == "sr25519":
                sr.challenges_batch(pks, msgs, [g[:32] for g in sigs])
            else:
                for p, m, g in zip(pks, msgs, sigs):
                    hashlib.sha512(g[:32] + p + m).digest()
            split["challenges_s"] = time.perf_counter() - t0
        elif P.kind == "ed25519":
            lib = native.load_prep()
            blobs = [b"".join(x) for x in jobs]
            offsets = native.offsets_of(msgs)
            rows = np.zeros((4, n, 32), np.uint8)
            pre = np.zeros(n, np.uint8)
            u8p = ctypes.POINTER(ctypes.c_uint8)
            t0 = time.perf_counter()
            rc = lib.prepare_batch(*blobs, offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n,
                                   *(x.ctypes.data_as(u8p) for x in rows), pre.ctypes.data_as(ctypes.c_char_p))
            split["c_prepare_s"] = time.perf_counter() - t0
            if rc != 0:
                raise AssertionError(f"native prepare_batch returned {rc}")
        t0 = time.perf_counter()
        a, r, s_rows, k_rows, pre = P.prepare(*jobs)
        t1 = time.perf_counter()
        zk, z, zs = M._rlc_scalars(s_rows, k_rows, n, z_raw)
        t2 = time.perf_counter()
    split.update(prepare_batch_s=t1 - t0, rlc_scalars_s=t2 - t1)
    return (a, r, s_rows, k_rows, pre, zk, z, zs), split


def host_prep(P, jobs, n, z_raw, timed_turns: bool):
    """One plane's host prep of a commit on both routes, the native C and
    the Python that TM_TPU_NATIVE=0 selects, which must give the same rows,
    precheck and scalars byte for byte. With timed_turns, in turns
    HOST_PREP_TURNS, the mean of each route's turns by part; else one turn
    each. Returns the native route's (a, r, zk, z, zs, pre) and the split."""
    import numpy as np

    outs, turns = {}, {"python": [], "native": []}
    for route in HOST_PREP_TURNS if timed_turns else ("python", "native"):
        out, split = host_prep_route(P, jobs, n, z_raw, route == "python")
        turns[route].append(split)
        outs.setdefault(route, out)
    names = ("a", "r", "s", "k", "precheck", "zk", "z", "zs")
    diff = [name for name, x, y in zip(names, outs["python"], outs["native"])
            if x.dtype != y.dtype or x.shape != y.shape or not np.array_equal(x, y)]
    if diff:
        raise AssertionError(f"{P.kind} host prep of {n} rows: the native route differs from the Python "
                             f"route in {diff}")
    split = {}
    for route, splits in turns.items():
        for key in splits[0]:
            split[f"{route}_{key}"] = sum(sp[key] for sp in splits) / len(splits)
    a, r, _, _, pre, zk, z, zs = outs["native"]
    return (a, r, zk, z, zs, pre), split


VALID_CALL_TURNS = ("python", "native", "native", "python", "python", "native")


def valid_call_split(P, chain_id, commit_entry, kind):
    """The valid 10,000-validator verify_commit split into the commit loop
    (sign bytes and bv.add, up to the host prep), the host prep
    (prepare_batch, RLC scalars), the copies to the device (synchronized)
    and the kernel with its sync (launch to collect_rlc's end), each call
    with the launch counts set to 0 just before it and held to one RLC
    launch; in turns VALID_CALL_TURNS, on both host-prep routes, under
    TM_TPU_ENGINE=off: the split instruments direct dispatch. Then the same
    call, native route, through the engine against direct dispatch in the
    turns ENGINE_TURNS. Returns the mean split of each route and the mean
    wall seconds of each mode."""
    import torch

    from tendermint_tpu_torch.ops import msm as M
    from tendermint_tpu_torch.types.validation import verify_commit

    vals, bid, commit = commit_entry
    n = SIZES[-1]
    prep_name = "prepare_batch" if kind == "ed25519" else "prepare_batch_sr"
    marks = {}

    def wrap(name, sync=False):
        fn = getattr(M, name)

        def timed_fn(*args, **kwargs):
            marks[f"{name}_start"] = time.perf_counter()
            out = fn(*args, **kwargs)
            if sync:
                torch.cuda.synchronize()
            marks[f"{name}_end"] = time.perf_counter()
            return out
        return fn, timed_fn

    wrapped = {name: wrap(name, sync) for name, sync in ((prep_name, False), ("_rlc_scalars", False),
                                                         ("_h2d", True), ("collect_rlc", False))}
    splits = {"python": [], "native": []}
    try:
        for name, (_, timed_fn) in wrapped.items():
            setattr(M, name, timed_fn)
        for route in VALID_CALL_TURNS:
            marks.clear()
            with native_setting(route == "python"), env_setting("TM_TPU_ENGINE", "off"):
                t0 = time.perf_counter()
                _, t = drive(f"{kind} valid call on {n} validators ({route} host prep)",
                             lambda: verify_commit(chain_id, vals, bid, commit.height, commit),
                             {P.rlc.__name__: 1}, {})
            m = {k: v - t0 for k, v in marks.items()}
            sp = {"s": t, "commit_loop_s": m[f"{prep_name}_start"],
                  "prepare_batch_s": m[f"{prep_name}_end"] - m[f"{prep_name}_start"],
                  "rlc_scalars_s": m["_rlc_scalars_end"] - m["_rlc_scalars_start"],
                  "h2d_s": m["_h2d_end"] - m["_h2d_start"],
                  "kernel_sync_s": m["collect_rlc_end"] - m["_h2d_end"]}
            sp["rest_s"] = sp["s"] - sum(v for k, v in sp.items() if k != "s")
            splits[route].append(sp)
            log(f"phase 4: {kind} valid {n}-validator call, {route} host prep, seconds: {json.dumps(sp)} "
                f"on {card()}")
    finally:
        for name, (fn, _) in wrapped.items():
            setattr(M, name, fn)
    # the same call through the engine (the default) against direct dispatch
    walls = {"direct": [], "engine": []}
    for mode in ENGINE_TURNS:
        with env_setting("TM_TPU_ENGINE", "off" if mode == "direct" else None):
            _, t = drive(f"{kind} valid call on {n} validators ({mode})",
                         lambda: verify_commit(chain_id, vals, bid, commit.height, commit),
                         {P.rlc.__name__: 1}, {})
        walls[mode].append(t)
    log(f"phase 4: {kind} valid {n}-validator call, native host prep, engine against direct dispatch "
        f"in the turns {ENGINE_TURNS}, ms: {json.dumps({m: [round(x * 1e3, 2) for x in v] for m, v in walls.items()})} "
        f"on {card()}")
    return ({route: {key: sum(sp[key] for sp in v) / len(v) for key in v[0]} for route, v in splits.items()},
            {mode: sum(v) / len(v) for mode, v in walls.items()})


def make_record(fn, splits, n, ms, p_ms, err, ops, nbytes, launches, int32_rate, name=None,
                library_ms=None):
    """One kernel's entry in the kernels record, its bound from this run's
    counts; logged as it is made."""
    name = name or kernel_label(fn, splits)
    b_ms, b_by = bound_ms(ops, nbytes, int32_rate)
    log(f"kernel {name} rows={n} == plain; kernel {ms:.3f} ms, plain {p_ms:.1f} ms, "
        f"bound {b_ms:.4f} ms ({b_by}), {launches} launches on the main path")
    src, replaces = KERNEL_SOURCES[fn.__name__]
    rec = {"name": name, "route": "cuda", "source": f"tendermint_tpu_torch/{src}",
           "replaces": replaces, "launches": launches, "max_abs_err": err, "ms": ms,
           "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms, "rows": n}
    if splits is not None:
        rec["splits"] = splits
    return rec


def expect_bitmap(name, out, pre, n, bad):
    ok = out[:n].cpu().numpy() & pre
    if ok[bad] or int(ok.sum()) != n - 1:
        raise AssertionError(f"{name}: bitmap on the tampered {n}-validator commit has "
                             f"{n - int(ok.sum())} invalid rows, #{bad} valid={bool(ok[bad])}")


def cache_kernels_at_main_path(P, dev, splits, jobs, bad, counts, errs, int32_rate):
    """A plane's cache fill and cache hit at one split, on the rows the
    tampered 1,000-validator commit gives them (1024): the fill against its
    plain version, and the hit through the main path's own cache of that
    split, which the path just filled (its slots and tables as
    dispatch_cached hands them to the kernel); both timed."""
    import numpy as np
    import torch

    from tendermint_tpu_torch.ops import verify as V

    fill, fill_plain, hit, hit_plain = cache_pair(P, splits)
    fill_fn, hit_fn = (P.fill1, P.hit1) if splits == 1 else (P.fill, P.hit)
    n = len(jobs[0])
    a, r, s, k, pre = P.prepare(*jobs)
    k_rows = V.pad_pow2_rows([k], n)[0]
    a, r, s, k = V._to_device(V.pad_pow2_rows([a, r, s, k], n), dev)
    m = len(a)
    (tabs, oks), ms = event_ms(lambda: fill(a), 10)
    (ptabs, poks), p_ms = plain_ms(lambda: fill_plain(a))
    err = check_fill(kernel_label(fill_fn, splits), tabs, oks, ptabs, poks, all_decode=True)
    entry = 4096 * splits
    records = [make_record(fill_fn, splits, m, ms, p_ms, max(err, errs[kernel_label(fill_fn, splits)]),
                           P.ops_fill(m, splits), m * (32 + entry + 1),
                           counts.get(fill_fn.__name__, 0), int32_rate)]
    slots, cache_t, cache_o = P.cache(dev).ensure_snapshot(jobs[0])
    if cache_t.shape[1:] != tabs.shape[1:]:
        raise AssertionError(f"the main path's cache has entries {tuple(cache_t.shape[1:])}, "
                             f"not the split-{splits} entries {tuple(tabs.shape[1:])}")
    (slots,) = V._to_device([np.pad(slots, (0, m - n), mode="edge")], dev)
    args = (cache_t, cache_o, slots, r, s, k)
    got, ms = event_ms(lambda: hit(*args), 10)
    want, p_ms = plain_ms(lambda: hit_plain(*args))
    name = kernel_label(hit_fn, splits)
    if not torch.equal(got, want):
        raise AssertionError(f"{name}: {int((got != want).sum())} rows differ from plain")
    expect_bitmap(name, got, pre, n, bad)
    records.append(make_record(hit_fn, splits, m, ms, p_ms, errs[name], P.ops_hit(m, splits),
                               m * (4 + 96 + 1 + 1) + cache_read_bytes(k_rows, splits),
                               counts.get(hit_fn.__name__, 0), int32_rate))
    return records


def kernels_at_main_path(P, dev, rng, chain_id, commits, bad_index, counts, errs, int32_rate, runs):
    """Hold one plane's kernels against their plain versions on the rows
    phase 3's commits give them (exact equality), check the verdicts, and
    time those same calls."""
    import torch

    from tendermint_tpu_torch.ops import msm as M
    from tendermint_tpu_torch.ops import verify as V

    def cuda(arrays):
        return V._to_device(arrays, dev)

    records = []

    # the uncached bitmap: the tampered 10,000-validator commit (16384 rows)
    n = SIZES[2]
    bad = bad_index[n]
    a, r, s, k, pre = P.prepare(*commit_jobs(commits[n], chain_id, bad))
    rows = cuda(V.pad_pow2_rows([a, r, s, k], n))
    got, ms = event_ms(lambda: P.bitmap(*rows), 5)
    want, p_ms = plain_ms(lambda: P.bitmap_plain(*rows))
    if not torch.equal(got, want):
        raise AssertionError(f"{P.bitmap.__name__}: {int((got != want).sum())} rows differ from plain")
    expect_bitmap(P.bitmap.__name__, got, pre, n, bad)
    m = len(rows[0])
    records.append(make_record(P.bitmap, None, m, ms, p_ms, errs[P.bitmap.__name__], P.ops_bitmap(m),
                               129 * m, counts[P.bitmap.__name__], int32_rate))
    log(f"phase 4: {P.bitmap.__name__} steps at {m} rows, device ms a call: "
        f"{json.dumps(step_times(lambda: P.bitmap(*rows), names=P.bitmap_steps)) or 'not measured'}")

    # the cache fill and the cache hit at the default split: the tampered
    # 1,000-validator commit (1024 rows)
    n = SIZES[1]
    records += cache_kernels_at_main_path(P, dev, DEFAULT_SPLITS, commit_jobs(commits[n], chain_id, bad_index[n]),
                                          bad_index[n], counts, errs, int32_rate)

    # the RLC: the 1,000- and 10,000-validator commits, valid and tampered,
    # with one z_raw for both verdicts; the largest shape is recorded
    for n in SIZES[1:]:
        z_raw = M._ensure_z_raw(n, rng.bytes(16 * n))
        verdicts = {}
        for verdict, bad in (("valid", None), ("tampered", bad_index[n])):
            timed_prep = n == SIZES[-1] and bad is None
            (a, r, zk, z, zs, pre), split = host_prep(P, commit_jobs(commits[n], chain_id, bad), n, z_raw,
                                                      timed_prep)
            if timed_prep:
                runs.append({"plane": P.kind, "commit": n, "run": "host prep of the RLC, native route",
                             "s": split["native_prepare_batch_s"] + split["native_rlc_scalars_s"], **split})
                log(f"phase 4: {P.kind} host prep of the valid {n}-validator commit, the same bytes on both "
                    f"routes, seconds (means of the turns {HOST_PREP_TURNS}): {json.dumps(split)} on {card()}")
            if not pre.all():
                raise AssertionError(f"{P.rlc.__name__}: the {verdict} {n}-validator commit fails the precheck")
            rows = cuda(V.pad_pow2_rows([a, r, zk, z], n) + [zs])
            if bad is None:  # time the valid polarity; it warms the plain version's shapes
                got, ms = event_ms(lambda: P.rlc(*rows), 5)
                want = P.rlc_plain(*rows)
            else:
                got = P.rlc(*rows)
                want, p_ms = plain_ms(lambda: P.rlc_plain(*rows), warm=False)
            if bool(got) != bool(want) or bool(got) != (bad is None):
                raise AssertionError(f"{P.rlc.__name__} ({verdict}, {n} validators): "
                                     f"kernel {bool(got)} plain {bool(want)}")
            verdicts[verdict] = bool(got)
            log(f"phase 4: {P.rlc.__name__} steps at {len(rows[0])} rows ({verdict}), device ms a call: "
                f"{json.dumps(step_times(lambda: P.rlc(*rows))) or 'not measured (no profiler device time)'}")
        m = len(rows[0])
        log(f"phase 4: {P.rlc.__name__} verdicts at {m} rows, same z_raw: {json.dumps(verdicts)}")
        rec = make_record(P.rlc, None, m, ms, p_ms, errs[P.rlc.__name__], P.ops_rlc(m, M._streams(m)),
                          m * (32 + 32 + 32 + 16) + 32 + 1, counts[P.rlc.__name__], int32_rate)

    # the valid 10,000-validator call, split, on both host-prep routes
    n = SIZES[-1]
    splits, walls = valid_call_split(P, chain_id, commits[n], P.kind)
    for route, sp in splits.items():
        runs.append({"plane": P.kind, "commit": n, "run": f"verify_commit valid, split, {route} host prep, "
                     f"mean of {VALID_CALL_TURNS.count(route)}", **sp})
    for mode, t in walls.items():
        runs.append({"plane": P.kind, "commit": n, "run": f"verify_commit valid, native host prep, {mode}, "
                     f"mean of {ENGINE_TURNS.count(mode)}", "s": t})
    return records + [rec]


# -- phase 4 (continued): the RLC and the split hits against the parent tree --

# One turn of the A/B: the RLC kernels, the uncached bitmaps, the fills and
# the cache hits of the tree in argv[1] (its package first on the path),
# timed on the inputs saved in argv[3] with this script's event_ms and
# step_times (argv[2] is this repo's root); in this tree's turns also the
# single-table hits' two-launch layout and block shapes and both designs of
# the single-table fills (build_ab_variants), each fill's bytes held to the
# entry point's; each verdict and bitmap checked; the times, and the ptxas
# reports of the libraries the turn built, written as JSON to argv[4].
AB_SCRIPT = r'''
import hashlib
import importlib.util
import json
import sys

import numpy as np
import torch

tree, root, inputs, out = sys.argv[1:5]
sys.path.insert(0, tree)
spec = importlib.util.spec_from_file_location("chip_smoke_ab", f"{root}/chip_smoke.py")
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
from tendermint_tpu_torch.ops import _build
from tendermint_tpu_torch.ops import msm as M
from tendermint_tpu_torch.ops import verify as V
from tendermint_tpu_torch.ops import verify_sr as VS

reports = _build.build_all(["msm", "msm_sr", "pk_tables", "sr_tables", "verify_cached",
                            "verify_sr_cached", "verify", "verify_sr", "pk_tables_single",
                            "sr_tables_single", "verify_cached_single",
                            "verify_sr_cached_single"])
data = np.load(inputs)
dev = torch.device("cuda", 0)
res = {"ptxas": {name: cs.ptxas_functions(rep) for name, rep in reports.items()}, "ms": {}}
variants = None
if tree == root:
    variants, variant_reports = cs.build_ab_variants(out + ".d")
    res["ptxas"].update(variant_reports)


def fill_digest(tables, oks):
    return hashlib.sha256(tables.cpu().numpy().tobytes() + oks.cpu().numpy().tobytes()).hexdigest()


for key in sorted({f.rsplit("__", 1)[0] for f in data.files}):
    what, plane, m, variant = key.split("__")
    sr = plane == "sr25519"
    if what == "rlc":
        rows = [torch.from_numpy(data[f"{key}__{c}"]).to(dev) for c in cs.AB_RLC_COLS]
        fn = M.msm_verify_sr_kernel if sr else M.msm_verify_kernel
        got, ms = cs.event_ms(lambda: fn(*rows), 10)
        if bool(got) != (variant == "valid"):
            raise SystemExit(f"{tree}: {key}: verdict {bool(got)}")
        res["ms"][key] = {"ms": ms, "steps": cs.step_times(lambda: fn(*rows))}
    elif what == "bitmap":
        rows = [torch.from_numpy(data[f"{key}__{c}"]).to(dev) for c in cs.AB_BITMAP_COLS[:-1]]
        fn = VS.verify_sr_kernel if sr else V.verify_kernel
        got, ms = cs.event_ms(lambda: fn(*rows), 10)
        if not np.array_equal(got.cpu().numpy(), data[f"{key}__want"]):
            raise SystemExit(f"{tree}: {key}: the bitmap differs from this tree's kernel's")
        steps = cs.step_times(lambda: fn(*rows), names=cs.SR_BITMAP_STEPS if sr else cs.BITMAP_STEPS)
        res["ms"][key] = {"ms": ms, "steps": steps}
    elif what == "fill1":
        a = torch.from_numpy(data[f"{key}__a"]).to(dev)
        fill = VS.build_sr_tables if sr else V.build_pk_tables
        (tables, oks), ms = cs.event_ms(lambda: fill(a), 10)
        digest = fill_digest(tables, oks)
        res["ms"][key] = {"ms": ms, "fill_sha256": digest}
        if variants is not None:
            for label, split_decode in (("design_a_ms", False), ("design_b_ms", True)):
                (tables, oks), ms = cs.event_ms(
                    lambda: cs.fill1_design(variants["fill1"], split_decode, sr, a), 10)
                if fill_digest(tables, oks) != digest:
                    raise SystemExit(f"{tree}: {key}: {label[:-3]} writes other bytes than the entry point")
                res["ms"][key][label] = ms
    else:
        a, *args = [torch.from_numpy(data[f"{key}__{c}"]).to(dev) for c in cs.AB_HIT_COLS[:-1]]
        fill, _, fn, _ = cs.cache_pair(cs.plane(plane), int(variant[1:]))
        (tables, oks), fill_ms = cs.event_ms(lambda: fill(a), 10)
        got, ms = cs.event_ms(lambda: fn(tables, oks, *args), 10)
        if not np.array_equal(got.cpu().numpy(), data[f"{key}__want"]):
            raise SystemExit(f"{tree}: {key}: the bitmap differs from this tree's kernel's")
        res["ms"][key] = {"ms": ms, "fill_ms": fill_ms, "fill_sha256": fill_digest(tables, oks)}
        if variant == "S1" and variants is not None:
            runs = {"two_launch_ms": lambda: cs.two_launch_hit(variants["two_launch"], sr, tables, oks, *args)}
            for w in range(1, 5):
                runs[f"w{w}_ms"] = lambda w=w: cs.fixed_w_hit(variants[plane], w, tables, oks, *args)
            for label, call in runs.items():
                got, ms = cs.event_ms(call, 10)
                if not np.array_equal(got.cpu().numpy(), data[f"{key}__want"]):
                    raise SystemExit(f"{tree}: {key}: the bitmap of {label[:-3]} differs")
                res["ms"][key][label] = ms
with open(out, "w") as f:
    json.dump(res, f)
'''
AB_TIMEOUT_S = 600

# The single-table hits' other layout, timed beside them in this tree's A/B
# turns and used nowhere else: a decode step of one thread a row writing
# -R (ed25519) or R (sr25519) and its decode bit to scratch, then a quad a
# row on coop.cuh's window loop under row 1's launch bound (80 registers),
# deciding as the kernels do (csrc/verify_cached_single.cu,
# csrc/verify_sr_cached_single.cu keep the decode in a warp beside the
# ladder instead).
HIT1_TWO_LAUNCH_SRC = r'''
#include <cuda_runtime.h>

#include "coop.cuh"
#include "ristretto.cuh"

template <bool SR>
__global__ void hit1_decode(const uint8_t *r_enc, int32_t *rows, uint8_t *r_oks, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  ge p;
  bool ok;
  if (SR) {
    ok = ristretto_decode(p, r_enc + 32 * i);
  } else {
    ok = ge_decompress(p, r_enc + 32 * i);
    ge_neg(p, p);
  }
  r_oks[i] = ok ? 1 : 0;
  ge_store_row(rows + (size_t)i * 40, p);
}

template <bool SR>
__global__ void __launch_bounds__(128, 6)
    hit1_ladder(const int16_t *tables, const uint8_t *oks, const int32_t *slots,
                const uint8_t *s_bytes, const uint8_t *k_bytes, const int32_t *base_table,
                const int32_t *rows, const uint8_t *r_oks, uint8_t *out, int n, int capacity) {
  __shared__ int32_t sh_b[16 * B_SLOT];
  coop_base_to_shared(sh_b, base_table);
  const int q = threadIdx.x & 3;
  const int row_raw = blockIdx.x * 32 + threadIdx.x / 4, row = min(row_raw, n - 1);
  const int slot = cache_slot(slots[row], capacity);
  const int16_t *entry = tables + (size_t)slot * 16 * 128;
  fe mine;
  coop_straus_with(
      mine, q, sh_b,
      [entry, q](fe &x, fe &y, fe &w, int e) { coop_load_cached(x, y, w, entry, e, q); },
      s_bytes + 32 * row, k_bytes + 32 * row);
  const int32_t *r_row = rows + (size_t)row * 40;
  bool ok;
  if (SR) {
    ge qp, rp;
    fe_shfl(qp.X, mine, 0);
    fe_shfl(qp.Y, mine, 1);
    fe_load_coord(rp.X, r_row, 0, 1);
    fe_load_coord(rp.Y, r_row, 1, 1);
    ok = ristretto_equal(rp, qp);
  } else {
    ok = coop_cofactored_identity(mine, q, r_row);
  }
  if (q == 0 && row_raw < n) out[row] = (oks[slot] && r_oks[row] && ok) ? 1 : 0;
}

template <bool SR>
static int launch(const void *tables, const void *oks, const void *slots, const void *r_enc,
                  const void *s_bytes, const void *k_bytes, const void *base_table,
                  void *scratch, void *out, int n, int capacity, cudaStream_t st) {
  int32_t *rows = (int32_t *)scratch;
  uint8_t *r_oks = (uint8_t *)(rows + (size_t)40 * n);
  hit1_decode<SR><<<grid_for(n, 128), 128, 0, st>>>((const uint8_t *)r_enc, rows, r_oks, n);
  const int rc = (int)cudaGetLastError();
  if (rc) return rc;
  hit1_ladder<SR><<<grid_for(4 * n, 128), 128, 0, st>>>(
      (const int16_t *)tables, (const uint8_t *)oks, (const int32_t *)slots,
      (const uint8_t *)s_bytes, (const uint8_t *)k_bytes, (const int32_t *)base_table, rows,
      r_oks, (uint8_t *)out, n, capacity);
  return (int)cudaGetLastError();
}

extern "C" int tm_hit1_two_launch(int sr, const void *tables, const void *oks, const void *slots,
                                  const void *r_enc, const void *s_bytes, const void *k_bytes,
                                  const void *base_table, void *scratch, void *out, int n,
                                  int capacity, void *stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return sr ? launch<true>(tables, oks, slots, r_enc, s_bytes, k_bytes, base_table, scratch, out,
                           n, capacity, st)
            : launch<false>(tables, oks, slots, r_enc, s_bytes, k_bytes, base_table, scratch, out,
                            n, capacity, st);
}
'''


# An entry point appended to a single-table hit's source, taking the
# ladder warps a block (W) from its caller instead of coop.cuh hit1_warps,
# so that the A/B times the kernel at each block shape.
HIT1_FIXED_W_SRC = r'''
extern "C" int tm_hit1_fixed_w(int warps, const void *tables, const void *oks, const void *slots,
                               const void *r_enc, const void *s_bytes, const void *k_bytes,
                               const void *base_table, void *out, int n, int capacity,
                               void *stream) {
  KERNEL<<<grid_for(n, warps * HIT1_ROWS), 32 * (warps + 1), 0, (cudaStream_t)stream>>>(
      (const int16_t *)tables, (const uint8_t *)oks, (const int32_t *)slots,
      (const uint8_t *)r_enc, (const uint8_t *)s_bytes, (const uint8_t *)k_bytes,
      (const int32_t *)base_table, (uint8_t *)out, n, capacity);
  return (int)cudaGetLastError();
}
'''
HIT1_KERNELS = {"ed25519": ("verify_cached_single", "verify_cached_single_rows"),
                "sr25519": ("verify_sr_cached_single", "verify_sr_cached_single_rows")}


# Both designs of the single-table fills, for this tree's A/B turns and
# nowhere else: a quad a key on coop.cuh's coop_fill at S = 1, decoding with
# the one-lane decoders (design A: ge_decompress, ristretto_decode, the four
# lanes running one chain each) or with coop_decode.cuh's quad-split ones
# (design B); csrc/pk_tables_single.cu and csrc/sr_tables_single.cu launch
# design B. Beside them one field product a thread (fe_mul, coop_fe_mul,
# coop_fe_sq), never launched, whose instructions cuobjdump counts.
FILL1_DESIGNS_SRC = r'''
#include <cuda_runtime.h>

#include "coop_decode.cuh"

template <int WHICH>
__global__ void product_probe(const int32_t *in, int32_t *out) {
  fe f, g, h;
  fe_load_coord(f, in, 0, 1);
  fe_load_coord(g, in, 1, 1);
  const int q = threadIdx.x & 3;
  if constexpr (WHICH == 0)
    fe_mul(h, f, g);
  else if constexpr (WHICH == 1)
    coop_fe_mul(h, f, g, q);
  else
    coop_fe_sq(h, f, q);
  fe_store_coord(out, threadIdx.x, h);
}
template __global__ void product_probe<0>(const int32_t *, int32_t *);
template __global__ void product_probe<1>(const int32_t *, int32_t *);
template __global__ void product_probe<2>(const int32_t *, int32_t *);

template <bool SPLIT_DECODE, bool SR>
__global__ void __launch_bounds__(COOP_FILL_THREADS, 10)
    fill1_design(const uint8_t *a_enc, int16_t *tables, uint8_t *oks, int n) {
  coop_fill(
      [](ge &p, const uint8_t *enc) {
        if constexpr (SR)
          return SPLIT_DECODE ? coop_ristretto_decode(p, enc) : ristretto_decode(p, enc);
        else
          return SPLIT_DECODE ? coop_ge_decompress(p, enc) : ge_decompress(p, enc);
      },
      a_enc, tables, oks, n, 1);
}

template <bool SPLIT_DECODE, bool SR>
static int launch(const void *a_enc, void *tables, void *oks, int n, cudaStream_t st) {
  fill1_design<SPLIT_DECODE, SR><<<grid_for(4 * n, COOP_FILL_THREADS), COOP_FILL_THREADS, 0, st>>>(
      (const uint8_t *)a_enc, (int16_t *)tables, (uint8_t *)oks, n);
  return (int)cudaGetLastError();
}

extern "C" int tm_fill1_design(int split_decode, int sr, const void *a_enc, void *tables,
                               void *oks, int n, void *stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (split_decode)
    return sr ? launch<true, true>(a_enc, tables, oks, n, st) : launch<true, false>(a_enc, tables, oks, n, st);
  return sr ? launch<false, true>(a_enc, tables, oks, n, st) : launch<false, false>(a_enc, tables, oks, n, st);
}
'''


def build_ab_variants(workdir: str):
    # the A/B's variants built against the imported package's csrc/ with its
    # nvcc flags, one nvcc each, all at once: the single-table hits' two-
    # launch layout (HIT1_TWO_LAUNCH_SRC), each plane's hit with
    # HIT1_FIXED_W_SRC, and the single-table fills' two designs
    # (FILL1_DESIGNS_SRC); returns ({"two_launch", "fill1" or plane: loaded
    # library}, {"hit1_two_launch", "fill1_designs": ptxas report parsed,
    # "fill1_sass": the fill source's SASS counts})
    import ctypes

    from tendermint_tpu_torch.ops import _build

    os.makedirs(workdir, exist_ok=True)
    sources = {"two_launch": HIT1_TWO_LAUNCH_SRC, "fill1": FILL1_DESIGNS_SRC}
    for kind, (name, kernel) in HIT1_KERNELS.items():
        with open(_build.CSRC / f"{name}.cu") as f:
            sources[kind] = f.read() + HIT1_FIXED_W_SRC.replace("KERNEL", kernel)
    procs = {}
    for kind, text in sources.items():
        src, lib = os.path.join(workdir, f"variant_{kind}.cu"), os.path.join(workdir, f"variant_{kind}.so")
        with open(src, "w") as f:
            f.write(text)
        procs[kind] = lib, subprocess.Popen(
            [_build._nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
             "-Xptxas", "-v", "-I", str(_build.CSRC), "-o", lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs, reports = {}, {}
    for kind, (lib, proc) in procs.items():
        log_text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the A/B variant {kind} "
                               f"(rc {proc.returncode}):\n{log_text}")
        so = libs[kind] = ctypes.CDLL(lib)
        if kind == "fill1":
            reports["fill1_designs"] = ptxas_functions(log_text)
            reports["fill1_sass"] = sass_counts(lib)
            so.tm_fill1_design.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 3
                                           + [ctypes.c_int, ctypes.c_void_p])
            so.tm_fill1_design.restype = ctypes.c_int
        elif kind == "two_launch":
            reports["hit1_two_launch"] = ptxas_functions(log_text)
            so.tm_hit1_two_launch.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 9
                                              + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
            so.tm_hit1_two_launch.restype = ctypes.c_int
        else:
            so.tm_hit1_fixed_w.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 8
                                           + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
            so.tm_hit1_fixed_w.restype = ctypes.c_int
    return libs, reports


PRODUCT_PROBES = {"product_probe<0>": "fe_mul", "product_probe<1>": "coop_fe_mul",
                  "product_probe<2>": "coop_fe_sq"}


def sass_counts(lib: str):
    """{kernel: {"instructions": n, opcode: n, ...}} of a library's SASS
    (cuobjdump -sass), NOPs left out, names as ptxas_functions gives them."""
    from tendermint_tpu_torch.ops import _build

    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True, check=True).stdout
    out, fn = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = ptxas_functions(f"Function properties for {m.group(1)}\nUsed 0 registers")[0][0]
            out[fn] = {"instructions": 0}
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if m and fn and m.group(1) != "NOP":
            op = m.group(1).split(".")[0] + (".WIDE" if ".WIDE" in m.group(1) else "")
            out[fn]["instructions"] += 1
            out[fn][op] = out[fn].get(op, 0) + 1
    return out


def fill1_design(so, split_decode: bool, sr: bool, a):
    # a single-table fill's (tables, decode bits) by design B (split_decode)
    # or A, on CUDA tensors
    import torch

    from tendermint_tpu_torch.ops import _build

    n = a.shape[0]
    tables = torch.empty((n, 16, 4, 32), dtype=torch.int16, device=a.device)
    oks = torch.empty(n, dtype=torch.bool, device=a.device)
    rc = so.tm_fill1_design(int(split_decode), int(sr), a.data_ptr(), tables.data_ptr(),
                            oks.data_ptr(), n, _build.stream_of(a))
    _build.check(rc, f"the single-table fill's design {'B' if split_decode else 'A'}")
    return tables, oks


def fixed_w_hit(so, warps: int, tables, oks, slots, r, s, k):
    # a single-table hit's bitmap by its kernel at W ladder warps a block
    import torch

    from tendermint_tpu_torch.ops import _build
    from tendermint_tpu_torch.ops import verify as V

    out = torch.empty(r.shape[0], dtype=torch.bool, device=r.device)
    rc = so.tm_hit1_fixed_w(warps, tables.data_ptr(), oks.data_ptr(), slots.data_ptr(), r.data_ptr(),
                            s.data_ptr(), k.data_ptr(), V.device_table("base", r.device).data_ptr(),
                            out.data_ptr(), r.shape[0], tables.shape[0], _build.stream_of(r))
    _build.check(rc, f"the single-table hit at W = {warps}")
    return out


def two_launch_hit(so, sr: bool, tables, oks, slots, r, s, k):
    # the single-table hit's bitmap by the two-launch layout, on CUDA tensors
    import torch

    from tendermint_tpu_torch.ops import _build
    from tendermint_tpu_torch.ops import verify as V

    n = r.shape[0]
    out = torch.empty(n, dtype=torch.bool, device=r.device)
    scratch = torch.empty(40 * n + (n + 3) // 4, dtype=torch.int32, device=r.device)
    rc = so.tm_hit1_two_launch(int(sr), tables.data_ptr(), oks.data_ptr(), slots.data_ptr(),
                               r.data_ptr(), s.data_ptr(), k.data_ptr(),
                               V.device_table("base", r.device).data_ptr(), scratch.data_ptr(),
                               out.data_ptr(), n, tables.shape[0], _build.stream_of(r))
    _build.check(rc, "the two-launch single-table hit")
    return out
AB_RLC_COLS = ("a", "r", "zk", "z", "zs")
AB_HIT_COLS = ("a", "slots", "r", "s", "k", "want")
AB_HIT_SPLITS = (2, 4, 8)
AB_BITMAP_COLS = ("a", "r", "s", "k", "want")


def ab_inputs(planes, dev, chain_id, commits, bad_index, rng):
    """The A/B's inputs as named arrays: the RLC's rows of the 1,000- and
    10,000-validator commits (1,024 and 16,384), valid and tampered with
    one z_raw; the cache hits' rows of the tampered 1,000-validator commit
    (1,024) at S = 1, 2, 4 and 8, and of the tampered 10,000-validator one
    at row 15's shapes (10,240 rows and the 2,560-row shard of the bad row)
    at S = 1 and 4, each with the keys its cache holds (slot i for key i)
    and the bitmap this tree's hit gives them; each turn fills the tables
    with its tree's fill, timed (the split fills, rows 2 and 12, at 1,024
    keys and S = 2, 4, 8 and at 10,240 keys and S = 4; the single-table
    fills at S = 1) and hashed, for the two trees' fills must write the
    same bytes; the same 1,024 keys for the
    single-table fills (rows 5 and 10), timed and hashed, and at 4,096 and
    10,240 keys of the 10,000-validator commit; and the uncached
    bitmaps' rows (rows 1 and 9) of the tampered 10,000-validator commit at
    16,384 (verify_commit's), 10,240 and 2,560 (row 14's) and 8 rows (the
    autotune's size), with this tree's bitmap."""
    import numpy as np

    from tendermint_tpu_torch.ops import msm as M
    from tendermint_tpu_torch.ops import verify as V
    from tendermint_tpu_torch.parallel import sharded_verify as SV

    arrays = {}
    for kind, P in planes.items():
        for n in SIZES[1:]:
            z_raw = M._ensure_z_raw(n, rng.bytes(16 * n))
            for verdict, bad in (("valid", None), ("tampered", bad_index[n])):
                (a, r, zk, z, zs, _), _ = host_prep(P, commit_jobs(commits[kind][n], chain_id, bad), n, z_raw)
                rows = V.pad_pow2_rows([a, r, zk, z], n) + [zs]
                for col, x in zip(AB_RLC_COLS, rows):
                    arrays[f"rlc__{kind}__{len(rows[0])}__{verdict}__{col}"] = x
        n = SIZES[2]
        bad = bad_index[n]
        a, r, s, k, _ = P.prepare(*commit_jobs(commits[kind][n], chain_id, bad))
        m, q = SV.shard_rows(n, 1), SV.shard_rows(n, 4)
        shard = SV._pad_rows([a, r, s, k], m)
        for rows in (V.pad_pow2_rows([a, r, s, k], n), shard,
                     [x[bad // q * q:(bad // q + 1) * q] for x in shard], [x[:8] for x in shard]):
            rows = [np.ascontiguousarray(x) for x in rows]
            want = P.bitmap(*V._to_device(rows, dev)).cpu().numpy()
            for col, x in zip(AB_BITMAP_COLS, rows + [want]):
                arrays[f"bitmap__{kind}__{len(rows[0])}__rows__{col}"] = x
        for n, splits_list in ((SIZES[1], (1,) + AB_HIT_SPLITS), (SIZES[2], (1, DEFAULT_SPLITS))):
            bad = bad_index[n]
            a, r, s, k, _ = P.prepare(*commit_jobs(commits[kind][n], chain_id, bad))
            if n == SIZES[2]:  # row 15's shapes: 10,240 rows and the 2,560-row shard of the bad row
                m, q = SV.shard_rows(n, 1), SV.shard_rows(n, 4)
                a, r, s, k = SV._pad_rows([a, r, s, k], m)
                shapes = (slice(0, m), slice(bad // q * q, (bad // q + 1) * q))
                # the single-table fills at row 15's 10,240 keys and at
                # PubkeyCache's default capacity, the largest fill a real
                # cache takes
                for keys in (m, 4096):
                    arrays[f"fill1__{kind}__{keys}__S1__a"] = np.ascontiguousarray(a[:keys])
            else:
                a, r, s, k = V.pad_pow2_rows([a, r, s, k], n)
                shapes = (slice(0, len(a)),)
                arrays[f"fill1__{kind}__{len(a)}__S1__a"] = a
            (a_d,) = V._to_device([a], dev)
            for splits in splits_list:
                fill, _, hit, _ = cache_pair(P, splits)
                tables, oks = fill(a_d)
                for sl in shapes:
                    slots = np.arange(len(a), dtype=np.int32)[sl]
                    args = V._to_device([slots, r[sl], s[sl], k[sl]], dev)
                    key = f"hit__{kind}__{len(slots)}__S{splits}"
                    want = hit(tables, oks, *args).cpu().numpy()
                    for col, x in zip(AB_HIT_COLS, (a, slots, r[sl], s[sl], k[sl], want)):
                        arrays[f"{key}__{col}"] = x
    return arrays


def ab_parent(planes, dev, chain_id, commits, bad_index, rng, parent, tmp):
    """Kernels 4 and 8, the uncached bitmaps (kernels 1 and 9, and row 14's
    shapes), the fills (the split kernels 2 and 12 and the single-table
    kernels 5 and 10, whose tables must hash the same in every turn) and
    the cache hits (the split kernels 3 and 13, the single-table kernels 6
    and 11, and row 15's shapes) of the parent tree (its package at
    `parent`) against this tree's, in turns parent, new, new, parent, each
    turn a process of its own, on ab_inputs' rows: mean ms of 10 launches
    by CUDA events, the RLC's and the bitmaps' steps by torch.profiler;
    in this tree's turns, beside the single-table hits their two-launch
    layout (HIT1_TWO_LAUNCH_SRC) and block shapes on the same rows, and
    beside the single-table fills both designs (FILL1_DESIGNS_SRC) on the
    same keys. Logs each tree's ptxas report of the bitmaps, the fills and
    the hits and the SASS counts of the fill designs and one field product,
    one line an input, and returns the turns."""
    import numpy as np
    import torch

    inputs = os.path.join(tmp, "ab_inputs.npz")
    np.savez(inputs, **ab_inputs(planes, dev, chain_id, commits, bad_index, rng))
    script = os.path.join(tmp, "ab.py")
    with open(script, "w") as f:
        f.write(AB_SCRIPT)
    turns = []
    for i, (label, tree) in enumerate((("parent", parent), ("new", ROOT), ("new", ROOT), ("parent", parent))):
        out = os.path.join(tmp, f"ab{i}.json")
        proc = subprocess.run([sys.executable, script, tree, ROOT, inputs, out], cwd=tree,
                              capture_output=True, text=True, timeout=AB_TIMEOUT_S)
        if proc.returncode != 0:
            raise AssertionError(f"A/B turn {i} ({label}, {tree}) failed (rc {proc.returncode}):\n"
                                 f"{(proc.stdout + proc.stderr)[-3000:]}")
        with open(out) as f:
            turns.append((label, json.load(f)))
    logged = set()  # a tree's turns build the same variants: one line each
    for label, res in turns:
        for fn, counts in res["ptxas"].get("fill1_sass", {}).items():
            if (fn in PRODUCT_PROBES or fn.startswith("fill1_design")) and (label, fn) not in logged:
                logged.add((label, fn))
                ops = {op: n for op, n in counts.items() if op in ("IMAD", "IMAD.WIDE", "SHFL", "SEL")}
                log(f"ab: {label} tree SASS of {PRODUCT_PROBES.get(fn, fn)}: {counts['instructions']} "
                    f"instructions, {json.dumps(ops)}")
        for name, fns in res["ptxas"].items():
            if name in ("verify_cached", "verify_sr_cached", "verify", "verify_sr", "pk_tables",
                        "sr_tables", "pk_tables_single", "sr_tables_single", "verify_cached_single",
                        "verify_sr_cached_single", "hit1_two_launch", "fill1_designs"):
                for fn, regs, spills in fns:
                    if (label, name, fn) not in logged:
                        logged.add((label, name, fn))
                        log(f"ab: {label} tree {name}: {fn}: {regs} registers, {spills}")
    data = np.load(inputs)
    for key in turns[0][1]["ms"]:
        ms = {label: " / ".join("%.3f" % t["ms"][key]["ms"] for lab, t in turns if lab == label)
              for label in ("parent", "new")}
        what, plane, rows, variant = key.split("__")
        if what == "rlc":
            steps = {label: next(t["ms"][key]["steps"] for lab, t in turns if lab == label)
                     for label in ("parent", "new")}
            log(f"ab: {plane} RLC {rows} rows {variant}, ms a call (turns 1 and 4 / 2 and 3): parent "
                f"{ms['parent']}, new {ms['new']}; steps parent {json.dumps(steps['parent'])} "
                f"new {json.dumps(steps['new'])}")
        elif what == "bitmap":
            steps = {label: next(t["ms"][key]["steps"] for lab, t in turns if lab == label)
                     for label in ("parent", "new")}
            log(f"ab: {plane} uncached bitmap {rows} rows, ms a call (turns 1 and 4 / 2 and 3): parent "
                f"{ms['parent']}, new {ms['new']}; steps parent {json.dumps(steps['parent'])} "
                f"new {json.dumps(steps['new'])}")
        elif what == "fill1":
            digests = {t["ms"][key]["fill_sha256"] for _, t in turns}
            if len(digests) != 1:
                raise AssertionError(f"ab: {plane} single-table fill: the trees' tables differ ({digests})")
            designs = {c: " / ".join("%.3f" % t["ms"][key][c] for lab, t in turns if lab == "new")
                       for c in ("design_a_ms", "design_b_ms")}
            log(f"ab: {plane} single-table fill {rows} keys, ms a call (turns 1 and 4 / 2 and 3): parent "
                f"{ms['parent']}, new {ms['new']}; in turns 2 and 3 design A (one-lane decoders) "
                f"{designs['design_a_ms']}, design B (quad-split decoders) {designs['design_b_ms']}; "
                f"tables and decode bits byte-identical in all four turns and under both designs")
        else:
            kind = "single-table hit" if variant == "S1" else "split hit"
            log(f"ab: {plane} {kind} {rows} rows {variant[0]} = {variant[1:]}, ms a call (turns 1 and "
                f"4 / 2 and 3): parent {ms['parent']}, new {ms['new']}; bitmaps equal in all four turns")
            if variant == "S1":
                new = {c: " / ".join("%.3f" % t["ms"][key][c] for lab, t in turns if lab == "new")
                       for c in ("two_launch_ms", "w1_ms", "w2_ms", "w3_ms", "w4_ms")}
                w = 3 if -(-int(rows) // (3 * 8)) <= torch.cuda.get_device_properties(0).multi_processor_count else 4
                log(f"ab: {plane} single-table hit {rows} rows, ms a call (turns 2 and 3): the two-launch "
                    f"layout (a decode step, then the quad ladder) {new['two_launch_ms']}; this tree's "
                    f"kernel at W = 1, 2, 3, 4 ladder warps a block {new['w1_ms']}, {new['w2_ms']}, "
                    f"{new['w3_ms']}, {new['w4_ms']} (the entry point takes W = {w}); bitmaps equal")
            digests = {t["ms"][key]["fill_sha256"] for _, t in turns}
            if len(digests) != 1:
                raise AssertionError(f"ab: {plane} fill for {key}: the trees' tables differ ({digests})")
            if len(data[f"{key}__a"]) == int(rows):
                fill_ms = {label: " / ".join("%.3f" % t["ms"][key]["fill_ms"] for lab, t in turns
                                             if lab == label) for label in ("parent", "new")}
                kind = "single-table fill" if variant == "S1" else "split fill"
                log(f"ab: {plane} {kind} {rows} keys {variant[0]} = {variant[1:]}, ms a call (turns "
                    f"1 and 4 / 2 and 3): parent {fill_ms['parent']}, new {fill_ms['new']}; tables and "
                    f"decode bits byte-identical in all four turns")
    return turns


# -- phase 5: the other cache geometries --------------------------------------


def geometry_path(planes, dev, chain_id, commits, bad_index, errs, int32_rate, runs):
    """For S = 1, 2 and 8 (TM_TPU_PK_SPLIT), on each plane: verify_commit on
    the 150-validator commit (fill, then hit, through a new cache of that
    split) and on the tampered 1,000-validator commit (the RLC, then fill
    and hit), exact launches each; then the split's fill and hit against
    their plain versions on the rows that commit gives them, timed."""
    from tendermint_tpu_torch.types.validation import verify_commit

    small, mid, _ = SIZES
    records = []
    for splits in OTHER_SPLITS:
        os.environ["TM_TPU_PK_SPLIT"] = str(splits)
        for kind, P in planes.items():
            fill, hit = (P.fill1, P.hit1) if splits == 1 else (P.fill, P.hit)
            totals = {}
            want = [{fill.__name__: 1, hit.__name__: 1},
                    {P.rlc.__name__: 1, fill.__name__: 1, hit.__name__: 1}]
            what = f"phase 5: {kind} S={splits}"
            vals, bid, commit = commits[kind][small]
            _, t = drive(f"{what} valid call on {small} validators",
                         lambda: verify_commit(chain_id, vals, bid, commit.height, commit), want[0], totals)
            runs.append({"plane": kind, "commit": small, "splits": splits, "run": "verify_commit valid",
                         "s": t})
            msg, t = verify_tampered(chain_id, commits[kind][mid], bad_index[mid], lambda fn: drive(
                f"{what} tampered call on {mid} validators", fn, want[1], totals))
            runs.append({"plane": kind, "commit": mid, "splits": splits,
                         "run": f"verify_commit tampered #{bad_index[mid]}", "s": t})
            check_path(what, totals, want)
            records += cache_kernels_at_main_path(
                P, dev, splits, commit_jobs(commits[kind][mid], chain_id, bad_index[mid]),
                bad_index[mid], totals, errs, int32_rate)
    os.environ["TM_TPU_PK_SPLIT"] = str(DEFAULT_SPLITS)
    return records


# -- phase 6: the cached RLC --------------------------------------------------


def rlc_cache_path(P, dev, rng, chain_id, commits, bad_index, errs, int32_rate, runs):
    """TM_TPU_MSM_CACHE=on on the ed25519 plane. For S = 2, 4 and 8, each
    through a new cache: the valid 1,000-validator commit with the knob off
    (the uncached RLC), then on (the fill and the cached RLC), then on
    again (the cached RLC alone); the tampered one (the cached RLC, then
    the cache hit); the 10,000-validator commit, whose keys overflow the
    cache (the uncached RLC). At S = 1 the knob takes the uncached RLC.
    Then the cached RLC against its plain version on the 1,000-validator
    commit's rows in both verdicts with one z_raw, timed."""
    import numpy as np

    from tendermint_tpu_torch.ops import msm as M
    from tendermint_tpu_torch.ops import verify as V
    from tendermint_tpu_torch.types.validation import verify_commit

    small, mid, large = SIZES
    rlc, cached = P.rlc.__name__, M.msm_verify_kernel_cached.__name__
    records = []

    def valid(n):
        vals, bid, commit = commits[n]
        return lambda: verify_commit(chain_id, vals, bid, commit.height, commit)

    for splits in RLC_CACHE_SPLITS + (1,):
        os.environ["TM_TPU_PK_SPLIT"] = str(splits)
        V._PK_CACHES.clear()  # a new cache of this split
        what = f"phase 6: S={splits}"
        totals = {}
        if splits == 1:
            os.environ["TM_TPU_MSM_CACHE"] = "on"
            drive(f"{what} valid call on {mid} validators", valid(mid), {rlc: 1}, totals)
            check_path(what, totals, [{rlc: 1}])
            continue
        fill, hit = P.fill.__name__, P.hit.__name__
        want = [{rlc: 1}, {fill: 1, cached: 1}, {cached: 1}, {cached: 1, hit: 1}, {rlc: 1}]
        os.environ["TM_TPU_MSM_CACHE"] = "off"
        _, t_off = drive(f"{what} MSM_CACHE=off valid call on {mid} validators", valid(mid), want[0], totals)
        os.environ["TM_TPU_MSM_CACHE"] = "on"
        _, t_fill = drive(f"{what} first valid call on {mid} validators", valid(mid), want[1], totals)
        _, t_on = drive(f"{what} second valid call on {mid} validators", valid(mid), want[2], totals)
        runs.append({"plane": P.kind, "commit": mid, "splits": splits,
                     "run": "verify_commit valid: RLC uncached / cached with fill / cached",
                     "s": t_on, "uncached_s": t_off, "fill_s": t_fill})
        verify_tampered(chain_id, commits[mid], bad_index[mid], lambda fn: drive(
            f"{what} tampered call on {mid} validators", fn, want[3], totals))
        drive(f"{what} valid call on {large} validators", valid(large), want[4], totals)
        check_path(what, totals, want)

        # kernel 7 on the 1,000-validator commit's rows, valid and tampered
        jobs = commit_jobs(commits[mid], chain_id)
        slots, cache_t, cache_o = P.cache(dev).ensure_snapshot(jobs[0])
        z_raw = M._ensure_z_raw(mid, rng.bytes(16 * mid))
        verdicts = {}
        for verdict, bad in (("valid", None), ("tampered", bad_index[mid])):
            _, r, s_rows, k_rows, pre = P.prepare(*commit_jobs(commits[mid], chain_id, bad))
            zk, z, zs = M._rlc_scalars(s_rows, k_rows, mid, z_raw)
            r, zk, z = V.pad_pow2_rows([r, zk, z], mid)
            m = len(r)
            args = V._to_device([np.pad(slots, (0, m - mid), mode="edge"), r, zk, z, zs], dev)
            if bad is None:
                got, ms = event_ms(lambda: M.msm_verify_kernel_cached(cache_t, cache_o, *args), 5)
                want_v, p_ms = plain_ms(lambda: M.msm_verify_kernel_cached_plain(cache_t, cache_o, *args))
                zk_rows = zk
            else:
                got = M.msm_verify_kernel_cached(cache_t, cache_o, *args)
                want_v = M.msm_verify_kernel_cached_plain(cache_t, cache_o, *args)
            if bool(got) != bool(want_v) or bool(got) != (bad is None):
                raise AssertionError(f"{kernel_label(M.msm_verify_kernel_cached, splits)} ({verdict}): "
                                     f"kernel {bool(got)} plain {bool(want_v)}")
            verdicts[verdict] = bool(got)
        log(f"{what}: {cached} verdicts at {m} rows, same z_raw: {json.dumps(verdicts)}")
        name = kernel_label(M.msm_verify_kernel_cached, splits)
        records.append(make_record(
            M.msm_verify_kernel_cached, splits, m, ms, p_ms, errs[name],
            ops_msm_cached(m, M._streams(m), splits),
            m * (4 + 32 + 32 + 16 + 1) + 32 + 1 + cache_read_bytes(zk_rows, splits),
            totals[cached], int32_rate))
    os.environ.pop("TM_TPU_MSM_CACHE", None)
    os.environ["TM_TPU_PK_SPLIT"] = str(DEFAULT_SPLITS)
    V._PK_CACHES.clear()
    return records


# -- phase 2 (continued): fail_count ---------------------------------------------


def check_fail_count(rng, dev):
    """fail_count against its plain version on edge inputs: bitmaps of B in
    1, 8, 255, 256 and 10,240 rows (bool and uint8) all true, all false,
    false at row 0 alone, at row B - 1 alone, and random; a () verdict of
    each value; int32 vectors of 1 to 8 counts."""
    import numpy as np
    import torch

    from tendermint_tpu_torch.parallel import sharded_verify as SV

    cases = []
    for b in (1, 8, 255, 256, 10240):
        for pattern in ("all true", "all false", "false at 0", "false at B-1", "random"):
            ok = np.ones(b, bool)
            if pattern == "all false":
                ok[:] = False
            elif pattern == "false at 0":
                ok[0] = False
            elif pattern == "false at B-1":
                ok[-1] = False
            elif pattern == "random":
                ok = rng.random(b) < 0.9
            cases += [(f"{pattern}, B={b}", torch.from_numpy(ok).to(dev)),
                      (f"{pattern}, B={b}, uint8", torch.from_numpy(ok.astype(np.uint8)).to(dev))]
    cases += [(f"verdict {v}", torch.tensor(v, device=dev)) for v in (True, False)]
    cases += [(f"{k} counts", torch.from_numpy(rng.integers(0, 10241, k).astype(np.int32)).to(dev))
              for k in range(1, 9)]
    for what, x in cases:
        got, want = SV.fail_count(x), SV.fail_count_plain(x)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"fail_count on {what}: kernel {got.tolist()} plain {want.tolist()}")
    log(f"phase 2: fail_count == plain on {len(cases)} edge inputs (bitmaps of 1-10,240 rows, "
        f"verdicts, 1-8 counts)")
    return {"fail_count": 0}


# -- phase 7: the sharded path ---------------------------------------------------

# One rank of verify_batch_sharded_local: joins the group (gloo when the
# backend device is "cpu", NCCL otherwise), verifies its quarter of the jobs
# in the .npz on the card and writes its bitmap, verdict, backend and launches.
RANK_SCRIPT = r'''
import sys

import numpy as np
import torch


def unpack(flat, lengths):
    ends = np.cumsum(lengths)
    return [flat[e - n:e].tobytes() for e, n in zip(ends, lengths)]


def rank_main(rank, world, init, backend_device, mesh_device, path, out_dir):
    import torch.distributed as dist

    from tendermint_tpu_torch.ops import verify as V
    from tendermint_tpu_torch.parallel import multihost as mh
    from tendermint_tpu_torch.parallel import sharded_verify as SV

    mh.initialize(init, world, rank, device=backend_device)
    mesh = mh.global_mesh(device=mesh_device)
    data = np.load(path)
    cols = [unpack(data[c], data[c + "_len"]) for c in ("pk", "msg", "sig")]
    per = len(cols[0]) // world
    V.verify_kernel.launches = SV.fail_count.launches = 0
    bitmap, ok = mh.verify_batch_sharded_local(mesh, *(c[rank * per:(rank + 1) * per] for c in cols))
    torch.cuda.synchronize()
    np.savez(f"{out_dir}/rank{rank}.npz", bitmap=bitmap, ok=np.array(ok),
             backend=np.array(dist.get_backend()),
             launches=np.array([V.verify_kernel.launches, SV.fail_count.launches]))
    dist.destroy_process_group()


if __name__ == "__main__":
    import torch.multiprocessing as mp

    world = int(sys.argv[1])
    mp.spawn(rank_main, args=(world, *sys.argv[2:]), nprocs=world, join=True)
'''
RANK_TIMEOUT_S = 300


def _pack(items):
    import numpy as np

    return np.frombuffer(b"".join(items), np.uint8), np.array([len(x) for x in items], np.int64)


def run_ranks(tmp, world, backend_device, mesh_device, jobs):
    """verify_batch_sharded_local in `world` rank processes, each holding its
    share of `jobs`; fatal on failure or past RANK_TIMEOUT_S (the launcher's
    whole process group is killed). Returns each rank's saved outputs."""
    import signal

    import numpy as np

    run = os.path.join(tmp, f"{backend_device}-{world}")
    os.makedirs(run)
    arrays = {}
    for col, items in zip(("pk", "msg", "sig"), jobs):
        arrays[col], arrays[col + "_len"] = _pack(items)
    np.savez(os.path.join(run, "jobs.npz"), **arrays)
    script = os.path.join(run, "ranks.py")
    with open(script, "w") as f:
        f.write(RANK_SCRIPT)
    env = dict(os.environ, PYTHONPATH=ROOT)
    cmd = [sys.executable, script, str(world), f"file://{run}/rendezvous", backend_device, mesh_device,
           os.path.join(run, "jobs.npz"), run]
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=RANK_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        raise AssertionError(f"{world} ranks ({backend_device}) hung past {RANK_TIMEOUT_S} s:\n"
                             f"{out[-3000:]}") from None
    if proc.returncode != 0:
        raise AssertionError(f"{world} ranks ({backend_device}) failed (rc {proc.returncode}):\n"
                             f"{out[-3000:]}")
    return [np.load(os.path.join(run, f"rank{r}.npz")) for r in range(world)]


def expect_sharded(what, bitmap, ok, n, bad):
    """A sharded call's (bitmap, verdict): every row valid and True, or row
    #bad alone invalid and False."""
    invalid = [i for i in range(n) if not bitmap[i]]
    if len(bitmap) != n or invalid != ([] if bad is None else [bad]) or ok is not (bad is None):
        raise AssertionError(f"{what}: {len(bitmap)} rows, invalid {invalid[:8]}, verdict {ok}; "
                             f"expected {n} rows, invalid {[] if bad is None else [bad]}")


def sharded_path(planes, meshes, dev, rng, chain_id, commits, bad_index, runs, tmp):
    """Phase 7's calls, each with every launch counter set to 0 just before
    it and read just after and held to its exact launches and sharded entry
    point; returns the summed launches."""
    import numpy as np

    from tendermint_tpu_torch.ops import msm as M
    from tendermint_tpu_torch.ops import verify as V
    from tendermint_tpu_torch.parallel import sharded_verify as SV

    small, mid, large = SIZES
    fc = SV.fail_count.__name__
    totals, expected = {}, []

    def run(what, fn, want, entries):
        expected.append(want)
        return drive(f"phase 7: {what}", fn, want, totals, entries)

    # row 14: the bitmap plane on the 10,000-validator commits; the bitmap
    # equals the single-card one
    whole = {}
    for kind, P in planes.items():
        for verdict, bad in (("valid", None), ("tampered", bad_index[large])):
            jobs = commit_jobs(commits[kind][large], chain_id, bad)
            single = P.batch(*jobs, device=dev)
            for label, mesh in meshes.items():
                what = f"{kind} verify_batch_sharded on the {verdict} {large}-validator commit, mesh of {label}"
                (bitmap, ok), t = run(what, lambda: SV.verify_batch_sharded(mesh, *jobs, key_type=kind),
                                      {P.bitmap.__name__: mesh.size, fc: mesh.size + 1}, {"bitmap": 1})
                expect_sharded(what, bitmap, ok, large, bad)
                if not np.array_equal(bitmap, single):
                    raise AssertionError(f"{what}: the bitmap differs from the single-card verify_batch")
                runs.append({"plane": kind, "commit": large, "mesh": label, "s": t,
                             "run": f"verify_batch_sharded {verdict}"})
            whole[kind, verdict] = jobs, single

    # row 15: the cached plane on the 1,000-validator commits at S = 4 and
    # S = 1, each through new caches: the fill on the first call, then a
    # hit a shard; at S = 4 the 10,000 keys overflow to the uncached path
    for splits in (DEFAULT_SPLITS, 1):
        os.environ["TM_TPU_PK_SPLIT"] = str(splits)
        V._PK_CACHES.clear()
        for kind, P in planes.items():
            fill, hit = ((P.fill1, P.hit1) if splits == 1 else (P.fill, P.hit))
            first = True
            for label, mesh in reversed(meshes.items()):
                for verdict, bad in (("valid", None), ("tampered", bad_index[mid])):
                    jobs = commit_jobs(commits[kind][mid], chain_id, bad)
                    want = {hit.__name__: mesh.size, fc: mesh.size + 1}
                    if first:
                        want[fill.__name__] = 1
                        first = False
                    what = (f"{kind} verify_batch_sharded_cached at S={splits} on the {verdict} "
                            f"{mid}-validator commit, mesh of {label}")
                    (bitmap, ok), t = run(what, lambda: SV.verify_batch_sharded_cached(
                        mesh, *jobs, key_type=kind), want, {"cached": 1})
                    expect_sharded(what, bitmap, ok, mid, bad)
                    runs.append({"plane": kind, "commit": mid, "mesh": label, "splits": splits, "s": t,
                                 "run": f"verify_batch_sharded_cached {verdict}"})
            if splits == DEFAULT_SPLITS:
                jobs, _ = whole[kind, "valid"]
                mesh = meshes["4"]
                what = f"{kind} verify_batch_sharded_cached on the valid {large}-validator commit (overflow)"
                (bitmap, ok), _ = run(what, lambda: SV.verify_batch_sharded_cached(mesh, *jobs, key_type=kind),
                                      {P.bitmap.__name__: mesh.size, fc: mesh.size + 1}, {"bitmap": 1})
                expect_sharded(what, bitmap, ok, large, None)
    os.environ["TM_TPU_PK_SPLIT"] = str(DEFAULT_SPLITS)
    V._PK_CACHES.clear()

    # row 16: the sharded RLC (ed25519) on the 1,000- and 10,000-validator
    # commits, one z_raw for both verdicts; then 10 signatures on the mesh
    # of 4, whose shards 2 and 3 hold padding only
    P = planes["ed25519"]
    for n in (mid, large):
        z_raw = M._ensure_z_raw(n, rng.bytes(16 * n))
        for verdict, bad in (("valid", None), ("tampered", bad_index[n])):
            jobs = commit_jobs(commits["ed25519"][n], chain_id, bad)
            for label, mesh in meshes.items():
                what = f"verify_batch_sharded_rlc on the {verdict} {n}-validator commit, mesh of {label}"
                ok, t = run(what, lambda: SV.verify_batch_sharded_rlc(mesh, *jobs, z_raw=z_raw),
                            {P.rlc.__name__: mesh.size, fc: mesh.size + 1}, {"rlc": 1})
                if ok is not (bad is None):
                    raise AssertionError(f"{what}: verdict {ok}")
                runs.append({"plane": "ed25519", "commit": n, "mesh": label, "s": t,
                             "run": f"verify_batch_sharded_rlc {verdict}"})
    ten = [x[:10] for x in commit_jobs(commits["ed25519"][mid], chain_id)]
    mesh = meshes["4"]
    for verdict, sigs in (("valid", ten[2]), ("tampered", ten[2][:9] + [tamper(ten[2][9])])):
        what = f"verify_batch_sharded_rlc on {verdict} 10 signatures, mesh of 4 (shards 2, 3 of padding)"
        ok, _ = run(what, lambda: SV.verify_batch_sharded_rlc(mesh, ten[0], ten[1], sigs),
                    {P.rlc.__name__: 4, fc: 5}, {"rlc": 1})
        if ok is not (verdict == "valid"):
            raise AssertionError(f"{what}: verdict {ok}")
    check_path("phase 7", totals, expected)

    # verify_batch_sharded_local across processes: one rank on NCCL, and four
    # ranks on gloo with their kernels on the card (NCCL refuses two ranks on
    # one GPU), each a quarter of the tampered 10,000-validator commit
    jobs, single = whole["ed25519", "tampered"]
    for world, backend_device in ((1, dev.type), (4, "cpu")):
        t0 = time.perf_counter()
        ranks = run_ranks(tmp, world, backend_device, str(dev), jobs)
        bitmap = np.concatenate([r["bitmap"] for r in ranks])
        oks = {bool(r["ok"]) for r in ranks}
        backends = {str(r["backend"]) for r in ranks}
        launches = {tuple(r["launches"].tolist()) for r in ranks}
        per = SV.shard_rows(large // world, 1)
        if not np.array_equal(bitmap, single) or oks != {False} or launches != {(1, 2)}:
            raise AssertionError(f"{world} ranks ({backends}): {int((bitmap != single).sum())} rows differ "
                                 f"from the whole bitmap, verdicts {oks}, launches {launches}")
        log(f"phase 7: verify_batch_sharded_local on {world} rank(s), backend {sorted(backends)}, kernels "
            f"and the reduced int32 on {dev}, {large // world} jobs ({per} rows) a rank: the concatenated "
            f"bitmap equals the "
            f"whole one, every rank False, launches (bitmap, fail_count) {sorted(launches)}, "
            f"{time.perf_counter() - t0:.1f} s with process start")
    return totals


def kernels_at_sharded_shapes(planes, dev, rng, chain_id, commits, bad_index, counts, int32_rate):
    """Each kernel of the sharded path against its plain version on the rows
    the sharded calls give it at 10,000 validators: 10,240 rows on the mesh
    of 1 and the shard of 2,560 that holds the tampered row on the mesh of
    4, exact, timed with CUDA events; the cache kernels at S = 4 and S = 1
    through tables that their fill built for the commit's 10,240 keys;
    fail_count beside torch.sum on the 10,240-row bitmap."""
    import numpy as np
    import torch

    from tendermint_tpu_torch.ops import msm as M
    from tendermint_tpu_torch.ops import verify as V
    from tendermint_tpu_torch.parallel import sharded_verify as SV

    n = SIZES[-1]
    bad = bad_index[n]
    m, q = SV.shard_rows(n, 1), SV.shard_rows(n, 4)
    d = bad // q
    shapes = ((m, slice(0, m)), (q, slice(d * q, (d + 1) * q)))
    records = []

    def check_bitmap(name, got, want, sl):
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: {int((got != want).sum())} rows differ from plain")
        host = got.cpu().numpy()
        invalid = [i + (sl.start or 0) for i in np.flatnonzero(~host)]
        if invalid != [bad]:
            raise AssertionError(f"{name}: invalid rows {invalid[:8]}, expected [{bad}]")

    for kind, P in planes.items():
        a, r, s, k, pre = P.prepare(*commit_jobs(commits[kind][n], chain_id, bad))
        rows = SV._pad_rows([a, r, s, k], m)
        for rows_n, sl in shapes:
            args = V._to_device([x[sl] for x in rows], dev)
            name = f"{P.bitmap.__name__}[rows={rows_n}]"
            got, ms = event_ms(lambda: P.bitmap(*args), 5)
            want, p_ms = plain_ms(lambda: P.bitmap_plain(*args), warm=False)
            check_bitmap(name, got, want, sl)
            records.append(make_record(P.bitmap, None, rows_n, ms, p_ms, 0, P.ops_bitmap(rows_n),
                                       129 * rows_n, counts.get(P.bitmap.__name__, 0), int32_rate, name))
            if kind == "ed25519" and rows_n == m:
                records.append(fail_count_record(got, counts.get("fail_count", 0), int32_rate))
        (a_d,) = V._to_device([rows[0]], dev)
        for splits in (DEFAULT_SPLITS, 1):
            fill, fill_plain, hit, hit_plain = cache_pair(P, splits)
            fill_fn, hit_fn = (P.fill1, P.hit1) if splits == 1 else (P.fill, P.hit)
            name = f"{kernel_label(fill_fn, splits)}[S={splits},rows={m}]"
            (tabs, oks), ms = event_ms(lambda: fill(a_d), 5)
            (ptabs, poks), p_ms = plain_ms(lambda: fill_plain(a_d), warm=False)
            err = check_fill(name, tabs, oks, ptabs, poks, all_decode=True)
            del ptabs, poks
            records.append(make_record(fill_fn, splits, m, ms, p_ms, err, P.ops_fill(m, splits),
                                       m * (32 + 4096 * splits + 1), counts.get(fill_fn.__name__, 0),
                                       int32_rate, name))
            slots = torch.arange(m, dtype=torch.int32, device=dev)
            for rows_n, sl in shapes:
                args = (tabs, oks, slots[sl].contiguous(), *V._to_device([x[sl] for x in rows[1:]], dev))
                name = f"{kernel_label(hit_fn, splits)}[S={splits},rows={rows_n}]"
                got, ms = event_ms(lambda: hit(*args), 5)
                want, p_ms = plain_ms(lambda: hit_plain(*args), warm=False)
                check_bitmap(name, got, want, sl)
                records.append(make_record(hit_fn, splits, rows_n, ms, p_ms, 0, P.ops_hit(rows_n, splits),
                                           rows_n * (4 + 96 + 1 + 1) + cache_read_bytes(rows[3][sl], splits),
                                           counts.get(hit_fn.__name__, 0), int32_rate, name))
            del tabs, oks

    # the RLC (ed25519): the whole commit at 10,240 rows and the shard of
    # 2,560 with its own scalars, both verdicts with one z_raw
    P = planes["ed25519"]
    z_raw = M._ensure_z_raw(n, rng.bytes(16 * n))
    for rows_n, sl in shapes:
        lo, hi = sl.start, min(sl.stop, n)
        verdicts = {}
        for verdict, b in (("valid", None), ("tampered", bad)):
            a, r, s, k, _ = P.prepare(*commit_jobs(commits["ed25519"][n], chain_id, b))
            zk, z, zs = M._rlc_scalars(s[lo:hi], k[lo:hi], hi - lo, z_raw[16 * lo:16 * hi])
            args = V._to_device(SV._pad_rows([a[lo:hi], r[lo:hi], zk, z], rows_n) + [zs], dev)
            if b is None:
                got, ms = event_ms(lambda: P.rlc(*args), 5)
                want = P.rlc_plain(*args)
            else:
                got = P.rlc(*args)
                want, p_ms = plain_ms(lambda: P.rlc_plain(*args), warm=False)
            if bool(got) != bool(want) or bool(got) != (b is None):
                raise AssertionError(f"{P.rlc.__name__}[rows={rows_n}] ({verdict}): kernel {bool(got)} "
                                     f"plain {bool(want)}")
            verdicts[verdict] = bool(got)
        log(f"phase 7: {P.rlc.__name__} verdicts at {rows_n} rows, same z_raw: {json.dumps(verdicts)}")
        records.append(make_record(P.rlc, None, rows_n, ms, p_ms, 0, P.ops_rlc(rows_n, M._streams(rows_n)),
                                   rows_n * (32 + 32 + 32 + 16) + 32 + 1, counts.get(P.rlc.__name__, 0),
                                   int32_rate, f"{P.rlc.__name__}[rows={rows_n}]"))
    return records


def fail_count_record(bitmap, launches, int32_rate):
    """fail_count on a bitmap the path made, timed beside its plain version
    and one PyTorch call, (~ok).sum(); bound: the bitmap read once and one
    int32 written, one compare and one add a row."""
    import torch

    from tendermint_tpu_torch.parallel import sharded_verify as SV

    n = bitmap.numel()
    got, ms = event_ms(lambda: SV.fail_count(bitmap), 50)
    want, p_ms = event_ms(lambda: SV.fail_count_plain(bitmap), 50)
    lib, lib_ms = event_ms(lambda: (~bitmap).sum(), 50)
    if not torch.equal(got, want) or int(got) != int(lib):
        raise AssertionError(f"fail_count: kernel {int(got)} plain {int(want)} torch.sum {int(lib)}")
    return make_record(SV.fail_count, None, n, ms, p_ms, 0, 2 * n, n + 4, launches, int32_rate,
                       library_ms=lib_ms)


E2E_ROUNDS = 5


def sharded_end_to_end(planes, meshes, dev, chain_id, commits, runs):
    """verify_batch_sharded on the mesh of 1 (10,240 rows) and on the mesh
    of 4 against the single-card verify_batch (16,384 rows) on the valid
    10,000-validator commit of each plane: E2E_ROUNDS rounds, the three in
    a rotating order each round; the medians are recorded."""
    import statistics

    from tendermint_tpu_torch.parallel import sharded_verify as SV

    n = SIZES[-1]
    for kind, P in planes.items():
        jobs = commit_jobs(commits[kind][n], chain_id)
        calls = {"sharded_1": lambda: SV.verify_batch_sharded(meshes["1"], *jobs, key_type=kind),
                 "single": lambda: P.batch(*jobs, device=dev),
                 "sharded_4": lambda: SV.verify_batch_sharded(meshes["4"], *jobs, key_type=kind)}
        keys = list(calls)
        t = {key: [] for key in keys}
        for r in range(E2E_ROUNDS):
            for key in keys[r % 3:] + keys[:r % 3]:
                t[key].append(timed(calls[key])[1])
        med = {key: statistics.median(v) for key, v in t.items()}
        runs.append({"plane": kind, "commit": n, "run": f"end to end, median of {E2E_ROUNDS}: sharded "
                     "mesh of 1 / single card / sharded mesh of 4", "s": med["sharded_1"],
                     "single_s": med["single"], "mesh4_s": med["sharded_4"]})
        log(f"phase 7: {kind} end to end on {n} validators, seconds a call: {json.dumps(t)}")


# -- phase 8: the cutover autotune -------------------------------------------------

# A fresh process with the cutovers unpinned and TM_TPU_AUTOTUNE unset: a
# 4-signature batch verify (below every cutover, so the host path) starts the
# probe on the card; the probe's thread is joined; writes what the probe
# recorded, the cutovers and the launch counts as JSON to argv[2].
AUTOTUNE_SCRIPT = r'''
import importlib.util
import json
import os
import sys

root, out = sys.argv[1:3]
for var in ("TM_TPU_AUTOTUNE", "TM_TPU_BATCH_CUTOVER", "TM_TPU_MSM_CUTOVER"):
    os.environ.pop(var, None)
sys.path.insert(0, root)
spec = importlib.util.spec_from_file_location("chip_smoke_autotune", f"{root}/chip_smoke.py")
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
from tendermint_tpu_torch.crypto import ed25519 as ed
from tendermint_tpu_torch.crypto import ed25519_ref as ref
from tendermint_tpu_torch.ops import engine as E

cs.reset_counts()
priv = ref.gen_privkey(bytes(32))
bv = ed.Ed25519BatchVerifier()
for i in range(4):
    msg = b"autotune-%d" % i
    bv.add(ed.Ed25519PubKey(priv[32:]), msg, ref.sign(priv, msg))
ok, _ = bv.verify()
probe = E._AUTOTUNE.get("thread")
if probe is not None:
    probe.join(timeout=300)
rec = {k: (repr(v) if k in ("error", "thread") else v) for k, v in E._AUTOTUNE.items()}
with open(out, "w") as f:
    json.dump({"ok": ok, "alive": probe is not None and probe.is_alive(), "autotune": rec,
               "cutovers": [ed.DEVICE_BATCH_CUTOVER, ed.MSM_BATCH_CUTOVER],
               "launches": {k: v for k, v in cs.read_counts().items() if v}}, f)
'''


def autotune_phase(tmp):
    """The probe on the card in a fresh process: it must start, end, record
    no exception, set the cutovers to the reference's formula from its two
    timings, and launch the 8-signature bitmap exactly 4 times (one warm-up,
    three timed); the batch itself stays on the host."""
    script, out = os.path.join(tmp, "autotune.py"), os.path.join(tmp, "autotune.json")
    with open(script, "w") as f:
        f.write(AUTOTUNE_SCRIPT)
    proc = subprocess.run([sys.executable, script, ROOT, out], cwd=ROOT, capture_output=True,
                          text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"phase 8 failed (rc {proc.returncode}):\n{(proc.stdout + proc.stderr)[-3000:]}")
    with open(out) as f:
        res = json.load(f)
    rec = res["autotune"]
    if "error" in rec or res["alive"] or "thread" not in rec or not res["ok"]:
        raise AssertionError(f"phase 8: the probe did not run to its end cleanly: {json.dumps(res)}")
    cutover = 8
    while cutover * rec["t_host"] < rec["t_launch"] and cutover < 4096:
        cutover *= 2
    want = [cutover, max(64, min(4 * cutover, 8192))]
    got = [rec["device_batch_cutover"], rec["msm_batch_cutover"]]
    if got != want or res["cutovers"] != want:
        raise AssertionError(f"phase 8: cutovers {got} (module {res['cutovers']}), the formula gives {want}")
    if res["launches"] != {"verify_kernel": 4}:
        raise AssertionError(f"phase 8: launched {res['launches']}, expected {{'verify_kernel': 4}}")
    log(f"phase 8: autotune probe: t_host {rec['t_host'] * 1e3:.4f} ms a host verify, t_launch "
        f"{rec['t_launch'] * 1e3:.4f} ms an 8-signature bitmap call -> DEVICE_BATCH_CUTOVER {got[0]}, "
        f"MSM_BATCH_CUTOVER {got[1]} (the formula's); launches {json.dumps(res['launches'])}")
    return rec


# -- phase 9: the engine on the card ------------------------------------------------

ENGINE_TURNS = ("direct", "engine", "engine", "direct")
# phase 9 (a)'s groups: (validators, commits, the tampered commit or None)
COALESCE_GROUPS = ((67, 3, None), (1000, 4, 2))
# phase 9 (d)'s concurrent callers: (validators, threads), ed25519
CALLER_MIXES = ((150, 8), (1000, 4))


@contextlib.contextmanager
def env_setting(name: str, value):
    """os.environ[name] = value inside the block (None: unset), restored
    after."""
    before = os.environ.pop(name, None)
    if value is not None:
        os.environ[name] = value
    try:
        yield
    finally:
        os.environ.pop(name, None)
        if before is not None:
            os.environ[name] = before


def engine_commits(pool, rng, keys, chain_id):
    """Phase 9's commits, signed at set-up: each plane's groups of
    COALESCE_GROUPS and ed25519's eight 150-validator commits; each commit
    of one size is signed by the same validators at its own height."""
    out = {}
    height = 500
    sizes = {(n, count) for n, count, _ in COALESCE_GROUPS}
    for kind in PLANES:
        seeds, pubs = keys[kind]
        for n, count in sorted(sizes | ({(150, 8)} if kind == "ed25519" else set())):
            out[kind, n] = [build_commit(pool, kind, seeds, pubs, rng, n, chain_id, height + i)
                            for i in range(count)]
            height += count
    return out


def commit_outcome(chain_id, entry):
    """verify_commit's verdict: "accepted", or its error up to the
    signature's hex."""
    from tendermint_tpu_torch.types.validation import verify_commit

    vals, bid, commit = entry
    try:
        verify_commit(chain_id, vals, bid, commit.height, commit)
    except ValueError as e:
        return str(e).split(":")[0]
    return "accepted"


def one_launch(P, pks, rows: int, valid: bool):
    """The launches one direct call over `rows` rows of these keys makes
    now: none below the device cutover; the cache hit (and the fill, when a
    key is not in the cache) below the RLC cutover; the RLC, and on a bad
    row the cache hit (and fill) after it, above."""
    from tendermint_tpu_torch.crypto import ed25519 as ed

    if rows < ed.DEVICE_BATCH_CUTOVER:
        return {}
    cache = P.cache()
    bitmap = {P.hit.__name__: 1}
    if any(pk not in cache._lru for pk in set(pks)):
        bitmap[P.fill.__name__] = 1
    if rows < ed.MSM_BATCH_CUTOVER:
        return bitmap
    return {P.rlc.__name__: 1, **({} if valid else bitmap)}


def coalesced_on_card(kind, calls):
    """Each call in a thread of its own while the engine's dispatch worker
    is held by a first, one-row job, so that the calls' jobs all queue
    before the worker takes its next group. Launch counts are set to 0 just
    before the release and read after the last call returns. Returns (each
    call's output, the launches, the groups the release formed as
    (observations, jobs) of coalesced_group_size)."""
    import threading

    import torch

    from tendermint_tpu_torch.metrics import engine_metrics
    from tendermint_tpu_torch.ops import engine as E

    eng = E.get_engine()
    gate, held = threading.Event(), threading.Event()
    dispatch_group = eng._dispatch_group

    def hold(group, seq=0):
        del eng._dispatch_group  # only this first group waits
        held.set()
        if not gate.wait(120):
            raise AssertionError("phase 9: the held group was never released")
        return dispatch_group(group, seq)

    eng._dispatch_group = hold
    blocker = eng.submit(kind, [bytes(32)], [b"hold"], [bytes(64)])  # one host row
    if not held.wait(60):
        raise AssertionError("phase 9: the dispatch worker never took the first job")
    outs, errors = {}, []

    def run(i, fn):
        try:
            outs[i] = fn()
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i, fn)) for i, fn in enumerate(calls)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 120
    while len(eng._pending) < len(calls) and not errors:
        if time.monotonic() > deadline:
            raise AssertionError(f"phase 9: {len(eng._pending)} of {len(calls)} jobs queued")
        time.sleep(0.001)
    groups = engine_metrics().coalesced_group_size
    (_, jobs0, n0), = groups.totals()  # the holding group is observed already
    reset_counts()
    gate.set()
    for t in threads:
        t.join(timeout=300)
    if any(t.is_alive() for t in threads) or errors:
        raise AssertionError(f"phase 9: a caller failed or hung: {errors}")
    torch.cuda.synchronize()
    launches = {name: c for name, c in read_counts().items() if c}
    (_, jobs1, n1), = groups.totals()
    blocker.result(timeout=60)
    return [outs[i] for i in range(len(calls))], launches, (int(n1 - n0), int(jobs1 - jobs0))


def coalescing_phase(planes, chain_id, commits9):
    """Phase 9 (a) and (b) on each plane: the groups of COALESCE_GROUPS, each
    submitted behind a held worker, must form one group, give each caller
    the verdict and tampered index that direct dispatch gives it and launch
    exactly what one direct call over the combined rows launches; three
    20-signature jobs (60 rows, below the cutover) form one host group and
    launch nothing."""
    from tendermint_tpu_torch.crypto.batch import create_batch_verifier
    from tendermint_tpu_torch.metrics import engine_metrics

    for kind, P in planes.items():
        for n, count, bad_commit in COALESCE_GROUPS:
            entries = commits9[kind, n]
            bad = (n * 5) // 12
            good = entries[bad_commit][2].signatures[bad].signature if bad_commit is not None else None
            if bad_commit is not None:
                entries[bad_commit][2].signatures[bad].signature = tamper(good)
            try:
                with env_setting("TM_TPU_ENGINE", "off"):
                    want = [commit_outcome(chain_id, e) for e in entries]
                expect = one_launch(P, [v.pub_key.bytes() for v in entries[0][0].validators],
                                    n * count, bad_commit is None)
                got, launches, groups = coalesced_on_card(
                    kind, [functools.partial(commit_outcome, chain_id, e) for e in entries])
            finally:
                if bad_commit is not None:
                    entries[bad_commit][2].signatures[bad].signature = good
            verdicts = ["accepted"] * count
            if bad_commit is not None:
                verdicts[bad_commit] = f"wrong signature (#{bad})"
            if got != want or want != verdicts:
                raise AssertionError(f"phase 9: {kind} {count} x {n}: engine {got}, direct {want}, "
                                     f"expected {verdicts}")
            if groups != (1, count) or launches != expect:
                raise AssertionError(f"phase 9: {kind} {count} x {n}: groups {groups}, launched "
                                     f"{launches}, one launch over {n * count} rows makes {expect}")
            log(f"phase 9: {kind} {count} x {n}-validator commits as one group of {n * count} rows: "
                f"verdicts {got} (direct dispatch's), launches {json.dumps(launches)}")

        vals, _, commit = commits9[kind, COALESCE_GROUPS[0][0]][0]
        calls = []
        for j in range(3):
            bv = create_batch_verifier(vals.validators[0].pub_key)
            for i in range(20 * j, 20 * j + 20):
                bv.add(vals.validators[i].pub_key, commit.vote_sign_bytes(chain_id, i),
                       commit.signatures[i].signature)
            calls.append(bv.verify)
        def host_groups():
            samples = engine_metrics().launches.samples()
            return {tuple(lb.values()): v for _, lb, v in samples}.get((kind, "host"), 0)

        before = host_groups()
        got, launches, groups = coalesced_on_card(kind, calls)
        deadline = time.monotonic() + 5  # a group is counted after its callers wake
        while host_groups() - before < 2 and time.monotonic() < deadline:
            time.sleep(0.001)
        after = host_groups()
        if got != [(True, [True] * 20)] * 3 or launches or groups != (1, 3) or after - before != 2:
            raise AssertionError(f"phase 9: {kind} 3 x 20 signatures: {groups} groups, launched "
                                 f"{launches}, host groups {after - before} (with the holding one)")
        log(f"phase 9: {kind} 3 x 20 signatures as one host group of 60 rows, no launch")


# A fresh process with TM_TPU_DEVOBS=1: the valid 1,000-validator ed25519
# commit's rows (argv[2], hex JSON) through the engine, a pubkey-cache fill
# of 150 keys, a residency sample, then a build of fail_count into an empty
# build directory (argv[4]); writes devobs' status, the sample and the
# libraries loaded as JSON to argv[3].
DEVOBS_SCRIPT = r"""
import json
import os
import sys
from pathlib import Path

root, jobs_path, out, build_dir = sys.argv[1:5]
os.environ["TM_TPU_DEVOBS"] = "1"
sys.path.insert(0, root)
from tendermint_tpu_torch import devobs
from tendermint_tpu_torch.crypto import ed25519 as ed
from tendermint_tpu_torch.metrics import global_registry
from tendermint_tpu_torch.ops import _build
from tendermint_tpu_torch.ops import verify as V

with open(jobs_path) as f:
    pks, msgs, sigs = ([bytes.fromhex(x) for x in col] for col in json.load(f))
bv = ed.Ed25519BatchVerifier()
for p, m, s in zip(pks, msgs, sigs):
    bv.add(ed.Ed25519PubKey(p), m, s)
before = devobs.status()
ok, _ = bv.verify()
call = devobs.status()
V.pubkey_cache().ensure(pks[:150])
sample = devobs.sample_residency()
loaded = sorted(_build._LIBS)
_build.BUILD_DIR = Path(build_dir)
_build.load("fail_count")
with open(out, "w") as f:
    json.dump({"enabled": devobs.enabled(), "ok": ok, "before": before, "call": call,
               "sample": sample, "loaded": loaded, "status": devobs.status(tail=256),
               "gather": global_registry().gather()}, f)
"""


def devobs_phase(chain_id, entry, tmp):
    """Phase 9 (c): devobs on the card in a fresh process. The 1,000-row
    call's h2d bytes must equal its inputs' (the RLC's rows padded to 1,024:
    a, r, zk of 32 bytes, z of 16, and zs, 32 bytes), its d2h the verdict's
    byte; residency must be above zero after the cache fill, the cache
    plane holding the cache's tables; the build events must be one load of
    each library the process loaded and one nvcc run and one load of the
    one kernel it built."""
    pks, msgs, sigs = commit_jobs(entry, chain_id)
    jobs, out = os.path.join(tmp, "devobs_jobs.json"), os.path.join(tmp, "devobs.json")
    script, build_dir = os.path.join(tmp, "devobs.py"), os.path.join(tmp, "build")
    os.makedirs(build_dir)
    with open(jobs, "w") as f:
        json.dump([[x.hex() for x in col] for col in (pks, msgs, sigs)], f)
    with open(script, "w") as f:
        f.write(DEVOBS_SCRIPT)
    proc = subprocess.run([sys.executable, script, ROOT, jobs, out, build_dir], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"phase 9 (c) failed (rc {proc.returncode}):\n{(proc.stdout + proc.stderr)[-3000:]}")
    with open(out) as f:
        res = json.load(f)
    n = len(sigs)
    rows = 1 << (n - 1).bit_length()
    want_h2d = rows * (32 + 32 + 32 + 16) + 32
    h2d = res["call"]["transfer_bytes"]["h2d"] - res["before"]["transfer_bytes"]["h2d"]
    d2h = res["call"]["transfer_bytes"]["d2h"] - res["before"]["transfer_bytes"]["d2h"]
    if not (res["enabled"] and res["ok"]) or (h2d, d2h) != (want_h2d, 1):
        raise AssertionError(f"phase 9 (c): the {n}-row call copied {h2d} bytes in and {d2h} out, "
                             f"its inputs take {want_h2d} and 1: {json.dumps(res['call'])}")
    sample = res["sample"]
    plane = sample["planes"].get("ed25519_pk", {})
    if sample["live_buffer_bytes"] <= 0 or plane.get("entries", 0) < 150 or plane.get("bytes", 0) <= 0:
        raise AssertionError(f"phase 9 (c): residency after the fill: {json.dumps(sample)}")
    events = sorted((e["fn"], e["kind"]) for e in res["status"]["tail"])
    want_events = sorted([(lib, "load") for lib in res["loaded"]] + [("fail_count", "nvcc"),
                                                                     ("fail_count", "load")])
    if events != want_events or res["status"]["compiles"] != len(want_events):
        raise AssertionError(f"phase 9 (c): build events {events}, expected {want_events}")
    log(f"phase 9: devobs: the valid {n}-validator call copied {h2d} bytes to the card (its inputs, "
        f"{rows} rows) and {d2h} back; after a 150-key cache fill {sample['live_buffer_bytes']} bytes "
        f"live, high water {sample['high_water_bytes']}, planes {json.dumps(sample['planes'])}; build "
        f"events {json.dumps(events)} in "
        f"{sum(e['dur_s'] for e in res['status']['tail']):.3f} s on {card()}")
    return res


def concurrent_turns(what, entries, chain_id, runs):
    """Phase 9 (d): len(entries) verify_commit callers, one thread each,
    released together, engine against direct dispatch in ENGINE_TURNS; the
    wall time of a turn runs from the release to the last return (then a
    synchronize). Logs and returns each mode's mean seconds and launches per
    commit, and the engine's overlap_ratio; logs the engine turns' groups
    and their mean queue wait, launch (dispatch stage) and collect latency
    from EngineMetrics."""
    import threading

    import torch

    from tendermint_tpu_torch.metrics import engine_metrics

    m = engine_metrics()
    stages = {"queue_wait": m.queue_wait, "launch": m.launch_latency, "collect": m.collect_latency}

    def stage_totals():
        return {k: tuple(sum(t[i] for t in h.totals()) for i in (1, 2)) for k, h in stages.items()}

    times = {"direct": [], "engine": []}
    launches = {"direct": [], "engine": []}
    stage_sums = {k: [0.0, 0.0] for k in stages}
    for mode in ENGINE_TURNS:
        before = stage_totals()
        with env_setting("TM_TPU_ENGINE", "off" if mode == "direct" else None):
            start = threading.Barrier(len(entries) + 1)
            outs = []

            def call(entry, start=start, outs=outs):
                start.wait(timeout=60)
                outs.append(commit_outcome(chain_id, entry))

            threads = [threading.Thread(target=call, args=(e,)) for e in entries]
            for t in threads:
                t.start()
            torch.cuda.synchronize()
            reset_counts()
            start.wait(timeout=60)
            t0 = time.perf_counter()
            for t in threads:
                t.join(timeout=300)
            torch.cuda.synchronize()
            t = time.perf_counter() - t0
        if any(th.is_alive() for th in threads) or outs != ["accepted"] * len(entries):
            raise AssertionError(f"phase 9: {what} ({mode}): {outs}")
        times[mode].append(t)
        launches[mode].append(sum(read_counts().values()) / len(entries))
        if mode == "engine":
            for k, (total, count) in stage_totals().items():
                stage_sums[k][0] += total - before[k][0]
                stage_sums[k][1] += count - before[k][1]
    ratio = next((v for _, _, v in m.overlap_ratio.samples()), 0.0)
    groups = int(stage_sums["launch"][1])
    stage_ms = {k: round(total / count * 1e3, 3) if count else None
                for k, (total, count) in stage_sums.items()}
    mean = {mode: sum(v) / len(v) for mode, v in times.items()}
    per = {mode: sum(v) / len(v) for mode, v in launches.items()}
    log(f"phase 9: {what}: engine {mean['engine'] * 1e3:.2f} ms, direct {mean['direct'] * 1e3:.2f} ms "
        f"(means of the turns {ENGINE_TURNS}; each turn "
        f"{json.dumps({m: [round(x * 1e3, 2) for x in v] for m, v in times.items()})} ms), launches a "
        f"commit engine {per['engine']:.3f} direct {per['direct']:.3f}, overlap_ratio {ratio:.4f}; "
        f"the engine turns' {groups} groups, mean ms a group {json.dumps(stage_ms)} on {card()}")
    for mode in times:
        runs.append({"plane": "ed25519", "commit": len(entries[0][0].validators),
                     "run": f"{what}, {mode}, mean of {ENGINE_TURNS.count(mode)}", "s": mean[mode],
                     "launches_per_commit": per[mode]})
    return mean, per, ratio


def engine_phase(planes, chain_id, commits, commits9, runs, tmp):
    """Phase 9: the engine on the card, (a) to (d)."""
    coalescing_phase(planes, chain_id, commits9)
    devobs_phase(chain_id, commits["ed25519"][SIZES[1]], tmp)
    for n, threads in CALLER_MIXES:
        concurrent_turns(f"{threads} threads x {n}-validator ed25519 commits", commits9["ed25519", n][:threads],
                         chain_id, runs)
    n = SIZES[-1]
    concurrent_turns(f"one {n}-validator ed25519 call", [commits["ed25519"][n]], chain_id, runs)


# -- phase 10: the light client and the hashes on the card ---------------------------

LIGHT_VALIDATORS = 150  # the Cosmos Hub's active set
LIGHT_HEIGHTS = 16
LIGHT_SWAP_AT = 9  # the first height the second set signs
LIGHT_T0 = 1_700_000_000  # the first header's time, unix seconds
LIGHT_DT = 6  # seconds between headers
TRUSTING_PERIOD_NS = 14 * 24 * 3600 * 10**9
MAX_CLOCK_DRIFT_NS = 10 * 10**9
MIXED_SECP = 50  # BASELINE.json config 4's secp256k1 keys among 150
MULTIPROOF_INDICES = 64
HASH_TURNS = ("native", "python", "python", "native")


def light_modules():
    """The port's modules a light chain is built and verified with; the
    builders below take such a namespace, so the CPU tests can hand them
    the JAX package's instead."""
    from tendermint_tpu_torch import light
    from tendermint_tpu_torch.crypto import ed25519, merkle, secp256k1, sr25519
    from tendermint_tpu_torch.evidence import verify as ev
    from tendermint_tpu_torch.light import client
    from tendermint_tpu_torch.store import kv
    from tendermint_tpu_torch.types import block, evidence, light_block, validation, validator_set, vote
    from tendermint_tpu_torch.utils import tmtime

    return SimpleNamespace(
        light=light, block=block, light_block=light_block, validation=validation, vs=validator_set,
        tmtime=tmtime, merkle=merkle, client=client, kv=kv, vote=vote, evidence=evidence, ev=ev,
        keys={"ed25519": ed25519.Ed25519PubKey, "sr25519": sr25519.Sr25519PubKey,
              "secp256k1": secp256k1.Secp256k1PubKey})


def light_vals(m, members, proposer: int | None = None):
    """A validator set over members [(kind, pub, secret)] of power 10 each,
    the member at index `proposer` 11 (so that it proposes); returns the set
    and each address's secret."""
    vals, secrets = [], {}
    for i, (kind, pub, secret) in enumerate(members):
        v = m.vs.Validator.new(m.keys[kind](pub), 11 if i == proposer else 10)
        vals.append(v)
        secrets[v.address] = secret
    return m.vs.ValidatorSet.new(vals), secrets


def signed_commit(m, vals, secrets, sign, chain_id, height, block_id, time_s):
    """A commit of every validator of vals for block_id, each signing its
    canonical vote sign bytes through sign(secrets, msgs) -> sigs."""
    commit = m.block.Commit(height=height, round=0, block_id=block_id, signatures=[
        m.block.CommitSig.new_commit(v.address, m.tmtime.Time(time_s + 1, 1000 * i + 7), b"")
        for i, v in enumerate(vals.validators)])
    msgs = [commit.vote_sign_bytes(chain_id, i) for i in range(len(vals.validators))]
    for cs, sig in zip(commit.signatures, sign([secrets[v.address] for v in vals.validators], msgs)):
        cs.signature = sig
    return commit


def tagged(tag: bytes, height: int) -> bytes:
    """A made-up 32-byte hash for a header field."""
    import hashlib

    return hashlib.sha256(b"%s-%d" % (tag, height)).digest()


def signed_header(m, vals, next_vals, secrets, sign, chain_id, height, last_block_id, last_commit_hash):
    """A fully populated header at `height` signed by vals: its commit signs
    header.hash()."""
    sha = lambda tag: tagged(tag, height)
    time_s = LIGHT_T0 + LIGHT_DT * height
    header = m.block.Header(
        chain_id=chain_id, height=height, time=m.tmtime.Time(time_s, 1000 * height),
        last_block_id=last_block_id, last_commit_hash=last_commit_hash,
        data_hash=m.block.txs_hash([b"tx-%d-%d" % (height, i) for i in range(3)]),
        validators_hash=vals.hash(), next_validators_hash=next_vals.hash(),
        consensus_hash=sha(b"consensus"), app_hash=sha(b"app"), last_results_hash=sha(b"results"),
        evidence_hash=m.merkle.hash_from_byte_slices([]),
        proposer_address=vals.get_proposer().address)
    block_id = m.block.BlockID(header.hash(), m.block.PartSetHeader(1, sha(b"parts")))
    return m.light_block.SignedHeader(
        header, signed_commit(m, vals, secrets, sign, chain_id, height, block_id, time_s))


def light_chain(m, members, swap_in, untrusted, sign, chain_id, heights=LIGHT_HEIGHTS,
                swap_at=(LIGHT_SWAP_AT,)):
    """A chain of `heights` light blocks over members' set A whose set changes
    at each height of swap_at: at the i-th, the next k = len(swap_in) //
    len(swap_at) of A's validators (in A's order) leave and the next k of
    swap_in join (update_with_change_set, then the proposer rotation). With
    `untrusted` given, also a rival block at the last height signed by set C:
    a third of A's members and the `untrusted` members, where A's validators
    hold a third of A's power. Returns ({height: LightBlock}, the rival
    LightBlock or None)."""
    a, secrets = light_vals(m, members)
    k = len(swap_in) // len(swap_at)
    sets, current = [], a
    for i in range(len(swap_at)):
        changes = [m.vs.Validator(v.address, v.pub_key, 0) for v in a.validators[i * k:(i + 1) * k]]
        for kind, pub, secret in swap_in[i * k:(i + 1) * k]:
            new = m.vs.Validator.new(m.keys[kind](pub), 10)
            secrets[new.address] = secret
            changes.append(new)
        current = current.copy()
        current.update_with_change_set(changes)
        current = current.copy_increment_proposer_priority(1)
        sets.append(current)

    def vals_at(h):
        passed = [i for i, at in enumerate(swap_at) if h >= at]
        return sets[passed[-1]] if passed else a

    blocks = {}
    last_bid, last_commit_hash = m.block.BlockID(), b""
    for h in range(1, heights + 1):
        vals = vals_at(h)
        sh = signed_header(m, vals, vals_at(h + 1), secrets, sign, chain_id, h, last_bid, last_commit_hash)
        blocks[h] = m.light_block.LightBlock(sh, vals)
        last_bid, last_commit_hash = sh.commit.block_id, sh.commit.hash()
    if untrusted is None:
        return blocks, None
    c, c_secrets = light_vals(m, members[:len(members) // 3] + list(untrusted))
    prev = blocks[heights - 1].signed_header.commit
    rival = signed_header(m, c, c, c_secrets, sign, chain_id, heights, prev.block_id, prev.hash())
    return blocks, m.light_block.LightBlock(rival, c)


def tampered_commit(m, commit, idx):
    """A copy of commit with signature #idx tampered."""
    sigs = [m.block.CommitSig(cs.block_id_flag, cs.validator_address, cs.timestamp,
                              tamper(cs.signature) if i == idx else cs.signature)
            for i, cs in enumerate(commit.signatures)]
    return m.block.Commit(commit.height, commit.round, commit.block_id, sigs)


def light_cases(m, blocks, rival, chain_id, device=None):
    """Phase 10 (a)'s calls: [(label, call, vals whose commit check it runs
    or None, the trusting check's vals or None, expected outcome)]; an
    outcome is ("accepted", "") or (error class, a fragment of its
    message). `device` is passed on unless None (the JAX package's
    verifier takes none)."""
    import dataclasses

    L = m.light
    sh = {h: lb.signed_header for h, lb in blocks.items()}
    vals = {h: lb.validator_set for h, lb in blocks.items()}
    top = max(blocks)
    now = m.tmtime.Time(LIGHT_T0 + LIGHT_DT * top + 60)
    period, drift = TRUSTING_PERIOD_NS, MAX_CLOCK_DRIFT_NS
    ok = ("accepted", "")
    kw = {} if device is None else {"device": device}
    cases = [(f"verify_adjacent {h} -> {h + 1}",
              functools.partial(L.verify_adjacent, chain_id, sh[h], sh[h + 1], vals[h + 1], period,
                                now, drift, **kw), vals[h + 1], None, ok)
             for h in range(1, top)]
    cases.append((f"verify_non_adjacent 1 -> {top}", functools.partial(
        L.verify_non_adjacent, chain_id, sh[1], vals[1], sh[top], vals[top], period, now, drift,
        **kw), vals[top], vals[1], ok))
    cases.append((f"verify 1 -> {top}", functools.partial(
        L.verify, chain_id, sh[1], vals[1], sh[top], vals[top], period, now, drift, **kw),
        vals[top], vals[1], ok))
    s = min(h for h in blocks if vals[h].hash() != vals[1].hash())  # the first height of the new set
    forged = m.light_block.SignedHeader(dataclasses.replace(sh[s].header, data_hash=bytes(32)),
                                        sh[s].commit)
    cases.append((f"forged data_hash at {s}", functools.partial(
        L.verify_adjacent, chain_id, sh[s - 1], forged, vals[s], period, now, drift, **kw),
        None, None, ("ErrInvalidHeader", "commit signs block")))
    cases.append((f"the old set supplied at {s}", functools.partial(
        L.verify_adjacent, chain_id, sh[s - 1], sh[s], vals[s - 1], period, now, drift, **kw),
        None, None, ("ErrInvalidHeader", "to match those that were supplied")))
    bad = (len(vals[top].validators) * 5) // 12
    tampered = m.light_block.SignedHeader(sh[top].header, tampered_commit(m, sh[top].commit, bad))
    cases.append((f"signature #{bad} tampered at {top}", functools.partial(
        L.verify_adjacent, chain_id, sh[top - 1], tampered, vals[top], period, now, drift,
        **kw), vals[top], None, ("ErrInvalidHeader", f"wrong signature (#{bad})")))
    late = now.add(TRUSTING_PERIOD_NS)
    cases.append(("trusted header expired", functools.partial(
        L.verify_adjacent, chain_id, sh[1], sh[2], vals[2], period, late, drift, **kw),
        None, None, ("ErrOldHeaderExpired", "old header expired")))
    cases.append((f"a third of the trusted power at {top}", functools.partial(
        L.verify_non_adjacent, chain_id, sh[1], vals[1], rival.signed_header, rival.validator_set,
        period, now, drift, **kw), None, vals[1], (
            "ErrNewValSetCantBeTrusted", "insufficient voting power")))
    return cases


def outcome(call):
    """("accepted", "") or (the error's class name, its message)."""
    try:
        call()
    except Exception as e:  # noqa: BLE001 - the outcome is compared
        return type(e).__name__, str(e)
    return "accepted", ""


def light_counted(vals, frac=(2, 3)):
    """The keys a commit check of vals tallies before its power passes
    frac of the total (every validator signed, in the set's order)."""
    needed = vals.total_voting_power() * frac[0] // frac[1]
    tallied, keys = 0, []
    for v in vals.validators:
        keys.append(v.pub_key.bytes())
        tallied += v.voting_power
        if tallied > needed:
            break
    return keys


def light_setup(pool, rng, chain_id):
    """Phase 10's chains and commits, signed at set-up: a light chain on each
    plane, and the mixed-key sets of BASELINE.json config 4 with an ed25519
    and with a secp256k1 proposer, each with its signed commit."""
    m = light_modules()

    def sign(secrets, msgs):
        return [sigs[0] for _, sigs in pool.map(
            _sign_worker, [(kind, seed, [msg]) for (kind, seed), msg in zip(secrets, msgs)],
            chunksize=16)]

    def members(kind, n):
        seeds = [rng.bytes(32) for _ in range(n)]
        pubs = make_keys(pool, kind, seeds)
        return [(kind, pub, (kind, seed)) for pub, seed in zip(pubs, seeds)]

    n = LIGHT_VALIDATORS
    chains = {}
    for kind in PLANES:
        fresh = members(kind, n + 1 + n - n // 3)
        chains[kind] = light_chain(m, fresh[:n], [fresh[n]], fresh[n + 1:], sign, chain_id)
    mixed = members("ed25519", n - MIXED_SECP) + members("secp256k1", MIXED_SECP)
    order = rng.permutation(n)
    mixed = [mixed[i] for i in order]
    sets = {}
    for proposer_kind in ("ed25519", "secp256k1"):
        vals, secrets = light_vals(m, mixed, [k for k, _, _ in mixed].index(proposer_kind))
        bid = m.block.BlockID(rng.bytes(32), m.block.PartSetHeader(1, rng.bytes(32)))
        sets[proposer_kind] = vals, bid, signed_commit(m, vals, secrets, sign, chain_id, 900, bid,
                                                       LIGHT_T0)
    return chains, sets


def light_phase(planes, chain_id, chains, runs):
    """Phase 10 (a) on each plane: every call of light_cases with its launch
    counters zeroed just before it and read just after, held to the
    launches its routing gives; returns the launches summed."""
    from tendermint_tpu_torch.crypto import ed25519 as ed

    m = light_modules()
    totals = {}
    for kind, P in planes.items():
        blocks, rival = chains[kind]
        seen = set()
        plane_totals = {}
        for label, call, checked, trusted, want in light_cases(m, blocks, rival, chain_id):
            if trusted is not None and len(light_counted(trusted, (1, 3))) >= ed.DEVICE_BATCH_CUTOVER:
                raise AssertionError(f"phase 10: {label}: the trusting check would reach the card")
            expect = {}
            if checked is not None:
                keys = light_counted(checked)
                if len(keys) >= ed.DEVICE_BATCH_CUTOVER:
                    expect = {P.hit.__name__: 1}
                    if not seen.issuperset(keys):
                        expect[P.fill.__name__] = 1
                    seen.update(keys)
            got, t = drive(f"phase 10: {kind} {label}", lambda: outcome(call), expect, plane_totals)
            if got[0] != want[0] or want[1] not in got[1]:
                raise AssertionError(f"phase 10: {kind} {label}: {got}, expected {want}")
            runs.append({"plane": kind, "commit": len(blocks[1].validator_set.validators),
                         "run": f"light {label}", "s": t})
            log(f"phase 10: {kind} {label}: {got[0]}{' (' + got[1][:60] + ')' if got[1] else ''}, "
                f"launches {json.dumps(expect)}, {t * 1e3:.2f} ms on {card()}")
        fills, hits = plane_totals.get(P.fill.__name__, 0), plane_totals.get(P.hit.__name__, 0)
        if not fills or not hits:
            raise AssertionError(f"phase 10: {kind} launched {plane_totals}: a fill and a hit expected")
        for name, c in plane_totals.items():
            totals[name] = totals.get(name, 0) + c
    check_path("phase 10", totals, [{P.fill.__name__: 1, P.hit.__name__: 1} for P in planes.values()])
    return totals


def hash_phase(vals, runs):
    """Phase 10 (b): a 10,000-validator set's hash() cold (a copy without the
    leaf memo) and memoized; its leaves' root, proofs and a 64-index
    multiproof on the native route and under TM_TPU_NATIVE=0 in turns
    HASH_TURNS, the same bytes on both, each proof verifying and a tampered
    one failing. No call launches a kernel."""
    import numpy as np

    m = light_modules()
    n = len(vals.validators)
    cold = m.vs.ValidatorSet(
        validators=[m.vs.Validator(v.address, v.pub_key, v.voting_power, v.proposer_priority)
                    for v in vals.validators], proposer=vals.proposer)
    totals = {}
    root, t_cold = drive("phase 10: cold hash()", cold.hash, {}, totals)
    again, t_memo = drive("phase 10: memoized hash()", cold.hash, {}, totals)
    leaves = [v.bytes() for v in cold.validators]
    idx = sorted(np.random.default_rng(n).choice(n, MULTIPROOF_INDICES, replace=False).tolist())
    got, times = {}, {route: {"root": [], "proofs": [], "multiproof": []} for route in HASH_TURNS}
    for route in HASH_TURNS:
        with native_setting(route == "python"):
            r, t = drive("phase 10: root", lambda: m.merkle.hash_from_byte_slices(leaves), {}, totals)
            times[route]["root"].append(t)
            (pr, proofs), t = drive("phase 10: proofs",
                                    lambda: m.merkle.proofs_from_byte_slices(leaves), {}, totals)
            times[route]["proofs"].append(t)
            (mr, mp), t = drive("phase 10: multiproof",
                                lambda: m.merkle.multiproof_from_byte_slices(leaves, idx), {}, totals)
            times[route]["multiproof"].append(t)
        this = (r, pr, [(p.leaf_hash, p.aunts) for p in proofs], mr, mp.leaf_hashes, mp.nodes)
        if got.setdefault(route, this) != this or got[HASH_TURNS[0]] != this:
            raise AssertionError(f"phase 10: the {route} route's hashes differ")
    if not (root == again == got["native"][0] and all(
            p.verify(root, leaf) for p, leaf in zip(proofs, leaves)) and mp.verify(
            root, [leaves[i] for i in idx])):
        raise AssertionError("phase 10: the 10,000-validator hashes or proofs do not verify")
    forged = m.merkle.Proof(n, 7, proofs[7].leaf_hash, [bytes(32)] + proofs[7].aunts[1:])
    if forged.verify(root, leaves[7]) or mp.verify(root, [leaves[idx[0]] + b"x"] + [
            leaves[i] for i in idx[1:]]):
        raise AssertionError("phase 10: a tampered proof verified")
    mean = {route: {k: float(np.mean(v)) for k, v in parts.items()} for route, parts in times.items()}
    runs.append({"plane": "ed25519", "commit": n, "run": "validator-set hash() cold", "s": t_cold})
    runs.append({"plane": "ed25519", "commit": n, "run": "validator-set hash() memoized", "s": t_memo})
    log(f"phase 10: {n}-validator set hash() cold {t_cold * 1e3:.3f} ms (leaf encodes and a native "
        f"root), memoized {t_memo * 1e6:.2f} us; root, {n} proofs, a {MULTIPROOF_INDICES}-index "
        f"multiproof, ms (means of turns {'/'.join(HASH_TURNS)}): "
        + json.dumps({r: {k: round(v * 1e3, 4) for k, v in parts.items()} for r, parts in mean.items()})
        + f"; the same bytes on both routes, every proof verifies, on {card()}")


def mixed_phase(chain_id, sets, runs):
    """Phase 10 (c), BASELINE.json config 4: verify_commit on the mixed-key
    commits (50 secp256k1 keys among 150) under each proposer: the valid
    commit accepted, a tampered secp256k1 and a tampered ed25519 signature
    reported at their index, by the reference's serial semantics, so no
    call launches a kernel."""
    from tendermint_tpu_torch.crypto import secp256k1

    m = light_modules()
    totals = {}
    for proposer_kind, (vals, bid, commit) in sets.items():
        kinds = [v.pub_key.type_name for v in vals.validators]
        proposer = vals.get_proposer().pub_key.type_name
        if proposer != proposer_kind or kinds.count("secp256k1") != MIXED_SECP:
            raise AssertionError(f"phase 10: the mixed set has a {proposer} proposer, {kinds.count('secp256k1')} "
                                 "secp256k1 keys")
        for label, bad in (("valid", None), ("secp256k1 tampered", kinds.index("secp256k1", 1)),
                           ("ed25519 tampered", kinds.index("ed25519", 1))):
            c = commit if bad is None else tampered_commit(m, commit, bad)
            got, t = drive(f"phase 10: mixed {label}", lambda: outcome(functools.partial(
                m.validation.verify_commit, chain_id, vals, bid, c.height, c)), {}, totals)
            want = "accepted" if bad is None else f"wrong signature (#{bad}):"
            if not (got[0] if bad is None else got[1]).startswith(want):
                raise AssertionError(f"phase 10: mixed {label} under a {proposer} proposer: {got}")
            runs.append({"plane": "mixed", "commit": len(kinds), "run": f"verify_commit {label}, "
                         f"{proposer} proposer", "s": t})
            log(f"phase 10: mixed-key verify_commit ({len(kinds) - MIXED_SECP} ed25519 + {MIXED_SECP} "
                f"secp256k1, {proposer} proposer) {label}: {got[0]}{' #' + str(bad) if bad is not None else ''}, "
                f"no launch, {t * 1e3:.1f} ms, secp256k1 route {secp256k1.route()}, on {card()}")


# -- phase 11: the light client, its store and providers, and evidence ---------------

ROTATION_HEIGHTS = 32
ROTATION_SWAPS = (9, 17, 25)  # a third of the set leaves at each: none of it signs 32
BACKWARDS_TO = 20
# the reference's EvidenceParams defaults (types/params.py:48-51)
EVIDENCE_PARAMS = {"max_age_num_blocks": 100000, "max_age_duration": 48 * 3600 * 10**9,
                   "max_bytes": 1048576}
FORGED_APP_HASH = b"\x66" * 32


def member_secrets(m, members):
    """Each member's address and secret."""
    return {m.keys[kind](pub).address(): secret for kind, pub, secret in members}


def resign(m, vals, secrets, sign, chain_id, header, **changes):
    """A LightBlock of vals over a copy of header with `changes`, its commit
    signed by every validator of vals."""
    import dataclasses

    header = dataclasses.replace(header, **changes)
    bid = m.block.BlockID(header.hash(), m.block.PartSetHeader(1, tagged(b"forged parts", header.height)))
    commit = signed_commit(m, vals, secrets, sign, chain_id, header.height, bid,
                           LIGHT_T0 + LIGHT_DT * header.height)
    return m.light_block.LightBlock(m.light_block.SignedHeader(header, commit), vals)


def rotation_chain(m, members, swap_in, sign, chain_id, heights=ROTATION_HEIGHTS, swap_at=ROTATION_SWAPS):
    """Phase 11's chain: light_chain with a third of the set swapped at each
    height of swap_at; the lunatic witness's block at the last height (the
    set of height 1, the common set, re-signs the header with a forged
    app_hash and itself as the validators), the equivocating witness's (the
    height's own set signs it again, same round, with another data_hash),
    and two precommits of one validator at the last height for two block
    IDs."""
    blocks, _ = light_chain(m, members, swap_in, None, sign, chain_id, heights, swap_at)
    secrets = member_secrets(m, list(members) + list(swap_in))
    header = blocks[heights].signed_header.header
    common, last = blocks[1].validator_set, blocks[heights].validator_set
    lunatic = resign(m, common, secrets, sign, chain_id, header, app_hash=FORGED_APP_HASH,
                     validators_hash=common.hash(), next_validators_hash=common.hash(),
                     proposer_address=common.get_proposer().address)
    equivocation = resign(m, last, secrets, sign, chain_id, header,
                          data_hash=tagged(b"other data", heights))
    val = last.validators[0]
    votes = []
    for tag in (b"vote a", b"vote b"):
        v = m.vote.Vote(type=m.vote.PRECOMMIT, height=heights, round=0,
                        block_id=m.block.BlockID(tagged(tag, heights),
                                                 m.block.PartSetHeader(1, tagged(tag + b" parts", heights))),
                        timestamp=header.time, validator_address=val.address, validator_index=0)
        v.signature = sign([secrets[val.address]], [v.sign_bytes(chain_id)])[0]
        votes.append(v)
    return SimpleNamespace(blocks=blocks, lunatic=lunatic, equivocation=equivocation, votes=votes)


class ChainStore:
    """A stand-in for a node's block store and state store over {height:
    LightBlock}: what LocalProvider and verify_evidence read. A height's
    canonical commit is the next block's last commit, so the tip has only
    its seen commit."""

    def __init__(self, blocks):
        self.blocks = blocks

    def height(self):
        return max(self.blocks)

    def load_block_meta(self, h):
        lb = self.blocks.get(h)
        return None if lb is None else SimpleNamespace(header=lb.signed_header.header)

    def load_block_commit(self, h):
        return self.blocks[h].signed_header.commit if h in self.blocks and h < self.height() else None

    def load_seen_commit(self, h):
        lb = self.blocks.get(h)
        return None if lb is None else lb.signed_header.commit

    def load_validators(self, h):
        lb = self.blocks.get(h)
        return None if lb is None else lb.validator_set


def chain_provider(m, chain_id, blocks, name):
    """A LocalProvider of m's package over ChainStore(blocks), recording the
    heights it is asked for in `.fetched`."""

    class ChainProvider(m.light.LocalProvider):
        def light_block(self, height):
            self.fetched.append(height)
            return super().light_block(height)

    store = ChainStore(blocks)
    provider = ChainProvider(chain_id, store, store, name)
    provider.fetched = []
    return provider


def chain_state(blocks, chain_id):
    """A stand-in for a full node's state at the chain's tip."""
    top = blocks[max(blocks)].signed_header.header
    return SimpleNamespace(chain_id=chain_id, last_block_height=top.height, last_block_time=top.time,
                           consensus_params=SimpleNamespace(evidence=SimpleNamespace(**EVIDENCE_PARAMS)))


def trust_passes(trusted, target, frac=(1, 3)):
    """Whether the validators of `trusted` in `target` (every one of which
    signs) hold more than frac of trusted's power."""
    addrs = {v.address for v in target.validators}
    held = sum(v.voting_power for v in trusted.validators if v.address in addrs)
    return held > trusted.total_voting_power() * frac[0] // frac[1]


def bisection_model(blocks, lo, hi):
    """Skipping verification from lo to hi worked out from the sets alone:
    ([(trusted height, target height, passes)], the midpoints fetched)."""
    steps, mids, verified, pending = [], [], [lo], [hi]
    while pending:
        cur, cand = verified[-1], pending[-1]
        ok = cand == cur + 1 or trust_passes(blocks[cur].validator_set, blocks[cand].validator_set)
        steps.append((cur, cand, ok))
        if ok:
            verified.append(cand)
            pending.pop()
        else:
            mids.append((cur + cand) // 2)
            pending.append(mids[-1])
    return steps, mids


@contextlib.contextmanager
def traced_client(m, counts=None):
    """Routes m's light client's verifier calls through a recorder: each
    verify_adjacent / verify_non_adjacent call appends [name, trusted
    height, target height, outcome class, seconds, launches] to the yielded
    list (launches: the change of counts(), or None)."""
    real = m.client.vf
    trace = []

    def recorded(fn, trusted_at, target_at):
        def call(*a, **k):
            before = counts() if counts else None
            got = "accepted"
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            except Exception as e:
                got = type(e).__name__
                raise
            finally:
                t = time.perf_counter() - t0
                launched = None if before is None else {
                    n: c - before.get(n, 0) for n, c in counts().items() if c != before.get(n, 0)}
                trace.append([fn.__name__, a[trusted_at].header.height, a[target_at].header.height, got, t,
                              launched])
        return call

    proxy = SimpleNamespace(**{k: getattr(real, k) for k in dir(real) if not k.startswith("__")})
    proxy.verify_adjacent = recorded(real.verify_adjacent, 1, 2)
    proxy.verify_non_adjacent = recorded(real.verify_non_adjacent, 1, 3)
    m.client.vf = proxy
    try:
        yield trace
    finally:
        m.client.vf = real


def stored_heights(store):
    """The heights a MemLightStore or DBLightStore holds, ascending (from its
    keys, without decoding a block)."""
    return sorted(store._blocks) if hasattr(store, "_blocks") else sorted(store._heights())


def client_script(m, chain, chain_id, stores=("mem", "db"), backwards_to=BACKWARDS_TO, device=None,
                  counts=None):
    """Phase 11's calls on m's package, in order, as a generator: it yields
    (label, call, the validator sets whose 2/3 commit checks the call runs,
    the expected outcome) and is sent each call's outcome ("accepted", "")
    or (error class, message); it checks what each call fetched, persisted,
    reported and built, and returns {"facts": what the CPU tests compare
    across packages, "trace": the verifier calls [name, from, to, outcome,
    seconds, launches], "times": {the detections' seconds}}.

    (a) From trust at height 1, verify to the last height skipping (the
    bisection worked out by bisection_model), sequentially, and backwards
    from the last height to backwards_to (a hash-chain walk, no commit
    check), once over a MemLightStore and once over DBLightStore(MemDB());
    (b) skipping with an honest, a lunatic and an equivocating witness:
    each lying witness raises ErrLightClientAttack, leaves only the trust
    root persisted and reports its evidence to both providers; (c) the full
    node's verify_evidence over ChainStore and chain_state: both pieces of
    evidence and a duplicate vote accepted, then the refusals."""
    import copy

    L, blocks = m.light, chain.blocks
    top = max(blocks)
    kw = {} if device is None else {"device": device}
    now = m.tmtime.Time(LIGHT_T0 + LIGHT_DT * top + 60)
    ok = ("accepted", "")
    facts, times, held = {}, {}, {}
    steps, mids = bisection_model(blocks, 1, top)
    skipped = [blocks[to].validator_set for _, to, passes in steps if passes]
    sequential = [blocks[h].validator_set for h in range(2, top + 1)]
    want_trace = {"skipping": [["verify_adjacent" if to == cur + 1 else "verify_non_adjacent", cur, to,
                                "accepted" if passes else "ErrNewValSetCantBeTrusted"]
                               for cur, to, passes in steps],
                  "sequential": [["verify_adjacent", h - 1, h, "accepted"] for h in range(2, top + 1)]}
    want_heights = {"skipping": [1] + [to for _, to, passes in steps if passes],
                    "sequential": list(range(1, top + 1)), "backwards": [backwards_to, top]}
    want_fetched = {"skipping": [1, top] + mids, "sequential": [1, top] + list(range(2, top)),
                    "backwards": list(range(top, backwards_to - 1, -1))}

    def expect(what, got, want):
        if got != want:
            raise AssertionError(f"phase 11: {what}: {got}, expected {want}")

    def client(name, trusted_at, store, mode=m.client.SKIPPING, witnesses=()):
        primary = chain_provider(m, chain_id, blocks, "primary")
        options = L.TrustOptions(period_ns=TRUSTING_PERIOD_NS, height=trusted_at,
                                 hash=blocks[trusted_at].signed_header.hash())

        def call():
            held[name] = L.LightClient(chain_id, options, primary, witnesses=list(witnesses),
                                       trusted_store=store, verification_mode=mode, clock=lambda: now, **kw)
        return primary, call

    with traced_client(m, counts) as trace:
        # (a) the three modes, over each store
        for kind in stores:
            for mode in ("skipping", "sequential", "backwards"):
                db = m.kv.MemDB() if kind == "db" else None
                store = L.MemLightStore() if db is None else L.DBLightStore(db)
                trusted_at = top if mode == "backwards" else 1
                primary, make = client(mode, trusted_at, store,
                                       m.client.SEQUENTIAL if mode == "sequential" else m.client.SKIPPING)
                yield (f"{kind} store, {mode}: trust height {trusted_at}", make,
                       [blocks[trusted_at].validator_set], ok)
                target = backwards_to if mode == "backwards" else top
                first = len(trace)
                yield (f"{kind} store, {mode}: verify to {target}",
                       functools.partial(held[mode].verify_light_block_at_height, target),
                       {"skipping": skipped, "sequential": sequential, "backwards": []}[mode], ok)
                expect(f"{kind} {mode} verifier calls", [t[:4] for t in trace[first:]], want_trace.get(mode, []))
                expect(f"{kind} {mode} persisted", stored_heights(store), want_heights[mode])
                expect(f"{kind} {mode} fetched", primary.fetched, want_fetched[mode])
                facts[f"{kind} {mode}"] = (stored_heights(store), primary.fetched,
                                           [t[:4] for t in trace[first:]])
                if db is not None:
                    facts[f"{kind} {mode} kv"] = list(db.iterator())

        # (b) witnesses
        evidence = {}
        for name, forged in (("honest", None), ("lunatic", chain.lunatic), ("equivocation", chain.equivocation)):
            served = blocks if forged is None else {**blocks, top: forged}
            witness = chain_provider(m, chain_id, served, f"{name} witness")
            store = L.MemLightStore()
            primary, make = client(name, 1, store, witnesses=[witness])
            yield f"{name} witness: trust height 1", make, [blocks[1].validator_set], ok
            c = held[name]
            detect = c._detect_divergence

            def timed_detect(*a, _detect=detect, _name=name):
                t0 = time.perf_counter()
                try:
                    return _detect(*a)
                finally:
                    times[f"detection, {_name} witness"] = time.perf_counter() - t0

            c._detect_divergence = timed_detect
            want = ok if forged is None else ("ErrLightClientAttack", f"witness {name} witness has a different header")
            yield (f"{name} witness: verify to {top}", functools.partial(c.verify_light_block_at_height, top),
                   skipped, want)
            ev = c.latest_attack_evidence
            if forged is None:
                expect("honest witness: evidence", ev, None)
                expect("honest witness: persisted", stored_heights(store), want_heights["skipping"])
                continue
            expect(f"{name} witness: persisted", stored_heights(store), [1])
            expect(f"{name} witness: reports", (primary.evidence, witness.evidence), ([ev], [ev]))
            common = 1 if name == "lunatic" else top
            byzantine = blocks[common].validator_set if name == "lunatic" else blocks[top].validator_set
            expect(f"{name} evidence", (ev.common_height, ev.total_voting_power, sorted(
                v.address for v in ev.byzantine_validators)), (common, byzantine.total_voting_power(), sorted(
                    v.address for v in byzantine.validators)))
            facts[f"{name} evidence"] = (ev.to_proto().encode(), ev.hash(), stored_heights(store))
            evidence[name] = ev

        # (c) the full node's side
        node, state = ChainStore(blocks), chain_state(blocks, chain_id)
        V = m.ev
        verify = lambda e: functools.partial(V.verify_evidence, e, state, node, node, **kw)
        last = blocks[top].validator_set
        dup = m.evidence.DuplicateVoteEvidence.new(*chain.votes, blocks[top].signed_header.header.time, last)
        facts["duplicate vote evidence"] = (dup.to_proto().encode(), dup.hash())
        yield "verify_evidence: lunatic", verify(evidence["lunatic"]), [], ok
        yield "verify_evidence: equivocation", verify(evidence["equivocation"]), [last], ok
        yield "verify_evidence: duplicate vote", verify(dup), [], ok
        bad = copy.deepcopy(evidence["lunatic"])
        bad.total_voting_power += 7

        def tampered():
            try:
                V.verify_evidence(bad, state, node, node, **kw)
            except V.EvidenceABCIError as e:
                held["regenerate"] = e.regenerate
                raise

        yield "verify_evidence: lunatic, total power tampered", tampered, [], (
            "EvidenceABCIError", "total voting power from the evidence and our validator set does not match")

        def regenerated():
            held["regenerate"]()
            V.verify_evidence(bad, state, node, node, **kw)

        yield "verify_evidence: lunatic, regenerated", regenerated, [], ok
        expect("regenerated evidence", bad.to_proto().encode(), evidence["lunatic"].to_proto().encode())
        rewritten = copy.deepcopy(evidence["lunatic"])
        rewritten.conflicting_block.signed_header.header.proposer_address = b"\x01" * 20
        yield "verify_evidence: conflicting header rewritten after signing", verify(rewritten), [], (
            "EvidenceVerifyError", "invalid evidence: invalid conflicting light block")
        unknown = copy.deepcopy(evidence["lunatic"])
        unknown.common_height = top + 100
        yield f"verify_evidence: common height {top + 100}", verify(unknown), [], (
            "EvidenceVerifyError", "common height has to be less than equal")
        forged_vote = copy.deepcopy(dup)
        forged_vote.vote_b.signature = bytes(64)
        yield "verify_evidence: duplicate vote, vote B's signature forged", verify(forged_vote), [], (
            "EvidenceVerifyError", "verifying VoteB: invalid signature")
        bad_sig = (len(last.validators) * 5) // 12
        forged_commit = copy.deepcopy(evidence["equivocation"])
        cs_ = forged_commit.conflicting_block.signed_header.commit.signatures[bad_sig]
        cs_.signature = tamper(cs_.signature)
        yield f"verify_evidence: equivocation, signature #{bad_sig} forged", verify(forged_commit), [last], (
            "EvidenceVerifyError", f"verifying conflicting commit: wrong signature (#{bad_sig})")
        return {"facts": facts, "trace": [list(t) for t in trace], "times": times}


def run_script(script, step):
    """Drive a client_script: step(label, call, checked, want) returns the
    call's outcome, which must be `want` (its class, a fragment of its
    message); returns the script's result."""
    try:
        item = next(script)
        while True:
            label, call, checked, want = item
            got = step(label, call, checked, want)
            if got[0] != want[0] or want[1] not in got[1]:
                raise AssertionError(f"phase 11: {label}: {got}, expected {want}")
            item = script.send(got)
    except StopIteration as done:
        return done.value


def client_setup(pool, rng, chain_id):
    """Phase 11's chain on each plane, signed at set-up."""
    m = light_modules()

    def sign(secrets, msgs):
        return [sigs[0] for _, sigs in pool.map(
            _sign_worker, [(kind, seed, [msg]) for (kind, seed), msg in zip(secrets, msgs)],
            chunksize=16)]

    n, swaps = LIGHT_VALIDATORS, len(ROTATION_SWAPS)
    chains = {}
    for kind in PLANES:
        seeds = [rng.bytes(32) for _ in range(n + swaps * (n // 3))]
        fresh = [(kind, pub, (kind, seed)) for pub, seed in zip(make_keys(pool, kind, seeds), seeds)]
        chains[kind] = rotation_chain(m, fresh[:n], fresh[n:], sign, chain_id)
    return chains


def client_phase(planes, chain_id, chains, runs):
    """Phase 11 on each plane: every call of client_script with its launch
    counters zeroed just before it and read just after, held to the
    launches worked out from the keys its commit checks tally (a fill when
    one is new to the phase, then a hit; a check below the cutover, none);
    logs each call's wall time with the garbage collections inside it, each
    bisection step with its launches, the sequential syncs' adjacent steps
    and the detections' cost."""
    import gc

    m = light_modules()
    totals = {}
    paused = {"s": 0.0, "t0": None}

    def on_gc(stage, info):
        if stage == "start":
            paused["t0"] = time.perf_counter()
        elif paused["t0"] is not None:
            paused["s"] += time.perf_counter() - paused["t0"]
            paused["t0"] = None

    gc.callbacks.append(on_gc)
    try:
        for kind, P in planes.items():
            _client_plane(m, kind, P, chain_id, chains[kind], runs, totals, paused)
    finally:
        gc.callbacks.remove(on_gc)
    check_path("phase 11", totals, [{P.fill.__name__: 1, P.hit.__name__: 1} for P in planes.values()])
    return totals


def _client_plane(m, kind, P, chain_id, chain, runs, totals, paused):
    """Phase 11 on one plane; `paused` sums the interpreter's garbage
    collections, which each call's line reports beside its time."""
    from tendermint_tpu_torch.crypto import ed25519 as ed

    seen, plane_totals = set(), {}

    def step(label, call, checked, want):
        expect = {}
        for vals in checked:
            keys = light_counted(vals)
            if len(keys) >= ed.DEVICE_BATCH_CUTOVER:
                expect[P.hit.__name__] = expect.get(P.hit.__name__, 0) + 1
                if not seen.issuperset(keys):
                    expect[P.fill.__name__] = expect.get(P.fill.__name__, 0) + 1
                seen.update(keys)
        gc0 = paused["s"]
        got, t = drive(f"phase 11: {kind} {label}", lambda: outcome(call), expect, plane_totals)
        runs.append({"plane": kind, "commit": LIGHT_VALIDATORS, "run": f"client {label}", "s": t})
        log(f"phase 11: {kind} {label}: {got[0]}{' (' + got[1][:70] + ')' if got[1] else ''}, "
            f"launches {json.dumps(expect)}, {t * 1e3:.2f} ms (garbage collection "
            f"{(paused['s'] - gc0) * 1e3:.2f}) on {card()}")
        return got

    done = run_script(client_script(m, chain, chain_id, counts=read_counts), step)
    adjacent = []
    for name, trusted, target, got, t, launched in done["trace"]:
        if got == "ErrNewValSetCantBeTrusted" and launched:
            raise AssertionError(f"phase 11: {kind} {name} {trusted} -> {target} failed after launching "
                                 f"{launched}")
        if name == "verify_adjacent":
            adjacent.append(t)
            continue
        log(f"phase 11: {kind} bisection step {trusted} -> {target}: {got}, launches "
            f"{json.dumps(launched)}, {t * 1e3:.2f} ms on {card()}")
    log(f"phase 11: {kind} {len(adjacent)} adjacent steps (sequential syncs): mean "
        f"{sum(adjacent) / len(adjacent) * 1e3:.2f} ms, min {min(adjacent) * 1e3:.2f}, max "
        f"{max(adjacent) * 1e3:.2f}, one hit each, on {card()}")
    for what, t in done["times"].items():
        log(f"phase 11: {kind} {what}: {t * 1e3:.3f} ms on {card()}")
    for name, c in plane_totals.items():
        totals[name] = totals.get(name, 0) + c


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0, help="seed of every key, message and scalar")
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after holding the kernels against their plain versions")
    ap.add_argument("--ab-parent", metavar="DIR",
                    help="after phase 4, time the RLC kernels, the uncached bitmaps, the fills and "
                         "the cache hits of the tree unpacked at DIR against this tree's, in turns")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    # the exact-launch phases run with the cutovers fixed: the autotune's
    # probe launches from a thread at an unknown time (phase 8 runs it)
    os.environ["TM_TPU_AUTOTUNE"] = "off"
    # the main path's host prep is the native one; phase 4 times both routes
    os.environ.pop("TM_TPU_NATIVE", None)
    sys.path.insert(0, ROOT)
    try:
        from tendermint_tpu_torch import native
        from tendermint_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: the port package is missing: {e}", file=sys.stderr)
        return 2

    import multiprocessing
    import tempfile

    import numpy as np

    from tendermint_tpu_torch.parallel import sharded_verify as SV

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    card_line = card()
    clock_mhz = float(nvidia_smi("clocks.max.sm"))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    int32_rate = sms * INT32_LANES_PER_SM * clock_mhz * 1e6
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; {sms} SMs at {clock_mhz:.0f} MHz max")

    # phase 1
    t0 = time.perf_counter()
    reports = _build.build_all()
    log(f"phase 1: built {sorted(reports) or 'nothing (cached)'} in {time.perf_counter() - t0:.1f} s")
    for name, rep in reports.items():
        for fn, regs, spills in ptxas_functions(rep):
            log(f"phase 1: {name}: {fn}: {regs} registers, {spills}")
    t0 = time.perf_counter()
    cmd = native.build()
    log(f"phase 1: native host prep: `{' '.join(cmd or native.command(native.target()))}` "
        + (f"built in {time.perf_counter() - t0:.1f} s" if cmd else "(already built)"))
    native.load_prep()

    rng = np.random.default_rng(args.seed)
    planes = {kind: plane(kind) for kind in PLANES}
    errs = {}
    for P in planes.values():
        errs.update(check_kernels(rng, dev, P))
    errs.update(check_fail_count(rng, dev))
    if args.kernels_only:
        log(f"kernels only: stopping after phase 2 on {card_line}")
        return 0

    chain_id = "chip-smoke"
    workers = max(1, min(8, os.cpu_count() or 1))
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(workers) as pool:
        keys = {}
        for kind in PLANES:
            t0 = time.perf_counter()
            seeds = [rng.bytes(32) for _ in range(SIZES[-1])]
            keys[kind] = seeds, make_keys(pool, kind, seeds)
            log(f"phase 3: {len(seeds)} {kind} validator keys in {time.perf_counter() - t0:.1f} s")
        commits, bad_index, counts, runs = main_path(pool, rng, keys, chain_id)
        t0 = time.perf_counter()
        commits9 = engine_commits(pool, rng, keys, chain_id)
        log(f"phase 9: its commits signed in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        chains10, mixed10 = light_setup(pool, rng, chain_id)
        log(f"phase 10: its light chains and mixed-key commits signed in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        chains11 = client_setup(pool, rng, chain_id)
        log(f"phase 11: its rotating chains, forged blocks and votes signed in {time.perf_counter() - t0:.1f} s")
    kernels = []
    for kind, P in planes.items():
        kernels += kernels_at_main_path(P, dev, rng, chain_id, commits[kind], bad_index, counts, errs,
                                        int32_rate, runs)
    if args.ab_parent:
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            ab_parent(planes, dev, chain_id, commits, bad_index, rng, os.path.abspath(args.ab_parent), tmp)
        log(f"phase 4: the A/B against {args.ab_parent} in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    kernels += geometry_path(planes, dev, chain_id, commits, bad_index, errs, int32_rate, runs)
    log(f"phase 5: the cache geometries in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    kernels += rlc_cache_path(planes["ed25519"], dev, rng, chain_id, commits["ed25519"], bad_index,
                              errs, int32_rate, runs)
    log(f"phase 6: the cached RLC in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    meshes = {"1": SV.make_mesh(), "4": SV.make_mesh(4, device=dev)}
    with tempfile.TemporaryDirectory() as tmp:
        counts = sharded_path(planes, meshes, dev, rng, chain_id, commits, bad_index, runs, tmp)
    kernels += kernels_at_sharded_shapes(planes, dev, rng, chain_id, commits, bad_index, counts, int32_rate)
    sharded_end_to_end(planes, meshes, dev, chain_id, commits, runs)
    log(f"phase 7: the sharded path in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        autotune_phase(tmp)
    log(f"phase 8: the autotune in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        engine_phase(planes, chain_id, commits, commits9, runs, tmp)
    log(f"phase 9: the engine in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    light_phase(planes, chain_id, chains10, runs)
    hash_phase(commits["ed25519"][SIZES[-1]][0], runs)
    mixed_phase(chain_id, mixed10, runs)
    log(f"phase 10: the light client and the hashes in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    client_phase(planes, chain_id, chains11, runs)
    log(f"phase 11: the light client's sync modes, witnesses and evidence in {time.perf_counter() - t0:.1f} s")
    for r in runs:
        extra = {k: round(v, 5) for k, v in r.items() if k.endswith("_s") and k not in ("s", "sigs_per_s")}
        log(f"run: {r['plane']} {r['run']} on {r['commit']} validators"
            + (f" at S={r['splits']}" if "splits" in r else "")
            + (f", mesh of {r['mesh']}" if "mesh" in r else "") + f": {r['s'] * 1e3:.1f} ms"
            + (f", {r['sigs_per_s']:.0f} sigs/s" if "sigs_per_s" in r else "")
            + (f" {json.dumps(extra)}" if extra else "") + f" on {card()}")
    names = {k["name"].split("[")[0] for k in kernels}
    if names != set(KERNEL_SOURCES):
        raise AssertionError(f"kernels without a main-path record: {sorted(set(KERNEL_SOURCES) - names)}")
    log(f"card {card_line}; total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card_line)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
