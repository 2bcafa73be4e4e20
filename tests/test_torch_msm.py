"""The port's RLC plane (tendermint_tpu_torch/ops/msm.py) against the JAX
package's at 8 rows: the plain versions of the RLC kernel and of the cached
RLC kernel (at S = 2, 4 and 8) give the JAX programs' verdicts on the same
inputs and the same z_raw, in both polarities; the host scalar math and
guards are the reference's, and so are the cached dispatch's three
refusals."""

import numpy as np
import pytest
import torch

from tendermint_tpu.crypto import ed25519_ref as ref
from tendermint_tpu.ops import msm as JM
from tendermint_tpu.ops import verify as JV
from tendermint_tpu_torch.ops import curve as C
from tendermint_tpu_torch.ops import field as F
from tendermint_tpu_torch.ops import msm as M
from tendermint_tpu_torch.ops import ristretto as R
from tendermint_tpu_torch.ops import verify as V

import test_torch_verify_sr as SR
from test_torch_verify import seeded_jobs

# The plain versions run many small ops: one intra-op thread per test
# worker keeps parallel workers from oversubscribing the cores.
torch.set_num_threads(1)

Z16 = bytes(range(1, 17))


def valid_edge_jobs():
    """7 honest signatures and the small-order key with identity R and
    s = 0: an all-valid batch that only the cofactored equation accepts."""
    pks, msgs, sigs = seeded_jobs(41, 7)
    pks.append(ref.small_order_points()[1])
    msgs.append(b"anything")
    sigs.append(ref.compress(ref.IDENTITY) + b"\x00" * 32)
    return pks, msgs, sigs


def _rows(pks, msgs, sigs, z_raw):
    a, r, s, k, pre = JV._prepare_batch_py(pks, msgs, sigs)
    assert pre.all()
    zk, z, zs = JM._rlc_scalars_py(s, k, len(sigs), z_raw)
    return a, r, zk, z, zs


@pytest.mark.parametrize("case", ["valid", "tampered", "wrong_key"])
def test_msm_plain_matches_jax(case):
    pks, msgs, sigs = valid_edge_jobs()
    if case == "tampered":
        sigs[3] = sigs[3][:40] + bytes([sigs[3][40] ^ 1]) + sigs[3][41:]
    elif case == "wrong_key":
        pks[5] = seeded_jobs(42, 1)[0][0]
    rows = _rows(pks, msgs, sigs, Z16 * 8)
    want = bool(JM.msm_verify_kernel(*rows))
    got = M.msm_verify_kernel(*[torch.from_numpy(np.array(x)) for x in rows])
    assert got.dtype == torch.bool and got.shape == ()
    assert bool(got) == want == (case == "valid")


def test_verify_batch_rlc_matches_reference():
    pks, msgs, sigs = valid_edge_jobs()
    z_raw = np.random.default_rng(43).bytes(16 * 8)
    assert M.collect_rlc(M.verify_batch_rlc_async(pks, msgs, sigs, z_raw=z_raw, device="cpu")) is True
    assert JM.verify_batch_rlc(pks, msgs, sigs, z_raw=z_raw) is True
    # an s >= L row is refused on the host before any launch
    s = int.from_bytes(sigs[0][32:], "little")
    sigs[0] = sigs[0][:32] + (s + ref.L).to_bytes(32, "little")
    assert M.verify_batch_rlc_async(pks, msgs, sigs, z_raw=z_raw, device="cpu") is None
    assert M.collect_rlc(None) is False


def test_rlc_scalars_match_reference():
    pks, msgs, sigs = seeded_jobs(44, 5)
    a, r, s, k, _ = JV._prepare_batch_py(pks, msgs, sigs)
    (s, k) = JV.pad_pow2_rows([s, k], 5)
    z_raw = np.random.default_rng(45).bytes(16 * 5)
    for got, want in zip(M._rlc_scalars_py(s, k, 5, z_raw), JM._rlc_scalars_py(s, k, 5, z_raw)):
        np.testing.assert_array_equal(got, want)


def test_stream_divisibility_guard(monkeypatch):
    """A row count that the stream count does not divide raises instead of
    dropping the tail rows from the sum (ops/msm.py:92-101)."""
    monkeypatch.setattr(M, "G_STREAMS", 8)
    rows = [torch.zeros((12, w), dtype=torch.uint8) for w in (32, 32, 32, 16)]
    with pytest.raises(ValueError, match="not a multiple of the stream count 8"):
        M.msm_verify_kernel(*rows, torch.zeros((1, 32), dtype=torch.uint8))
    assert M._streams(16) == 8 and M._streams(4) == 4


def test_z_raw_validation():
    assert len(M._ensure_z_raw(3, None)) == 48
    assert M._ensure_z_raw(2, Z16 * 2) == Z16 * 2
    with pytest.raises(ValueError, match="z_raw must be 32 bytes"):
        M._ensure_z_raw(2, Z16)
    assert M.verify_batch_rlc_async([], [], [], device="cpu") is None


# a permutation of the 8 keys into a 12-slot cache, so slots are not rows
SLOTS = np.array([5, 0, 11, 2, 7, 9, 3, 6], np.int32)


def _split_cache(a, splits):
    """The 8 keys' split tables (the port's plain fill, equal to the JAX
    fill's) at SLOTS of a 12-slot cache, as numpy arrays."""
    tabs, oks = (x.numpy() for x in V.build_pk_tables_split(torch.from_numpy(a), splits))
    tables = np.zeros((12,) + tabs.shape[1:], np.int16)
    cache_oks = np.zeros((12,), bool)
    tables[SLOTS], cache_oks[SLOTS] = tabs, oks
    return tables, cache_oks


@pytest.mark.parametrize("case", ["valid", "tampered", "bad_entry"])
@pytest.mark.parametrize("splits", [2, 4, 8])
def test_msm_cached_plain_matches_jax(splits, case):
    """The cached RLC with one z_raw: valid, with a tampered signature, and
    with a key whose cache entry did not decode."""
    pks, msgs, sigs = valid_edge_jobs()
    if case == "tampered":
        sigs[3] = sigs[3][:40] + bytes([sigs[3][40] ^ 1]) + sigs[3][41:]
    a, r, zk, z, zs = _rows(pks, msgs, sigs, Z16 * 8)
    tables, oks = _split_cache(a, splits)
    if case == "bad_entry":
        oks[SLOTS[2]] = False
    want = bool(JM.msm_verify_kernel_cached(tables, oks, SLOTS, r, zk, z, zs))
    got = M.msm_verify_kernel_cached(*[torch.from_numpy(np.array(x))
                                       for x in (tables, oks, SLOTS, r, zk, z, zs)])
    assert got.dtype == torch.bool and got.shape == ()
    assert bool(got) == want == (case == "valid")


@pytest.fixture
def spies(monkeypatch):
    """Fresh pubkey caches, and a record of the RLC kernels and preps the
    cached dispatch calls."""
    monkeypatch.setattr(V, "_PK_CACHES", {})
    calls = []
    for name in ("msm_verify_kernel", "msm_verify_kernel_cached", "prepare_batch",
                 "verify_batch_rlc_async"):
        fn = getattr(M, name)
        monkeypatch.setattr(M, name, lambda *a, _fn=fn, _name=name, **k: calls.append(_name)
                            or _fn(*a, **k))
    return monkeypatch, calls


def test_rlc_cached_precheck_refusal_touches_no_cache(spies):
    """A malformed row refuses the batch before the cache is touched: none
    of its keys is inserted."""
    _, calls = spies
    pks, msgs, sigs = valid_edge_jobs()
    s = int.from_bytes(sigs[0][32:], "little")
    sigs[0] = sigs[0][:32] + (s + ref.L).to_bytes(32, "little")
    assert M.verify_batch_rlc_cached_async(pks, msgs, sigs, z_raw=Z16 * 8, device="cpu") is None
    cache = V.pubkey_cache("cpu")
    assert not cache._lru and not cache._pending and not cache._pinned
    assert calls == ["prepare_batch"]


def test_rlc_cached_overflow_takes_uncached_kernel(spies):
    """More distinct keys than the cache holds: the uncached kernel, on the
    prep and scalars already made, and no key inserted."""
    monkeypatch, calls = spies
    monkeypatch.setitem(V._PK_CACHES, ("ed25519", 4, "cpu"), V.PubkeyCache(capacity=4, device="cpu"))
    pks, msgs, sigs = valid_edge_jobs()
    handle = M.verify_batch_rlc_cached_async(pks, msgs, sigs, z_raw=Z16 * 8, device="cpu")
    assert M.collect_rlc(handle) is True
    assert calls == ["prepare_batch", "msm_verify_kernel"]
    assert not V.pubkey_cache("cpu")._lru


def test_rlc_cached_single_table_takes_uncached_dispatch(spies):
    """A single-table cache (S = 1) has no split tables for the cached RLC:
    the batch goes to verify_batch_rlc_async."""
    monkeypatch, calls = spies
    monkeypatch.setenv("TM_TPU_PK_SPLIT", "1")
    pks, msgs, sigs = valid_edge_jobs()
    handle = M.verify_batch_rlc_cached_async(pks, msgs, sigs, z_raw=Z16 * 8, device="cpu")
    assert M.collect_rlc(handle) is True
    assert calls == ["verify_batch_rlc_async", "prepare_batch", "msm_verify_kernel"]
    assert not V.pubkey_cache("cpu")._lru


def test_rlc_cached_fills_then_hits(spies):
    """Through an empty split cache the batch's keys are filled once and
    the cached kernel runs; tampered, it reports false."""
    _, calls = spies
    pks, msgs, sigs = valid_edge_jobs()
    assert M.collect_rlc(M.verify_batch_rlc_cached_async(pks, msgs, sigs, z_raw=Z16 * 8,
                                                         device="cpu")) is True
    assert len(V.pubkey_cache("cpu")._lru) == 8
    sigs[5] = sigs[5][:40] + bytes([sigs[5][40] ^ 1]) + sigs[5][41:]
    assert M.collect_rlc(M.verify_batch_rlc_cached_async(pks, msgs, sigs, z_raw=Z16 * 8,
                                                         device="cpu")) is False
    assert calls == ["prepare_batch", "msm_verify_kernel_cached"] * 2


# -- the RLC kernels' launch geometry and order of summation (csrc/msm.cuh) --

# Row counts the wrappers hand the RLC kernels: pad_pow2_rows' powers of
# two and shard_rows' multiples of 256, up to 2^17.
PADDED_ROWS = sorted({1 << e for e in range(18)} | set(range(256, (1 << 17) + 1, 256)))


def _window_rows(n, g, chunks, threads, blocks):
    """The rows each windows-step thread of one column walks, as the kernel
    indexes them: thread tid is chunk tid % K of stream tid // K, and chunk
    k walks rounds [k R / K, (k + 1) R / K) of the R = n / g rounds, row
    stream + g * round. Returns (rows, per-chunk lengths)."""
    tid = np.arange(blocks * threads)
    stream, k = tid // chunks, tid % chunks
    live = stream < g
    stream, k = stream[live], k[live]
    rounds = n // g
    lo, hi = k * rounds // chunks, (k + 1) * rounds // chunks
    lengths = hi - lo
    starts = np.repeat(np.cumsum(lengths) - lengths, lengths)
    r = np.repeat(lo, lengths) + np.arange(lengths.sum()) - starts
    return np.repeat(stream, lengths) + g * r, lengths


@pytest.mark.parametrize("sms", [1, 66, 132])
@pytest.mark.parametrize("streams", [1, 2, 128, 1024])
def test_window_geometry_covers_every_row(monkeypatch, streams, sms):
    """For every padded row count: K is a power of two that leaves no chunk
    empty and keeps a stream's chunks in one block; each column's threads
    walk every row exactly once; the partial sums and window sums the
    kernels write fit the scratch the wrapper allocates; row counts the
    stream count does not divide still raise."""
    monkeypatch.setattr(M, "G_STREAMS", streams)
    for n in PADDED_ROWS:
        if n % min(streams, n):
            with pytest.raises(ValueError, match="not a multiple of the stream count"):
                M._streams(n)
            continue
        g = M._streams(n)
        k = M._window_chunks(n, g, sms)
        assert k & (k - 1) == 0 and 1 <= k <= min(n // g, M.WINDOW_BLOCK), (n, g, k)
        threads = min(M.WINDOW_BLOCK, g * k)
        blocks = -(-g * k // threads)
        assert threads % k == 0 and blocks * threads >= g * k
        rows, lengths = _window_rows(n, g, k, threads, blocks)
        assert lengths.min() >= 1 and lengths.max() <= max(n // g // k + 1, 1)
        assert rows.size == n and np.array_equal(np.bincount(rows, minlength=n), np.ones(n, int)), (n, g, k)
        tabs, oks, part, ws = M._msm_scratch(n, g, "meta")
        assert tabs.shape == (2 * n, 16, 40) and oks.shape == (2 * n,)
        # point c * g + s of part, limb i at i * stride (csrc ge_store)
        assert part.shape == (40, M.MSM_COLS * g) and (M.MSM_COLS - 1) * g + g - 1 < part.shape[1]
        assert ws.shape == (40, 64)


def test_window_chunks_fill_the_card():
    """At the main path's shapes on 132 SMs the windows grid holds at least
    two resident waves and a thread walks at most MAX_CHUNK_ROUNDS rows."""
    for n in (1024, 2560, 10240, 16384, 1 << 17):
        g = M._streams(n)
        k = M._window_chunks(n, g, 132)
        assert M.MSM_COLS * g * k >= 2 * M.RESIDENT_PER_SM * 132 or k == min(n // g, M.WINDOW_BLOCK)
        assert n // g // k <= M.MAX_CHUNK_ROUNDS
    assert M._window_chunks(16384, 128, 132) == 8 and M._window_chunks(1024, 128, 132) == 8


def _add(p, q):
    return C.point_add(p, q, out_t=True)


def _identity_like(p):
    return C.identity_point(p.shape[2:], p.device)


def _kernel_order_total(neg, nibs_zk, nibs_z, n, g, chunks):
    """A model of csrc/msm.cuh's order of summation, in the plain curve
    ops: each of the 96 columns' (stream, chunk) sums from its first entry,
    the block's tree over a stream's chunks, the reduce (each of 64 threads
    over the streams t, t + 64, ... of the window's A column, then its R
    column, from the identity; then a tree over the threads), and Horner
    over the 64 window sums (4 doublings and one addition a window). Each
    step's skipped additions are additions of the identity here. Returns
    the (4, 32, 1) sum with T."""
    table = C._build_var_table(neg).permute(3, 0, 1, 2)  # (2n, 16, 4, 32)
    row = torch.arange(n)[None, :]
    entries = torch.cat([table[row, nibs_zk.long()], table[n + row, nibs_z.long()]])  # (96, n, 4, 32)
    entries = entries.permute(2, 3, 0, 1)  # (4, 32, 96, n)
    rounds = n // g
    parts = []
    for s in range(g):
        sums = []
        for k in range(chunks):
            lo, hi = k * rounds // chunks, (k + 1) * rounds // chunks
            acc = entries[..., s + g * lo]
            for r in range(lo + 1, hi):
                acc = _add(acc, entries[..., s + g * r])
            sums.append(acc)
        half = chunks // 2
        while half:
            sums[:half] = [_add(sums[i], sums[i + half]) for i in range(half)]
            half //= 2
        parts.append(sums[0])
    part = torch.stack(parts, dim=-1)  # (4, 32, 96, g)
    threads = 64
    acc = C.identity_point((64, threads), neg.device)
    ident = C.identity_point((64, threads), neg.device)
    for col_off in (0, 64):
        cols = torch.arange(64) + col_off
        for j in range(-(-g // threads)):
            s = torch.arange(threads) + threads * j
            live = (cols[:, None] < M.MSM_COLS) & (s[None, :] < g)
            p = part[:, :, cols.clamp(max=M.MSM_COLS - 1)][..., s.clamp(max=g - 1)]
            acc = _add(acc, torch.where(live, p, ident))
    half = threads // 2
    while half:
        acc = torch.cat([_add(acc[..., :half], acc[..., half:2 * half]), acc[..., half:]], dim=-1)
        half //= 2
    windows = acc[..., 0]  # (4, 32, 64)
    total = windows[..., 63:64]
    for w in range(62, -1, -1):
        for _ in range(4):
            total = C.point_double(total, out_t=True)
        total = _add(total, windows[..., w:w + 1])
    return total


def _kernel_order_comb(zs_bytes):
    """[zs]B as the tail's comb warp sums it: lane L adds entries 2L and
    2L + 1, then a tree across the 32 lanes (lane L adds lane L + off)."""
    nibbles = C.scalar_to_nibbles(zs_bytes)[:, 0]
    table = torch.as_tensor(C.fixed_base_table())  # (64, 16, 4, 32)
    entries = table[torch.arange(64), nibbles.long()].permute(1, 2, 0)  # (4, 32, 64)
    lanes = _add(entries[..., 0::2], entries[..., 1::2])
    off = 16
    while off:
        lanes = torch.cat([_add(lanes[..., :off], lanes[..., off:2 * off]), lanes[..., off:]], dim=-1)
        off //= 2
    return lanes[..., 0:1]


def _affine(p):
    """Canonical affine (x, y) limbs of a (4, 32, 1) point."""
    zinv = F.fe_invert(p[2])
    return F.fe_canonical(F.fe_mul(p[0], zinv)), F.fe_canonical(F.fe_mul(p[1], zinv))


def _edge_encodings_jobs():
    """Valid under ZIP-215 only: honest signatures beside the small-order
    key with identity R and s = 0, the key y = p + 1 (non-canonical, decodes
    as y = 1) and x = 0 with the sign bit set (decodes as x = 0)."""
    pks, msgs, sigs = seeded_jobs(46, 5)
    ident = ref.compress(ref.IDENTITY)
    neg_zero = bytearray(ident)
    neg_zero[31] |= 0x80
    pks += [ref.small_order_points()[1], (ref.P + 1).to_bytes(32, "little"), bytes(neg_zero)]
    msgs += [b"anything", b"y>=p", b"-0"]
    sigs += [ident + bytes(32), ident + bytes(32), bytes(neg_zero) + bytes(32)]
    return pks, msgs, sigs


def _sr_jobs(case):
    pks, msgs, sigs = SR.seeded_jobs(78, 7)
    for col, v in zip((pks, msgs, sigs), SR.zero_row()):
        col.append(v)
    if case == "tampered":
        sigs[3] = sigs[3][:40] + bytes([sigs[3][40] ^ 1]) + sigs[3][41:]
    elif case == "wrong_key":
        pks[5] = SR.seeded_jobs(79, 1)[0][0]
    elif case == "encodings":  # a non-canonical key (RFC 9496): it does not decode
        pks[2] = bytes.fromhex(SR.BAD_ENCODINGS[0])
    return pks, msgs, sigs


def _ed_jobs(case):
    pks, msgs, sigs = _edge_encodings_jobs() if case == "encodings" else valid_edge_jobs()
    if case == "tampered":
        sigs[3] = sigs[3][:40] + bytes([sigs[3][40] ^ 1]) + sigs[3][41:]
    elif case == "wrong_key":
        pks[5] = seeded_jobs(42, 1)[0][0]
    return pks, msgs, sigs


@pytest.mark.parametrize("case", ["valid", "tampered", "wrong_key", "encodings"])
@pytest.mark.parametrize("plane", ["ed25519", "sr25519"])
def test_kernel_summation_order_matches_reference(plane, case):
    """The RLC kernels' order (columns, chunks, block tree, window reduce,
    Horner over window sums, comb tree), modelled at 8 rows on two
    geometries, gives the point that _accumulate_windows and
    fixed_base_mul give where every row decodes, and the JAX program's
    verdict on every batch."""
    jobs = _sr_jobs(case) if plane == "sr25519" else _ed_jobs(case)
    rows = SR._rlc_rows(jobs, Z16 * 8) if plane == "sr25519" else _rows(*jobs, Z16 * 8)
    jax_fn = JM.msm_verify_sr_kernel if plane == "sr25519" else JM.msm_verify_kernel
    want = bool(jax_fn(*rows))
    assert want == (case in ("valid", "encodings") if plane == "ed25519" else case == "valid")
    a, r, zk, z, zs = (V._limb_major(torch.from_numpy(np.array(x))) for x in rows)
    n = a.shape[1]
    decode = R.decode if plane == "sr25519" else C.decompress
    pts, oks = decode(torch.cat([a, r], dim=1))
    neg = C.point_neg(pts)
    nibs_zk, nibs_z = C.scalar_to_nibbles(zk), C.scalar_to_nibbles(z)
    ref_total = M._accumulate_windows(neg, nibs_zk, nibs_z, n)
    ref_sb = C.fixed_base_mul(zs)
    sb = _kernel_order_comb(zs)
    for x, y in zip(_affine(sb), _affine(ref_sb)):
        assert torch.equal(x, y)
    decoded = bool(torch.all(oks))
    assert decoded == (case != "encodings" or plane == "ed25519")
    for g, chunks in ((2, 2), (1, 4)):
        total = _kernel_order_total(neg, nibs_zk, nibs_z, n, g, chunks)
        # an undecodable row leaves a candidate off the curve, where the
        # order of additions shows; the decode bit decides that batch
        for x, y in zip(_affine(_add(total, sb)), _affine(_add(ref_total, ref_sb))):
            assert torch.equal(x, y) or not decoded
        if plane == "sr25519":
            got = decoded and bool(torch.all(R.encode(_add(total, sb)) == 0))
        else:
            got = decoded and bool(M._cofactored_identity(total, sb))
        assert got == want, (g, chunks)
