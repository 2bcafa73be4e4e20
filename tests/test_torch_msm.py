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
from tendermint_tpu_torch.ops import msm as M
from tendermint_tpu_torch.ops import verify as V

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
