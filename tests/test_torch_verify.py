"""The port's bitmap plane (tendermint_tpu_torch/ops/verify.py) against the
JAX package's at 8 rows: the plain versions of the uncached bitmap, the
cache fill and the cache-hit bitmap equal the JAX programs exactly, on a
seeded batch with tampered rows and the ZIP-215 edge vectors; the pubkey
cache keeps the reference's LRU contract and carries across from a JAX
cache snapshot."""

import numpy as np
import pytest
import torch

from tendermint_tpu.crypto import ed25519_ref as ref
from tendermint_tpu.ops import verify as JV
from tendermint_tpu_torch.ops import verify as V

# The plain versions run many small ops: one intra-op thread per test
# worker keeps parallel workers from oversubscribing the cores.
torch.set_num_threads(1)


def seeded_jobs(seed: int, n: int, tamper=()):
    rng = np.random.default_rng(seed)
    pks, msgs, sigs = [], [], []
    for i in range(n):
        priv = ref.gen_privkey(rng.bytes(32))
        msg = b"vote-%d-" % i + rng.bytes(16)
        sig = ref.sign(priv, msg)
        if i in tamper:
            sig = sig[:10] + bytes([sig[10] ^ 0xFF]) + sig[11:]
        pks.append(priv[32:])
        msgs.append(msg)
        sigs.append(sig)
    return pks, msgs, sigs


def edge_jobs():
    """8 rows: 3 honest, 1 tampered, s + L, a small-order key with identity
    R and s = 0 (valid), a non-point key, and x = 0 with the sign bit set."""
    pks, msgs, sigs = seeded_jobs(21, 4, tamper={2})
    s = int.from_bytes(sigs[0][32:], "little")
    pks.append(pks[0]); msgs.append(msgs[0]); sigs.append(sigs[0][:32] + (s + ref.L).to_bytes(32, "little"))
    ident = ref.compress(ref.IDENTITY)
    pks.append(ref.small_order_points()[1]); msgs.append(b"anything"); sigs.append(ident + b"\x00" * 32)
    y = 2
    while ref.decompress(int.to_bytes(y, 32, "little")) is not None:
        y += 1
    pks.append(int.to_bytes(y, 32, "little")); msgs.append(b"x"); sigs.append(sigs[1])
    neg_zero = bytearray(ident)
    neg_zero[31] |= 0x80
    pks.append(bytes(neg_zero)); msgs.append(b"-0"); sigs.append(bytes(neg_zero) + b"\x00" * 32)
    return pks, msgs, sigs


@pytest.fixture(scope="module")
def batch():
    pks, msgs, sigs = edge_jobs()
    rows = JV._prepare_batch_py(pks, msgs, sigs)
    oracle = [ref.verify(p, m, s) for p, m, s in zip(pks, msgs, sigs)]
    return (pks, msgs, sigs), rows, oracle


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def test_prepare_batch_matches_reference(batch):
    jobs, rows, _ = batch
    for got, want in zip(V.prepare_batch(*jobs), rows):
        np.testing.assert_array_equal(got, want)
    assert rows[4].tolist() == [True] * 4 + [False] + [True] * 3


def test_verify_kernel_plain_matches_jax(batch):
    _, (a, r, s, k, pre), oracle = batch
    want = np.asarray(JV.verify_kernel(a, r, s, k))
    got = V.verify_kernel(*_t(a, r, s, k))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy() & pre).tolist() == oracle
    assert oracle == [True, True, False, True, False, True, False, True]


def test_build_pk_tables_split_plain_matches_jax(batch):
    _, (a, *_), _ = batch
    jt, jo = JV.build_pk_tables_split(a)
    tt, to = V.build_pk_tables_split(*_t(a))
    assert tt.dtype == torch.int16 and tuple(tt.shape) == (8, 4, 16, 4, 32)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))


@pytest.fixture(scope="module")
def jax_cache(batch):
    """The JAX package's process-wide split cache (capacity 4096, the shape
    its own tests compile), filled with this batch's keys."""
    (pks, msgs, sigs), _, _ = batch
    want = JV.verify_batch_cached(pks, msgs, sigs)
    cache = JV.pubkey_cache()
    keys = [pk if len(pk) == 32 else b"\x00" * 32 for pk in pks]
    slots = cache.ensure(keys)
    return cache, slots, want


def test_verify_kernel_cached_split_plain_matches_jax(batch, jax_cache):
    _, (a, r, s, k, pre), oracle = batch
    cache, slots, _ = jax_cache
    tables, oks = np.asarray(cache.tables), np.asarray(cache.oks)
    want = np.asarray(JV.verify_kernel_cached_split(tables, oks, slots, r, s, k))
    got = V.verify_kernel_cached_split(*_t(tables, oks, slots, r, s, k))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy() & pre).tolist() == oracle


def test_cache_from_reference_gives_reference_bitmaps(batch, jax_cache):
    (pks, msgs, sigs), _, oracle = batch
    cache, slots, want = jax_cache
    snapshot = dict(cache._lru)
    port = V.cache_from_reference(np.asarray(cache.tables), np.asarray(cache.oks), snapshot, device="cpu")
    assert port.tables.dtype == torch.int16 and port.capacity == cache.capacity
    keys = [pk if len(pk) == 32 else b"\x00" * 32 for pk in pks]
    np.testing.assert_array_equal(port.ensure(keys), slots)  # all hits, same slots
    got = V.collect(V.dispatch_cached(port, V.prepare_batch, V.verify_kernel_cached_split,
                                      V.verify_batch_async, pks, msgs, sigs))
    np.testing.assert_array_equal(got, want)
    assert got.tolist() == oracle


def test_verify_batch_matches_reference(batch):
    (pks, msgs, sigs), _, oracle = batch
    got = V.verify_batch(pks, msgs, sigs, device="cpu")
    np.testing.assert_array_equal(got, JV.verify_batch(pks, msgs, sigs))
    assert got.tolist() == oracle


def _stub_build(enc):
    n = enc.shape[0]
    shape = V.cache_entry_shape(V.PK_SPLITS)
    return torch.zeros((n,) + shape, dtype=torch.int16), torch.ones(n, dtype=torch.bool)


def test_pubkey_cache_eviction_and_overflow():
    """The LRU contract of tests/test_batch_verify.py:83, on the port's cache
    (a stub table build: the fill kernel is held against JAX above)."""
    cache = V.PubkeyCache(capacity=4, device="cpu", build_fn=_stub_build)
    pks, _, _ = seeded_jobs(31, 3)
    slots1 = cache.ensure(pks)
    assert len(set(slots1.tolist())) == 3
    cache.ensure([pks[0]])  # refresh pk0; pk1 becomes the coldest
    pks2, _, _ = seeded_jobs(32, 2)
    cache.ensure(pks2)
    assert pks[1] not in cache._lru and pks[0] in cache._lru
    extra, _, _ = seeded_jobs(33, 1)
    slots = cache.ensure([pks[0]] + pks2 + extra)  # never evicts its own keys
    assert slots is not None and len(set(slots.tolist())) == 4
    many, _, _ = seeded_jobs(34, 5)
    assert cache.ensure(many) is None
    assert not cache._pending and not cache._pinned


def test_cache_overflow_takes_uncached_kernel():
    """More distinct keys than the cache holds: the bitmap comes from the
    uncached kernel and still localizes the bad row."""
    cache = V.PubkeyCache(capacity=4, device="cpu", build_fn=_stub_build)
    pks, msgs, sigs = seeded_jobs(35, 5, tamper={3})
    got = V.collect(V.dispatch_cached(cache, V.prepare_batch, V.verify_kernel_cached_split,
                                      V.verify_batch_async, pks, msgs, sigs))
    assert got.tolist() == [True, True, True, False, True]
    assert not cache._lru


def test_split_setting_and_devices(monkeypatch):
    monkeypatch.setattr(V, "_PK_CACHES", {})
    monkeypatch.setenv("TM_TPU_PK_SPLIT", "1")
    cache = V.pubkey_cache("cpu")
    assert tuple(cache.tables.shape) == (4096, 16, 4, 32) and cache.tables.dtype == torch.int16
    monkeypatch.setenv("TM_TPU_PK_SPLIT", "3")
    with pytest.raises(ValueError, match="TM_TPU_PK_SPLIT must be 1, 2, 4 or 8, got 3"):
        V.pubkey_cache("cpu")
    meta = torch.zeros((8, 32), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        V.verify_kernel(meta, meta, meta, meta)
    cpu = torch.zeros((8, 32), dtype=torch.uint8)
    with pytest.raises(ValueError, match="several devices"):
        V.verify_kernel(cpu, meta, cpu, cpu)
