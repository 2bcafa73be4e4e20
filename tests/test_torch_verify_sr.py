"""The port's sr25519 device plane (ops/ristretto.py, ops/verify_sr.py and
the sr25519 RLC in ops/msm.py) against the JAX package's at 8 rows: the
ristretto codec, the host prep, and the plain versions of the uncached
bitmap, the cache fill, the cache-hit bitmap and the RLC check equal the
JAX programs exactly on a seeded batch with the RFC 9496 bad encodings, a
tampered R and s, a missing marker bit, s >= L and the zero row; a JAX sr
cache carries across, and the two planes keep separate caches."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tendermint_tpu.ops import msm as JM
from tendermint_tpu.ops import ristretto as JR
from tendermint_tpu.ops import verify_sr as JVS
from tendermint_tpu_torch.crypto import ed25519_ref as ref
from tendermint_tpu_torch.crypto import sr25519 as tsr
from tendermint_tpu_torch.ops import msm as M
from tendermint_tpu_torch.ops import ristretto as R
from tendermint_tpu_torch.ops import verify as V
from tendermint_tpu_torch.ops import verify_sr as VS

from test_torch_sr25519 import BAD_ENCODINGS

# The plain versions run many small ops: one intra-op thread per test
# worker keeps parallel workers from oversubscribing the cores.
torch.set_num_threads(1)

Z16 = bytes(range(1, 17))


def seeded_jobs(seed: int, n: int):
    rng = np.random.default_rng(seed)
    pks, msgs, sigs = [], [], []
    for i in range(n):
        priv = tsr.Sr25519PrivKey(rng.bytes(32))
        msg = b"sr-vote-%d-" % i + rng.bytes(12)
        pks.append(priv.pub_key().bytes())
        msgs.append(msg)
        sigs.append(priv.sign(msg))
    return pks, msgs, sigs


def zero_row():
    """Identity key, identity R, s = 0, marked: valid (the padding row)."""
    return bytes(32), b"zero", bytes(63) + b"\x80"


def edge_jobs():
    """8 rows: 2 honest, tampered s, a bad R encoding, the marker bit
    cleared, s + L, a non-square key (RFC 9496), and the zero row."""
    pks, msgs, sigs = seeded_jobs(70, 6)
    sigs[2] = sigs[2][:40] + bytes([sigs[2][40] ^ 1]) + sigs[2][41:]
    sigs[3] = bytes.fromhex(BAD_ENCODINGS[9]) + sigs[3][32:]
    sigs[4] = sigs[4][:63] + bytes([sigs[4][63] & 0x7F])
    s = int.from_bytes(sigs[5][32:], "little") & ((1 << 255) - 1)
    big = bytearray((s + tsr.L).to_bytes(32, "little"))
    big[31] |= 0x80
    sigs[5] = sigs[5][:32] + bytes(big)
    pks.append(bytes.fromhex(BAD_ENCODINGS[7])); msgs.append(msgs[0]); sigs.append(sigs[0])
    for col, v in zip((pks, msgs, sigs), zero_row()):
        col.append(v)
    return pks, msgs, sigs


ORACLE = [True, True, False, False, False, False, False, True]


@pytest.fixture(scope="module")
def batch():
    jobs = edge_jobs()
    rows = JVS.prepare_batch(*jobs)
    assert [tsr.verify(p, m, s) for p, m, s in zip(*jobs)] == ORACLE
    return jobs, rows


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def test_prepare_batch_matches_reference(batch):
    jobs, rows = batch
    for got, want in zip(VS.prepare_batch(*jobs), rows):
        np.testing.assert_array_equal(got, want)
    assert rows[4].tolist() == [True] * 4 + [False, False] + [True, True]


@pytest.fixture(scope="module")
def codec_cases():
    """(32, N) byte columns: basepoint multiples, random bytes, the RFC 9496
    bad encodings, and sign/canonicity edges."""
    cases = [tsr.ristretto_encode(ref.scalar_mult(k, ref.BASE)) for k in range(1, 9)]
    rng = np.random.default_rng(71)
    cases += [rng.bytes(32) for _ in range(8)]
    cases += [bytes.fromhex(h) for h in BAD_ENCODINGS]
    p = 2**255 - 19
    cases += [(v % 2**256).to_bytes(32, "little") for v in (0, p - 19, p - 1, p, p + 18, 2**256 - 2)]
    return cases, np.stack([np.frombuffer(c, np.uint8) for c in cases]).T.astype(np.int32)


def test_ristretto_codec_matches_jax(codec_cases):
    cases, arr = codec_cases
    jpt, jok = jax.jit(JR.decode)(jnp.asarray(arr))
    jenc = jax.jit(JR.encode)(jpt)
    pt, ok = R.decode(torch.from_numpy(arr))
    enc = R.encode(pt)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(jpt))
    np.testing.assert_array_equal(enc.numpy(), np.asarray(jenc))
    for i, c in enumerate(cases):
        host = tsr.ristretto_decode(c)
        assert (host is not None) == bool(ok[i]), i
        if host is not None:
            assert bytes(enc[:, i].numpy().astype(np.uint8)) == tsr.ristretto_encode(host) == c
    assert not ok[16:28].any()  # every RFC 9496 bad encoding is rejected
    assert bool(ok[28])  # the zero encoding is the identity


def test_verify_sr_kernel_plain_matches_jax(batch):
    _, (a, r, s, k, pre) = batch
    want = np.asarray(JVS.verify_sr_kernel(a, r, s, k))
    got = VS.verify_sr_kernel(*_t(a, r, s, k))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy() & pre).tolist() == ORACLE


def test_build_sr_tables_split_plain_matches_jax(batch):
    _, (a, *_) = batch
    jt, jo = JVS.build_sr_tables_split(a)
    tt, to = VS.build_sr_tables_split(*_t(a))
    assert tt.dtype == torch.int16 and tuple(tt.shape) == (8, 4, 16, 4, 32)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    assert to.tolist() == [True] * 6 + [False, True]


@pytest.fixture(scope="module")
def jax_sr_cache(batch):
    """The JAX package's process-wide sr25519 cache (capacity 4096), filled
    with this batch's keys."""
    jobs, _ = batch
    want = JVS.verify_batch_cached(*jobs)
    cache = JVS.sr_pubkey_cache()
    slots = cache.ensure(jobs[0])
    return cache, slots, want


def test_verify_sr_kernel_cached_split_plain_matches_jax(batch, jax_sr_cache):
    _, (a, r, s, k, pre) = batch
    cache, slots, _ = jax_sr_cache
    tables, oks = np.asarray(cache.tables), np.asarray(cache.oks)
    want = np.asarray(JVS.verify_sr_kernel_cached_split(tables, oks, slots, r, s, k))
    got = VS.verify_sr_kernel_cached_split(*_t(tables, oks, slots, r, s, k))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy() & pre).tolist() == ORACLE


def test_cache_from_reference_gives_reference_bitmaps(batch, jax_sr_cache):
    """A JAX sr cache carried across: all hits, the same slots, the JAX
    bitmap; a miss afterwards fills with the sr25519 plane's kernel."""
    jobs, _ = batch
    cache, slots, want = jax_sr_cache
    port = V.cache_from_reference(np.asarray(cache.tables), np.asarray(cache.oks), dict(cache._lru),
                                  device="cpu", plane="sr25519")
    assert port.plane == "sr25519" and port.capacity == cache.capacity
    np.testing.assert_array_equal(port.ensure(jobs[0]), slots)
    got = VS.collect(V.dispatch_cached(port, VS.prepare_batch, VS.verify_sr_kernel_cached_split,
                                       VS.verify_batch_async, *jobs))
    np.testing.assert_array_equal(got, want)
    assert got.tolist() == ORACLE
    extra = seeded_jobs(72, 1)
    (slot,) = port.ensure(extra[0])
    tabs, _ = VS.build_sr_tables_split_plain(torch.from_numpy(np.frombuffer(extra[0][0], np.uint8)[None].copy()))
    np.testing.assert_array_equal(port.tables[slot].numpy(), tabs[0].numpy())


def test_two_planes_two_caches():
    """The same 32 bytes are different points under ZIP-215 and ristretto:
    each plane has its own cache per device, filled by its own kernel."""
    sr_cache, ed_cache = VS.sr_pubkey_cache("cpu"), V.pubkey_cache("cpu")
    assert sr_cache is not ed_cache and sr_cache is VS.sr_pubkey_cache("cpu")
    assert (sr_cache.plane, ed_cache.plane) == ("sr25519", "ed25519")
    pk = seeded_jobs(73, 1)[0][0]
    (s_slot,) = sr_cache.ensure([pk])
    assert pk not in ed_cache._lru
    (e_slot,) = ed_cache.ensure([pk])
    enc = torch.from_numpy(np.frombuffer(pk, np.uint8)[None].copy())
    sr_tab, _ = VS.build_sr_tables_split_plain(enc)
    ed_tab, _ = V.build_pk_tables_split_plain(enc)
    assert torch.equal(sr_cache.tables[s_slot], sr_tab[0])
    assert torch.equal(ed_cache.tables[e_slot], ed_tab[0])
    assert not torch.equal(sr_tab, ed_tab)
    with pytest.raises(ValueError, match="no pubkey-cache plane"):
        V.PubkeyCache(capacity=2, device="cpu", plane="secp256k1")


def _rlc_rows(jobs, z_raw):
    a, r, s, k, pre = JVS.prepare_batch(*jobs)
    assert pre.all()
    zk, z, zs = JM._rlc_scalars_py(s, k, len(jobs[2]), z_raw)
    return a, r, zk, z, zs


@pytest.mark.parametrize("case", ["valid", "tampered", "wrong_key"])
def test_msm_sr_plain_matches_jax(case):
    """Row 8 with one z_raw: 7 honest signatures and the zero row."""
    pks, msgs, sigs = seeded_jobs(74, 7)
    for col, v in zip((pks, msgs, sigs), zero_row()):
        col.append(v)
    if case == "tampered":
        sigs[3] = sigs[3][:40] + bytes([sigs[3][40] ^ 1]) + sigs[3][41:]
    elif case == "wrong_key":
        pks[5] = seeded_jobs(75, 1)[0][0]
    rows = _rlc_rows((pks, msgs, sigs), Z16 * 8)
    want = bool(JM.msm_verify_sr_kernel(*rows))
    got = M.msm_verify_sr_kernel(*[torch.from_numpy(np.array(x)) for x in rows])
    assert got.dtype == torch.bool and got.shape == ()
    assert bool(got) == want == (case == "valid")


def test_verify_batch_rlc_sr_matches_reference():
    pks, msgs, sigs = seeded_jobs(76, 8)
    z_raw = np.random.default_rng(77).bytes(16 * 8)
    assert M.collect_rlc(M.verify_batch_rlc_sr_async(pks, msgs, sigs, z_raw=z_raw, device="cpu")) is True
    assert bool(JM.collect_rlc(JM.verify_batch_rlc_sr_async(pks, msgs, sigs, z_raw=z_raw))) is True
    # a row without the marker bit is refused on the host before any launch
    sigs[1] = sigs[1][:63] + bytes([sigs[1][63] & 0x7F])
    assert M.verify_batch_rlc_sr_async(pks, msgs, sigs, z_raw=z_raw, device="cpu") is None
    assert JM.verify_batch_rlc_sr_async(pks, msgs, sigs, z_raw=z_raw) is None


def test_verify_batch_matches_reference(batch):
    jobs, _ = batch
    got = VS.verify_batch(*jobs, device="cpu")
    np.testing.assert_array_equal(got, JVS.verify_batch(*jobs))
    assert got.tolist() == ORACLE
    cache = V.PubkeyCache(capacity=4, device="cpu", plane="sr25519")
    # 8 distinct keys overflow a 4-entry cache: the uncached kernel answers
    got = VS.collect(V.dispatch_cached(cache, VS.prepare_batch, VS.verify_sr_kernel_cached_split,
                                       VS.verify_batch_async, *jobs))
    assert got.tolist() == ORACLE and not cache._lru
