"""The port's sharded cached plane and sharded RLC
(tendermint_tpu_torch/parallel/sharded_verify.py) against the JAX
package's, on the 8-device virtual CPU mesh of tests/conftest.py and on
make_mesh(n, device="cpu"): the cached plane on both key types at S = 4
and S = 1 (both packages' split set for the test), its overflow fallback
and its last-slot padding; the RLC with one z_raw, valid, tampered, on
shards of padding only and refused by the precheck. Bitmaps and verdicts
are compared exactly."""

import pytest
import torch

from tendermint_tpu.ops import verify as JV
from tendermint_tpu.parallel import sharded_verify as jsv
from tendermint_tpu_torch.crypto import ed25519_ref as ref
from tendermint_tpu_torch.ops import verify as V
from tendermint_tpu_torch.ops import verify_sr as VS
from tendermint_tpu_torch.parallel import sharded_verify as sv

from test_torch_sharded import Z16, _same, _tamper, fresh_caches, jobs  # noqa: F401 (fixtures)
from test_torch_verify import seeded_jobs

# The plain versions run many small ops: one intra-op thread per test
# worker keeps parallel workers from oversubscribing the cores.
torch.set_num_threads(1)


@pytest.mark.parametrize("splits", [4, 1])
@pytest.mark.parametrize("case", ["ed25519-19-tampered-3", "sr25519-64-tampered-37"])
def test_verify_batch_sharded_cached_matches_jax(jobs, fresh_caches, case, splits):
    fresh_caches(splits)
    kind, job = jobs[case]
    if kind == "sr25519":
        job = tuple(x[:12] for x in job[:2]) + (_tamper(job[2][:12], 7),)
    want = jsv.verify_batch_sharded_cached(jsv.make_mesh(3), *job, key_type=kind)
    mesh = sv.make_mesh(3, device="cpu")
    got = sv.verify_batch_sharded_cached(mesh, *job, key_type=kind)
    _same(got, want)
    assert not got[1] and sum(not ok for ok in got[0]) == 1
    cache = (V.pubkey_cache if kind == "ed25519" else VS.sr_pubkey_cache)("cpu")
    assert V.table_splits(cache.tables) == splits and len(cache._lru) == len(set(job[0]))


def test_cached_overflow_takes_the_uncached_path(jobs, fresh_caches, monkeypatch):
    """More distinct keys than a small port cache holds: the uncached
    sharded bitmap, equal to the JAX package's, and nothing cached."""
    fresh_caches(4)
    kind, job = jobs["ed25519-19-tampered-3"]
    small = V.PubkeyCache(capacity=4, device="cpu", plane="ed25519")
    monkeypatch.setitem(V._PK_CACHES, ("ed25519", 4, "cpu"), small)
    before = (sv.verify_batch_sharded.launches, sv.verify_batch_sharded_cached.launches)
    got = sv.verify_batch_sharded_cached(sv.make_mesh(3, device="cpu"), *job)
    assert (sv.verify_batch_sharded.launches, sv.verify_batch_sharded_cached.launches) == (
        before[0] + 1, before[1])
    _same(got, jsv.verify_batch_sharded(jsv.make_mesh(3), *job))
    assert not small._lru


def test_cached_pads_with_the_last_slot(fresh_caches):
    """Slot 0 holds a key that does not decode; an all-valid batch whose
    padded rows take its own last slot still verifies, on both packages
    (padding with slot 0 would fail the verdict)."""
    fresh_caches(4)
    y = 2
    while ref.decompress(y.to_bytes(32, "little")) is not None:
        y += 1
    bad_key = y.to_bytes(32, "little")
    job = seeded_jobs(143, 9)  # 9 rows over 3 shards of 8: 15 padded rows
    mesh = sv.make_mesh(3, device="cpu")
    cache = V.pubkey_cache("cpu")
    assert cache.ensure([bad_key]).tolist() == [0] and not cache.oks[0]
    JV.pubkey_cache().ensure([bad_key])
    want = jsv.verify_batch_sharded_cached(jsv.make_mesh(3), *job)
    got = sv.verify_batch_sharded_cached(mesh, *job)
    _same(got, want)
    assert got[1] and got[0].all() and 0 not in cache.ensure(job[0]).tolist()


# -- the RLC (row 16) -----------------------------------------------------------


@pytest.fixture(scope="module")
def rlc_jobs():
    return seeded_jobs(144, 64), seeded_jobs(145, 64, tamper={17})


@pytest.mark.parametrize("case", ["valid-64", "tampered-64", "valid-50", "precheck"])
def test_verify_batch_sharded_rlc_matches_jax(rlc_jobs, case):
    valid, tampered = rlc_jobs
    job = {"valid-64": valid, "tampered-64": tampered,
           "valid-50": tuple(x[:50] for x in valid),
           "precheck": valid[:2] + (valid[2][:5] + [b"\x00" * 63] + valid[2][6:],)}[case]
    z = Z16 * len(job[2])
    before = sv.verify_batch_sharded_rlc.launches
    want = jsv.verify_batch_sharded_rlc(jsv.make_mesh(8), *job, z_raw=z)
    got = sv.verify_batch_sharded_rlc(sv.make_mesh(8, device="cpu"), *job, z_raw=z)
    assert got is want is case.startswith("valid")
    assert sv.verify_batch_sharded_rlc.launches == before + (case != "precheck")


def test_verify_batch_sharded_rlc_refuses():
    mesh = sv.make_mesh(2, device="cpu")
    assert sv.verify_batch_sharded_rlc(mesh, [], [], []) is False
    with pytest.raises(ValueError, match="z_raw must be 32 bytes"):
        sv.verify_batch_sharded_rlc(mesh, *seeded_jobs(146, 2), z_raw=Z16)
