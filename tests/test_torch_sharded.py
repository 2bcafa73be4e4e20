"""The port's sharded verification plane (tendermint_tpu_torch/parallel/)
against the JAX package's (tendermint_tpu/parallel/sharded_verify.py): the
JAX programs run on the 8-device virtual CPU mesh of tests/conftest.py,
the port on make_mesh(n, device="cpu"), which runs the plain versions once
a shard. The bitmap plane on both key types at mesh sizes 1, 3 and 8,
bitmaps and verdicts compared exactly; fail_count's plain version against
the reference's `jnp.sum(jnp.where(ok, 0, 1))`; make_mesh's refusals; the
shard schedule; the sharded RLC's per-shard scalars on the scalar pool at
mesh sizes 1, 3 and 8; and the launches a call makes a shard, on all three
entry points. The cached plane and the rest of the RLC's cases are in
test_torch_sharded_cached.py."""

import collections
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tendermint_tpu.ops import msm as JM
from tendermint_tpu.ops import verify as JV
from tendermint_tpu.ops import verify_sr as JVS
from tendermint_tpu.parallel import sharded_verify as jsv
from tendermint_tpu_torch.crypto import sr25519 as tsr
from tendermint_tpu_torch.ops import msm as M
from tendermint_tpu_torch.ops import verify as V
from tendermint_tpu_torch.parallel import sharded_verify as sv

from test_torch_verify import seeded_jobs

# The plain versions run many small ops: one intra-op thread per test
# worker keeps parallel workers from oversubscribing the cores.
torch.set_num_threads(1)

Z16 = bytes(range(1, 17))


def _tamper(sigs, i):
    sigs = list(sigs)
    sigs[i] = sigs[i][:10] + bytes([sigs[i][10] ^ 0xFF]) + sigs[i][11:]
    return sigs


def sr_jobs(n, tamper=()):
    """n sr25519 signatures of one key (the reference's sharded sr25519
    case), the rows in `tamper` with a flipped byte of R."""
    priv = tsr.Sr25519PrivKey(b"\x05" * 32)
    msgs = [b"sharded-sr-%02d" % i for i in range(n)]
    sigs = [priv.sign(m) for m in msgs]
    for i in tamper:
        sigs = _tamper(sigs, i)
    return [priv.pub_key().bytes()] * n, msgs, sigs


# name -> (key type, jobs): the cases of tests/test_batch_verify.py
CASES = {
    "ed25519-19-tampered-3": ("ed25519", lambda: seeded_jobs(141, 19, tamper={3})),
    "sr25519-64-tampered-37": ("sr25519", lambda: sr_jobs(64, tamper={37})),
    "ed25519-37-valid": ("ed25519", lambda: seeded_jobs(142, 37)),
}


@pytest.fixture(scope="module")
def jobs():
    return {name: (kind, make()) for name, (kind, make) in CASES.items()}


def _same(got, want):
    """Exact equality of (bitmap, verdict) pairs, the port's first."""
    assert got[0].dtype == bool and got[0].tolist() == np.asarray(want[0]).tolist()
    assert got[1] is bool(want[1])


# -- the bitmap plane (row 14) ------------------------------------------------


@pytest.mark.parametrize("case, mesh_size", [
    ("ed25519-19-tampered-3", 1), ("ed25519-19-tampered-3", 3), ("ed25519-19-tampered-3", 8),
    ("sr25519-64-tampered-37", 1), ("sr25519-64-tampered-37", 3), ("sr25519-64-tampered-37", 8),
    # 37 rows over 8 shards of 8: shards 5, 6 and 7 hold padding only
    ("ed25519-37-valid", 8),
])
def test_verify_batch_sharded_matches_jax(jobs, case, mesh_size):
    kind, job = jobs[case]
    want = jsv.verify_batch_sharded(jsv.make_mesh(mesh_size), *job, key_type=kind)
    got = sv.verify_batch_sharded(sv.make_mesh(mesh_size, device="cpu"), *job, key_type=kind)
    _same(got, want)
    bad = [i for i, ok in enumerate(got[0]) if not ok]
    assert bad == {"ed25519-19-tampered-3": [3], "sr25519-64-tampered-37": [37]}.get(case, [])
    assert got[1] is (not bad)


def test_unsupported_key_type_raises():
    mesh = sv.make_mesh(2, device="cpu")
    for fn in (sv.verify_batch_sharded, sv.verify_batch_sharded_cached):
        with pytest.raises(ValueError, match="unsupported key_type 'secp256k1'"):
            fn(mesh, [b"\x01" * 33], [b"m"], [b"\x00" * 64], key_type="secp256k1")
        bitmap, all_valid = fn(mesh, [], [], [])
        assert bitmap.shape == (0,) and all_valid is False


@pytest.fixture
def fresh_caches(monkeypatch):
    """New JAX and port caches for the test; splits(S) sets both packages'
    split (the JAX caches read PK_SPLITS when they are made)."""
    monkeypatch.setattr(JV, "_PK_CACHE", None)
    monkeypatch.setattr(JVS, "_SR_CACHE", None)
    monkeypatch.setattr(V, "_PK_CACHES", {})

    def splits(s):
        monkeypatch.setattr(JV, "PK_SPLITS", s)
        monkeypatch.setenv("TM_TPU_PK_SPLIT", str(s))

    return splits


# -- fail_count (the one kernel of the slice) -----------------------------------


def _bitmap(b, pattern):
    ok = np.ones(b, bool)
    if pattern == "all_false":
        ok[:] = False
    elif pattern == "false_first":
        ok[0] = False
    elif pattern == "false_last":
        ok[-1] = False
    elif pattern == "random":
        ok = np.random.default_rng(b).random(b) < 0.7
    return ok


@pytest.mark.parametrize("pattern", ["all_true", "all_false", "false_first", "false_last", "random"])
@pytest.mark.parametrize("b", [1, 8, 255, 256])
def test_fail_count_plain_matches_jax(b, pattern):
    ok = _bitmap(b, pattern)
    want = int(jnp.sum(jnp.where(jnp.asarray(ok), 0, 1)))
    for t in (torch.from_numpy(ok), torch.from_numpy(ok.astype(np.uint8))):
        got = sv.fail_count(t)
        assert got.dtype == torch.int32 and tuple(got.shape) == (1,) and int(got) == want


def test_fail_count_modes():
    """A () verdict counts as one row; an int32 vector of counts is summed
    (the cross-shard reduction); nothing else is taken."""
    for verdict in (True, False):
        assert int(sv.fail_count(torch.tensor(verdict))) == int(jnp.where(verdict, 0, 1))
    for k in range(1, 9):
        counts = np.random.default_rng(k).integers(0, 300, k).astype(np.int32)
        assert int(sv.fail_count(torch.from_numpy(counts))) == int(jnp.sum(counts))
    for bad in (torch.zeros(3, dtype=torch.int64), torch.zeros((2, 2), dtype=torch.bool)):
        with pytest.raises(ValueError, match="fail_count: expected"):
            sv.fail_count(bad)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        sv.fail_count(torch.zeros(3, dtype=torch.bool, device="meta"))
    assert sv.fail_count.launches == 0  # the plain version counts no launch


# -- the mesh -----------------------------------------------------------------------


def test_make_mesh(monkeypatch):
    """make_mesh takes CUDA devices and raises without enough of them;
    device= is the only way onto the host."""
    assert sv.make_mesh(3, device="cpu").devices == (torch.device("cpu"),) * 3
    assert sv.make_mesh(device="cpu").size == 1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sv.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sv.make_mesh(1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert sv.make_mesh().devices == (torch.device("cuda", 0), torch.device("cuda", 1))
    assert sv.make_mesh(1).devices == (torch.device("cuda", 0),)
    with pytest.raises(ValueError, match=r"make_mesh\(3\): only 2 CUDA device"):
        sv.make_mesh(3)
    with pytest.raises(ValueError, match="at least 1"):
        sv.make_mesh(0, device="cpu")
    assert sv.make_mesh(4, device="cuda:1").devices == (torch.device("cuda", 1),) * 4
    assert sv.make_mesh(2, device="cpu").distinct() == (torch.device("cpu"),)


@pytest.mark.parametrize("n, shards, per", [
    (1, 1, 8), (19, 3, 8), (37, 8, 8), (64, 3, 32), (257, 1, 512), (1000, 1, 1024),
    (1000, 4, 256), (10000, 1, 10240), (10000, 4, 2560), (10, 4, 8),
])
def test_shard_rows_is_the_reference_schedule(n, shards, per):
    assert sv.shard_rows(n, shards) == per
    p = -(-n // shards)  # the reference's inline schedule
    assert per == (JV._pad_pow2(p, floor=8) if p <= 256 else -(-p // 256) * 256)


# -- the sharded RLC's scalars ------------------------------------------------------


@pytest.mark.parametrize("mesh_size", [1, 3, 8])
def test_sharded_rlc_scalar_pool_matches_jax(monkeypatch, mesh_size):
    """verify_batch_sharded_rlc with its scalars on the pool: the verdict
    equals the JAX program's, each shard's zk, z and zs partial sum equal
    the reference's Python scalars of its own rows (zeros on a shard of
    padding only), and with more than one live shard every shard's
    scalars ran on a pool thread."""
    n = 19
    job = seeded_jobs(148, n)
    z_raw = np.random.default_rng(mesh_size).bytes(16 * n)
    scalar_threads, shards = [], []
    scalars, kernel = M._rlc_scalars, M.msm_verify_kernel
    monkeypatch.setattr(M, "_rlc_scalars", lambda *a: scalar_threads.append(
        threading.current_thread().name) or scalars(*a))
    monkeypatch.setattr(M, "msm_verify_kernel", lambda *a: shards.append(
        [x.numpy().copy() for x in a[2:]]) or kernel(*a))
    got = sv.verify_batch_sharded_rlc(sv.make_mesh(mesh_size, device="cpu"), *job, z_raw=z_raw)
    assert got is jsv.verify_batch_sharded_rlc(jsv.make_mesh(mesh_size), *job, z_raw=z_raw) is True
    per = sv.shard_rows(n, mesh_size)
    _, _, s_rows, k_rows, _ = JV._prepare_batch_py(*job)
    assert len(shards) == mesh_size
    for d, (zk, z, zs) in enumerate(shards):
        lo, hi = min(d * per, n), min((d + 1) * per, n)
        zk_w, z_w, zs_w = JM._rlc_scalars_py(s_rows[lo:hi], k_rows[lo:hi], hi - lo, z_raw[16 * lo:16 * hi])
        pad = ((0, per - (hi - lo)), (0, 0))
        np.testing.assert_array_equal(zk, np.pad(zk_w, pad), err_msg=f"shard {d} zk")
        np.testing.assert_array_equal(z, np.pad(z_w, pad), err_msg=f"shard {d} z")
        np.testing.assert_array_equal(zs, zs_w, err_msg=f"shard {d} zs")
    live = -(-n // per)
    assert len(scalar_threads) == live
    pooled = [name.startswith("ThreadPoolExecutor-rlc") for name in scalar_threads]
    assert all(pooled) if live > 1 else not any(pooled)


# -- launches a shard ---------------------------------------------------------------


def test_launches_per_shard(monkeypatch, fresh_caches):
    """Each call launches every shard, padding-only shards included: one
    plane kernel and one fail count a shard, one fail count for the
    cross-shard sum, and one cache fill a distinct device on a first
    cached call. The kernels are counted by wrapping them (the plain
    versions count no launch); they return all-valid outputs."""
    fresh_caches(4)
    calls = collections.Counter()

    def counted(name, fn):
        def wrapper(*args):
            calls[name] += 1
            return fn(*args)
        return wrapper

    def valid_rows(*args):
        return torch.ones(args[-1].shape[0], dtype=torch.bool)

    prep, _, cache_of, split_hit, single_hit = sv._PLANES["ed25519"]
    monkeypatch.setitem(sv._PLANES, "ed25519", (
        prep, counted("bitmap", valid_rows), cache_of, counted("hit", valid_rows), single_hit))
    monkeypatch.setattr(M, "msm_verify_kernel", counted("rlc", lambda *a: torch.tensor(True)))
    monkeypatch.setattr(sv, "fail_count", counted("fail_count", sv.fail_count_plain))
    monkeypatch.setattr(V, "_plane_build", lambda plane, splits: counted(
        "fill", lambda a: (torch.zeros((a.shape[0], splits, 16, 4, 32), dtype=torch.int16),
                           torch.ones(a.shape[0], dtype=torch.bool))))
    job = seeded_jobs(147, 9)  # 3 shards of 8 rows: the third holds padding only
    mesh = sv.make_mesh(3, device="cpu")
    entries = (sv.verify_batch_sharded, sv.verify_batch_sharded_cached, sv.verify_batch_sharded_rlc)
    for fn, args, want, label in (
        (sv.verify_batch_sharded, (), {"bitmap": 3, "fail_count": 4}, 0),
        (sv.verify_batch_sharded_cached, (), {"fill": 1, "hit": 3, "fail_count": 4}, 1),
        (sv.verify_batch_sharded_cached, (), {"hit": 3, "fail_count": 4}, 1),
        (sv.verify_batch_sharded_rlc, (Z16 * 9,), {"rlc": 3, "fail_count": 4}, 2),
    ):
        calls.clear()
        before = [e.launches for e in entries]
        out = fn(mesh, *job, *args)
        assert dict(calls) == want
        assert [e.launches - b for e, b in zip(entries, before)] == [int(i == label) for i in range(3)]
        assert (out[1] if isinstance(out, tuple) else out) is True
