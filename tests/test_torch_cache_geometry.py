"""Every pubkey-cache geometry of the port (TM_TPU_PK_SPLIT 1, 2, 4, 8) against
the JAX package's at 8 rows, on both signature planes: the plain versions
of the single-table fill and hit (kernels 5, 6, 10, 11) and of the split
fill and hit at S = 2 and 8 equal the JAX programs exactly on the edge
batches; cache_from_reference takes every entry shape the reference's
caches hold; verify_commit through a cache of each split, on ed25519 and
on sr25519 commits, gives the JAX package's verdict and error.

The JAX split programs read the module global PK_SPLITS when they trace:
each case sets it with monkeypatch and traces the _impl body under a fresh
jax.jit of a new function, so no program traced at the default S = 4 is
reused."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from tendermint_tpu.crypto import ed25519 as jed
from tendermint_tpu.ops import verify as JV
from tendermint_tpu.ops import verify_sr as JVS
from tendermint_tpu.types import validation as jval
from tendermint_tpu_torch.crypto import ed25519 as ted
from tendermint_tpu_torch.crypto import ed25519_ref as ref
from tendermint_tpu_torch.ops import verify as V
from tendermint_tpu_torch.ops import verify_sr as VS
from tendermint_tpu_torch.types import validation as tval

import test_torch_sr25519 as TS
import test_torch_verify as TV
import test_torch_verify_sr as TVS
from test_torch_validation import JAX_PKG, PORT_PKG, _call, _outcome, build

# The plain versions run many small ops: one intra-op thread per test
# worker keeps parallel workers from oversubscribing the cores.
torch.set_num_threads(1)

PLANES = ("ed25519", "sr25519")

# plane -> (port module, JAX module, port single fill, port single hit,
#           port split fill, port split hit, JAX single fill, JAX single hit,
#           JAX split fill body, JAX split hit body)
KERNELS = {
    "ed25519": (V, JV, V.build_pk_tables, V.verify_kernel_cached, V.build_pk_tables_split,
                V.verify_kernel_cached_split, JV.build_pk_tables, JV.verify_kernel_cached,
                JV.build_pk_tables_split_impl, JV.verify_kernel_cached_split_impl),
    "sr25519": (VS, JVS, VS.build_sr_tables, VS.verify_sr_kernel_cached, VS.build_sr_tables_split,
                VS.verify_sr_kernel_cached_split, JVS.build_sr_tables, JVS.verify_sr_kernel_cached,
                JVS.build_sr_tables_split_impl, JVS.verify_sr_kernel_cached_split_impl),
}


@pytest.fixture(scope="module")
def batches():
    """Each plane's 8-row edge batch: (jobs, prepared rows, oracle bitmap)."""
    out = {}
    jobs = TV.edge_jobs()
    out["ed25519"] = jobs, JV._prepare_batch_py(*jobs), [ref.verify(*j) for j in zip(*jobs)]
    jobs = TVS.edge_jobs()
    out["sr25519"] = jobs, JVS.prepare_batch(*jobs), TVS.ORACLE
    return out


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


# a permutation of the 8 keys into a 12-slot cache, so slots are not rows
SLOTS = np.array([5, 0, 11, 2, 7, 9, 3, 6], np.int32)


def _cache_of(tables, oks, capacity=12):
    """tables/oks of 8 keys placed at SLOTS of a larger cache (the other
    slots zero), as numpy arrays."""
    t = np.zeros((capacity,) + tables.shape[1:], np.int16)
    o = np.zeros((capacity,), bool)
    t[SLOTS], o[SLOTS] = tables, oks
    return t, o


def _jit_fresh(body):
    """A new jax.jit of a new function: traces the body now, reading the
    module globals as they are."""
    return jax.jit(lambda *args: body(*args))


@pytest.mark.parametrize("plane", PLANES)
def test_single_table_fill_matches_jax(batches, plane):
    _, _, fill, _, _, _, jfill, *_ = KERNELS[plane]
    _, (a, *_), _ = batches[plane]
    jt, jo = jfill(a)
    tt, to = fill(*_t(a))
    assert tt.dtype == torch.int16 and tuple(tt.shape) == (8, 16, 4, 32)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))


@pytest.mark.parametrize("plane", PLANES)
def test_single_table_hit_matches_jax(batches, plane):
    _, _, _, hit, _, _, jfill, jhit, *_ = KERNELS[plane]
    _, (a, r, s, k, pre), oracle = batches[plane]
    tables, oks = _cache_of(*(np.asarray(x) for x in jfill(a)))  # the reference's signed limbs
    want = np.asarray(jhit(tables, oks, SLOTS, r, s, k))
    got = hit(*_t(tables, oks, SLOTS, r, s, k))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy() & pre).tolist() == oracle


@pytest.mark.parametrize("splits", [2, 8])
@pytest.mark.parametrize("plane", PLANES)
def test_split_fill_matches_jax(batches, monkeypatch, plane, splits):
    _, _, _, _, fill, _, _, _, jfill_impl, _ = KERNELS[plane]
    _, (a, *_), _ = batches[plane]
    monkeypatch.setattr(JV, "PK_SPLITS", splits)
    jt, jo = _jit_fresh(jfill_impl)(a)
    assert np.asarray(jt).shape == (8, splits, 16, 4, 32)
    tt, to = fill(*_t(a), splits)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))


@pytest.mark.parametrize("splits", [2, 8])
@pytest.mark.parametrize("plane", PLANES)
def test_split_hit_matches_jax(batches, monkeypatch, plane, splits):
    """The split hit at S, on tables the port's plain fill made (equal to
    the JAX fill's, limb for limb, by the test above)."""
    _, _, _, _, fill, hit, _, _, _, jhit_impl = KERNELS[plane]
    _, (a, r, s, k, pre), oracle = batches[plane]
    tables, oks = _cache_of(*(x.numpy() for x in fill(*_t(a), splits)))
    monkeypatch.setattr(JV, "PK_SPLITS", splits)
    want = np.asarray(_jit_fresh(jhit_impl)(tables, oks, SLOTS, r, s, k))
    got = hit(*_t(tables, oks, SLOTS, r, s, k))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy() & pre).tolist() == oracle


@pytest.mark.parametrize("splits", [1, 2, 4, 8])
@pytest.mark.parametrize("plane", PLANES)
def test_cache_from_reference_every_shape(batches, plane, splits):
    """A snapshot of a reference cache of each geometry carries across: the
    port cache takes its split from the entry shape, hits every key at its
    slot, and the cache-hit dispatch picks the kernel of that shape."""
    mod, _, fill1, hit1, fill, hit, *_ = KERNELS[plane]
    (pks, msgs, sigs), _, oracle = batches[plane]
    keys = [pk if len(pk) == 32 else b"\x00" * 32 for pk in pks]
    a = np.frombuffer(b"".join(keys), np.uint8).reshape(-1, 32)  # every key, as the cache holds them
    tabs = fill1(*_t(a)) if splits == 1 else fill(*_t(a), splits)
    tables, oks = _cache_of(*(x.numpy() for x in tabs))
    lru = dict(zip(keys, SLOTS.tolist()))
    port = V.cache_from_reference(tables, oks, lru, device="cpu", plane=plane)
    assert port.tables.shape == tables.shape and V.table_splits(port.tables) == splits
    np.testing.assert_array_equal(port.ensure(keys), [lru[k] for k in keys])  # all hits
    kern = hit1 if splits == 1 else hit
    got = V.collect(V.dispatch_cached(port, mod.prepare_batch, kern, mod.verify_batch_async,
                                      pks, msgs, sigs))
    assert got.tolist() == oracle


def test_cache_from_reference_refuses_other_shapes():
    with pytest.raises(ValueError, match="entry shape"):
        V.cache_from_reference(np.zeros((4, 3, 16, 4, 32), np.int16), np.zeros(4, bool), {},
                               device="cpu")
    with pytest.raises(ValueError, match="entry shape"):
        V.cache_from_reference(np.zeros((4, 4, 32), np.int16), np.zeros(4, bool), {}, device="cpu")


@pytest.mark.parametrize("splits", [1, 2, 4, 8])
def test_plane_caches_keyed_by_split(monkeypatch, splits):
    """Each split has its own process-wide cache per plane, of its entry
    shape, and a kernel of another geometry refuses its tables."""
    monkeypatch.setattr(V, "_PK_CACHES", {})
    monkeypatch.setenv("TM_TPU_PK_SPLIT", str(splits))
    ed_cache, sr_cache = V.pubkey_cache("cpu"), VS.sr_pubkey_cache("cpu")
    assert ed_cache is not sr_cache and ed_cache is V.pubkey_cache("cpu")
    for cache in (ed_cache, sr_cache):
        assert tuple(cache.tables.shape[1:]) == V.cache_entry_shape(splits)
    monkeypatch.setenv("TM_TPU_PK_SPLIT", "4" if splits != 4 else "2")
    assert V.pubkey_cache("cpu") is not ed_cache
    V._check_tables("kernel", ed_cache.tables, (splits,))
    with pytest.raises(ValueError, match="bad tables"):
        V._check_tables("kernel", ed_cache.tables, (1,) if splits != 1 else (2, 4, 8))


@pytest.mark.parametrize("splits", [1, 2, 4, 8])
def test_verify_commit_through_each_split(monkeypatch, splits):
    """verify_commit on an 8-validator ed25519 commit through a new cache of
    the split: the JAX package's outcome, valid and with one tampered
    signature."""
    monkeypatch.setattr(V, "_PK_CACHES", {})
    monkeypatch.setenv("TM_TPU_PK_SPLIT", str(splits))
    monkeypatch.setenv("TM_TPU_ENGINE", "off")
    monkeypatch.setenv("TM_TPU_CRYPTO", "on")
    for mod in (jed, ted):
        monkeypatch.setattr(mod, "DEVICE_BATCH_CUTOVER", 4)
    rng = np.random.default_rng(90 + splits)
    privs = [ref.gen_privkey(rng.bytes(32)) for _ in range(8)]
    jv, jb, jc = build(JAX_PKG, privs)
    tv, tb, tc = build(PORT_PKG, privs)
    assert _outcome(lambda: _call(tval, "commit", tv, tb, tc, device="cpu")) == ("accepted", "")
    for c in (jc, tc):
        sig = c.signatures[5].signature
        c.signatures[5].signature = sig[:40] + bytes([sig[40] ^ 1]) + sig[41:]
    want = _outcome(lambda: _call(jval, "commit", jv, jb, jc))
    got = _outcome(lambda: _call(tval, "commit", tv, tb, tc, device="cpu"))
    assert got == want and got[1].startswith("wrong signature (#5): ")
    cache = V.pubkey_cache("cpu")
    assert V.table_splits(cache.tables) == splits and len(cache._lru) == 8


@pytest.mark.parametrize("splits", [1, 2, 4, 8])
def test_sr25519_verify_commit_through_each_split(monkeypatch, splits):
    """verify_commit on an 8-validator sr25519 commit through a new sr25519
    cache of the split: the JAX package's outcome (its host path), valid
    and with one tampered signature."""
    monkeypatch.setattr(V, "_PK_CACHES", {})
    monkeypatch.setenv("TM_TPU_PK_SPLIT", str(splits))
    monkeypatch.setenv("TM_TPU_ENGINE", "off")
    monkeypatch.setenv("TM_TPU_CRYPTO", "on")
    monkeypatch.setattr(ted, "DEVICE_BATCH_CUTOVER", 4)
    jv, jb, jc = TS.build(TS.JAX_PKG, TS.SR_SET)
    tv, tb, tc = TS.build(TS.PORT_PKG, TS.SR_SET)
    assert TS._outcome(lambda: TS._call(tval, "commit", tv, tb, tc, device="cpu")) == ("accepted", "")
    for c in (jc, tc):
        sig = c.signatures[3].signature
        c.signatures[3].signature = sig[:40] + bytes([sig[40] ^ 1]) + sig[41:]
    want = TS._outcome(lambda: TS._call(jval, "commit", jv, jb, jc))
    got = TS._outcome(lambda: TS._call(tval, "commit", tv, tb, tc, device="cpu"))
    assert got == want and got[1].startswith("wrong signature (#3): ")
    cache = VS.sr_pubkey_cache("cpu")
    assert V.table_splits(cache.tables) == splits and len(cache._lru) == 8


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("package", ["tendermint_tpu_torch", "tendermint_tpu"])
def test_invalid_split_fails_at_import(package):
    """TM_TPU_PK_SPLIT=3 makes importing ops/verify.py raise the same
    ValueError in the port as in the reference; a valid split imports."""
    env = dict(os.environ, TM_TPU_PK_SPLIT="3", JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
    code = f"import {package}.ops.verify"
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=180)
    assert proc.returncode == 1
    assert proc.stderr.strip().splitlines()[-1] == (
        "ValueError: TM_TPU_PK_SPLIT must be 1, 2, 4 or 8, got 3")
    env["TM_TPU_PK_SPLIT"] = "2"
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr[-2000:]
