"""Cache slots no real path hands out, held to the reference: the JAX
package gathers a cache entry with `tables[slots]` under jnp indexing,
which counts a negative slot from the end (slot + C) and then clamps the
index into [0, C - 1]. The port's plain versions map slots the same way
(ops/verify.py cache_slots) and so do its kernels (csrc/ladder.cuh
cache_slot, held on the card by chip_smoke.py's hit_edges).

Here, at 8 rows and a 12-slot cache on both signature planes: the slot
helper against jax.jit(lambda t, s: t[s]); every plain cache hit (S = 1,
2, 4, 8) and the cached RLC (S = 2, 4, 8) against the JAX programs with
the slots -1, -5, -C, -C - 1, INT32_MIN, C, C + 3 and INT32_MAX, one a
row, and with every row's slot counted from the end (slot - C), which
must read the row's own entry and give the bitmap (or verdict) of the
plain slots."""

import jax
import numpy as np
import pytest
import torch

from tendermint_tpu.ops import msm as JM
from tendermint_tpu.ops import verify as JV
from tendermint_tpu.ops import verify_sr as JVS
from tendermint_tpu_torch.crypto import ed25519_ref as ref
from tendermint_tpu_torch.ops import msm as M
from tendermint_tpu_torch.ops import verify as V
from tendermint_tpu_torch.ops import verify_sr as VS

import test_torch_msm as TM
import test_torch_verify as TV
import test_torch_verify_sr as TVS

# The plain versions run many small ops: one intra-op thread per test
# worker keeps parallel workers from oversubscribing the cores.
torch.set_num_threads(1)

CAPACITY = 12
INT32_MIN, INT32_MAX = -2**31, 2**31 - 1
EDGE_SLOTS = np.array([-1, -5, -CAPACITY, -CAPACITY - 1, INT32_MIN, CAPACITY, CAPACITY + 3,
                       INT32_MAX], np.int32)
# a permutation of the 8 keys into the cache, so slots are not rows
SLOTS = np.array([5, 0, 11, 2, 7, 9, 3, 6], np.int32)
WRAPPED = SLOTS - CAPACITY

# plane -> (port split fill, port split hit, port single fill,
#           port single hit, JAX split hit body, JAX single hit)
PLANES = {
    "ed25519": (V.build_pk_tables_split, V.verify_kernel_cached_split, V.build_pk_tables,
                V.verify_kernel_cached, JV.verify_kernel_cached_split_impl,
                JV.verify_kernel_cached),
    "sr25519": (VS.build_sr_tables_split, VS.verify_sr_kernel_cached_split, VS.build_sr_tables,
                VS.verify_sr_kernel_cached, JVS.verify_sr_kernel_cached_split_impl,
                JVS.verify_sr_kernel_cached),
}


@pytest.fixture(scope="module")
def batches():
    """Each plane's 8-row edge batch: (prepared rows, oracle bitmap)."""
    jobs = TV.edge_jobs()
    return {
        "ed25519": (JV._prepare_batch_py(*jobs), [ref.verify(*j) for j in zip(*jobs)]),
        "sr25519": (JVS.prepare_batch(*TVS.edge_jobs()), TVS.ORACLE),
    }


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _cache_of(tables, oks):
    """tables/oks of the 8 keys at SLOTS of the cache (the other slots
    zero), as numpy arrays."""
    t = np.zeros((CAPACITY,) + tables.shape[1:], np.int16)
    o = np.zeros((CAPACITY,), bool)
    t[SLOTS], o[SLOTS] = tables, oks
    return t, o


def _jit_fresh(body):
    """A new jax.jit of a new function: traces the body now, reading the
    module globals (PK_SPLITS) as they are."""
    return jax.jit(lambda *args: body(*args))


@pytest.mark.parametrize("capacity", [1, CAPACITY, 4096])
def test_slot_helper_matches_jnp_gather(capacity):
    rng = np.random.default_rng(capacity)
    slots = np.concatenate([
        np.array([-1, -5, -capacity, -capacity - 1, INT32_MIN, capacity, capacity + 3, INT32_MAX,
                  0, capacity - 1, 1 - capacity], np.int64).clip(INT32_MIN, INT32_MAX),
        rng.integers(INT32_MIN, INT32_MAX, 64, endpoint=True),
        rng.integers(-3 * capacity, 3 * capacity, 64)]).astype(np.int32)
    table = np.arange(capacity, dtype=np.int32)
    want = np.asarray(jax.jit(lambda t, s: t[s])(table, slots))
    got = V.cache_slots(torch.from_numpy(slots), capacity)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("splits", [1, 2, 4, 8])
@pytest.mark.parametrize("plane", list(PLANES))
def test_cache_hit_slots_match_jax(batches, monkeypatch, plane, splits):
    """The plain hit at S on the edge slots and on the slots counted from
    the end, against the JAX program on the same raw slots."""
    fill, hit, fill1, hit1, jhit_impl, jhit1 = PLANES[plane]
    (a, r, s, k, pre), oracle = batches[plane]
    if splits == 1:
        tables, oks = _cache_of(*(x.numpy() for x in fill1(*_t(a))))
        port, jax_hit = hit1, jhit1
    else:
        tables, oks = _cache_of(*(x.numpy() for x in fill(*_t(a), splits)))
        monkeypatch.setattr(JV, "PK_SPLITS", splits)
        port, jax_hit = hit, _jit_fresh(jhit_impl)
    for slots in (EDGE_SLOTS, WRAPPED):
        want = np.asarray(jax_hit(tables, oks, slots, r, s, k))
        got = port(*_t(tables, oks, slots, r, s, k))
        np.testing.assert_array_equal(got.numpy(), want)
    # slot - C reads the row's own entry: the bitmap of the plain slots
    assert (got.numpy() & pre).tolist() == oracle


@pytest.mark.parametrize("splits", [2, 4, 8])
def test_cached_rlc_slots_match_jax(splits):
    """The cached RLC on a valid batch: with every slot counted from the
    end it must still accept; with the edge slots it reads other entries
    and must reject. Both against the JAX program on the same raw slots."""
    pks, msgs, sigs = TM.valid_edge_jobs()
    a, r, zk, z, zs = TM._rows(pks, msgs, sigs, TM.Z16 * 8)
    tabs, oks = (x.numpy() for x in V.build_pk_tables_split(torch.from_numpy(a), splits))
    tables, cache_oks = _cache_of(tabs, oks)
    for slots, expect in ((WRAPPED, True), (EDGE_SLOTS, False)):
        want = bool(JM.msm_verify_kernel_cached(tables, cache_oks, slots, r, zk, z, zs))
        got = M.msm_verify_kernel_cached(*_t(tables, cache_oks, slots, r, zk, z, zs))
        assert bool(got) == want == expect
