"""The port's plain PyTorch field (tendermint_tpu_torch/ops/field.py) against
the JAX package's field, limb for limb, and against Python ints.

Inputs are random limb vectors from a fixed numpy seed, inside the JAX
field's bounds contract; the arithmetic is integer, so equality is exact.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tendermint_tpu.ops import field as JF
from tendermint_tpu_torch.ops import field as F

# The plain versions run many small ops: one intra-op thread per test
# worker keeps parallel workers from oversubscribing the cores.
torch.set_num_threads(1)

P = F.P_INT
BATCH = (4, 6)  # two batch axes: the layout is (32, *batch)


def _limbs(seed: int, bound: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(-bound, bound + 1, size=(32,) + BATCH).astype(np.int32)


def _values(z: np.ndarray) -> list[int]:
    flat = np.asarray(z, np.int64).reshape(32, -1)
    return [F.limbs_to_int(flat[:, i]) for i in range(flat.shape[1])]


# name -> (JAX function, port function, arity, input bound, value oracle)
CASES = {
    "fe_mul": (JF.fe_mul, F.fe_mul, 2, 2**10, lambda x, y: x * y),
    "fe_square": (JF.fe_square, F.fe_square, 1, 2**10, lambda x: x * x),
    "fe_carry": (lambda z: JF.fe_carry(z, 1), lambda z: F.fe_carry(z, 1), 1, 2**11, lambda x: x),
    "fe_canonical": (JF.fe_canonical, F.fe_canonical, 1, 2**13, lambda x: x),
    "fe_invert": (JF.fe_invert, F.fe_invert, 1, 2**9, lambda x: pow(x, P - 2, P)),
    "fe_pow_p58": (JF.fe_pow_p58, F.fe_pow_p58, 1, 2**9, lambda x: pow(x, (P - 5) // 8, P)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_jax_limb_for_limb_and_ints(name):
    jfn, tfn, arity, bound, oracle = CASES[name]
    args = [_limbs(100 + i + 10 * sorted(CASES).index(name), bound) for i in range(arity)]
    want = np.asarray(jax.jit(jfn)(*[jnp.asarray(a) for a in args]))
    got = tfn(*[torch.from_numpy(a) for a in args])
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    ins = [_values(a) for a in args]
    for j, v in enumerate(_values(got.numpy())):
        assert v % P == oracle(*[col[j] for col in ins]) % P


def test_canonical_edges():
    """p, p - 1, 2^255 - 1, 0 and 2p + 5 reduce to their unique representatives."""
    vals = [P, P - 1, 2**255 - 1, 0, 2 * P + 5, 19]
    z = np.stack([F._int_to_limbs(v % 2**256)[:, 0] for v in vals], axis=1).astype(np.int32)
    got = F.fe_canonical(torch.from_numpy(z)).numpy()
    np.testing.assert_array_equal(got, np.asarray(JF.fe_canonical(jnp.asarray(z))))
    assert _values(got) == [v % P for v in vals]


def test_predicates_and_select():
    x = _limbs(7, 2**9)
    y = x.copy()
    y[0, 0, 0] += 1
    y[5, 1, 2] -= 256  # same value: one carry moved between limbs
    y[6, 1, 2] += 1
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    np.testing.assert_array_equal(
        F.fe_eq(tx, ty).numpy(), np.asarray(JF.fe_eq(jnp.asarray(x), jnp.asarray(y))))
    assert not bool(F.fe_eq(tx, ty)[0, 0]) and bool(F.fe_eq(tx, ty)[1, 2])
    assert bool(F.fe_is_zero(F.const(F.P_LIMBS, tx).expand_as(tx)).all())
    mask = torch.from_numpy(np.arange(24).reshape(BATCH) % 2 == 0)
    sel = F.fe_select(mask, tx, ty).numpy()
    np.testing.assert_array_equal(sel, np.where(mask.numpy(), x, y))


def test_constants_match_reference():
    for name in ("P_LIMBS", "D_LIMBS", "D2_LIMBS", "SQRT_M1_LIMBS", "ONE_LIMBS", "BIAS_LIMBS"):
        np.testing.assert_array_equal(getattr(F, name), getattr(JF, name))
    assert F.limbs_to_int(F.D_LIMBS) == F.D_INT
