"""The port's plain PyTorch curve layer (tendermint_tpu_torch/ops/curve.py)
against the JAX package's, limb for limb: ZIP-215 decoding, the point
formulas, the Straus ladders and the base-point tables."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tendermint_tpu.crypto import ed25519_ref as ref
from tendermint_tpu.ops import curve as JC
from tendermint_tpu_torch.ops import curve as C
from tendermint_tpu_torch.ops import field as F

# The plain versions run many small ops: one intra-op thread per test
# worker keeps parallel workers from oversubscribing the cores.
torch.set_num_threads(1)

_jdecomp = jax.jit(lambda e: JC.decompress(e, zip215=True))


def _enc_columns(encs) -> np.ndarray:
    return np.stack([np.frombuffer(e, np.uint8) for e in encs], axis=1).astype(np.int32)


def _non_square_encoding() -> bytes:
    y = 2
    while ref.decompress(int.to_bytes(y, 32, "little")) is not None:
        y += 1
    return int.to_bytes(y, 32, "little")


@pytest.fixture(scope="module")
def encodings():
    """Seeded keys, the whole 8-torsion, and the ZIP-215 edge encodings."""
    rng = np.random.default_rng(11)
    keys = [ref.gen_privkey(rng.bytes(32))[32:] for _ in range(5)]
    ident = bytearray(ref.compress(ref.IDENTITY))
    ident[31] |= 0x80  # x = 0 with the sign bit set
    edges = [
        (ref.P + 1).to_bytes(32, "little"),  # y >= p, decodes as y = 1
        (ref.P + 3).to_bytes(32, "little"),  # y >= p, y = 3 mod p
        bytes(ident),
        _non_square_encoding(),
        b"\x00" * 32,  # the padding row: y = 0 decodes
    ]
    return keys + ref.small_order_points() + edges


@pytest.fixture(scope="module")
def decoded(encodings):
    enc = _enc_columns(encodings)
    jpt, jok = _jdecomp(jnp.asarray(enc))
    tpt, tok = C.decompress(torch.from_numpy(enc))
    return enc, (np.asarray(jpt), np.asarray(jok)), (tpt, tok)


def test_decompress_matches_jax_and_oracle(encodings, decoded):
    _, (jpt, jok), (tpt, tok) = decoded
    np.testing.assert_array_equal(tpt.numpy(), jpt)
    np.testing.assert_array_equal(tok.numpy(), jok)
    want = [ref.decompress(e, zip215=True) is not None for e in encodings]
    assert tok.tolist() == want
    assert [want[-5], want[-3], want[-2], want[-1]] == [True, True, False, True]


@pytest.mark.parametrize("out_t", [True, False])
def test_point_add_and_double(decoded, out_t):
    _, (jpt, _), (tpt, _) = decoded
    q_j, q_t = jnp.roll(jnp.asarray(jpt), 1, axis=-1), torch.roll(tpt, 1, dims=-1)
    np.testing.assert_array_equal(
        C.point_add(tpt, q_t, out_t=out_t).numpy(),
        np.asarray(jax.jit(lambda p, q: JC.point_add(p, q, out_t=out_t))(jpt, q_j)))
    np.testing.assert_array_equal(
        C.point_double(tpt, out_t=out_t).numpy(),
        np.asarray(jax.jit(lambda p: JC.point_double(p, out_t=out_t))(jpt)))


def test_point_neg_equal_identity(decoded):
    _, (jpt, _), (tpt, _) = decoded
    np.testing.assert_array_equal(C.point_neg(tpt).numpy(), np.asarray(JC.point_neg(jnp.asarray(jpt))))
    np.testing.assert_array_equal(
        C.point_equal(tpt, torch.roll(tpt, 1, dims=-1)).numpy(),
        np.asarray(jax.jit(JC.point_equal)(jpt, jnp.roll(jnp.asarray(jpt), 1, axis=-1))))
    np.testing.assert_array_equal(
        C.point_is_identity(tpt).numpy(), np.asarray(jax.jit(JC.point_is_identity)(jpt)))


def _scalar_columns(vals) -> np.ndarray:
    return np.array([[(v >> (8 * i)) & 0xFF for v in vals] for i in range(32)], np.int32)


def test_double_scalar_mul_base_matches_jax():
    """[s]B + [k]A at batch 1 (the shape tests/test_curve.py compiles)."""
    rng = np.random.default_rng(5)
    a_point = ref.scalar_mult(int.from_bytes(rng.bytes(32), "little") % ref.L, ref.BASE)
    enc = _enc_columns([ref.compress(a_point)])
    jpt, _ = _jdecomp(jnp.asarray(enc))
    tpt, _ = C.decompress(torch.from_numpy(enc))
    jfn = jax.jit(JC.double_scalar_mul_base)
    for s, k in [(int.from_bytes(rng.bytes(32), "little") % ref.L,
                  int.from_bytes(rng.bytes(32), "little") % ref.L), (ref.L - 1, 15)]:
        sc, kc = _scalar_columns([s]), _scalar_columns([k])
        want = np.asarray(jfn(jnp.asarray(sc), jnp.asarray(kc), jpt))
        got = C.double_scalar_mul_base(torch.from_numpy(sc), torch.from_numpy(kc), tpt)
        np.testing.assert_array_equal(got.numpy(), want)


def test_power_tables_and_split_ladder_match_jax(decoded):
    """build_power_tables and double_scalar_mul_split at batch 6 (the shape
    tests/test_curve.py compiles), including a small-order point."""
    _, (jpt, _), (tpt, _) = decoded
    cols = [0, 1, 2, 5, 6, 11]  # seeded keys and 8-torsion points
    jp, tp = jnp.asarray(jpt[..., cols]), tpt[..., cols].contiguous()
    jtabs = jax.jit(JC.build_power_tables)(jp)
    ttabs = C.build_power_tables(tp)
    np.testing.assert_array_equal(ttabs.numpy(), np.asarray(jtabs))
    rng = np.random.default_rng(9)
    s = _scalar_columns([int.from_bytes(rng.bytes(32), "little") % ref.L for _ in cols])
    k = _scalar_columns([int.from_bytes(rng.bytes(32), "little") % ref.L for _ in cols[:-1]] + [0])
    want = np.asarray(jax.jit(JC.double_scalar_mul_split)(jnp.asarray(s), jnp.asarray(k), jtabs))
    got = C.double_scalar_mul_split(torch.from_numpy(s), torch.from_numpy(k), ttabs)
    np.testing.assert_array_equal(got.numpy(), want)


def test_fixed_base_mul_matches_oracle():
    rng = np.random.default_rng(3)
    vals = [int.from_bytes(rng.bytes(32), "little") % ref.L for _ in range(2)] + [0, 1]
    got = C.fixed_base_mul(torch.from_numpy(_scalar_columns(vals))).numpy()
    for j, v in enumerate(vals):
        x, y, z = (F.limbs_to_int(got[c, :, j]) % ref.P for c in range(3))
        want = ref.scalar_mult(v, ref.BASE)
        assert ref.point_equal((x, y, z, 0), want), v


def test_base_tables_equal_reference():
    np.testing.assert_array_equal(C.base_table(), JC.base_table())
    np.testing.assert_array_equal(C.fixed_base_table(), JC.fixed_base_table())
    np.testing.assert_array_equal(C.split_fixed_rows(4), JC._split_fixed_rows(4))
