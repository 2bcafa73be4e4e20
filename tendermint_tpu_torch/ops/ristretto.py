"""Ristretto255 group encoding on limb tensors (RFC 9496 §4.3): the plain
PyTorch codec of the sr25519 plane.

The curve is the Edwards25519 of ops/curve.py; only the point codec
differs. Ristretto encodes cosets of the 4-torsion subgroup, so equality
is encoding equality, not Edwards-coordinate equality, and the decoder
rejects what ZIP-215 decoding accepts: a non-canonical or odd s, a
non-square, a negative t, y = 0. The sign tests read the fully reduced
value (`fe_parity`).

Every function is the JAX package's (tendermint_tpu/ops/ristretto.py) in
the same order on the port's field, so each output is limb for limb the
reference's; csrc/ristretto.cuh is the same sequence on the kernels'
ten-limb field.
"""

from __future__ import annotations

import torch

from ..crypto.sr25519 import INVSQRT_A_MINUS_D as _INVSQRT_A_MINUS_D_INT
from . import curve as C
from . import field as F

INVSQRT_A_MINUS_D = F._int_to_limbs(_INVSQRT_A_MINUS_D_INT)


def fe_parity(z):
    """IS_NEGATIVE (RFC 9496 §4.1): canonical value odd -> 1."""
    return F.fe_canonical(z)[0] & 1


def fe_abs(z):
    """CT_ABS: the non-negative (even) representative, canonical limbs."""
    c = F.fe_canonical(z)
    neg = F.fe_canonical(F.const(F.P_LIMBS, c) - c)
    return F.fe_select((c[0] & 1) == 1, neg, c)


def sqrt_ratio_m1(u, v):
    """RFC 9496 §4.2: (was_square, non-negative sqrt(u/v) or sqrt(i*u/v))."""
    v3 = F.fe_mul(F.fe_square(v), v)
    v7 = F.fe_mul(F.fe_square(v3), v)
    r = F.fe_mul(F.fe_mul(u, v3), F.fe_pow_p58(F.fe_mul(u, v7)))
    check = F.fe_mul(v, F.fe_square(r))
    u_neg = F.fe_neg(u)
    correct = F.fe_eq(check, u)
    flipped = F.fe_eq(check, u_neg)
    flipped_i = F.fe_eq(check, F.fe_mul_const(u_neg, F.SQRT_M1_LIMBS))
    r = F.fe_select(flipped | flipped_i, F.fe_mul_const(r, F.SQRT_M1_LIMBS), r)
    return correct | flipped, fe_abs(r)


def decode(s_enc):
    """(32, B) int32 byte values -> (extended point, ok mask) (RFC 9496
    §4.3.1). Rejections: non-canonical, negative (odd), non-square,
    t negative, y zero."""
    s = s_enc.to(torch.int32)
    one = F.const(F.ONE_LIMBS, s)
    canonical = torch.all(F.fe_canonical(s) == s, dim=0)
    even = (s[0] & 1) == 0
    ss = F.fe_square(s)
    u1 = F.fe_sub(one, ss)
    u2 = F.fe_add(one, ss)
    u2_sqr = F.fe_square(u2)
    d_u1 = F.fe_mul_const(u1, F.D_LIMBS)
    v = F.fe_sub(F.fe_neg(F.fe_mul(d_u1, u1)), u2_sqr)
    was_square, invsqrt = sqrt_ratio_m1(one, F.fe_mul(v, u2_sqr))
    den_x = F.fe_mul(invsqrt, u2)
    den_y = F.fe_mul(F.fe_mul(invsqrt, den_x), v)
    x = fe_abs(F.fe_mul(F.fe_add(s, s), den_x))
    y = F.fe_canonical(F.fe_mul(u1, den_y))
    t = F.fe_mul(x, y)
    ok = canonical & even & was_square & (fe_parity(t) == 0) & ~F.fe_is_zero(y)
    return C.make_point(x, y, one.expand_as(x), t), ok


def encode(pt):
    """Extended point -> (32, B) canonical byte values (RFC 9496 §4.3.2).
    Encoding equality is ristretto equality, so callers compare these
    bytes with wire encodings directly."""
    x0, y0, z0, t0 = pt[0], pt[1], pt[2], pt[3]
    one = F.const(F.ONE_LIMBS, x0)
    u1 = F.fe_mul(F.fe_add(z0, y0), F.fe_sub(z0, y0))
    u2 = F.fe_mul(x0, y0)
    _, invsqrt = sqrt_ratio_m1(one, F.fe_mul(u1, F.fe_square(u2)))
    den1 = F.fe_mul(invsqrt, u1)
    den2 = F.fe_mul(invsqrt, u2)
    z_inv = F.fe_mul(F.fe_mul(den1, den2), t0)
    rotate = fe_parity(F.fe_mul(t0, z_inv)) == 1
    ix = F.fe_mul_const(x0, F.SQRT_M1_LIMBS)
    iy = F.fe_mul_const(y0, F.SQRT_M1_LIMBS)
    enchanted = F.fe_mul_const(den1, INVSQRT_A_MINUS_D)
    x = F.fe_select(rotate, iy, x0)
    y = F.fe_select(rotate, ix, y0)
    den_inv = F.fe_select(rotate, enchanted, den2)
    y = F.fe_select(fe_parity(F.fe_mul(x, z_inv)) == 1, F.fe_neg(y), y)
    return fe_abs(F.fe_mul(den_inv, F.fe_sub(z0, y)))
