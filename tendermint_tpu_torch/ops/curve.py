"""Edwards25519 group operations on limb tensors: the plain PyTorch curve.

Points are extended homogeneous coordinates stacked on the leading axis:
a (4, 32, *batch) int32 tensor holding (X, Y, Z, T) with x = X/Z,
y = Y/Z, T = XY/Z, in the field layout of ops/field.py. Every formula is
the JAX package's, in the same order, so each coordinate comes out limb
for limb as the reference computes it. The unified addition law is
complete for ed25519, so the small-order and mixed-order points that
ZIP-215 admits need no special case.

Verification handles only public data, so the 16-way table selects index
directly (a gather) where the reference multiplies by a one-hot mask; the
selected limbs are the same.

The host tables over the base point B (`base_table`, `fixed_base_table`)
are recomputed from the port's own copy of the pure-Python oracle.
"""

from __future__ import annotations

import numpy as np
import torch

from . import field as F

_NIBBLES = 64


def make_point(x, y, z, t):
    return torch.stack([x, y, z, t], dim=0)


def identity_point(batch_shape=(), device="cpu") -> torch.Tensor:
    pt = torch.zeros((4, 32) + tuple(batch_shape), dtype=torch.int32, device=device)
    pt[1, 0] = 1  # Y = 1
    pt[2, 0] = 1  # Z = 1
    return pt


def point_add(p, q, out_t: bool = True):
    """Unified complete addition (add-2008-hwcd-3, a = -1): 8M (+1M for T)."""
    xp, yp, zp, tp = p[0], p[1], p[2], p[3]
    xq, yq, zq, tq = q[0], q[1], q[2], q[3]
    a = F.fe_mul(F.fe_sub(yp, xp), F.fe_sub(yq, xq))
    b = F.fe_mul(F.fe_add(yp, xp), F.fe_add(yq, xq))
    c = F.fe_mul_const(F.fe_mul(tp, tq), F.D2_LIMBS)
    zz = F.fe_mul(zp, zq)
    d = F.fe_carry(F.fe_add(zz, zz), passes=1)
    e = F.fe_sub(b, a)
    f = F.fe_sub(d, c)
    g = F.fe_add(d, c)
    h = F.fe_add(b, a)
    t3 = F.fe_mul(e, h) if out_t else torch.zeros_like(e)
    return make_point(F.fe_mul(e, f), F.fe_mul(g, h), F.fe_mul(f, g), t3)


def point_double(p, out_t: bool = True):
    """Dedicated doubling, dbl-2008-hwcd (a = -1): 4S + 3M (+1M for T).
    Never reads p's T coordinate."""
    x1, y1, z1 = p[0], p[1], p[2]
    a = F.fe_square(x1)
    b = F.fe_square(y1)
    zsq = F.fe_square(z1)
    c = F.fe_carry(F.fe_add(zsq, zsq), passes=1)
    s = F.fe_carry(F.fe_add(x1, y1), passes=1)
    d = F.fe_square(s)
    e = F.fe_carry(F.fe_sub(F.fe_sub(d, a), b), passes=1)  # (X+Y)^2 - A - B
    g = F.fe_sub(b, a)
    f = F.fe_carry(F.fe_sub(g, c), passes=1)
    h = F.fe_neg(F.fe_add(a, b))
    t3 = F.fe_mul(e, h) if out_t else torch.zeros_like(e)
    return make_point(F.fe_mul(e, f), F.fe_mul(g, h), F.fe_mul(f, g), t3)


def point_neg(p):
    return make_point(F.fe_neg(p[0]), p[1], p[2], F.fe_neg(p[3]))


def point_is_identity(p):
    """X == 0 and Y == Z (projective identity test)."""
    return F.fe_is_zero(p[0]) & F.fe_is_zero(F.fe_sub(p[1], p[2]))


def point_equal(p, q):
    cross_x = F.fe_sub(F.fe_mul(p[0], q[2]), F.fe_mul(q[0], p[2]))
    cross_y = F.fe_sub(F.fe_mul(p[1], q[2]), F.fe_mul(q[1], p[2]))
    return F.fe_is_zero(cross_x) & F.fe_is_zero(cross_y)


def _repeat(fn, n: int, v):
    for _ in range(n):
        v = fn(v)
    return v


# -- decompression (ZIP-215 decoding) -------------------------------------


def decompress(enc_bytes: torch.Tensor):
    """Decode point encodings: enc_bytes (32, *batch) int32 byte values.

    Returns (point, ok) with ZIP-215 semantics: the 255-bit y is not
    checked for canonicity, and x = 0 with the sign bit set is accepted
    (x := -0). The only rejection is a non-square x^2 candidate."""
    sign = (enc_bytes[31] >> 7) & 1
    y = torch.cat([enc_bytes[:31], (enc_bytes[31] & 0x7F).unsqueeze(0)], dim=0).to(torch.int32)
    one = F.const(F.ONE_LIMBS, y)
    yy = F.fe_square(y)
    u = F.fe_sub(yy, one)  # y^2 - 1
    v = F.fe_add(F.fe_mul_const(yy, F.D_LIMBS), one)  # d*y^2 + 1
    v3 = F.fe_mul(F.fe_square(v), v)
    v7 = F.fe_mul(F.fe_square(v3), v)
    uv7 = F.fe_mul(u, v7)
    x = F.fe_mul(F.fe_mul(u, v3), F.fe_pow_p58(uv7))  # u*v^3*(u*v^7)^((p-5)/8)
    vxx = F.fe_mul(v, F.fe_square(x))
    is_root = F.fe_eq(vxx, u)
    is_neg_root = F.fe_is_zero(F.fe_add(vxx, u))
    x_alt = F.fe_mul_const(x, F.SQRT_M1_LIMBS)
    x = F.fe_select(is_root, x, x_alt)
    ok = is_root | is_neg_root
    # Normalize x and fix its parity to the sign bit.
    x = F.fe_canonical(x)
    parity = x[0] & 1
    neg_x = F.fe_canonical(F.const(F.P_LIMBS, x) - x)  # p - 0 canonicalizes to 0
    x = F.fe_select(parity != sign, neg_x, x)
    y_c = F.fe_canonical(y)
    pt = make_point(x, y_c, one.expand_as(x), F.fe_mul(x, y_c))
    return pt, ok


# -- scalar multiplication ------------------------------------------------


def scalar_to_nibbles(s_bytes: torch.Tensor) -> torch.Tensor:
    """(n_bytes, B) byte values -> (2*n_bytes, B) little-endian 4-bit windows."""
    lo = s_bytes & 0x0F
    hi = (s_bytes >> 4) & 0x0F
    return torch.stack([lo, hi], dim=1).reshape((2 * s_bytes.shape[0],) + tuple(s_bytes.shape[1:]))


def _select16(table: torch.Tensor, nib: torch.Tensor) -> torch.Tensor:
    """table (16, 4, 32, B or 1), nib (B,) -> (4, 32, B): entry nib[b] of
    column b, by direct indexing (the operands are public)."""
    b = nib.shape[0]
    table = table.expand(16, 4, 32, b)
    idx = nib.long().reshape(1, 1, 1, b).expand(1, 4, 32, b)
    return torch.gather(table, 0, idx)[0]


def _build_var_table(p: torch.Tensor) -> torch.Tensor:
    """Multiples 0..15 of p with T: (16, 4, 32, *batch), by repeated
    addition (entries[i] = entries[i-1] + p), as the reference's scan."""
    entries = [identity_point(p.shape[2:], p.device), p]
    acc = p
    for _ in range(14):
        acc = point_add(acc, p, out_t=True)
        entries.append(acc)
    return torch.stack(entries, dim=0)


def _affine_ext_limbs(pt) -> np.ndarray:
    from ..crypto import ed25519_ref as ref

    x, y, z, _ = pt
    zinv = pow(z, ref.P - 2, ref.P)
    xa, ya = x * zinv % ref.P, y * zinv % ref.P
    out = np.zeros((4, 32), np.int32)
    for limb in range(32):
        out[0, limb] = (xa >> (8 * limb)) & 0xFF
        out[1, limb] = (ya >> (8 * limb)) & 0xFF
        out[3, limb] = ((xa * ya % ref.P) >> (8 * limb)) & 0xFF
    out[2, 0] = 1
    return out


def _precompute_base_table() -> np.ndarray:
    """BASE_TABLE[j] = j * B as affine-extended limbs, shape (16, 4, 32)."""
    from ..crypto import ed25519_ref as ref

    table = np.zeros((16, 4, 32), np.int32)
    for j in range(16):
        pt = ref.scalar_mult(j, ref.BASE) if j else ref.IDENTITY
        table[j] = _affine_ext_limbs(pt)
    return table


def _precompute_fixed_table() -> np.ndarray:
    """FIXED_TABLE[i][j] = j * 16^i * B, shape (64, 16, 4, 32)."""
    from ..crypto import ed25519_ref as ref

    table = np.zeros((_NIBBLES, 16, 4, 32), np.int32)
    base = ref.BASE
    for i in range(_NIBBLES):
        acc = ref.IDENTITY
        for j in range(16):
            table[i, j] = _affine_ext_limbs(acc)
            acc = ref.point_add(acc, base)
        base = acc  # 16 * (16^i B)
    return table


_BASE_TABLE: np.ndarray | None = None
_FIXED_TABLE: np.ndarray | None = None


def base_table() -> np.ndarray:
    global _BASE_TABLE
    if _BASE_TABLE is None:
        _BASE_TABLE = _precompute_base_table()
    return _BASE_TABLE


def fixed_base_table() -> np.ndarray:
    global _FIXED_TABLE
    if _FIXED_TABLE is None:
        _FIXED_TABLE = _precompute_fixed_table()
    return _FIXED_TABLE


def split_fixed_rows(splits: int = 4) -> np.ndarray:
    """Fixed-base comb rows at each chunk boundary: row c holds
    j * 16^(c * 64/splits) * B. Shape (splits, 16, 4, 32)."""
    per = _NIBBLES // splits
    return fixed_base_table()[[c * per for c in range(splits)]]


def double_scalar_mul_base(s_bytes, k_bytes, a_pt=None, final_t: bool = True, a_table=None):
    """[s]B + [k]A' in one interleaved Straus ladder (A' = a_pt, usually the
    negated pubkey), 4-bit windows from the top, 252 shared doublings.
    s_bytes/k_bytes (32, B); a_pt (4, 32, B) with T, or a prebuilt
    (16, 4, 32, B) multiples table in `a_table`. final_t=False leaves T
    unset on the result (the identity check never reads it)."""
    nibs_s = scalar_to_nibbles(s_bytes)
    nibs_k = scalar_to_nibbles(k_bytes)
    if a_table is None:
        a_table = _build_var_table(a_pt)
    b_table = torch.as_tensor(base_table(), device=s_bytes.device)[..., None]

    def window(acc, w, last: bool):
        acc = _repeat(lambda v: point_double(v, out_t=False), 3, acc)
        acc = point_double(acc, out_t=True)
        acc = point_add(acc, _select16(b_table, nibs_s[w]), out_t=True)
        return point_add(acc, _select16(a_table, nibs_k[w]), out_t=last)

    acc = point_add(
        _select16(b_table, nibs_s[_NIBBLES - 1]),
        _select16(a_table, nibs_k[_NIBBLES - 1]),
        out_t=False,
    )
    for w in range(_NIBBLES - 2, 0, -1):
        acc = window(acc, w, False)
    return window(acc, 0, final_t)


def build_power_tables(p, splits: int = 4):
    """Straus tables of p, [2^c]p, [2^2c]p, ... (c = 256/splits bits):
    (splits, 16, 4, 32, B). Each power is c-1 doublings without T and one
    with T from the previous one."""
    chunk_bits = 256 // splits
    powers = [p]
    q = p
    for _ in range(splits - 1):
        q = _repeat(lambda v: point_double(v, out_t=False), chunk_bits - 1, q)
        q = point_double(q, out_t=True)
        powers.append(q)
    b = p.shape[-1]
    # one table build with the splits folded into the batch axis
    table = _build_var_table(torch.cat(powers, dim=-1))  # (16, 4, 32, splits*B)
    return table.reshape(16, 4, 32, splits, b).permute(3, 0, 1, 2, 4)


def double_scalar_mul_split(s_bytes, k_bytes, a_tables, splits: int = 4):
    """[s]B + [k]A' with the scalars split into `splits` chunks: s rides
    rows of the fixed-base comb, k rides a_tables = build_power_tables(A').
    16 steps of 4 shared doublings and 2*splits additions from the
    identity. Output carries no T."""
    per = _NIBBLES // splits
    nibs_s = scalar_to_nibbles(s_bytes)
    nibs_k = scalar_to_nibbles(k_bytes)
    b_tables = torch.as_tensor(split_fixed_rows(splits), device=s_bytes.device)[..., None]
    acc = identity_point(s_bytes.shape[1:], s_bytes.device)
    for i in range(per):
        w = per - 1 - i
        acc = _repeat(lambda v: point_double(v, out_t=False), 3, acc)
        acc = point_double(acc, out_t=True)
        for c in range(splits):
            acc = point_add(acc, _select16(b_tables[c], nibs_s[c * per + w]), out_t=True)
            # the step's last add feeds doublings, which never read T
            acc = point_add(acc, _select16(a_tables[c], nibs_k[c * per + w]), out_t=c < splits - 1)
    return acc


def fixed_base_mul(s_bytes):
    """[s]B via 64 windowed table additions (no doublings)."""
    nibbles = scalar_to_nibbles(s_bytes)
    table = torch.as_tensor(fixed_base_table(), device=s_bytes.device)[..., None]
    acc = identity_point(s_bytes.shape[1:], s_bytes.device)
    for i in range(_NIBBLES):
        acc = point_add(acc, _select16(table[i], nibbles[i]), out_t=True)
    return acc
