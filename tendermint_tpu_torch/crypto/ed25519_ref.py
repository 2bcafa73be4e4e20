"""Pure-Python Edwards25519 / ed25519 reference implementation.

This is the framework's CPU correctness oracle: RFC 8032 keygen/sign plus
ZIP-215 verification semantics matching the reference's curve25519-voi
configuration (crypto/ed25519/ed25519.go:24-31 sets ZIP-215: cofactored
equation, non-canonical point encodings accepted, s < L enforced).

All arithmetic uses Python ints — slow but transparently correct; the TPU
plane (ops/) is tested against this module, including adversarial
small-order and non-canonical vectors.
"""

from __future__ import annotations

import hashlib
import secrets

P = 2**255 - 19
L = 2**252 + 27742317777372353535851937790883648493
D = (-121665 * pow(121666, P - 2, P)) % P
SQRT_M1 = pow(2, (P - 1) // 4, P)  # sqrt(-1) mod p

# Base point B = (Bx, By), By = 4/5.
BY = (4 * pow(5, P - 2, P)) % P
_BX_SQ = lambda y: ((y * y - 1) * pow(D * y * y + 1, P - 2, P)) % P  # noqa: E731


def _sqrt_ratio(u: int, v: int):
    """Return x with v*x^2 == u (mod p), or None."""
    # x = u v^3 (u v^7)^((p-5)/8); then fix by sqrt(-1) if needed.
    x = (u * pow(v, 3, P) * pow(u * pow(v, 7, P) % P, (P - 5) // 8, P)) % P
    if (v * x * x - u) % P == 0:
        return x
    if (v * x * x + u) % P == 0:
        return (x * SQRT_M1) % P
    return None


BX = _sqrt_ratio(_BX_SQ(BY), 1)
if BX % 2 != 0:
    BX = P - BX

# Extended homogeneous coordinates (X, Y, Z, T) with x=X/Z, y=Y/Z, T=XY/Z.
IDENTITY = (0, 1, 1, 0)


def point_add(p, q):
    """Unified twisted-Edwards addition (complete for ed25519: a=-1 is
    square mod p, d nonsquare)."""
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    a = (y1 - x1) * (y2 - x2) % P
    b = (y1 + x1) * (y2 + x2) % P
    c = 2 * t1 * t2 * D % P
    dd = 2 * z1 * z2 % P
    e, f, g, h = b - a, dd - c, dd + c, b + a
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def point_double(p):
    return point_add(p, p)


def point_neg(p):
    x, y, z, t = p
    return (P - x if x else 0, y, z, P - t if t else 0)


def point_equal(p, q):
    x1, y1, z1, _ = p
    x2, y2, z2, _ = q
    return (x1 * z2 - x2 * z1) % P == 0 and (y1 * z2 - y2 * z1) % P == 0


def point_is_identity(p):
    x, y, z, _ = p
    return x % P == 0 and (y - z) % P == 0


def scalar_mult(k: int, p):
    q = IDENTITY
    while k > 0:
        if k & 1:
            q = point_add(q, p)
        p = point_double(p)
        k >>= 1
    return q


BASE = (BX, BY, 1, BX * BY % P)


def compress(p) -> bytes:
    x, y, z, _ = p
    zinv = pow(z, P - 2, P)
    x, y = x * zinv % P, y * zinv % P
    return int.to_bytes(y | ((x & 1) << 255), 32, "little")


def decompress(data: bytes, zip215: bool = True):
    """Decode a point encoding.

    zip215=True follows ref10/frombytes_negate semantics (what the
    reference's voi ZIP_215 verify option uses): the y coordinate is NOT
    required to be canonical (y >= p accepted), and x=0 with sign bit set
    is accepted (yields x = -0 = 0). zip215=False applies RFC 8032 strict
    decoding (canonical y, reject x=0 with sign=1).
    """
    if len(data) != 32:
        return None
    val = int.from_bytes(data, "little")
    sign = val >> 255
    y = val & ((1 << 255) - 1)
    if not zip215 and y >= P:
        return None
    y %= P
    u = (y * y - 1) % P
    v = (D * y * y + 1) % P
    x = _sqrt_ratio(u, v)
    if x is None:
        return None
    if x == 0 and sign and not zip215:
        return None
    if (x & 1) != sign:
        x = (P - x) % P
    return (x, y % P, 1, x * y % P)


# -- scalars / hashing ----------------------------------------------------


def _sha512(*parts: bytes) -> bytes:
    h = hashlib.sha512()
    for part in parts:
        h.update(part)
    return h.digest()


def _clamp(h: bytes) -> int:
    a = int.from_bytes(h[:32], "little")
    a &= (1 << 254) - 8
    a |= 1 << 254
    return a


def challenge_scalar(r_enc: bytes, a_enc: bytes, msg: bytes) -> int:
    """h = SHA512(R || A || M) mod L — over the raw encodings as received."""
    return int.from_bytes(_sha512(r_enc, a_enc, msg), "little") % L


# -- keys / sign / verify -------------------------------------------------

SEED_SIZE = 32
PUBKEY_SIZE = 32
PRIVKEY_SIZE = 64  # seed || pubkey, matching Go's crypto/ed25519 layout
SIG_SIZE = 64


def pubkey_from_seed(seed: bytes) -> bytes:
    a = _clamp(_sha512(seed))
    return compress(scalar_mult(a, BASE))


def gen_privkey(seed: bytes | None = None) -> bytes:
    seed = seed if seed is not None else secrets.token_bytes(SEED_SIZE)
    return seed + pubkey_from_seed(seed)


def sign(priv: bytes, msg: bytes) -> bytes:
    seed, pub = priv[:32], priv[32:]
    h = _sha512(seed)
    a = _clamp(h)
    prefix = h[32:]
    r = int.from_bytes(_sha512(prefix, msg), "little") % L
    r_enc = compress(scalar_mult(r, BASE))
    k = challenge_scalar(r_enc, pub, msg)
    s = (r + k * a) % L
    return r_enc + int.to_bytes(s, 32, "little")


def verify(pub: bytes, msg: bytes, sig: bytes, zip215: bool = True) -> bool:
    """ZIP-215 (default) or RFC-8032-strict single verification."""
    if len(sig) != SIG_SIZE or len(pub) != PUBKEY_SIZE:
        return False
    a_point = decompress(pub, zip215=zip215)
    if a_point is None:
        return False
    r_enc, s_enc = sig[:32], sig[32:]
    s = int.from_bytes(s_enc, "little")
    if s >= L:
        return False
    r_point = decompress(r_enc, zip215=zip215)
    if r_point is None:
        return False
    k = challenge_scalar(r_enc, pub, msg)
    # Cofactored: [8][s]B == [8]R + [8][k]A.
    lhs = scalar_mult(8 * s, BASE)
    rhs = point_add(scalar_mult(8, r_point), scalar_mult(8 * k, a_point))
    return point_equal(lhs, rhs)


def small_order_points() -> list[bytes]:
    """Canonical encodings of the full 8-torsion subgroup (adversarial
    tests). The rational torsion of ed25519 is cyclic of order 8: multiply
    any point of full order by L to land on a generator."""
    y = 2
    while True:
        cand = decompress(int.to_bytes(y, 32, "little"))
        if cand is not None:
            t = scalar_mult(L, cand)
            if not point_is_identity(t) and not point_is_identity(scalar_mult(4, t)):
                gen = t  # order exactly 8
                break
        y += 1
    pts, q = [], IDENTITY
    for _ in range(8):
        pts.append(compress(q))
        q = point_add(q, gen)
    return sorted(set(pts))
