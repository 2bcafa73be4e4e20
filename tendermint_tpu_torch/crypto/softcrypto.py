"""Pure-Python secp256k1 ECDSA (SEC 2 curve, RFC 6979 deterministic nonces),
a trimmed copy of the JAX package's crypto/softcrypto.py: the curve math
alone, which crypto/secp256k1.py takes when the `cryptography` package does
not import. The X25519 and ChaCha20-Poly1305 halves of that module come
with the node.
"""

from __future__ import annotations

import hashlib
import hmac

# SEC 2 v2 §2.4.1 domain parameters.
SECP_P = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFFC2F
SECP_N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
SECP_GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
SECP_GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8
SECP_G = (SECP_GX, SECP_GY)


def _secp_add(p1, p2):
    """Affine short-Weierstrass addition (a=0); None is the identity."""
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if (y1 + y2) % SECP_P == 0:
            return None
        lam = (3 * x1 * x1) * pow(2 * y1, SECP_P - 2, SECP_P) % SECP_P
    else:
        lam = (y2 - y1) * pow(x2 - x1, SECP_P - 2, SECP_P) % SECP_P
    x3 = (lam * lam - x1 - x2) % SECP_P
    return x3, (lam * (x1 - x3) - y1) % SECP_P


def secp_mult(k: int, point=SECP_G):
    acc = None
    addend = point
    while k:
        if k & 1:
            acc = _secp_add(acc, addend)
        addend = _secp_add(addend, addend)
        k >>= 1
    return acc


def secp_decompress(data: bytes):
    """33-byte SEC1 compressed point -> (x, y) or None if invalid."""
    if len(data) != 33 or data[0] not in (2, 3):
        return None
    x = int.from_bytes(data[1:], "big")
    if x >= SECP_P:
        return None
    y2 = (pow(x, 3, SECP_P) + 7) % SECP_P
    y = pow(y2, (SECP_P + 1) // 4, SECP_P)
    if y * y % SECP_P != y2:
        return None
    if (y & 1) != (data[0] & 1):
        y = SECP_P - y
    return x, y


def secp_compress(point) -> bytes:
    x, y = point
    return bytes([2 | (y & 1)]) + x.to_bytes(32, "big")


def _rfc6979_k(priv: int, digest: bytes) -> int:
    """RFC 6979 deterministic ECDSA nonce (SHA-256)."""
    holen = 32
    x = priv.to_bytes(32, "big")
    h1 = int.from_bytes(digest, "big") % SECP_N
    v = b"\x01" * holen
    k = b"\x00" * holen
    k = hmac.new(k, v + b"\x00" + x + h1.to_bytes(32, "big"), hashlib.sha256).digest()
    v = hmac.new(k, v, hashlib.sha256).digest()
    k = hmac.new(k, v + b"\x01" + x + h1.to_bytes(32, "big"), hashlib.sha256).digest()
    v = hmac.new(k, v, hashlib.sha256).digest()
    while True:
        v = hmac.new(k, v, hashlib.sha256).digest()
        cand = int.from_bytes(v, "big")
        if 1 <= cand < SECP_N:
            return cand
        k = hmac.new(k, v + b"\x00", hashlib.sha256).digest()
        v = hmac.new(k, v, hashlib.sha256).digest()


def secp_sign(priv: int, digest: bytes) -> tuple[int, int]:
    """(r, s) over a 32-byte digest; s NOT low-normalized (callers do)."""
    z = int.from_bytes(digest, "big") % SECP_N
    while True:
        k = _rfc6979_k(priv, digest)
        pt = secp_mult(k)
        r = pt[0] % SECP_N
        if r == 0:
            digest = hashlib.sha256(digest).digest()
            continue
        s = (z + r * priv) * pow(k, SECP_N - 2, SECP_N) % SECP_N
        if s == 0:
            digest = hashlib.sha256(digest).digest()
            continue
        return r, s


def secp_verify(pub_point, digest: bytes, r: int, s: int) -> bool:
    if not (1 <= r < SECP_N and 1 <= s < SECP_N):
        return False
    z = int.from_bytes(digest, "big") % SECP_N
    w = pow(s, SECP_N - 2, SECP_N)
    u1 = z * w % SECP_N
    u2 = r * w % SECP_N
    pt = _secp_add(secp_mult(u1), secp_mult(u2, pub_point))
    return pt is not None and pt[0] % SECP_N == r
