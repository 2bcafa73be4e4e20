"""Pure-Python primitives for where the `cryptography` package does not
import, a copy of the JAX package's crypto/softcrypto.py: X25519 (RFC
7748), ChaCha20-Poly1305 (RFC 8439, the ChaCha block vectorized across
blocks with numpy; seal and open through native/prep.c's libcrypto unless
TM_TPU_NATIVE=0), HKDF-SHA256 (RFC 5869), taken by p2p/secret_connection.py,
and secp256k1 ECDSA (SEC 2 curve, RFC 6979 deterministic nonces), taken by
crypto/secp256k1.py. Unlike the reference's, the AEAD has no quiet fallback:
a missing libcrypto raises.
"""

from __future__ import annotations

import hashlib
import hmac
import os
import struct

from .. import native

__all__ = [
    "ChaCha20Poly1305",
    "InvalidTag",
    "X25519PrivateKey",
    "X25519PublicKey",
    "hkdf_sha256",
    "x25519",
]


class InvalidTag(Exception):
    """AEAD authentication failure (mirrors cryptography.exceptions)."""


# ---------------------------------------------------------------- X25519

_P25519 = 2**255 - 19
_A24 = 121665


def _decode_scalar(k: bytes) -> int:
    b = bytearray(k)
    b[0] &= 248
    b[31] &= 127
    b[31] |= 64
    return int.from_bytes(bytes(b), "little")


def x25519(scalar: bytes, u_bytes: bytes) -> bytes:
    """RFC 7748 §5 X25519 Montgomery ladder."""
    if len(scalar) != 32 or len(u_bytes) != 32:
        raise ValueError("x25519 takes 32-byte scalar and u-coordinate")
    k = _decode_scalar(scalar)
    u = int.from_bytes(u_bytes[:31] + bytes([u_bytes[31] & 127]), "little") % _P25519
    x1, x2, z2, x3, z3 = u, 1, 0, u, 1
    swap = 0
    for t in range(254, -1, -1):
        kt = (k >> t) & 1
        if swap ^ kt:
            x2, x3 = x3, x2
            z2, z3 = z3, z2
        swap = kt
        a = (x2 + z2) % _P25519
        aa = a * a % _P25519
        b = (x2 - z2) % _P25519
        bb = b * b % _P25519
        e = (aa - bb) % _P25519
        c = (x3 + z3) % _P25519
        d = (x3 - z3) % _P25519
        da = d * a % _P25519
        cb = c * b % _P25519
        x3 = (da + cb) % _P25519
        x3 = x3 * x3 % _P25519
        z3 = (da - cb) % _P25519
        z3 = z3 * z3 % _P25519
        z3 = z3 * x1 % _P25519
        x2 = aa * bb % _P25519
        z2 = e * ((aa + _A24 * e) % _P25519) % _P25519
    if swap:
        x2, z2 = x3, z3
    out = x2 * pow(z2, _P25519 - 2, _P25519) % _P25519
    return out.to_bytes(32, "little")


class X25519PublicKey:
    """The raw u-coordinate behind the `cryptography` package's surface,
    as SecretConnection calls it."""

    def __init__(self, data: bytes):
        self._data = bytes(data)

    @classmethod
    def from_public_bytes(cls, data: bytes) -> "X25519PublicKey":
        if len(data) != 32:
            raise ValueError("X25519 public key must be 32 bytes")
        return cls(data)

    def public_bytes_raw(self) -> bytes:
        return self._data


class X25519PrivateKey:
    def __init__(self, data: bytes):
        self._data = bytes(data)

    @classmethod
    def generate(cls) -> "X25519PrivateKey":
        return cls(os.urandom(32))

    def public_key(self) -> X25519PublicKey:
        return X25519PublicKey(x25519(self._data, (9).to_bytes(32, "little")))

    def exchange(self, peer: X25519PublicKey) -> bytes:
        shared = x25519(self._data, peer.public_bytes_raw())
        if shared == b"\x00" * 32:
            raise ValueError("x25519 exchange produced the all-zero value")
        return shared


# ------------------------------------------------------ ChaCha20-Poly1305

_CHACHA_CONSTANTS = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)


def _chacha20_blocks(key_words, nonce_words, counter: int, nblocks: int) -> bytes:
    """Keystream for `nblocks` consecutive blocks, vectorized across the
    block axis with numpy (a sealed frame is ~17 blocks; one (16, n) uint32
    array walks all of them at once)."""
    import numpy as np

    n = nblocks
    state = np.empty((16, n), dtype=np.uint32)
    for i, w in enumerate(_CHACHA_CONSTANTS):
        state[i] = w
    for i, w in enumerate(key_words):
        state[4 + i] = w
    state[12] = (np.arange(n, dtype=np.uint64) + np.uint64(counter)).astype(np.uint32)
    for i, w in enumerate(nonce_words):
        state[13 + i] = w
    x = state.copy()

    def qr(a, b, c, d):
        x[a] += x[b]
        x[d] ^= x[a]
        x[d] = (x[d] << np.uint32(16)) | (x[d] >> np.uint32(16))
        x[c] += x[d]
        x[b] ^= x[c]
        x[b] = (x[b] << np.uint32(12)) | (x[b] >> np.uint32(20))
        x[a] += x[b]
        x[d] ^= x[a]
        x[d] = (x[d] << np.uint32(8)) | (x[d] >> np.uint32(24))
        x[c] += x[d]
        x[b] ^= x[c]
        x[b] = (x[b] << np.uint32(7)) | (x[b] >> np.uint32(25))

    for _ in range(10):
        qr(0, 4, 8, 12)
        qr(1, 5, 9, 13)
        qr(2, 6, 10, 14)
        qr(3, 7, 11, 15)
        qr(0, 5, 10, 15)
        qr(1, 6, 11, 12)
        qr(2, 7, 8, 13)
        qr(3, 4, 9, 14)
    x += state
    # column-major serialization = word 0..15 of block 0, then block 1, …
    return x.astype("<u4").tobytes(order="F")


def _poly1305(key: bytes, msg: bytes) -> bytes:
    """RFC 8439 §2.5 one-time authenticator."""
    r = int.from_bytes(key[:16], "little") & 0x0FFFFFFC0FFFFFFC0FFFFFFC0FFFFFFF
    s = int.from_bytes(key[16:32], "little")
    p = (1 << 130) - 5
    acc = 0
    for i in range(0, len(msg), 16):
        chunk = msg[i : i + 16]
        acc = (acc + int.from_bytes(chunk + b"\x01", "little")) * r % p
    return ((acc + s) & ((1 << 128) - 1)).to_bytes(16, "little")


def _pad16(data: bytes) -> bytes:
    return b"\x00" * (-len(data) % 16)


class ChaCha20Poly1305:
    """RFC 8439 AEAD with the cryptography-package call surface.

    Seal and open go through libcrypto (native/prep.c
    tm_aead_chacha20poly1305, one GIL-released call a frame); a missing
    libcrypto raises there. TM_TPU_NATIVE=0 is the explicit request for the
    Python cipher below, whose bytes are the same (the RFC vectors pin both
    in tests/test_torch_p2p_tcp.py). A tag that does not authenticate is a
    verdict, InvalidTag, on either route."""

    def __init__(self, key: bytes):
        if len(key) != 32:
            raise ValueError("ChaCha20Poly1305 key must be 32 bytes")
        self._key = bytes(key)
        self._key_words = struct.unpack("<8I", key)

    def _keystream(self, nonce: bytes, counter: int, nbytes: int) -> bytes:
        nonce_words = struct.unpack("<3I", nonce)
        nblocks = (nbytes + 63) // 64
        return _chacha20_blocks(self._key_words, nonce_words, counter, nblocks)[:nbytes]

    def _tag(self, nonce: bytes, aad: bytes, ct: bytes) -> bytes:
        otk = self._keystream(nonce, 0, 32)
        mac_data = (
            aad + _pad16(aad) + ct + _pad16(ct)
            + struct.pack("<QQ", len(aad), len(ct))
        )
        return _poly1305(otk, mac_data)

    def encrypt(self, nonce: bytes, data: bytes, aad: bytes | None) -> bytes:
        if len(nonce) != 12:
            raise ValueError("nonce must be 12 bytes")
        if not native.native_disabled():
            return native.aead_chacha20poly1305(True, self._key, nonce, aad or b"", bytes(data))
        ct = _xor_bytes(data, self._keystream(nonce, 1, len(data)))
        return ct + self._tag(nonce, aad or b"", ct)

    def decrypt(self, nonce: bytes, data: bytes, aad: bytes | None) -> bytes:
        if len(nonce) != 12:
            raise ValueError("nonce must be 12 bytes")
        if len(data) < 16:
            raise InvalidTag("ciphertext shorter than the tag")
        if not native.native_disabled():
            try:
                return native.aead_chacha20poly1305(False, self._key, nonce, aad or b"", bytes(data))
            except native.AeadAuthError as e:
                raise InvalidTag(str(e)) from None
        ct, tag = data[:-16], data[-16:]
        if not hmac.compare_digest(self._tag(nonce, aad or b"", ct), tag):
            raise InvalidTag("poly1305 tag mismatch")
        return _xor_bytes(ct, self._keystream(nonce, 1, len(ct)))


def _xor_bytes(a: bytes, b: bytes) -> bytes:
    import numpy as np

    return (
        np.frombuffer(a, np.uint8) ^ np.frombuffer(b[: len(a)], np.uint8)
    ).tobytes()


# ------------------------------------------------------------ HKDF-SHA256


def hkdf_sha256(ikm: bytes, length: int, info: bytes, salt: bytes | None = None) -> bytes:
    """RFC 5869 extract-and-expand."""
    salt = salt if salt is not None else b"\x00" * 32
    prk = hmac.new(salt, ikm, hashlib.sha256).digest()
    okm = b""
    t = b""
    counter = 1
    while len(okm) < length:
        t = hmac.new(prk, t + info + bytes([counter]), hashlib.sha256).digest()
        okm += t
        counter += 1
    return okm[:length]


# ------------------------------------------------------- secp256k1 ECDSA

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
