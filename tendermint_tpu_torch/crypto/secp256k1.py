"""secp256k1 ECDSA (ref: crypto/secp256k1/secp256k1.go).

Host-side only: there is no batch path for ECDSA (the reference's
crypto/batch/batch.go:26 reports secp256k1 as non-batchable and
types/validation.go:267 falls back to serial verification), so this key
type never reaches the card. A commit with an ed25519 or sr25519 proposer
that holds secp256k1 keys is verified serially (types/validation.py).

Wire format:
  - pubkey: 33-byte compressed SEC1 point
  - signature: 64-byte R || S, lower-S normalized; high-S rejected on
    verify (malleability guard, secp256k1.go:188)
  - message digest: SHA-256
  - address: RIPEMD160(SHA256(pubkey)), Bitcoin style (secp256k1.go:150)
  - deterministic keygen from secret: k = (sha256(secret) mod (n-1)) + 1
    (secp256k1.go:112 GenPrivKeySecp256k1)

Two routes give the same keys, signatures and verdicts: the
`cryptography` package's OpenSSL curve when it imports, else the
pure-Python curve of crypto/softcrypto.py. `route()` names the one taken.
"""

from __future__ import annotations

import hashlib
import os

from . import PrivKey, PubKey
from . import softcrypto as _soft

try:
    from cryptography.exceptions import InvalidSignature
    from cryptography.hazmat.primitives import hashes
    from cryptography.hazmat.primitives.asymmetric import ec
    from cryptography.hazmat.primitives.asymmetric.utils import (
        Prehashed,
        decode_dss_signature,
        encode_dss_signature,
    )
    from cryptography.hazmat.primitives.serialization import Encoding, PublicFormat

    _HAVE_OSSL = True
except ImportError:  # no `cryptography` package: the pure-Python curve
    _HAVE_OSSL = False

KEY_TYPE = "secp256k1"
PRIVKEY_SIZE = 32
PUBKEY_SIZE = 33
SIG_SIZE = 64

# Curve order n of secp256k1 (SEC2 v2, §2.4.1).
_N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
_HALF_N = _N >> 1


def route() -> str:
    """The curve implementation in use: "cryptography" or "softcrypto"."""
    return "cryptography" if _HAVE_OSSL else "softcrypto"


class Secp256k1PubKey(PubKey):
    """33-byte compressed pubkey (ref: secp256k1.go:139 PubKey)."""

    __slots__ = ("_bytes", "_key")

    def __init__(self, data: bytes):
        if len(data) != PUBKEY_SIZE:
            raise ValueError(f"secp256k1 pubkey must be {PUBKEY_SIZE} bytes, got {len(data)}")
        self._bytes = bytes(data)
        self._key = None  # parsed at first use; invalid encodings fail verify

    def _load(self):
        if self._key is None:
            if _HAVE_OSSL:
                self._key = ec.EllipticCurvePublicKey.from_encoded_point(ec.SECP256K1(), self._bytes)
            else:
                pt = _soft.secp_decompress(self._bytes)
                if pt is None:
                    raise ValueError("invalid secp256k1 point encoding")
                self._key = pt
        return self._key

    def address(self) -> bytes:
        """RIPEMD160(SHA256(pubkey)) (ref: secp256k1.go:150)."""
        sha = hashlib.sha256(self._bytes).digest()
        return hashlib.new("ripemd160", sha).digest()

    def bytes(self) -> bytes:
        return self._bytes

    def verify_signature(self, msg: bytes, sig: bytes) -> bool:
        """ref: secp256k1.go:193 VerifySignature; rejects high-S and
        non-64-byte signatures."""
        if len(sig) != SIG_SIZE:
            return False
        r = int.from_bytes(sig[:32], "big")
        s = int.from_bytes(sig[32:], "big")
        if r == 0 or s == 0 or r >= _N or s > _HALF_N:
            return False
        digest = hashlib.sha256(msg).digest()
        if not _HAVE_OSSL:
            try:
                return _soft.secp_verify(self._load(), digest, r, s)
            except ValueError:
                return False
        try:
            self._load().verify(encode_dss_signature(r, s), digest, ec.ECDSA(Prehashed(hashes.SHA256())))
            return True
        except (InvalidSignature, ValueError):
            return False

    @property
    def type_name(self) -> str:
        return KEY_TYPE

    def __repr__(self):
        return f"Secp256k1PubKey({self._bytes.hex().upper()[:16]})"


class Secp256k1PrivKey(PrivKey):
    __slots__ = ("_bytes", "_key")

    def __init__(self, data: bytes):
        if len(data) != PRIVKEY_SIZE:
            raise ValueError(f"secp256k1 privkey must be {PRIVKEY_SIZE} bytes")
        self._bytes = bytes(data)
        if _HAVE_OSSL:
            self._key = ec.derive_private_key(int.from_bytes(data, "big"), ec.SECP256K1())
        else:
            self._key = int.from_bytes(data, "big")
            if not 0 < self._key < _N:
                raise ValueError("secp256k1 privkey scalar out of range")

    @classmethod
    def generate(cls, secret: bytes | None = None) -> "Secp256k1PrivKey":
        """Random key, or deterministic from a secret via
        k = (sha256(secret) mod (n-1)) + 1 (ref: secp256k1.go:112)."""
        if secret is None:
            while True:
                cand = int.from_bytes(os.urandom(32), "big")
                if 0 < cand < _N:
                    return cls(cand.to_bytes(32, "big"))
        fe = int.from_bytes(hashlib.sha256(secret).digest(), "big")
        k = (fe % (_N - 1)) + 1
        return cls(k.to_bytes(32, "big"))

    def bytes(self) -> bytes:
        return self._bytes

    def sign(self, msg: bytes) -> bytes:
        """64-byte R||S, lower-S normalized (ref: secp256k1.go:166 Sign)."""
        digest = hashlib.sha256(msg).digest()
        if _HAVE_OSSL:
            der = self._key.sign(digest, ec.ECDSA(Prehashed(hashes.SHA256())))
            r, s = decode_dss_signature(der)
        else:
            r, s = _soft.secp_sign(self._key, digest)
        if s > _HALF_N:
            s = _N - s
        return r.to_bytes(32, "big") + s.to_bytes(32, "big")

    def pub_key(self) -> Secp256k1PubKey:
        if _HAVE_OSSL:
            return Secp256k1PubKey(
                self._key.public_key().public_bytes(Encoding.X962, PublicFormat.CompressedPoint)
            )
        return Secp256k1PubKey(_soft.secp_compress(_soft.secp_mult(self._key)))

    @property
    def type_name(self) -> str:
        return KEY_TYPE
