"""Crypto interfaces (ref: crypto/crypto.go:38-80).

`PubKey`/`PrivKey`/`BatchVerifier` mirror the reference node's interfaces;
the ed25519 and sr25519 batch verifiers (crypto/ed25519.py,
crypto/sr25519.py) run on the port's device plane (ops/), with the
pure-Python verifiers (`ed25519_ref`, `sr25519.verify`) as the
correctness reference; secp256k1 keys (crypto/secp256k1.py) verify on the
host only, as in the reference.
"""

from __future__ import annotations

import hashlib
from abc import ABC, abstractmethod

ADDRESS_SIZE = 20  # crypto/crypto.go:22 (TruncatedSize)


def checksum(data: bytes) -> bytes:
    """SHA-256 (ref: crypto.Checksum, crypto/hash.go)."""
    return hashlib.sha256(data).digest()


def address_hash(data: bytes) -> bytes:
    """First 20 bytes of SHA-256 (ref: crypto.AddressHash, crypto/crypto.go:27)."""
    return checksum(data)[:ADDRESS_SIZE]


class PubKey(ABC):
    @abstractmethod
    def address(self) -> bytes: ...

    @abstractmethod
    def bytes(self) -> bytes: ...

    @abstractmethod
    def verify_signature(self, msg: bytes, sig: bytes) -> bool: ...

    @property
    @abstractmethod
    def type_name(self) -> str: ...

    def __eq__(self, other):
        return isinstance(other, PubKey) and self.type_name == other.type_name and self.bytes() == other.bytes()

    def __hash__(self):
        return hash((self.type_name, self.bytes()))


class PrivKey(ABC):
    @abstractmethod
    def bytes(self) -> bytes: ...

    @abstractmethod
    def sign(self, msg: bytes) -> bytes: ...

    @abstractmethod
    def pub_key(self) -> PubKey: ...

    @property
    @abstractmethod
    def type_name(self) -> str: ...


class BatchVerifier(ABC):
    """Accumulate (pubkey, msg, sig) triples, then verify all at once
    (ref: crypto/crypto.go:69-80)."""

    # optional journey tag (trace.journey_key string): a caller that
    # verifies on behalf of one chain event (a commit at a height) sets it,
    # so the engine's coalesced dispatch and collect spans stay attributable
    # to that event even when its job shares a launch with others
    journey: str | None = None

    @abstractmethod
    def add(self, pub_key: PubKey, msg: bytes, sig: bytes) -> None:
        """Queue a verification job. Raises on malformed inputs."""

    @abstractmethod
    def verify(self) -> tuple[bool, list[bool]]:
        """Returns (all_valid, per-job validity bitmap)."""

    def verify_async(self):
        """Dispatch verification without blocking; returns a no-arg
        callable producing (all_valid, bitmap). The default completes
        eagerly."""
        result = self.verify()
        return lambda: result
