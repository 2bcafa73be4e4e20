"""RFC-6962 merkle roots (ref: crypto/merkle/tree.go).

Leaf hash = SHA256(0x00 || leaf); inner hash = SHA256(0x01 || left ||
right); trees over n items split at the largest power of two below n,
which bottom-up pairing with odd-node promotion builds exactly.
"""

from __future__ import annotations

import hashlib

LEAF_PREFIX = b"\x00"
INNER_PREFIX = b"\x01"


def leaf_hash(leaf: bytes) -> bytes:
    return hashlib.sha256(LEAF_PREFIX + leaf).digest()


def inner_hash(left: bytes, right: bytes) -> bytes:
    return hashlib.sha256(INNER_PREFIX + left + right).digest()


def _hash_level(level: list[bytes]) -> list[bytes]:
    """One pairing pass; an odd tail node is promoted unchanged."""
    nxt = [inner_hash(level[i], level[i + 1]) for i in range(0, len(level) - 1, 2)]
    if len(level) & 1:
        nxt.append(level[-1])
    return nxt


def hash_from_byte_slices(items: list[bytes]) -> bytes:
    """Merkle root (ref: HashFromByteSlices, crypto/merkle/tree.go:11)."""
    if not items:
        return hashlib.sha256(b"").digest()
    level = [leaf_hash(it) for it in items]
    while len(level) > 1:
        level = _hash_level(level)
    return level[0]
