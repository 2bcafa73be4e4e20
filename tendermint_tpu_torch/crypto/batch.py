"""Key-type -> BatchVerifier dispatch (ref: crypto/batch/batch.go:12-33).

The seam commit verification (types/validation.py) plugs into: ed25519
and sr25519 batch on the port's device plane; other key types are verified
serially by the caller (types/validation.go:267 semantics).
"""

from __future__ import annotations

from . import BatchVerifier, PubKey
from .ed25519 import KEY_TYPE as ED25519_TYPE
from .ed25519 import Ed25519BatchVerifier
from .sr25519 import KEY_TYPE as SR25519_TYPE
from .sr25519 import Sr25519BatchVerifier


def create_batch_verifier(pk: PubKey, device=None) -> BatchVerifier:
    """ref: CreateBatchVerifier crypto/batch/batch.go:12. `device` is where
    the batch runs: the card by default, "cpu" for the plain versions."""
    if pk.type_name == ED25519_TYPE:
        return Ed25519BatchVerifier(device=device)
    if pk.type_name == SR25519_TYPE:
        return Sr25519BatchVerifier(device=device)
    raise ValueError(f"key type {pk.type_name} does not support batch verification")


def supports_batch_verifier(pk: PubKey | None) -> bool:
    """ref: SupportsBatchVerifier crypto/batch/batch.go:26."""
    if pk is None:
        return False
    return pk.type_name in (ED25519_TYPE, SR25519_TYPE)
