"""Evidence verification (ref: internal/evidence/). The pool, which needs
the state store, and the gossip reactor come in later slices."""

from .verify import (
    EvidenceABCIError,
    EvidenceVerifyError,
    verify_duplicate_vote,
    verify_evidence,
    verify_light_client_attack,
)

__all__ = [
    "EvidenceABCIError",
    "EvidenceVerifyError",
    "verify_duplicate_vote",
    "verify_evidence",
    "verify_light_client_attack",
]
