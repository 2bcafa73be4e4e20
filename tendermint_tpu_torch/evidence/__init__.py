"""Evidence: the pool and verification (ref: internal/evidence/). The
gossip reactor comes with the node."""

from .pool import EvidenceError, EvidencePool
from .verify import (
    EvidenceABCIError,
    EvidenceVerifyError,
    verify_duplicate_vote,
    verify_evidence,
    verify_light_client_attack,
)

__all__ = [
    "EvidenceABCIError",
    "EvidenceError",
    "EvidencePool",
    "EvidenceVerifyError",
    "verify_duplicate_vote",
    "verify_evidence",
    "verify_light_client_attack",
]
