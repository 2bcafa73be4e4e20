"""Evidence: the pool, verification and the gossip reactor
(ref: internal/evidence/)."""

from .pool import EvidenceError, EvidencePool
from .reactor import EvidenceReactor, evidence_channel_descriptor
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
    "EvidenceReactor",
    "EvidenceVerifyError",
    "evidence_channel_descriptor",
    "verify_duplicate_vote",
    "verify_evidence",
    "verify_light_client_attack",
]
