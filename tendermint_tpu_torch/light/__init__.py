"""Light client: stateless header verification (ref: light/verifier.go).

The client with its bisection, the store and the providers come with
evidence (types/evidence.py), which the client imports.
"""

from .verifier import (
    DEFAULT_TRUST_LEVEL,
    ErrInvalidHeader,
    ErrNewValSetCantBeTrusted,
    ErrOldHeaderExpired,
    header_expired,
    validate_trust_level,
    verify,
    verify_adjacent,
    verify_non_adjacent,
)

__all__ = [
    "DEFAULT_TRUST_LEVEL",
    "ErrInvalidHeader",
    "ErrNewValSetCantBeTrusted",
    "ErrOldHeaderExpired",
    "header_expired",
    "validate_trust_level",
    "verify",
    "verify_adjacent",
    "verify_non_adjacent",
]
