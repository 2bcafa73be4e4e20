"""Light client: trust-period header verification with bisection, witness
cross-checks, a trusted store and providers (ref: light/)."""

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
from .client import LightClient, TrustOptions
from .store import LightStore, MemLightStore, DBLightStore
from .provider import Provider, LocalProvider

__all__ = [
    "DEFAULT_TRUST_LEVEL",
    "DBLightStore",
    "ErrInvalidHeader",
    "ErrNewValSetCantBeTrusted",
    "ErrOldHeaderExpired",
    "LightClient",
    "LightStore",
    "LocalProvider",
    "MemLightStore",
    "Provider",
    "TrustOptions",
    "header_expired",
    "validate_trust_level",
    "verify",
    "verify_adjacent",
    "verify_non_adjacent",
]
