"""Stateless light-client verification (ref: light/verifier.go).

Two verification regimes:
  - adjacent (h+1): hash-chain check (NextValidatorsHash) + 2/3 commit
    (verifier.go:106 VerifyAdjacent)
  - non-adjacent (h+n): trust-fraction check against the TRUSTED
    validator set, then full 2/3 against the new set
    (verifier.go:33 VerifyNonAdjacent)

Both commit checks run through the port's batch verifiers
(types/validation.py verify_commit_light / verify_commit_light_trusting):
on the card by default, on the host's plain versions with device="cpu".
Every entry point takes `device` and passes it on. Below the device
cutover (64 signatures) a batch verifies on the host either way. Only the
commit checks' verdicts (`VERDICT_ERRORS`, and the trusting check's int64
overflow) become ErrInvalidHeader or ErrNewValSetCantBeTrusted; a fault of
the verifier (a kernel wrapper's ValueError, a failed build or launch)
propagates as itself.
"""

from __future__ import annotations

from ..types.light_block import SignedHeader
from ..types.validation import (
    VERDICT_ERRORS,
    Fraction,
    verify_commit_light,
    verify_commit_light_trusting,
)
from ..types.validator_set import NotEnoughVotingPowerError, ValidatorSet
from ..utils.tmtime import Time

DEFAULT_TRUST_LEVEL = Fraction(1, 3)  # light/trust_options.go


class ErrOldHeaderExpired(Exception):
    """ref: light/errors.go ErrOldHeaderExpired."""


class ErrInvalidHeader(Exception):
    """ref: light/errors.go ErrInvalidHeader."""


class ErrNewValSetCantBeTrusted(Exception):
    """Trust-fraction check failed (ref: light/errors.go)."""


def validate_trust_level(lvl: Fraction) -> None:
    """ref: verifier.go:164 ValidateTrustLevel — in [1/3, 1]."""
    if lvl.numerator * 3 < lvl.denominator or lvl.numerator > lvl.denominator or lvl.denominator == 0:
        raise ValueError(f"trustLevel must be within [1/3, 1], given {lvl.numerator}/{lvl.denominator}")


def header_expired(h: SignedHeader, trusting_period_ns: int, now: Time) -> bool:
    """ref: verifier.go:182 HeaderExpired."""
    expiration_ns = h.header.time.unix_ns() + trusting_period_ns
    return expiration_ns <= now.unix_ns()


def _verify_new_header_and_vals(
    untrusted_header: SignedHeader,
    untrusted_vals: ValidatorSet,
    trusted_header: SignedHeader,
    now: Time,
    max_clock_drift_ns: int,
    chain_id: str,
) -> None:
    """ref: verifier.go:196 verifyNewHeaderAndVals."""
    try:
        untrusted_header.validate_basic(chain_id)
    except ErrInvalidHeader:
        raise
    except Exception as e:
        raise ErrInvalidHeader(str(e))
    if untrusted_header.header.height <= trusted_header.header.height:
        raise ErrInvalidHeader(
            f"expected new header height {untrusted_header.header.height} to be greater than "
            f"one of old header {trusted_header.header.height}"
        )
    if untrusted_header.header.time.unix_ns() <= trusted_header.header.time.unix_ns():
        raise ErrInvalidHeader(
            f"expected new header time {untrusted_header.header.time} to be after old header time "
            f"{trusted_header.header.time}"
        )
    if untrusted_header.header.time.unix_ns() >= now.unix_ns() + max_clock_drift_ns:
        raise ErrInvalidHeader(
            f"new header has a time from the future {untrusted_header.header.time} (now: {now})"
        )
    untrusted_vals_hash = untrusted_vals.hash()  # memoized (types/validator_set.py)
    if untrusted_header.header.validators_hash != untrusted_vals_hash:
        raise ErrInvalidHeader(
            f"expected new header validators ({untrusted_header.header.validators_hash.hex()}) to match "
            f"those that were supplied ({untrusted_vals_hash.hex()}) at height {untrusted_header.header.height}"
        )


def verify_non_adjacent(
    chain_id: str,
    trusted_header: SignedHeader,
    trusted_vals: ValidatorSet,
    untrusted_header: SignedHeader,
    untrusted_vals: ValidatorSet,
    trusting_period_ns: int,
    now: Time,
    max_clock_drift_ns: int,
    trust_level: Fraction = DEFAULT_TRUST_LEVEL,
    device=None,
) -> None:
    """ref: verifier.go:33 VerifyNonAdjacent."""
    if untrusted_header.header.height == trusted_header.header.height + 1:
        raise ValueError("headers must be non adjacent in height")
    if header_expired(trusted_header, trusting_period_ns, now):
        raise ErrOldHeaderExpired(f"old header expired at {trusted_header.header.time}")
    _verify_new_header_and_vals(untrusted_header, untrusted_vals, trusted_header, now, max_clock_drift_ns, chain_id)

    # enough trusted validators signed the NEW commit? (:70) Only a
    # POWER shortfall means "bisect"; invalid signatures etc. are final
    # (the reference keys on ErrNotEnoughVotingPowerSigned, :74)
    try:
        verify_commit_light_trusting(chain_id, trusted_vals, untrusted_header.commit, trust_level,
                                     device=device)
    except NotEnoughVotingPowerError as e:
        raise ErrNewValSetCantBeTrusted(str(e))
    except (*VERDICT_ERRORS, OverflowError) as e:
        raise ErrInvalidHeader(str(e))

    # the new validator set signed its own header with 2/3 (:85)
    try:
        verify_commit_light(
            chain_id,
            untrusted_vals,
            untrusted_header.commit.block_id,
            untrusted_header.header.height,
            untrusted_header.commit,
            device,
        )
    except VERDICT_ERRORS as e:
        raise ErrInvalidHeader(str(e))


def verify_adjacent(
    chain_id: str,
    trusted_header: SignedHeader,
    untrusted_header: SignedHeader,
    untrusted_vals: ValidatorSet,
    trusting_period_ns: int,
    now: Time,
    max_clock_drift_ns: int,
    device=None,
) -> None:
    """ref: verifier.go:106 VerifyAdjacent."""
    if untrusted_header.header.height != trusted_header.header.height + 1:
        raise ValueError("headers must be adjacent in height")
    if header_expired(trusted_header, trusting_period_ns, now):
        raise ErrOldHeaderExpired(f"old header expired at {trusted_header.header.time}")
    _verify_new_header_and_vals(untrusted_header, untrusted_vals, trusted_header, now, max_clock_drift_ns, chain_id)

    # hash-chain link (:135)
    if untrusted_header.header.validators_hash != trusted_header.header.next_validators_hash:
        raise ErrInvalidHeader(
            f"expected old header next validators ({trusted_header.header.next_validators_hash.hex()}) "
            f"to match those from new header ({untrusted_header.header.validators_hash.hex()})"
        )

    # 2/3 of the new set signed (:149)
    try:
        verify_commit_light(
            chain_id,
            untrusted_vals,
            untrusted_header.commit.block_id,
            untrusted_header.header.height,
            untrusted_header.commit,
            device,
        )
    except VERDICT_ERRORS as e:
        raise ErrInvalidHeader(str(e))


def verify(
    chain_id: str,
    trusted_header: SignedHeader,
    trusted_vals: ValidatorSet,
    untrusted_header: SignedHeader,
    untrusted_vals: ValidatorSet,
    trusting_period_ns: int,
    now: Time,
    max_clock_drift_ns: int,
    trust_level: Fraction = DEFAULT_TRUST_LEVEL,
    device=None,
) -> None:
    """Dispatch adjacent/non-adjacent (ref: verifier.go:154 Verify)."""
    if untrusted_header.header.height != trusted_header.header.height + 1:
        verify_non_adjacent(
            chain_id,
            trusted_header,
            trusted_vals,
            untrusted_header,
            untrusted_vals,
            trusting_period_ns,
            now,
            max_clock_drift_ns,
            trust_level,
            device,
        )
    else:
        verify_adjacent(
            chain_id, trusted_header, untrusted_header, untrusted_vals, trusting_period_ns, now,
            max_clock_drift_ns, device,
        )
