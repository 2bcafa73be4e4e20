"""Evidence verification (ref: internal/evidence/verify.go).

Two evidence kinds:
  - DuplicateVoteEvidence: two conflicting votes by one validator for the
    same height, round and type (verify.go:211 VerifyDuplicateVote); the
    two signatures verify on the host, one key at a time
  - LightClientAttackEvidence: a conflicting light block signed by part of
    a historical validator set (verify.go:115 VerifyLightClientAttack);
    its commit check runs through the port's batch verifiers
    (types/validation.py: verify_commit_light_trusting for the lunatic
    attack, :165, verify_commit_light for equivocation, :177), on the card
    unless `device="cpu"`. Below the device cutover (64 signatures) a
    batch verifies on the host either way.

`state`, `state_store` and `block_store` are duck-typed, as in the
reference: verify_evidence reads state.last_block_height,
state.last_block_time, state.chain_id and state.consensus_params.evidence,
state_store.load_validators(h), and block_store.height(),
load_block_meta(h).header, load_block_commit(h) and load_seen_commit(h).
"""

from __future__ import annotations

import time

from ..types.evidence import DuplicateVoteEvidence, LightClientAttackEvidence
from ..types.light_block import SignedHeader
from ..types.validation import VERDICT_ERRORS, Fraction, verify_commit_light, verify_commit_light_trusting


class EvidenceVerifyError(Exception):
    pass


class EvidenceABCIError(EvidenceVerifyError):
    """The structural checks passed but the ABCI component (powers,
    timestamp, byzantine validators) is wrong: the pool regenerates it and
    stores the rectified evidence while still refusing the original
    (ref: verify.go:76-81, :136-142)."""

    def __init__(self, msg: str, regenerate):
        super().__init__(msg)
        self.regenerate = regenerate  # () -> None, fixes ev in place


def verify_evidence(ev, state, state_store, block_store, metrics=None, device=None) -> None:
    """Full contextual verification (ref: verify.go:34 verify).

    Runs the evidence's ValidateBasic first, the reference's contract
    ("must run ValidateBasic() on the evidence before verifying",
    verify.go:159): it ties a light-client attack's conflicting commit to
    the header it claims to sign. Then checks the age (expired only when
    both the height and the time window are exceeded, verify.go:59) and
    dispatches by type. `metrics` (an EvidenceMetrics) observes the wall
    time of every check, refusals included."""
    t0 = time.perf_counter()
    try:
        _verify_evidence(ev, state, state_store, block_store, device)
    finally:
        if metrics is not None:
            metrics.verify_seconds.observe(time.perf_counter() - t0)


def _verify_evidence(ev, state, state_store, block_store, device) -> None:
    try:
        ev.validate_basic()
    except ValueError as e:
        raise EvidenceVerifyError(f"invalid evidence: {e}") from e
    height = state.last_block_height
    ev_params = state.consensus_params.evidence

    age_height = height - ev.height
    header = _header_at(block_store, ev.height)
    if header is None:
        raise EvidenceVerifyError(f"don't have header at height #{ev.height}")
    ev_time = header.time
    age_duration_ns = state.last_block_time.unix_ns() - ev_time.unix_ns()

    if age_duration_ns > ev_params.max_age_duration and age_height > ev_params.max_age_num_blocks:
        raise EvidenceVerifyError(
            f"evidence from height {ev.height} is too old; min height is "
            f"{height - ev_params.max_age_num_blocks}"
        )

    if isinstance(ev, DuplicateVoteEvidence):
        val_set = state_store.load_validators(ev.height)
        if val_set is None:
            raise EvidenceVerifyError(f"no validator set at height {ev.height}")
        verify_duplicate_vote(ev, state.chain_id, val_set)
        _, val = val_set.get_by_address(ev.vote_a.validator_address)
        # the ABCI component: the powers and the recorded time must match
        # the block at its height (verify.go:76 ValidateABCI)
        if (
            ev.timestamp != ev_time
            or ev.validator_power != val.voting_power
            or ev.total_voting_power != val_set.total_voting_power()
        ):
            raise EvidenceABCIError(
                f"duplicate-vote evidence ABCI component mismatch "
                f"(time {ev.timestamp} vs {ev_time}, power {ev.validator_power}, "
                f"total {ev.total_voting_power})",
                lambda: ev.generate_abci(val, val_set, ev_time),
            )
    elif isinstance(ev, LightClientAttackEvidence):
        common_height = ev.common_height
        common_vals = state_store.load_validators(common_height)
        if common_vals is None:
            raise EvidenceVerifyError(f"no validator set at common height {common_height}")
        trusted_sh = _signed_header_at(block_store, ev.conflicting_block.height)
        if trusted_sh is None:
            # a conflicting header past our head (a forward lunatic attack):
            # use the latest header, and refuse outright if it predates the
            # conflicting block (ref: verify.go:108-118)
            trusted_sh = _signed_header_at(block_store, block_store.height())
            if trusted_sh is None:
                raise EvidenceVerifyError("no trusted header available")
            if trusted_sh.header.time.unix_ns() < sh_time_ns(ev):
                raise EvidenceVerifyError("latest block time is before conflicting block time")
        common_header = _header_at(block_store, common_height)
        if common_header is None:
            raise EvidenceVerifyError(f"no header at common height {common_height} (pruned?)")
        verify_light_client_attack(ev, common_header, trusted_sh.header, common_vals, state.chain_id, device)
        _validate_lca_abci(ev, common_vals, trusted_sh, common_header.time)
    else:
        raise EvidenceVerifyError(f"unrecognized evidence type: {type(ev)}")


def _header_at(block_store, height: int):
    meta = block_store.load_block_meta(height)
    return meta.header if meta is not None else None


def _signed_header_at(block_store, height: int) -> SignedHeader | None:
    """The header and its commit (ref: getSignedHeader, verify.go:196)."""
    header = _header_at(block_store, height)
    if header is None:
        return None
    commit = block_store.load_block_commit(height)
    if commit is None:
        commit = block_store.load_seen_commit(height)
    if commit is None:
        return None
    return SignedHeader(header=header, commit=commit)


def sh_time_ns(ev: LightClientAttackEvidence) -> int:
    return ev.conflicting_block.signed_header.header.time.unix_ns()


def _validate_lca_abci(ev: LightClientAttackEvidence, common_vals, trusted_sh, ev_time) -> None:
    """The ABCI component of light-client-attack evidence (ref:
    types/evidence.go:445 ValidateABCI): the total voting power, the
    timestamp and the byzantine validators, in order, must be what this
    node derives."""

    def fail(msg: str):
        raise EvidenceABCIError(msg, lambda: ev.generate_abci(common_vals, trusted_sh, ev_time))

    if ev.total_voting_power != common_vals.total_voting_power():
        fail(
            f"total voting power from the evidence and our validator set does not match "
            f"({ev.total_voting_power} != {common_vals.total_voting_power()})"
        )
    if ev.timestamp != ev_time:
        fail(
            f"evidence has a different time to the block it is associated with "
            f"({ev.timestamp} != {ev_time})"
        )
    derived = ev.get_byzantine_validators(common_vals, trusted_sh)
    if len(derived) != len(ev.byzantine_validators):
        fail(
            f"expected {len(derived)} byzantine validators from evidence but got "
            f"{len(ev.byzantine_validators)}"
        )
    for want, got in zip(derived, ev.byzantine_validators):
        if want.address != got.address:
            fail("evidence contained an unexpected byzantine validator address")
        if want.voting_power != got.voting_power:
            fail("evidence contained an unexpected byzantine validator power")


def verify_duplicate_vote(ev: DuplicateVoteEvidence, chain_id: str, val_set) -> None:
    """ref: verify.go:211 VerifyDuplicateVote. The powers, the total and the
    timestamp are the ABCI component's, checked in verify_evidence."""
    a, b = ev.vote_a, ev.vote_b
    if a.height != b.height or a.round != b.round or a.type != b.type:
        raise EvidenceVerifyError(
            f"h/r/s does not match: {a.height}/{a.round}/{a.type} vs {b.height}/{b.round}/{b.type}"
        )
    if a.validator_address != b.validator_address:
        raise EvidenceVerifyError("validator addresses do not match")
    if a.block_id.key() == b.block_id.key():
        raise EvidenceVerifyError("block IDs are the same — not a duplicate vote")
    _, val = val_set.get_by_address(a.validator_address)
    if val is None:
        raise EvidenceVerifyError(f"address {a.validator_address.hex()} was not a validator at height {a.height}")
    if not val.pub_key.verify_signature(a.sign_bytes(chain_id), a.signature):
        raise EvidenceVerifyError("verifying VoteA: invalid signature")
    if not val.pub_key.verify_signature(b.sign_bytes(chain_id), b.signature):
        raise EvidenceVerifyError("verifying VoteB: invalid signature")


def verify_light_client_attack(
    ev: LightClientAttackEvidence,
    common_header,
    trusted_header,
    common_vals,
    chain_id: str,
    device=None,
) -> None:
    """ref: verify.go:115 VerifyLightClientAttack. A failed commit check
    (a forged signature, short power, another chain id) is raised as
    EvidenceVerifyError, the error every consumer of this path catches; a
    fault of the verifier is not a failed check and keeps its own type."""
    sh = ev.conflicting_block.signed_header
    try:
        if common_header is not None and common_header.height != sh.header.height:
            # lunatic: the header descends from an earlier common header, so
            # a third of the common set must have signed it (:160-166)
            verify_commit_light_trusting(chain_id, common_vals, sh.commit, Fraction(1, 3), device=device)
        else:
            # equivocation or amnesia: at the same height the conflicting
            # set must be the trusted one (:142-150)
            if sh.header.validators_hash != trusted_header.validators_hash:
                raise EvidenceVerifyError(
                    f"validator hash of conflicting block ({sh.header.validators_hash.hex()}) "
                    f"does not match trusted ({trusted_header.validators_hash.hex()})"
                )
            verify_commit_light(
                chain_id,
                ev.conflicting_block.validator_set,
                sh.commit.block_id,
                sh.header.height,
                sh.commit,
                device,
            )
    except (*VERDICT_ERRORS, OverflowError) as e:
        # only the commit checks' verdicts refuse the evidence; a fault of
        # the verifier (a kernel wrapper's ValueError, a failed launch)
        # propagates as itself
        raise EvidenceVerifyError(f"verifying conflicting commit: {e}") from e

    # a conflicting block past our head must violate monotonic time to be
    # an attack (verify.go:183); otherwise the headers must differ (:188)
    if sh.header.height > trusted_header.height and sh.header.time.unix_ns() > trusted_header.time.unix_ns():
        raise EvidenceVerifyError("conflicting block doesn't violate monotonically increasing time")
    if trusted_header.hash() == sh.header.hash():
        raise EvidenceVerifyError("headers are equal — no attack")
