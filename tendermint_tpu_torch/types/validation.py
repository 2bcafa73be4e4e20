"""Commit verification, the port's main path (ref: types/validation.go).

All four consumers (block application, blocksync, light client, evidence)
funnel here. Semantics preserved exactly from the reference:
  - batch path for >=2 signatures with a batch-capable key type (:12-16)
  - tally-before-verify with the voting-power check preceding the
    signature check (:237)
  - early-break once power exceeds the threshold when not counting all
    signatures (:225-233)
  - first-invalid-index reporting on batch failure (:245-255)
  - by-address lookup + double-vote detection for the trusting path
    (:190-210)

The batch verifier is the port's device plane (crypto/ed25519.py or
crypto/sr25519.py -> ops/msm.py, ops/verify.py or ops/verify_sr.py):
device launches evaluate every signature's equation data-parallel
(cofactored ZIP-215 for ed25519, ristretto encodings for sr25519), so
unlike the reference no serial re-verification pass is needed to locate a
bad signature.

Every entry point takes `device`: where the batch verifier runs, the card
by default, "cpu" for the plain PyTorch versions. The batch path writes the
reference's verify.commit_dispatch and verify.commit_collect spans and, with
tracing on, tags its batch with the commit's journey key (trace/).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from .. import trace as _trace
from ..crypto import batch as crypto_batch
from .block import BlockID, Commit, CommitSig
from .validator_set import NotEnoughVotingPowerError, ValidatorSet

# ref: types/validation.go:12
BATCH_VERIFY_THRESHOLD = 2


class CommitVerificationError(ValueError):
    """A commit that does not verify: a nil commit or validator set, a zero
    trust level, a wrong set size, height or block ID, a double vote or a
    wrong signature, with the reference's message. A fault of the verifier
    itself (a kernel wrapper's guard, a build, a launch or a missing device)
    keeps its own type, so a caller that refuses a block on this error does
    not refuse it on those."""


# Every verdict the commit checks give on their input: a caller that refuses
# a block, a header or evidence refuses it on these and on nothing else.
VERDICT_ERRORS = (CommitVerificationError, NotEnoughVotingPowerError)


@dataclass(frozen=True)
class Fraction:
    """ref: libs/math/fraction.go."""

    numerator: int
    denominator: int


def _should_batch_verify(vals: ValidatorSet, commit: Commit) -> bool:
    """ref: shouldBatchVerify (types/validation.go:14)."""
    if len(commit.signatures) < BATCH_VERIFY_THRESHOLD:
        return False
    proposer = vals.get_proposer()
    return proposer is not None and crypto_batch.supports_batch_verifier(proposer.pub_key)


def verify_commit(
    chain_id: str, vals: ValidatorSet, block_id: BlockID, height: int, commit: Commit, device=None
) -> None:
    """Verify +2/3 signed AND check every signature (ref: VerifyCommit,
    types/validation.go:27 — all signatures are checked because apps'
    incentivization logic depends on LastCommitInfo)."""
    verify_commit_async(chain_id, vals, block_id, height, commit, device)()


def verify_commit_async(
    chain_id: str, vals: ValidatorSet, block_id: BlockID, height: int, commit: Commit, device=None
):
    """verify_commit split at the device boundary, mirroring
    verify_commit_light_async: host-side checks raise NOW, the
    signature batch is dispatched, and the returned
    no-arg callable raises (or not) with verify_commit's exact error
    surface."""
    _verify_basic_vals_and_commit(vals, commit, height, block_id)
    voting_power_needed = vals.total_voting_power() * 2 // 3
    ignore = lambda c: c.block_id_flag == 1  # absent
    count = lambda c: c.block_id_flag == 2  # commit
    if _should_batch_verify(vals, commit):
        return _verify_commit_batch(
            chain_id, vals, commit, voting_power_needed, ignore, count, True, True,
            defer=True, device=device,
        )
    _verify_commit_single(chain_id, vals, commit, voting_power_needed, ignore, count, True, True)
    return lambda: None


def verify_commit_light(
    chain_id: str, vals: ValidatorSet, block_id: BlockID, height: int, commit: Commit, device=None
) -> None:
    """Verify +2/3 signed, early-exit once reached (ref: VerifyCommitLight,
    types/validation.go:61). One body with the async variant — the
    blocksync verify-ahead guards rely on the two being semantically
    identical."""
    verify_commit_light_async(chain_id, vals, block_id, height, commit, device)()


def verify_commit_light_async(
    chain_id: str, vals: ValidatorSet, block_id: BlockID, height: int, commit: Commit, device=None
):
    """verify_commit_light split at the device boundary: all host-side
    checks (structure, tally, power threshold) run NOW and raise
    immediately; the signature kernel is dispatched and the returned
    no-arg callable raises (or not) with verify_commit_light's exact
    error surface when invoked. Lets blocksync verify height h+1 on the
    chip while height h applies host-side (the verify-ahead pipeline —
    a capability the reference's serial verify loop lacks)."""
    _verify_basic_vals_and_commit(vals, commit, height, block_id)
    voting_power_needed = vals.total_voting_power() * 2 // 3
    ignore = lambda c: c.block_id_flag != 2
    count = lambda c: True
    if _should_batch_verify(vals, commit):
        return _verify_commit_batch(
            chain_id, vals, commit, voting_power_needed, ignore, count, False, True,
            defer=True, device=device,
        )
    _verify_commit_single(chain_id, vals, commit, voting_power_needed, ignore, count, False, True)
    return lambda: None


def verify_commit_light_trusting(
    chain_id: str, vals: ValidatorSet, commit: Commit, trust_level: Fraction, device=None
) -> None:
    """Verify trustLevel of an arbitrary validator set signed, looking
    validators up by address (ref: VerifyCommitLightTrusting,
    types/validation.go:96)."""
    if vals is None:
        raise CommitVerificationError("nil validator set")
    if trust_level.denominator == 0:
        raise CommitVerificationError("trustLevel has zero Denominator")
    if commit is None:
        raise CommitVerificationError("nil commit")
    product = vals.total_voting_power() * trust_level.numerator
    if product >= 2**63:
        raise OverflowError("int64 overflow while calculating voting power needed")
    voting_power_needed = product // trust_level.denominator
    ignore = lambda c: c.block_id_flag != 2
    count = lambda c: True
    if _should_batch_verify(vals, commit):
        _verify_commit_batch(
            chain_id, vals, commit, voting_power_needed, ignore, count, False, False, device=device
        )
    else:
        _verify_commit_single(chain_id, vals, commit, voting_power_needed, ignore, count, False, False)


def _verify_commit_batch(
    chain_id: str,
    vals: ValidatorSet,
    commit: Commit,
    voting_power_needed: int,
    ignore_sig: Callable[[CommitSig], bool],
    count_sig: Callable[[CommitSig], bool],
    count_all_signatures: bool,
    look_up_by_index: bool,
    defer: bool = False,
    device=None,
):
    """ref: verifyCommitBatch (types/validation.go:154).

    With defer=True the kernel is dispatched asynchronously and a no-arg
    completion callable is returned (raising with the same errors the
    synchronous path would); host-side failures still raise immediately."""
    proposer = vals.get_proposer()
    try:
        bv = crypto_batch.create_batch_verifier(proposer.pub_key, device=device)
    except Exception as e:
        crypto_batch.mark_fault(e)
        raise
    if _trace.enabled():
        # the journey tag rides the engine submit, so the coalesced launch's
        # dispatch and collect spans list this commit's height
        bv.journey = _trace.journey_key(commit.height, commit.round, "verify", "")
    tallied = 0
    seen_vals: dict[int, int] = {}
    batch_sig_idxs: list[int] = []

    for idx, commit_sig in enumerate(commit.signatures):
        if ignore_sig(commit_sig):
            continue
        if look_up_by_index:
            val = vals.validators[idx]
        else:
            val_idx, val = vals.get_by_address(commit_sig.validator_address)
            if val is None:
                continue
            if val_idx in seen_vals:
                raise CommitVerificationError(f"double vote from {val} ({seen_vals[val_idx]} and {idx})")
            seen_vals[val_idx] = idx
        vote_sign_bytes = commit.vote_sign_bytes(chain_id, idx)
        try:
            bv.add(val.pub_key, vote_sign_bytes, commit_sig.signature)
        except ValueError:
            # Mixed key types: this key cannot join the proposer-typed
            # batch. The reference returns the Add error outright
            # (validation.go:211), rejecting commits that are in fact
            # valid; we deliberately fall back to serial verification
            # instead — acceptance still requires every signature to
            # verify, so no invalid commit is admitted.
            single = _verify_commit_single(
                chain_id, vals, commit, voting_power_needed,
                ignore_sig, count_sig, count_all_signatures, look_up_by_index,
            )
            if defer:
                return lambda: single
            return single
        batch_sig_idxs.append(idx)
        if count_sig(commit_sig):
            tallied += val.voting_power
        if not count_all_signatures and tallied > voting_power_needed:
            break

    if tallied <= voting_power_needed:
        raise NotEnoughVotingPowerError(got=tallied, needed=voting_power_needed)

    with _trace.span("verify.commit_dispatch", "verify",
                     height=commit.height, nsigs=len(batch_sig_idxs)):
        try:
            pending = bv.verify_async()
        except Exception as e:
            crypto_batch.mark_fault(e)
            raise

    def complete() -> None:
        with _trace.span("verify.commit_collect", "verify",
                         height=commit.height, nsigs=len(batch_sig_idxs)):
            try:
                ok, valid_sigs = pending()
            except Exception as e:
                crypto_batch.mark_fault(e)
                raise
        if ok:
            return
        for i, sig_ok in enumerate(valid_sigs):
            if not sig_ok:
                idx = batch_sig_idxs[i]
                sig = commit.signatures[idx].signature
                raise CommitVerificationError(f"wrong signature (#{idx}): {sig.hex().upper()}")
        raise RuntimeError("BUG: batch verification failed with no invalid signatures")

    if defer:
        return complete
    complete()


def _verify_commit_single(
    chain_id: str,
    vals: ValidatorSet,
    commit: Commit,
    voting_power_needed: int,
    ignore_sig: Callable[[CommitSig], bool],
    count_sig: Callable[[CommitSig], bool],
    count_all_signatures: bool,
    look_up_by_index: bool,
) -> None:
    """ref: verifyCommitSingle (types/validation.go:267)."""
    tallied = 0
    seen_vals: dict[int, int] = {}
    for idx, commit_sig in enumerate(commit.signatures):
        if ignore_sig(commit_sig):
            continue
        if look_up_by_index:
            val = vals.validators[idx]
        else:
            val_idx, val = vals.get_by_address(commit_sig.validator_address)
            if val is None:
                continue
            if val_idx in seen_vals:
                raise CommitVerificationError(f"double vote from {val} ({seen_vals[val_idx]} and {idx})")
            seen_vals[val_idx] = idx
        vote_sign_bytes = commit.vote_sign_bytes(chain_id, idx)
        if not val.pub_key.verify_signature(vote_sign_bytes, commit_sig.signature):
            raise CommitVerificationError(f"wrong signature (#{idx}): {commit_sig.signature.hex().upper()}")
        if count_sig(commit_sig):
            tallied += val.voting_power
        if not count_all_signatures and tallied > voting_power_needed:
            return
    if tallied <= voting_power_needed:
        raise NotEnoughVotingPowerError(got=tallied, needed=voting_power_needed)


def _verify_basic_vals_and_commit(vals: ValidatorSet, commit: Commit, height: int, block_id: BlockID) -> None:
    """ref: verifyBasicValsAndCommit (types/validation.go:328)."""
    if vals is None:
        raise CommitVerificationError("nil validator set")
    if commit is None:
        raise CommitVerificationError("nil commit")
    if vals.size() != len(commit.signatures):
        raise CommitVerificationError(f"invalid commit -- wrong set size: {vals.size()} vs {len(commit.signatures)}")
    if height != commit.height:
        raise CommitVerificationError(f"invalid commit -- wrong height: {height} vs {commit.height}")
    if block_id != commit.block_id:
        raise CommitVerificationError(f"invalid commit -- wrong block ID: want {block_id}, got {commit.block_id}")
