"""Round state + per-height vote bookkeeping
(ref: internal/consensus/types/round_state.go, height_vote_set.go)."""

from __future__ import annotations

from dataclasses import dataclass, field

from ..types.block import Block, BlockID
from ..types.part_set import PartSet
from ..types.proposal import Proposal
from ..types.validator_set import ValidatorSet
from ..types.vote import PRECOMMIT, PREVOTE, Vote
from ..types.vote_set import VoteSet
from ..utils.tmtime import Time

# RoundStepType (ref: round_state.go:20-32)
STEP_NEW_HEIGHT = 1
STEP_NEW_ROUND = 2
STEP_PROPOSE = 3
STEP_PREVOTE = 4
STEP_PREVOTE_WAIT = 5
STEP_PRECOMMIT = 6
STEP_PRECOMMIT_WAIT = 7
STEP_COMMIT = 8

STEP_NAMES = {
    STEP_NEW_HEIGHT: "NewHeight",
    STEP_NEW_ROUND: "NewRound",
    STEP_PROPOSE: "Propose",
    STEP_PREVOTE: "Prevote",
    STEP_PREVOTE_WAIT: "PrevoteWait",
    STEP_PRECOMMIT: "Precommit",
    STEP_PRECOMMIT_WAIT: "PrecommitWait",
    STEP_COMMIT: "Commit",
}


class HeightVoteSet:
    """All rounds' prevote/precommit VoteSets for one height; rounds are
    created lazily up to round+1, plus peer-triggered catchup rounds
    (ref: internal/consensus/types/height_vote_set.go:29)."""

    def __init__(self, chain_id: str, height: int, val_set: ValidatorSet,
                 extensions_enabled: bool = False):
        """extensions_enabled: vote extensions active at this height —
        precommit sets are then extended (verify extension signatures,
        ref: height_vote_set.go + NewExtendedVoteSet)."""
        self.chain_id = chain_id
        self.height = height
        self.val_set = val_set
        self.extensions_enabled = extensions_enabled
        self.round = 0
        self._round_vote_sets: dict[int, tuple[VoteSet, VoteSet]] = {}
        self._peer_catchup_rounds: dict[str, list[int]] = {}
        self.set_round(0)

    def set_round(self, round_: int) -> None:
        """Create vote sets up through round_+1 (ref: SetRound :64)."""
        new_round = self.round - 1 if self.round > 0 else 0
        for r in range(new_round, round_ + 2):
            if r not in self._round_vote_sets:
                self._add_round(r)
        self.round = round_

    def _add_round(self, round_: int) -> None:
        prevotes = VoteSet(self.chain_id, self.height, round_, PREVOTE, self.val_set)
        if self.extensions_enabled:
            precommits = VoteSet.extended(
                self.chain_id, self.height, round_, PRECOMMIT, self.val_set
            )
        else:
            precommits = VoteSet(self.chain_id, self.height, round_, PRECOMMIT, self.val_set)
        self._round_vote_sets[round_] = (prevotes, precommits)

    def _get(self, round_: int, vote_type: int) -> VoteSet | None:
        rvs = self._round_vote_sets.get(round_)
        if rvs is None:
            return None
        return rvs[0] if vote_type == PREVOTE else rvs[1]

    def prevotes(self, round_: int) -> VoteSet | None:
        return self._get(round_, PREVOTE)

    def precommits(self, round_: int) -> VoteSet | None:
        return self._get(round_, PRECOMMIT)

    def add_vote(self, vote: Vote, peer_id: str = "") -> bool:
        """ref: AddVote :87 — unknown future rounds from peers are
        allowed twice per peer (catchup), then rejected."""
        vote_set = self._get(vote.round, vote.type)
        if vote_set is None:
            rounds = self._peer_catchup_rounds.setdefault(peer_id, [])
            if len(rounds) < 2:
                self._add_round(vote.round)
                vote_set = self._get(vote.round, vote.type)
                rounds.append(vote.round)
            else:
                raise GotVoteFromUnwantedRoundError(
                    f"peer has sent a vote that does not match our round for more than one round (round {vote.round})"
                )
        return vote_set.add_vote(vote)

    def pol_info(self) -> tuple[int, BlockID | None]:
        """Last round with a +2/3 prevote majority, or (-1, None)
        (ref: POLInfo :140)."""
        for r in range(self.round, -1, -1):
            prevotes = self.prevotes(r)
            if prevotes is not None:
                bid, ok = prevotes.two_thirds_majority()
                if ok:
                    return r, bid
        return -1, None

    def set_peer_maj23(self, round_: int, vote_type: int, peer_id: str, block_id: BlockID) -> None:
        if round_ not in self._round_vote_sets:
            self._add_round(round_)
        vs = self._get(round_, vote_type)
        vs.set_peer_maj23(peer_id, block_id)


class GotVoteFromUnwantedRoundError(Exception):
    pass


@dataclass
class RoundState:
    """The consensus-internal state snapshot (ref: round_state.go:67).
    Owned exclusively by the consensus loop thread — never mutated
    elsewhere (the reference's single-receiveRoutine discipline)."""

    height: int = 0
    round: int = 0
    step: int = STEP_NEW_HEIGHT
    start_time: Time = field(default_factory=Time)
    commit_time: Time = field(default_factory=Time)
    validators: ValidatorSet | None = None
    proposal: Proposal | None = None
    proposal_receive_time: Time = field(default_factory=Time)
    proposal_block: Block | None = None
    proposal_block_parts: PartSet | None = None
    locked_round: int = -1
    locked_block: Block | None = None
    locked_block_parts: PartSet | None = None
    valid_round: int = -1
    valid_block: Block | None = None
    valid_block_parts: PartSet | None = None
    votes: HeightVoteSet | None = None
    commit_round: int = -1
    last_commit: VoteSet | None = None
    last_validators: ValidatorSet | None = None
    triggered_timeout_precommit: bool = False

    def step_name(self) -> str:
        return STEP_NAMES.get(self.step, f"Unknown({self.step})")

    def proposal_block_id(self) -> BlockID | None:
        if self.proposal_block is None or self.proposal_block_parts is None:
            return None
        return BlockID(hash=self.proposal_block.hash(), part_set_header=self.proposal_block_parts.header)
