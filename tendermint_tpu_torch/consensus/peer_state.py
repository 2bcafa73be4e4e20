"""Per-peer consensus view (ref: internal/consensus/peer_state.go), a copy
of the JAX package's consensus/peer_state.py.

Tracks what each peer claims to have — round/step, proposal, block
parts, vote bit-arrays — so the gossip routines send only what the peer
is missing. All methods take the internal lock; callers are the reactor
receive loop and the per-peer gossip threads.
"""

from __future__ import annotations

import threading

from ..types.vote import PRECOMMIT, PREVOTE
from ..utils.bits import BitArray
from ..utils.tmtime import Time
from .round_state import STEP_NEW_HEIGHT


class PeerRoundState:
    """ref: internal/consensus/types/peer_round_state.go."""

    def __init__(self):
        self.height = 0
        self.round = -1
        self.step = STEP_NEW_HEIGHT
        self.start_time = Time()
        self.proposal = False
        self.proposal_block_parts_header = None  # PartSetHeader
        self.proposal_block_parts: BitArray | None = None
        self.proposal_pol_round = -1
        self.proposal_pol: BitArray | None = None
        self.prevotes: BitArray | None = None
        self.precommits: BitArray | None = None
        self.last_commit_round = -1
        self.last_commit: BitArray | None = None
        self.catchup_commit_round = -1
        self.catchup_commit: BitArray | None = None


class PeerState:
    """ref: peer_state.go:28 PeerState."""

    def __init__(self, peer_id: str):
        self.peer_id = peer_id
        self.prs = PeerRoundState()
        self._lock = threading.RLock()
        self.running = True

    # ---------------------------------------------------------- applies

    def apply_new_round_step(self, msg) -> None:
        """ref: peer_state.go:317 ApplyNewRoundStepMessage."""
        with self._lock:
            prs = self.prs
            if msg.height < prs.height or (msg.height == prs.height and msg.round < prs.round):
                return
            ph, pr = prs.height, prs.round
            ps_precommits = prs.precommits  # snapshot before the clear
            prs.height = msg.height
            prs.round = msg.round
            prs.step = msg.step
            if ph != msg.height or pr != msg.round:
                prs.proposal = False
                prs.proposal_block_parts_header = None
                prs.proposal_block_parts = None
                prs.proposal_pol_round = -1
                prs.proposal_pol = None
                prs.prevotes = None
                prs.precommits = None
            if ph == msg.height and pr != msg.round and msg.round == prs.catchup_commit_round:
                prs.precommits = prs.catchup_commit
            if ph != msg.height:
                if ph + 1 == msg.height and pr == msg.last_commit_round:
                    prs.last_commit_round = msg.last_commit_round
                    prs.last_commit = ps_precommits
                else:
                    prs.last_commit_round = msg.last_commit_round
                    prs.last_commit = None
                prs.catchup_commit_round = -1
                prs.catchup_commit = None

    def apply_new_valid_block(self, msg) -> None:
        """ref: peer_state.go:365 ApplyNewValidBlockMessage."""
        with self._lock:
            prs = self.prs
            if prs.height != msg.height:
                return
            if prs.round != msg.round and not msg.is_commit:
                return
            prs.proposal_block_parts_header = msg.block_part_set_header
            prs.proposal_block_parts = msg.block_parts

    def apply_proposal_pol(self, msg) -> None:
        """ref: peer_state.go:382 ApplyProposalPOLMessage."""
        with self._lock:
            prs = self.prs
            if prs.height != msg.height or prs.proposal_pol_round != msg.proposal_pol_round:
                return
            prs.proposal_pol = msg.proposal_pol

    def apply_has_vote(self, msg) -> None:
        """ref: peer_state.go:399 ApplyHasVoteMessage."""
        with self._lock:
            if self.prs.height != msg.height:
                return
            self._set_has_vote(msg.height, msg.round, msg.type, msg.index)

    def apply_vote_set_bits(self, msg, our_votes: BitArray | None) -> None:
        """ref: peer_state.go:410 ApplyVoteSetBitsMessage — union with
        what we know they know when block IDs match."""
        with self._lock:
            votes = self._get_vote_bit_array(msg.height, msg.round, msg.type)
            if votes is not None and msg.votes is not None:
                if our_votes is None:
                    votes.update(msg.votes)
                else:
                    # (what we know they have, minus our-block bits) ∪
                    # their claimed bits (peer_state.go:410)
                    other_votes = votes.sub(our_votes)
                    votes.update(other_votes.or_(msg.votes))

    # ---------------------------------------------------------- proposals

    def set_has_proposal(self, proposal) -> None:
        """ref: peer_state.go:116 SetHasProposal."""
        with self._lock:
            prs = self.prs
            if prs.height != proposal.height or prs.round != proposal.round:
                return
            if prs.proposal:
                return
            prs.proposal = True
            if prs.proposal_block_parts is not None:
                return  # NewValidBlock already set them
            prs.proposal_block_parts_header = proposal.block_id.part_set_header
            prs.proposal_block_parts = BitArray(proposal.block_id.part_set_header.total)
            prs.proposal_pol_round = proposal.pol_round
            prs.proposal_pol = None

    def init_proposal_block_parts(self, header) -> None:
        """ref: peer_state.go:134 InitProposalBlockParts."""
        with self._lock:
            if self.prs.proposal_block_parts is not None:
                return
            self.prs.proposal_block_parts_header = header
            self.prs.proposal_block_parts = BitArray(header.total)

    def set_has_proposal_block_part(self, height: int, round_: int, index: int) -> None:
        """ref: peer_state.go:146 SetHasProposalBlockPart."""
        with self._lock:
            prs = self.prs
            if prs.height != height or prs.round != round_:
                return
            if prs.proposal_block_parts is None:
                return
            prs.proposal_block_parts.set_index(index, True)

    # -------------------------------------------------------------- votes

    def set_has_vote(self, vote) -> None:
        with self._lock:
            self._set_has_vote(vote.height, vote.round, vote.type, vote.validator_index)

    def _set_has_vote(self, height: int, round_: int, vote_type: int, index: int) -> None:
        """ref: peer_state.go:286 setHasVote."""
        ba = self._get_vote_bit_array(height, round_, vote_type)
        if ba is not None:
            ba.set_index(index, True)

    def _get_vote_bit_array(self, height: int, round_: int, vote_type: int) -> BitArray | None:
        """ref: peer_state.go:218 getVoteBitArray."""
        prs = self.prs
        if prs.height == height:
            if prs.round == round_:
                return prs.prevotes if vote_type == PREVOTE else prs.precommits
            if prs.catchup_commit_round == round_ and vote_type == PRECOMMIT:
                return prs.catchup_commit
            if prs.proposal_pol_round == round_ and vote_type == PREVOTE:
                return prs.proposal_pol
            return None
        if prs.height == height + 1:
            if prs.last_commit_round == round_ and vote_type == PRECOMMIT:
                return prs.last_commit
            return None
        return None

    def ensure_vote_bit_arrays(self, height: int, num_validators: int) -> None:
        """ref: peer_state.go:254 EnsureVoteBitArrays."""
        with self._lock:
            prs = self.prs
            if prs.height == height:
                if prs.prevotes is None:
                    prs.prevotes = BitArray(num_validators)
                if prs.precommits is None:
                    prs.precommits = BitArray(num_validators)
                if prs.catchup_commit is None:
                    prs.catchup_commit = BitArray(num_validators)
                if prs.proposal_pol is None:
                    prs.proposal_pol = BitArray(num_validators)
            elif prs.height == height + 1:
                if prs.last_commit is None:
                    prs.last_commit = BitArray(num_validators)

    def ensure_catchup_commit_round(self, height: int, round_: int, num_validators: int) -> None:
        """ref: peer_state.go:230 EnsureCatchupCommitRound."""
        with self._lock:
            prs = self.prs
            if prs.height != height:
                return
            if prs.catchup_commit_round == round_:
                return
            prs.catchup_commit_round = round_
            prs.catchup_commit = BitArray(num_validators)

    def pick_vote_to_send(self, votes) -> object | None:
        """Pick a vote from `votes` (a VoteSet-like) the peer doesn't
        have (ref: peer_state.go:166 PickVoteToSend)."""
        with self._lock:
            if votes is None or votes.size() == 0:
                return None
            height = votes.height
            round_ = votes.round
            vote_type = votes.signed_msg_type
            ba = self._get_vote_bit_array(height, round_, vote_type)
            if ba is None:
                return None
            missing = votes.bit_array().sub(ba)
            idx, ok = missing.pick_random()
            if not ok:
                return None
            return votes.get_by_index(idx)
