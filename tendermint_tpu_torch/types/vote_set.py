"""VoteSet — per-(height, round, type) vote tally (ref: types/vote_set.go).

Tracks the canonical vote per validator plus per-block tallies so that
conflicting votes (double-signs) are detected and bounded: a conflicting
vote is only tracked if some peer claimed a 2/3 majority for that block
(vote_set.go:22-55 commentary)."""

from __future__ import annotations

from ..utils.bits import BitArray
from .block import BLOCK_ID_FLAG_COMMIT, BlockID, Commit, CommitSig
from .validator_set import MAX_VOTES_COUNT, ValidatorSet  # noqa: F401 (re-export)
from .vote import PRECOMMIT, Vote


class ConflictingVoteError(Exception):
    """ref: NewConflictingVoteError — carries both votes for evidence."""

    def __init__(self, conflicting: Vote, new: Vote):
        self.vote_a = conflicting
        self.vote_b = new
        super().__init__(f"conflicting votes from validator {new.validator_address.hex().upper()}")


class _BlockVotes:
    """Votes for one block key (ref: blockVotes, vote_set.go:678)."""

    def __init__(self, peer_maj23: bool, num_validators: int):
        self.peer_maj23 = peer_maj23
        self.bit_array = BitArray(num_validators)
        self.votes: list[Vote | None] = [None] * num_validators
        self.sum = 0

    def add_verified_vote(self, vote: Vote, voting_power: int) -> None:
        idx = vote.validator_index
        if self.votes[idx] is None:
            self.bit_array.set_index(idx, True)
            self.votes[idx] = vote
            self.sum += voting_power

    def get_by_index(self, index: int) -> Vote | None:
        return self.votes[index]


class VoteSet:
    def __init__(self, chain_id: str, height: int, round_: int, signed_msg_type: int, val_set: ValidatorSet):
        if height == 0:
            raise ValueError("cannot make VoteSet for height == 0")
        self.chain_id = chain_id
        self.height = height
        self.round = round_
        self.signed_msg_type = signed_msg_type
        self.val_set = val_set
        self.extensions_enabled = False
        self.votes_bit_array = BitArray(val_set.size())
        self.votes: list[Vote | None] = [None] * val_set.size()
        self.sum = 0
        self.maj23: BlockID | None = None
        self.votes_by_block: dict[bytes, _BlockVotes] = {}
        self.peer_maj23s: dict[str, BlockID] = {}

    @classmethod
    def extended(cls, chain_id: str, height: int, round_: int, signed_msg_type: int, val_set: ValidatorSet) -> "VoteSet":
        """Vote set that also verifies vote extensions (ref: NewExtendedVoteSet)."""
        vs = cls(chain_id, height, round_, signed_msg_type, val_set)
        vs.extensions_enabled = True
        return vs

    def size(self) -> int:
        return self.val_set.size()

    # -- adding votes ------------------------------------------------------

    def add_vote(self, vote: Vote | None) -> bool:
        """Returns True if added. Raises ConflictingVoteError on a
        double-sign, ValueError on any other rejection
        (ref: VoteSet.addVote, vote_set.go:161)."""
        if vote is None:
            raise ValueError("nil vote")
        val_index = vote.validator_index
        val_addr = vote.validator_address
        block_key = vote.block_id.key()

        if val_index < 0:
            raise ValueError("index < 0: invalid validator index")
        if not val_addr:
            raise ValueError("empty address: invalid validator address")
        if vote.height != self.height or vote.round != self.round or vote.type != self.signed_msg_type:
            raise ValueError(
                f"expected {self.height}/{self.round}/{self.signed_msg_type}, "
                f"got {vote.height}/{vote.round}/{vote.type}: unexpected step"
            )
        lookup_addr, val = self.val_set.get_by_index(val_index)
        if val is None:
            raise ValueError(f"cannot find validator {val_index} in valSet of size {self.val_set.size()}")
        if val_addr != lookup_addr:
            raise ValueError(
                f"vote.validator_address ({val_addr.hex()}) does not match address "
                f"({lookup_addr.hex()}) for index {val_index}"
            )
        existing = self._get_vote(val_index, block_key)
        if existing is not None:
            if existing.signature == vote.signature:
                return False  # duplicate
            raise ValueError("non-deterministic signature from validator")

        if self.extensions_enabled:
            vote.verify_with_extension(self.chain_id, val.pub_key)
        else:
            vote.verify(self.chain_id, val.pub_key)
            if vote.extension or vote.extension_signature:
                raise ValueError("unexpected vote extension data present in vote")

        added, conflicting = self._add_verified_vote(vote, block_key, val.voting_power)
        if conflicting is not None:
            raise ConflictingVoteError(conflicting, vote)
        if not added:
            raise RuntimeError("expected to add non-conflicting vote")
        return added

    def _get_vote(self, val_index: int, block_key: bytes) -> Vote | None:
        existing = self.votes[val_index]
        if existing is not None and existing.block_id.key() == block_key:
            return existing
        bv = self.votes_by_block.get(block_key)
        if bv is not None:
            return bv.get_by_index(val_index)
        return None

    def _add_verified_vote(self, vote: Vote, block_key: bytes, voting_power: int) -> tuple[bool, Vote | None]:
        """ref: addVerifiedVote (vote_set.go:247)."""
        val_index = vote.validator_index
        conflicting = None
        existing = self.votes[val_index]
        if existing is not None:
            if existing.block_id == vote.block_id:
                raise RuntimeError("addVerifiedVote does not expect duplicate votes")
            conflicting = existing
            if self.maj23 is not None and self.maj23.key() == block_key:
                self.votes[val_index] = vote
                self.votes_bit_array.set_index(val_index, True)
        else:
            self.votes[val_index] = vote
            self.votes_bit_array.set_index(val_index, True)
            self.sum += voting_power

        votes_by_block = self.votes_by_block.get(block_key)
        if votes_by_block is not None:
            if conflicting is not None and not votes_by_block.peer_maj23:
                return False, conflicting
        else:
            if conflicting is not None:
                return False, conflicting
            votes_by_block = _BlockVotes(False, self.val_set.size())
            self.votes_by_block[block_key] = votes_by_block

        orig_sum = votes_by_block.sum
        quorum = self.val_set.total_voting_power() * 2 // 3 + 1
        votes_by_block.add_verified_vote(vote, voting_power)
        if orig_sum < quorum <= votes_by_block.sum:
            if self.maj23 is None:
                self.maj23 = vote.block_id
                for i, v in enumerate(votes_by_block.votes):
                    if v is not None:
                        self.votes[i] = v
        return True, conflicting

    def set_peer_maj23(self, peer_id: str, block_id: BlockID) -> None:
        """ref: SetPeerMaj23 (vote_set.go:325)."""
        block_key = block_id.key()
        existing = self.peer_maj23s.get(peer_id)
        if existing is not None:
            if existing == block_id:
                return
            raise ValueError(f"setPeerMaj23: conflicting blockID from peer {peer_id}")
        self.peer_maj23s[peer_id] = block_id
        votes_by_block = self.votes_by_block.get(block_key)
        if votes_by_block is not None:
            votes_by_block.peer_maj23 = True
        else:
            self.votes_by_block[block_key] = _BlockVotes(True, self.val_set.size())

    # -- queries -----------------------------------------------------------

    def bit_array(self) -> BitArray:
        return self.votes_bit_array.copy()

    def bit_array_by_block_id(self, block_id: BlockID) -> BitArray | None:
        bv = self.votes_by_block.get(block_id.key())
        if bv is not None:
            return bv.bit_array.copy()
        return None

    def get_by_index(self, val_index: int) -> Vote | None:
        if val_index < 0 or val_index >= len(self.votes):
            return None
        return self.votes[val_index]

    def get_by_address(self, address: bytes) -> Vote | None:
        val_index, val = self.val_set.get_by_address(address)
        if val is None:
            raise ValueError("GetByAddress(address) returned nil")
        return self.votes[val_index]

    def list(self) -> list[Vote]:
        return [v for v in self.votes if v is not None]

    def has_two_thirds_majority(self) -> bool:
        return self.maj23 is not None

    def is_commit(self) -> bool:
        return self.signed_msg_type == PRECOMMIT and self.maj23 is not None

    def has_two_thirds_any(self) -> bool:
        return self.sum > self.val_set.total_voting_power() * 2 // 3

    def has_all(self) -> bool:
        return self.sum == self.val_set.total_voting_power()

    def two_thirds_majority(self) -> tuple[BlockID, bool]:
        if self.maj23 is not None:
            return self.maj23, True
        return BlockID(), False

    # -- commit construction ----------------------------------------------

    def make_commit(self) -> Commit:
        """Build a Commit from 2/3-majority precommits (ref:
        MakeExtendedCommit, vote_set.go:629 — extension-free variant)."""
        if self.signed_msg_type != PRECOMMIT:
            raise ValueError("cannot make_commit() unless VoteSet.Type is Precommit")
        if self.maj23 is None:
            raise ValueError("cannot make_commit() unless a blockhash has +2/3")
        sigs = []
        for v in self.votes:
            if v is None:
                sigs.append(CommitSig.new_absent())
                continue
            sig = v.to_commit_sig()
            if sig.block_id_flag == BLOCK_ID_FLAG_COMMIT and v.block_id != self.maj23:
                sig = CommitSig.new_absent()
            sigs.append(sig)
        return Commit(height=self.height, round=self.round, block_id=self.maj23, signatures=sigs)

    def make_extended_commit(self):
        """Build the ExtendedCommit proto from 2/3-majority precommits
        (ref: MakeExtendedCommit, vote_set.go:629-648). Like make_commit,
        the commit block_id is the +2/3 maj23 block — NOT whatever the
        first non-nil vote says — and a COMMIT vote for any other block
        (a conflicting/Byzantine precommit) is demoted to absent, so
        every persisted signature re-verifies against the commit's
        block_id on reload and catch-up gossip."""
        from ..proto import messages as pb
        from .block import BLOCK_ID_FLAG_ABSENT, BLOCK_ID_FLAG_NIL

        if self.signed_msg_type != PRECOMMIT:
            raise ValueError("cannot make_extended_commit() unless VoteSet.Type is Precommit")
        if self.maj23 is None:
            raise ValueError("cannot make_extended_commit() unless a blockhash has +2/3")
        absent = pb.ExtendedCommitSig(block_id_flag=BLOCK_ID_FLAG_ABSENT, timestamp=pb.Timestamp())
        sigs = []
        for v in self.votes:
            if v is None:
                sigs.append(absent)
                continue
            if v.block_id.is_nil():
                flag = BLOCK_ID_FLAG_NIL
            elif v.block_id == self.maj23:
                flag = BLOCK_ID_FLAG_COMMIT
            else:
                sigs.append(absent)
                continue
            sigs.append(pb.ExtendedCommitSig(
                block_id_flag=flag,
                validator_address=v.validator_address,
                timestamp=pb.Timestamp(seconds=v.timestamp.seconds, nanos=v.timestamp.nanos),
                signature=v.signature,
                # Extensions exist only on non-nil precommits; never copy
                # extension bytes onto a NIL signature (they are outside
                # the vote's sign bytes, so nothing vouches for them).
                extension=v.extension if flag == BLOCK_ID_FLAG_COMMIT else b"",
                extension_signature=(
                    v.extension_signature if flag == BLOCK_ID_FLAG_COMMIT else b""
                ),
            ))
        return pb.ExtendedCommit(
            height=self.height,
            round=self.round,
            block_id=self.maj23.to_proto(),
            extended_signatures=sigs,
        )
