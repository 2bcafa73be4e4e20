"""Vote domain type (ref: types/vote.go), over the port's canonical sign
bytes (types/canonical.py). Evidence carries two of these."""

from __future__ import annotations

from dataclasses import dataclass, field

from ..crypto import PubKey
from ..proto import messages as pb
from ..utils.tmtime import Time
from .block import ADDRESS_SIZE, BLOCK_ID_FLAG_ABSENT, BLOCK_ID_FLAG_COMMIT, BLOCK_ID_FLAG_NIL, BlockID, CommitSig
from .canonical import vote_extension_sign_bytes, vote_sign_bytes

PREVOTE = pb.SIGNED_MSG_TYPE_PREVOTE
PRECOMMIT = pb.SIGNED_MSG_TYPE_PRECOMMIT

MAX_SIGNATURE_SIZE = 64


def is_vote_type_valid(t: int) -> bool:
    return t in (PREVOTE, PRECOMMIT)


def _time(t: pb.Timestamp | None) -> Time:
    t = t or pb.Timestamp()
    return Time(t.seconds or 0, t.nanos or 0) if (t.seconds or t.nanos) else Time()


@dataclass
class Vote:
    type: int = 0
    height: int = 0
    round: int = 0
    block_id: BlockID = field(default_factory=BlockID)
    timestamp: Time = field(default_factory=Time)
    validator_address: bytes = b""
    validator_index: int = 0
    signature: bytes = b""
    extension: bytes = b""
    extension_signature: bytes = b""

    def is_nil(self) -> bool:
        """A vote for nil has an empty BlockID."""
        return self.block_id.is_nil()

    def sign_bytes(self, chain_id: str) -> bytes:
        """ref: Vote.SignBytes -> VoteSignBytes (types/vote.go:149)."""
        return vote_sign_bytes(chain_id, self.to_proto())

    def extension_sign_bytes(self, chain_id: str) -> bytes:
        """ref: VoteExtensionSignBytes (types/vote.go:167)."""
        return vote_extension_sign_bytes(chain_id, self.to_proto())

    def verify(self, chain_id: str, pub_key: PubKey) -> None:
        """Verify the vote signature (ref: Vote.Verify, types/vote.go:316)."""
        if pub_key.address() != self.validator_address:
            raise ValueError("invalid validator address")
        if not pub_key.verify_signature(self.sign_bytes(chain_id), self.signature):
            raise ValueError("invalid signature")

    def verify_with_extension(self, chain_id: str, pub_key: PubKey) -> None:
        """ref: VerifyWithExtension (types/vote.go:330)."""
        self.verify(chain_id, pub_key)
        if self.type == PRECOMMIT and not self.block_id.is_nil():
            if not pub_key.verify_signature(self.extension_sign_bytes(chain_id), self.extension_signature):
                raise ValueError("invalid extension signature")

    def validate_basic(self) -> None:
        """ref: Vote.ValidateBasic (types/vote.go:356)."""
        if not is_vote_type_valid(self.type):
            raise ValueError("invalid Type")
        if self.height < 0:
            raise ValueError("negative Height")
        if self.round < 0:
            raise ValueError("negative Round")
        self.block_id.validate_basic()
        if not self.block_id.is_nil() and not self.block_id.is_complete():
            raise ValueError(f"blockID must be either empty or complete, got: {self.block_id}")
        if len(self.validator_address) != ADDRESS_SIZE:
            raise ValueError(f"expected ValidatorAddress size to be {ADDRESS_SIZE} bytes")
        if self.validator_index < 0:
            raise ValueError("negative ValidatorIndex")
        if not self.signature:
            raise ValueError("signature is missing")
        if len(self.signature) > MAX_SIGNATURE_SIZE:
            raise ValueError(f"signature is too big (max: {MAX_SIGNATURE_SIZE})")
        # extensions only on non-nil precommits (ref: vote.go:323-342)
        if self.type != PRECOMMIT or self.block_id.is_nil():
            if self.extension:
                raise ValueError("unexpected vote extension")
            if self.extension_signature:
                raise ValueError("unexpected vote extension signature")
        else:
            if len(self.extension_signature) > MAX_SIGNATURE_SIZE:
                raise ValueError(f"vote extension signature is too big (max: {MAX_SIGNATURE_SIZE})")
            if self.extension and not self.extension_signature:
                raise ValueError("vote extension signature absent on vote with extension")

    def to_commit_sig(self) -> CommitSig:
        """ref: Vote.CommitSig (types/vote.go:264)."""
        return CommitSig(
            block_id_flag=BLOCK_ID_FLAG_NIL if self.block_id.is_nil() else BLOCK_ID_FLAG_COMMIT,
            validator_address=self.validator_address,
            timestamp=self.timestamp,
            signature=self.signature,
        )

    def to_proto(self) -> pb.Vote:
        return pb.Vote(
            type=self.type,
            height=self.height,
            round=self.round,
            block_id=self.block_id.to_proto(),
            timestamp=pb.Timestamp(seconds=self.timestamp.seconds, nanos=self.timestamp.nanos),
            validator_address=self.validator_address,
            validator_index=self.validator_index,
            signature=self.signature,
            extension=self.extension,
            extension_signature=self.extension_signature,
        )

    @classmethod
    def from_proto(cls, p: pb.Vote) -> "Vote":
        return cls(
            type=p.type or 0,
            height=p.height or 0,
            round=p.round or 0,
            block_id=BlockID.from_proto(p.block_id),
            timestamp=_time(p.timestamp),
            validator_address=p.validator_address or b"",
            validator_index=p.validator_index or 0,
            signature=p.signature or b"",
            extension=p.extension or b"",
            extension_signature=p.extension_signature or b"",
        )


def votes_from_extended_commit(ec: pb.ExtendedCommit) -> list[Vote | None]:
    """The precommits an ExtendedCommit encodes (ref:
    ExtendedCommit.ToExtendedVoteSet); absent slots become None."""
    commit_bid = BlockID.from_proto(ec.block_id)
    votes: list[Vote | None] = []
    for idx, sig in enumerate(ec.extended_signatures or []):
        flag = sig.block_id_flag or BLOCK_ID_FLAG_ABSENT
        if flag == BLOCK_ID_FLAG_ABSENT:
            votes.append(None)
            continue
        t = sig.timestamp or pb.Timestamp()
        votes.append(Vote(
            type=PRECOMMIT,
            height=ec.height or 0,
            round=ec.round or 0,
            block_id=commit_bid if flag == BLOCK_ID_FLAG_COMMIT else BlockID(),
            timestamp=Time(t.seconds or 0, t.nanos or 0),
            validator_address=sig.validator_address or b"",
            validator_index=idx,
            signature=sig.signature or b"",
            extension=sig.extension or b"",
            extension_signature=sig.extension_signature or b"",
        ))
    return votes
