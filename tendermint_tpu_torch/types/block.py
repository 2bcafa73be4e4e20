"""PartSetHeader, BlockID, CommitSig and Commit (ref: types/block.go),
the part of the block types commit verification needs."""

from __future__ import annotations

from dataclasses import dataclass, field

from ..crypto.merkle import hash_from_byte_slices
from ..proto import messages as pb
from ..utils.tmtime import Time
from .canonical import vote_sign_bytes_template

HASH_SIZE = 32
ADDRESS_SIZE = 20

BLOCK_ID_FLAG_ABSENT = pb.BLOCK_ID_FLAG_ABSENT
BLOCK_ID_FLAG_COMMIT = pb.BLOCK_ID_FLAG_COMMIT
BLOCK_ID_FLAG_NIL = pb.BLOCK_ID_FLAG_NIL


@dataclass(frozen=True)
class PartSetHeader:
    total: int = 0
    hash: bytes = b""

    def to_proto(self) -> pb.PartSetHeader:
        return pb.PartSetHeader(total=self.total, hash=self.hash)

    def __str__(self):
        return f"{self.total}:{self.hash.hex().upper()[:12]}"


@dataclass(frozen=True)
class BlockID:
    hash: bytes = b""
    part_set_header: PartSetHeader = field(default_factory=PartSetHeader)

    def to_proto(self) -> pb.BlockID:
        return pb.BlockID(hash=self.hash, part_set_header=self.part_set_header.to_proto())

    def __str__(self):
        return f"{self.hash.hex().upper()[:12]}:{self.part_set_header}"


@dataclass
class CommitSig:
    """One validator's slot in a commit (ref: types/block.go:590)."""

    block_id_flag: int = BLOCK_ID_FLAG_ABSENT
    validator_address: bytes = b""
    timestamp: Time = field(default_factory=Time)
    signature: bytes = b""

    @classmethod
    def new_absent(cls) -> "CommitSig":
        return cls()

    @classmethod
    def new_commit(cls, validator_address: bytes, timestamp: Time, signature: bytes) -> "CommitSig":
        return cls(BLOCK_ID_FLAG_COMMIT, validator_address, timestamp, signature)

    def block_id(self, commit_block_id: BlockID) -> BlockID:
        """ref: CommitSig.BlockID (types/block.go:641)."""
        if self.block_id_flag == BLOCK_ID_FLAG_COMMIT:
            return commit_block_id
        if self.block_id_flag in (BLOCK_ID_FLAG_ABSENT, BLOCK_ID_FLAG_NIL):
            return BlockID()
        raise ValueError(f"unknown BlockIDFlag: {self.block_id_flag}")

    def to_proto(self) -> pb.CommitSig:
        return pb.CommitSig(
            block_id_flag=self.block_id_flag,
            validator_address=self.validator_address,
            timestamp=pb.Timestamp(seconds=self.timestamp.seconds, nanos=self.timestamp.nanos),
            signature=self.signature,
        )


@dataclass
class Commit:
    """ref: types/block.go:786 Commit."""

    height: int = 0
    round: int = 0
    block_id: BlockID = field(default_factory=BlockID)
    signatures: list[CommitSig] = field(default_factory=list)
    # ((chain_id, height, round, block_id), make_commit, make_nil): the
    # sign-bytes templates; everything but the timestamp is
    # commit-invariant, and the key re-checks every baked-in input
    _sb_tmpl: tuple | None = field(default=None, compare=False, repr=False)

    def get_vote(self, val_idx: int) -> pb.Vote:
        """The proto Vote a commit sig corresponds to (ref: Commit.GetVote,
        types/block.go:836)."""
        cs = self.signatures[val_idx]
        bid = cs.block_id(self.block_id)
        return pb.Vote(
            type=pb.SIGNED_MSG_TYPE_PRECOMMIT,
            height=self.height,
            round=self.round,
            block_id=bid.to_proto(),
            timestamp=pb.Timestamp(seconds=cs.timestamp.seconds, nanos=cs.timestamp.nanos),
            validator_address=cs.validator_address,
            validator_index=val_idx,
            signature=cs.signature,
        )

    def vote_sign_bytes(self, chain_id: str, val_idx: int) -> bytes:
        """The canonical signed message of validator slot val_idx
        (ref: Commit.VoteSignBytes, types/block.go:859), from a per-commit
        template (only the timestamp varies per validator)."""
        cs = self.signatures[val_idx]
        tmpl_key = (chain_id, self.height, self.round, self.block_id)
        if self._sb_tmpl is None or self._sb_tmpl[0] != tmpl_key:
            self._sb_tmpl = (
                tmpl_key,
                vote_sign_bytes_template(
                    chain_id, pb.SIGNED_MSG_TYPE_PRECOMMIT,
                    self.height, self.round, self.block_id.to_proto(),
                ),
                vote_sign_bytes_template(
                    chain_id, pb.SIGNED_MSG_TYPE_PRECOMMIT,
                    self.height, self.round, BlockID().to_proto(),
                ),
            )
        if cs.block_id_flag == BLOCK_ID_FLAG_COMMIT:
            make = self._sb_tmpl[1]
        elif cs.block_id_flag in (BLOCK_ID_FLAG_ABSENT, BLOCK_ID_FLAG_NIL):
            make = self._sb_tmpl[2]
        else:
            # the flag byte is outside the signature: same guard as
            # CommitSig.block_id
            raise ValueError(f"unknown BlockIDFlag: {cs.block_id_flag}")
        return make(cs.timestamp.seconds, cs.timestamp.nanos)

    def hash(self) -> bytes:
        """Merkle root of the CommitSig encodings (ref: types/block.go:900)."""
        return hash_from_byte_slices([cs.to_proto().encode() for cs in self.signatures])
