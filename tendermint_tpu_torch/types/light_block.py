"""SignedHeader and LightBlock (ref: types/light.go)."""

from __future__ import annotations

from dataclasses import dataclass

from ..proto import messages as pb
from .block import Commit, Header
from .validator_set import ValidatorSet


@dataclass
class SignedHeader:
    header: Header
    commit: Commit

    def validate_basic(self, chain_id: str) -> None:
        """ref: SignedHeader.ValidateBasic (types/light.go:161)."""
        if self.header is None:
            raise ValueError("missing header")
        if self.commit is None:
            raise ValueError("missing commit")
        self.header.validate_basic()
        self.commit.validate_basic()
        if self.header.chain_id != chain_id:
            raise ValueError(f"header belongs to another chain {self.header.chain_id!r}, not {chain_id!r}")
        if self.commit.height != self.header.height:
            raise ValueError(f"header and commit height mismatch: {self.header.height} vs {self.commit.height}")
        hhash = self.header.hash() or b""
        chash = self.commit.block_id.hash
        if hhash != chash:
            raise ValueError(f"commit signs block {chash.hex()}, header is block {hhash.hex()}")

    @property
    def height(self) -> int:
        return self.header.height

    def hash(self) -> bytes | None:
        return self.header.hash()

    def to_proto(self) -> pb.SignedHeader:
        return pb.SignedHeader(header=self.header.to_proto(), commit=self.commit.to_proto())

    @classmethod
    def from_proto(cls, p: pb.SignedHeader) -> "SignedHeader":
        return cls(header=Header.from_proto(p.header), commit=Commit.from_proto(p.commit))


@dataclass
class LightBlock:
    """SignedHeader + the validator set that signed it (ref: types/light.go:14)."""

    signed_header: SignedHeader
    validator_set: ValidatorSet

    @property
    def height(self) -> int:
        return self.signed_header.header.height

    def validate_basic(self, chain_id: str) -> None:
        """ref: LightBlock.ValidateBasic (types/light.go:55)."""
        if self.signed_header is None:
            raise ValueError("missing signed header")
        if self.validator_set is None:
            raise ValueError("missing validator set")
        self.signed_header.validate_basic(chain_id)
        self.validator_set.validate_basic()
        if self.signed_header.header.validators_hash != self.validator_set.hash():
            raise ValueError(
                f"expected validator hash of header to match validator set hash "
                f"({self.signed_header.header.validators_hash.hex()} != {self.validator_set.hash().hex()})"
            )

    def to_proto(self) -> pb.LightBlock:
        return pb.LightBlock(signed_header=self.signed_header.to_proto(), validator_set=self.validator_set.to_proto())

    @classmethod
    def from_proto(cls, p: pb.LightBlock) -> "LightBlock":
        return cls(
            signed_header=SignedHeader.from_proto(p.signed_header),
            validator_set=ValidatorSet.from_proto(p.validator_set),
        )
