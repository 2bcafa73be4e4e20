"""Proposal — a proposed block at (height, round) with a POL round
(ref: types/proposal.go)."""

from __future__ import annotations

from dataclasses import dataclass, field

from ..proto import messages as pb
from ..utils.tmtime import Time
from .block import BlockID
from .canonical import proposal_sign_bytes

PROPOSAL_TYPE = 32  # tmproto.ProposalType (SignedMsgType)


@dataclass
class Proposal:
    """ref: types.Proposal (types/proposal.go:18)."""

    height: int = 0
    round: int = 0
    pol_round: int = -1
    block_id: BlockID = field(default_factory=BlockID)
    timestamp: Time = field(default_factory=Time)
    signature: bytes = b""

    def sign_bytes(self, chain_id: str) -> bytes:
        """ref: types.ProposalSignBytes (types/proposal.go:92)."""
        return proposal_sign_bytes(chain_id, self.to_proto())

    def validate_basic(self) -> None:
        """ref: Proposal.ValidateBasic (types/proposal.go:47)."""
        if self.height < 0:
            raise ValueError("negative Height")
        if self.round < 0:
            raise ValueError("negative Round")
        if self.pol_round < -1:
            raise ValueError("negative POLRound (exception: -1)")
        self.block_id.validate_basic()
        if not self.block_id.is_complete():
            raise ValueError(f"expected a complete, non-empty BlockID, got: {self.block_id}")
        if not self.signature:
            raise ValueError("signature is missing")
        if len(self.signature) > 64:
            raise ValueError("signature is too big")

    def is_timely(self, recv_time: Time, precision_ns: int, message_delay_ns: int, round_: int) -> bool:
        """Proposer-based timestamp check (ref: Proposal.IsTimely,
        types/proposal.go:73): accept iff
        proposal.time - precision <= recv_time <= proposal.time + delay + precision,
        with message_delay growing 10% per round to adapt to degraded nets."""
        for _ in range(round_):
            message_delay_ns = message_delay_ns * 11 // 10
        lhs = self.timestamp.unix_ns() - precision_ns
        rhs = self.timestamp.unix_ns() + message_delay_ns + precision_ns
        return lhs <= recv_time.unix_ns() <= rhs

    def to_proto(self) -> pb.Proposal:
        return pb.Proposal(
            type=PROPOSAL_TYPE,
            height=self.height,
            round=self.round,
            pol_round=self.pol_round,
            block_id=self.block_id.to_proto(),
            timestamp=pb.Timestamp(seconds=self.timestamp.seconds, nanos=self.timestamp.nanos),
            signature=self.signature,
        )

    @classmethod
    def from_proto(cls, p: pb.Proposal) -> "Proposal":
        t = p.timestamp or pb.Timestamp()
        return cls(
            height=p.height or 0,
            round=p.round or 0,
            pol_round=p.pol_round if p.pol_round is not None else -1,
            block_id=BlockID.from_proto(p.block_id),
            timestamp=Time(t.seconds or 0, t.nanos or 0) if (t.seconds or t.nanos) else Time(),
            signature=p.signature or b"",
        )
