"""Consensus wire messages (ref: internal/consensus/msgs.go — the 9
message kinds gossiped on the consensus channels)."""

from __future__ import annotations

from dataclasses import dataclass, field

from ..types.block import BlockID
from ..types.part_set import Part
from ..types.proposal import Proposal
from ..types.vote import Vote
from ..utils.bits import BitArray


@dataclass
class NewRoundStepMessage:
    """Channel 0x20 (ref: NewRoundStepMessage, reactor state gossip)."""

    height: int
    round: int
    step: int
    seconds_since_start_time: int = 0
    last_commit_round: int = 0


@dataclass
class NewValidBlockMessage:
    height: int
    round: int
    block_part_set_header: object = None
    block_parts: BitArray | None = None
    is_commit: bool = False


@dataclass
class ProposalMessage:
    proposal: Proposal
    # origin wall-clock (unix ns) stamped by the sending reactor's
    # encoder; 0 = unstamped (locally constructed / WAL replay). The
    # receive side turns now - origin_ns into the
    # consensus_msg_propagation_seconds histogram (shared-clock
    # testnets; docs/observability.md#flight).
    origin_ns: int = 0
    # the stamping node's p2p id ("" = unstamped) — the originator half
    # of the deterministic block-journey key (trace.journey_key) that
    # binds this frame's send/receive spans across node processes.
    origin_node: str = ""


@dataclass
class ProposalPOLMessage:
    height: int
    proposal_pol_round: int
    proposal_pol: BitArray | None = None


@dataclass
class BlockPartMessage:
    height: int
    round: int
    part: Part
    origin_ns: int = 0  # see ProposalMessage.origin_ns
    origin_node: str = ""  # see ProposalMessage.origin_node


@dataclass
class VoteMessage:
    vote: Vote
    origin_ns: int = 0  # see ProposalMessage.origin_ns
    origin_node: str = ""  # see ProposalMessage.origin_node


@dataclass
class HasVoteMessage:
    height: int
    round: int
    type: int
    index: int


@dataclass
class VoteSetMaj23Message:
    height: int
    round: int
    type: int
    block_id: BlockID = field(default_factory=BlockID)


@dataclass
class VoteSetBitsMessage:
    height: int
    round: int
    type: int
    block_id: BlockID = field(default_factory=BlockID)
    votes: BitArray | None = None
