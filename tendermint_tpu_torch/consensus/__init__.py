"""Consensus engine (ref: internal/consensus/)."""

from .messages import (  # noqa: F401
    BlockPartMessage,
    HasVoteMessage,
    NewRoundStepMessage,
    NewValidBlockMessage,
    ProposalMessage,
    ProposalPOLMessage,
    VoteMessage,
    VoteSetBitsMessage,
    VoteSetMaj23Message,
)
from .handshake import AppHashMismatchError, Handshaker, HandshakeError  # noqa: F401
from .round_state import HeightVoteSet, RoundState  # noqa: F401
from .state import ConsensusError, ConsensusState  # noqa: F401
from .ticker import TimeoutTicker  # noqa: F401
from .wal import WAL, EndHeightMessage, MsgInfo, TimeoutInfo  # noqa: F401
