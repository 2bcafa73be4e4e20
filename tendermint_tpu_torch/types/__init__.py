"""Core consensus types (ref: types/), re-exported as the JAX package's types/ does."""

from .block import (  # noqa: F401
    BLOCK_ID_FLAG_ABSENT,
    BLOCK_ID_FLAG_COMMIT,
    BLOCK_ID_FLAG_NIL,
    BLOCK_PART_SIZE_BYTES,
    Block,
    BlockID,
    Commit,
    CommitSig,
    Header,
    PartSetHeader,
    tx_hash,
    txs_hash,
)
from .canonical import (  # noqa: F401
    proposal_sign_bytes,
    vote_extension_sign_bytes,
    vote_sign_bytes,
)
from .evidence import (  # noqa: F401
    DuplicateVoteEvidence,
    Evidence,
    LightClientAttackEvidence,
    evidence_from_proto,
    evidence_to_proto,
)
from .genesis import GenesisDoc, GenesisValidator  # noqa: F401
from .light_block import LightBlock, SignedHeader  # noqa: F401
from .params import ConsensusParams, default_consensus_params  # noqa: F401
from .part_set import Part, PartSet  # noqa: F401
from .validation import (  # noqa: F401
    Fraction,
    verify_commit,
    verify_commit_light,
    verify_commit_light_trusting,
)
from .validator_set import (  # noqa: F401
    MAX_TOTAL_VOTING_POWER,
    NotEnoughVotingPowerError,
    Validator,
    ValidatorSet,
)
from .vote import PRECOMMIT, PREVOTE, Vote  # noqa: F401
from .vote_set import ConflictingVoteError, VoteSet  # noqa: F401
