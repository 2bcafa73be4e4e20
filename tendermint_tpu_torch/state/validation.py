"""Block validation against the state (ref:
internal/state/validation.go:14-130).

Its LastCommit check, state.last_validators.VerifyCommit, is the per-block
signature check of every block a node applies; it runs through
types/validation.py's verify_commit into the batch verifiers, on the card
unless the caller passes device="cpu".
"""

from __future__ import annotations

from ..types.block import Block
from ..types.evidence import evidence_to_proto
from ..types.validation import verify_commit
from .state import State


class InvalidBlockError(ValueError):
    pass


def validate_block(state: State, block: Block, device=None) -> None:
    """ref: validateBlock (internal/state/validation.go:14). `device` is
    where verify_commit's batch runs (the card when None)."""
    block.validate_basic()

    if block.header.version_app != state.version_app or block.header.version_block != state.version_block:
        raise InvalidBlockError(
            f"wrong Block.Header.Version. Expected block={state.version_block}/app={state.version_app}, "
            f"got block={block.header.version_block}/app={block.header.version_app}"
        )
    if block.header.chain_id != state.chain_id:
        raise InvalidBlockError(f"wrong Block.Header.ChainID. Expected {state.chain_id}, got {block.header.chain_id}")
    if state.last_block_height == 0 and block.header.height != state.initial_height:
        raise InvalidBlockError(
            f"wrong Block.Header.Height. Expected {state.initial_height} for initial block, got {block.header.height}"
        )
    if state.last_block_height > 0 and block.header.height != state.last_block_height + 1:
        raise InvalidBlockError(
            f"wrong Block.Header.Height. Expected {state.last_block_height + 1}, got {block.header.height}"
        )
    if block.header.last_block_id != state.last_block_id:
        raise InvalidBlockError(
            f"wrong Block.Header.LastBlockID. Expected {state.last_block_id}, got {block.header.last_block_id}"
        )
    if block.header.app_hash != state.app_hash:
        raise InvalidBlockError(
            f"wrong Block.Header.AppHash. Expected {state.app_hash.hex().upper()}, got {block.header.app_hash.hex().upper()}"
        )
    hash_cp = state.consensus_params.hash_consensus_params()
    if block.header.consensus_hash != hash_cp:
        raise InvalidBlockError(
            f"wrong Block.Header.ConsensusHash. Expected {hash_cp.hex().upper()}, got {block.header.consensus_hash.hex().upper()}"
        )
    if block.header.last_results_hash != state.last_results_hash:
        raise InvalidBlockError(
            f"wrong Block.Header.LastResultsHash. Expected {state.last_results_hash.hex().upper()}, "
            f"got {block.header.last_results_hash.hex().upper()}"
        )
    vals_hash = state.validators.hash()  # memoized (types/validator_set.py)
    if block.header.validators_hash != vals_hash:
        raise InvalidBlockError(
            f"wrong Block.Header.ValidatorsHash. Expected {vals_hash.hex().upper()}, "
            f"got {block.header.validators_hash.hex().upper()}"
        )
    next_vals_hash = state.next_validators.hash()
    if block.header.next_validators_hash != next_vals_hash:
        raise InvalidBlockError(
            f"wrong Block.Header.NextValidatorsHash. Expected {next_vals_hash.hex().upper()}, "
            f"got {block.header.next_validators_hash.hex().upper()}"
        )

    # LastCommit: the signature check (validation.go:92)
    if block.header.height == state.initial_height:
        if block.last_commit is not None and len(block.last_commit.signatures) != 0:
            raise InvalidBlockError("initial block can't have LastCommit signatures")
    else:
        verify_commit(
            state.chain_id, state.last_validators, state.last_block_id, block.header.height - 1, block.last_commit,
            device=device,
        )

    # Evidence size cap (validation.go:131): the per-block evidence byte
    # budget is a consensus param.
    max_ev_bytes = state.consensus_params.evidence.max_bytes
    ev_bytes = sum(len(evidence_to_proto(ev).encode()) for ev in block.evidence)
    if ev_bytes > max_ev_bytes:
        raise InvalidBlockError(
            f"evidence bytes {ev_bytes} exceeds maximum {max_ev_bytes}"
        )

    if not state.validators.has_address(block.header.proposer_address):
        raise InvalidBlockError(
            f"block.Header.ProposerAddress {block.header.proposer_address.hex().upper()} is not a validator"
        )

    # Block time monotonicity (validation.go:109)
    if block.header.height > state.initial_height:
        if block.header.time.unix_ns() <= state.last_block_time.unix_ns():
            raise InvalidBlockError(
                f"block time {block.header.time} not greater than last block time {state.last_block_time}"
            )
    elif block.header.height == state.initial_height:
        if block.header.time.unix_ns() < state.last_block_time.unix_ns():
            raise InvalidBlockError(f"block time {block.header.time} is before genesis time {state.last_block_time}")
    else:
        raise InvalidBlockError(
            f"block height {block.header.height} lower than initial height {state.initial_height}"
        )
