"""State rollback — rewind one height for app-hash mismatch recovery
(ref: internal/state/rollback.go)."""

from __future__ import annotations

from dataclasses import replace


class RollbackError(Exception):
    pass


def rollback_state(state_store, block_store) -> tuple[int, bytes]:
    """Rewind state one height; block store keeps the rolled-back block
    (the reference expects a matching app rollback). Returns
    (new_height, app_hash) (ref: rollback.go:19 Rollback)."""
    invalid_state = state_store.load()
    if invalid_state is None:
        raise RollbackError("no state found")
    height = block_store.height()

    # the reference tolerates a block store one ahead of state (crash
    # mid-commit, rollback.go:33)
    if height not in (invalid_state.last_block_height, invalid_state.last_block_height + 1):
        raise RollbackError(
            f"statestore height ({invalid_state.last_block_height}) is not one below or "
            f"equal to blockstore height ({height})"
        )

    rollback_height = invalid_state.last_block_height
    rollback_block = block_store.load_block_meta(rollback_height)
    if rollback_block is None:
        raise RollbackError(f"block at height {rollback_height} not found")
    previous_height = rollback_height - 1
    if previous_height < 1:
        raise RollbackError("cannot rollback to height 0")
    previous_block = block_store.load_block_meta(previous_height)
    if previous_block is None:
        raise RollbackError(f"block at height {previous_height} not found")

    prev_vals = state_store.load_validators(previous_height)
    curr_vals = state_store.load_validators(rollback_height)
    next_vals = state_store.load_validators(rollback_height + 1)
    prev_params = state_store.load_consensus_params(rollback_height)
    if prev_vals is None or curr_vals is None or next_vals is None:
        raise RollbackError("validator sets for rollback heights not found")

    f_res = state_store.load_finalize_block_responses(previous_height)

    rolled = replace(
        invalid_state,
        last_block_height=previous_height,
        last_block_id=previous_block.block_id,
        last_block_time=previous_block.header.time,
        validators=curr_vals.copy(),
        next_validators=next_vals.copy(),
        last_validators=prev_vals.copy(),
        consensus_params=prev_params if prev_params is not None else invalid_state.consensus_params,
        app_hash=rollback_block.header.app_hash,
        last_results_hash=rollback_block.header.last_results_hash,
    )
    state_store.save(rolled)
    return rolled.last_block_height, rolled.app_hash
