"""The state layer (ref: internal/state/): State and its update, the state
store, block validation against the state and the BlockExecutor."""

from .execution import BlockExecutor, tx_results_hash  # noqa: F401
from .state import State, make_genesis_state  # noqa: F401
from .store import StateStore  # noqa: F401
from .validation import InvalidBlockError, validate_block  # noqa: F401
