"""Typed event bus over pubsub (ref: internal/eventbus/event_bus.go).

A copy of the JAX package's eventbus/ and its event log, wired by the
node to BlockExecutor's and the Handshaker's event_publisher."""

from .event_bus import (
    EVENT_NEW_BLOCK,
    EVENT_NEW_BLOCK_HEADER,
    EVENT_TX,
    EVENT_VALIDATOR_SET_UPDATES,
    EVENT_VOTE,
    EVENT_NEW_ROUND_STEP,
    EventBus,
    abci_events_to_map,
)

__all__ = [
    "EVENT_NEW_BLOCK",
    "EVENT_NEW_BLOCK_HEADER",
    "EVENT_NEW_ROUND_STEP",
    "EVENT_TX",
    "EVENT_VALIDATOR_SET_UPDATES",
    "EVENT_VOTE",
    "EventBus",
    "abci_events_to_map",
]
