"""EventBus — typed façade over the pubsub server
(ref: internal/eventbus/event_bus.go:25-196).

Reserved composite keys (types/events.go): `tm.event` (event type),
`tx.hash`, `tx.height`. ABCI events flatten to `{type}.{key}` keys.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Any

from ..pubsub import Query, Server, Subscription, parse_query

# Event type values (ref: types/events.go EventNewBlockValue etc.)
EVENT_NEW_BLOCK = "NewBlock"
EVENT_NEW_BLOCK_HEADER = "NewBlockHeader"
EVENT_TX = "Tx"
EVENT_VOTE = "Vote"
EVENT_VALIDATOR_SET_UPDATES = "ValidatorSetUpdates"
EVENT_NEW_ROUND_STEP = "NewRoundStep"
EVENT_NEW_ROUND = "NewRound"
EVENT_COMPLETE_PROPOSAL = "CompleteProposal"
EVENT_LOCK = "Lock"
EVENT_POLKA = "Polka"
EVENT_BLOCK_SYNC_STATUS = "BlockSyncStatus"
EVENT_STATE_SYNC_STATUS = "StateSyncStatus"

TYPE_KEY = "tm.event"  # types/events.go EventTypeKey
TX_HASH_KEY = "tx.hash"
TX_HEIGHT_KEY = "tx.height"
BLOCK_HEIGHT_KEY = "block.height"


def tx_hash(tx: bytes) -> bytes:
    """ref: types/tx.go Tx.Hash — SHA256."""
    return hashlib.sha256(tx).digest()


def abci_events_to_map(events, base: dict[str, list[str]] | None = None) -> dict[str, list[str]]:
    """Flatten ABCI events to composite keys (ref: internal/pubsub
    query semantics + types/events.go)."""
    out: dict[str, list[str]] = {k: list(v) for k, v in (base or {}).items()}
    for ev in events or []:
        if not ev.type:
            continue
        for attr in ev.attributes:
            if not attr.key:
                continue
            out.setdefault(f"{ev.type}.{attr.key}", []).append(attr.value)
    return out


@dataclass
class EventDataNewBlock:
    block: Any = None
    block_id: Any = None
    result_finalize_block: Any = None


@dataclass
class EventDataNewBlockHeader:
    header: Any = None
    num_txs: int = 0


@dataclass
class EventDataTx:
    height: int = 0
    index: int = 0
    tx: bytes = b""
    result: Any = None


@dataclass
class EventDataVote:
    vote: Any = None


@dataclass
class EventDataValidatorSetUpdates:
    validator_updates: list = field(default_factory=list)


@dataclass
class EventDataRoundState:
    height: int = 0
    round: int = 0
    step: str = ""


class EventBus:
    """ref: eventbus.EventBus."""

    def __init__(self, event_log=None):
        self.server = Server()
        # Optional eventlog backing the polling /events RPC
        # (ref: internal/eventlog wired at node/node.go:167)
        self.event_log = event_log

    # ------------------------------------------------------------ subscribe

    def subscribe(self, subscriber: str, query: Query | str, buffer_size: int | None = None) -> Subscription:
        q = parse_query(query) if isinstance(query, str) else query
        return self.server.subscribe(subscriber, q, buffer_size)

    def unsubscribe(self, subscriber: str, query: Query | str) -> None:
        q = parse_query(query) if isinstance(query, str) else query
        self.server.unsubscribe(subscriber, q)

    def unsubscribe_all(self, subscriber: str) -> None:
        self.server.unsubscribe_all(subscriber)

    # -------------------------------------------------------------- publish

    def publish(self, event_value: str, data: Any, extra_events: dict[str, list[str]] | None = None) -> None:
        events = {TYPE_KEY: [event_value]}
        for k, v in (extra_events or {}).items():
            events.setdefault(k, []).extend(v)
        self._publish_raw(event_value, data, events)

    def _publish_raw(self, event_value: str, data: Any, events: dict[str, list[str]]) -> None:
        """Single funnel: pubsub subscribers + the polling event log."""
        self.server.publish(data, events)
        if self.event_log is not None:
            self.event_log.add(event_value, data, events)

    def publish_event_new_block(self, block, block_id, f_res) -> None:
        """ref: event_bus.go:69 PublishEventNewBlock — indexes the
        FinalizeBlock events too."""
        base = {
            TYPE_KEY: [EVENT_NEW_BLOCK],
            BLOCK_HEIGHT_KEY: [str(block.header.height)],
        }
        events = abci_events_to_map(getattr(f_res, "events", None), base)
        self._publish_raw(
            EVENT_NEW_BLOCK,
            EventDataNewBlock(block=block, block_id=block_id, result_finalize_block=f_res),
            events,
        )

    def publish_event_new_block_header(self, header, num_txs: int) -> None:
        self.publish(
            EVENT_NEW_BLOCK_HEADER,
            EventDataNewBlockHeader(header=header, num_txs=num_txs),
            {BLOCK_HEIGHT_KEY: [str(header.height)]},
        )

    def publish_event_tx(self, height: int, index: int, tx: bytes, result) -> None:
        """ref: event_bus.go PublishEventTx — reserved tx.hash/tx.height
        keys plus the tx's own ABCI events."""
        base = {
            TYPE_KEY: [EVENT_TX],
            TX_HASH_KEY: [tx_hash(tx).hex().upper()],
            TX_HEIGHT_KEY: [str(height)],
        }
        events = abci_events_to_map(getattr(result, "events", None), base)
        self._publish_raw(
            EVENT_TX, EventDataTx(height=height, index=index, tx=tx, result=result), events
        )

    def publish_event_vote(self, vote) -> None:
        self.publish(EVENT_VOTE, EventDataVote(vote=vote))

    def publish_event_validator_set_updates(self, updates: list) -> None:
        self.publish(EVENT_VALIDATOR_SET_UPDATES, EventDataValidatorSetUpdates(validator_updates=updates))

    def publish_event_new_round_step(self, height: int, round_: int, step: str) -> None:
        self.publish(EVENT_NEW_ROUND_STEP, EventDataRoundState(height=height, round=round_, step=step))

    # --------------------------------------------------------- integration

    def block_event_publisher(self):
        """Adapter for BlockExecutor.event_publisher
        (ref: internal/state/execution.go:600 fireEvents)."""

        def publish(block, block_id, f_res, validator_updates):
            self.publish_event_new_block(block, block_id, f_res)
            self.publish_event_new_block_header(block.header, len(block.txs))
            for i, tx in enumerate(block.txs):
                result = f_res.tx_results[i] if i < len(f_res.tx_results) else None
                self.publish_event_tx(block.header.height, i, tx, result)
            if validator_updates:
                self.publish_event_validator_set_updates(validator_updates)

        return publish
