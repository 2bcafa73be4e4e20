"""Indexer service — subscribes to the event bus and feeds sinks
(ref: internal/state/indexer/indexer_service.go)."""

from __future__ import annotations

import threading

from ..eventbus import EVENT_NEW_BLOCK, EventBus
from ..pubsub.query import parse_query


class IndexerService:
    SUBSCRIBER = "IndexerService"

    def __init__(self, indexer, event_bus: EventBus):
        self.indexer = indexer
        self.event_bus = event_bus
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> None:
        # tmcheck: ok[shared-mutation] handoff: start() publishes _sub before the thread exists; _run is the sole writer afterwards
        self._sub = self.event_bus.subscribe(
            self.SUBSCRIBER, parse_query(f"tm.event = '{EVENT_NEW_BLOCK}'"), buffer_size=512
        )
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True, name="indexer")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self.event_bus.unsubscribe_all(self.SUBSCRIBER)
        if self._thread is not None:
            self._thread.join(timeout=2)

    def _run(self) -> None:
        while not self._stop.is_set():
            if self._sub.terminated.is_set():
                # dropped as a slow subscriber: drain what's already
                # buffered, then resubscribe (blocks published between
                # termination and resubscribe are missed; log loudly)
                drained = 0
                while True:
                    msg = self._sub.next(timeout=0)
                    if msg is None:
                        break
                    self._index_one(msg)
                    drained += 1
                print(
                    f"indexer: subscription terminated (slow); drained {drained}, resubscribing",
                    flush=True,
                )
                self.event_bus.unsubscribe_all(self.SUBSCRIBER)
                self._sub = self.event_bus.subscribe(
                    self.SUBSCRIBER, parse_query(f"tm.event = '{EVENT_NEW_BLOCK}'"), buffer_size=512
                )
            msg = self._sub.next(timeout=0.2)
            if msg is None:
                if self._sub.terminated.is_set():
                    self._stop.wait(0.2)  # no hot spin while terminated+empty
                continue
            self._index_one(msg)

    def _index_one(self, msg) -> None:
        data = msg.data  # EventDataNewBlock
        block = data.block
        f_res = data.result_finalize_block
        # self.indexer may be one sink or a list of sinks (ref:
        # EventSinksFromConfig returns a slice, node/setup.go)
        sinks = self.indexer if isinstance(self.indexer, (list, tuple)) else [self.indexer]
        for sink in sinks:
            try:
                sink.index_block_events(block.header.height, f_res)
                sink.index_tx_events(block.header.height, list(block.txs), list(f_res.tx_results))
            except Exception:
                import traceback

                traceback.print_exc()
