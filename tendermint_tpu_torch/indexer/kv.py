"""KV event sink (ref: internal/state/indexer/sink/kv/kv.go).

Indexes tx results by hash and by event attribute, block events by
height. Query support mirrors the /tx_search semantics: all conditions
ANDed, ranges on numeric values.
"""

from __future__ import annotations

import json
import threading

from ..eventbus.event_bus import abci_events_to_map, tx_hash
from ..pubsub.query import Query

_TX_RESULT = b"idx/tx/"  # + tx hash
_TX_EVENT = b"idx/txev/"  # + key / value / height / index
_BLOCK_EVENT = b"idx/blkev/"  # + key / value / height
_BLOCK_HEIGHT = b"idx/blk/"  # + height


def _sep(*parts: bytes) -> bytes:
    return b"\x00".join(parts)


class KVIndexer:
    """ref: sink/kv/kv.go EventSink."""

    def __init__(self, db):
        self.db = db
        self._lock = threading.Lock()

    # ------------------------------------------------------------- writing

    def index_block_events(self, height: int, f_res) -> None:
        """ref: kv/kv.go IndexBlockEvents."""
        with self._lock:
            self.db.set(_BLOCK_HEIGHT + self._h(height), str(height).encode())
            for key, values in abci_events_to_map(getattr(f_res, "events", None)).items():
                for v in values:
                    self.db.set(
                        _sep(_BLOCK_EVENT + key.encode(), v.encode(), self._h(height)),
                        str(height).encode(),
                    )

    def index_tx_events(self, height: int, txs: list[bytes], tx_results: list) -> None:
        """ref: kv/kv.go IndexTxEvents."""
        with self._lock:
            for i, tx in enumerate(txs):
                result = tx_results[i] if i < len(tx_results) else None
                h = tx_hash(tx)
                doc = {
                    "height": height,
                    "index": i,
                    "tx": tx.hex(),
                    "code": getattr(result, "code", 0),
                    "log": getattr(result, "log", ""),
                    "gas_wanted": getattr(result, "gas_wanted", 0),
                    "gas_used": getattr(result, "gas_used", 0),
                    "events": [
                        {"type": e.type, "attributes": [{"key": a.key, "value": a.value} for a in e.attributes]}
                        for e in (getattr(result, "events", None) or [])
                    ],
                }
                self.db.set(_TX_RESULT + h, json.dumps(doc).encode())
                event_map = abci_events_to_map(getattr(result, "events", None))
                event_map.setdefault("tx.height", []).append(str(height))
                for key, values in event_map.items():
                    for v in values:
                        self.db.set(
                            _sep(_TX_EVENT + key.encode(), v.encode(), self._h(height), str(i).encode()),
                            h,
                        )

    @staticmethod
    def _h(height: int) -> bytes:
        return height.to_bytes(8, "big")

    # ------------------------------------------------------------- reading

    def get_tx_by_hash(self, h: bytes) -> dict | None:
        raw = self.db.get(_TX_RESULT + h)
        return json.loads(raw) if raw else None

    def search_tx_events(self, query: Query, limit: int = 100) -> list[dict]:
        """AND of all conditions (ref: kv/kv.go SearchTxEvents). Each
        condition produces a set of tx hashes; intersect them."""
        result_sets: list[set[bytes]] = []
        for cond in query.conditions:
            matches: set[bytes] = set()
            prefix = _TX_EVENT + cond.key.encode() + b"\x00"
            for k, v in self.db.iterator(prefix, prefix + b"\xff"):
                rest = k[len(prefix):]
                value = rest.split(b"\x00", 1)[0].decode(errors="replace")
                if cond.matches([value]):
                    matches.add(bytes(v))
            result_sets.append(matches)
        if not result_sets:
            return []
        hashes = set.intersection(*result_sets)
        out = []
        for h in hashes:
            doc = self.get_tx_by_hash(h)
            if doc is not None:
                out.append(doc)
        # deterministic pagination: order by (height, index), THEN truncate
        out.sort(key=lambda d: (d["height"], d["index"]))
        return out[:limit]

    def search_block_events(self, query: Query, limit: int = 100) -> list[int]:
        """Heights whose block events match (ref: kv/kv.go SearchBlockEvents)."""
        result_sets: list[set[int]] = []
        for cond in query.conditions:
            if cond.key == "block.height":
                heights = set()
                for k, v in self.db.iterator(_BLOCK_HEIGHT, _BLOCK_HEIGHT + b"\xff"):
                    height = int(v.decode())
                    if cond.matches([str(height)]):
                        heights.add(height)
                result_sets.append(heights)
                continue
            matches: set[int] = set()
            prefix = _BLOCK_EVENT + cond.key.encode() + b"\x00"
            for k, v in self.db.iterator(prefix, prefix + b"\xff"):
                rest = k[len(prefix):]
                value = rest.split(b"\x00", 1)[0].decode(errors="replace")
                if cond.matches([value]):
                    matches.add(int(v.decode()))
            result_sets.append(matches)
        if not result_sets:
            return []
        return sorted(set.intersection(*result_sets))[:limit]
