"""Relational event sink (ref: internal/state/indexer/sink/psql/).

The reference indexes events into PostgreSQL with a blocks / tx_results
/ events / attributes schema for ad-hoc SQL queries. This environment
has no postgres driver, so the same schema runs on the stdlib sqlite3 —
the capability (SQL-queryable event history, joins across blocks, txs,
and attributes) is identical; swap the connection for a DB-API postgres
connection to run against the real thing.
"""

from __future__ import annotations

import sqlite3
import threading
from ..eventbus.event_bus import tx_hash

_SCHEMA = """
CREATE TABLE IF NOT EXISTS blocks (
  rowid    INTEGER PRIMARY KEY,
  height   INTEGER NOT NULL,
  chain_id TEXT NOT NULL,
  created_at TEXT NOT NULL DEFAULT (datetime('now')),
  UNIQUE (height, chain_id)
);
CREATE INDEX IF NOT EXISTS idx_blocks_height_chain ON blocks(height, chain_id);

CREATE TABLE IF NOT EXISTS tx_results (
  rowid    INTEGER PRIMARY KEY,
  block_id INTEGER NOT NULL REFERENCES blocks(rowid),
  index_in_block INTEGER NOT NULL,
  created_at TEXT NOT NULL DEFAULT (datetime('now')),
  tx_hash  TEXT NOT NULL,
  tx_result BLOB NOT NULL,
  UNIQUE (block_id, index_in_block)
);

CREATE TABLE IF NOT EXISTS events (
  rowid    INTEGER PRIMARY KEY,
  block_id INTEGER NOT NULL REFERENCES blocks(rowid),
  tx_id    INTEGER NULL REFERENCES tx_results(rowid),
  type     TEXT NOT NULL
);

CREATE TABLE IF NOT EXISTS attributes (
  event_id INTEGER NOT NULL REFERENCES events(rowid),
  key      TEXT NOT NULL,
  composite_key TEXT NOT NULL,
  value    TEXT NULL,
  UNIQUE (event_id, key)
);

CREATE VIEW IF NOT EXISTS event_attributes AS
  SELECT blocks.rowid AS block_id, height, chain_id, tx_id,
         events.rowid AS event_id, type, key, composite_key, value
  FROM blocks JOIN events ON (events.block_id = blocks.rowid)
  JOIN attributes ON (attributes.event_id = events.rowid);
"""


class SQLSink:
    """ref: psql.EventSink. One writer (the indexer service thread),
    any number of readers."""

    def __init__(self, path: str, chain_id: str):
        self.chain_id = chain_id
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._lock = threading.Lock()
        with self._lock:
            self._conn.executescript(_SCHEMA)
            self._conn.commit()

    # ------------------------------------------------------------- writes

    def _insert_events(self, cur, block_rowid: int, tx_rowid, events) -> None:
        for ev in events or []:
            cur.execute(
                "INSERT INTO events (block_id, tx_id, type) VALUES (?, ?, ?)",
                (block_rowid, tx_rowid, getattr(ev, "type", "") or ""),
            )
            event_id = cur.lastrowid
            for attr in getattr(ev, "attributes", None) or []:
                key = getattr(attr, "key", "") or ""
                cur.execute(
                    "INSERT OR IGNORE INTO attributes (event_id, key, composite_key, value)"
                    " VALUES (?, ?, ?, ?)",
                    (event_id, key, f"{ev.type}.{key}", getattr(attr, "value", "") or ""),
                )

    def _block_rowid(self, cur, height: int) -> int:
        """Upsert the block row, return its rowid."""
        cur.execute(
            "INSERT OR IGNORE INTO blocks (height, chain_id) VALUES (?, ?)",
            (height, self.chain_id),
        )
        cur.execute(
            "SELECT rowid FROM blocks WHERE height = ? AND chain_id = ?",
            (height, self.chain_id),
        )
        return cur.fetchone()[0]

    def index_block_events(self, height: int, f_res) -> None:
        """ref: psql.go IndexBlockEvents."""
        with self._lock:
            cur = self._conn.cursor()
            block_rowid = self._block_rowid(cur, height)
            self._insert_events(cur, block_rowid, None, getattr(f_res, "events", None))
            self._conn.commit()

    def index_tx_events(self, height: int, txs: list[bytes], tx_results: list) -> None:
        """ref: psql.go IndexTxEvents — the tx_result column stores the
        serialized TxResult (tx + execution outcome), so the execution
        code/log/gas are recoverable from the database."""
        from ..abci.proto import TxResultPB, _txres_to_pb

        with self._lock:
            cur = self._conn.cursor()
            block_rowid = self._block_rowid(cur, height)
            for i, tx in enumerate(txs):
                result = tx_results[i] if i < len(tx_results) else None
                record = TxResultPB(
                    height=height, index=i, tx=tx,
                    result=_txres_to_pb(result) if result is not None else None,
                ).encode()
                cur.execute(
                    "INSERT OR IGNORE INTO tx_results"
                    " (block_id, index_in_block, tx_hash, tx_result) VALUES (?, ?, ?, ?)",
                    (block_rowid, i, tx_hash(tx).hex().upper(), record),
                )
                cur.execute(
                    "SELECT rowid FROM tx_results WHERE block_id = ? AND index_in_block = ?",
                    (block_rowid, i),
                )
                tx_rowid = cur.fetchone()[0]
                self._insert_events(cur, block_rowid, tx_rowid, getattr(result, "events", None))
            self._conn.commit()

    # -------------------------------------------------------------- reads

    def query(self, sql: str, params: tuple = ()) -> list[tuple]:
        """Ad-hoc read access — the point of a relational sink."""
        with self._lock:
            return list(self._conn.execute(sql, params))

    def get_tx_by_hash(self, h: bytes):
        """Decoded TxResult record (height, index, tx, result) or None."""
        from ..abci.proto import TxResultPB

        rows = self.query("SELECT tx_result FROM tx_results WHERE tx_hash = ?", (h.hex().upper(),))
        return TxResultPB.decode(rows[0][0]) if rows else None

    def close(self) -> None:
        with self._lock:
            self._conn.close()
