"""Tx/block indexing (ref: internal/state/indexer/).

A copy of the JAX package's kv indexer and its service, with the same keys,
and its SQL sinks: sqlite (sink_sql.py, the standard library's sqlite3) and
PostgreSQL (sink_psql.py, over any DB-API driver; none is installed)."""

from .kv import KVIndexer
from .service import IndexerService

__all__ = ["KVIndexer", "IndexerService"]
