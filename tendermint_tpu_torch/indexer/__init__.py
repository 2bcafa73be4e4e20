"""Tx/block indexing (ref: internal/state/indexer/).

A copy of the JAX package's kv indexer and its service, with the same keys;
the SQL sinks come with ROADMAP A14b."""

from .kv import KVIndexer
from .service import IndexerService

__all__ = ["KVIndexer", "IndexerService"]
