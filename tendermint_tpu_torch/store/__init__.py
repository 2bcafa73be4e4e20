"""Persistence (ref: internal/store/, tm-db): the key-value store and the
block store."""

from .kv import Batch, FileDB, KVStore, MemDB  # noqa: F401
