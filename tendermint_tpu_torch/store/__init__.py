"""Persistence (ref: internal/store/, tm-db). The block store comes with
the state slice."""

from .kv import Batch, FileDB, KVStore, MemDB  # noqa: F401
