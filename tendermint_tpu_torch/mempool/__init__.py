"""Mempool (ref: internal/mempool/)."""

from .mempool import LRUTxCache, TxInCacheError, TxMempool, WrappedTx, tx_key  # noqa: F401
