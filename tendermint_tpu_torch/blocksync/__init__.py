"""Blocksync: fast block-by-block catch-up (ref: internal/blocksync/), the
port's fourth consumer of verify_commit."""

from .pool import BlockPool
from .reactor import BlockSyncReactor, blocksync_channel_descriptor

__all__ = ["BlockPool", "BlockSyncReactor", "blocksync_channel_descriptor"]
