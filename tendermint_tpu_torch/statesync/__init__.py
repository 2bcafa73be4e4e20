"""Statesync: snapshot-based state transfer + light-block backfill
(ref: internal/statesync/)."""

from .reactor import StateSyncReactor, statesync_channel_descriptors
from .syncer import Syncer

__all__ = ["StateSyncReactor", "Syncer", "statesync_channel_descriptors"]
