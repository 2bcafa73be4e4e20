"""Node configuration (ref: config/).

A copy of the JAX package's config/: the same fields, TOML and refusals,
read with the standard library's tomllib."""

from .config import (
    BaseConfig,
    BlockSyncConfig,
    Config,
    ConsensusConfig,
    MempoolConfig,
    P2PConfig,
    RPCConfig,
    StateSyncConfig,
    TxIndexConfig,
    default_config,
    load_config,
)

__all__ = [
    "BaseConfig",
    "BlockSyncConfig",
    "Config",
    "ConsensusConfig",
    "MempoolConfig",
    "P2PConfig",
    "RPCConfig",
    "StateSyncConfig",
    "TxIndexConfig",
    "default_config",
    "load_config",
]
