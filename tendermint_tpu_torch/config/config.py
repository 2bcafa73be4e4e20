"""Config tree + TOML persistence (ref: config/config.go:62-1230,
config/toml.go).

Consensus-critical parameters (timeouts, synchrony) are ON-CHAIN
ConsensusParams, not node config — a node-local config cannot fork the
chain (config.go's deprecated-timeout migration moved them out). What
remains here is operational: listeners, db paths, mempool sizing,
peers, sync modes.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import tomllib

DEFAULT_DATA_DIR = "data"
DEFAULT_CONFIG_DIR = "config"
DEFAULT_CONFIG_FILE = "config.toml"
DEFAULT_GENESIS_FILE = "genesis.json"
DEFAULT_PRIVVAL_KEY = "priv_validator_key.json"
DEFAULT_PRIVVAL_STATE = "priv_validator_state.json"
DEFAULT_NODE_KEY = "node_key.json"


@dataclass
class BaseConfig:
    """ref: config.BaseConfig (config/config.go:146)."""

    home: str = ""
    moniker: str = "anonymous"
    mode: str = "validator"  # validator | full | seed
    proxy_app: str = "builtin:kvstore"  # builtin:<name> | tcp://... (socket ABCI)
    db_backend: str = "filedb"
    db_dir: str = "data"
    log_level: str = "info"
    # "plain" (human console lines) | "json" (one object per line,
    # zerolog-style) — ref: config.go BaseConfig.LogFormat
    log_format: str = "plain"
    genesis_file: str = os.path.join(DEFAULT_CONFIG_DIR, DEFAULT_GENESIS_FILE)
    priv_validator_key_file: str = os.path.join(DEFAULT_CONFIG_DIR, DEFAULT_PRIVVAL_KEY)
    priv_validator_state_file: str = os.path.join(DEFAULT_DATA_DIR, DEFAULT_PRIVVAL_STATE)
    # When set, the node listens here and an external remote signer dials
    # in (ref: config.PrivValidator.ListenAddr, config/config.go:354).
    priv_validator_laddr: str = ""
    node_key_file: str = os.path.join(DEFAULT_CONFIG_DIR, DEFAULT_NODE_KEY)


@dataclass
class RPCConfig:
    """ref: config.RPCConfig (config/config.go:388)."""

    laddr: str = "tcp://127.0.0.1:26657"
    max_open_connections: int = 900
    timeout_broadcast_tx_commit: float = 10.0
    enable: bool = True
    # ref: RPCConfig (config.go:421-470) DoS guards + CORS
    max_body_bytes: int = 1_000_000
    max_subscription_clients: int = 100
    max_subscriptions_per_client: int = 5
    cors_allowed_origins: str = ""  # comma-separated; "*" allows all
    # ref: RPCConfig.Unsafe (config.go:429): activates unsafe_* routes
    # (flush-mempool, partition fault injection). Never in production.
    unsafe: bool = False


@dataclass
class P2PConfig:
    """ref: config.P2PConfig (config/config.go:570)."""

    laddr: str = "tcp://0.0.0.0:26656"
    external_address: str = ""
    persistent_peers: str = ""  # comma-separated id@host:port
    bootstrap_peers: str = ""
    max_connections: int = 64
    max_incoming_connection_attempts: int = 100
    pex: bool = True
    private_peer_ids: str = ""
    # per-connection flow control, bytes/sec (ref: conn/connection.go:45-46)
    send_rate: int = 512000
    recv_rate: int = 512000
    # connection liveness (ref: conn/connection.go pingRoutine): ping
    # cadence and how long a link may stay silent after a ping before it
    # is closed as half-open/dead; ping_interval <= 0 disables both
    ping_interval: float = 15.0
    pong_timeout: float = 45.0
    # per-peer outbound queue discipline: fifo | priority |
    # simple-priority (ref: config.go P2PConfig.QueueType)
    queue_type: str = "fifo"


@dataclass
class MempoolConfig:
    """ref: config.MempoolConfig (config/config.go:697)."""

    size: int = 5000
    max_txs_bytes: int = 1 << 30
    cache_size: int = 10000
    keep_invalid_txs_in_cache: bool = False
    max_tx_bytes: int = 1 << 20
    recheck: bool = True
    broadcast: bool = True
    # ref: MempoolConfig.TTLDuration / TTLNumBlocks (config.go:762-770):
    # 0 disables; otherwise txs expire after this many seconds / blocks.
    ttl_duration: float = 0.0
    ttl_num_blocks: int = 0
    # Opt-in engine-routed tx signature pre-verification
    # (mempool/preverify.py): admission batch-verifies signed-tx
    # envelopes through ops/engine before the app's CheckTx. Off by
    # default — kvstore txs are unsigned. No reference analog.
    precheck_sigs: bool = False


@dataclass
class BlockSyncConfig:
    """ref: config.BlockSyncConfig (config/config.go:832)."""

    enable: bool = True


@dataclass
class StateSyncConfig:
    """ref: config.StateSyncConfig (config/config.go:775)."""

    enable: bool = False
    rpc_servers: str = ""
    trust_height: int = 0
    trust_hash: str = ""
    trust_period: float = 168 * 3600.0  # seconds
    discovery_time: float = 15.0
    fetchers: int = 4  # 0.35 spelling (0.34: chunk-fetchers)


@dataclass
class ConsensusConfig:
    """Operational consensus knobs (ref: config.ConsensusConfig
    config/config.go:847 — timeouts live on-chain now)."""

    wal_file: str = os.path.join(DEFAULT_DATA_DIR, "cs.wal", "wal")
    double_sign_check_height: int = 0
    create_empty_blocks: bool = True
    create_empty_blocks_interval: float = 0.0
    peer_gossip_sleep_duration: float = 0.1
    peer_query_maj23_sleep_duration: float = 2.0


@dataclass
class TxIndexConfig:
    """ref: config.TxIndexConfig (config/config.go:1100)."""

    indexer: str = "kv"  # kv | sqlite | psql | "null", comma-separated
    # DSN for the psql sink, e.g. postgresql://user:pw@host:5432/db
    # (ref: config.go TxIndexConfig.PsqlConn)
    psql_conn: str = ""


@dataclass
class InstrumentationConfig:
    """ref: config.InstrumentationConfig (config/config.go:1130)."""

    prometheus: bool = False
    prometheus_listen_addr: str = ":26660"
    namespace: str = "tendermint"
    # In-run flight recorder (metrics/flight.py): sample the node's
    # registries every this-many seconds into <home>/timeseries.jsonl
    # (flushed per record — rates-over-time survive SIGKILL). 0
    # disables (the production default: zero threads, zero cost); the
    # e2e runner turns it on fleet-wide. No reference analog.
    flight_interval: float = 0.0


@dataclass
class Config:
    """ref: config.Config (config/config.go:62)."""

    base: BaseConfig = field(default_factory=BaseConfig)
    rpc: RPCConfig = field(default_factory=RPCConfig)
    p2p: P2PConfig = field(default_factory=P2PConfig)
    mempool: MempoolConfig = field(default_factory=MempoolConfig)
    statesync: StateSyncConfig = field(default_factory=StateSyncConfig)
    blocksync: BlockSyncConfig = field(default_factory=BlockSyncConfig)
    consensus: ConsensusConfig = field(default_factory=ConsensusConfig)
    tx_index: TxIndexConfig = field(default_factory=TxIndexConfig)
    instrumentation: InstrumentationConfig = field(default_factory=InstrumentationConfig)
    # keys present in the TOML but not recognized (stale/misspelled) —
    # populated by from_toml, warned about by load_config
    unknown_keys: list = field(default_factory=list)

    # -------------------------------------------------------------- paths

    def _root(self, path: str) -> str:
        return path if os.path.isabs(path) else os.path.join(self.base.home, path)

    @property
    def genesis_file(self) -> str:
        return self._root(self.base.genesis_file)

    @property
    def priv_validator_key_file(self) -> str:
        return self._root(self.base.priv_validator_key_file)

    @property
    def priv_validator_state_file(self) -> str:
        return self._root(self.base.priv_validator_state_file)

    @property
    def node_key_file(self) -> str:
        return self._root(self.base.node_key_file)

    @property
    def db_dir(self) -> str:
        return self._root(self.base.db_dir)

    @property
    def wal_file(self) -> str:
        return self._root(self.consensus.wal_file)

    def validate_basic(self) -> None:
        if self.base.mode not in ("validator", "full", "seed"):
            raise ValueError(f"unknown mode {self.base.mode!r}")
        if self.base.log_format not in ("plain", "json"):
            # ref: config/config.go BaseConfig.ValidateBasic (unknown
            # log_format must error, not silently fall back to console)
            raise ValueError(
                f"unknown log_format {self.base.log_format!r} (must be 'plain' or 'json')"
            )
        if self.mempool.size <= 0:
            raise ValueError("mempool.size must be positive")
        if self.mempool.ttl_duration < 0 or self.mempool.ttl_num_blocks < 0:
            # ref: MempoolConfig.ValidateBasic (config.go:792-800)
            raise ValueError("mempool ttl-duration and ttl-num-blocks can't be negative")

    # --------------------------------------------------------------- TOML

    def save(self, path: str | None = None) -> str:
        path = path or os.path.join(self.base.home, DEFAULT_CONFIG_DIR, DEFAULT_CONFIG_FILE)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write(self.to_toml())
        return path

    def to_toml(self) -> str:
        """ref: config/toml.go template."""

        def v(val) -> str:
            if isinstance(val, bool):
                return "true" if val else "false"
            if isinstance(val, (int, float)):
                return str(val)
            return '"%s"' % str(val).replace("\\", "\\\\").replace('"', '\\"')

        lines = ["# tendermint-tpu node configuration", ""]
        sections = [
            ("", self.base),
            ("rpc", self.rpc),
            ("p2p", self.p2p),
            ("mempool", self.mempool),
            ("statesync", self.statesync),
            ("blocksync", self.blocksync),
            ("consensus", self.consensus),
            ("tx-index", self.tx_index),
            ("instrumentation", self.instrumentation),
        ]
        for name, section in sections:
            if name:
                lines.append(f"[{name}]")
            for key, val in vars(section).items():
                if name == "" and key == "home":
                    continue  # home is implied by file location
                lines.append(f"{key.replace('_', '-')} = {v(val)}")
            lines.append("")
        return "\n".join(lines)

    @classmethod
    def from_toml(cls, text: str, home: str = "") -> "Config":
        """Parse, collecting unrecognized keys into `cfg.unknown_keys` —
        the reference warns on deprecated/unknown config (config.go's
        deprecated-key detection at :1001-1090, and the confix migration
        tool); load_config logs them so a stale config.toml (e.g. a
        consensus timeout that moved on-chain) is visible, not silently
        ignored."""
        doc = tomllib.loads(text)
        cfg = cls()
        cfg.base.home = home
        unknown: list[str] = []

        def apply(section_obj, d: dict, prefix: str):
            for k, val in d.items():
                if isinstance(val, dict):
                    # no known section nests tables: a sub-table or an
                    # inline-table value is always unrecognized config
                    unknown.append(f"{prefix}{k}.*")
                    continue
                attr = k.replace("-", "_")
                if hasattr(section_obj, attr):
                    setattr(section_obj, attr, val)
                else:
                    unknown.append(f"{prefix}{k}")

        sections = {
            "rpc": cfg.rpc,
            "p2p": cfg.p2p,
            "mempool": cfg.mempool,
            "statesync": cfg.statesync,
            "blocksync": cfg.blocksync,
            "consensus": cfg.consensus,
            "tx-index": cfg.tx_index,
            "instrumentation": cfg.instrumentation,
        }
        apply(cfg.base, {k: v for k, v in doc.items() if not isinstance(v, dict)}, "")
        for name, obj in sections.items():
            apply(obj, doc.get(name, {}), name + ".")
        for name in doc:
            if isinstance(doc[name], dict) and name not in sections:
                unknown.append(f"[{name}]")
        cfg.unknown_keys = unknown
        return cfg


def default_config(home: str) -> Config:
    cfg = Config()
    cfg.base.home = home
    return cfg


def load_config(home: str) -> Config:
    """Load <home>/config/config.toml, defaulting when absent. Warns on
    stderr about unrecognized keys (stale or misspelled config)."""
    path = os.path.join(home, DEFAULT_CONFIG_DIR, DEFAULT_CONFIG_FILE)
    if not os.path.exists(path):
        return default_config(home)
    with open(path) as f:
        cfg = Config.from_toml(f.read(), home=home)
    if cfg.unknown_keys:
        import sys

        print(f"WARNING: unrecognized config keys in {path}: "
              f"{', '.join(cfg.unknown_keys)}", file=sys.stderr)
    return cfg
