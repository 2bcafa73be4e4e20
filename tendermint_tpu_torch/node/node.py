"""Node — dependency wiring of every subsystem
(ref: node/node.go:121-400 makeNode, :403-520 OnStart).

A copy of the JAX package's node/node.py. Start order preserved from the
reference: app client → eventbus → indexer → ABCI handshake/replay →
router → reactors → RPC. Sync orchestration: blocksync first unless this
node is the only validator, switching to consensus when caught up
(node/node.go:360-377, node/setup.go:134 onlyValidatorIsUs).

`Node(..., device=None)` runs its verifying layers (BlockExecutor, the
Handshaker, the EvidencePool, the BlockSyncReactor and the mempool's
EngineTxPreVerifier) on the card unless the caller passes device="cpu".
The state provider's light client, which `_run_statesync` builds when
statesync.enable is set on a node at height 0, takes the node's `device`
too. The node wires the file signer or a remote one (privval/remote.py
over a socket, privval/grpc.py over gRPC), the builtin kvstore (with its
snapshots) or an app behind the socket or gRPC client (abci/socket.py,
abci/grpc.py), the kv, sqlite and psql event sinks, the flight recorder
(metrics/flight.py) and state sync's reactor on its four channels. What
the port has not reached yet raises an error that names the item that
brings it (NotYetPorted), never a quiet substitute: the bank app (A15c)
and the e2e tooling's environment knobs. `stop()` closes the WAL only
once the consensus thread has ended.
"""

from __future__ import annotations

import json
import os
import threading
import time
from urllib.parse import urlparse

from ..abci import LocalClient
from ..blocksync import BlockSyncReactor, blocksync_channel_descriptor
from ..config import Config
from ..consensus import WAL, ConsensusState, Handshaker
from ..consensus.reactor import ConsensusReactor, consensus_channel_descriptors
from ..crypto.batch import is_fault
from ..crypto.ed25519 import Ed25519PrivKey
from ..eventbus import EventBus
from ..evidence import EvidencePool
from ..evidence.reactor import EvidenceReactor, evidence_channel_descriptor
from ..indexer import IndexerService, KVIndexer
from ..light.provider import LocalProvider
from ..mempool.mempool import TxMempool
from ..mempool.reactor import MempoolReactor, mempool_channel_descriptor
from ..p2p import NodeInfo, PeerManager, PeerManagerOptions, Router, RouterOptions, node_id_from_pubkey
from ..p2p.transport import Endpoint, parse_peer_list
from ..p2p.transport_tcp import TcpTransport
from ..privval import FilePV
from ..rpc import JSONRPCServer, RPCEnvironment, build_routes
from ..state import BlockExecutor, StateStore, make_genesis_state
from ..store.blockstore import BlockStore
from ..store.kv import FileDB, MemDB
from ..types.genesis import GenesisDoc


class NotYetPorted(NotImplementedError):
    """A setting whose module the port has not reached yet: the message
    names the ROADMAP item that brings it."""


def not_yet(what: str, item: str) -> NotYetPorted:
    return NotYetPorted(f"{what} comes with ROADMAP {item} of the PyTorch/CUDA port")


# environment knobs of the reference's e2e tooling, which the port has not queued
TOOLING_ENV = ("TM_E2E_DELAYS_MS", "TM_TPU_LOCKCHECK", "TM_TPU_RACECHECK", "TM_TPU_BYZ", "TM_TPU_PROF")


def check_tooling_env(names=TOOLING_ENV) -> None:
    for name in names:
        if os.environ.get(name):
            raise not_yet(f"{name} (the e2e tooling: sanitizers, byzantine roles, delays, the profiler)",
                          "tooling, not queued")


class NodeKey:
    """P2P identity key (ref: types/node_key.go)."""

    def __init__(self, priv_key: Ed25519PrivKey):
        self.priv_key = priv_key
        self.node_id = node_id_from_pubkey(priv_key.pub_key())

    @classmethod
    def load_or_gen(cls, path: str) -> "NodeKey":
        if os.path.exists(path):
            with open(path) as f:
                doc = json.load(f)
            return cls(Ed25519PrivKey(bytes.fromhex(doc["priv_key"])))
        key = Ed25519PrivKey.generate()
        nk = cls(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            json.dump({"id": nk.node_id, "priv_key": key.bytes().hex()}, f)
        return nk


def _make_db(config: Config, name: str):
    if config.base.db_backend == "memdb":
        return MemDB()
    os.makedirs(config.db_dir, exist_ok=True)
    return FileDB(os.path.join(config.db_dir, f"{name}.db"))


def _make_app(proxy_app: str, app_db=None):
    """ref: internal/proxy/client.go:26 ClientFactory. kvstore, builtin,
    builtin:kvstore[:snapshot=N][:retain=M] map to abci/kvstore.py (app
    state in `app_db`, the node's FileDB, so a restarted node handshakes
    from the app's committed height; snapshot = the app's snapshot
    interval), noop / builtin:noop to BaseApplication; builtin:bank raises
    NotYetPorted. tcp:// and unix:// addresses dial an external app over
    the socket ABCI transport (abci/socket.py), grpc:// over gRPC
    (abci/grpc.py)."""
    check_tooling_env(("TM_E2E_DELAYS_MS",))
    from ..abci.kvstore import KVStoreApplication

    def _kvstore(**kw):
        if app_db is not None:
            kw["db"] = app_db
        return KVStoreApplication(**kw)

    if proxy_app.startswith("builtin:") and not proxy_app.startswith("builtin:noop"):
        parts = proxy_app.split(":")[1:]  # [name, opt, opt...]
        name, kw = parts[0], {}
        opt_names = {"snapshot": "snapshot_interval", "retain": "retain_blocks",
                     "accounts": "genesis_accounts"}
        for opt in parts[1:]:
            k, _, v = opt.partition("=")
            if k not in opt_names:
                raise ValueError(f"unknown builtin app option {opt!r} in {proxy_app!r}")
            kw[opt_names[k]] = int(v)
        if name == "bank":
            raise not_yet("the bank app (statetree/)", "A15c")
        if name != "kvstore":
            raise ValueError(f"unknown app {name!r} (expected one of ('kvstore', 'bank'))")
        if "genesis_accounts" in kw:
            raise ValueError("genesis_accounts is a bank-app knob")
        return LocalClient(_kvstore(**kw))
    if proxy_app in ("kvstore", "builtin"):
        return LocalClient(_kvstore())
    if proxy_app in ("noop", "builtin:noop"):
        from ..abci.types import BaseApplication

        return LocalClient(BaseApplication())
    if proxy_app.startswith(("tcp://", "unix://")):
        from ..abci.socket import SocketClient

        client = SocketClient(proxy_app)
        client.start()
        return client
    if proxy_app.startswith("grpc://"):
        from ..abci.grpc import GRPCClient

        client = GRPCClient(proxy_app)
        client.start()
        return client
    raise ValueError(f"unsupported proxy_app {proxy_app!r}")


class Node:
    """ref: node.nodeImpl (node/node.go:57)."""

    def __init__(
        self,
        config: Config,
        gen_doc: GenesisDoc | None = None,
        app_client=None,
        priv_validator=None,
        node_key: NodeKey | None = None,
        device=None,
    ):
        from ..metrics import (
            BlockSyncMetrics,
            ConsensusMetrics,
            EvidenceMetrics,
            MempoolMetrics,
            P2PMetrics,
            PrometheusServer,
            Registry,
            StateMetrics,
            StateSyncMetrics,
        )
        from ..utils.log import Logger, parse_level

        self.config = config
        config.validate_basic()
        self.device = device

        # ---- observability (ref: node/node.go:575 Prometheus; libs/log)
        self.metrics_registry = Registry()
        self.consensus_metrics = ConsensusMetrics(self.metrics_registry)
        self.mempool_metrics = MempoolMetrics(self.metrics_registry)
        self.p2p_metrics = P2PMetrics(self.metrics_registry)
        self.state_metrics = StateMetrics(self.metrics_registry)
        self.blocksync_metrics = BlockSyncMetrics(self.metrics_registry)
        self.statesync_metrics = StateSyncMetrics(self.metrics_registry)
        self.evidence_metrics = EvidenceMetrics(self.metrics_registry)
        self.prometheus_server = (
            PrometheusServer(self.metrics_registry, config.instrumentation.prometheus_listen_addr)
            if config.instrumentation.prometheus
            else None
        )
        # In-run flight recorder (metrics/flight.py): streams delta
        # records to <home>/timeseries.jsonl so rates-over-time survive
        # a SIGKILL. Disabled (the default) nothing is constructed —
        # the zero-cost path really is zero.
        self.flight_recorder = None
        if config.instrumentation.flight_interval > 0 and config.base.home:
            from ..metrics import FlightMetrics, global_registry
            from ..metrics.flight import TIMESERIES_NAME, FlightRecorder

            # tmdev: when the device observatory is live, its HBM-
            # residency sampler rides the recorder's cadence so the
            # live-buffer timeline (and the device_mem_growth verdict
            # built on it) survives SIGKILL. Off: empty sampler list,
            # flight.py stays devobs-free (import isolation).
            from .. import devobs

            samplers = [devobs.sample_residency] if devobs.enabled() else []
            self.flight_recorder = FlightRecorder(
                [self.metrics_registry, global_registry()],
                os.path.join(config.base.home, TIMESERIES_NAME),
                interval=config.instrumentation.flight_interval,
                metrics=FlightMetrics(self.metrics_registry),
                samplers=samplers,
            )
        self.logger = Logger(level=parse_level(config.base.log_level),
                             fmt=config.base.log_format).with_fields(
            module="node"
        )
        self._halted = threading.Event()
        self.halt_reason: BaseException | None = None

        # ---- genesis + state (node/node.go:691 loadStateFromDBOrGenesisDocProvider)
        self.gen_doc = gen_doc if gen_doc is not None else GenesisDoc.from_file(config.genesis_file)
        self.state_store = StateStore(_make_db(config, "state"))
        self.block_store = BlockStore(_make_db(config, "blockstore"))
        state = self.state_store.load()
        if state is None:
            state = make_genesis_state(self.gen_doc)
            self.state_store.save(state)

        # ---- app + handshake prerequisites (node/node.go:159)
        if app_client is not None:
            self.app_client = app_client
        else:
            # builtin apps persist their state next to the node's other
            # dbs — a kill+restart under retain_blocks pruning must
            # handshake from the app's committed height, not replay a
            # genesis the blockstore no longer has
            builtin = config.base.proxy_app.split(":", 1)[0] in ("builtin", "kvstore") \
                and "noop" not in config.base.proxy_app
            self.app_client = _make_app(
                config.base.proxy_app,
                app_db=_make_db(config, "app") if builtin else None,
            )
        # in-process apps with an authenticated state plane (bank's
        # statetree) report dirty-path sizes / rehash latencies into the
        # node's tendermint_state_* series
        _app = getattr(self.app_client, "_app", None)
        if _app is not None and hasattr(_app, "set_state_metrics"):
            _app.set_state_metrics(self.state_metrics)
        from ..eventbus.eventlog import EventLog

        self.event_bus = EventBus(event_log=EventLog())
        # Event sinks (ref: EventSinksFromConfig, node/setup.go): "kv",
        # "sqlite" (in-process SQL), and/or "psql" (a real Postgres via
        # config.tx_index.psql_conn, ref: config.go TxIndexConfig.PsqlConn),
        # comma-separated.
        self.indexer = None
        self.sql_sinks = []  # every SQL-backed sink, closed on stop
        sinks = []
        for name in filter(None, (s.strip() for s in config.tx_index.indexer.split(","))):
            if name == "kv":
                self.indexer = KVIndexer(_make_db(config, "tx_index"))
                sinks.append(self.indexer)
            elif name == "sqlite":
                from ..indexer.sink_sql import SQLSink

                os.makedirs(config.db_dir, exist_ok=True)
                self.sql_sinks.append(SQLSink(
                    os.path.join(config.db_dir, "events.sqlite"), self.gen_doc.chain_id
                ))
                sinks.append(self.sql_sinks[-1])
            elif name == "psql":
                from ..indexer.sink_psql import PsqlSink

                dsn = getattr(config.tx_index, "psql_conn", "")
                if not dsn:
                    raise ValueError(
                        "tx_index.indexer 'psql' requires `psql-conn` in the "
                        "[tx-index] section (ref: config.go TxIndexConfig.PsqlConn)"
                    )
                self.sql_sinks.append(PsqlSink(dsn, self.gen_doc.chain_id))
                sinks.append(self.sql_sinks[-1])
            elif name in ("null", "none"):
                continue
            else:
                raise ValueError(f"unsupported tx_index.indexer {name!r}")
        self.sql_sink = self.sql_sinks[0] if self.sql_sinks else None
        self.indexer_service = IndexerService(sinks, self.event_bus) if sinks else None

        # ---- privval (node/setup.go:489: file | socket | grpc remote signer)
        self.privval_endpoint = None
        if priv_validator is not None:
            self.priv_validator = priv_validator
        elif (
            config.base.mode == "validator"
            and config.base.priv_validator_laddr.startswith("grpc://")
        ):
            from ..privval.grpc import GRPCSignerClient

            self.priv_validator = GRPCSignerClient(
                config.base.priv_validator_laddr, self.gen_doc.chain_id
            )
        elif config.base.mode == "validator" and config.base.priv_validator_laddr:
            from ..privval.remote import SignerClient, SignerListenerEndpoint

            self.privval_endpoint = SignerListenerEndpoint(
                config.base.priv_validator_laddr,
                logger=self.logger.with_fields(module="privval"),
            )
            self.privval_endpoint.start()
            self.priv_validator = SignerClient(self.privval_endpoint, self.gen_doc.chain_id)
        elif config.base.mode == "validator":
            self.priv_validator = FilePV.load_or_generate(
                config.priv_validator_key_file, config.priv_validator_state_file
            )
        else:
            self.priv_validator = None

        # ---- p2p identity + transport + router (node/setup.go:201,290)
        self.node_key = node_key if node_key is not None else NodeKey.load_or_gen(config.node_key_file)
        self.node_id = self.node_key.node_id
        from ..statesync import statesync_channel_descriptors

        from ..p2p.pex import PexReactor, pex_channel_descriptor

        # consensus frames carry this node's id as the tmpath journey
        # origin (field-1001 local extension; docs/observability.md#tmpath)
        cs_descs = consensus_channel_descriptors(
            origin_node=self.node_id, metrics=self.consensus_metrics
        )
        descs = (
            cs_descs
            + [mempool_channel_descriptor(), evidence_channel_descriptor(), blocksync_channel_descriptor()]
            + statesync_channel_descriptors()
        )
        if config.p2p.pex:
            descs.append(pex_channel_descriptor())
        laddr = urlparse(config.p2p.laddr if "//" in config.p2p.laddr else "tcp://" + config.p2p.laddr)
        self.transport = TcpTransport(
            descs,
            bind_host=laddr.hostname or "0.0.0.0",
            bind_port=laddr.port or 0,
            send_rate=config.p2p.send_rate,
            recv_rate=config.p2p.recv_rate,
            ping_interval=config.p2p.ping_interval,
            pong_timeout=config.p2p.pong_timeout,
        )
        persistent = parse_peer_list(config.p2p.persistent_peers)
        self.peer_manager = PeerManager(
            self.node_id,
            PeerManagerOptions(
                persistent_peers=[e.node_id for e in persistent],
                max_connected=config.p2p.max_connections,
                private_peers=set(filter(None, config.p2p.private_peer_ids.split(","))),
            ),
            db=_make_db(config, "peerstore"),
            metrics=self.p2p_metrics,
        )
        for ep in persistent:
            self.peer_manager.add(ep)
        # bootstrap peers (typically seed nodes): dialed for PEX
        # discovery but NOT pinned as persistent — the peer manager may
        # drop them once the mesh is known (ref: config.P2P
        # BootstrapPeers, node/setup.go peer wiring)
        for ep in parse_peer_list(config.p2p.bootstrap_peers):
            self.peer_manager.add(ep)
        ep = self.transport.endpoint()
        # Advertise external_address when configured — the bind address
        # (e.g. 0.0.0.0) is not dialable by peers (ref: config.p2p
        # ExternalAddress, config/config.go).
        advertised = config.p2p.external_address or f"{ep.host}:{ep.port}"
        if "://" in advertised:
            advertised = advertised.split("://", 1)[1]
        self.node_info = NodeInfo(
            node_id=self.node_id,
            listen_addr=advertised,
            network=self.gen_doc.chain_id,
            moniker=config.base.moniker,
            rpc_address=config.rpc.laddr,
        )
        self.router = Router(
            self.node_info, self.node_key.priv_key, self.peer_manager, [self.transport],
            options=RouterOptions(queue_type=config.p2p.queue_type),
            metrics=self.p2p_metrics,
        )
        cs_chs = [self.router.open_channel(d) for d in cs_descs]
        mp_ch = self.router.open_channel(mempool_channel_descriptor())
        ev_ch = self.router.open_channel(evidence_channel_descriptor())
        bs_ch = self.router.open_channel(blocksync_channel_descriptor())
        ss_chs = [self.router.open_channel(d) for d in statesync_channel_descriptors()]

        # ---- PEX (node/node.go:346; internal/p2p/pex/reactor.go)
        self.pex_reactor = None
        if config.p2p.pex:
            pex_ch = self.router.open_channel(pex_channel_descriptor())
            self.pex_reactor = PexReactor(
                self.peer_manager, pex_ch, logger=self.logger.with_fields(module="pex")
            )

        # ---- pools + executor (node/setup.go:142,177; node/node.go:276)
        pre_verify = None
        if config.mempool.precheck_sigs:
            from ..mempool.preverify import EngineTxPreVerifier

            pre_verify = EngineTxPreVerifier(device=device)
        self.mempool = TxMempool(
            self.app_client,
            size=config.mempool.size,
            max_txs_bytes=config.mempool.max_txs_bytes,
            cache_size=config.mempool.cache_size,
            max_tx_bytes=config.mempool.max_tx_bytes,
            keep_invalid_txs_in_cache=config.mempool.keep_invalid_txs_in_cache,
            ttl_duration=config.mempool.ttl_duration,
            ttl_num_blocks=config.mempool.ttl_num_blocks,
            metrics=self.mempool_metrics,
            # PostCheckMaxGas analog (node.go wires it from consensus
            # params); refreshed after each commit in BlockExecutor
            max_gas=state.consensus_params.block.max_gas,
            pre_verify=pre_verify,
        )
        self.evidence_pool = EvidencePool(
            _make_db(config, "evidence"), self.state_store, self.block_store,
            metrics=self.evidence_metrics, device=device,
        )
        self.block_executor = BlockExecutor(
            self.state_store,
            self.app_client,
            mempool=self.mempool,
            evidence_pool=self.evidence_pool,
            block_store=self.block_store,
            event_publisher=self.event_bus.block_event_publisher(),
            metrics=self.state_metrics,
            device=device,
        )

        # ---- consensus (node/node.go:300,316)
        wal = WAL(config.wal_file)
        self.consensus = ConsensusState(
            state,
            self.block_executor,
            self.block_store,
            priv_validator=self.priv_validator,
            wal=wal,
            evidence_pool=self.evidence_pool,
            metrics=self.consensus_metrics,
            logger=self.logger.with_fields(module="consensus"),
            on_fatal=self._on_fatal,
            wait_for_txs=not config.consensus.create_empty_blocks,
            create_empty_blocks_interval=config.consensus.create_empty_blocks_interval,
            mempool=self.mempool,
            double_sign_check_height=config.consensus.double_sign_check_height,
        )
        # journey keys for events this node originates (proposal build)
        # carry its p2p id (docs/observability.md#tmpath)
        self.consensus.node_id = self.node_id
        if not config.consensus.create_empty_blocks:
            self.mempool.enable_txs_available()
            self._txs_watcher = threading.Thread(
                target=self._watch_txs_available, daemon=True, name="txs-available"
            )
        else:
            self._txs_watcher = None
        self.consensus_reactor = ConsensusReactor(
            self.consensus, cs_chs[0], cs_chs[1], cs_chs[2], cs_chs[3], self.peer_manager, self.block_store
        )
        self.mempool_reactor = MempoolReactor(self.mempool, mp_ch, self.peer_manager, on_fatal=self._on_fatal)
        self.evidence_reactor = EvidenceReactor(self.evidence_pool, ev_ch, self.peer_manager,
                                                on_fatal=self._on_fatal)

        # ---- blocksync (node/node.go:329)
        self._initial_state = state
        self.blocksync_reactor = BlockSyncReactor(
            state,
            self.block_executor,
            self.block_store,
            bs_ch,
            self.peer_manager,
            on_caught_up=self._on_blocksync_done,
            block_sync=self._should_blocksync(state),
            on_fatal=self._on_fatal,
            metrics=self.blocksync_metrics,
            device=device,
        )

        # ---- statesync (node/node.go:352-377): always serves snapshots/
        # light blocks to peers; consumes when config.statesync.enable
        from ..statesync import StateSyncReactor

        self.local_provider = LocalProvider(self.gen_doc.chain_id, self.block_store, self.state_store)
        self.statesync_reactor = StateSyncReactor(
            self.app_client,
            self.state_store,
            self.block_store,
            ss_chs[0], ss_chs[1], ss_chs[2], ss_chs[3],
            self.peer_manager,
            local_provider=self.local_provider,
            metrics=self.statesync_metrics,
        )

        # ---- RPC (node/node.go:509)
        self.rpc_server = None
        self.rpc_env = None
        if config.rpc.enable:
            rpc_addr = urlparse(config.rpc.laddr if "//" in config.rpc.laddr else "tcp://" + config.rpc.laddr)
            env = self.rpc_env = RPCEnvironment(
                chain_id=self.gen_doc.chain_id,
                state_store=self.state_store,
                block_store=self.block_store,
                consensus_state=self.consensus,
                mempool=self.mempool,
                evidence_pool=self.evidence_pool,
                event_bus=self.event_bus,
                tx_indexer=self.indexer,
                app_client=self.app_client,
                gen_doc=self.gen_doc,
                peer_manager=self.peer_manager,
                node_info=self.node_info,
                pub_key=self.priv_validator.get_pub_key() if self.priv_validator else None,
                router=self.router,
                unsafe=self.config.rpc.unsafe,
                flight_recorder=self.flight_recorder,
                on_fatal=self._on_fatal,
            )
            self.rpc_server = JSONRPCServer(
                build_routes(env),
                host=rpc_addr.hostname or "127.0.0.1",
                port=rpc_addr.port or 0,
                event_bus=self.event_bus,
                max_body_bytes=config.rpc.max_body_bytes,
                max_subscription_clients=config.rpc.max_subscription_clients,
                max_subscriptions_per_client=config.rpc.max_subscriptions_per_client,
                cors_allowed_origins=tuple(
                    o.strip() for o in config.rpc.cors_allowed_origins.split(",") if o.strip()
                ),
            )

        self._started = threading.Event()
        self._consensus_running = threading.Event()

    # ------------------------------------------------------------ lifecycle

    def _watch_txs_available(self) -> None:
        """Forward mempool tx-available signals to consensus
        (ref: node wiring of TxsAvailable, consensus/state.go:1143)."""
        while not self._halted.is_set():
            try:
                if self.mempool.wait_txs_available(timeout=0.2):
                    self.consensus.handle_txs_available()
                    time.sleep(0.05)  # signal latches until next height
            except Exception as e:
                # block production depends on this thread when
                # create_empty_blocks=false — never die silently
                self.logger.error("txs-available watcher error", err=str(e))
                time.sleep(0.5)

    def _should_blocksync(self, state) -> bool:
        """Skip blocksync when we're the only validator
        (ref: node/setup.go:134 onlyValidatorIsUs)."""
        if not self.config.blocksync.enable:
            return False
        if self.priv_validator is None:
            return True
        if state.validators.size() != 1:
            return True
        addr = self.priv_validator.get_pub_key().address()
        _, val = state.validators.get_by_address(addr)
        return val is None

    def start(self) -> None:
        """ref: OnStart ordering (node/node.go:403-520)."""
        if self.indexer_service is not None:
            self.indexer_service.start()
        if self.prometheus_server is not None:
            self.prometheus_server.start()
        if self.flight_recorder is not None:
            self.flight_recorder.start()

        # ABCI handshake: sync the app to the stores (node/node.go:430)
        hs = Handshaker(
            self.state_store, self._initial_state, self.block_store, self.gen_doc,
            event_publisher=self.event_bus.block_event_publisher(), device=self.device,
        )
        state = hs.handshake(self.app_client)
        self._initial_state = state
        self.consensus.update_to_state(state)
        # tmcheck: ok[shared-mutation] boot/statesync handoff: the reactor's routines are not running yet when these anchors are (re)set
        self.blocksync_reactor.state = state
        # Handshake replay may have advanced state past what the reactor
        # saw at construction (crash between blockstore and state saves);
        # re-anchor the pool so it doesn't re-request an applied height
        # (the statesync path below resets it the same way).
        self.blocksync_reactor.pool.reanchor(
            max(state.last_block_height + 1, state.initial_height)
        )

        self.router.start()
        self.evidence_reactor.start()
        self.mempool_reactor.start()
        self.consensus_reactor.start()
        self.statesync_reactor.start()
        if self.pex_reactor is not None:
            self.pex_reactor.start()
        if self._txs_watcher is not None:
            self._txs_watcher.start()
        if self.config.statesync.enable and state.last_block_height == 0:
            threading.Thread(target=self._run_statesync, daemon=True, name="statesync").start()
        elif self.blocksync_reactor.block_sync:
            self.blocksync_reactor.start()
        else:
            self._start_consensus()
        if self.rpc_server is not None:
            self.rpc_server.start()
        self._started.set()

    def _run_statesync(self) -> None:
        """Statesync → blocksync → consensus (node/node.go:360-377). The
        light client verifies on the node's device. A failure falls back to
        blocksync from genesis, as in the reference, except a fault of the
        verifier, which halts the node (`_on_fatal`)."""
        import traceback

        from ..light import LightClient, TrustOptions
        from ..light.http_provider import HTTPProvider
        from ..statesync.stateprovider import LightClientStateProvider

        cfg = self.config.statesync
        try:
            servers = [s.strip() for s in cfg.rpc_servers.split(",") if s.strip()]
            if not cfg.trust_hash:
                raise ValueError("statesync requires trust_hash")
            trust = TrustOptions(
                period_ns=int(cfg.trust_period * 1e9),
                height=cfg.trust_height,
                hash=bytes.fromhex(cfg.trust_hash),
            )
            params_fetcher = None
            if servers:
                primary = HTTPProvider(self.gen_doc.chain_id, servers[0])
                witnesses = [HTTPProvider(self.gen_doc.chain_id, s) for s in servers[1:]]
            else:
                # p2p mode (ref: config statesync.use-p2p + the p2p state
                # provider, stateprovider.go): light blocks and consensus
                # params come from peers over the statesync channels
                from ..statesync.dispatcher import Dispatcher, P2PLightProvider

                dispatcher = Dispatcher(self.statesync_reactor)
                primary = P2PLightProvider(
                    self.gen_doc.chain_id, dispatcher, self.peer_manager.peers
                )
                witnesses = []
                # the light client fetches its trust root at once: wait for
                # a peer first, within the snapshot search's window
                deadline = time.monotonic() + cfg.discovery_time
                while time.monotonic() < deadline and not self.peer_manager.peers():
                    if self._halted.is_set():
                        return
                    time.sleep(0.1)

                def params_fetcher(height, _d=dispatcher):
                    # a failure aborts the sync (to blocksync from genesis)
                    # rather than restoring with genesis params, which an
                    # on-chain update would fork from
                    return _d.consensus_params(height, self.peer_manager.peers())
            lc = LightClient(self.gen_doc.chain_id, trust, primary, witnesses=witnesses, device=self.device)
            sp = LightClientStateProvider(lc, self.gen_doc, params_fetcher=params_fetcher)
            state, _commit = self.statesync_reactor.sync(sp, self.gen_doc, discovery_time=cfg.discovery_time)
            self.statesync_reactor.backfill(state, lambda h: self._fetch_lb_quiet(primary, h))
            self.consensus.update_to_state(state)
            self.blocksync_reactor.state = state
            self.blocksync_reactor.pool.reanchor(state.last_block_height + 1)
            self.blocksync_reactor.start()
        except Exception as e:
            if is_fault(e):
                self._on_fatal(e)
                return
            traceback.print_exc()
            # fall back to blocksync-from-genesis
            if self.blocksync_reactor.block_sync:
                self.blocksync_reactor.start()
            else:
                self._start_consensus()

    @staticmethod
    def _fetch_lb_quiet(provider, height: int):
        try:
            return provider.light_block(height)
        except Exception:
            return None

    def _on_blocksync_done(self, state, blocks_synced: int) -> None:
        """ref: node/node.go:360-377 + SwitchToConsensus
        (consensus/reactor.go:256): the last commit must be rebuilt from
        the SYNCED chain before updateToState — any set reconstructed at
        boot predates the sync (and on a vote-extension chain the
        extended commit blocksync just persisted is the only valid
        source)."""
        self.consensus.switch_to_state(state)
        self._start_consensus()

    def _start_consensus(self) -> None:
        if not self._consensus_running.is_set():
            self._consensus_running.set()
            self.consensus.start()

    def _on_fatal(self, exc: BaseException) -> None:
        """Fatal subsystem failure (consensus state machine, blocksync
        apply; in the port also a verifier fault that the mempool and
        evidence reactors or an RPC route met): halt the whole node —
        router, RPC, mempool must not keep serving from a dead engine
        (ref: state.go:899-938 re-panics to stop the process; blocksync
        poolRoutine panics on apply error). The first fault halts it; a
        later one (the same fault met by another layer) is only logged."""
        if self._halted.is_set():
            self.logger.error("fatal failure on a halted node", err=repr(exc))
            return
        self.halt_reason = exc
        self._halted.set()
        self.logger.error("halting node on fatal failure", err=repr(exc))
        threading.Thread(target=self.stop, daemon=True, name="node-halt").start()

    @property
    def halted(self) -> bool:
        return self._halted.is_set()

    def stop(self) -> None:
        self._halted.set()  # stops the txs-available watcher too
        if self._consensus_running.is_set():
            self.consensus.stop()
        if hasattr(self.priv_validator, "stop"):
            self.priv_validator.stop()  # gRPC signer client channel
        if self.privval_endpoint is not None:
            self.privval_endpoint.stop()
        if self.pex_reactor is not None:
            self.pex_reactor.stop()
        self.blocksync_reactor.stop()
        self.statesync_reactor.stop()
        self.consensus_reactor.stop()
        self.mempool_reactor.stop()
        self.evidence_reactor.stop()
        self.router.stop()
        if self.rpc_server is not None:
            self.rpc_server.stop()
        if self.indexer_service is not None:
            self.indexer_service.stop()
        if self.prometheus_server is not None:
            self.prometheus_server.stop()
        if self.flight_recorder is not None:
            self.flight_recorder.stop()  # final sample lands in the timeline
        # closed by the consensus thread on its way out if stop()'s join
        # gave up while it still handled a message
        self.consensus.close_wal()
        for sink in self.sql_sinks:
            sink.close()

    # -------------------------------------------------------------- helpers

    @property
    def rpc_address(self) -> tuple[str, int] | None:
        return self.rpc_server.address if self.rpc_server else None

    @property
    def p2p_endpoint(self) -> Endpoint:
        ep = self.transport.endpoint()
        return Endpoint(protocol="mconn", host=ep.host, port=ep.port, node_id=self.node_id)

    def dial(self, other: "Node") -> None:
        self.peer_manager.add(other.p2p_endpoint)
