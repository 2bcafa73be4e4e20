"""Seed node — p2p layer + PEX reactor only (ref: node/seed.go).

A seed exists to bootstrap a network: it crawls addresses via PEX and
serves its address book to anyone who dials it. It runs no consensus, no
stores, no ABCI app — just the router, peer manager, and PEX.
"""

from __future__ import annotations

from urllib.parse import urlparse

from ..config import Config
from ..p2p import NodeInfo, PeerManager, PeerManagerOptions, Router, RouterOptions
from ..p2p.pex import PexReactor, pex_channel_descriptor
from ..p2p.transport import Endpoint, parse_peer_list
from ..p2p.transport_tcp import TcpTransport
from ..types.genesis import GenesisDoc
from ..utils.log import Logger, parse_level
from .node import NodeKey, _make_db


class SeedNode:
    """ref: node/seed.go makeSeedNode / seedNodeImpl."""

    def __init__(
        self,
        config: Config,
        gen_doc: GenesisDoc | None = None,
        node_key: NodeKey | None = None,
    ):
        config.validate_basic()  # same gate as Node (node/node.py)
        if not config.p2p.pex:
            raise ValueError("cannot run seed nodes with PEX disabled")
        self.config = config
        self.gen_doc = gen_doc if gen_doc is not None else GenesisDoc.from_file(config.genesis_file)
        self.logger = Logger(level=parse_level(config.base.log_level),
                             fmt=config.base.log_format).with_fields(module="seed")

        self.node_key = node_key if node_key is not None else NodeKey.load_or_gen(config.node_key_file)
        self.node_id = self.node_key.node_id

        descs = [pex_channel_descriptor()]
        laddr = urlparse(config.p2p.laddr if "//" in config.p2p.laddr else "tcp://" + config.p2p.laddr)
        self.transport = TcpTransport(descs, bind_host=laddr.hostname or "0.0.0.0", bind_port=laddr.port or 0)

        persistent = parse_peer_list(config.p2p.persistent_peers)
        self.peer_manager = PeerManager(
            self.node_id,
            PeerManagerOptions(
                persistent_peers=[e.node_id for e in persistent],
                # seeds hold many addresses but few connections; keep
                # connection slots open for bootstrapping clients
                max_connected=config.p2p.max_connections,
                private_peers=set(filter(None, config.p2p.private_peer_ids.split(","))),
            ),
            db=_make_db(config, "peerstore"),
        )
        for ep in persistent:
            self.peer_manager.add(ep)

        ep = self.transport.endpoint()
        advertised = config.p2p.external_address or f"{ep.host}:{ep.port}"
        if "://" in advertised:
            advertised = advertised.split("://", 1)[1]
        self.node_info = NodeInfo(
            node_id=self.node_id,
            listen_addr=advertised,
            network=self.gen_doc.chain_id,
            moniker=config.base.moniker,
        )
        self.router = Router(
            self.node_info, self.node_key.priv_key, self.peer_manager, [self.transport],
            options=RouterOptions(),
        )
        pex_ch = self.router.open_channel(pex_channel_descriptor())
        self.pex_reactor = PexReactor(self.peer_manager, pex_ch, logger=self.logger)

    # ------------------------------------------------------------ lifecycle

    def start(self) -> None:
        self.logger.info("starting seed node", node_id=self.node_id)
        self.router.start()
        self.pex_reactor.start()

    def stop(self) -> None:
        self.pex_reactor.stop()
        self.router.stop()

    def endpoint(self) -> Endpoint:
        """Dialable address of this seed."""
        ep = self.transport.endpoint()
        return Endpoint(protocol=ep.protocol, host=ep.host, port=ep.port, node_id=self.node_id)
