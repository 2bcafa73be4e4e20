"""Transport / Connection interfaces (ref: internal/p2p/transport.go:23-191).

A Transport listens for and dials Endpoints, producing Connections. A
Connection moves (channel_id, message) frames after a handshake that
exchanges NodeInfo + node pubkey and authenticates the peer key.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from .types import NodeInfo


@dataclass(frozen=True)
class Endpoint:
    """Network address of a transport endpoint
    (ref: transport.go Endpoint — protocol://node_id@host:port)."""

    protocol: str = "memory"
    host: str = ""
    port: int = 0
    node_id: str = ""  # optional expected peer

    def __str__(self) -> str:
        auth = f"{self.node_id}@" if self.node_id else ""
        if self.protocol == "memory":
            return f"memory:{auth}{self.host}"
        return f"{self.protocol}://{auth}{self.host}:{self.port}"

    @classmethod
    def parse(cls, s: str) -> "Endpoint":
        """Parse `protocol://[id@]host[:port]` / `memory:[id@]id`."""
        if s.startswith("memory:"):
            rest = s[len("memory:"):]
            node_id = ""
            if "@" in rest:
                node_id, rest = rest.split("@", 1)
            return cls(protocol="memory", host=rest, node_id=node_id or rest)
        proto, _, rest = s.partition("://")
        if not rest:
            proto, rest = "mconn", s
        node_id = ""
        if "@" in rest:
            node_id, rest = rest.split("@", 1)
        host, _, port = rest.rpartition(":")
        if not host:
            host, port = rest, "0"
        return cls(protocol=proto, host=host, port=int(port), node_id=node_id)


class Connection:
    """ref: transport.go Connection interface."""

    def handshake(self, node_info: NodeInfo, priv_key, timeout: float | None = None) -> tuple[NodeInfo, Any]:
        """Exchange NodeInfo + pubkey; returns (peer_info, peer_pubkey)."""
        raise NotImplementedError

    def send_message(self, channel_id: int, message) -> None:
        raise NotImplementedError

    def receive_message(self, timeout: float | None = None) -> tuple[int, Any]:
        """Returns (channel_id, message); raises ConnectionClosed on close."""
        raise NotImplementedError

    def local_endpoint(self) -> Endpoint:
        raise NotImplementedError

    def remote_endpoint(self) -> Endpoint:
        raise NotImplementedError

    def close(self) -> None:
        raise NotImplementedError


class ConnectionClosed(Exception):
    pass


class Transport:
    """ref: transport.go Transport interface."""

    protocol: str = ""

    def endpoint(self) -> Endpoint | None:
        raise NotImplementedError

    def accept(self, timeout: float | None = None) -> Connection:
        raise NotImplementedError

    def dial(self, endpoint: Endpoint, timeout: float | None = None) -> Connection:
        raise NotImplementedError

    def close(self) -> None:
        raise NotImplementedError


def parse_peer_list(csv: str) -> "list[Endpoint]":
    """Parse a comma-separated `id@host:port` peer list (config
    persistent_peers / bootstrap_peers format) into Endpoints."""
    out = []
    for entry in filter(None, (s.strip() for s in csv.split(","))):
        out.append(Endpoint.parse("mconn://" + entry if "://" not in entry else entry))
    return out
