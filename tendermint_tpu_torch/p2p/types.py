"""P2P core types (ref: internal/p2p/p2p.go, types/node_id.go,
types/node_info.go).

NodeID = lowercase hex of the 20-byte address hash of the node's ed25519
pubkey (types/node_id.go: NodeIDFromPubKey). Envelopes wrap a message
with routing metadata; ChannelDescriptors register a channel ID with a
priority and codec.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, Callable

NODE_ID_BYTE_LENGTH = 20
_NODE_ID_RE = re.compile(r"^[0-9a-f]{40}$")

PEER_STATUS_UP = "up"
PEER_STATUS_DOWN = "down"
PEER_STATUS_GOOD = "good"
PEER_STATUS_BAD = "bad"


def node_id_from_pubkey(pub_key) -> str:
    """ref: types/node_id.go NodeIDFromPubKey — hex(address(pubkey))."""
    return pub_key.address().hex()


def validate_node_id(node_id: str) -> None:
    if not _NODE_ID_RE.match(node_id):
        raise ValueError(f"invalid node ID {node_id!r} (want 40 lowercase hex chars)")


@dataclass
class Envelope:
    """A routed message (ref: internal/p2p/channel.go:16-27)."""

    message: Any = None
    from_: str = ""  # sender node ID (set by router on receive)
    to: str = ""  # recipient node ID (empty + broadcast=False is invalid on send)
    broadcast: bool = False  # send to all connected peers, ignore To
    channel_id: int = 0


@dataclass
class PeerError:
    """Reactor-reported peer misbehavior → eviction
    (ref: internal/p2p/channel.go:30-35)."""

    node_id: str
    err: Exception | str
    fatal: bool = False


@dataclass
class ChannelDescriptor:
    """Channel registration (ref: internal/p2p/conn/connection.go:628).

    encode/decode translate between in-memory message objects and wire
    bytes; the memory transport bypasses them (a byte transport would
    use them). `message_type` names the proto envelope for diagnostics.
    """

    id: int
    name: str = ""
    priority: int = 1
    send_queue_capacity: int = 64
    recv_message_capacity: int = 1 << 22  # bytes
    recv_buffer_capacity: int = 128
    encode: Callable[[Any], bytes] | None = None
    decode: Callable[[bytes], Any] | None = None


@dataclass
class PeerUpdate:
    """Peer lifecycle notification (ref: internal/p2p/peermanager.go:63)."""

    node_id: str
    status: str  # PEER_STATUS_UP / PEER_STATUS_DOWN
    channels: set[int] = field(default_factory=set)


@dataclass
class ProtocolVersion:
    """ref: types/node_info.go ProtocolVersion."""

    p2p: int = 8
    block: int = 11
    app: int = 0


@dataclass
class NodeInfo:
    """Exchanged during handshake (ref: types/node_info.go:30-70)."""

    node_id: str = ""
    listen_addr: str = ""
    network: str = ""  # chain ID
    version: str = "0.35.0-tpu"
    channels: bytes = b""  # supported channel IDs, one byte each
    moniker: str = ""
    protocol_version: ProtocolVersion = field(default_factory=ProtocolVersion)
    rpc_address: str = ""
    tx_index: str = "on"

    def validate(self) -> None:
        validate_node_id(self.node_id)
        if len(self.channels) > 128:
            raise ValueError("too many channels")

    def compatible_with(self, other: "NodeInfo") -> None:
        """ref: types/node_info.go CompatibleWith — same block protocol,
        same network, at least one common channel."""
        if self.protocol_version.block != other.protocol_version.block:
            raise ValueError(
                f"peer is on a different block protocol: {other.protocol_version.block} != {self.protocol_version.block}"
            )
        if self.network != other.network:
            raise ValueError(f"peer is on a different network: {other.network!r} != {self.network!r}")
        if self.channels and other.channels and not (set(self.channels) & set(other.channels)):
            raise ValueError("no common channels with peer")

    def to_proto(self) -> "pb.NodeInfoProto":
        """tendermint.p2p.NodeInfo wire form (proto/tendermint/p2p/types.proto:15)."""
        from ..proto import messages as pb

        return pb.NodeInfoProto(
            protocol_version=pb.ProtocolVersionProto(
                p2p=self.protocol_version.p2p,
                block=self.protocol_version.block,
                app=self.protocol_version.app,
            ),
            node_id=self.node_id,
            listen_addr=self.listen_addr,
            network=self.network,
            version=self.version,
            channels=self.channels,
            moniker=self.moniker,
            other=pb.NodeInfoOtherProto(tx_index=self.tx_index, rpc_address=self.rpc_address),
        )

    @classmethod
    def from_proto(cls, p) -> "NodeInfo":
        pv = p.protocol_version
        other = p.other
        return cls(
            node_id=p.node_id or "",
            listen_addr=p.listen_addr or "",
            network=p.network or "",
            version=p.version or "",
            channels=p.channels or b"",
            moniker=p.moniker or "",
            protocol_version=ProtocolVersion(
                p2p=(pv.p2p or 0) if pv else 0,
                block=(pv.block or 0) if pv else 0,
                app=(pv.app or 0) if pv else 0,
            ),
            rpc_address=(other.rpc_address or "") if other else "",
            tx_index=(other.tx_index or "on") if other else "on",
        )


# Channel registry (ref: SURVEY §2.5 channel table)
CHANNEL_PEX = 0x00
CHANNEL_CONSENSUS_STATE = 0x20
CHANNEL_CONSENSUS_DATA = 0x21
CHANNEL_CONSENSUS_VOTE = 0x22
CHANNEL_CONSENSUS_VOTE_SET_BITS = 0x23
CHANNEL_MEMPOOL = 0x30
CHANNEL_EVIDENCE = 0x38
CHANNEL_BLOCKSYNC = 0x40
CHANNEL_SNAPSHOT = 0x60
CHANNEL_CHUNK = 0x61
CHANNEL_LIGHT_BLOCK = 0x62
CHANNEL_PARAMS = 0x63
