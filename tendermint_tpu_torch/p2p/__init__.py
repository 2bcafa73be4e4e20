"""The port's host-side P2P stack (ref: internal/p2p/), the layer blocksync
and the consensus, mempool and evidence reactors run on.

A copy of the JAX package's p2p/: peers meet over TCP, each link behind a
secret connection (ephemeral X25519, HKDF-SHA256, ChaCha20-Poly1305 frames,
the ed25519 auth signature checked on the host), or over the in-process
MemoryNetwork; the PEX reactor completes the mesh from one known address.
Nothing here runs device code or takes `device`; the objects the reactors
feed do.

  types.py             Envelope / PeerError / ChannelDescriptor / PeerUpdate /
                       NodeInfo and the channel IDs
  channel.py           typed duplex pipe per protocol  (internal/p2p/channel.go)
  transport.py         Endpoint, Transport/Connection  (internal/p2p/transport.go)
  transport_memory.py  in-process network              (internal/p2p/transport_memory.go)
  transport_tcp.py     TCP + MConnection-style framing (internal/p2p/transport_mconn.go)
  secret_connection.py STS authenticated encryption    (internal/p2p/conn/secret_connection.go)
  pex.py               peer exchange, channel 0x00     (internal/p2p/pex/reactor.go)
  conn_tracker.py      per-IP inbound limits           (internal/p2p/conn_tracker.go)
  peermanager.py       peer lifecycle + scoring        (internal/p2p/peermanager.go)
  router.py            envelope routing                (internal/p2p/router.go)
"""

from .types import (
    ChannelDescriptor,
    Envelope,
    NodeInfo,
    PeerError,
    PeerUpdate,
    PEER_STATUS_UP,
    PEER_STATUS_DOWN,
    node_id_from_pubkey,
    validate_node_id,
)
from .channel import Channel
from .conn_tracker import ConnTracker
from .transport import Connection, Endpoint, Transport
from .transport_memory import MemoryNetwork, MemoryTransport
from .peermanager import PeerManager, PeerManagerOptions
from .router import Router, RouterOptions
from .secret_connection import SecretConnection
from .transport_tcp import TcpConnection, TcpTransport
from .pex import PexReactor, pex_channel_descriptor

__all__ = [
    "Channel",
    "ChannelDescriptor",
    "Connection",
    "ConnTracker",
    "Endpoint",
    "Envelope",
    "MemoryNetwork",
    "MemoryTransport",
    "NodeInfo",
    "PeerError",
    "PeerManager",
    "PeerManagerOptions",
    "PeerUpdate",
    "PEER_STATUS_UP",
    "PEER_STATUS_DOWN",
    "PexReactor",
    "Router",
    "RouterOptions",
    "SecretConnection",
    "TcpConnection",
    "TcpTransport",
    "Transport",
    "node_id_from_pubkey",
    "pex_channel_descriptor",
    "validate_node_id",
]
