"""The port's host-side P2P stack (ref: internal/p2p/), the layer blocksync
runs on.

A copy of the JAX package's p2p/ without its TCP transport, secret
connection and PEX (they come with the node's p2p layer): peers meet over
the in-process MemoryNetwork. Nothing here runs device code or takes
`device`; the reactors above it do.

  types.py             Envelope / PeerError / ChannelDescriptor / PeerUpdate /
                       NodeInfo and the channel IDs
  channel.py           typed duplex pipe per protocol  (internal/p2p/channel.go)
  transport.py         Endpoint, Transport/Connection  (internal/p2p/transport.go)
  transport_memory.py  in-process network              (internal/p2p/transport_memory.go)
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
    "Router",
    "RouterOptions",
    "Transport",
    "node_id_from_pubkey",
    "validate_node_id",
]
