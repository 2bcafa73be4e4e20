"""Peer-exchange (PEX) reactor, channel 0x00
(ref: internal/p2p/pex/reactor.go), a copy of the JAX package's p2p/pex.py.

The reactor supports the peer manager: it polls connected peers for
addresses (one request at a time, poll interval widening as the address
book approaches capacity) and serves its own book via
`PeerManager.advertise`. Throttling mirrors the reference: a peer may be
asked again only after it answered; inbound requests are rate-limited per
peer; unsolicited responses and oversized responses are peer errors.
"""

from __future__ import annotations

import threading
import time

from ..proto import messages as pb
from ..utils.log import new_logger
from .peermanager import PeerManager
from .transport import Endpoint
from .types import CHANNEL_PEX, ChannelDescriptor, PEER_STATUS_UP, PeerError

# ref: pex/reactor.go:24-52
MAX_ADDRESSES = 100
MAX_ADDRESS_SIZE = 256
MAX_MSG_SIZE = MAX_ADDRESS_SIZE * 250
MIN_RECEIVE_REQUEST_INTERVAL = 0.1
MIN_POLL_INTERVAL = 2.5 * MIN_RECEIVE_REQUEST_INTERVAL  # sender-side floor
NO_AVAILABLE_PEERS_WAIT = 1.0
FULL_CAPACITY_INTERVAL = 600.0


def pex_channel_descriptor() -> ChannelDescriptor:
    """Channel 0x00, priority 1 (ref: pex/reactor.go:58-68)."""
    return ChannelDescriptor(
        id=CHANNEL_PEX,
        name="pex",
        priority=1,
        send_queue_capacity=10,
        recv_message_capacity=MAX_MSG_SIZE,
        recv_buffer_capacity=128,
        encode=lambda m: m.encode(),
        decode=pb.PexMessage.decode,
    )


class PexReactor:
    """ref: internal/p2p/pex/reactor.go Reactor."""

    def __init__(self, peer_manager: PeerManager, channel, logger=None):
        self.peer_manager = peer_manager
        self.channel = channel
        self.logger = logger or new_logger("pex")
        self._lock = threading.Lock()
        self._available: set[str] = set()  # peers we may poll
        self._requests_sent: set[str] = set()  # in-flight polls
        self._last_received_request: dict[str, float] = {}
        self.total_peers = 0
        # Poll cadence; starts fast to bootstrap, widens as the book
        # fills (ref: reactor.go:163 nextPeerRequest). The floor stays
        # 2.5x above the receiver's MIN_RECEIVE_REQUEST_INTERVAL throttle
        # so network jitter can't make a well-behaved poll look abusive.
        self._next_request_interval = MIN_POLL_INTERVAL
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []

    # ------------------------------------------------------------ lifecycle

    def start(self) -> None:
        self.peer_manager.subscribe(self._on_peer_update)
        for nid in self.peer_manager.peers():
            with self._lock:
                self._available.add(nid)
        t = threading.Thread(target=self._run, daemon=True, name="pex")
        t.start()
        self._threads.append(t)

    def stop(self) -> None:
        self._stop.set()
        self.peer_manager.unsubscribe(self._on_peer_update)
        for t in self._threads:
            t.join(timeout=2)

    # ------------------------------------------------------------ main loop

    def _run(self) -> None:
        """Single loop: alternate between handling inbound envelopes and
        firing the poll timer (ref: reactor.go:146 processPexCh)."""
        next_poll = time.monotonic()  # poll immediately on start
        while not self._stop.is_set():
            env = self.channel.receive_one(timeout=0.05)
            if env is not None:
                try:
                    new_interval = self._handle_message(env.from_, env.message)
                except Exception as e:
                    self.channel.send_error(PeerError(node_id=env.from_, err=e))
                else:
                    if new_interval is not None:
                        self._next_request_interval = new_interval
            if time.monotonic() >= next_poll:
                self._send_request_for_peers()
                next_poll = time.monotonic() + self._next_request_interval

    # ------------------------------------------------------------ messages

    def _handle_message(self, from_id: str, msg) -> float | None:
        """Returns a new poll interval when priors changed
        (ref: reactor.go:225 handlePexMessage)."""
        if msg.pex_request is not None:
            self._mark_peer_request(from_id)
            addrs = self.peer_manager.advertise(limit=MAX_ADDRESSES)
            resp = pb.PexMessage(
                pex_response=pb.PexResponse(
                    addresses=[pb.PexAddress(url=str(ep)) for ep in addrs]
                )
            )
            self.channel.send_to(from_id, resp)
            return None
        if msg.pex_response is not None:
            self._mark_peer_response(from_id)
            addresses = msg.pex_response.addresses or []
            if len(addresses) > MAX_ADDRESSES:
                raise ValueError(
                    f"peer sent too many addresses ({len(addresses)} > {MAX_ADDRESSES})"
                )
            num_added = 0
            for pex_addr in addresses:
                try:
                    ep = Endpoint.parse(pex_addr.url or "")
                except Exception:
                    continue
                try:
                    if self.peer_manager.add(ep):
                        num_added += 1
                except Exception:
                    continue
            self.total_peers += num_added
            return self._calculate_next_request_time(num_added)
        raise ValueError("received unknown PEX message")

    # ------------------------------------------------------------ polling

    def _send_request_for_peers(self) -> None:
        """Poll one available peer (ref: reactor.go:307)."""
        with self._lock:
            candidates = self._available - self._requests_sent
            if not candidates:
                return
            peer_id = next(iter(candidates))
            self._available.discard(peer_id)
            self._requests_sent.add(peer_id)
        self.channel.send_to(peer_id, pb.PexMessage(pex_request=pb.PexRequest()))

    def _calculate_next_request_time(self, added: int) -> float:
        """Widen the poll interval as the book fills
        (ref: reactor.go:335 calculateNextRequestTime)."""
        book_size = len(self.peer_manager.store)
        cap = self.peer_manager.options.max_peers or 1000
        ratio = min(1.0, book_size / cap)
        if ratio >= 0.95:
            return FULL_CAPACITY_INTERVAL
        if added == 0:
            return NO_AVAILABLE_PEERS_WAIT
        # base interval scales with fullness^2 (reference scales by
        # 1/(1-ratio^3); both widen superlinearly near capacity)
        return max(MIN_POLL_INTERVAL, NO_AVAILABLE_PEERS_WAIT * ratio * ratio)

    # ------------------------------------------------------------ throttling

    def _mark_peer_request(self, peer_id: str) -> None:
        """ref: reactor.go:365 markPeerRequest."""
        with self._lock:
            last = self._last_received_request.get(peer_id, 0.0)
            now = time.monotonic()
            if now < last + MIN_RECEIVE_REQUEST_INTERVAL:
                raise ValueError(
                    f"peer {peer_id} sent PEX request too soon "
                    f"(min interval {MIN_RECEIVE_REQUEST_INTERVAL}s)"
                )
            self._last_received_request[peer_id] = now

    def _mark_peer_response(self, peer_id: str) -> None:
        """ref: reactor.go:377 markPeerResponse — response must match an
        in-flight request; peer becomes available for the next poll."""
        with self._lock:
            if peer_id not in self._requests_sent:
                raise ValueError(f"peer {peer_id} sent unsolicited PEX response")
            self._requests_sent.discard(peer_id)
            self._available.add(peer_id)

    # ------------------------------------------------------------ peer events

    def _on_peer_update(self, update) -> None:
        """ref: reactor.go:288 processPeerUpdate."""
        with self._lock:
            if update.status == PEER_STATUS_UP:
                self._available.add(update.node_id)
            else:
                self._available.discard(update.node_id)
                self._requests_sent.discard(update.node_id)
                self._last_received_request.pop(update.node_id, None)
