"""Router — connects transports, the peer manager, and reactor channels
(ref: internal/p2p/router.go:142-976).

Thread layout mirrors the reference's goroutine layout:
  - one accept loop per transport           (router.go:444 acceptPeers)
  - one dial loop                           (router.go:528 dialPeers)
  - one evict loop                          (router.go:877 evictPeers)
  - per-channel route loop                  (router.go:301 routeChannel)
  - per-peer send + receive threads         (router.go:791,843)

Envelopes flow: reactor → Channel.out_queue → routeChannel → per-peer
queue → sendPeer → Connection; and Connection → receivePeer →
Channel.in_queue → reactor.
"""

from __future__ import annotations

import heapq
import queue
import threading
import traceback
from dataclasses import dataclass

from .channel import Channel
from .conn_tracker import ConnTracker
from .transport import Connection, ConnectionClosed, Endpoint, Transport
from .types import ChannelDescriptor, Envelope, NodeInfo, PeerError, node_id_from_pubkey
from .peermanager import PeerManager


@dataclass
class RouterOptions:
    """ref: router.go RouterOptions."""

    dial_timeout: float = 5.0
    handshake_timeout: float = 5.0
    queue_size: int = 128
    num_dial_threads: int = 4
    filter_peer_by_id: object = None  # callable(node_id) -> None | raise
    # per-IP inbound limits (ref: conn_tracker.go; 0 disables)
    max_incoming_per_ip: int = 8
    incoming_conn_window: float = 0.1
    # per-peer outbound queue discipline (ref: config `queue-type`,
    # router.go queueFactory): fifo | priority | simple-priority
    queue_type: str = "fifo"


class _PeerQueue:
    """Per-peer outbound queue; closed on disconnect."""

    __slots__ = ("q", "closed")
    _SENTINEL = object()

    def __init__(self, size: int):
        self.q: queue.Queue = queue.Queue(maxsize=size)
        self.closed = threading.Event()

    def put(self, envelope: Envelope, timeout: float = 1.0) -> bool:
        if self.closed.is_set():
            return False
        try:
            self.q.put(envelope, timeout=timeout)
            return True
        except queue.Full:
            return False  # drop on sustained backpressure (ref drops too)

    def get(self, timeout: float = 0.2):
        try:
            item = self.q.get(timeout=timeout)
        except queue.Empty:
            return None
        return None if item is self._SENTINEL else item

    def qsize(self) -> int:
        return self.q.qsize()

    def close(self) -> None:
        self.closed.set()
        try:
            self.q.put_nowait(self._SENTINEL)
        except queue.Full:
            pass


class _PriorityPeerQueue:
    """Per-peer outbound queue scheduling by channel priority
    (ref: pqueue.go:289 priorityQueueScheduler): dequeue order is
    strictly highest-priority-first (FIFO within a priority); when full,
    the lowest-priority entry — possibly the incoming one — is dropped,
    so consensus traffic survives a flood of low-priority gossip."""

    __slots__ = ("_heap", "_size", "_cv", "closed", "_seq", "_priorities", "dropped",
                 "on_drop")

    def __init__(self, size: int, priorities: dict[int, int], on_drop=None):
        self._heap: list[tuple[int, int, Envelope]] = []  # (-prio, seq, env)
        self._size = size
        self._cv = threading.Condition()
        self.closed = threading.Event()  # same surface as _PeerQueue
        self._seq = 0
        self._priorities = priorities
        self.dropped = 0
        self.on_drop = on_drop  # callable(channel_id) for evicted envelopes

    def _priority(self, envelope: Envelope) -> int:
        return self._priorities.get(envelope.channel_id, 0)

    def put(self, envelope: Envelope, timeout: float = 1.0) -> bool:
        prio = self._priority(envelope)
        with self._cv:
            if self.closed.is_set():
                return False
            if len(self._heap) >= self._size:
                worst = max(self._heap)  # lowest priority, newest within it
                if (-prio, self._seq) >= worst[:2]:
                    self.dropped += 1
                    return False  # incoming ranks lowest: drop it (caller counts)
                self._heap.remove(worst)
                heapq.heapify(self._heap)
                self.dropped += 1
                if self.on_drop is not None:
                    # an eviction is invisible to the caller (put returns
                    # True), so it must be metered here
                    self.on_drop(worst[2].channel_id)
            heapq.heappush(self._heap, (-prio, self._seq, envelope))
            self._seq += 1
            self._cv.notify()
            return True

    def get(self, timeout: float = 0.2):
        with self._cv:
            if not self._heap:
                self._cv.wait(timeout)
            if not self._heap:
                return None
            return heapq.heappop(self._heap)[2]

    def qsize(self) -> int:
        with self._cv:
            return len(self._heap)

    def close(self) -> None:
        with self._cv:
            self.closed.set()
            self._cv.notify_all()


class _SimplePriorityPeerQueue(_PriorityPeerQueue):
    """ref: rqueue.go newSimplePriorityQueue: arrival-order delivery,
    priorities consulted only under pressure (overflow drops the
    lowest-priority queued entry, or the incoming one if it ranks
    lowest)."""

    def get(self, timeout: float = 0.2):
        with self._cv:
            if not self._heap:
                self._cv.wait(timeout)
            if not self._heap:
                return None
            entry = min(self._heap, key=lambda e: e[1])  # oldest first
            self._heap.remove(entry)
            heapq.heapify(self._heap)
            return entry[2]


class Router:
    """ref: internal/p2p/router.go Router."""

    def __init__(
        self,
        node_info: NodeInfo,
        priv_key,
        peer_manager: PeerManager,
        transports: list[Transport],
        endpoint_for: dict[str, Transport] | None = None,
        options: RouterOptions | None = None,
        logger=None,
        metrics=None,
    ):
        self.node_info = node_info
        self.priv_key = priv_key
        self.peer_manager = peer_manager
        self.transports = list(transports)
        self.options = options or RouterOptions()
        self.logger = logger
        self.metrics = metrics  # P2PMetrics (ref: p2p/metrics.go)

        self._channels: dict[int, Channel] = {}
        self._channel_lock = threading.RLock()
        self._peer_queues: dict[str, _PeerQueue] = {}
        self._peer_conns: dict[str, Connection] = {}
        self._peer_channels: dict[str, set[int]] = {}
        self._peer_lock = threading.RLock()
        self._peer_veto: set[str] = set()
        self._threads: list[threading.Thread] = []  # long-lived loop threads only
        self._threads_lock = threading.Lock()
        self._stop = threading.Event()
        self._network_enabled = threading.Event()
        self._network_enabled.set()
        if self.options.queue_type not in ("fifo", "priority", "simple-priority", "", None):
            # fail at construction: a per-connection failure after the
            # handshake would leave peers wedged in connected state
            raise ValueError(f"unsupported queue-type {self.options.queue_type!r}")
        self._conn_tracker = (
            ConnTracker(self.options.max_incoming_per_ip, self.options.incoming_conn_window)
            if self.options.max_incoming_per_ip > 0
            else None
        )

    # ------------------------------------------------------------- channels

    def open_channel(self, desc: ChannelDescriptor) -> Channel:
        """ref: router.go:251 OpenChannel."""
        with self._channel_lock:
            if desc.id in self._channels:
                raise ValueError(f"channel {desc.id:#x} already exists")
            ch = Channel(desc)
            self._channels[desc.id] = ch
            self.node_info.channels += bytes([desc.id])
            if not self._stop.is_set() and self._threads:
                self._spawn(self._route_channel, ch)
            return ch

    def channel_ids(self) -> set[int]:
        with self._channel_lock:
            return set(self._channels)

    # ------------------------------------------------------------ lifecycle

    def set_network_enabled(self, enabled: bool) -> None:
        """Hard partition switch for fault injection (the host-level
        equivalent of the reference e2e runner's docker network
        disconnect, test/e2e/runner/perturb.go:43): disabling closes
        every live peer connection NOW and refuses new inbound and
        outbound connections until re-enabled. Unlike a SIGSTOP pause,
        peers observe immediate EOF/reset and run their real
        disconnect/eviction/reconnect paths."""
        if enabled:
            self._network_enabled.set()
            return
        self._network_enabled.clear()
        with self._peer_lock:
            conns = list(self._peer_conns.values())
        for conn in conns:
            try:
                conn.close()
            except Exception:
                pass

    @property
    def network_enabled(self) -> bool:
        return self._network_enabled.is_set()

    def set_peer_veto(self, peer_ids) -> None:
        """Per-peer partition (ref analog: the e2e runner's
        container-level network disconnect, test/e2e/runner/perturb.go:
        40-72, at per-link granularity): connections to the given peer
        ids are closed NOW and refused (dial and accept) until the veto
        is lifted. Asymmetric by construction — only THIS node refuses;
        the vetoed side keeps trying and exercises its real
        dial-failure/backoff/eviction paths. Pass an empty set to
        heal.

        Granularity note: inbound peers are identified only by the
        handshake, so a vetoed dialer completes the handshake and is
        dropped immediately after — it observes short connect/close
        blips rather than refused SYNs (the reference's docker
        partition cuts at the packet level; this cuts at the link
        level). Data-plane isolation is unaffected: no envelope is
        routed to or from a vetoed peer."""
        veto = {p.lower() for p in peer_ids}
        with self._peer_lock:
            self._peer_veto = veto
            doomed = [c for pid, c in self._peer_conns.items() if pid in veto]
        for conn in doomed:
            try:
                conn.close()
            except Exception:
                pass

    @property
    def peer_veto(self) -> set:
        with self._peer_lock:
            return set(self._peer_veto)

    def _make_peer_queue(self):
        """ref: router.go createQueueFactory, selectable via config
        `queue-type`."""
        qt = self.options.queue_type
        if qt in ("fifo", "", None):
            return _PeerQueue(self.options.queue_size)
        with self._channel_lock:
            priorities = {cid: ch.desc.priority for cid, ch in self._channels.items()}
        on_drop = None
        if self.metrics is not None:
            metrics = self.metrics

            def on_drop(channel_id: int) -> None:
                metrics.peer_queue_dropped_msgs.add(1, f"{channel_id:#x}")

        if qt == "priority":
            return _PriorityPeerQueue(self.options.queue_size, priorities, on_drop=on_drop)
        if qt == "simple-priority":
            return _SimplePriorityPeerQueue(self.options.queue_size, priorities, on_drop=on_drop)
        raise ValueError(f"unsupported queue-type {qt!r}")

    def start(self) -> None:
        self._stop.clear()
        with self._channel_lock:
            for ch in self._channels.values():
                self._spawn(self._route_channel, ch)
        for t in self.transports:
            self._spawn(self._accept_loop, t)
        for _ in range(self.options.num_dial_threads):
            self._spawn(self._dial_loop)
        self._spawn(self._evict_loop)

    def stop(self) -> None:
        self._stop.set()
        with self._channel_lock:
            for ch in self._channels.values():
                ch.close()
        with self._peer_lock:
            conns = list(self._peer_conns.values())
            queues = list(self._peer_queues.values())
        for pq in queues:
            pq.close()
        for conn in conns:
            conn.close()
        for t in self.transports:
            t.close()
        with self._threads_lock:
            loops = list(self._threads)
            self._threads.clear()
        for th in loops:
            th.join(timeout=2)

    def _spawn(self, fn, *args) -> None:
        """Spawn + track a long-lived loop thread (joined at stop)."""
        th = threading.Thread(target=fn, args=args, daemon=True, name=fn.__name__)
        with self._threads_lock:
            self._threads.append(th)
        th.start()

    @staticmethod
    def _spawn_conn(fn, *args, name: str = "conn") -> None:
        """Per-connection thread: untracked (exits when its connection
        closes; stop() closes every connection, unblocking them all)."""
        threading.Thread(target=fn, args=args, daemon=True, name=name).start()

    # -------------------------------------------------------- channel route

    def _route_channel(self, ch: Channel) -> None:
        """Fan envelopes from a reactor channel out to peer queues
        (ref: router.go:301 routeChannel)."""
        while not self._stop.is_set():
            # peer errors → peer manager
            try:
                while True:
                    perr: PeerError = ch.error_queue.get_nowait()
                    self.peer_manager.errored(perr.node_id, perr.err)
            except queue.Empty:
                pass
            try:
                envelope = ch.out_queue.get(timeout=0.2)
            except queue.Empty:
                continue
            if envelope is None:
                return
            envelope.channel_id = ch.id
            if envelope.broadcast:
                with self._peer_lock:
                    targets = [
                        (nid, pq)
                        for nid, pq in self._peer_queues.items()
                        if ch.id in self._peer_channels.get(nid, ())
                    ]
            else:
                if not envelope.to:
                    continue
                with self._peer_lock:
                    pq = self._peer_queues.get(envelope.to)
                    ok = pq is not None and ch.id in self._peer_channels.get(envelope.to, ())
                targets = [(envelope.to, pq)] if ok else []
            for nid, pq in targets:
                env = Envelope(
                    message=envelope.message,
                    to=nid,
                    channel_id=ch.id,
                )
                if not pq.put(env) and self.metrics is not None:
                    # ref: p2p/metrics.go PeerQueueDroppedMsgs
                    self.metrics.peer_queue_dropped_msgs.add(1, f"{ch.id:#x}")

    # ------------------------------------------------------------- accept

    def _accept_loop(self, transport: Transport) -> None:
        """ref: router.go:444 acceptPeers (per-IP limiting per
        conn_tracker.go via router.go:466 connTracker.AddConn)."""
        while not self._stop.is_set():
            try:
                conn = transport.accept(timeout=0.2)
            except TimeoutError:
                continue
            except (ConnectionClosed, OSError):
                return
            if not self._network_enabled.is_set():
                conn.close()
                continue
            ip = ""
            if self._conn_tracker is not None:
                try:
                    host = conn.remote_endpoint().host
                    # loopback is exempt: localnets legitimately open many
                    # rapid connections from 127.0.0.1
                    if host and not host.startswith("127.") and host != "::1":
                        self._conn_tracker.add_conn(host)
                        ip = host
                except ConnectionRefusedError:
                    conn.close()
                    continue
                except Exception:
                    ip = ""
            self._spawn_conn(self._run_inbound, conn, ip, name="accept-conn")

    def _run_inbound(self, conn: Connection, ip: str) -> None:
        try:
            self._open_connection(conn, False, None)
        finally:
            if ip and self._conn_tracker is not None:
                self._conn_tracker.remove_conn(ip)

    def _open_connection(self, conn: Connection, outgoing: bool, endpoint: Endpoint | None) -> None:
        """Handshake + register + run send/recv (ref: router.go:481
        openConnection / :675 handshakePeer + :745 routePeer)."""
        if not self._network_enabled.is_set():
            conn.close()
            return
        peer_id = None
        try:
            peer_info, peer_key = conn.handshake(
                self.node_info, self.priv_key, timeout=self.options.handshake_timeout
            )
            peer_info.validate()
            peer_id = peer_info.node_id
            if node_id_from_pubkey(peer_key) != peer_id:
                raise ValueError("peer's public key did not match its node ID")
            if peer_id == self.node_info.node_id:
                raise ValueError("rejecting handshake with self")
            if outgoing and endpoint is not None and endpoint.node_id and endpoint.node_id != peer_id:
                raise ValueError(f"expected to dial {endpoint.node_id}, got {peer_id}")
            self.node_info.compatible_with(peer_info)
            with self._peer_lock:
                if peer_id in self._peer_veto:
                    raise ValueError(f"peer {peer_id} vetoed (partition)")
            if self.options.filter_peer_by_id is not None:
                self.options.filter_peer_by_id(peer_id)

            if outgoing:
                self.peer_manager.dialed(endpoint)
            else:
                self.peer_manager.accepted(peer_id)
                # Record the peer's self-advertised listen address so the
                # address book (and thus PEX) can hand out a dialable
                # endpoint for inbound peers — this is what makes a seed
                # node useful (ref: 0.34 address-book AddOurAddress flow;
                # NodeInfo.ListenAddr, types/node_info.go).
                self._record_listen_addr(peer_id, peer_info.listen_addr)
        except Exception:
            if outgoing and endpoint is not None:
                self.peer_manager.dial_failed(endpoint)
            conn.close()
            return

        peer_channels = set(peer_info.channels)
        pq = self._make_peer_queue()
        if self.metrics is not None:
            metrics = self.metrics

            def on_traffic(direction: str, channel_id: int, nbytes: int) -> None:
                if direction == "send":
                    metrics.message_send_bytes_total.add(nbytes, f"{channel_id:#x}")
                else:
                    metrics.message_receive_bytes_total.add(nbytes, f"{channel_id:#x}")

            conn.on_traffic = on_traffic
        with self._peer_lock:
            # Re-check under the lock set_network_enabled snapshots with:
            # a connection that finished its handshake while the switch
            # flipped would otherwise register AFTER the close sweep and
            # survive the "partition". Same for a per-peer veto landing
            # mid-handshake.
            if not self._network_enabled.is_set() or peer_id in self._peer_veto:
                conn.close()
                self.peer_manager.disconnected(peer_id)
                return
            old = self._peer_conns.pop(peer_id, None)
            self._peer_queues[peer_id] = pq
            self._peer_conns[peer_id] = conn
            self._peer_channels[peer_id] = peer_channels & self.channel_ids()
            if self.metrics is not None:
                self.metrics.peers.set(len(self._peer_conns))
                self.metrics.peer_connections.add(1, "out" if outgoing else "in")
        if old is not None:
            old.close()

        self.peer_manager.ready(peer_id, peer_channels)

        send_done = threading.Event()
        sender = threading.Thread(
            target=self._send_peer, args=(peer_id, conn, pq, send_done), daemon=True, name=f"send:{peer_id[:8]}"
        )
        sender.start()
        try:
            self._receive_peer(peer_id, conn)
        finally:
            pq.close()
            conn.close()
            send_done.set()
            sender.join(timeout=2)
            with self._peer_lock:
                if self._peer_conns.get(peer_id) is conn:
                    del self._peer_conns[peer_id]
                    self._peer_queues.pop(peer_id, None)
                    self._peer_channels.pop(peer_id, None)
                    if self.metrics is not None:
                        self.metrics.peer_send_queue_depth.remove(peer_id)
                if self.metrics is not None:
                    self.metrics.peers.set(len(self._peer_conns))
            self.peer_manager.disconnected(peer_id)

    def _record_listen_addr(self, peer_id: str, listen_addr: str) -> None:
        """Add an inbound peer's advertised listen address to the book."""
        if not listen_addr:
            return
        try:
            host, _, port_s = listen_addr.rpartition(":")
            port = int(port_s)
            # Unspecified bind hosts are not dialable; advertising them
            # would make PEX recipients dial themselves.
            if not host or port <= 0 or host in ("0.0.0.0", "::", "[::]"):
                return
            self.peer_manager.add(
                Endpoint(protocol="mconn", host=host, port=port, node_id=peer_id)
            )
        except (ValueError, TypeError):
            pass

    # --------------------------------------------------------------- dial

    def _dial_loop(self) -> None:
        """ref: router.go:528 dialPeers."""
        while not self._stop.is_set():
            endpoint = self.peer_manager.dial_next(timeout=0.2)
            if endpoint is None:
                continue
            if not self._network_enabled.is_set() or (
                endpoint.node_id and endpoint.node_id.lower() in self.peer_veto
            ):
                self.peer_manager.dial_failed(endpoint)  # retry after backoff
                continue
            transport = self._transport_for(endpoint.protocol)
            if transport is None:
                self.peer_manager.dial_failed(endpoint)
                continue
            try:
                conn = transport.dial(endpoint, timeout=self.options.dial_timeout)
            except Exception:
                self.peer_manager.dial_failed(endpoint)
                continue
            # run the connection on its own thread so this dial worker is
            # free to keep dialing (outbound peers otherwise cap at the
            # number of dial threads)
            self._spawn_conn(self._open_connection, conn, True, endpoint, name="dial-conn")

    def _transport_for(self, protocol: str) -> Transport | None:
        for t in self.transports:
            if t.protocol == protocol:
                return t
        return None

    # --------------------------------------------------------------- evict

    def _evict_loop(self) -> None:
        """ref: router.go:877 evictPeers."""
        while not self._stop.is_set():
            nid = self.peer_manager.evict_next(timeout=0.2)
            if nid is None:
                continue
            with self._peer_lock:
                conn = self._peer_conns.get(nid)
            if conn is not None:
                conn.close()

    # ------------------------------------------------------------ send/recv

    def _send_peer(self, peer_id: str, conn: Connection, pq: _PeerQueue, done: threading.Event) -> None:
        """ref: router.go:791 sendPeer."""
        while not done.is_set() and not self._stop.is_set():
            envelope = pq.get(timeout=0.2)
            if self.metrics is not None and not pq.closed.is_set():
                # Per-peer backlog gauge, updated ONLY from this thread
                # (joined before the disconnect path calls
                # peer_send_queue_depth.remove(), so a set here cannot
                # resurrect a removed child and leak stale peer labels
                # under churn; the closed check narrows the
                # join-timeout edge). A slow peer shows its backlog at
                # every send; an idle one decays to 0 each poll tick.
                self.metrics.peer_send_queue_depth.set(pq.qsize(), peer_id)
            if envelope is None:
                if pq.closed.is_set():
                    return
                continue
            try:
                conn.send_message(envelope.channel_id, envelope.message)
            except (ConnectionClosed, OSError):
                return
            except Exception:
                traceback.print_exc()
                return

    def _receive_peer(self, peer_id: str, conn: Connection) -> None:
        """ref: router.go:843 receivePeer."""
        while not self._stop.is_set():
            try:
                channel_id, message = conn.receive_message(timeout=0.2)
            except TimeoutError:
                continue
            except (ConnectionClosed, OSError):
                return
            except Exception:
                return
            with self._channel_lock:
                ch = self._channels.get(channel_id)
            if ch is None:
                continue
            ch.deliver(Envelope(message=message, from_=peer_id, channel_id=channel_id))
