"""PeerManager — peer lifecycle, address book, scoring, eviction
(ref: internal/p2p/peermanager.go).

State machine per peer (peermanager.go:243-282):

  disconnected → dialing → connected → ready → (evicting →) disconnected
  disconnected → accepted(incoming) → ready → ...

The Router drives transitions via dial_next/try_dial_*/accepted/ready/
disconnected/errored/try_evict_next; subscribers get PeerUpdate{Up,Down}.
Persistent peers get max score and are always retried.
"""

from __future__ import annotations

import json
import random
import threading
import time
from dataclasses import dataclass, field

from .types import (
    PEER_STATUS_DOWN,
    PEER_STATUS_UP,
    PeerUpdate,
    validate_node_id,
)
from .transport import Endpoint

MAX_PEER_SCORE = 100  # ref: peermanager.go PeerScorePersistent


@dataclass
class PeerManagerOptions:
    """ref: peermanager.go PeerManagerOptions."""

    persistent_peers: list[str] = field(default_factory=list)
    max_peers: int = 0  # 0 = unlimited address-book entries
    max_connected: int = 16
    max_connected_upgrade: int = 4
    min_retry_time: float = 0.25
    max_retry_time: float = 30.0
    max_retry_time_persistent: float = 5.0
    retry_time_jitter: float = 0.1
    # Redial-storm guards (the JAX package's, which the Go reference
    # lacks: a dial that reaches a vetoed or filtering peer may cost a
    # whole handshake in Python, and a partition that vetoes N-1
    # persistent peers turns the 5 s persistent retry cap into a CPU
    # storm):
    #   - after this many consecutive failures to one address, the
    #     retry cap ESCALATES (doubles per further failure) toward
    #     max_retry_time even for persistent peers; one success resets
    #   - at most this many dials may be in flight at once, bounding
    #     concurrent handshake CPU no matter how many peers are down
    storm_backoff_after: int = 8
    max_dial_concurrency: int = 8
    disconnect_cooldown: float = 0.0
    peer_scores: dict[str, int] = field(default_factory=dict)
    private_peers: set[str] = field(default_factory=set)
    self_id: str = ""

    def is_persistent(self, node_id: str) -> bool:
        return node_id in self.persistent_peers


@dataclass
class PeerAddressInfo:
    """ref: peermanager.go peerAddressInfo."""

    endpoint: Endpoint
    last_dial_success: float = 0.0
    last_dial_failure: float = 0.0
    dial_failures: int = 0


@dataclass
class PeerInfo:
    """ref: peermanager.go peerInfo (persisted address-book entry)."""

    node_id: str
    address_info: dict[str, PeerAddressInfo] = field(default_factory=dict)
    last_connected: float = 0.0
    last_disconnected: float = 0.0
    persistent: bool = False
    inactive: bool = False
    mutable_score: int = 0

    def score(self) -> int:
        """ref: peermanager.go peerInfo.Score."""
        if self.persistent:
            return MAX_PEER_SCORE
        score = self.mutable_score
        for ai in self.address_info.values():
            score -= ai.dial_failures
        return min(score, MAX_PEER_SCORE)

    def to_wire(self) -> dict:
        return {
            "node_id": self.node_id,
            "last_connected": self.last_connected,
            "inactive": self.inactive,
            "mutable_score": self.mutable_score,
            "addresses": [
                {
                    "endpoint": str(ai.endpoint),
                    "last_dial_success": ai.last_dial_success,
                    "last_dial_failure": ai.last_dial_failure,
                    "dial_failures": ai.dial_failures,
                }
                for ai in self.address_info.values()
            ],
        }

    @classmethod
    def from_wire(cls, d: dict) -> "PeerInfo":
        info = cls(node_id=d["node_id"])
        info.last_connected = d.get("last_connected", 0.0)
        info.inactive = d.get("inactive", False)
        info.mutable_score = d.get("mutable_score", 0)
        for a in d.get("addresses", []):
            ep = Endpoint.parse(a["endpoint"])
            ai = PeerAddressInfo(
                endpoint=ep,
                last_dial_success=a.get("last_dial_success", 0.0),
                last_dial_failure=a.get("last_dial_failure", 0.0),
                dial_failures=a.get("dial_failures", 0),
            )
            info.address_info[str(ep)] = ai
        return info


_STORE_PREFIX = b"p2p/peer/"


class _PeerStore:
    """Address book, optionally persisted to a KVStore
    (ref: peermanager.go peerStore)."""

    def __init__(self, db=None):
        self.db = db
        self.peers: dict[str, PeerInfo] = {}
        if db is not None:
            for key, value in db.iterator(_STORE_PREFIX, _STORE_PREFIX + b"\xff"):
                info = PeerInfo.from_wire(json.loads(value.decode()))
                self.peers[info.node_id] = info

    def get(self, node_id: str) -> PeerInfo | None:
        return self.peers.get(node_id)

    def set(self, info: PeerInfo) -> None:
        self.peers[info.node_id] = info
        if self.db is not None:
            key = _STORE_PREFIX + info.node_id.encode()
            self.db.set(key, json.dumps(info.to_wire()).encode())

    def delete(self, node_id: str) -> None:
        self.peers.pop(node_id, None)
        if self.db is not None:
            self.db.delete(_STORE_PREFIX + node_id.encode())

    def ranked(self) -> list[PeerInfo]:
        """Peers sorted by descending score (ref: peerStore.Ranked)."""
        return sorted(self.peers.values(), key=lambda p: p.score(), reverse=True)

    def __len__(self) -> int:
        return len(self.peers)


class PeerManager:
    """ref: internal/p2p/peermanager.go PeerManager."""

    def __init__(self, self_id: str, options: PeerManagerOptions | None = None, db=None,
                 metrics=None):
        self.self_id = self_id
        self.options = options or PeerManagerOptions()
        self.options.self_id = self_id
        # P2PMetrics (or None): dial outcomes land on
        # p2p_dial_attempts_total{result} so a redial storm is visible
        # as a failed-dial RATE while it happens, not a post-hoc total
        self.metrics = metrics
        self.store = _PeerStore(db)
        self._lock = threading.RLock()
        self._dialing: set[str] = set()  # dialing in progress
        self._connected: dict[str, bool] = {}  # node_id → is_outgoing
        self._ready: set[str] = set()
        self._evict: set[str] = set()  # marked for eviction
        self._evicting: set[str] = set()  # eviction in progress
        self._subscribers: list = []
        self._dial_waker = threading.Event()
        self._evict_waker = threading.Event()

        for nid in self.options.persistent_peers:
            info = self.store.get(nid) or PeerInfo(node_id=nid)
            info.persistent = True
            self.store.set(info)

    # ------------------------------------------------------------ address book

    def add(self, endpoint: Endpoint) -> bool:
        """Add a candidate address (ref: peermanager.go Add)."""
        node_id = endpoint.node_id
        validate_node_id(node_id)
        if node_id == self.self_id:
            return False
        with self._lock:
            info = self.store.get(node_id)
            if info is None:
                if self.options.max_peers and len(self.store) >= self.options.max_peers:
                    if not self._prune_for(node_id):
                        return False
                info = PeerInfo(node_id=node_id, persistent=self.options.is_persistent(node_id))
            key = str(endpoint)
            if key in info.address_info:
                return False
            info.address_info[key] = PeerAddressInfo(endpoint=endpoint)
            self.store.set(info)
            self._dial_waker.set()
            return True

    def _prune_for(self, candidate_id: str) -> bool:
        """Evict the lowest-ranked non-connected peer to make room."""
        ranked = self.store.ranked()
        for info in reversed(ranked):
            nid = info.node_id
            if nid not in self._connected and nid not in self._dialing and not info.persistent:
                self.store.delete(nid)
                return True
        return False

    def advertise(self, limit: int = 100) -> list[Endpoint]:
        """Addresses to share via PEX (ref: peermanager.go Advertise)."""
        with self._lock:
            out = []
            for info in self.store.ranked():
                if info.node_id in self.options.private_peers:
                    continue
                for ai in info.address_info.values():
                    out.append(ai.endpoint)
                    if len(out) >= limit:
                        return out
            return out

    def peers(self) -> list[str]:
        with self._lock:
            return sorted(self._ready)

    def connected_count(self) -> int:
        with self._lock:
            return len(self._connected)

    def scores(self) -> dict[str, int]:
        with self._lock:
            return {nid: (self.store.get(nid).score() if self.store.get(nid) else 0) for nid in self._ready}

    # ------------------------------------------------------------ dialing

    def dial_next(self, timeout: float | None = None) -> Endpoint | None:
        """Blocking: next address to dial (ref: peermanager.go DialNext)."""
        deadline = time.monotonic() + timeout if timeout is not None else None
        while True:
            ep = self.try_dial_next()
            if ep is not None:
                return ep
            remaining = None if deadline is None else deadline - time.monotonic()
            if remaining is not None and remaining <= 0:
                return None
            self._dial_waker.wait(timeout=0.05 if remaining is None else min(0.05, remaining))
            self._dial_waker.clear()

    def try_dial_next(self) -> Endpoint | None:
        """ref: peermanager.go TryDialNext."""
        with self._lock:
            if len(self._connected) + len(self._dialing) >= self.options.max_connected + self.options.max_connected_upgrade:
                return None
            # bounded concurrent dials: each dial may cost a full
            # handshake; a wide outage must not run them all at once
            if (
                self.options.max_dial_concurrency > 0
                and len(self._dialing) >= self.options.max_dial_concurrency
            ):
                return None
            now = time.time()
            for info in self.store.ranked():
                nid = info.node_id
                if nid in self._dialing or nid in self._connected:
                    continue
                if info.inactive:
                    continue
                if self.options.disconnect_cooldown and now - info.last_disconnected < self.options.disconnect_cooldown:
                    continue
                for ai in info.address_info.values():
                    if now < self._retry_at(info, ai):
                        continue
                    # At capacity: only dial if this peer could upgrade
                    # (outscore) a currently connected one.
                    if len(self._connected) >= self.options.max_connected and self._upgrade_victim(info) is None:
                        return None
                    self._dialing.add(nid)
                    return ai.endpoint
            return None

    def _retry_at(self, info: PeerInfo, ai: PeerAddressInfo) -> float:
        """Exponential backoff with jitter (ref: peermanager.go
        retryDelay), plus a storm escalation: past
        `storm_backoff_after` consecutive failures the persistent-peer
        cap stops protecting the peer and doubles per further failure
        up to max_retry_time — a peer that vetoes/fails every
        handshake for minutes is a partition, not a blip, and redialing
        it at the 5s persistent cadence burns a handshake's CPU each
        time. One successful dial resets dial_failures and with it the
        escalation."""
        if ai.dial_failures == 0:
            return 0.0
        cap = self.options.max_retry_time_persistent if info.persistent else self.options.max_retry_time
        over = ai.dial_failures - self.options.storm_backoff_after
        if self.options.storm_backoff_after > 0 and over > 0:
            cap = min(self.options.max_retry_time, cap * (2 ** min(over, 16)))
        delay = min(self.options.min_retry_time * (2 ** min(ai.dial_failures - 1, 16)), cap)
        delay += random.random() * self.options.retry_time_jitter
        return ai.last_dial_failure + delay

    def _upgrade_victim(self, challenger: PeerInfo) -> str | None:
        """Lowest-scored connected peer strictly below challenger's score."""
        victim, victim_score = None, challenger.score()
        for nid in self._connected:
            if nid in self._evict or nid in self._evicting:
                continue
            vinfo = self.store.get(nid)
            s = vinfo.score() if vinfo else 0
            if s < victim_score:
                victim, victim_score = nid, s
        return victim

    def dial_failed(self, endpoint: Endpoint) -> None:
        """ref: peermanager.go DialFailed."""
        with self._lock:
            nid = endpoint.node_id
            self._dialing.discard(nid)
            info = self.store.get(nid)
            if info is not None:
                ai = info.address_info.get(str(endpoint))
                if ai is not None:
                    ai.last_dial_failure = time.time()
                    ai.dial_failures += 1
                    self.store.set(info)
            self._dial_waker.set()
        if self.metrics is not None:
            self.metrics.dial_attempts.add(1, "failed")

    def dialed(self, endpoint: Endpoint) -> None:
        """Outgoing connection established (ref: peermanager.go Dialed).
        Raises to reject (router closes the connection)."""
        with self._lock:
            nid = endpoint.node_id
            self._dialing.discard(nid)
            if nid in self._connected:
                raise ValueError(f"peer {nid} is already connected")
            if len(self._connected) >= self.options.max_connected:
                info = self.store.get(nid)
                victim = self._upgrade_victim(info) if info else None
                if victim is None:
                    raise ValueError("already connected to maximum number of peers")
                self._evict.add(victim)
                self._evict_waker.set()
            info = self.store.get(nid)
            if info is None:
                info = PeerInfo(node_id=nid, persistent=self.options.is_persistent(nid))
            info.last_connected = time.time()
            info.inactive = False
            ai = info.address_info.get(str(endpoint))
            if ai is not None:
                ai.last_dial_success = time.time()
                ai.dial_failures = 0
            self.store.set(info)
            self._connected[nid] = True
            # a dial slot freed up (max_dial_concurrency): wake the
            # dial loop for the next candidate
            self._dial_waker.set()
        if self.metrics is not None:
            self.metrics.dial_attempts.add(1, "ok")

    def accepted(self, node_id: str) -> None:
        """Incoming connection (ref: peermanager.go Accepted)."""
        with self._lock:
            if node_id == self.self_id:
                raise ValueError("rejecting connection from self")
            if node_id in self._connected:
                raise ValueError(f"peer {node_id} is already connected")
            if len(self._connected) >= self.options.max_connected + self.options.max_connected_upgrade:
                raise ValueError("already connected to maximum number of peers")
            if len(self._connected) >= self.options.max_connected:
                info = self.store.get(node_id) or PeerInfo(node_id=node_id)
                victim = self._upgrade_victim(info)
                if victim is None:
                    raise ValueError("already connected to maximum number of peers")
                self._evict.add(victim)
                self._evict_waker.set()
            info = self.store.get(node_id)
            if info is None:
                info = PeerInfo(node_id=node_id, persistent=self.options.is_persistent(node_id))
            info.last_connected = time.time()
            info.inactive = False
            self.store.set(info)
            self._connected[node_id] = False

    def ready(self, node_id: str, channels: set[int]) -> None:
        """Handshake complete, routing active (ref: peermanager.go Ready)."""
        with self._lock:
            if node_id not in self._connected:
                return
            self._ready.add(node_id)
            update = PeerUpdate(node_id=node_id, status=PEER_STATUS_UP, channels=channels)
            subs = list(self._subscribers)
        for sub in subs:
            sub(update)

    def disconnected(self, node_id: str) -> None:
        """ref: peermanager.go Disconnected."""
        with self._lock:
            was_ready = node_id in self._ready
            self._connected.pop(node_id, None)
            self._ready.discard(node_id)
            self._evict.discard(node_id)
            self._evicting.discard(node_id)
            info = self.store.get(node_id)
            if info is not None:
                info.last_disconnected = time.time()
                self.store.set(info)
            self._dial_waker.set()
            subs = list(self._subscribers) if was_ready else []
        update = PeerUpdate(node_id=node_id, status=PEER_STATUS_DOWN)
        for sub in subs:
            sub(update)

    def errored(self, node_id: str, err) -> None:
        """Reactor-reported error → evict (ref: peermanager.go Errored)."""
        with self._lock:
            if node_id in self._connected:
                self._evict.add(node_id)
                self._evict_waker.set()

    def process_peer_event(self, update: PeerUpdate) -> None:
        pass

    # ------------------------------------------------------------ eviction

    def evict_next(self, timeout: float | None = None) -> str | None:
        """Blocking: next peer to evict (ref: peermanager.go EvictNext)."""
        deadline = time.monotonic() + timeout if timeout is not None else None
        while True:
            nid = self.try_evict_next()
            if nid is not None:
                return nid
            remaining = None if deadline is None else deadline - time.monotonic()
            if remaining is not None and remaining <= 0:
                return None
            self._evict_waker.wait(timeout=0.05 if remaining is None else min(0.05, remaining))
            self._evict_waker.clear()

    def try_evict_next(self) -> str | None:
        with self._lock:
            while self._evict:
                nid = self._evict.pop()
                if nid in self._connected and nid not in self._evicting:
                    self._evicting.add(nid)
                    return nid
            return None

    # ------------------------------------------------------------ scoring

    def report_peer(self, node_id: str, delta: int) -> None:
        """Adjust mutable score (good/bad behavior)."""
        with self._lock:
            info = self.store.get(node_id)
            if info is None:
                return
            info.mutable_score = max(-MAX_PEER_SCORE, min(MAX_PEER_SCORE, info.mutable_score + delta))
            self.store.set(info)

    # ------------------------------------------------------------ updates

    def subscribe(self, callback) -> None:
        """Register a PeerUpdate callback (ref: peermanager.go Subscribe —
        queue-based there; callback-based here, invoked off-lock)."""
        with self._lock:
            self._subscribers.append(callback)

    def unsubscribe(self, callback) -> None:
        with self._lock:
            if callback in self._subscribers:
                self._subscribers.remove(callback)
