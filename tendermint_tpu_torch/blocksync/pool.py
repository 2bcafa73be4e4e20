"""BlockPool — pipelined block fetching during fast sync
(ref: internal/blocksync/pool.go).

Keeps a sliding window of in-flight per-height requests across known
peers (the reference runs ~600 concurrent bpRequester goroutines,
pool.go:64,132). The verify loop consumes blocks strictly in height
order via peek_two_blocks/pop_request; slow or lying peers are timed
out/banned and their heights re-requested.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

REQUEST_INTERVAL = 0.01  # pool.go requestIntervalMS = 2ms
MAX_PENDING_REQUESTS_PER_PEER = 20  # pool.go maxPendingRequestsPerPeer
MAX_TOTAL_REQUESTERS = 600  # pool.go maxTotalRequesters
PEER_TIMEOUT = 15.0  # pool.go peerTimeout
# Minimum observation window after start before is_caught_up may fire:
# at restart the first status to arrive can be from a peer that is
# itself behind (or a seed at height 0), and switching to consensus on
# that stale view leaves a node hundreds of blocks behind crawling to
# the tip via vote gossip instead of blocksync. The reference gets the
# same settling time from its 1 s switchToConsensusTicker
# (reactor.go:35,444); here the window is explicit.
STATUS_SETTLE_SECONDS = 1.0


@dataclass
class _BpPeer:
    """ref: pool.go bpPeer."""

    peer_id: str
    base: int
    height: int
    pending: int = 0
    last_block_at: float = field(default_factory=time.monotonic)
    did_timeout: bool = False


class BlockPool:
    """ref: pool.go BlockPool."""

    def __init__(self, start_height: int, send_request, send_error=None):
        """send_request(height, peer_id) asks the reactor to fire a
        BlockRequest; send_error(err, peer_id) reports bad peers."""
        self.height = start_height  # next height to verify
        self.start_height = start_height
        self.send_request = send_request
        self.send_error = send_error or (lambda err, peer_id: None)
        self.peers: dict[str, _BpPeer] = {}
        self.requesters: dict[int, str] = {}  # height → assigned peer
        self.blocks: dict[int, tuple] = {}  # height → (block, peer_id)
        self._ext_commits: dict[int, object] = {}  # height → pb.ExtendedCommit
        self.max_peer_height = 0
        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.last_advance = time.monotonic()
        self.last_hundred_start = time.monotonic()
        self.last_sync_rate = 0.0
        self.settle_seconds = STATUS_SETTLE_SECONDS
        self._started_at = time.monotonic()

    def reanchor(self, height: int) -> None:
        """Move the next-height cursor after a handshake replay or a
        statesync restore (the node's boot and statesync handoffs).
        Under the pool lock even though the pool thread is not running
        yet at either call site, so that the anchor write shares the
        discipline of every other height access."""
        with self._lock:
            self.height = height
            self.start_height = height
            self.last_advance = time.monotonic()
            self.last_hundred_start = self.last_advance

    # ----------------------------------------------------------- lifecycle

    def start(self) -> None:
        self._started_at = time.monotonic()
        self._stop.clear()
        self._thread = threading.Thread(target=self._make_requests_routine, daemon=True, name="blockpool")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)

    # ----------------------------------------------------------- peers

    def set_peer_range(self, peer_id: str, base: int, height: int) -> None:
        """StatusResponse from a peer (ref: pool.go:392 SetPeerRange)."""
        with self._lock:
            peer = self.peers.get(peer_id)
            if peer is not None:
                peer.base = base
                peer.height = height
            else:
                self.peers[peer_id] = _BpPeer(peer_id=peer_id, base=base, height=height)
            if height > self.max_peer_height:
                self.max_peer_height = height

    def remove_peer(self, peer_id: str) -> None:
        """ref: pool.go:343 RemovePeer — reassign its heights."""
        with self._lock:
            self.peers.pop(peer_id, None)
            for h in [h for h, p in self.requesters.items() if p == peer_id]:
                del self.requesters[h]
            # drop unverified blocks it delivered — a banned peer's
            # second block must not be used to verify the first
            for h in [h for h, (_, p) in self.blocks.items() if p == peer_id and h >= self.height]:
                del self.blocks[h]
                self._ext_commits.pop(h, None)
            self.max_peer_height = max((p.height for p in self.peers.values()), default=0)

    # ----------------------------------------------------------- blocks

    def take_ext_commit(self, height: int):
        """ExtendedCommit delivered with the block at `height`, if any."""
        with self._lock:
            return self._ext_commits.pop(height, None)

    def add_block(self, peer_id: str, block, ext_commit=None) -> bool:
        """A BlockResponse arrived (ref: pool.go:244 AddBlock). Only the
        peer the height was assigned to may deliver it — unsolicited
        blocks are rejected (the reference errors the sender), which
        bounds pool memory at the request window size."""
        with self._lock:
            height = block.header.height
            if self.requesters.get(height) != peer_id:
                self.send_error(ValueError(f"unsolicited block for height {height}"), peer_id)
                return False
            if ext_commit is not None:
                self._ext_commits[height] = ext_commit
            if height in self.blocks:
                return False
            self.blocks[height] = (block, peer_id)
            peer = self.peers.get(peer_id)
            if peer is not None:
                peer.pending = max(0, peer.pending - 1)
                peer.last_block_at = time.monotonic()
            return True

    def peek_two_blocks(self):
        """The verify loop needs first+second (second.LastCommit proves
        first) (ref: pool.go:204 PeekTwoBlocks)."""
        with self._lock:
            first = self.blocks.get(self.height)
            second = self.blocks.get(self.height + 1)
            return (first[0] if first else None), (second[0] if second else None)

    def peek_third_block(self):
        """Block at height+2 if downloaded — feeds the verify-ahead
        pipeline (its LastCommit proves height+1 while height applies)."""
        with self._lock:
            third = self.blocks.get(self.height + 2)
            return third[0] if third else None

    def block_sender(self, height: int) -> str | None:
        with self._lock:
            entry = self.blocks.get(height)
            return entry[1] if entry else None

    def retry_height(self, height: int, peer_id: str) -> None:
        """Peer answered NoBlockResponse: unassign so another peer is
        asked (no ban) (ref: pool.go requestRoutine retry on redo)."""
        with self._lock:
            if self.requesters.get(height) == peer_id and height not in self.blocks:
                del self.requesters[height]
                peer = self.peers.get(peer_id)
                if peer is not None:
                    peer.pending = max(0, peer.pending - 1)
                    # don't serve this height from them again: shrink range
                    if peer.height >= height:
                        peer.height = height - 1

    def pop_request(self) -> None:
        """First block verified → advance (ref: pool.go:222 PopRequest)."""
        with self._lock:
            self.blocks.pop(self.height, None)
            self.requesters.pop(self.height, None)
            self.height += 1
            self.last_advance = time.monotonic()
            if (self.height - self.start_height) % 100 == 0:
                now = time.monotonic()
                dt = now - self.last_hundred_start
                if dt > 0:
                    rate = 100 / dt
                    self.last_sync_rate = rate if self.last_sync_rate == 0 else 0.9 * self.last_sync_rate + 0.1 * rate
                self.last_hundred_start = now

    def redo_request(self, height: int) -> str | None:
        """Verification failed → drop the peer that sent `height`, retry
        (ref: pool.go:274 RedoRequest)."""
        with self._lock:
            entry = self.blocks.pop(height, None)
            self._ext_commits.pop(height, None)
            self.requesters.pop(height, None)
            peer_id = entry[1] if entry else None
            if peer_id is not None:
                self.remove_peer(peer_id)
            return peer_id

    def is_caught_up(self) -> bool:
        """ref: pool.go:189 IsCaughtUp + the reactor's 1 s switch ticker
        (reactor.go:466). Peers only enter `self.peers` via status
        responses, so non-empty peers implies at least one post-start
        status round; the settle window additionally keeps the first —
        possibly stale or height-0 — response from deciding the switch
        alone (the restart race: a node 100+ blocks behind must rejoin
        via blocksync, not vote gossip)."""
        with self._lock:
            if not self.peers:
                return False
            if time.monotonic() - self._started_at < self.settle_seconds:
                return False
            return self.height >= self.max_peer_height

    def status(self) -> tuple[int, int, float]:
        with self._lock:
            return self.height, self.max_peer_height, self.last_sync_rate

    # ------------------------------------------------------ request engine

    def _make_requests_routine(self) -> None:
        """Keep the request window full (ref: pool.go:156
        makeRequestersRoutine + requestRoutine :656)."""
        while not self._stop.is_set():
            self._check_peer_timeouts()
            self._fill_requests()
            time.sleep(REQUEST_INTERVAL)

    def _fill_requests(self) -> None:
        with self._lock:
            next_heights = []
            h = self.height
            while (
                len(self.requesters) < MAX_TOTAL_REQUESTERS
                and len(next_heights) < 50
                and h <= self.max_peer_height
            ):
                if h not in self.requesters and h not in self.blocks:
                    next_heights.append(h)
                h += 1
            assignments = []
            now = time.monotonic()
            for h in next_heights:
                peer = self._pick_peer(h)
                if peer is None:
                    break
                if peer.pending == 0:
                    # idle → active: restart the silence clock, else a
                    # long-idle peer is insta-banned on first request
                    peer.last_block_at = now
                peer.pending += 1
                self.requesters[h] = peer.peer_id
                assignments.append((h, peer.peer_id))
        for h, peer_id in assignments:
            try:
                self.send_request(h, peer_id)
            except Exception:
                with self._lock:
                    self.requesters.pop(h, None)
                    p = self.peers.get(peer_id)
                    if p is not None:
                        p.pending = max(0, p.pending - 1)

    def _pick_peer(self, height: int) -> _BpPeer | None:
        """ref: pool.go:440 pickIncrAvailablePeer."""
        best = None
        for peer in self.peers.values():
            if peer.did_timeout or peer.pending >= MAX_PENDING_REQUESTS_PER_PEER:
                continue
            if not (peer.base <= height <= peer.height):
                continue
            if best is None or peer.pending < best.pending:
                best = peer
        return best

    def _check_peer_timeouts(self) -> None:
        with self._lock:
            now = time.monotonic()
            for peer in list(self.peers.values()):
                if peer.pending > 0 and now - peer.last_block_at > PEER_TIMEOUT:
                    peer.did_timeout = True
                    self.send_error(TimeoutError("peer did not send us anything"), peer.peer_id)
                    self.remove_peer(peer.peer_id)
