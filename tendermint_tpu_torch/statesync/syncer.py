"""Statesync syncer — discover snapshots, offer to the app, fetch and
apply chunks, verify against the light client
(ref: internal/statesync/syncer.go:54-550).

As in the reference, a failure of the state provider rejects the snapshot,
except a fault of the verifier (crypto/batch.py mark_fault: a failed
kernel build or launch, a missing card), which says nothing about the
snapshot and is raised to the caller.
"""

from __future__ import annotations

import threading
import time

from ..abci import types as abci
from ..crypto.batch import is_fault


class StateSyncError(Exception):
    pass


class ErrNoSnapshots(StateSyncError):
    pass


class ErrRejectSnapshot(StateSyncError):
    pass


class _SnapshotPool:
    """Dedup + peer tracking + prioritization (ref: snapshots.go)."""

    def __init__(self):
        self._snapshots: dict[tuple, abci.Snapshot] = {}
        self._peers: dict[tuple, set[str]] = {}
        self._rejected: set[tuple] = set()
        self._lock = threading.Lock()

    @staticmethod
    def _key(s: abci.Snapshot) -> tuple:
        return (s.height, s.format, s.chunks, s.hash)

    def add(self, peer_id: str, snapshot: abci.Snapshot) -> bool:
        with self._lock:
            key = self._key(snapshot)
            if key in self._rejected:
                return False
            known = key in self._snapshots
            self._snapshots[key] = snapshot
            self._peers.setdefault(key, set()).add(peer_id)
            return not known

    def best(self) -> abci.Snapshot | None:
        """Highest height, most peers first (ref: snapshots.go Best)."""
        with self._lock:
            if not self._snapshots:
                return None
            return max(
                self._snapshots.values(),
                key=lambda s: (s.height, len(self._peers.get(self._key(s), ()))),
            )

    def reject(self, snapshot: abci.Snapshot) -> None:
        with self._lock:
            key = self._key(snapshot)
            self._rejected.add(key)
            self._snapshots.pop(key, None)

    def peers_of(self, snapshot: abci.Snapshot) -> list[str]:
        with self._lock:
            return sorted(self._peers.get(self._key(snapshot), ()))

    def remove_peer(self, peer_id: str) -> None:
        with self._lock:
            for key in list(self._peers):
                self._peers[key].discard(peer_id)
                if not self._peers[key]:
                    del self._peers[key]
                    self._snapshots.pop(key, None)


class _ChunkQueue:
    """Pending/received chunk bookkeeping (ref: chunks.go).

    Re-requests carry ESCALATING per-chunk backoff: each expiry of an
    outstanding request doubles that chunk's effective timeout (capped
    at 2**BACKOFF_CAP) instead of hammering a dead/slow peer on a
    fixed cadence, and the expiry is recorded against the peer the
    request was assigned to (take_timeouts) so the syncer can rotate
    away from it."""

    BACKOFF_CAP = 4  # 16x the base timeout at most

    def __init__(self, n_chunks: int):
        self.n = n_chunks
        self.chunks: list[bytes | None] = [None] * n_chunks
        self.senders: dict[int, str] = {}
        self._requested: dict[int, float] = {}
        self._fails: dict[int, int] = {}  # expiries per chunk -> backoff exponent
        self._assigned: dict[int, str] = {}  # chunk -> peer of the last request
        self._timeouts: list[tuple[int, str]] = []  # drained by take_timeouts
        self._lock = threading.Lock()

    def next_request(self, timeout: float = 10.0, now: float | None = None) -> int | None:
        with self._lock:
            now = time.monotonic() if now is None else now
            for i in range(self.n):
                if self.chunks[i] is not None:
                    continue
                prev = self._requested.get(i)
                if prev is None:
                    self._requested[i] = now
                    return i
                backoff = timeout * (2 ** min(self._fails.get(i, 0), self.BACKOFF_CAP))
                if now - prev > backoff:
                    self._fails[i] = self._fails.get(i, 0) + 1
                    peer = self._assigned.get(i)
                    if peer:
                        self._timeouts.append((i, peer))
                    self._requested[i] = now
                    return i
            return None

    def mark_assigned(self, index: int, peer: str) -> None:
        with self._lock:
            self._assigned[index] = peer

    def take_timeouts(self) -> list[tuple[int, str]]:
        """Drain (chunk, peer) pairs whose outstanding request expired
        since the last drain."""
        with self._lock:
            out, self._timeouts = self._timeouts, []
            return out

    def fail_count(self, index: int) -> int:
        with self._lock:
            return self._fails.get(index, 0)

    def add(self, index: int, chunk: bytes, sender: str) -> bool:
        with self._lock:
            if index >= self.n or self.chunks[index] is not None:
                return False
            self.chunks[index] = chunk
            self.senders[index] = sender
            return True

    def refetch(self, indexes: list[int]) -> None:
        """App-driven re-request (corrupt/rejected chunk): clear the
        data and the request clock so the chunk is immediately
        re-requestable. The backoff exponent survives — a chunk that
        keeps timing out AND failing verification must not snap back
        to the base cadence."""
        with self._lock:
            for i in indexes:
                if 0 <= i < self.n:
                    self.chunks[i] = None
                    self._requested.pop(i, None)
                    self._assigned.pop(i, None)

    def complete(self) -> bool:
        with self._lock:
            return all(c is not None for c in self.chunks)

    def next_unapplied(self, applied: int) -> tuple[int, bytes, str] | None:
        with self._lock:
            if applied < self.n and self.chunks[applied] is not None:
                return applied, self.chunks[applied], self.senders.get(applied, "")
            return None


class Syncer:
    """ref: syncer.go:54 syncer."""

    DISCOVERY_WAIT = 2.0
    CHUNK_TIMEOUT = 5.0
    FETCH_STALL = 15.0
    # rotate away from a peer once this many of its chunk requests
    # expired without a response (one delivered chunk resets it)
    PEER_ROTATE_TIMEOUTS = 3

    def __init__(self, app_client, state_provider, request_snapshots, request_chunk, logger=None,
                 metrics=None):
        """request_snapshots() broadcasts a GetSnapshots query;
        request_chunk(snapshot, index, peers) asks a peer for a chunk.
        state_provider: .app_hash(height), .state(height), .commit(height)."""
        self.app = app_client
        self.state_provider = state_provider
        self.request_snapshots = request_snapshots
        self.request_chunk = request_chunk
        self.metrics = metrics  # StateSyncMetrics (ref: statesync/metrics.go)
        self.snapshots = _SnapshotPool()
        self.chunks: _ChunkQueue | None = None
        self._current: abci.Snapshot | None = None
        self._missing = False
        self._lock = threading.Lock()
        # chunk-fetch peer scheduling: consecutive expired requests per
        # peer; at PEER_ROTATE_TIMEOUTS the peer is passed over until a
        # chunk it sent lands (guarded by _lock with the queue swap)
        self._peer_timeouts: dict[str, int] = {}
        self._rr = 0  # round-robin cursor over healthy peers

    def _count_retry(self, result: str, n: int = 1) -> None:
        if self.metrics is not None:
            self.metrics.chunk_retries.add(n, result)

    # ------------------------------------------------------------ inbound

    def add_snapshot(self, peer_id: str, snapshot: abci.Snapshot) -> bool:
        added = self.snapshots.add(peer_id, snapshot)
        if added and self.metrics is not None:
            self.metrics.snapshots_discovered.add(1)
        return added

    def add_chunk(self, index: int, chunk: bytes, sender: str) -> bool:
        with self._lock:
            if self.chunks is None:
                return False
            added = self.chunks.add(index, chunk, sender)
            if added and sender:
                # a delivered chunk clears the peer's timeout strikes
                self._peer_timeouts.pop(sender, None)
            return added

    def note_missing(self, height: int, format: int) -> None:
        """Peer no longer has a chunk of the current snapshot (pruned) —
        abandon this snapshot and rediscover."""
        with self._lock:
            if self._current is not None and self._current.height == height and self._current.format == format:
                self._missing = True

    def remove_peer(self, peer_id: str) -> None:
        self.snapshots.remove_peer(peer_id)

    def _pick_peer(self, peers: list[str]) -> str:
        """Round-robin over peers that have NOT accumulated
        PEER_ROTATE_TIMEOUTS consecutive expired chunk requests; when
        every peer is struck out, fall back to the full set with fresh
        strikes (rotation must degrade a peer, never starve the
        fetch)."""
        with self._lock:
            healthy = [
                p for p in peers
                if self._peer_timeouts.get(p, 0) < self.PEER_ROTATE_TIMEOUTS
            ]
            if not healthy:
                self._peer_timeouts = {}
                healthy = list(peers)
            self._rr += 1
            return healthy[self._rr % len(healthy)]

    # -------------------------------------------------------------- sync

    def sync_any(self, discovery_time: float = 15.0, stop_event: threading.Event | None = None):
        """Try snapshots until one restores; returns (state, commit)
        (ref: syncer.go:126 SyncAny)."""
        stop_event = stop_event or threading.Event()
        deadline = time.monotonic() + discovery_time
        while not stop_event.is_set():
            self.request_snapshots()
            snapshot = self.snapshots.best()
            if snapshot is None:
                if time.monotonic() > deadline:
                    raise ErrNoSnapshots("no viable snapshots discovered")
                stop_event.wait(self.DISCOVERY_WAIT)
                continue
            try:
                return self._sync_snapshot(snapshot, stop_event)
            except (ErrRejectSnapshot, StateSyncError):
                self.snapshots.reject(snapshot)
                deadline = time.monotonic() + discovery_time
        raise StateSyncError("statesync aborted")

    def _sync_snapshot(self, snapshot: abci.Snapshot, stop_event: threading.Event):
        """ref: syncer.go:262 Sync: verify app hash via light client,
        OfferSnapshot, fetch+apply chunks, verify final state."""
        # 1. trusted app hash for the snapshot height (+1 header carries
        # it). Any light-client failure here — e.g. the +1 block doesn't
        # exist yet because the snapshot sits at the provider's tip —
        # drops THIS snapshot and tries the next (ref: syncer.go:269-282
        # "Dropping snapshot and trying again" → errRejectSnapshot).
        try:
            app_hash = self.state_provider.app_hash(snapshot.height)
        except Exception as e:
            if is_fault(e):
                raise
            raise ErrRejectSnapshot(
                f"failed to verify state at snapshot height {snapshot.height}: {e}"
            )

        # 2. offer to the app (syncer.go:320 offerSnapshot)
        resp = self.app.offer_snapshot(abci.RequestOfferSnapshot(snapshot=snapshot, app_hash=app_hash))
        if resp.result == abci.SNAPSHOT_REJECT:
            raise ErrRejectSnapshot("snapshot rejected by app")
        if resp.result in (abci.SNAPSHOT_REJECT_FORMAT, abci.SNAPSHOT_REJECT_SENDER):
            raise ErrRejectSnapshot(f"snapshot rejected: {resp.result}")
        if resp.result != abci.SNAPSHOT_ACCEPT:
            raise StateSyncError(f"unexpected OfferSnapshot result {resp.result}")

        with self._lock:
            self.chunks = _ChunkQueue(snapshot.chunks)
            self._current = snapshot
            self._missing = False
            self._peer_timeouts = {}
            self._rr = 0

        # 3. fetch + apply strictly in order (syncer.go:380 fetchChunks /
        #    applyChunks — the e2e app requires ordered apply). A stall
        #    (no progress for FETCH_STALL) abandons the snapshot.
        applied = 0
        peers = self.snapshots.peers_of(snapshot)
        last_progress = time.monotonic()
        while applied < snapshot.chunks and not stop_event.is_set():
            if self._missing:
                raise ErrRejectSnapshot("peer no longer has the snapshot's chunks")
            if time.monotonic() - last_progress > self.FETCH_STALL:
                raise ErrRejectSnapshot("chunk fetching stalled")
            entry = self.chunks.next_unapplied(applied)
            if entry is None:
                idx = self.chunks.next_request(self.CHUNK_TIMEOUT)
                # account the expiries next_request just detected: each
                # is a strike against the peer whose request went dark
                for _i, peer in self.chunks.take_timeouts():
                    self._count_retry("timeout")
                    with self._lock:
                        strikes = self._peer_timeouts.get(peer, 0) + 1
                        self._peer_timeouts[peer] = strikes
                    if strikes == self.PEER_ROTATE_TIMEOUTS:
                        self._count_retry("peer_rotated")
                if idx is not None and peers:
                    peer = self._pick_peer(peers)
                    self.chunks.mark_assigned(idx, peer)
                    self.request_chunk(snapshot, idx, [peer])
                stop_event.wait(0.05)
                continue
            index, chunk, sender = entry
            chunk_t0 = time.monotonic()
            last_progress = chunk_t0
            resp = self.app.apply_snapshot_chunk(
                abci.RequestApplySnapshotChunk(index=index, chunk=chunk, sender=sender)
            )
            if resp.result == abci.CHUNK_ACCEPT:
                applied += 1
                if self.metrics is not None:
                    self.metrics.chunks_applied.add(1)
                    self.metrics.chunk_process_time.observe(time.monotonic() - chunk_t0)
                continue
            if resp.result == abci.CHUNK_RETRY:
                self.chunks.refetch([index])
                self._count_retry("refetch")
                continue
            if resp.result == abci.CHUNK_RETRY_SNAPSHOT:
                refetched = resp.refetch_chunks or list(range(snapshot.chunks))
                self.chunks.refetch(refetched)
                self._count_retry("refetch", len(refetched))
                applied = 0
                continue
            raise ErrRejectSnapshot(f"chunk apply failed: {resp.result}")

        if stop_event.is_set():
            raise StateSyncError("statesync aborted")

        # 4. verify the app restored to the trusted hash (syncer.go:470)
        info = self.app.info(abci.RequestInfo())
        if info.last_block_app_hash != app_hash:
            raise ErrRejectSnapshot(
                f"app hash mismatch after restore: {info.last_block_app_hash.hex()} != {app_hash.hex()}"
            )
        if info.last_block_height != snapshot.height:
            raise ErrRejectSnapshot(
                f"app height mismatch after restore: {info.last_block_height} != {snapshot.height}"
            )

        # 5. build the framework state + seen commit (syncer.go:500).
        # Provider failures here — e.g. the +2 light block does not
        # exist yet because the chain stalled right at the snapshot
        # height — must REJECT the snapshot (sync_any rediscovers and
        # retries, picking up a newer snapshot once the chain moves),
        # not kill the statesync thread and strand the joiner at
        # genesis.
        try:
            state = self.state_provider.state(snapshot.height)
            commit = self.state_provider.commit(snapshot.height)
        except Exception as e:
            if is_fault(e):
                raise
            raise ErrRejectSnapshot(
                f"failed to build state at snapshot height {snapshot.height}: {e}"
            )
        return state, commit
