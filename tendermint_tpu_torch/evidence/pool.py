"""Evidence pool (ref: internal/evidence/pool.go).

Holds the pending (uncommitted, unexpired) evidence in a key-value store
and in memory, for gossip and for proposals. Consensus reports conflicting
votes with `report_conflicting_votes` (pool.go:187); they become
DuplicateVoteEvidence at the next `update`, once the block time is known
(pool.go:132 processConsensusBuffer). Light-client attack evidence is
verified through the batch verifiers on `device`: the card unless "cpu".
"""

from __future__ import annotations

import threading

from ..proto import messages as pb
from ..types.evidence import (
    DuplicateVoteEvidence,
    evidence_from_proto,
    evidence_to_proto,
)
from .verify import EvidenceABCIError, EvidenceVerifyError, verify_evidence

_PENDING_PREFIX = b"ev/pending/"
_COMMITTED_PREFIX = b"ev/committed/"


class EvidenceError(Exception):
    """ref: types.ErrInvalidEvidence."""


def _key(prefix: bytes, ev) -> bytes:
    return prefix + ev.height.to_bytes(8, "big") + ev.hash()


def _ev_type(ev) -> str:
    """The label of evidence_total and evidence_pending: the two proto
    oneof arms, or the class name of anything else."""
    name = type(ev).__name__
    return {
        "DuplicateVoteEvidence": "duplicate_vote",
        "LightClientAttackEvidence": "light_client_attack",
    }.get(name, name)


class EvidencePool:
    """ref: evidence.Pool (pool.go:42)."""

    def __init__(self, db, state_store, block_store, logger=None, metrics=None, device=None):
        self.db = db
        self.state_store = state_store
        self.block_store = block_store
        self.logger = logger
        self.metrics = metrics  # EvidenceMetrics (ref: evidence/metrics.go)
        self.device = device  # where verify_evidence's commit checks run
        self._lock = threading.RLock()
        self._pending: dict[bytes, object] = {}  # hash → evidence
        self._consensus_buffer: list[tuple] = []  # (vote_a, vote_b)
        self._state = state_store.load()
        self._load_pending()

    # ------------------------------------------------------------- queries

    def pending_evidence(self, max_bytes: int) -> tuple[list, int]:
        """Evidence for block inclusion, within the byte budget; returns
        (evidence, total_bytes) (ref: pool.go:90 PendingEvidence)."""
        with self._lock:
            out, size = [], 0
            for ev in sorted(self._pending.values(), key=lambda e: (e.height, e.hash())):
                sz = len(ev.bytes()) + 8  # proto overhead margin
                if size + sz > max_bytes:
                    break
                out.append(ev)
                size += sz
            return out, size

    def size(self) -> int:
        with self._lock:
            return len(self._pending)

    # ------------------------------------------------------------ mutation

    def add_evidence(self, ev) -> None:
        """Validate + persist new (gossiped or locally formed) evidence
        (ref: pool.go:118 AddEvidence)."""
        with self._lock:
            h = ev.hash()
            if h in self._pending or self._is_committed(ev):
                return  # idempotent
            try:
                verify_evidence(ev, self._state, self.state_store,
                                self.block_store, metrics=self.metrics, device=self.device)
            except EvidenceABCIError as e:
                # Structurally valid but the ABCI component is wrong:
                # regenerate it, store the rectified evidence, and still
                # reject the original (ref: verify.go:76-81,:136-142).
                self._count_outcome(ev, "rejected")
                e.regenerate()
                self._add_pending(ev)
                raise
            except EvidenceVerifyError:
                self._count_outcome(ev, "rejected")
                raise
            self._count_outcome(ev, "verified")
            self._add_pending(ev)

    def report_conflicting_votes(self, vote_a, vote_b) -> None:
        """Called by consensus on a double-sign (ref: pool.go:187
        ReportConflictingVotes). Buffered until the next Update when the
        block time and validator set are final."""
        with self._lock:
            self._consensus_buffer.append((vote_a, vote_b))

    def check_evidence(self, ev_list: list, device=None) -> None:
        """Validate a proposed block's evidence list (ref: pool.go:200
        CheckEvidence). Raises EvidenceError on any invalid item. `device`
        (the BlockExecutor's) overrides the pool's own when given."""
        device = self.device if device is None else device
        hashes = set()
        with self._lock:
            for ev in ev_list:
                h = ev.hash()
                if h in hashes:
                    raise EvidenceError("duplicate evidence in list")
                hashes.add(h)
                if self._is_committed(ev):
                    raise EvidenceError("evidence was already committed")
                if h not in self._pending:
                    try:
                        verify_evidence(ev, self._state, self.state_store,
                                        self.block_store, metrics=self.metrics, device=device)
                    except EvidenceVerifyError as e:
                        self._count_outcome(ev, "rejected")
                        raise EvidenceError(str(e))
                    self._count_outcome(ev, "verified")
                    self._add_pending(ev)

    def update(self, state, ev_list: list) -> None:
        """Bookkeeping after a commit (ref: pool.go:102 Update): mark the
        block's evidence committed, turn the buffered conflicting votes into
        evidence, prune the expired."""
        with self._lock:
            if state.last_block_height <= self._state.last_block_height:
                raise ValueError(
                    f"failed EvidencePool.Update: new state height {state.last_block_height} "
                    f"not greater than previous {self._state.last_block_height}"
                )
            self._state = state
            for ev in ev_list:
                self._mark_committed(ev)
                self._count_outcome(ev, "committed")
            if ev_list and self.metrics is not None:
                self.metrics.committed.add(len(ev_list))
            self._process_consensus_buffer(state)
            self._prune_expired()
            self._set_pending_gauges()

    # ------------------------------------------------------------ internals

    def _load_pending(self) -> None:
        for key, value in self.db.iterator(_PENDING_PREFIX, _PENDING_PREFIX + b"\xff"):
            ev = evidence_from_proto(pb.Evidence.decode(value))
            self._pending[ev.hash()] = ev

    def _add_pending(self, ev) -> None:
        self._pending[ev.hash()] = ev
        self.db.set(_key(_PENDING_PREFIX, ev), evidence_to_proto(ev).encode())
        self._set_pending_gauges()

    def _count_outcome(self, ev, outcome: str) -> None:
        if self.metrics is not None:
            self.metrics.total.add(1, _ev_type(ev), outcome)

    def _set_pending_gauges(self) -> None:
        if self.metrics is None:
            return
        self.metrics.num_evidence.set(len(self._pending))
        counts = {"duplicate_vote": 0, "light_client_attack": 0}
        for ev in self._pending.values():
            counts[_ev_type(ev)] = counts.get(_ev_type(ev), 0) + 1
        for t, n in counts.items():
            self.metrics.pending.set(n, t)

    def _mark_committed(self, ev) -> None:
        h = ev.hash()
        self._pending.pop(h, None)
        self.db.delete(_key(_PENDING_PREFIX, ev))
        # committed marker carries only the height (pool.go:272)
        self.db.set(_COMMITTED_PREFIX + h, ev.height.to_bytes(8, "big"))

    def _is_committed(self, ev) -> bool:
        return self.db.has(_COMMITTED_PREFIX + ev.hash())

    def _process_consensus_buffer(self, state) -> None:
        """ref: pool.go:132 processConsensusBuffer."""
        for vote_a, vote_b in self._consensus_buffer:
            try:
                val_set = self.state_store.load_validators(vote_a.height)
                if val_set is None:
                    continue
                block_meta = self.block_store.load_block_meta(vote_a.height)
                ev_time = block_meta.header.time if block_meta else state.last_block_time
                ev = DuplicateVoteEvidence.new(vote_a, vote_b, ev_time, val_set)
                if ev.hash() not in self._pending and not self._is_committed(ev):
                    self._add_pending(ev)
            except Exception:
                continue
        self._consensus_buffer.clear()

    def _prune_expired(self) -> None:
        """Both windows must lapse (ref: pool.go:264
        removeExpiredPendingEvidence, isExpired pool.go:480: height and
        time)."""
        params = self._state.consensus_params.evidence
        height = self._state.last_block_height
        now_ns = self._state.last_block_time.unix_ns()
        for h, ev in list(self._pending.items()):
            expired_height = ev.height <= height - params.max_age_num_blocks
            expired_time = ev.time.unix_ns() <= now_ns - params.max_age_duration
            if expired_height and expired_time:
                self._pending.pop(h, None)
                self.db.delete(_key(_PENDING_PREFIX, ev))
                self._count_outcome(ev, "expired")
