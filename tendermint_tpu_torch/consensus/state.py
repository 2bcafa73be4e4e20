"""Consensus state machine — Tendermint BFT
(ref: internal/consensus/state.go).

Architecture preserved from the reference: ONE consumer thread
(`receive_routine`) serializes peer messages, internal messages, and
timeouts, writing each to the WAL before acting (fsync for the node's
own messages). RoundState is owned exclusively by that thread — the
single-goroutine discipline the reference calls out as a correctness
feature (no locks in the hot path).

Outbound messages (proposal, block parts, votes, step events) go
through the `broadcast` hook; the reactor (or an in-process test
harness) fans them out to peers.

The proposal block's LastCommit is checked by the BlockExecutor, on the
card unless the executor was given device="cpu"; each vote is checked on
the host (types/vote_set.py). Any error of validate_block leads to a nil
prevote, as in the reference, but a fault of the verifier (marked by
crypto.batch.mark_fault: a kernel wrapper's ValueError, a failed build or
launch) is no verdict: it propagates out of the step to _receive_routine,
which hands it to on_fatal, and _handle_msg and _try_add_vote, which read a
ValueError as a rejected message or vote, let it through as well.
"""

from __future__ import annotations

import queue
import threading
import time as _pytime
import traceback
from typing import Callable

from .. import trace as _trace
from ..crypto.batch import is_fault
from ..state.execution import BlockExecutor
from ..state.state import State
from ..types.block import (
    BLOCK_ID_FLAG_COMMIT,
    BLOCK_PART_SIZE_BYTES,
    BlockID,
    Commit,
    PartSetHeader,
)
from ..types.part_set import PartSet
from ..types.proposal import Proposal
from ..types.vote import PRECOMMIT, PREVOTE, Vote
from ..types.vote_set import ConflictingVoteError, VoteSet
from ..utils.tmtime import Time
from .messages import (
    BlockPartMessage,
    HasVoteMessage,
    NewRoundStepMessage,
    ProposalMessage,
    VoteMessage,
)
from .round_state import (
    STEP_COMMIT,
    STEP_NEW_HEIGHT,
    STEP_NEW_ROUND,
    STEP_PRECOMMIT,
    STEP_PRECOMMIT_WAIT,
    STEP_PREVOTE,
    STEP_PREVOTE_WAIT,
    STEP_PROPOSE,
    HeightVoteSet,
    RoundState,
)
from .ticker import TimeoutTicker
from .wal import WAL, EndHeightMessage, EventRoundStep, MsgInfo, TimeoutInfo


class ConsensusError(Exception):
    pass


class _NopWAL:
    def write(self, msg):
        pass

    def write_sync(self, msg):
        pass

    def flush_and_sync(self):
        pass

    def close(self):
        pass

    def search_for_end_height(self, height):
        return []

    def search_for_end_height_with_status(self, height):
        return [], True

    def repair(self):
        return False


class ConsensusState:
    """ref: consensus.State (internal/consensus/state.go:123)."""

    def __init__(
        self,
        state: State,
        block_executor: BlockExecutor,
        block_store,
        priv_validator=None,
        wal: WAL | None = None,
        evidence_pool=None,
        broadcast: Callable | None = None,
        on_decided: Callable | None = None,
        clock: Callable[[], Time] = Time.now,
        metrics=None,
        logger=None,
        on_fatal: Callable | None = None,
        wait_for_txs: bool = False,
        create_empty_blocks_interval: float = 0.0,
        mempool=None,
        double_sign_check_height: int = 0,
    ):
        from ..utils.log import new_logger

        # ref: config.ConsensusConfig.DoubleSignCheckHeight — refuse to
        # start if our own signature appears in the last N commits.
        self.double_sign_check_height = double_sign_check_height
        # create_empty_blocks=false plumbing (ref: config.WaitForTxs)
        self.wait_for_txs = wait_for_txs
        self.create_empty_blocks_interval = create_empty_blocks_interval
        self.mempool = mempool

        self.block_exec = block_executor
        self.block_store = block_store
        self.priv_validator = priv_validator
        self.priv_pub_key = priv_validator.get_pub_key() if priv_validator else None
        self.wal = wal if wal is not None else _NopWAL()
        self.evpool = evidence_pool
        self.broadcast = broadcast or (lambda msg: None)
        self.on_decided = on_decided or (lambda height, block, block_id: None)
        self.now = clock
        self.metrics = metrics
        self.logger = logger or new_logger("consensus")
        # Invoked when the state machine dies — the node must halt rather
        # than keep serving from a dead machine (ref: state.go:899-938
        # "CONSENSUS FAILURE!!!" panics the whole process).
        self.on_fatal = on_fatal or (lambda exc: None)

        self.rs = RoundState()
        self.state = State()  # set by update_to_state
        self.replay_mode = False
        # our p2p node id (set by node.py after construction) — the
        # originator half of block-journey keys for events this node
        # creates (proposal build); "" keeps keys deterministic-but-
        # anonymous in harnesses that never wire an identity
        self.node_id = ""

        self._queue: queue.Queue = queue.Queue(maxsize=1000)
        self._internal_queue: queue.Queue = queue.Queue(maxsize=1000)
        self.ticker = TimeoutTicker(self._tock)
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        # the WAL is closed once the consumer thread has ended (close_wal):
        # a close asked for while the thread still handles a message is
        # left to the thread's way out, so no record meets a closed file
        self._exit_lock = threading.Lock()
        self._running = False
        self._close_wal_on_exit = False
        self._n_steps = 0
        # quorum-assembly timing (consensus_quorum_assembly_seconds):
        # first vote seen for (height, round, type) -> 2/3 majority.
        # Cleared at every height transition (update_to_state).
        self._quorum_clock: dict[tuple, float] = {}
        self._quorum_done: set[tuple] = set()
        # block-journey anchors, trace-clock µs (cleared per height):
        # first-vote times for retrospective journey.quorum spans and
        # first-block-part times for journey.block_assembled
        self._quorum_trace_us: dict[tuple, float] = {}
        self._part_trace_us: dict[int, float] = {}

        self.update_to_state(state)
        # Boot-time reconstruction is best-effort: a statesync-restored
        # node on a vote-extension chain has NO ExtendedCommit until
        # blocksync applies its first block, and must still be able to
        # construct (it boots into statesync/blocksync, not consensus).
        # The blocksync->consensus switch re-runs this strictly
        # (switch_to_state) where the data is guaranteed.
        self._reconstruct_last_commit_if_needed(state, strict=False)

    # ---------------------------------------------------------- lifecycle

    def start(self, replay: bool = True) -> None:
        """Replay the WAL from the last height boundary, then launch the
        consumer thread (ref: OnStart state.go:393 → catchupReplay)."""
        self._check_double_signing_risk()
        if replay:
            self._catchup_replay()
        self._stop.clear()
        self._running = True
        self._thread = threading.Thread(target=self._receive_routine, daemon=True, name="consensus")
        self._thread.start()
        self._schedule_round_0()

    def _check_double_signing_risk(self) -> None:
        """Refuse to start signing if our own signature is present in a
        recent commit: a validator restoring onto a chain it recently
        signed (lost state, duplicated deployment) would equivocate.
        ref: state.go checkDoubleSigningRisk (internal/consensus/
        state.go:2663) — scans the double_sign_check_height most recent
        commits for our address and errors out, halting node start."""
        n = self.double_sign_check_height
        height = self.state.last_block_height
        if n <= 0 or height <= 0 or self.priv_pub_key is None:
            return
        addr = self.priv_pub_key.address()
        for i in range(min(n, height)):
            h = height - i
            commit = self.block_store.load_seen_commit(h) if i == 0 else None
            if commit is None:
                commit = self.block_store.load_block_commit(h)
            if commit is None:
                continue
            for sig in commit.signatures:
                if sig.block_id_flag == BLOCK_ID_FLAG_COMMIT and sig.validator_address == addr:
                    raise RuntimeError(
                        f"consensus: own signature found in commit at height {h} "
                        f"(within double_sign_check_height={n}); this key appears "
                        "to be validating elsewhere — refusing to start"
                    )

    def stop(self) -> None:
        self._stop.set()
        self.ticker.stop()
        try:
            self._queue.put_nowait(None)
        except queue.Full:
            pass  # consumer sees _stop on its next poll timeout
        if self._thread is not None:
            self._thread.join(timeout=5)
        self.wal.flush_and_sync()

    def close_wal(self) -> None:
        """Close the WAL once the consumer thread has ended: now if it
        has, else by the thread itself after the message in hand (stop()'s
        join gives up after 5 s; a record written after that still lands
        in the open file)."""
        with self._exit_lock:
            if self._running:
                self._close_wal_on_exit = True
                return
        self.wal.close()

    # ------------------------------------------------------------- inputs

    def add_peer_message(self, msg, peer_id: str) -> None:
        """Entry point for reactor-delivered messages (peerMsgQueue).

        Only the three data-plane kinds reach the state machine — the
        reactor handles gossip-control messages (NewRoundStep, HasVote,
        VoteSetMaj23…) itself, as in the reference — which also keeps the
        WAL codec closed over exactly these types."""
        if not isinstance(msg, (ProposalMessage, BlockPartMessage, VoteMessage)):
            return
        self._queue.put(MsgInfo(msg, peer_id))

    def _send_internal(self, msg) -> None:
        """ref: sendInternalMessage state.go — internal queue has
        priority and is fsync'd in the WAL. Never blocks: the caller IS
        the consumer thread, so a blocking put on a full queue would
        self-deadlock (the reference uses select/default + goroutine
        fallback for exactly this reason)."""
        self._internal_queue.put(MsgInfo(msg, ""))
        try:
            self._queue.put_nowait(("internal",))  # wake the consumer
        except queue.Full:
            # Queue is saturated with peer messages; the consumer drains
            # the internal queue opportunistically via the next wake.
            threading.Thread(
                target=lambda: self._queue.put(("internal",)), daemon=True
            ).start()

    def _tock(self, ti: TimeoutInfo) -> None:
        self._queue.put(ti)

    def handle_txs_available(self) -> None:
        """Mempool signal (ref: handleTxsAvailable state.go:1143): with
        create_empty_blocks=false, the waiting round 0 proceeds to
        propose as soon as the mempool has txs. Enqueued to the consumer
        thread like every other input."""
        self._queue.put(("txs_available",))

    def _handle_txs_available(self) -> None:
        rs = self.rs
        if not self.wait_for_txs:
            return
        if rs.step == STEP_NEW_HEIGHT:
            # still in the commit timeout: shorten it (state.go:1150)
            remaining = (rs.start_time.unix_ns() - self.now().unix_ns()) / 1e9
            self._schedule_timeout(max(remaining, 0.0) + 1e-3, rs.height, 0, STEP_NEW_HEIGHT)
        elif rs.step == STEP_NEW_ROUND:
            self._enter_propose(rs.height, 0)

    # -------------------------------------------------------- the routine

    def _receive_routine(self) -> None:
        """THE hot loop (ref: receiveRoutine state.go:888)."""
        try:
            self._receive_loop()
        finally:
            with self._exit_lock:
                self._running = False
                close = self._close_wal_on_exit
            if close:
                self.wal.close()

    def _receive_loop(self) -> None:
        while not self._stop.is_set():
            try:
                item = self._queue.get(timeout=0.1)
            except queue.Empty:
                continue
            if item is None:
                break
            try:
                self._dispatch(item)
            except Exception as exc:
                # ref: state.go:899 "CONSENSUS FAILURE!!!" — halt, don't
                # limp along with corrupted round state. on_fatal stops
                # the whole node (router, RPC, mempool included).
                self.logger.error(
                    "CONSENSUS FAILURE!!!", err=repr(exc), height=self.rs.height, round=self.rs.round
                )
                traceback.print_exc()
                self._stop.set()
                try:
                    self.on_fatal(exc)
                finally:
                    raise

    def _dispatch(self, item) -> None:
        # Internal messages drain first (they carry our own votes).
        if isinstance(item, tuple) and item and item[0] == "txs_available":
            self._handle_txs_available()
        elif isinstance(item, tuple) and item and item[0] == "internal":
            try:
                mi = self._internal_queue.get_nowait()
            except queue.Empty:
                return
            self.wal.write_sync(mi)  # fsync own messages (state.go:964)
            self._handle_msg(mi)
        elif isinstance(item, MsgInfo):
            self.wal.write(item)
            self._handle_msg(item)
        elif isinstance(item, TimeoutInfo):
            self.wal.write(item)
            self._handle_timeout(item)

    def process_all(self, timeout: float = 0.0) -> None:
        """Synchronously drain pending inputs — used by replay and by
        deterministic tests that drive the machine without the thread."""
        while True:
            try:
                item = self._queue.get(timeout=timeout)
            except queue.Empty:
                return
            if item is None:
                return
            self._dispatch(item)

    def _handle_msg(self, mi: MsgInfo) -> None:
        """ref: handleMsg (state.go:994). Per-message validation failures
        are logged, never fatal — a malformed or stale proposal/part must
        not kill the node (the reference logs 'failed to process message'
        and keeps going, state.go:1032-1086). This includes our OWN parts
        from the internal queue: after a round race, a proposer's queued
        parts can mismatch a newer accepted proposal's part-set header —
        stale data, not corruption. Invariant breaks in the step
        functions (ConsensusError) stay fatal."""
        msg, peer_id = mi.msg, mi.peer_id
        added = False
        try:
            if isinstance(msg, ProposalMessage):
                self._set_proposal(msg.proposal, self.now(),
                                   origin=getattr(msg, "origin_node", ""))
            elif isinstance(msg, BlockPartMessage):
                added = self._add_proposal_block_part(msg)
            elif isinstance(msg, VoteMessage):
                self._try_add_vote(msg.vote, peer_id)
        except (ValueError, KeyError) as e:
            if is_fault(e):
                raise
            self.logger.error(
                "failed to process message",
                peer=peer_id or "internal", msg_type=type(msg).__name__, err=str(e),
                height=self.rs.height, round=self.rs.round,
            )
            return
        # The complete-proposal path can drive prevote → commit; errors in
        # THERE are invariant breaks and must stay fatal (the reference
        # panics inside finalizeCommit), so it runs outside the catch.
        if added and self.rs.proposal_block_parts.is_complete():
            self._handle_complete_proposal(msg.height)

    def _handle_timeout(self, ti: TimeoutInfo) -> None:
        """ref: handleTimeout (state.go:1089)."""
        rs = self.rs
        if ti.height != rs.height or ti.round < rs.round or (ti.round == rs.round and ti.step < rs.step):
            return
        if ti.step == STEP_NEW_HEIGHT:
            self._enter_new_round(ti.height, 0)
        elif ti.step == STEP_NEW_ROUND:
            self._enter_propose(ti.height, ti.round)
        elif ti.step == STEP_PROPOSE:
            self._enter_prevote(ti.height, ti.round)
        elif ti.step == STEP_PREVOTE_WAIT:
            self._enter_precommit(ti.height, ti.round)
        elif ti.step == STEP_PRECOMMIT_WAIT:
            self._enter_precommit(ti.height, ti.round)
            self._enter_new_round(ti.height, ti.round + 1)
        else:
            raise ConsensusError(f"invalid timeout step: {ti.step}")

    # ------------------------------------------------------ state updates

    def switch_to_state(self, state: State) -> None:
        """Blocksync/statesync -> consensus transition (ref:
        SwitchToConsensus, consensus/reactor.go:256): rebuild the last
        commit from the SYNCED chain — any set reconstructed at boot
        predates the sync, and on a vote-extension chain the stored
        ExtendedCommit is the only valid source — then reset RoundState."""
        if state.last_block_height > 0:
            self.rs.last_commit = None
            self._reconstruct_last_commit_if_needed(state)  # strict
        self.update_to_state(state)

    def update_to_state(self, state: State) -> None:
        """Reset RoundState for the next height (ref: updateToState
        state.go:752)."""
        rs = self.rs
        if rs.commit_round > -1 and 0 < rs.height and rs.height != state.last_block_height:
            raise ConsensusError(
                f"updateToState() expected state height of {rs.height} but found {state.last_block_height}"
            )
        if not self.state.is_empty and self.state.last_block_height + 1 != rs.height and self.state.last_block_height > 0:
            raise ConsensusError(
                f"inconsistent cs.state.LastBlockHeight+1 {self.state.last_block_height + 1} vs cs.Height {rs.height}"
            )
        if not self.state.is_empty and state.last_block_height <= self.state.last_block_height:
            self._new_step()
            return

        # LastCommit: the precommits that justified the block we just did
        if state.last_block_height == 0:
            last_commit = None
        elif rs.commit_round > -1 and rs.votes is not None:
            precommits = rs.votes.precommits(rs.commit_round)
            if not precommits.has_two_thirds_majority():
                raise ConsensusError("wanted to form a commit, but precommits didn't have 2/3+")
            last_commit = precommits
        else:
            last_commit = rs.last_commit  # reconstructed from seen commit

        height = state.last_block_height + 1
        if height == 1:
            height = state.initial_height

        rs.height = height
        rs.round = 0
        rs.step = STEP_NEW_HEIGHT
        commit_t = rs.commit_time if not rs.commit_time.is_zero() else self.now()
        rs.start_time = commit_t.add(state.consensus_params.timeout.commit)
        rs.validators = state.validators
        rs.proposal = None
        rs.proposal_receive_time = Time()
        rs.proposal_block = None
        rs.proposal_block_parts = None
        rs.locked_round = -1
        rs.locked_block = None
        rs.locked_block_parts = None
        rs.valid_round = -1
        rs.valid_block = None
        rs.valid_block_parts = None
        rs.votes = HeightVoteSet(
            state.chain_id, height, state.validators,
            extensions_enabled=state.consensus_params.abci.vote_extensions_enabled(height),
        )
        rs.commit_round = -1
        rs.last_commit = last_commit
        rs.last_validators = state.last_validators
        rs.triggered_timeout_precommit = False
        self._quorum_clock.clear()
        self._quorum_done.clear()
        self._quorum_trace_us.clear()
        self._part_trace_us.clear()
        self.state = state
        if self.metrics is not None:
            self.metrics.validators.set(state.validators.size())
            self.metrics.validators_power.set(state.validators.total_voting_power())
        self._new_step()

    def _reconstruct_last_commit_if_needed(self, state: State, strict: bool = True) -> None:
        """Rebuild LastCommit VoteSet from storage (ref:
        reconstructLastCommit state.go:704-745). When vote extensions
        were enabled at last_block_height the set MUST be rebuilt from
        the stored ExtendedCommit via an extensions-verifying vote set —
        a plain set rebuilt from the seen commit lacks extension
        signatures, so 1-behind peers' extended precommit sets would
        reject every gossiped vote."""
        if state.last_block_height == 0 or self.rs.last_commit is not None:
            return
        last_vals = self.block_exec.store.load_validators(state.last_block_height)
        if state.consensus_params.abci.vote_extensions_enabled(state.last_block_height):
            votes = (
                self.block_store.load_extended_commit(state.last_block_height)
                if self.block_store else None
            )
            if votes is None:
                if not strict:
                    self.logger.info(
                        "no extended commit yet for last height; deferring "
                        "last-commit reconstruction to the sync switch",
                        height=state.last_block_height,
                    )
                    return
                raise ConsensusError(
                    f"failed to reconstruct last extended commit; extended commit for "
                    f"height {state.last_block_height} not found"
                )
            round_ = next((v.round for v in votes if v is not None), None)
            if round_ is None:
                raise ConsensusError("failed to reconstruct last extended commit; all slots absent")
            vote_set = VoteSet.extended(
                state.chain_id, state.last_block_height, round_, PRECOMMIT, last_vals
            )
            for vote in votes:
                if vote is not None:
                    vote_set.add_vote(vote)
            if not vote_set.has_two_thirds_majority():
                raise ConsensusError("failed to reconstruct last extended commit; does not have +2/3 maj")
            self.rs.last_commit = vote_set
            return
        seen = self.block_store.load_seen_commit(state.last_block_height) if self.block_store else None
        if seen is None:
            raise ConsensusError(f"failed to reconstruct last commit; seen commit for height {state.last_block_height} not found")
        vote_set = VoteSet(state.chain_id, seen.height, seen.round, PRECOMMIT, last_vals)
        for idx, cs_sig in enumerate(seen.signatures):
            if cs_sig.absent():
                continue
            vote = Vote(
                type=PRECOMMIT,
                height=seen.height,
                round=seen.round,
                block_id=cs_sig.block_id(seen.block_id),
                timestamp=cs_sig.timestamp,
                validator_address=cs_sig.validator_address,
                validator_index=idx,
                signature=cs_sig.signature,
            )
            vote_set.add_vote(vote)
        if not vote_set.has_two_thirds_majority():
            raise ConsensusError("failed to reconstruct last commit; does not have +2/3 maj")
        self.rs.last_commit = vote_set

    def _new_step(self) -> None:
        """Log the step transition + notify the reactor
        (ref: newStep state.go:861)."""
        rs = self.rs
        self.wal.write(EventRoundStep(rs.height, rs.round, rs.step))
        self._n_steps += 1
        if _trace.enabled():
            from .round_state import STEP_NAMES

            _trace.instant(
                "consensus.step", "consensus",
                step=STEP_NAMES.get(rs.step, str(rs.step)),
                height=rs.height, round=rs.round,
            )
        if self.metrics is not None:
            from .round_state import STEP_NAMES

            self.metrics.mark_step(STEP_NAMES.get(rs.step, str(rs.step)))
            self.metrics.height.set(rs.height)
            self.metrics.rounds.set(rs.round)
        self.broadcast(
            NewRoundStepMessage(
                height=rs.height,
                round=rs.round,
                step=rs.step,
                seconds_since_start_time=max(0, int((self.now().unix_ns() - rs.start_time.unix_ns()) / 1e9)),
                last_commit_round=rs.last_commit.round if isinstance(rs.last_commit, VoteSet) else 0,
            )
        )

    def _schedule_round_0(self) -> None:
        """ref: scheduleRound0 (state.go:712)."""
        sleep = max(0.0, (self.rs.start_time.unix_ns() - self.now().unix_ns()) / 1e9)
        self.ticker.schedule_timeout(TimeoutInfo(sleep, self.rs.height, 0, STEP_NEW_HEIGHT))

    def _schedule_timeout(self, duration_s: float, height: int, round_: int, step: int) -> None:
        self.ticker.schedule_timeout(TimeoutInfo(duration_s, height, round_, step))

    # -------------------------------------------------------- step: round

    def _enter_new_round(self, height: int, round_: int) -> None:
        """ref: enterNewRound (state.go:1178)."""
        rs = self.rs
        if rs.height != height or round_ < rs.round or (rs.round == round_ and rs.step != STEP_NEW_HEIGHT):
            return
        validators = rs.validators
        if rs.round < round_:
            validators = validators.copy()
            validators.increment_proposer_priority(round_ - rs.round)
        rs.round = round_
        rs.step = STEP_NEW_ROUND
        rs.validators = validators
        if round_ != 0:
            rs.proposal = None
            rs.proposal_receive_time = Time()
            rs.proposal_block = None
            rs.proposal_block_parts = None
        rs.votes.set_round(round_ + 1)  # track next round for skipping
        rs.triggered_timeout_precommit = False

        # create_empty_blocks=false: round 0 waits for txs unless a proof
        # block is needed (ref: enterNewRound state.go:1230 waitForTxs)
        if self.wait_for_txs and round_ == 0 and not self._need_proof_block(height):
            if self.mempool is not None and not self.mempool.has_txs():
                if self.create_empty_blocks_interval > 0:
                    self._schedule_timeout(
                        self.create_empty_blocks_interval, height, round_, STEP_NEW_ROUND
                    )
                return  # handle_txs_available (or the interval) proceeds
        self._enter_propose(height, round_)

    def _need_proof_block(self, height: int) -> bool:
        """First block, or the app hash changed — a block must be made to
        prove the new state (ref: needProofBlock state.go:1259)."""
        if height == self.state.initial_height:
            return True
        last = self.block_store.load_block_meta(height - 1)
        return last is not None and last.header.app_hash != self.state.app_hash

    def _is_proposer(self, address: bytes) -> bool:
        proposer = self.rs.validators.get_proposer()
        return proposer is not None and proposer.address == address

    def _enter_propose(self, height: int, round_: int) -> None:
        """ref: enterPropose (state.go:1273)."""
        rs = self.rs
        if rs.height != height or round_ < rs.round or (rs.round == round_ and STEP_PROPOSE <= rs.step):
            return

        # Proposer-based timestamps: wait until our clock passes the
        # previous block time (ref: proposerWaitTime state.go:2799).
        if self.priv_pub_key is not None and self._is_proposer(self.priv_pub_key.address()):
            wait_ns = self.state.last_block_time.unix_ns() - self.now().unix_ns()
            if wait_ns > 0:
                self._schedule_timeout(wait_ns / 1e9 + 1e-3, height, round_, STEP_NEW_ROUND)
                return

        try:
            self._schedule_timeout(
                self.state.consensus_params.timeout.propose_timeout(round_), height, round_, STEP_PROPOSE
            )
            if self.priv_validator is None or self.priv_pub_key is None:
                return
            addr = self.priv_pub_key.address()
            if not rs.validators.has_address(addr):
                return
            if self._is_proposer(addr):
                self._decide_proposal(height, round_)
        finally:
            rs.round = round_
            rs.step = STEP_PROPOSE
            self._new_step()
            if self._is_proposal_complete():
                self._enter_prevote(height, rs.round)

    def _decide_proposal(self, height: int, round_: int) -> None:
        """ref: defaultDecideProposal (state.go:1353)."""
        rs = self.rs
        if rs.valid_block is not None:
            block, block_parts = rs.valid_block, rs.valid_block_parts
        else:
            # journey.proposal_build: the proposer-compute leg of the
            # block journey — everything between deciding to propose
            # and having a gossip-ready part set (mempool reap, ABCI
            # PrepareProposal, merkle roots, part split). Emitted
            # retrospectively so a refused build (no last-commit
            # majority yet) leaves NO anchor — a phantom span here
            # would fabricate proposer attribution for a height this
            # node never proposed.
            # unconditional clock read (once per proposed height, not
            # hot): a live-enable between here and the emit below must
            # not pair a zero start with a real end
            t_build = _trace.now_us()
            block = self._create_proposal_block(height)
            if block is None:
                return
            block_parts = PartSet.from_data(block.to_proto().encode(), BLOCK_PART_SIZE_BYTES)
            if _trace.enabled():
                _trace.complete(
                    "journey.proposal_build", "journey",
                    t_build, _trace.now_us() - t_build,
                    height=height, round=round_, parts=block_parts.total(),
                    journey=_trace.journey_key(height, round_, "block", self.node_id),
                )
            self._journey_mark("proposal_build")

        self.wal.flush_and_sync()
        prop_block_id = BlockID(hash=block.hash(), part_set_header=block_parts.header)
        proposal = Proposal(
            height=height,
            round=round_,
            pol_round=rs.valid_round,
            block_id=prop_block_id,
            timestamp=block.header.time,
        )
        try:
            self.priv_validator.sign_proposal(self.state.chain_id, proposal)
        except Exception:
            if not self.replay_mode:
                traceback.print_exc()
            return
        if self.metrics is not None:
            self.metrics.proposal_create_count.add(1)
        self._send_internal(ProposalMessage(proposal))
        self.broadcast(ProposalMessage(proposal))
        for i in range(block_parts.total()):
            part = block_parts.get_part(i)
            self._send_internal(BlockPartMessage(rs.height, rs.round, part))
            self.broadcast(BlockPartMessage(rs.height, rs.round, part))

    def _create_proposal_block(self, height: int):
        """ref: createProposalBlock (state.go:1433)."""
        rs = self.rs
        if height == self.state.initial_height:
            commit = Commit(height=0)
        elif rs.last_commit is not None and rs.last_commit.has_two_thirds_majority():
            commit = rs.last_commit.make_commit()
        else:
            return None  # cannot propose without commit for previous block
        proposer_addr = self.priv_pub_key.address()
        return self.block_exec.create_proposal_block(
            height, self.state, commit, proposer_addr, block_time=self.now()
        )

    def _is_proposal_complete(self) -> bool:
        """ref: isProposalComplete (state.go:1411)."""
        rs = self.rs
        if rs.proposal is None or rs.proposal_block is None:
            return False
        if rs.proposal.pol_round < 0:
            return True
        prevotes = rs.votes.prevotes(rs.proposal.pol_round)
        return prevotes is not None and prevotes.has_two_thirds_majority()

    # ------------------------------------------------------ step: prevote

    def _enter_prevote(self, height: int, round_: int) -> None:
        """ref: enterPrevote (state.go:1478)."""
        rs = self.rs
        if rs.height != height or round_ < rs.round or (rs.round == round_ and STEP_PREVOTE <= rs.step):
            return
        self._do_prevote(height, round_)
        rs.round = round_
        rs.step = STEP_PREVOTE
        self._new_step()

    def _proposal_is_timely(self) -> bool:
        sp = self.state.consensus_params.synchrony
        return self.rs.proposal.is_timely(self.rs.proposal_receive_time, sp.precision, sp.message_delay, self.rs.round)

    def _do_prevote(self, height: int, round_: int) -> None:
        """ref: defaultDoPrevote (state.go:1507)."""
        rs = self.rs
        if rs.proposal_block is None or rs.proposal is None:
            self._sign_add_vote(PREVOTE, b"", PartSetHeader())
            return
        if rs.proposal.timestamp != rs.proposal_block.header.time:
            self._sign_add_vote(PREVOTE, b"", PartSetHeader())
            return
        # PBTS: fresh (non-POL) proposals must be timely when we're unlocked
        if not self.replay_mode and rs.proposal.pol_round == -1 and rs.locked_round == -1 and not self._proposal_is_timely():
            self._sign_add_vote(PREVOTE, b"", PartSetHeader())
            return
        try:
            self.block_exec.validate_block(self.state, rs.proposal_block)
        except Exception as e:  # noqa: BLE001 - any verdict on the block prevotes nil
            if is_fault(e):
                raise  # the verifier's fault propagates to on_fatal
            self._sign_add_vote(PREVOTE, b"", PartSetHeader())
            return
        if not self.block_exec.process_proposal(rs.proposal_block, self.state):
            self._sign_add_vote(PREVOTE, b"", PartSetHeader())
            return

        # Algorithm line 22: fresh proposal, unlocked or matching our lock
        if rs.proposal.pol_round == -1:
            if rs.locked_round == -1 or rs.proposal_block.hashes_to(rs.locked_block.hash()):
                self._sign_add_vote(PREVOTE, rs.proposal_block.hash(), rs.proposal_block_parts.header)
                return
        # Algorithm line 28: POL from an earlier round unlocks us
        pol_round = rs.proposal.pol_round
        if 0 <= pol_round < rs.round:
            prevotes = rs.votes.prevotes(pol_round)
            if prevotes is not None:
                block_id, ok = prevotes.two_thirds_majority()
                if ok and rs.proposal_block.hashes_to(block_id.hash):
                    if rs.locked_round <= pol_round or rs.proposal_block.hashes_to(rs.locked_block.hash()):
                        self._sign_add_vote(PREVOTE, rs.proposal_block.hash(), rs.proposal_block_parts.header)
                        return
        self._sign_add_vote(PREVOTE, b"", PartSetHeader())

    def _enter_prevote_wait(self, height: int, round_: int) -> None:
        """ref: enterPrevoteWait (state.go:1646)."""
        rs = self.rs
        if rs.height != height or round_ < rs.round or (rs.round == round_ and STEP_PREVOTE_WAIT <= rs.step):
            return
        if not rs.votes.prevotes(round_).has_two_thirds_any():
            raise ConsensusError(f"entering prevote wait step ({height}/{round_}), but prevotes does not have any +2/3 votes")
        rs.round = round_
        rs.step = STEP_PREVOTE_WAIT
        self._new_step()
        self._schedule_timeout(self.state.consensus_params.timeout.vote_timeout(round_), height, round_, STEP_PREVOTE_WAIT)

    # ---------------------------------------------------- step: precommit

    def _enter_precommit(self, height: int, round_: int) -> None:
        """ref: enterPrecommit (state.go:1682)."""
        rs = self.rs
        if rs.height != height or round_ < rs.round or (rs.round == round_ and STEP_PRECOMMIT <= rs.step):
            return
        try:
            block_id, ok = rs.votes.prevotes(round_).two_thirds_majority()
            if not ok:
                self._sign_add_vote(PRECOMMIT, b"", PartSetHeader())
                return
            pol_round, _ = rs.votes.pol_info()
            if pol_round < round_:
                raise ConsensusError(f"this POLRound should be {round_} but got {pol_round}")
            if block_id.is_nil():
                self._sign_add_vote(PRECOMMIT, b"", PartSetHeader())
                return
            if rs.proposal is None or rs.proposal_block is None:
                self._sign_add_vote(PRECOMMIT, b"", PartSetHeader())
                return
            if rs.proposal.timestamp != rs.proposal_block.header.time:
                self._sign_add_vote(PRECOMMIT, b"", PartSetHeader())
                return
            if rs.locked_block is not None and rs.locked_block.hashes_to(block_id.hash):
                rs.locked_round = round_
                self._sign_add_vote(PRECOMMIT, block_id.hash, block_id.part_set_header)
                return
            if rs.proposal_block.hashes_to(block_id.hash):
                self.block_exec.validate_block(self.state, rs.proposal_block)  # panics in ref on failure
                rs.locked_round = round_
                rs.locked_block = rs.proposal_block
                rs.locked_block_parts = rs.proposal_block_parts
                self._sign_add_vote(PRECOMMIT, block_id.hash, block_id.part_set_header)
                return
            # polka for a block we don't have: fetch it, precommit nil
            if rs.proposal_block_parts is None or not rs.proposal_block_parts.has_header(block_id.part_set_header):
                rs.proposal_block = None
                rs.proposal_block_parts = PartSet(block_id.part_set_header)
            self._sign_add_vote(PRECOMMIT, b"", PartSetHeader())
        finally:
            rs.round = round_
            rs.step = STEP_PRECOMMIT
            self._new_step()

    def _enter_precommit_wait(self, height: int, round_: int) -> None:
        """ref: enterPrecommitWait (state.go:1807)."""
        rs = self.rs
        if rs.height != height or round_ < rs.round or (rs.round == round_ and rs.triggered_timeout_precommit):
            return
        if not rs.votes.precommits(round_).has_two_thirds_any():
            raise ConsensusError(f"entering precommit wait step ({height}/{round_}), but precommits does not have any +2/3 votes")
        rs.triggered_timeout_precommit = True
        self._new_step()
        self._schedule_timeout(self.state.consensus_params.timeout.vote_timeout(round_), height, round_, STEP_PRECOMMIT_WAIT)

    # ------------------------------------------------------- step: commit

    def _enter_commit(self, height: int, commit_round: int) -> None:
        """ref: enterCommit (state.go:1837)."""
        rs = self.rs
        if rs.height != height or STEP_COMMIT <= rs.step:
            return
        try:
            block_id, ok = rs.votes.precommits(commit_round).two_thirds_majority()
            if not ok:
                raise ConsensusError("enterCommit expects +2/3 precommits")
            if rs.locked_block is not None and rs.locked_block.hashes_to(block_id.hash):
                rs.proposal_block = rs.locked_block
                rs.proposal_block_parts = rs.locked_block_parts
            if rs.proposal_block is None or not rs.proposal_block.hashes_to(block_id.hash):
                if rs.proposal_block_parts is None or not rs.proposal_block_parts.has_header(block_id.part_set_header):
                    rs.proposal_block = None
                    rs.proposal_block_parts = PartSet(block_id.part_set_header)
        finally:
            rs.step = STEP_COMMIT
            rs.commit_round = commit_round
            rs.commit_time = self.now()
            self._new_step()
            self._try_finalize_commit(height)

    def _try_finalize_commit(self, height: int) -> None:
        """ref: tryFinalizeCommit (state.go:1905)."""
        rs = self.rs
        if rs.height != height:
            raise ConsensusError(f"tryFinalizeCommit() cs.Height: {rs.height} vs height: {height}")
        block_id, ok = rs.votes.precommits(rs.commit_round).two_thirds_majority()
        if not ok or block_id.is_nil():
            return
        if rs.proposal_block is None or not rs.proposal_block.hashes_to(block_id.hash):
            return
        self._finalize_commit(height)

    def _finalize_commit(self, height: int) -> None:
        """ref: finalizeCommit (state.go:1931) — save, WAL EndHeight,
        ApplyBlock, advance to next height."""
        rs = self.rs
        if rs.height != height or rs.step != STEP_COMMIT:
            return
        # journey key origin "": all nodes share one commit key per
        # (height, round), so the merged fleet trace binds every node's
        # finalize span into one cross-node journey flow
        with _trace.span("consensus.finalize_commit", "consensus",
                         height=height, round=rs.commit_round,
                         journey=_trace.journey_key(height, rs.commit_round,
                                                    "commit", "")):
            self._do_finalize_commit(height)

    def _do_finalize_commit(self, height: int) -> None:
        rs = self.rs
        block_id, ok = rs.votes.precommits(rs.commit_round).two_thirds_majority()
        block, block_parts = rs.proposal_block, rs.proposal_block_parts
        if not ok:
            raise ConsensusError("cannot finalize commit; commit does not have 2/3 majority")
        if not block_parts.has_header(block_id.part_set_header):
            raise ConsensusError("expected ProposalBlockParts header to be commit header")
        if not block.hashes_to(block_id.hash):
            raise ConsensusError("cannot finalize commit; proposal block does not hash to commit hash")
        self.block_exec.validate_block(self.state, block)

        if self.block_store.height() < block.header.height:
            precommits = rs.votes.precommits(rs.commit_round)
            seen_commit = precommits.make_commit()
            # The extended commit rides in the same batch as the block:
            # catch-up gossip must serve votes an EXTENDED vote set
            # accepts (commit-derived votes lack extension signatures) —
            # ref: SaveBlockWithExtendedCommit
            ext = (
                precommits.make_extended_commit()
                if self.state.consensus_params.abci.vote_extensions_enabled(height)
                else None
            )
            self.block_store.save_block(block, block_parts, seen_commit, extended_commit=ext)

        # EndHeight implies the block store saved the block; crash before
        # this replays from the WAL, crash after replays via ApplyBlock in
        # the handshake (state.go:1993).
        self.wal.write_sync(EndHeightMessage(height))

        state_copy = self.state.copy()
        prev_block_time = self.state.last_block_time
        state_copy = self.block_exec.apply_block(state_copy, block_id, block)

        if self.metrics is not None:
            m = self.metrics
            if height > self.state.initial_height:
                m.block_interval.observe(
                    max(0.0, (block.header.time.unix_ns() - prev_block_time.unix_ns()) / 1e9)
                )
            m.num_txs.set(len(block.txs))
            m.total_txs.add(len(block.txs))
            m.block_size.set(len(block.to_proto().encode()))
            if block.last_commit is not None:
                m.commit_sigs.set(sum(1 for s in block.last_commit.signatures if s.for_block()))
                # Participation gauges over the set that signed LastCommit
                # (ref: metrics.go MissingValidators{,Power}).
                missing = missing_power = 0
                last_vals = rs.last_validators
                if last_vals is not None and last_vals.size() == len(block.last_commit.signatures):
                    for idx, s in enumerate(block.last_commit.signatures):
                        if not s.for_block():
                            missing += 1
                            missing_power += last_vals.validators[idx].voting_power
                m.missing_validators.set(missing)
                m.missing_validators_power.set(missing_power)
            power_by_addr = (
                {v.address: v.voting_power for v in rs.last_validators.validators}
                if rs.last_validators is not None
                else {}
            )
            byz: set = set()
            for ev in block.evidence:
                if hasattr(ev, "vote_a"):  # DuplicateVoteEvidence
                    byz.add(ev.vote_a.validator_address)
                else:  # LightClientAttackEvidence
                    for v in ev.byzantine_validators:
                        power_by_addr.setdefault(v.address, v.voting_power)
                        byz.add(v.address)
            m.byzantine_validators.set(len(byz))
            m.byzantine_validators_power.set(sum(power_by_addr.get(a, 0) for a in byz))
            m.last_block_age.mark()
            m.mark_round()
        self.logger.info(
            "finalized block", height=height, hash=block_id.hash, txs=len(block.txs), round=rs.commit_round
        )

        self.on_decided(height, block, block_id)
        self.update_to_state(state_copy)
        self._schedule_round_0()

    # -------------------------------------------------------------- msgs

    def _journey_mark(self, stage: str) -> None:
        """Count one block-journey span emission
        (consensus_journey_spans_total{stage})."""
        if self.metrics is not None:
            self.metrics.journey_spans.add(1, stage)

    def _set_proposal(self, proposal: Proposal, recv_time: Time, origin: str = "") -> None:
        """ref: defaultSetProposal (state.go:2138). `origin` is the
        delivering frame's origin_node stamp ("" for our own proposal
        from the internal queue / WAL replay)."""
        rs = self.rs
        if rs.proposal is not None or proposal is None:
            return
        if proposal.height != rs.height or proposal.round != rs.round:
            return
        # PEER-INPUT validation failures are ValueErrors: _handle_msg
        # logs and drops them (ref: defaultSetProposal RETURNS
        # ErrInvalidProposalPOLRound/Signature, state.go:2151-2161, and
        # handleMsg logs — one malicious proposal must not be able to
        # halt the node the way a real invariant break does).
        if proposal.pol_round < -1 or (proposal.pol_round >= 0 and proposal.pol_round >= proposal.round):
            raise ValueError("invalid proposal POL round")
        proposer = rs.validators.get_proposer()
        if not proposer.pub_key.verify_signature(proposal.sign_bytes(self.state.chain_id), proposal.signature):
            raise ValueError("invalid proposal signature")
        rs.proposal = proposal
        rs.proposal_receive_time = recv_time
        if rs.proposal_block_parts is None:
            rs.proposal_block_parts = PartSet(proposal.block_id.part_set_header)
        if not self.replay_mode:
            if _trace.enabled():
                # journey.proposal: the moment this node ACCEPTED the
                # height's proposal — end of the proposer leg of the
                # block journey from this node's point of view
                _trace.instant(
                    "journey.proposal", "journey",
                    height=proposal.height, round=proposal.round,
                    journey=_trace.journey_key(
                        proposal.height, proposal.round, "proposal",
                        origin or self.node_id,
                    ),
                )
            self._journey_mark("proposal")

    def _add_proposal_block_part(self, msg: BlockPartMessage) -> bool:
        """ref: addProposalBlockPart (state.go:2183)."""
        from ..proto import messages as pb
        from ..types.block import Block

        rs = self.rs
        if rs.height != msg.height:
            return False
        if rs.proposal_block_parts is None:
            return False
        added = rs.proposal_block_parts.add_part(msg.part)
        if not added:
            if self.metrics is not None:
                self.metrics.duplicate_block_part.add(1)
            return False
        if _trace.enabled() and not self.replay_mode:
            # first accepted part of this height starts the gossip/
            # reassembly leg; journey.block_assembled is emitted
            # retrospectively over [first part, set complete]
            self._part_trace_us.setdefault(msg.height, _trace.now_us())
        # PEER-INPUT failures below are ValueErrors (logged + dropped):
        # parts and their contents are proposer-controlled bytes, and
        # the reference RETURNS errors for both (state.go:2220-2233) —
        # a byzantine proposer must cost a round, not halt the node.
        if rs.proposal_block_parts.byte_size > self.state.consensus_params.block.max_bytes:
            raise ValueError(
                f"total size of proposal block parts exceeds maximum block bytes "
                f"({rs.proposal_block_parts.byte_size} > {self.state.consensus_params.block.max_bytes})"
            )
        if rs.proposal_block_parts.is_complete():
            data = rs.proposal_block_parts.get_data()
            try:
                rs.proposal_block = Block.from_proto(pb.Block.decode(data))
            except Exception as e:
                raise ValueError(f"malformed proposal block encoding: {e!r}") from e
            if not self.replay_mode:
                if _trace.enabled():
                    t0 = self._part_trace_us.pop(msg.height, None)
                    now = _trace.now_us()
                    _trace.complete(
                        "journey.block_assembled", "journey",
                        now if t0 is None else t0,
                        0.0 if t0 is None else now - t0,
                        height=msg.height, round=msg.round,
                        parts=rs.proposal_block_parts.total(),
                        journey=_trace.journey_key(
                            msg.height, msg.round, "block",
                            getattr(msg, "origin_node", "") or self.node_id,
                        ),
                    )
                self._journey_mark("block_assembled")
        return added

    def _handle_complete_proposal(self, height: int) -> None:
        """ref: handleCompleteProposal (state.go:2255)."""
        rs = self.rs
        prevotes = rs.votes.prevotes(rs.round)
        block_id, has_two_thirds = prevotes.two_thirds_majority()
        if has_two_thirds and not block_id.is_nil() and rs.valid_round < rs.round:
            if rs.proposal_block.hashes_to(block_id.hash):
                rs.valid_round = rs.round
                rs.valid_block = rs.proposal_block
                rs.valid_block_parts = rs.proposal_block_parts
        if rs.step <= STEP_PROPOSE and self._is_proposal_complete():
            self._enter_prevote(height, rs.round)
            if has_two_thirds:
                self._enter_precommit(height, rs.round)
        elif rs.step == STEP_COMMIT:
            self._try_finalize_commit(height)

    def _try_add_vote(self, vote: Vote, peer_id: str) -> bool:
        """ref: tryAddVote (state.go:2289). Only *vote-level* errors
        (bad sig, wrong index, conflicts) are non-fatal; anything raised
        downstream of a 2/3 majority (enterCommit → ApplyBlock) is a
        consensus failure and must propagate to halt the node, as the
        reference's panics do."""
        try:
            # Stateless checks first (ref: msgs.go VoteMessage.ValidateBasic
            # on the reactor boundary): among other things this rejects
            # extension data smuggled onto prevotes and nil precommits —
            # such bytes are outside the vote's sign bytes, so signature
            # verification alone would accept the tampered vote and the
            # garbage would end up in our extended commit, which syncing
            # peers then refuse.
            vote.validate_basic()
            return self._add_vote(vote, peer_id)
        except ConflictingVoteError as e:
            if self.priv_pub_key is not None and vote.validator_address == self.priv_pub_key.address():
                # conflicting vote from ourselves — unsafe reset?
                return False
            if self.evpool is not None:
                self.evpool.report_conflicting_votes(e.vote_a, e.vote_b)
            return False
        except ValueError as e:
            # VoteSet.add_vote rejection (invalid index/address/signature);
            # a verifier fault raised by a step the vote drove is no
            # rejection of the vote
            if is_fault(e):
                raise
            return False

    def _add_vote(self, vote: Vote, peer_id: str) -> bool:
        """ref: addVote (state.go:2333)."""
        rs = self.rs

        # Late precommit for the previous height during timeoutCommit
        if vote.height + 1 == rs.height and vote.type == PRECOMMIT:
            if rs.step != STEP_NEW_HEIGHT:
                return False
            if rs.last_commit is None:
                return False
            added = rs.last_commit.add_vote(vote)
            if not added:
                return False
            self.broadcast(HasVoteMessage(vote.height, vote.round, vote.type, vote.validator_index))
            if self.state.consensus_params.timeout.bypass_commit_timeout and rs.last_commit.has_all():
                self._enter_new_round(rs.height, 0)
            return True

        if vote.height != rs.height:
            if self.metrics is not None and vote.height < rs.height:
                self.metrics.late_votes.add(1, "prevote" if vote.type == PREVOTE else "precommit")
            return False

        # Vote extensions
        if self.state.consensus_params.abci.vote_extensions_enabled(rs.height):
            my_addr = self.priv_pub_key.address() if self.priv_pub_key else b""
            if vote.type == PRECOMMIT and not vote.block_id.is_nil() and vote.validator_address != my_addr:
                _, val = self.state.validators.get_by_index(vote.validator_index)
                if val is None:
                    return False  # unknown validator index — reject, don't crash
                try:
                    vote.verify_with_extension(self.state.chain_id, val.pub_key)
                    ext_ok = self.block_exec.verify_vote_extension(vote)
                except Exception:
                    if self.metrics is not None:
                        self.metrics.vote_extension_receive_count.add(1, "rejected")
                    raise
                if self.metrics is not None:
                    self.metrics.vote_extension_receive_count.add(
                        1, "accepted" if ext_ok else "rejected"
                    )
                if not ext_ok:
                    return False
        else:
            vote.extension = b""
            vote.extension_signature = b""

        height = rs.height
        added = rs.votes.add_vote(vote, peer_id)
        if not added:
            # add_vote's False (vs raise) is specifically the
            # exact-duplicate case (ref: metrics.go DuplicateVote).
            if self.metrics is not None:
                self.metrics.duplicate_vote.add(1)
            return False
        if not self.replay_mode:
            # start the quorum-assembly clocks on the FIRST vote of this
            # (height, round, type) — our own votes flow through here too
            qkey = (vote.height, vote.round, vote.type)
            if self.metrics is not None:
                self._quorum_clock.setdefault(qkey, _pytime.monotonic())
            if _trace.enabled():
                self._quorum_trace_us.setdefault(qkey, _trace.now_us())
        self.broadcast(HasVoteMessage(vote.height, vote.round, vote.type, vote.validator_index))

        if vote.type == PREVOTE:
            prevotes = rs.votes.prevotes(vote.round)
            block_id, ok = prevotes.two_thirds_majority()
            if ok:
                self._mark_quorum(vote)
            if ok and not block_id.is_nil():
                if rs.valid_round < vote.round and vote.round == rs.round:
                    if rs.proposal_block is not None and rs.proposal_block.hashes_to(block_id.hash):
                        rs.valid_round = vote.round
                        rs.valid_block = rs.proposal_block
                        rs.valid_block_parts = rs.proposal_block_parts
                    else:
                        rs.proposal_block = None
                    if rs.proposal_block_parts is None or not rs.proposal_block_parts.has_header(block_id.part_set_header):
                        rs.proposal_block_parts = PartSet(block_id.part_set_header)
            if rs.round < vote.round and prevotes.has_two_thirds_any():
                self._enter_new_round(height, vote.round)  # round skip
            elif rs.round == vote.round and STEP_PREVOTE <= rs.step:
                block_id, ok = prevotes.two_thirds_majority()
                if ok and (self._is_proposal_complete() or block_id.is_nil()):
                    self._enter_precommit(height, vote.round)
                elif prevotes.has_two_thirds_any():
                    self._enter_prevote_wait(height, vote.round)
            elif rs.proposal is not None and 0 <= rs.proposal.pol_round == vote.round:
                if self._is_proposal_complete():
                    self._enter_prevote(height, rs.round)
        elif vote.type == PRECOMMIT:
            precommits = rs.votes.precommits(vote.round)
            block_id, ok = precommits.two_thirds_majority()
            if ok:
                self._mark_quorum(vote)
                self._enter_new_round(height, vote.round)
                self._enter_precommit(height, vote.round)
                if not block_id.is_nil():
                    self._enter_commit(height, vote.round)
                    if self.state.consensus_params.timeout.bypass_commit_timeout and precommits.has_all():
                        self._enter_new_round(rs.height, 0)
                else:
                    self._enter_precommit_wait(height, vote.round)
            elif rs.round <= vote.round and precommits.has_two_thirds_any():
                self._enter_new_round(height, vote.round)
                self._enter_precommit_wait(height, vote.round)
        else:
            raise ConsensusError(f"unexpected vote type {vote.type}")
        return True

    def _mark_quorum(self, vote: Vote) -> None:
        """First 2/3 majority for (height, round, type): observe the
        assembly time since that slot's first vote
        (consensus_quorum_assembly_seconds{type}) exactly once, and
        emit the retrospective journey.quorum span — the quorum-wait
        leg of the block journey."""
        if self.replay_mode:
            return
        key = (vote.height, vote.round, vote.type)
        if key in self._quorum_done:
            return
        self._quorum_done.add(key)
        label = "prevote" if vote.type == PREVOTE else "precommit"
        if self.metrics is not None:
            t0 = self._quorum_clock.get(key)
            if t0 is not None:
                self.metrics.quorum_assembly.observe(
                    _pytime.monotonic() - t0, label
                )
        t0_us = self._quorum_trace_us.pop(key, None)
        if t0_us is not None and _trace.enabled():
            _trace.complete(
                "journey.quorum", "journey", t0_us, _trace.now_us() - t0_us,
                height=vote.height, round=vote.round, type=label,
                journey=_trace.journey_key(vote.height, vote.round, label, ""),
            )
        self._journey_mark("quorum")

    # -------------------------------------------------------------- votes

    def _sign_vote(self, msg_type: int, hash_: bytes, header: PartSetHeader) -> Vote | None:
        """ref: signVote (state.go:2540)."""
        self.wal.flush_and_sync()
        if self.priv_pub_key is None:
            return None
        addr = self.priv_pub_key.address()
        val_idx, _ = self.rs.validators.get_by_address(addr)
        vote = Vote(
            type=msg_type,
            height=self.rs.height,
            round=self.rs.round,
            block_id=BlockID(hash=hash_, part_set_header=header),
            timestamp=self.now(),
            validator_address=addr,
            validator_index=val_idx,
        )
        if msg_type == PRECOMMIT and not vote.block_id.is_nil():
            if self.state.consensus_params.abci.vote_extensions_enabled(self.rs.height):
                vote.extension = self.block_exec.extend_vote(vote)
        self.priv_validator.sign_vote(self.state.chain_id, vote)
        return vote

    def _sign_add_vote(self, msg_type: int, hash_: bytes, header: PartSetHeader) -> Vote | None:
        """ref: signAddVote (state.go:2599)."""
        if self.priv_validator is None or self.priv_pub_key is None:
            return None
        if not self.rs.validators.has_address(self.priv_pub_key.address()):
            return None
        try:
            vote = self._sign_vote(msg_type, hash_, header)
        except Exception:
            # During WAL replay the privval rightly refuses to re-sign
            # already-signed HRS slots; only surface errors live.
            if not self.replay_mode:
                traceback.print_exc()
            return None
        if vote is None:
            return None
        if not self.state.consensus_params.abci.vote_extensions_enabled(vote.height):
            vote.extension = b""
            vote.extension_signature = b""
        self._send_internal(VoteMessage(vote))
        self.broadcast(VoteMessage(vote))
        return vote

    # -------------------------------------------------------------- replay

    def replay_record(self, record) -> None:
        """Apply ONE WAL record in replay mode — the single dispatch
        shared by crash recovery and the replay console (EndHeight and
        round-step markers are informational, not state transitions)."""
        if isinstance(record, (EndHeightMessage, EventRoundStep)):
            return
        self.replay_mode = True
        try:
            if isinstance(record, TimeoutInfo):
                self._handle_timeout(record)
            elif isinstance(record, MsgInfo):
                self._handle_msg(record)
        finally:
            self.replay_mode = False

    def _catchup_replay(self) -> None:
        """Replay WAL messages since the last EndHeight, with
        repair-and-retry on corruption: back up the damaged file,
        truncate it at the corruption point, and replay the clean
        prefix (ref: catchupReplay replay.go:97; the repair loop
        state.go:420-466, one attempt then fail)."""
        repair_attempted = False
        while True:
            msgs, clean = self.wal.search_for_end_height_with_status(self.rs.height - 1)
            if clean:
                break
            if repair_attempted:
                raise RuntimeError("consensus WAL corrupted and repair failed")
            self.logger.error("the WAL file is corrupted; attempting repair")
            self.wal.repair()
            repair_attempted = True
        if msgs is None:
            return
        for m in msgs:
            self.replay_record(m)
