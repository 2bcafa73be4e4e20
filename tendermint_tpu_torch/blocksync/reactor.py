"""Blocksync reactor (ref: internal/blocksync/reactor.go).

Serves BlockRequests from the local store and runs the verify loop:
PeekTwoBlocks → VerifyCommitLight(first, using second.LastCommit) on the
port's batch verifier (reactor.go:582) → ApplyBlock → PopRequest.
Channel 0x40, priority 5.

The reactor reaches the card three ways, each on `device` (the card
unless the caller passes "cpu"): the light check of second.LastCommit,
the verify-ahead of the next height's (`verify_commit_light_async`
while this height applies), and the extended commit's vote and extension
batches (`_validate_ext_commit`). The pool and the p2p layer run no
device code.

Unlike the JAX package's reactor, nothing here falls back after a device,
build or launch failure: only a verdict (a commit or extended commit that
does not verify: a CommitVerificationError or NotEnoughVotingPowerError)
makes the reactor refuse a block and report its senders; any other error,
a kernel wrapper's ValueError included, propagates from `_try_sync_one`
(the verify loop hands it to on_fatal). The one host path left is the
reference's for an extension that the batch refuses at `add` (a key of
another type, a malformed signature).
"""

from __future__ import annotations

import threading
import time

from .. import trace as _trace
from ..p2p.types import CHANNEL_BLOCKSYNC, ChannelDescriptor, PEER_STATUS_UP, PeerError
from ..proto import messages as pb
from ..types.block import Block, BlockID
from ..types.validation import VERDICT_ERRORS, verify_commit_light, verify_commit_light_async
from .pool import BlockPool

# VERDICT_ERRORS: what a commit that does not verify raises
# (types/validation.py); any other error is a fault of this node, not of the
# peer that sent the block


# ------------------------------------------------------------------ messages


class BlockRequest:
    def __init__(self, height: int):
        self.height = height


class NoBlockResponse:
    def __init__(self, height: int):
        self.height = height


class BlockResponse:
    def __init__(self, block: Block, ext_commit=None):
        self.block = block
        # pb.ExtendedCommit for vote-extension heights
        # (blocksync/types.proto:23) — lets the syncing node later serve
        # extension-aware catch-up gossip itself
        self.ext_commit = ext_commit


class StatusRequest:
    pass


class StatusResponse:
    def __init__(self, base: int, height: int):
        self.base = base
        self.height = height


def encode_blocksync_msg(msg) -> bytes:
    """Wire bytes = the reference's Message oneof
    (proto/tendermint/blocksync/types.proto:34-42)."""
    if isinstance(msg, BlockRequest):
        env = pb.BlocksyncMessage(block_request=pb.BlocksyncBlockRequest(height=msg.height))
    elif isinstance(msg, NoBlockResponse):
        env = pb.BlocksyncMessage(no_block_response=pb.BlocksyncNoBlockResponse(height=msg.height))
    elif isinstance(msg, BlockResponse):
        env = pb.BlocksyncMessage(block_response=pb.BlocksyncBlockResponse(
            block=msg.block.to_proto(), ext_commit=msg.ext_commit))
    elif isinstance(msg, StatusRequest):
        env = pb.BlocksyncMessage(status_request=pb.BlocksyncStatusRequest())
    elif isinstance(msg, StatusResponse):
        env = pb.BlocksyncMessage(
            status_response=pb.BlocksyncStatusResponse(height=msg.height, base=msg.base)
        )
    else:
        raise TypeError(f"unknown blocksync message {type(msg)}")
    return env.encode()


def decode_blocksync_msg(data: bytes):
    env = pb.BlocksyncMessage.decode(data)
    kind = env.which()
    if kind == "block_request":
        return BlockRequest(env.block_request.height or 0)
    if kind == "no_block_response":
        return NoBlockResponse(env.no_block_response.height or 0)
    if kind == "block_response":
        if env.block_response.block is None:
            raise ValueError("block_response without a block")
        return BlockResponse(
            Block.from_proto(env.block_response.block),
            ext_commit=env.block_response.ext_commit,
        )
    if kind == "status_request":
        return StatusRequest()
    if kind == "status_response":
        r = env.status_response
        return StatusResponse(r.base or 0, r.height or 0)
    raise ValueError(f"empty or unknown blocksync oneof: {kind}")


def blocksync_channel_descriptor() -> ChannelDescriptor:
    """ref: reactor.go:27,43-48 — channel 0x40, priority 5."""
    return ChannelDescriptor(
        id=CHANNEL_BLOCKSYNC,
        name="blocksync",
        priority=5,
        send_queue_capacity=1000,
        recv_message_capacity=10 * 1024 * 1024,
        recv_buffer_capacity=1024,
        encode=encode_blocksync_msg,
        decode=decode_blocksync_msg,
    )


class BlockSyncReactor:
    """ref: reactor.go Reactor."""

    STATUS_UPDATE_INTERVAL = 2.0  # reactor.go statusUpdateIntervalSeconds = 10
    SWITCH_CHECK_INTERVAL = 0.5  # reactor.go switchToConsensusIntervalSeconds = 1

    def __init__(
        self,
        state,
        block_executor,
        block_store,
        channel,
        peer_manager,
        on_caught_up=None,
        block_sync: bool = True,
        on_fatal=None,
        metrics=None,
        device=None,
    ):
        """on_caught_up(state, blocks_synced) fires when the pool reaches
        the network head — the node switches to consensus
        (ref: reactor.go:370 SwitchToBlockSync / poolRoutine).
        on_fatal(exc) fires when a VERIFIED block fails to apply — an
        invariant violation the node must halt on, as the reference's
        poolRoutine panic does — or when a check fails for a reason
        other than its verdict. `device` is where the commit checks
        run: the card by default, "cpu" for the plain versions."""
        self.state = state
        self.block_exec = block_executor
        self.block_store = block_store
        self.channel = channel
        self.peer_manager = peer_manager
        self.on_caught_up = on_caught_up or (lambda state, n: None)
        self.on_fatal = on_fatal or (lambda exc: None)
        self.block_sync = block_sync
        self.device = device
        self.pool = BlockPool(
            max(self.state.last_block_height + 1, self.state.initial_height),
            self._send_block_request,
            self._send_peer_error,
        )
        self.blocks_synced = 0
        self.sync_error = False
        self.metrics = metrics  # BlockSyncMetrics (ref: blocksync/metrics.go)
        # verify-ahead pipeline state: (height, block obj, commit-source
        # block obj, valset hash, completion callable). Object identity
        # guards against the pool refetching either block; the valset
        # hash guards against validator-set changes (state.validators
        # after applying h is exactly state.next_validators before —
        # state/state.py:97 — so a mismatch means a dynamic update we
        # must not have predicted).
        self._verify_ahead = None
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._switched = False

    # ----------------------------------------------------------- lifecycle

    def start(self) -> None:
        self.peer_manager.subscribe(self._on_peer_update)
        if self.block_sync:
            self.pool.start()
        for fn in (self._recv_loop, self._status_broadcast_loop):
            t = threading.Thread(target=fn, daemon=True, name=fn.__name__)
            t.start()
            self._threads.append(t)
        if self.block_sync:
            t = threading.Thread(target=self._pool_routine, daemon=True, name="bs-pool")
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        self._stop.set()
        self.pool.stop()
        self.peer_manager.unsubscribe(self._on_peer_update)

    # ------------------------------------------------------------- wiring

    def _send_block_request(self, height: int, peer_id: str) -> None:
        if not self.channel.send_to(peer_id, BlockRequest(height), timeout=1.0):
            raise RuntimeError("send queue full")

    def _send_peer_error(self, err, peer_id: str) -> None:
        self.channel.send_error(PeerError(node_id=peer_id, err=err))

    def _on_peer_update(self, update) -> None:
        if update.status == PEER_STATUS_UP:
            self.channel.send_to(update.node_id, StatusRequest(), timeout=1.0)
        else:
            self.pool.remove_peer(update.node_id)

    # -------------------------------------------------------------- loops

    def _recv_loop(self) -> None:
        """ref: reactor.go:236 handleMessage."""
        while not self._stop.is_set():
            env = self.channel.receive_one(timeout=0.2)
            if env is None:
                continue
            msg, nid = env.message, env.from_
            try:
                if isinstance(msg, BlockRequest):
                    self._respond_to_peer(msg, nid)
                elif isinstance(msg, BlockResponse):
                    self.pool.add_block(nid, msg.block, ext_commit=msg.ext_commit)
                elif isinstance(msg, StatusRequest):
                    self.channel.send_to(
                        nid, StatusResponse(self.block_store.base(), self.block_store.height()), timeout=1.0
                    )
                elif isinstance(msg, StatusResponse):
                    self.pool.set_peer_range(nid, msg.base, msg.height)
                elif isinstance(msg, NoBlockResponse):
                    self.pool.retry_height(msg.height, nid)
            except Exception as e:
                self.channel.send_error(PeerError(node_id=nid, err=e))

    def _respond_to_peer(self, msg: BlockRequest, peer_id: str) -> None:
        """ref: reactor.go:186 respondToPeer — the extended commit rides
        along for vote-extension heights."""
        block = self.block_store.load_block(msg.height)
        if block is not None:
            ec = self.block_store.load_extended_commit_proto(msg.height)
            self.channel.send_to(peer_id, BlockResponse(block, ext_commit=ec), timeout=1.0)
        else:
            self.channel.send_to(peer_id, NoBlockResponse(msg.height), timeout=1.0)

    def _status_broadcast_loop(self) -> None:
        while not self._stop.is_set():
            self.channel.broadcast(
                StatusResponse(self.block_store.base(), self.block_store.height()), timeout=1.0
            )
            if self.metrics is not None:
                height, _, rate = self.pool.status()
                self.metrics.latest_height.set(height)
                self.metrics.sync_rate.set(rate)
                self.metrics.syncing.set(0 if self._switched else int(self.block_sync))
            self._stop.wait(self.STATUS_UPDATE_INTERVAL)

    def _pool_routine(self) -> None:
        """The verify loop (ref: reactor.go:477 poolRoutine)."""
        last_switch_check = 0.0
        while not self._stop.is_set():
            now = time.monotonic()
            if now - last_switch_check > self.SWITCH_CHECK_INTERVAL:
                last_switch_check = now
                if (
                    not self._switched
                    and self.pool.is_caught_up()
                    and self._can_switch_to_consensus()
                ):
                    self._switched = True
                    self.pool.stop()
                    try:
                        self.on_caught_up(self.state, self.blocks_synced)
                    except Exception as exc:
                        # A failed switch (e.g. reconstruction cannot
                        # find its data) must HALT the node, not leave
                        # it half-alive with consensus never started.
                        import traceback

                        traceback.print_exc()
                        self.on_fatal(exc)
                    return
            try:
                advanced = self._try_sync_one()
            except Exception as exc:
                # A verified block failing to apply is a store/app
                # invariant violation — the reference panics here
                # (reactor.go poolRoutine). Halt the node via on_fatal
                # rather than dying silently and stalling half-alive.
                import traceback

                traceback.print_exc()
                self.sync_error = True
                self.pool.stop()
                self.on_fatal(exc)
                return
            if not advanced:
                time.sleep(0.01)

    def _can_switch_to_consensus(self) -> bool:
        """ref: reactor.go:485-507: when vote extensions were enabled at
        last_block_height, consensus cannot start without that height's
        ExtendedCommit (restart reconstruction requires it). Every
        synced extension-height block carries one, so a node that
        synced >= 1 block is safe; a statesync-landed node that synced
        none must wait for the chain to extend by one block."""
        h = self.state.last_block_height
        if h == 0 or not self.state.consensus_params.abci.vote_extensions_enabled(h):
            return True
        if self.blocks_synced > 0:
            return True
        return self.block_store.load_extended_commit_proto(h) is not None

    def _try_sync_one(self) -> bool:
        """ref: reactor.go:536-616 (the trySync block)."""
        first, second = self.pool.peek_two_blocks()
        if first is None or second is None:
            return False
        first_parts = None
        try:
            # ★ the north-star call (reactor.go:582): batched verify of
            # second.LastCommit against OUR current validator set — via
            # the verify-ahead pipeline when the previous iteration
            # already dispatched this height to the device.
            ahead, self._verify_ahead = self._verify_ahead, None
            if (
                ahead is not None
                and ahead[0] == first.header.height
                and ahead[1] is first
                and ahead[2] is second
                and ahead[3] == self.state.validators.hash()
            ):
                first_parts, first_id = ahead[4], ahead[5]  # reuse dispatch-time work
                ahead[6]()  # completes the dispatched kernel; raises as sync would
            else:
                first_parts = first.make_part_set()
                first_id = BlockID(hash=first.hash(), part_set_header=first_parts.header)
                with _trace.span("blocksync.verify_commit", "blocksync",
                                 height=first.header.height):
                    verify_commit_light(
                        self.state.chain_id,
                        self.state.validators,
                        first_id,
                        first.header.height,
                        second.last_commit,
                        device=self.device,
                    )
            self._dispatch_verify_ahead(second)
        except VERDICT_ERRORS as e:
            # Either sender could be lying (a forged second.LastCommit
            # fails an honest first block): ban BOTH and refetch both
            # heights (ref: reactor.go:592-604 errors both senders).
            h = first.header.height
            second_peer = self.pool.block_sender(h + 1)
            first_peer = self.pool.redo_request(h)
            if second_peer is not None and second_peer != first_peer:
                self.pool.redo_request(h + 1)
                self.channel.send_error(PeerError(node_id=second_peer, err=e))
            if first_peer is not None:
                self.channel.send_error(PeerError(node_id=first_peer, err=e))
            return False

        height = first.header.height
        ec = self.pool.take_ext_commit(height)
        if self.state.consensus_params.abci.vote_extensions_enabled(height):
            err = self._validate_ext_commit(
                ec, height, first_id, self.state.validators, self.state.chain_id
            )
            if err is not None:
                # A missing or malformed extended commit at a
                # vote-extension height is a peer fault: without it the
                # synced node could never serve extension-aware catch-up
                # gossip. Re-request the height from another peer
                # (ref: reactor.go:549-553, 590).
                peer = self.pool.redo_request(height)
                if peer is not None:
                    self.channel.send_error(PeerError(node_id=peer, err=err))
                return False
        else:
            ec = None  # extensions disabled at this height: nothing to persist

        self.pool.pop_request()
        # Block and extended commit ride one DB batch: a crash between
        # separate writes would leave a block whose restart
        # reconstruction (consensus/state.py) requires an EC that is
        # not there — a permanent halt.
        self.block_store.save_block(
            first, first_parts, second.last_commit, extended_commit=ec
        )
        with _trace.span("blocksync.apply", "blocksync", height=height):
            self.state = self.block_exec.apply_block(self.state, first_id, first)
        self.blocks_synced += 1
        if self.metrics is not None:
            self.metrics.num_blocks.add(1)
        return True

    def _validate_ext_commit(self, ec, height: int, first_id, vals=None,
                             chain_id: str = "") -> Exception | None:
        """A block at a vote-extension height MUST carry an
        ExtendedCommit whose height/block_id match the verified block
        and whose COMMIT signatures all carry extension signatures
        (ref: reactor.go:549-553 refuses a missing one; EnsureExtensions
        at reactor.go:590 before SaveBlockWithExtendedCommit).

        When the validator set is supplied, the commit is then verified
        CRYPTOGRAPHICALLY by replaying it through an extensions-checking
        VoteSet requiring +2/3 for the block — an unverified EC on disk
        is a poison pill: the next restart rebuilds last_commit from it
        and halts forever if it was forged."""
        from ..types.block import BLOCK_ID_FLAG_COMMIT, BlockID

        if ec is None:
            return ValueError(
                f"block {height} at vote-extension height arrived without extended commit"
            )
        if (ec.height or 0) != height:
            return ValueError(f"extended commit height {ec.height or 0} != block height {height}")
        if BlockID.from_proto(ec.block_id) != first_id:
            return ValueError("extended commit block_id does not match verified block")
        for i, sig in enumerate(ec.extended_signatures or []):
            flag = sig.block_id_flag or 0
            if flag == BLOCK_ID_FLAG_COMMIT:
                if not (sig.extension_signature or b""):
                    return ValueError(f"extended commit signature {i} missing extension signature")
            elif (sig.extension or b"") or (sig.extension_signature or b""):
                return ValueError(f"extended commit signature {i} has unexpected extension data")
        if vals is None:
            return None
        from ..crypto import batch as crypto_batch
        from ..types.block import Commit, CommitSig
        from ..types.validation import verify_commit_async
        from ..types.vote import votes_from_extended_commit
        from ..utils.tmtime import Time

        sigs = ec.extended_signatures or []
        if len(sigs) != vals.size():
            return ValueError(
                f"extended commit has {len(sigs)} signature slots, validator set has {vals.size()}"
            )
        # Vote signatures: check ALL of them (not just a 2/3 prefix —
        # restart reconstruction re-verifies every persisted vote, so an
        # unverified tail would be an on-disk poison) through the same
        # batch/device plane the sync pipeline already uses.
        commit = Commit(
            height=ec.height or 0,
            round=ec.round or 0,
            block_id=BlockID.from_proto(ec.block_id),
            signatures=[
                CommitSig(
                    block_id_flag=s.block_id_flag or 0,
                    validator_address=s.validator_address or b"",
                    timestamp=Time((s.timestamp or pb.Timestamp()).seconds or 0,
                                   (s.timestamp or pb.Timestamp()).nanos or 0),
                    signature=s.signature or b"",
                )
                for s in sigs
            ],
        )
        # Dispatch the vote-signature batch NOW and collect it after the
        # extension batch is also in flight: the two launches overlap
        # (and coalesce into one when the engine plane is on) instead of
        # running back to back. Error priority is unchanged — vote
        # verification failures report before address/extension ones.
        try:
            complete_votes = verify_commit_async(chain_id, vals, first_id, height, commit,
                                                 device=self.device)
        except VERDICT_ERRORS as e:
            return ValueError(f"extended commit votes failed verification: {e}")
        # Extension signatures (COMMIT slots only), batched likewise.
        votes = votes_from_extended_commit(ec)
        ext_jobs = []
        addr_err = None
        for idx, v in enumerate(votes):
            if v is None:
                continue
            # Address must match the slot for NIL votes too — restart
            # reconstruction (VoteSet.add_vote) rejects mismatches, so
            # letting one through here would poison the store.
            addr, val = vals.get_by_index(idx)
            if val is None or v.validator_address != addr:
                addr_err = ValueError(f"extended commit signature {idx} has wrong validator address")
                break
            if v.block_id.is_nil():
                continue
            ext_jobs.append((val.pub_key, v.extension_sign_bytes(chain_id), v.extension_signature))
        pending_ext = None
        if addr_err is None and ext_jobs:
            proposer_pk = ext_jobs[0][0]
            if crypto_batch.supports_batch_verifier(proposer_pk):
                bv = crypto_batch.create_batch_verifier(proposer_pk, device=self.device)
                try:
                    for pk, msg, sig in ext_jobs:
                        bv.add(pk, msg, sig)
                except ValueError:
                    bv = None  # a key or signature the batch refuses: serial below
                if bv is not None:
                    pending_ext = bv.verify_async()
        try:
            complete_votes()
        except VERDICT_ERRORS as e:
            return ValueError(f"extended commit votes failed verification: {e}")
        if addr_err is not None:
            return addr_err
        if ext_jobs:
            if pending_ext is not None:
                # any error of the collect is the verifier's, not a verdict:
                # it propagates, and nothing is verified again on the host
                ok, _ = pending_ext()
            else:
                ok = all(pk.verify_signature(msg, sig) for pk, msg, sig in ext_jobs)
            if not ok:
                return ValueError("extended commit has an invalid extension signature")
        return None

    def _dispatch_verify_ahead(self, second) -> None:
        """Launch the device verification of height h+1's commit while
        height h applies on the host (ABCI + stores): `second` is proven
        by third.last_commit against state.next_validators — the exact
        set that becomes state.validators after the apply
        (state/state.py:97). Host-side check failures are deferred to
        the completion call so error handling stays in one place; a
        dispatch that turns out stale (pool refetch, valset change) is
        simply dropped by the identity/hash guards above."""
        third = self.pool.peek_third_block()
        if third is None:
            return
        next_vals = self.state.next_validators
        second_parts = second_id = None
        try:
            second_parts = second.make_part_set()
            second_id = BlockID(hash=second.hash(), part_set_header=second_parts.header)
            complete = verify_commit_light_async(
                self.state.chain_id,
                next_vals,
                second_id,
                second.header.height,
                third.last_commit,
                device=self.device,
            )
        except Exception as e:
            def complete(e=e):
                raise e
        # parts/id carried along so the consuming iteration reuses the
        # serialization + merkle work instead of redoing it
        self._verify_ahead = (
            second.header.height, second, third, next_vals.hash(),
            second_parts, second_id, complete,
        )
