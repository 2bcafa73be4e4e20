"""ABCI handshake: sync the application to the block store at boot
(ref: internal/consensus/replay.go:204-551 Handshaker).

On start the node calls ABCI Info; if the app is behind the block store
(crash between block-store save and app Commit, or a fresh app behind an
existing chain), the missing blocks are replayed via FinalizeBlock. A
fresh chain (app height 0, store height 0) triggers InitChain, which may
override genesis validators and consensus params (replay.go:279-334).

The replay's BlockExecutor checks each replayed block's LastCommit where
the Handshaker's `device` says: the card when None, the plain versions on
the host with "cpu".
"""

from __future__ import annotations

from ..abci import types as abci
from ..state.execution import (
    BlockExecutor,
    validator_updates_from_abci,
)
from ..types.validator_set import ValidatorSet


class HandshakeError(Exception):
    pass


class AppHashMismatchError(HandshakeError):
    """ref: replay.go appHashMismatchError — operator must rollback."""


class Handshaker:
    """ref: replay.go:204 NewHandshaker."""

    def __init__(self, state_store, state, block_store, gen_doc, event_publisher=None, logger=None, device=None):
        self.device = device
        self.state_store = state_store
        self.initial_state = state
        self.block_store = block_store
        self.gen_doc = gen_doc
        self.event_publisher = event_publisher
        self.logger = logger
        self.n_blocks = 0

    def handshake(self, app_client):
        """Info → replay; returns the possibly-updated State
        (ref: replay.go:225 Handshake)."""
        res = app_client.info(abci.RequestInfo(version="0.35.0-tpu"))
        app_height = res.last_block_height
        app_hash = res.last_block_app_hash
        if app_height < 0:
            raise HandshakeError(f"got a negative last block height ({app_height}) from the app")
        state = self.replay_blocks(self.initial_state, app_client, app_hash, app_height)
        return state

    # ------------------------------------------------------------ replay

    def replay_blocks(self, state, app_client, app_hash: bytes, app_height: int):
        """ref: replay.go:279 ReplayBlocks."""
        store_height = self.block_store.height()
        store_base = self.block_store.base()

        # 1. fresh chain → InitChain (replay.go:292-334). Validators and
        # params come from the GENESIS doc, not the current state — a
        # fresh app on an old chain must re-derive updates by replay.
        if app_height == 0:
            if self.gen_doc.validators:
                validators = [
                    abci.ValidatorUpdate(
                        pub_key_type=gv.pub_key.type_name,
                        pub_key_bytes=gv.pub_key.bytes(),
                        power=gv.power,
                    )
                    for gv in self.gen_doc.validators
                ]
            else:
                validators = []
            req = abci.RequestInitChain(
                time_ns=self.gen_doc.genesis_time.unix_ns(),
                chain_id=self.gen_doc.chain_id,
                consensus_params=self.gen_doc.consensus_params or state.consensus_params,
                validators=validators,
                app_state_bytes=getattr(self.gen_doc, "app_state", b"") or b"",
                initial_height=self.gen_doc.initial_height,
            )
            ri = app_client.init_chain(req)

            if store_height == 0:  # only a fresh state may be amended
                state = state.copy()
                if ri.app_hash:
                    state.app_hash = ri.app_hash
                    app_hash = ri.app_hash
                if ri.consensus_params is not None:
                    # The wire form is a nullable-sectioned params update
                    # (pb.ConsensusParamsUpdate from a socket app); apply
                    # it over the current params, matching the reference
                    # (replay.go:311 UpdateConsensusParams). In-process
                    # apps may hand back the dataclass directly.
                    cp = ri.consensus_params
                    if not hasattr(cp, "hash_consensus_params"):
                        cp = state.consensus_params.update_consensus_params(cp)
                    state.consensus_params = cp
                    state.version_app = cp.version.app_version
                if ri.validators:
                    vals = validator_updates_from_abci(ri.validators)
                    state.validators = ValidatorSet.new(vals)
                    state.next_validators = ValidatorSet.new(vals).copy_increment_proposer_priority(1)
                elif not self.gen_doc.validators:
                    raise HandshakeError("validator set is nil in genesis and still empty after InitChain")
                self.state_store.save(state)

        # 2. app and store in sync? (replay.go:344-376)
        if store_height == 0:
            if app_height > 0:
                raise AppHashMismatchError(
                    f"app is at height {app_height} but the block store is empty; "
                    "wrong data dir or wiped chain — refusing to restart from genesis"
                )
            return state

        if store_height == app_height:
            # Crash between app Commit and state save: the app already
            # executed the block, so fold it into framework state from
            # the STORED FinalizeBlock responses — never re-execute on
            # the live app (the reference uses a mock proxy here,
            # replay.go:440-460).
            while state.last_block_height < store_height:
                state = self._apply_from_stored_responses(state, state.last_block_height + 1)
                self.n_blocks += 1
            self._assert_app_hash(state.app_hash, app_hash)
            return state

        if app_height < store_height:
            # app is behind → replay missing blocks against the app
            if app_height < store_base - 1:
                raise HandshakeError(
                    f"app height {app_height} is too far below block store base {store_base}; "
                    "statesync or app snapshot restore required"
                )
            state = self._replay_range(state, app_client, app_height, store_height,
                                       mutate_app=True, reported_app_hash=app_hash)
            return state

        raise AppHashMismatchError(
            f"app block height ({app_height}) is higher than the chain ({store_height}); "
            "rollback the app or resync"
        )

    def _replay_range(self, state, app_client, from_height: int, to_height: int,
                      mutate_app: bool, reported_app_hash: bytes = b""):
        """Replay (from, to] (ref: replay.go:378-470 replayBlocks).

        Heights the state already covers are executed against the app
        ONLY (FinalizeBlock+Commit, no state mutation — the reference's
        execBlockOnProxyApp); heights beyond the state go through the
        full BlockExecutor.ApplyBlock."""
        from ..types.block import BlockID

        executor = BlockExecutor(
            self.state_store,
            app_client,
            block_store=self.block_store,
            event_publisher=self.event_publisher,
            device=self.device,
        )
        # Seed the divergence check with the app's Info-reported hash:
        # the FIRST replayed block's header records exactly the hash the
        # app should currently hold — without the seed, divergence that
        # happened BEFORE the crash slips through when only the final
        # block needs replaying (apply_block validates against framework
        # state, not the app).
        app_hash = reported_app_hash or None
        state_height_before = state.last_block_height
        for height in range(from_height + 1, to_height + 1):
            block = self.block_store.load_block(height)
            if block is None:
                raise HandshakeError(f"block store is missing block at height {height}")
            # each block's header records the app hash AFTER the
            # previous block: the app's replayed execution must match
            # it or the app has diverged from the chain (ref:
            # checkAppHashEqualsOneFromBlock, replay.go:487 — starting
            # a forked app would make this node propose invalid blocks)
            if app_hash is not None and block.header.app_hash != app_hash:
                raise AppHashMismatchError(
                    f"app hash after replaying height {height - 1} "
                    f"({app_hash.hex()}) does not match the chain "
                    f"({block.header.app_hash.hex()})"
                )
            meta = self.block_store.load_block_meta(height)
            block_id = meta.block_id if meta else BlockID(hash=block.hash(), part_set_header=None)
            if height <= state.last_block_height:
                if mutate_app:
                    app_hash = self._exec_block_on_app(executor, app_client, block, state)
                    self.n_blocks += 1
                continue
            state = executor.apply_block(state, block_id, block)
            app_hash = state.app_hash
            self.n_blocks += 1
        # the final block has no successor header to check against; when
        # the framework state ALREADY covered it (exec-only path — gate
        # on the pre-loop height, apply_block advances the live one),
        # the state's recorded app hash is the authority
        if mutate_app and app_hash is not None and to_height <= state_height_before:
            self._assert_app_hash(state.app_hash, app_hash)
        return state

    def _exec_block_on_app(self, executor, app_client, block, state) -> bytes:
        """FinalizeBlock + Commit without touching framework state;
        returns the app's post-block hash for divergence checking
        (ref: replay.go execBlockOnProxyApp -> ExecCommitBlock)."""
        from ..types.evidence import evidence_to_abci

        res = app_client.finalize_block(
            abci.RequestFinalizeBlock(
                hash=block.hash(),
                height=block.header.height,
                time_ns=block.header.time.unix_ns(),
                txs=list(block.txs),
                decided_last_commit=executor.build_last_commit_info(block, state.initial_height),
                misbehavior=evidence_to_abci(block.evidence),
                proposer_address=block.header.proposer_address,
                next_validators_hash=block.header.next_validators_hash,
            )
        )
        app_client.commit()
        return res.app_hash

    def _apply_from_stored_responses(self, state, height: int):
        """Advance state one height using the FinalizeBlock responses
        persisted before the crash (ref: replay.go mock-proxy replay)."""
        from ..state.execution import tx_results_hash
        from ..types.block import BlockID

        block = self.block_store.load_block(height)
        if block is None:
            raise HandshakeError(f"block store is missing block at height {height}")
        f_res = self.state_store.load_finalize_block_responses(height)
        if f_res is None:
            raise HandshakeError(
                f"no stored FinalizeBlock responses for height {height}; cannot catch state up"
            )
        meta = self.block_store.load_block_meta(height)
        block_id = meta.block_id if meta else BlockID(hash=block.hash(), part_set_header=None)
        validator_updates = validator_updates_from_abci(f_res.validator_updates)
        results_hash = tx_results_hash(f_res.tx_results)
        new_state = state.update(
            block_id, block.header, results_hash, f_res.consensus_param_updates, validator_updates
        )
        new_state.app_hash = f_res.app_hash
        self.state_store.save(new_state)
        return new_state

    @staticmethod
    def _assert_app_hash(state_hash: bytes, app_hash: bytes) -> None:
        if state_hash and app_hash and state_hash != app_hash:
            raise AppHashMismatchError(
                f"app hash mismatch: state {state_hash.hex()} vs app {app_hash.hex()}; "
                "use rollback to recover"
            )
