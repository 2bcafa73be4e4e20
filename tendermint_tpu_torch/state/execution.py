"""BlockExecutor: runs blocks through the app over ABCI (ref:
internal/state/execution.go:27).

CreateProposalBlock (then PrepareProposal), ProcessProposal, ValidateBlock
(whose LastCommit check runs the batch verifiers, on the card unless the
executor was given device="cpu"), ApplyBlock (FinalizeBlock, then
State.update, then Commit), and the vote-extension calls consensus makes.
"""

from __future__ import annotations

import time as _time

from .. import trace as _trace
from ..abci import types as abci
from ..abci.client import Client
from ..crypto.merkle import hash_from_byte_slices
from ..proto import wire
from ..types.block import Block, BlockID, Commit
from ..types.evidence import evidence_to_abci
from ..types.validator_set import Validator
from ..types.vote import Vote
from .state import State
from .store import StateStore
from .validation import validate_block


def tx_results_hash(tx_results: list[abci.ExecTxResult]) -> bytes:
    """Merkle root of the deterministically encoded tx results (ref:
    abci.MarshalTxResults and merkle.HashFromByteSlices,
    execution.go:263-266): code, data, gas_wanted and gas_used only, as
    abci/types/result.go deterministicExecTxResult."""
    items = []
    for r in tx_results:
        buf = b""
        if r.code:
            buf += wire.encode_tag(1, wire.WIRE_VARINT) + wire.encode_varint(r.code)
        if r.data:
            buf += wire.encode_tag(2, wire.WIRE_BYTES) + wire.encode_bytes(r.data)
        if r.gas_wanted:
            buf += wire.encode_tag(5, wire.WIRE_VARINT) + wire.encode_varint(r.gas_wanted & (2**64 - 1))
        if r.gas_used:
            buf += wire.encode_tag(6, wire.WIRE_VARINT) + wire.encode_varint(r.gas_used & (2**64 - 1))
        items.append(buf)
    return hash_from_byte_slices(items, site="tx_results")


def validator_updates_from_abci(updates: list[abci.ValidatorUpdate]) -> list[Validator]:
    """ref: types.PB2TM.ValidatorUpdates (types/protobuf.go)."""
    from ..crypto.ed25519 import Ed25519PubKey
    from ..crypto.secp256k1 import Secp256k1PubKey

    out = []
    for u in updates:
        if u.pub_key_type in ("ed25519", "tendermint/PubKeyEd25519"):
            pk = Ed25519PubKey(u.pub_key_bytes)
        elif u.pub_key_type in ("secp256k1", "tendermint/PubKeySecp256k1"):
            pk = Secp256k1PubKey(u.pub_key_bytes)
        elif u.pub_key_type in ("sr25519", "tendermint/PubKeySr25519"):
            from ..crypto.sr25519 import Sr25519PubKey

            pk = Sr25519PubKey(u.pub_key_bytes)
        else:
            raise ValueError(f"unsupported pubkey type {u.pub_key_type}")
        out.append(Validator(address=pk.address(), pub_key=pk, voting_power=u.power))
    return out


def validate_validator_updates(updates: list[abci.ValidatorUpdate], params) -> None:
    """ref: validateValidatorUpdates (execution.go:500)."""
    for u in updates:
        if u.power < 0:
            raise ValueError(f"voting power can't be negative: {u}")
        if u.power == 0:
            continue
        if u.pub_key_type not in params.pub_key_types:
            raise ValueError(f"validator {u} is using pubkey {u.pub_key_type}, which is unsupported for consensus")


class _NopMempool:
    """Replay-stub mempool (ref: internal/consensus/replay_stubs.go)."""

    def lock(self):
        pass

    def unlock(self):
        pass

    max_gas = -1  # admission gas cap; kept in the interface so the
    # commit-path refresh needs no duck-typing guard

    def reap_max_bytes_max_gas(self, max_bytes: int, max_gas: int) -> list[bytes]:
        return []

    def update(self, height, txs, tx_results, recheck=True):
        pass

    def remove_tx_by_key(self, key: bytes) -> None:
        pass


class _NopEvidencePool:
    """ref: sm.EmptyEvidencePool."""

    def pending_evidence(self, max_bytes: int) -> tuple[list, int]:
        return [], 0

    def check_evidence(self, evidence: list, device=None) -> None:
        pass

    def update(self, state: State, evidence: list) -> None:
        pass


class BlockExecutor:
    """ref: sm.BlockExecutor (internal/state/execution.go:27-84)."""

    def __init__(
        self,
        state_store: StateStore,
        app_client: Client,
        mempool=None,
        evidence_pool=None,
        block_store=None,
        event_publisher=None,
        metrics=None,
        device=None,
    ):
        """`device` is where the LastCommit checks and the evidence pool's
        commit checks run: the card when None, the plain versions on the
        host with "cpu". `metrics` is a StateMetrics."""
        self.store = state_store
        self.app = app_client
        self.mempool = mempool if mempool is not None else _NopMempool()
        self.evpool = evidence_pool if evidence_pool is not None else _NopEvidencePool()
        self.block_store = block_store
        self.event_publisher = event_publisher
        self.metrics = metrics
        self.device = device
        # Last validated block hash: apply_block only ever re-validates the
        # block just validated, so one slot suffices (vs the reference's
        # map at execution.go:44, which also only ever holds the tip).
        self._last_validated_hash: bytes | None = None

    # -------------------------------------------------------- proposals

    def create_proposal_block(
        self,
        height: int,
        state: State,
        last_commit: Commit | None,
        proposer_address: bytes,
        block_time=None,
        local_last_commit: abci.ExtendedCommitInfo | None = None,
    ) -> Block:
        """ref: CreateProposalBlock (execution.go:86)."""
        max_bytes = state.consensus_params.block.max_bytes
        max_gas = state.consensus_params.block.max_gas
        evidence, ev_size = self.evpool.pending_evidence(state.consensus_params.evidence.max_bytes)
        max_data_bytes = max_data_bytes_for(max_bytes, ev_size, state.validators.size())
        txs = self.mempool.reap_max_bytes_max_gas(max_data_bytes, max_gas)
        if block_time is None:
            from ..utils.tmtime import Time

            block_time = Time.now()  # resolve once: PrepareProposal and the final block must agree
        block = state.make_block(height, txs, last_commit, evidence, proposer_address, block_time)
        rpp = self.app.prepare_proposal(
            abci.RequestPrepareProposal(
                max_tx_bytes=max_data_bytes,
                txs=list(block.txs),
                local_last_commit=local_last_commit or abci.ExtendedCommitInfo(),
                misbehavior=evidence_to_abci(block.evidence),
                height=block.header.height,
                time_ns=block.header.time.unix_ns(),
                next_validators_hash=block.header.next_validators_hash,
                proposer_address=block.header.proposer_address,
            )
        )
        total = sum(len(tx) for tx in rpp.txs)
        if total > max_data_bytes:
            raise ValueError(f"transaction data size {total} exceeds maximum {max_data_bytes}")
        return state.make_block(height, list(rpp.txs), last_commit, evidence, proposer_address, block_time)

    def process_proposal(self, block: Block, state: State) -> bool:
        """ref: ProcessProposal (execution.go:144)."""
        resp = self.app.process_proposal(
            abci.RequestProcessProposal(
                hash=block.hash(),
                height=block.header.height,
                time_ns=block.header.time.unix_ns(),
                txs=list(block.txs),
                proposed_last_commit=self.build_last_commit_info(block, state.initial_height),
                misbehavior=evidence_to_abci(block.evidence),
                proposer_address=block.header.proposer_address,
                next_validators_hash=block.header.next_validators_hash,
            )
        )
        if resp.status == abci.PROPOSAL_STATUS_UNKNOWN:
            raise RuntimeError("ProcessProposal responded with status UNKNOWN")
        return resp.is_accepted

    # ------------------------------------------------------- validation

    def validate_block(self, state: State, block: Block) -> None:
        """ref: ValidateBlock (execution.go:173), memoized by block hash."""
        h = block.hash()
        if h == self._last_validated_hash:
            return
        validate_block(state, block, device=self.device)
        self.evpool.check_evidence(block.evidence, device=self.device)
        self._last_validated_hash = h

    # ------------------------------------------------------ application

    def apply_block(self, state: State, block_id: BlockID, block: Block) -> State:
        """ref: ApplyBlock (execution.go:199): validate, FinalizeBlock,
        State.update, Commit, prune, fire events."""
        with _trace.span("state.apply_block", "state",
                         height=block.header.height, txs=len(block.txs)):
            return self._apply_block(state, block_id, block)

    def _apply_block(self, state: State, block_id: BlockID, block: Block) -> State:
        with _trace.span("state.validate_block", "state",
                         height=block.header.height):
            self.validate_block(state, block)

        start = _time.perf_counter()
        with _trace.span("state.finalize_block", "state",
                         height=block.header.height, txs=len(block.txs)):
            f_res = self.app.finalize_block(
                abci.RequestFinalizeBlock(
                    hash=block.hash(),
                    height=block.header.height,
                    time_ns=block.header.time.unix_ns(),
                    txs=list(block.txs),
                    decided_last_commit=self.build_last_commit_info(block, state.initial_height),
                    misbehavior=evidence_to_abci(block.evidence),
                    proposer_address=block.header.proposer_address,
                    next_validators_hash=block.header.next_validators_hash,
                )
            )
        if self.metrics is not None:
            self.metrics.observe("block_processing_time", _time.perf_counter() - start)

        self.store.save_finalize_block_responses(block.header.height, f_res)

        validate_validator_updates(f_res.validator_updates, state.consensus_params.validator)
        validator_updates = validator_updates_from_abci(f_res.validator_updates)

        results_hash = tx_results_hash(f_res.tx_results)
        new_state = state.update(
            block_id, block.header, results_hash, f_res.consensus_param_updates, validator_updates
        )

        retain_height = self.commit(new_state, block, f_res.tx_results)

        self.evpool.update(new_state, block.evidence)

        new_state.app_hash = f_res.app_hash
        self.store.save(new_state)

        if retain_height > 0 and self.block_store is not None:
            try:
                self.block_store.prune_blocks(retain_height)
                self.store.prune_states(retain_height)
            except Exception:
                pass  # pruning failure is non-fatal (execution.go:296)

        if self.event_publisher is not None:
            self.event_publisher(block, block_id, f_res, validator_updates)
        return new_state

    def commit(self, state: State, block: Block, tx_results: list[abci.ExecTxResult]) -> int:
        """Lock mempool, ABCI Commit, update mempool
        (ref: BlockExecutor.Commit, execution.go:342)."""
        self.mempool.lock()
        try:
            with _trace.span("state.abci_commit", "state",
                             height=block.header.height):
                res = self.app.commit()
            # the on-chain params may have changed at this block: refresh
            # the admission gas cap (the reference's PostCheckMaxGas)
            self.mempool.max_gas = state.consensus_params.block.max_gas
            self.mempool.update(
                block.header.height,
                list(block.txs),
                tx_results,
                recheck=state.consensus_params.abci.recheck_tx,
            )
            return res.retain_height
        finally:
            self.mempool.unlock()

    # -------------------------------------------------- vote extensions

    def extend_vote(self, vote: Vote) -> bytes:
        """ref: ExtendVote (execution.go:307)."""
        resp = self.app.extend_vote(abci.RequestExtendVote(hash=vote.block_id.hash, height=vote.height))
        return resp.vote_extension

    def verify_vote_extension(self, vote: Vote) -> bool:
        """ref: VerifyVoteExtension (execution.go:318)."""
        resp = self.app.verify_vote_extension(
            abci.RequestVerifyVoteExtension(
                hash=vote.block_id.hash,
                validator_address=vote.validator_address,
                height=vote.height,
                vote_extension=vote.extension,
            )
        )
        return resp.is_accepted

    # ----------------------------------------------------------- helpers

    def build_last_commit_info(self, block: Block, initial_height: int) -> abci.CommitInfo:
        """ref: buildLastCommitInfo (execution.go:388)."""
        if block.header.height == initial_height:
            return abci.CommitInfo()
        last_val_set = self.store.load_validators(block.header.height - 1)
        if last_val_set is None:
            raise RuntimeError(f"failed to load validator set at height {block.header.height - 1}")
        commit = block.last_commit
        if commit.size() != last_val_set.size():
            raise RuntimeError(
                f"commit size ({commit.size()}) doesn't match validator set length ({last_val_set.size()}) "
                f"at height {block.header.height}"
            )
        votes = [
            abci.VoteInfo(
                validator=abci.Validator(address=val.address, power=val.voting_power),
                signed_last_block=not commit.signatures[i].absent(),
            )
            for i, val in enumerate(last_val_set.validators)
        ]
        return abci.CommitInfo(round=commit.round, votes=votes)


def max_data_bytes_for(max_bytes: int, evidence_bytes: int, num_validators: int) -> int:
    """ref: types.MaxDataBytes (types/block.go): the block budget less the
    header, commit and evidence overhead."""
    from ..types.block import MAX_HEADER_BYTES

    MAX_OVERHEAD_FOR_BLOCK = 11
    COMMIT_OVERHEAD = 94  # per-signature overhead (MaxCommitOverheadBytes)
    COMMIT_BASE = 82
    if max_bytes < 0:
        return -1
    data_bytes = (
        max_bytes
        - MAX_OVERHEAD_FOR_BLOCK
        - MAX_HEADER_BYTES
        - COMMIT_BASE
        - num_validators * COMMIT_OVERHEAD
        - evidence_bytes
    )
    if data_bytes < 0:
        raise ValueError(
            f"negative MaxDataBytes. Block.MaxBytes={max_bytes} is too small to accommodate header&lastCommit&evidence"
        )
    return data_bytes
