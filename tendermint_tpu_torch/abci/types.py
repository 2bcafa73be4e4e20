"""ABCI++ request and response types and the Application interface.

ref: abci/types/application.go:8-34 (the interface), abci/types/types.pb.go
(the message shapes). Plain dataclasses: an in-process app, behind the
local client (abci/client.py, ref: abci/client/local_client.go), pays no
serialization.
"""

from __future__ import annotations

from abc import ABC
from dataclasses import dataclass, field

CODE_TYPE_OK = 0

# ResponseOfferSnapshot / ResponseApplySnapshotChunk result codes
# (ref: abci/types/types.pb.go ResponseOfferSnapshot_Result).
SNAPSHOT_ACCEPT = 1
SNAPSHOT_ABORT = 2
SNAPSHOT_REJECT = 3
SNAPSHOT_REJECT_FORMAT = 4
SNAPSHOT_REJECT_SENDER = 5

CHUNK_ACCEPT = 1
CHUNK_ABORT = 2
CHUNK_RETRY = 3
CHUNK_RETRY_SNAPSHOT = 4
CHUNK_REJECT_SNAPSHOT = 5

PROPOSAL_STATUS_UNKNOWN = 0
PROPOSAL_STATUS_ACCEPT = 1
PROPOSAL_STATUS_REJECT = 2

VERIFY_STATUS_UNKNOWN = 0
VERIFY_STATUS_ACCEPT = 1
VERIFY_STATUS_REJECT = 2


@dataclass
class EventAttribute:
    key: str = ""
    value: str = ""
    index: bool = False


@dataclass
class Event:
    type: str = ""
    attributes: list[EventAttribute] = field(default_factory=list)


@dataclass
class ValidatorUpdate:
    """ref: abci.ValidatorUpdate: a key (type and bytes) and its power."""

    pub_key_type: str = "ed25519"
    pub_key_bytes: bytes = b""
    power: int = 0


@dataclass
class Validator:
    """A validator in LastCommitInfo and Misbehavior: address and power."""

    address: bytes = b""
    power: int = 0


@dataclass
class VoteInfo:
    validator: Validator = field(default_factory=Validator)
    signed_last_block: bool = False


@dataclass
class ExtendedVoteInfo:
    validator: Validator = field(default_factory=Validator)
    signed_last_block: bool = False
    vote_extension: bytes = b""


@dataclass
class CommitInfo:
    round: int = 0
    votes: list[VoteInfo] = field(default_factory=list)


@dataclass
class ExtendedCommitInfo:
    round: int = 0
    votes: list[ExtendedVoteInfo] = field(default_factory=list)


MISBEHAVIOR_DUPLICATE_VOTE = 1
MISBEHAVIOR_LIGHT_CLIENT_ATTACK = 2


@dataclass
class Misbehavior:
    type: int = 0
    validator: Validator = field(default_factory=Validator)
    height: int = 0
    time_ns: int = 0
    total_voting_power: int = 0


@dataclass
class ExecTxResult:
    """ref: abci.ExecTxResult: one transaction's result in FinalizeBlock."""

    code: int = CODE_TYPE_OK
    data: bytes = b""
    log: str = ""
    info: str = ""
    gas_wanted: int = 0
    gas_used: int = 0
    events: list[Event] = field(default_factory=list)
    codespace: str = ""

    @property
    def is_ok(self) -> bool:
        return self.code == CODE_TYPE_OK


@dataclass
class Snapshot:
    height: int = 0
    format: int = 0
    chunks: int = 0
    hash: bytes = b""
    metadata: bytes = b""


# ---------------------------------------------------------------- requests


@dataclass
class RequestInfo:
    version: str = ""
    block_version: int = 0
    p2p_version: int = 0
    abci_version: str = ""


@dataclass
class RequestQuery:
    data: bytes = b""
    path: str = ""
    height: int = 0
    prove: bool = False


@dataclass
class RequestCheckTx:
    tx: bytes = b""
    type: int = 0  # 0 = New, 1 = Recheck


@dataclass
class RequestInitChain:
    time_ns: int = 0
    chain_id: str = ""
    consensus_params: object | None = None
    validators: list[ValidatorUpdate] = field(default_factory=list)
    app_state_bytes: bytes = b""
    initial_height: int = 1


@dataclass
class RequestPrepareProposal:
    max_tx_bytes: int = 0
    txs: list[bytes] = field(default_factory=list)
    local_last_commit: ExtendedCommitInfo = field(default_factory=ExtendedCommitInfo)
    misbehavior: list[Misbehavior] = field(default_factory=list)
    height: int = 0
    time_ns: int = 0
    next_validators_hash: bytes = b""
    proposer_address: bytes = b""


@dataclass
class RequestProcessProposal:
    txs: list[bytes] = field(default_factory=list)
    proposed_last_commit: CommitInfo = field(default_factory=CommitInfo)
    misbehavior: list[Misbehavior] = field(default_factory=list)
    hash: bytes = b""
    height: int = 0
    time_ns: int = 0
    next_validators_hash: bytes = b""
    proposer_address: bytes = b""


@dataclass
class RequestExtendVote:
    hash: bytes = b""
    height: int = 0


@dataclass
class RequestVerifyVoteExtension:
    hash: bytes = b""
    validator_address: bytes = b""
    height: int = 0
    vote_extension: bytes = b""


@dataclass
class RequestFinalizeBlock:
    txs: list[bytes] = field(default_factory=list)
    decided_last_commit: CommitInfo = field(default_factory=CommitInfo)
    misbehavior: list[Misbehavior] = field(default_factory=list)
    hash: bytes = b""
    height: int = 0
    time_ns: int = 0
    next_validators_hash: bytes = b""
    proposer_address: bytes = b""


@dataclass
class RequestListSnapshots:
    pass


@dataclass
class RequestOfferSnapshot:
    snapshot: Snapshot = field(default_factory=Snapshot)
    app_hash: bytes = b""


@dataclass
class RequestLoadSnapshotChunk:
    height: int = 0
    format: int = 0
    chunk: int = 0


@dataclass
class RequestApplySnapshotChunk:
    index: int = 0
    chunk: bytes = b""
    sender: str = ""


# ---------------------------------------------------------------- responses


@dataclass
class ResponseInfo:
    data: str = ""
    version: str = ""
    app_version: int = 0
    last_block_height: int = 0
    last_block_app_hash: bytes = b""


@dataclass
class ResponseQuery:
    code: int = CODE_TYPE_OK
    log: str = ""
    info: str = ""
    index: int = 0
    key: bytes = b""
    value: bytes = b""
    proof_ops: list | None = None
    height: int = 0
    codespace: str = ""


@dataclass
class ResponseCheckTx:
    code: int = CODE_TYPE_OK
    data: bytes = b""
    log: str = ""
    info: str = ""
    gas_wanted: int = 0
    gas_used: int = 0
    events: list[Event] = field(default_factory=list)
    codespace: str = ""
    sender: str = ""
    priority: int = 0
    mempool_error: str = ""

    @property
    def is_ok(self) -> bool:
        return self.code == CODE_TYPE_OK


@dataclass
class ResponseInitChain:
    consensus_params: object | None = None
    validators: list[ValidatorUpdate] = field(default_factory=list)
    app_hash: bytes = b""


@dataclass
class ResponsePrepareProposal:
    txs: list[bytes] = field(default_factory=list)


@dataclass
class ResponseProcessProposal:
    status: int = PROPOSAL_STATUS_UNKNOWN

    @property
    def is_accepted(self) -> bool:
        return self.status == PROPOSAL_STATUS_ACCEPT


@dataclass
class ResponseExtendVote:
    vote_extension: bytes = b""


@dataclass
class ResponseVerifyVoteExtension:
    status: int = VERIFY_STATUS_UNKNOWN

    @property
    def is_accepted(self) -> bool:
        return self.status == VERIFY_STATUS_ACCEPT


@dataclass
class ResponseFinalizeBlock:
    events: list[Event] = field(default_factory=list)
    tx_results: list[ExecTxResult] = field(default_factory=list)
    validator_updates: list[ValidatorUpdate] = field(default_factory=list)
    consensus_param_updates: object | None = None
    app_hash: bytes = b""


@dataclass
class ResponseCommit:
    retain_height: int = 0


@dataclass
class ResponseListSnapshots:
    snapshots: list[Snapshot] = field(default_factory=list)


@dataclass
class ResponseOfferSnapshot:
    result: int = SNAPSHOT_REJECT


@dataclass
class ResponseLoadSnapshotChunk:
    chunk: bytes = b""


@dataclass
class ResponseApplySnapshotChunk:
    result: int = CHUNK_REJECT_SNAPSHOT
    refetch_chunks: list[int] = field(default_factory=list)
    reject_senders: list[str] = field(default_factory=list)


# ---------------------------------------------------------------- interface


class Application(ABC):
    """Deterministic state machine driven via ABCI++
    (ref: abci/types/application.go:8-34). All methods have no-op
    defaults so apps override only what they need (BaseApplication,
    application.go:37-99)."""

    # Info/Query connection
    def info(self, req: RequestInfo) -> ResponseInfo:
        return ResponseInfo()

    def query(self, req: RequestQuery) -> ResponseQuery:
        return ResponseQuery()

    # Mempool connection
    def check_tx(self, req: RequestCheckTx) -> ResponseCheckTx:
        return ResponseCheckTx(code=CODE_TYPE_OK)

    # Consensus connection
    def init_chain(self, req: RequestInitChain) -> ResponseInitChain:
        return ResponseInitChain()

    def prepare_proposal(self, req: RequestPrepareProposal) -> ResponsePrepareProposal:
        """Default: include txs that fit in max_tx_bytes
        (ref: application.go:75-87)."""
        txs, total = [], 0
        for tx in req.txs:
            total += len(tx)
            if req.max_tx_bytes >= 0 and total > req.max_tx_bytes:
                break
            txs.append(tx)
        return ResponsePrepareProposal(txs=txs)

    def process_proposal(self, req: RequestProcessProposal) -> ResponseProcessProposal:
        return ResponseProcessProposal(status=PROPOSAL_STATUS_ACCEPT)

    def extend_vote(self, req: RequestExtendVote) -> ResponseExtendVote:
        return ResponseExtendVote()

    def verify_vote_extension(self, req: RequestVerifyVoteExtension) -> ResponseVerifyVoteExtension:
        return ResponseVerifyVoteExtension(status=VERIFY_STATUS_ACCEPT)

    def finalize_block(self, req: RequestFinalizeBlock) -> ResponseFinalizeBlock:
        return ResponseFinalizeBlock(tx_results=[ExecTxResult() for _ in req.txs])

    def commit(self) -> ResponseCommit:
        return ResponseCommit()

    # State-sync connection
    def list_snapshots(self, req: RequestListSnapshots) -> ResponseListSnapshots:
        return ResponseListSnapshots()

    def offer_snapshot(self, req: RequestOfferSnapshot) -> ResponseOfferSnapshot:
        return ResponseOfferSnapshot()

    def load_snapshot_chunk(self, req: RequestLoadSnapshotChunk) -> ResponseLoadSnapshotChunk:
        return ResponseLoadSnapshotChunk()

    def apply_snapshot_chunk(self, req: RequestApplySnapshotChunk) -> ResponseApplySnapshotChunk:
        return ResponseApplySnapshotChunk()


class BaseApplication(Application):
    """Concrete no-op application (ref: abci/types/application.go:37)."""
