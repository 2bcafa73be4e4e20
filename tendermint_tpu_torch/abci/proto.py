"""ABCI wire messages + dataclass converters (socket/grpc transports).

Proto schemas mirror `proto/tendermint/abci/types.proto` (field numbers
byte-compatible with the reference, including the reserved gaps left by
the removed BeginBlock/DeliverTx/EndBlock calls). The in-process
LocalClient never touches this module — zero serialization on the
builtin path, as in the reference (abci/client/local_client.go).

Layout notes vs the internal dataclasses (abci/types.py):
  - dataclass time_ns int fields <-> google.protobuf.Timestamp
  - ResponsePrepareProposal.txs <-> repeated TxRecord (UNMODIFIED out,
    non-REMOVED in; ref: abci/types.proto TxRecord)
"""

from __future__ import annotations

from ..proto.message import Field, Message
from ..proto.messages import ConsensusParamsUpdate, PublicKey, Timestamp
from . import types as T

# ---------------------------------------------------------------- shared


class ValidatorPB(Message):
    fields = [Field(1, "bytes", "address"), Field(3, "int64", "power")]


class ValidatorUpdatePB(Message):
    fields = [
        Field(1, "message", "pub_key", always_emit=True, msg_cls=PublicKey),
        Field(2, "int64", "power"),
    ]


class VoteInfoPB(Message):
    fields = [
        Field(1, "message", "validator", always_emit=True, msg_cls=ValidatorPB),
        Field(2, "bool", "signed_last_block"),
    ]


class ExtendedVoteInfoPB(Message):
    fields = [
        Field(1, "message", "validator", always_emit=True, msg_cls=ValidatorPB),
        Field(2, "bool", "signed_last_block"),
        Field(3, "bytes", "vote_extension"),
    ]


class CommitInfoPB(Message):
    fields = [
        Field(1, "int32", "round"),
        Field(2, "message", "votes", repeated=True, msg_cls=VoteInfoPB),
    ]


class ExtendedCommitInfoPB(Message):
    fields = [
        Field(1, "int32", "round"),
        Field(2, "message", "votes", repeated=True, msg_cls=ExtendedVoteInfoPB),
    ]


class MisbehaviorPB(Message):
    fields = [
        Field(1, "enum", "type"),
        Field(2, "message", "validator", always_emit=True, msg_cls=ValidatorPB),
        Field(3, "int64", "height"),
        Field(4, "message", "time", always_emit=True, msg_cls=Timestamp),
        Field(5, "int64", "total_voting_power"),
    ]


class EventAttributePB(Message):
    fields = [
        Field(1, "string", "key"),
        Field(2, "string", "value"),
        Field(3, "bool", "index"),
    ]


class EventPB(Message):
    fields = [
        Field(1, "string", "type"),
        Field(2, "message", "attributes", repeated=True, msg_cls=EventAttributePB),
    ]


class ExecTxResultPB(Message):
    fields = [
        Field(1, "uint32", "code"),
        Field(2, "bytes", "data"),
        Field(3, "string", "log"),
        Field(4, "string", "info"),
        Field(5, "int64", "gas_wanted"),
        Field(6, "int64", "gas_used"),
        Field(7, "message", "events", repeated=True, msg_cls=EventPB),
        Field(8, "string", "codespace"),
    ]


class TxResultPB(Message):
    """abci.TxResult — the indexing record (types.proto:385)."""

    fields = [
        Field(1, "int64", "height"),
        Field(2, "uint32", "index"),
        Field(3, "bytes", "tx"),
        Field(4, "message", "result", always_emit=True, msg_cls=ExecTxResultPB),
    ]


TXRECORD_UNKNOWN = 0
TXRECORD_UNMODIFIED = 1
TXRECORD_ADDED = 2
TXRECORD_REMOVED = 3


class TxRecordPB(Message):
    fields = [Field(1, "enum", "action"), Field(2, "bytes", "tx")]


class SnapshotPB(Message):
    fields = [
        Field(1, "uint64", "height"),
        Field(2, "uint32", "format"),
        Field(3, "uint32", "chunks"),
        Field(4, "bytes", "hash"),
        Field(5, "bytes", "metadata"),
    ]


# --------------------------------------------------------------- requests


class RequestEchoPB(Message):
    fields = [Field(1, "string", "message")]


class RequestFlushPB(Message):
    fields = []


class RequestInfoPB(Message):
    fields = [
        Field(1, "string", "version"),
        Field(2, "uint64", "block_version"),
        Field(3, "uint64", "p2p_version"),
        Field(4, "string", "abci_version"),
    ]


class RequestInitChainPB(Message):
    fields = [
        Field(1, "message", "time", always_emit=True, msg_cls=Timestamp),
        Field(2, "string", "chain_id"),
        Field(3, "message", "consensus_params", msg_cls=ConsensusParamsUpdate),
        Field(4, "message", "validators", repeated=True, msg_cls=ValidatorUpdatePB),
        Field(5, "bytes", "app_state_bytes"),
        Field(6, "int64", "initial_height"),
    ]


class RequestQueryPB(Message):
    fields = [
        Field(1, "bytes", "data"),
        Field(2, "string", "path"),
        Field(3, "int64", "height"),
        Field(4, "bool", "prove"),
    ]


class RequestCheckTxPB(Message):
    fields = [Field(1, "bytes", "tx"), Field(2, "enum", "type")]


class RequestCommitPB(Message):
    fields = []


class RequestListSnapshotsPB(Message):
    fields = []


class RequestOfferSnapshotPB(Message):
    fields = [
        Field(1, "message", "snapshot", msg_cls=SnapshotPB),
        Field(2, "bytes", "app_hash"),
    ]


class RequestLoadSnapshotChunkPB(Message):
    fields = [
        Field(1, "uint64", "height"),
        Field(2, "uint32", "format"),
        Field(3, "uint32", "chunk"),
    ]


class RequestApplySnapshotChunkPB(Message):
    fields = [
        Field(1, "uint32", "index"),
        Field(2, "bytes", "chunk"),
        Field(3, "string", "sender"),
    ]


class RequestPrepareProposalPB(Message):
    fields = [
        Field(1, "int64", "max_tx_bytes"),
        Field(2, "bytes", "txs", repeated=True),
        Field(3, "message", "local_last_commit", always_emit=True, msg_cls=ExtendedCommitInfoPB),
        Field(4, "message", "misbehavior", repeated=True, msg_cls=MisbehaviorPB),
        Field(5, "int64", "height"),
        Field(6, "message", "time", always_emit=True, msg_cls=Timestamp),
        Field(7, "bytes", "next_validators_hash"),
        Field(8, "bytes", "proposer_address"),
    ]


class RequestProcessProposalPB(Message):
    fields = [
        Field(1, "bytes", "txs", repeated=True),
        Field(2, "message", "proposed_last_commit", always_emit=True, msg_cls=CommitInfoPB),
        Field(3, "message", "misbehavior", repeated=True, msg_cls=MisbehaviorPB),
        Field(4, "bytes", "hash"),
        Field(5, "int64", "height"),
        Field(6, "message", "time", always_emit=True, msg_cls=Timestamp),
        Field(7, "bytes", "next_validators_hash"),
        Field(8, "bytes", "proposer_address"),
    ]


class RequestExtendVotePB(Message):
    fields = [Field(1, "bytes", "hash"), Field(2, "int64", "height")]


class RequestVerifyVoteExtensionPB(Message):
    fields = [
        Field(1, "bytes", "hash"),
        Field(2, "bytes", "validator_address"),
        Field(3, "int64", "height"),
        Field(4, "bytes", "vote_extension"),
    ]


class RequestFinalizeBlockPB(Message):
    fields = [
        Field(1, "bytes", "txs", repeated=True),
        Field(2, "message", "decided_last_commit", always_emit=True, msg_cls=CommitInfoPB),
        Field(3, "message", "misbehavior", repeated=True, msg_cls=MisbehaviorPB),
        Field(4, "bytes", "hash"),
        Field(5, "int64", "height"),
        Field(6, "message", "time", always_emit=True, msg_cls=Timestamp),
        Field(7, "bytes", "next_validators_hash"),
        Field(8, "bytes", "proposer_address"),
    ]


class RequestPB(Message):
    """Request oneof (abci/types.proto:19-39; 6,8,9 reserved)."""

    fields = [
        Field(1, "message", "echo", msg_cls=RequestEchoPB),
        Field(2, "message", "flush", msg_cls=RequestFlushPB),
        Field(3, "message", "info", msg_cls=RequestInfoPB),
        Field(4, "message", "init_chain", msg_cls=RequestInitChainPB),
        Field(5, "message", "query", msg_cls=RequestQueryPB),
        Field(7, "message", "check_tx", msg_cls=RequestCheckTxPB),
        Field(10, "message", "commit", msg_cls=RequestCommitPB),
        Field(11, "message", "list_snapshots", msg_cls=RequestListSnapshotsPB),
        Field(12, "message", "offer_snapshot", msg_cls=RequestOfferSnapshotPB),
        Field(13, "message", "load_snapshot_chunk", msg_cls=RequestLoadSnapshotChunkPB),
        Field(14, "message", "apply_snapshot_chunk", msg_cls=RequestApplySnapshotChunkPB),
        Field(15, "message", "prepare_proposal", msg_cls=RequestPrepareProposalPB),
        Field(16, "message", "process_proposal", msg_cls=RequestProcessProposalPB),
        Field(17, "message", "extend_vote", msg_cls=RequestExtendVotePB),
        Field(18, "message", "verify_vote_extension", msg_cls=RequestVerifyVoteExtensionPB),
        Field(19, "message", "finalize_block", msg_cls=RequestFinalizeBlockPB),
    ]



# -------------------------------------------------------------- responses


class ResponseExceptionPB(Message):
    fields = [Field(1, "string", "error")]


class ResponseEchoPB(Message):
    fields = [Field(1, "string", "message")]


class ResponseFlushPB(Message):
    fields = []


class ResponseInfoPB(Message):
    fields = [
        Field(1, "string", "data"),
        Field(2, "string", "version"),
        Field(3, "uint64", "app_version"),
        Field(4, "int64", "last_block_height"),
        Field(5, "bytes", "last_block_app_hash"),
    ]


class ResponseInitChainPB(Message):
    fields = [
        Field(1, "message", "consensus_params", msg_cls=ConsensusParamsUpdate),
        Field(2, "message", "validators", repeated=True, msg_cls=ValidatorUpdatePB),
        Field(3, "bytes", "app_hash"),
    ]


class ResponseQueryPB(Message):
    fields = [
        Field(1, "uint32", "code"),
        Field(3, "string", "log"),
        Field(4, "string", "info"),
        Field(5, "int64", "index"),
        Field(6, "bytes", "key"),
        Field(7, "bytes", "value"),
        Field(9, "int64", "height"),
        Field(10, "string", "codespace"),
    ]


class ResponseCheckTxPB(Message):
    fields = [
        Field(1, "uint32", "code"),
        Field(2, "bytes", "data"),
        Field(5, "int64", "gas_wanted"),
        Field(8, "string", "codespace"),
        Field(9, "string", "sender"),
        Field(10, "int64", "priority"),
    ]


class ResponseCommitPB(Message):
    fields = [Field(3, "int64", "retain_height")]


class ResponseListSnapshotsPB(Message):
    fields = [Field(1, "message", "snapshots", repeated=True, msg_cls=SnapshotPB)]


class ResponseOfferSnapshotPB(Message):
    fields = [Field(1, "enum", "result")]


class ResponseLoadSnapshotChunkPB(Message):
    fields = [Field(1, "bytes", "chunk")]


class ResponseApplySnapshotChunkPB(Message):
    fields = [
        Field(1, "enum", "result"),
        Field(2, "uint32", "refetch_chunks", repeated=True),
        Field(3, "string", "reject_senders", repeated=True),
    ]


class ResponsePrepareProposalPB(Message):
    fields = [Field(1, "message", "tx_records", repeated=True, msg_cls=TxRecordPB)]


class ResponseProcessProposalPB(Message):
    fields = [Field(1, "enum", "status")]


class ResponseExtendVotePB(Message):
    fields = [Field(1, "bytes", "vote_extension")]


class ResponseVerifyVoteExtensionPB(Message):
    fields = [Field(1, "enum", "status")]


class ResponseFinalizeBlockPB(Message):
    fields = [
        Field(1, "message", "events", repeated=True, msg_cls=EventPB),
        Field(2, "message", "tx_results", repeated=True, msg_cls=ExecTxResultPB),
        Field(3, "message", "validator_updates", repeated=True, msg_cls=ValidatorUpdatePB),
        Field(4, "message", "consensus_param_updates", msg_cls=ConsensusParamsUpdate),
        Field(5, "bytes", "app_hash"),
    ]


class ResponsePB(Message):
    """Response oneof (abci/types.proto:163-184; 7,9,10 reserved)."""

    fields = [
        Field(1, "message", "exception", msg_cls=ResponseExceptionPB),
        Field(2, "message", "echo", msg_cls=ResponseEchoPB),
        Field(3, "message", "flush", msg_cls=ResponseFlushPB),
        Field(4, "message", "info", msg_cls=ResponseInfoPB),
        Field(5, "message", "init_chain", msg_cls=ResponseInitChainPB),
        Field(6, "message", "query", msg_cls=ResponseQueryPB),
        Field(8, "message", "check_tx", msg_cls=ResponseCheckTxPB),
        Field(11, "message", "commit", msg_cls=ResponseCommitPB),
        Field(12, "message", "list_snapshots", msg_cls=ResponseListSnapshotsPB),
        Field(13, "message", "offer_snapshot", msg_cls=ResponseOfferSnapshotPB),
        Field(14, "message", "load_snapshot_chunk", msg_cls=ResponseLoadSnapshotChunkPB),
        Field(15, "message", "apply_snapshot_chunk", msg_cls=ResponseApplySnapshotChunkPB),
        Field(16, "message", "prepare_proposal", msg_cls=ResponsePrepareProposalPB),
        Field(17, "message", "process_proposal", msg_cls=ResponseProcessProposalPB),
        Field(18, "message", "extend_vote", msg_cls=ResponseExtendVotePB),
        Field(19, "message", "verify_vote_extension", msg_cls=ResponseVerifyVoteExtensionPB),
        Field(20, "message", "finalize_block", msg_cls=ResponseFinalizeBlockPB),
    ]



# -------------------------------------------------- dataclass converters


def _ts(time_ns: int) -> Timestamp:
    return Timestamp(seconds=time_ns // 1_000_000_000, nanos=time_ns % 1_000_000_000)


def _ts_ns(ts: Timestamp | None) -> int:
    if ts is None:
        return 0
    return (ts.seconds or 0) * 1_000_000_000 + (ts.nanos or 0)


def _params_pb(p) -> ConsensusParamsUpdate | None:
    """Accept either the wire message or the internal ConsensusParams
    dataclass (node code hands InitChain the dataclass; apps may return
    either) and produce the proto for encoding."""
    if p is None or isinstance(p, ConsensusParamsUpdate):
        return p
    to_proto = getattr(p, "to_proto_update", None)
    if to_proto is None:
        raise TypeError(f"cannot encode consensus params of type {type(p).__name__}")
    return to_proto()


def _val_to_pb(v: T.Validator) -> ValidatorPB:
    return ValidatorPB(address=v.address, power=v.power)


def _val_from_pb(p: ValidatorPB | None) -> T.Validator:
    if p is None:
        return T.Validator()
    return T.Validator(address=p.address or b"", power=p.power or 0)


def _vu_to_pb(u: T.ValidatorUpdate) -> ValidatorUpdatePB:
    pk = PublicKey(**{u.pub_key_type: u.pub_key_bytes})
    return ValidatorUpdatePB(pub_key=pk, power=u.power)


def _vu_from_pb(p: ValidatorUpdatePB) -> T.ValidatorUpdate:
    pk = p.pub_key or PublicKey()
    for kind in ("ed25519", "secp256k1", "sr25519"):
        data = getattr(pk, kind, None)
        if data:
            return T.ValidatorUpdate(pub_key_type=kind, pub_key_bytes=data, power=p.power or 0)
    return T.ValidatorUpdate(pub_key_bytes=b"", power=p.power or 0)


def _commit_info_to_pb(ci: T.CommitInfo) -> CommitInfoPB:
    return CommitInfoPB(
        round=ci.round,
        votes=[
            VoteInfoPB(validator=_val_to_pb(v.validator), signed_last_block=v.signed_last_block)
            for v in ci.votes
        ],
    )


def _commit_info_from_pb(p: CommitInfoPB | None) -> T.CommitInfo:
    if p is None:
        return T.CommitInfo()
    return T.CommitInfo(
        round=p.round or 0,
        votes=[
            T.VoteInfo(validator=_val_from_pb(v.validator), signed_last_block=bool(v.signed_last_block))
            for v in (p.votes or [])
        ],
    )


def _ext_commit_info_to_pb(ci: T.ExtendedCommitInfo) -> ExtendedCommitInfoPB:
    return ExtendedCommitInfoPB(
        round=ci.round,
        votes=[
            ExtendedVoteInfoPB(
                validator=_val_to_pb(v.validator),
                signed_last_block=v.signed_last_block,
                vote_extension=v.vote_extension,
            )
            for v in ci.votes
        ],
    )


def _ext_commit_info_from_pb(p: ExtendedCommitInfoPB | None) -> T.ExtendedCommitInfo:
    if p is None:
        return T.ExtendedCommitInfo()
    return T.ExtendedCommitInfo(
        round=p.round or 0,
        votes=[
            T.ExtendedVoteInfo(
                validator=_val_from_pb(v.validator),
                signed_last_block=bool(v.signed_last_block),
                vote_extension=v.vote_extension or b"",
            )
            for v in (p.votes or [])
        ],
    )


def _misb_to_pb(m: T.Misbehavior) -> MisbehaviorPB:
    return MisbehaviorPB(
        type=m.type,
        validator=_val_to_pb(m.validator),
        height=m.height,
        time=_ts(m.time_ns),
        total_voting_power=m.total_voting_power,
    )


def _misb_from_pb(p: MisbehaviorPB) -> T.Misbehavior:
    return T.Misbehavior(
        type=p.type or 0,
        validator=_val_from_pb(p.validator),
        height=p.height or 0,
        time_ns=_ts_ns(p.time),
        total_voting_power=p.total_voting_power or 0,
    )


def _event_to_pb(e: T.Event) -> EventPB:
    return EventPB(
        type=e.type,
        attributes=[
            EventAttributePB(key=a.key, value=a.value, index=a.index) for a in e.attributes
        ],
    )


def _event_from_pb(p: EventPB) -> T.Event:
    return T.Event(
        type=p.type or "",
        attributes=[
            T.EventAttribute(key=a.key or "", value=a.value or "", index=bool(a.index))
            for a in (p.attributes or [])
        ],
    )


def _txres_to_pb(r: T.ExecTxResult) -> ExecTxResultPB:
    return ExecTxResultPB(
        code=r.code,
        data=r.data,
        log=r.log,
        info=r.info,
        gas_wanted=r.gas_wanted,
        gas_used=r.gas_used,
        events=[_event_to_pb(e) for e in r.events],
        codespace=r.codespace,
    )


def _txres_from_pb(p: ExecTxResultPB) -> T.ExecTxResult:
    return T.ExecTxResult(
        code=p.code or 0,
        data=p.data or b"",
        log=p.log or "",
        info=p.info or "",
        gas_wanted=p.gas_wanted or 0,
        gas_used=p.gas_used or 0,
        events=[_event_from_pb(e) for e in (p.events or [])],
        codespace=p.codespace or "",
    )


def _snapshot_to_pb(s: T.Snapshot) -> SnapshotPB:
    return SnapshotPB(height=s.height, format=s.format, chunks=s.chunks, hash=s.hash, metadata=s.metadata)


def _snapshot_from_pb(p: SnapshotPB | None) -> T.Snapshot:
    if p is None:
        return T.Snapshot()
    return T.Snapshot(
        height=p.height or 0,
        format=p.format or 0,
        chunks=p.chunks or 0,
        hash=p.hash or b"",
        metadata=p.metadata or b"",
    )


# method name -> (dataclass -> RequestPB kwargs) and inverse
def request_to_pb(method: str, req) -> RequestPB:
    if method == "echo":
        return RequestPB(echo=RequestEchoPB(message=req))
    if method == "flush":
        return RequestPB(flush=RequestFlushPB())
    if method == "info":
        return RequestPB(info=RequestInfoPB(
            version=req.version, block_version=req.block_version,
            p2p_version=req.p2p_version, abci_version=req.abci_version))
    if method == "init_chain":
        return RequestPB(init_chain=RequestInitChainPB(
            time=_ts(req.time_ns), chain_id=req.chain_id,
            consensus_params=_params_pb(req.consensus_params),
            validators=[_vu_to_pb(v) for v in req.validators],
            app_state_bytes=req.app_state_bytes, initial_height=req.initial_height))
    if method == "query":
        return RequestPB(query=RequestQueryPB(
            data=req.data, path=req.path, height=req.height, prove=req.prove))
    if method == "check_tx":
        return RequestPB(check_tx=RequestCheckTxPB(tx=req.tx, type=req.type))
    if method == "commit":
        return RequestPB(commit=RequestCommitPB())
    if method == "list_snapshots":
        return RequestPB(list_snapshots=RequestListSnapshotsPB())
    if method == "offer_snapshot":
        return RequestPB(offer_snapshot=RequestOfferSnapshotPB(
            snapshot=_snapshot_to_pb(req.snapshot), app_hash=req.app_hash))
    if method == "load_snapshot_chunk":
        return RequestPB(load_snapshot_chunk=RequestLoadSnapshotChunkPB(
            height=req.height, format=req.format, chunk=req.chunk))
    if method == "apply_snapshot_chunk":
        return RequestPB(apply_snapshot_chunk=RequestApplySnapshotChunkPB(
            index=req.index, chunk=req.chunk, sender=req.sender))
    if method == "prepare_proposal":
        return RequestPB(prepare_proposal=RequestPrepareProposalPB(
            max_tx_bytes=req.max_tx_bytes, txs=list(req.txs),
            local_last_commit=_ext_commit_info_to_pb(req.local_last_commit),
            misbehavior=[_misb_to_pb(m) for m in req.misbehavior],
            height=req.height, time=_ts(req.time_ns),
            next_validators_hash=req.next_validators_hash,
            proposer_address=req.proposer_address))
    if method == "process_proposal":
        return RequestPB(process_proposal=RequestProcessProposalPB(
            txs=list(req.txs), proposed_last_commit=_commit_info_to_pb(req.proposed_last_commit),
            misbehavior=[_misb_to_pb(m) for m in req.misbehavior],
            hash=req.hash, height=req.height, time=_ts(req.time_ns),
            next_validators_hash=req.next_validators_hash,
            proposer_address=req.proposer_address))
    if method == "extend_vote":
        return RequestPB(extend_vote=RequestExtendVotePB(hash=req.hash, height=req.height))
    if method == "verify_vote_extension":
        return RequestPB(verify_vote_extension=RequestVerifyVoteExtensionPB(
            hash=req.hash, validator_address=req.validator_address,
            height=req.height, vote_extension=req.vote_extension))
    if method == "finalize_block":
        return RequestPB(finalize_block=RequestFinalizeBlockPB(
            txs=list(req.txs), decided_last_commit=_commit_info_to_pb(req.decided_last_commit),
            misbehavior=[_misb_to_pb(m) for m in req.misbehavior],
            hash=req.hash, height=req.height, time=_ts(req.time_ns),
            next_validators_hash=req.next_validators_hash,
            proposer_address=req.proposer_address))
    raise ValueError(f"unknown ABCI method {method!r}")


def request_from_pb(pb: RequestPB) -> tuple[str, object]:
    """RequestPB -> (method name, dataclass request)."""
    kind = pb.which()
    if kind == "echo":
        return "echo", pb.echo.message or ""
    if kind == "flush":
        return "flush", None
    if kind == "info":
        p = pb.info
        return "info", T.RequestInfo(
            version=p.version or "", block_version=p.block_version or 0,
            p2p_version=p.p2p_version or 0, abci_version=p.abci_version or "")
    if kind == "init_chain":
        p = pb.init_chain
        return "init_chain", T.RequestInitChain(
            time_ns=_ts_ns(p.time), chain_id=p.chain_id or "",
            consensus_params=p.consensus_params,
            validators=[_vu_from_pb(v) for v in (p.validators or [])],
            app_state_bytes=p.app_state_bytes or b"",
            initial_height=p.initial_height or 0)
    if kind == "query":
        p = pb.query
        return "query", T.RequestQuery(
            data=p.data or b"", path=p.path or "", height=p.height or 0, prove=bool(p.prove))
    if kind == "check_tx":
        p = pb.check_tx
        return "check_tx", T.RequestCheckTx(tx=p.tx or b"", type=p.type or 0)
    if kind == "commit":
        return "commit", None
    if kind == "list_snapshots":
        return "list_snapshots", T.RequestListSnapshots()
    if kind == "offer_snapshot":
        p = pb.offer_snapshot
        return "offer_snapshot", T.RequestOfferSnapshot(
            snapshot=_snapshot_from_pb(p.snapshot), app_hash=p.app_hash or b"")
    if kind == "load_snapshot_chunk":
        p = pb.load_snapshot_chunk
        return "load_snapshot_chunk", T.RequestLoadSnapshotChunk(
            height=p.height or 0, format=p.format or 0, chunk=p.chunk or 0)
    if kind == "apply_snapshot_chunk":
        p = pb.apply_snapshot_chunk
        return "apply_snapshot_chunk", T.RequestApplySnapshotChunk(
            index=p.index or 0, chunk=p.chunk or b"", sender=p.sender or "")
    if kind == "prepare_proposal":
        p = pb.prepare_proposal
        return "prepare_proposal", T.RequestPrepareProposal(
            max_tx_bytes=p.max_tx_bytes or 0, txs=list(p.txs or []),
            local_last_commit=_ext_commit_info_from_pb(p.local_last_commit),
            misbehavior=[_misb_from_pb(m) for m in (p.misbehavior or [])],
            height=p.height or 0, time_ns=_ts_ns(p.time),
            next_validators_hash=p.next_validators_hash or b"",
            proposer_address=p.proposer_address or b"")
    if kind == "process_proposal":
        p = pb.process_proposal
        return "process_proposal", T.RequestProcessProposal(
            txs=list(p.txs or []), proposed_last_commit=_commit_info_from_pb(p.proposed_last_commit),
            misbehavior=[_misb_from_pb(m) for m in (p.misbehavior or [])],
            hash=p.hash or b"", height=p.height or 0, time_ns=_ts_ns(p.time),
            next_validators_hash=p.next_validators_hash or b"",
            proposer_address=p.proposer_address or b"")
    if kind == "extend_vote":
        p = pb.extend_vote
        return "extend_vote", T.RequestExtendVote(hash=p.hash or b"", height=p.height or 0)
    if kind == "verify_vote_extension":
        p = pb.verify_vote_extension
        return "verify_vote_extension", T.RequestVerifyVoteExtension(
            hash=p.hash or b"", validator_address=p.validator_address or b"",
            height=p.height or 0, vote_extension=p.vote_extension or b"")
    if kind == "finalize_block":
        p = pb.finalize_block
        return "finalize_block", T.RequestFinalizeBlock(
            txs=list(p.txs or []), decided_last_commit=_commit_info_from_pb(p.decided_last_commit),
            misbehavior=[_misb_from_pb(m) for m in (p.misbehavior or [])],
            hash=p.hash or b"", height=p.height or 0, time_ns=_ts_ns(p.time),
            next_validators_hash=p.next_validators_hash or b"",
            proposer_address=p.proposer_address or b"")
    raise ValueError(f"empty or unknown request oneof: {kind}")


def response_to_pb(method: str, res) -> ResponsePB:
    if method == "exception":
        return ResponsePB(exception=ResponseExceptionPB(error=str(res)))
    if method == "echo":
        return ResponsePB(echo=ResponseEchoPB(message=res))
    if method == "flush":
        return ResponsePB(flush=ResponseFlushPB())
    if method == "info":
        return ResponsePB(info=ResponseInfoPB(
            data=res.data, version=res.version, app_version=res.app_version,
            last_block_height=res.last_block_height,
            last_block_app_hash=res.last_block_app_hash))
    if method == "init_chain":
        return ResponsePB(init_chain=ResponseInitChainPB(
            consensus_params=_params_pb(res.consensus_params),
            validators=[_vu_to_pb(v) for v in res.validators],
            app_hash=res.app_hash))
    if method == "query":
        return ResponsePB(query=ResponseQueryPB(
            code=res.code, log=res.log, info=res.info, index=res.index,
            key=res.key, value=res.value, height=res.height, codespace=res.codespace))
    if method == "check_tx":
        return ResponsePB(check_tx=ResponseCheckTxPB(
            code=res.code, data=res.data, gas_wanted=res.gas_wanted,
            codespace=res.codespace, sender=res.sender, priority=res.priority))
    if method == "commit":
        return ResponsePB(commit=ResponseCommitPB(retain_height=res.retain_height))
    if method == "list_snapshots":
        return ResponsePB(list_snapshots=ResponseListSnapshotsPB(
            snapshots=[_snapshot_to_pb(s) for s in res.snapshots]))
    if method == "offer_snapshot":
        return ResponsePB(offer_snapshot=ResponseOfferSnapshotPB(result=res.result))
    if method == "load_snapshot_chunk":
        return ResponsePB(load_snapshot_chunk=ResponseLoadSnapshotChunkPB(chunk=res.chunk))
    if method == "apply_snapshot_chunk":
        return ResponsePB(apply_snapshot_chunk=ResponseApplySnapshotChunkPB(
            result=res.result, refetch_chunks=list(res.refetch_chunks),
            reject_senders=list(res.reject_senders)))
    if method == "prepare_proposal":
        return ResponsePB(prepare_proposal=ResponsePrepareProposalPB(
            tx_records=[TxRecordPB(action=TXRECORD_UNMODIFIED, tx=tx) for tx in res.txs]))
    if method == "process_proposal":
        return ResponsePB(process_proposal=ResponseProcessProposalPB(status=res.status))
    if method == "extend_vote":
        return ResponsePB(extend_vote=ResponseExtendVotePB(vote_extension=res.vote_extension))
    if method == "verify_vote_extension":
        return ResponsePB(verify_vote_extension=ResponseVerifyVoteExtensionPB(status=res.status))
    if method == "finalize_block":
        return ResponsePB(finalize_block=ResponseFinalizeBlockPB(
            events=[_event_to_pb(e) for e in res.events],
            tx_results=[_txres_to_pb(r) for r in res.tx_results],
            validator_updates=[_vu_to_pb(v) for v in res.validator_updates],
            consensus_param_updates=_params_pb(res.consensus_param_updates),
            app_hash=res.app_hash))
    raise ValueError(f"unknown ABCI method {method!r}")


class ABCIRemoteError(Exception):
    """The remote app returned ResponseException."""


def response_from_pb(pb: ResponsePB):
    """ResponsePB -> (method, dataclass response). Raises on exception."""
    kind = pb.which()
    if kind == "exception":
        raise ABCIRemoteError(pb.exception.error or "remote ABCI exception")
    if kind == "echo":
        return kind, pb.echo.message or ""
    if kind == "flush":
        return kind, None
    if kind == "info":
        p = pb.info
        return kind, T.ResponseInfo(
            data=p.data or "", version=p.version or "", app_version=p.app_version or 0,
            last_block_height=p.last_block_height or 0,
            last_block_app_hash=p.last_block_app_hash or b"")
    if kind == "init_chain":
        p = pb.init_chain
        return kind, T.ResponseInitChain(
            consensus_params=p.consensus_params,
            validators=[_vu_from_pb(v) for v in (p.validators or [])],
            app_hash=p.app_hash or b"")
    if kind == "query":
        p = pb.query
        return kind, T.ResponseQuery(
            code=p.code or 0, log=p.log or "", info=p.info or "", index=p.index or 0,
            key=p.key or b"", value=p.value or b"", height=p.height or 0,
            codespace=p.codespace or "")
    if kind == "check_tx":
        p = pb.check_tx
        return kind, T.ResponseCheckTx(
            code=p.code or 0, data=p.data or b"", gas_wanted=p.gas_wanted or 0,
            codespace=p.codespace or "", sender=p.sender or "", priority=p.priority or 0)
    if kind == "commit":
        return kind, T.ResponseCommit(retain_height=pb.commit.retain_height or 0)
    if kind == "list_snapshots":
        return kind, T.ResponseListSnapshots(
            snapshots=[_snapshot_from_pb(s) for s in (pb.list_snapshots.snapshots or [])])
    if kind == "offer_snapshot":
        return kind, T.ResponseOfferSnapshot(result=pb.offer_snapshot.result or 0)
    if kind == "load_snapshot_chunk":
        return kind, T.ResponseLoadSnapshotChunk(chunk=pb.load_snapshot_chunk.chunk or b"")
    if kind == "apply_snapshot_chunk":
        p = pb.apply_snapshot_chunk
        return kind, T.ResponseApplySnapshotChunk(
            result=p.result or 0, refetch_chunks=list(p.refetch_chunks or []),
            reject_senders=list(p.reject_senders or []))
    if kind == "prepare_proposal":
        p = pb.prepare_proposal
        return kind, T.ResponsePrepareProposal(
            txs=[r.tx or b"" for r in (p.tx_records or [])
                 if (r.action or 0) in (TXRECORD_UNKNOWN, TXRECORD_UNMODIFIED, TXRECORD_ADDED)])
    if kind == "process_proposal":
        return kind, T.ResponseProcessProposal(status=pb.process_proposal.status or 0)
    if kind == "extend_vote":
        return kind, T.ResponseExtendVote(vote_extension=pb.extend_vote.vote_extension or b"")
    if kind == "verify_vote_extension":
        return kind, T.ResponseVerifyVoteExtension(status=pb.verify_vote_extension.status or 0)
    if kind == "finalize_block":
        p = pb.finalize_block
        return kind, T.ResponseFinalizeBlock(
            events=[_event_from_pb(e) for e in (p.events or [])],
            tx_results=[_txres_from_pb(r) for r in (p.tx_results or [])],
            validator_updates=[_vu_from_pb(v) for v in (p.validator_updates or [])],
            consensus_param_updates=p.consensus_param_updates,
            app_hash=p.app_hash or b"")
    raise ValueError(f"empty or unknown response oneof: {kind}")


# ---------------------------------------------------- CheckTx fast path
#
# CheckTx is the one ABCI message a tx flood sends tens of thousands of
# times per second; the generic reflection-driven Message codec above
# costs ~25us per encode/decode of even this 2-field message, which
# dominates the pipelined socket transport's per-tx budget. These
# hand-rolled encoders/decoders emit the exact same bytes (same field
# numbers, same varint wire types) and are used by both the socket
# client and server whenever the frame IS a CheckTx; anything else
# falls back to the generic path. Round-trip equality with the generic
# codec is pinned by tests/test_abci_socket.py.

from ..utils.varint import encode_uvarint as _fp_uvarint  # noqa: E402
from ..utils.varint import read_uvarint as _fp_read_uvarint  # noqa: E402

_CHECK_TX_REQ_TAG = 0x3A   # RequestPB field 7, wire type 2
_CHECK_TX_RESP_TAG = 0x42  # ResponsePB field 8, wire type 2


def _fp_i64(v: int) -> int:
    """Interpret an unsigned varint as a signed int64."""
    return v - (1 << 64) if v >= (1 << 63) else v


def encode_check_tx_request(req) -> bytes:
    """RequestPB(check_tx=...).encode(), hand-rolled (proto3 default
    skipping: empty tx / zero type are omitted, like the generic
    encoder)."""
    inner = b""
    if req.tx:
        inner = b"\x0a" + _fp_uvarint(len(req.tx)) + req.tx
    if req.type:
        inner += b"\x10" + _fp_uvarint(req.type)
    return b"\x3a" + _fp_uvarint(len(inner)) + inner


def encode_check_tx_response(res) -> bytes:
    """ResponsePB(check_tx=...).encode(), hand-rolled (the proto3
    default-skipping rules the generic encoder applies: zero/empty
    fields are omitted)."""
    inner = b""
    if res.code:
        inner += b"\x08" + _fp_uvarint(res.code)
    if res.data:
        inner += b"\x12" + _fp_uvarint(len(res.data)) + res.data
    if res.gas_wanted:
        inner += b"\x28" + _fp_uvarint(res.gas_wanted & 0xFFFFFFFFFFFFFFFF)
    if res.codespace:
        b = res.codespace.encode()
        inner += b"\x42" + _fp_uvarint(len(b)) + b
    if res.sender:
        b = res.sender.encode()
        inner += b"\x4a" + _fp_uvarint(len(b)) + b
    if res.priority:
        inner += b"\x50" + _fp_uvarint(res.priority & 0xFFFFFFFFFFFFFFFF)
    return b"\x42" + _fp_uvarint(len(inner)) + inner


def try_decode_check_tx_request(body: bytes):
    """body -> RequestCheckTx, or None when the frame is not a plain
    CheckTx request (caller falls back to the generic decoder)."""
    if not body or body[0] != _CHECK_TX_REQ_TAG:
        return None
    try:
        size, pos = _fp_read_uvarint(body, 1)
        if pos + size != len(body):
            return None  # trailing fields: not a pure check_tx oneof
        end = pos + size
        tx = b""
        typ = 0
        while pos < end:
            tag = body[pos]
            pos += 1
            if tag == 0x0A:
                ln, pos = _fp_read_uvarint(body, pos)
                if pos + ln > end:
                    return None  # truncated field: let the generic decoder raise
                tx = body[pos : pos + ln]
                pos += ln
            elif tag == 0x10:
                typ, pos = _fp_read_uvarint(body, pos)
            else:
                return None
        if pos != end:
            return None
        return T.RequestCheckTx(tx=tx, type=typ)
    except (IndexError, ValueError):
        return None


def try_decode_check_tx_response(body: bytes):
    """body -> ResponseCheckTx, or None when the frame is not a plain
    CheckTx response (exception frames and every other oneof arm fall
    back to the generic decoder, which raises ABCIRemoteError etc.)."""
    if not body or body[0] != _CHECK_TX_RESP_TAG:
        return None
    try:
        size, pos = _fp_read_uvarint(body, 1)
        if pos + size != len(body):
            return None
        end = pos + size
        code = gas_wanted = priority = 0
        data = b""
        codespace = sender = ""
        while pos < end:
            tag = body[pos]
            pos += 1
            if tag == 0x08:
                code, pos = _fp_read_uvarint(body, pos)
            elif tag == 0x12:
                ln, pos = _fp_read_uvarint(body, pos)
                if pos + ln > end:
                    return None  # truncated field: let the generic decoder raise
                data = body[pos : pos + ln]
                pos += ln
            elif tag == 0x28:
                v, pos = _fp_read_uvarint(body, pos)
                gas_wanted = _fp_i64(v)
            elif tag == 0x42:
                ln, pos = _fp_read_uvarint(body, pos)
                if pos + ln > end:
                    return None
                codespace = body[pos : pos + ln].decode()
                pos += ln
            elif tag == 0x4A:
                ln, pos = _fp_read_uvarint(body, pos)
                if pos + ln > end:
                    return None
                sender = body[pos : pos + ln].decode()
                pos += ln
            elif tag == 0x50:
                v, pos = _fp_read_uvarint(body, pos)
                priority = _fp_i64(v)
            else:
                return None
        if pos != end:
            return None
        return T.ResponseCheckTx(
            code=code, data=data, gas_wanted=gas_wanted,
            codespace=codespace, sender=sender, priority=priority,
        )
    except (IndexError, ValueError):
        return None
