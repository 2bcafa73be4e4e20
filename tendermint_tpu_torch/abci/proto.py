"""ABCI wire messages + dataclass converters (ref: proto/tendermint/abci/types.proto).

A trimmed copy of the JAX package's abci/proto.py: the indexing record
(`TxResultPB`, types.proto:385) with the execution result and events it
carries, and their encoders, as the SQL event sinks store them
(indexer/sink_sql.py, indexer/sink_psql.py). Field numbers are the
reference's. The rest of the module, the socket and gRPC transports'
request and response messages, comes with the remote app clients (ROADMAP
A15b).
"""

from __future__ import annotations

from ..proto.message import Field, Message
from . import types as T


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


def _event_to_pb(e: T.Event) -> EventPB:
    return EventPB(
        type=e.type,
        attributes=[
            EventAttributePB(key=a.key, value=a.value, index=a.index) for a in e.attributes
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

