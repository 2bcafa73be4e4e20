"""Wire message schemas for canonical vote sign bytes and commit hashing (ref:
proto/tendermint/types/types.proto, canonical.proto).

Field numbers and nullability mirror the reference schemas exactly; the
encodings are byte-identical.
"""

from __future__ import annotations

from .message import Field, Message

SIGNED_MSG_TYPE_UNKNOWN = 0
SIGNED_MSG_TYPE_PREVOTE = 1
SIGNED_MSG_TYPE_PRECOMMIT = 2
SIGNED_MSG_TYPE_PROPOSAL = 32

BLOCK_ID_FLAG_UNKNOWN = 0
BLOCK_ID_FLAG_ABSENT = 1
BLOCK_ID_FLAG_COMMIT = 2
BLOCK_ID_FLAG_NIL = 3


class Timestamp(Message):
    """google.protobuf.Timestamp."""

    fields = [
        Field(1, "int64", "seconds"),
        Field(2, "int32", "nanos"),
    ]


class PartSetHeader(Message):
    fields = [
        Field(1, "uint32", "total"),
        Field(2, "bytes", "hash"),
    ]


class BlockID(Message):
    fields = [
        Field(1, "bytes", "hash"),
        Field(2, "message", "part_set_header", always_emit=True, msg_cls=PartSetHeader),
    ]


class Vote(Message):
    fields = [
        Field(1, "enum", "type"),
        Field(2, "int64", "height"),
        Field(3, "int32", "round"),
        Field(4, "message", "block_id", always_emit=True, msg_cls=BlockID),
        Field(5, "message", "timestamp", always_emit=True, msg_cls=Timestamp),
        Field(6, "bytes", "validator_address"),
        Field(7, "int32", "validator_index"),
        Field(8, "bytes", "signature"),
        Field(9, "bytes", "extension"),
        Field(10, "bytes", "extension_signature"),
    ]


class CommitSig(Message):
    fields = [
        Field(1, "enum", "block_id_flag"),
        Field(2, "bytes", "validator_address"),
        Field(3, "message", "timestamp", always_emit=True, msg_cls=Timestamp),
        Field(4, "bytes", "signature"),
    ]


class CanonicalPartSetHeader(Message):
    fields = [
        Field(1, "uint32", "total"),
        Field(2, "bytes", "hash"),
    ]


class CanonicalBlockID(Message):
    fields = [
        Field(1, "bytes", "hash"),
        Field(2, "message", "part_set_header", always_emit=True, msg_cls=CanonicalPartSetHeader),
    ]


class CanonicalVote(Message):
    fields = [
        Field(1, "enum", "type"),
        Field(2, "sfixed64", "height"),
        Field(3, "sfixed64", "round"),
        Field(4, "message", "block_id", msg_cls=CanonicalBlockID),  # nullable
        Field(5, "message", "timestamp", always_emit=True, msg_cls=Timestamp),
        Field(6, "string", "chain_id"),
    ]
