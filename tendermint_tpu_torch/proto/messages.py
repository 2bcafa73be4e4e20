"""Wire message schemas for canonical vote and vote-extension sign bytes,
commit and header hashing, votes, extended commits, validator sets, light
blocks and evidence (ref: proto/tendermint/types/types.proto,
canonical.proto, validator.proto, evidence.proto,
proto/tendermint/crypto/keys.proto, proof.proto,
proto/tendermint/version/types.proto).

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


class Consensus(Message):
    """tendermint.version.Consensus (proto/tendermint/version/types.proto)."""

    fields = [
        Field(1, "uint64", "block"),
        Field(2, "uint64", "app"),
    ]


class Proof(Message):
    fields = [
        Field(1, "int64", "total"),
        Field(2, "int64", "index"),
        Field(3, "bytes", "leaf_hash"),
        Field(4, "bytes", "aunts", repeated=True),
    ]


class PublicKey(Message):
    """tendermint.crypto.PublicKey: oneof {ed25519, secp256k1, sr25519}."""

    fields = [
        Field(1, "bytes", "ed25519"),
        Field(2, "bytes", "secp256k1"),
        Field(3, "bytes", "sr25519"),
    ]

    def __init__(self, **kwargs):
        self.ed25519 = kwargs.pop("ed25519", None)
        self.secp256k1 = kwargs.pop("secp256k1", None)
        self.sr25519 = kwargs.pop("sr25519", None)
        if kwargs:
            raise TypeError(f"PublicKey: unknown fields {sorted(kwargs)}")

    def encode(self) -> bytes:
        from . import wire

        # oneof: emit whichever arm is set, even if empty bytes.
        for num, name in ((1, "ed25519"), (2, "secp256k1"), (3, "sr25519")):
            v = getattr(self, name)
            if v is not None:
                return wire.encode_tag(num, wire.WIRE_BYTES) + wire.encode_bytes(bytes(v))
        return b""

    @classmethod
    def decode(cls, buf: bytes):
        from . import wire

        msg = cls()
        pos = 0
        while pos < len(buf):
            num, wt, pos = wire.decode_tag(buf, pos)
            if wt != wire.WIRE_BYTES:
                raise ValueError("PublicKey: bad wire type")
            val, pos = wire.decode_bytes(buf, pos)
            if num == 1:
                msg.ed25519 = val
            elif num == 2:
                msg.secp256k1 = val
            elif num == 3:
                msg.sr25519 = val
        return msg

    @property
    def sum(self):
        for name in ("ed25519", "secp256k1", "sr25519"):
            v = getattr(self, name)
            if v is not None:
                return name, v
        return None, None


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


class Header(Message):
    fields = [
        Field(1, "message", "version", always_emit=True, msg_cls=Consensus),
        Field(2, "string", "chain_id"),
        Field(3, "int64", "height"),
        Field(4, "message", "time", always_emit=True, msg_cls=Timestamp),
        Field(5, "message", "last_block_id", always_emit=True, msg_cls=BlockID),
        Field(6, "bytes", "last_commit_hash"),
        Field(7, "bytes", "data_hash"),
        Field(8, "bytes", "validators_hash"),
        Field(9, "bytes", "next_validators_hash"),
        Field(10, "bytes", "consensus_hash"),
        Field(11, "bytes", "app_hash"),
        Field(12, "bytes", "last_results_hash"),
        Field(13, "bytes", "evidence_hash"),
        Field(14, "bytes", "proposer_address"),
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


class Commit(Message):
    fields = [
        Field(1, "int64", "height"),
        Field(2, "int32", "round"),
        Field(3, "message", "block_id", always_emit=True, msg_cls=BlockID),
        Field(4, "message", "signatures", repeated=True, msg_cls=CommitSig),
    ]


class ExtendedCommitSig(Message):
    """CommitSig with its vote extension (types.proto:155-165)."""

    fields = [
        Field(1, "enum", "block_id_flag"),
        Field(2, "bytes", "validator_address"),
        Field(3, "message", "timestamp", always_emit=True, msg_cls=Timestamp),
        Field(4, "bytes", "signature"),
        Field(5, "bytes", "extension"),
        Field(6, "bytes", "extension_signature"),
    ]


class ExtendedCommit(Message):
    """Commit whose signatures keep their vote extensions (types.proto:145-151)."""

    fields = [
        Field(1, "int64", "height"),
        Field(2, "int32", "round"),
        Field(3, "message", "block_id", always_emit=True, msg_cls=BlockID),
        Field(4, "message", "extended_signatures", repeated=True, msg_cls=ExtendedCommitSig),
    ]


class Validator(Message):
    fields = [
        Field(1, "bytes", "address"),
        Field(2, "message", "pub_key", always_emit=True, msg_cls=PublicKey),
        Field(3, "int64", "voting_power"),
        Field(4, "int64", "proposer_priority"),
    ]


class ValidatorSet(Message):
    fields = [
        Field(1, "message", "validators", repeated=True, msg_cls=Validator),
        Field(2, "message", "proposer", msg_cls=Validator),
        Field(3, "int64", "total_voting_power"),
    ]


class SimpleValidator(Message):
    fields = [
        Field(1, "message", "pub_key", msg_cls=PublicKey),
        Field(2, "int64", "voting_power"),
    ]


class SignedHeader(Message):
    fields = [
        Field(1, "message", "header", msg_cls=Header),
        Field(2, "message", "commit", msg_cls=Commit),
    ]


class LightBlock(Message):
    fields = [
        Field(1, "message", "signed_header", msg_cls=SignedHeader),
        Field(2, "message", "validator_set", msg_cls=ValidatorSet),
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


class CanonicalVoteExtension(Message):
    fields = [
        Field(1, "bytes", "extension"),
        Field(2, "sfixed64", "height"),
        Field(3, "sfixed64", "round"),
        Field(4, "string", "chain_id"),
    ]


# -- evidence (proto/tendermint/types/evidence.proto) ---------------------


class DuplicateVoteEvidence(Message):
    fields = [
        Field(1, "message", "vote_a", msg_cls=Vote),
        Field(2, "message", "vote_b", msg_cls=Vote),
        Field(3, "int64", "total_voting_power"),
        Field(4, "int64", "validator_power"),
        Field(5, "message", "timestamp", always_emit=True, msg_cls=Timestamp),
    ]


class LightClientAttackEvidence(Message):
    fields = [
        Field(1, "message", "conflicting_block", msg_cls=LightBlock),
        Field(2, "int64", "common_height"),
        Field(3, "message", "byzantine_validators", repeated=True, msg_cls=Validator),
        Field(4, "int64", "total_voting_power"),
        Field(5, "message", "timestamp", always_emit=True, msg_cls=Timestamp),
    ]


class Evidence(Message):
    """oneof sum {DuplicateVoteEvidence, LightClientAttackEvidence}."""

    fields = [
        Field(1, "message", "duplicate_vote_evidence", msg_cls=DuplicateVoteEvidence),
        Field(2, "message", "light_client_attack_evidence", msg_cls=LightClientAttackEvidence),
    ]


class EvidenceList(Message):
    fields = [Field(1, "message", "evidence", repeated=True, msg_cls=Evidence)]
