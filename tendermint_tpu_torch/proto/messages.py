"""Wire message schemas for canonical vote and vote-extension sign bytes,
commit and header hashing, votes, extended commits, validator sets, light
blocks, evidence, blocks and their parts, block metas and consensus params
(ref: proto/tendermint/types/types.proto, canonical.proto, validator.proto,
evidence.proto, block.proto, params.proto,
proto/tendermint/crypto/keys.proto, proof.proto,
proto/tendermint/version/types.proto), the p2p layer's NodeInfo, PEX and
secret-connection messages (proto/tendermint/p2p/types.proto, pex.proto,
conn.proto), the bit arrays (proto/tendermint/libs/bits/types.proto), the
consensus reactor's messages (proto/tendermint/consensus/types.proto),
blocksync's (proto/tendermint/blocksync/types.proto) and state sync's
(proto/tendermint/statesync/types.proto).

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


class Part(Message):
    fields = [
        Field(1, "uint32", "index"),
        Field(2, "bytes", "bytes_"),
        Field(3, "message", "proof", always_emit=True, msg_cls=Proof),
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


class Data(Message):
    fields = [Field(1, "bytes", "txs", repeated=True)]


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


class Proposal(Message):
    fields = [
        Field(1, "enum", "type"),
        Field(2, "int64", "height"),
        Field(3, "int32", "round"),
        Field(4, "int32", "pol_round"),
        Field(5, "message", "block_id", always_emit=True, msg_cls=BlockID),
        Field(6, "message", "timestamp", always_emit=True, msg_cls=Timestamp),
        Field(7, "bytes", "signature"),
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


class BlockMeta(Message):
    fields = [
        Field(1, "message", "block_id", always_emit=True, msg_cls=BlockID),
        Field(2, "int64", "block_size"),
        Field(3, "message", "header", always_emit=True, msg_cls=Header),
        Field(4, "int64", "num_txs"),
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


class CanonicalProposal(Message):
    fields = [
        Field(1, "enum", "type"),
        Field(2, "sfixed64", "height"),
        Field(3, "sfixed64", "round"),
        Field(4, "int64", "pol_round"),
        Field(5, "message", "block_id", msg_cls=CanonicalBlockID),  # nullable
        Field(6, "message", "timestamp", always_emit=True, msg_cls=Timestamp),
        Field(7, "string", "chain_id"),
    ]


class CanonicalVoteExtension(Message):
    fields = [
        Field(1, "bytes", "extension"),
        Field(2, "sfixed64", "height"),
        Field(3, "sfixed64", "round"),
        Field(4, "string", "chain_id"),
    ]


# -- consensus params (proto/tendermint/types/params.proto) ---------------


class HashedParams(Message):
    """The subset of the params folded into Header.ConsensusHash."""

    fields = [
        Field(1, "int64", "block_max_bytes"),
        Field(2, "int64", "block_max_gas"),
    ]


class Duration(Message):
    """google.protobuf.Duration."""

    fields = [
        Field(1, "int64", "seconds"),
        Field(2, "int32", "nanos"),
    ]

    def to_ns(self) -> int:
        return (self.seconds or 0) * 1_000_000_000 + (self.nanos or 0)

    @classmethod
    def from_ns(cls, ns: int) -> "Duration":
        return cls(seconds=ns // 1_000_000_000, nanos=ns % 1_000_000_000)


class BlockParamsProto(Message):
    fields = [
        Field(1, "int64", "max_bytes"),
        Field(2, "int64", "max_gas"),
    ]


class EvidenceParamsProto(Message):
    fields = [
        Field(1, "int64", "max_age_num_blocks"),
        Field(2, "message", "max_age_duration", msg_cls=Duration),
        Field(3, "int64", "max_bytes"),
    ]


class ValidatorParamsProto(Message):
    fields = [Field(1, "string", "pub_key_types", repeated=True)]


class VersionParamsProto(Message):
    fields = [Field(1, "uint64", "app_version")]


class SynchronyParamsProto(Message):
    """Field numbers per params.proto:78-85: message_delay=1, precision=2."""

    fields = [
        Field(1, "message", "message_delay", msg_cls=Duration),
        Field(2, "message", "precision", msg_cls=Duration),
    ]


class TimeoutParamsProto(Message):
    fields = [
        Field(1, "message", "propose", msg_cls=Duration),
        Field(2, "message", "propose_delta", msg_cls=Duration),
        Field(3, "message", "vote", msg_cls=Duration),
        Field(4, "message", "vote_delta", msg_cls=Duration),
        Field(5, "message", "commit", msg_cls=Duration),
        Field(6, "bool", "bypass_commit_timeout"),
    ]


class ABCIParamsProto(Message):
    fields = [
        Field(1, "int64", "vote_extensions_enable_height"),
        Field(2, "bool", "recheck_tx"),
    ]


class ConsensusParamsUpdate(Message):
    """tendermint.types.ConsensusParams as ABCI carries it: every section
    nullable, only the changed ones set."""

    fields = [
        Field(1, "message", "block", msg_cls=BlockParamsProto),
        Field(2, "message", "evidence", msg_cls=EvidenceParamsProto),
        Field(3, "message", "validator", msg_cls=ValidatorParamsProto),
        Field(4, "message", "version", msg_cls=VersionParamsProto),
        Field(5, "message", "synchrony", msg_cls=SynchronyParamsProto),
        Field(6, "message", "timeout", msg_cls=TimeoutParamsProto),
        Field(7, "message", "abci", msg_cls=ABCIParamsProto),
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


class Block(Message):
    """proto/tendermint/types/block.proto."""

    fields = [
        Field(1, "message", "header", always_emit=True, msg_cls=Header),
        Field(2, "message", "data", always_emit=True, msg_cls=Data),
        Field(3, "message", "evidence", always_emit=True, msg_cls=EvidenceList),
        Field(4, "message", "last_commit", msg_cls=Commit),
    ]


# -- p2p PEX (proto/tendermint/p2p/pex.proto) -----------------------------


class PexAddress(Message):
    fields = [Field(1, "string", "url")]


class PexRequest(Message):
    fields = []


class PexResponse(Message):
    fields = [Field(1, "message", "addresses", repeated=True, msg_cls=PexAddress)]


class PexMessage(Message):
    """oneof sum — field numbers 1,2 reserved (spec PR #352)."""

    fields = [
        Field(3, "message", "pex_request", msg_cls=PexRequest),
        Field(4, "message", "pex_response", msg_cls=PexResponse),
    ]


class AuthSigMessage(Message):
    """Secret-connection authentication (proto/tendermint/p2p/conn.proto
    and duplicated at proto/tendermint/privval/types.proto)."""

    fields = [
        Field(1, "message", "pub_key", always_emit=True, msg_cls=PublicKey),
        Field(2, "bytes", "sig"),
    ]


# -- libs/bits (proto/tendermint/libs/bits/types.proto) --------------------


class BitArrayProto(Message):
    fields = [
        Field(1, "int64", "bits"),
        Field(2, "uint64", "elems", repeated=True),
    ]


# -- consensus wire messages (proto/tendermint/consensus/types.proto) ------


class CsNewRoundStep(Message):
    fields = [
        Field(1, "int64", "height"),
        Field(2, "int32", "round"),
        Field(3, "uint32", "step"),
        Field(4, "int64", "seconds_since_start_time"),
        Field(5, "int32", "last_commit_round"),
    ]


class CsNewValidBlock(Message):
    fields = [
        Field(1, "int64", "height"),
        Field(2, "int32", "round"),
        Field(3, "message", "block_part_set_header", always_emit=True, msg_cls=PartSetHeader),
        Field(4, "message", "block_parts", msg_cls=BitArrayProto),
        Field(5, "bool", "is_commit"),
    ]


class CsProposal(Message):
    fields = [Field(1, "message", "proposal", always_emit=True, msg_cls=Proposal)]


class CsProposalPOL(Message):
    fields = [
        Field(1, "int64", "height"),
        Field(2, "int32", "proposal_pol_round"),
        Field(3, "message", "proposal_pol", always_emit=True, msg_cls=BitArrayProto),
    ]


class CsBlockPart(Message):
    fields = [
        Field(1, "int64", "height"),
        Field(2, "int32", "round"),
        Field(3, "message", "part", always_emit=True, msg_cls=Part),
    ]


class CsVote(Message):
    fields = [Field(1, "message", "vote", msg_cls=Vote)]


class CsHasVote(Message):
    fields = [
        Field(1, "int64", "height"),
        Field(2, "int32", "round"),
        Field(3, "enum", "type"),
        Field(4, "int32", "index"),
    ]


class CsVoteSetMaj23(Message):
    fields = [
        Field(1, "int64", "height"),
        Field(2, "int32", "round"),
        Field(3, "enum", "type"),
        Field(4, "message", "block_id", always_emit=True, msg_cls=BlockID),
    ]


class CsVoteSetBits(Message):
    fields = [
        Field(1, "int64", "height"),
        Field(2, "int32", "round"),
        Field(3, "enum", "type"),
        Field(4, "message", "block_id", always_emit=True, msg_cls=BlockID),
        Field(5, "message", "votes", always_emit=True, msg_cls=BitArrayProto),
    ]


class ConsensusMessage(Message):
    """tendermint.consensus.Message oneof (consensus/types.proto:88-100)."""

    fields = [
        Field(1, "message", "new_round_step", msg_cls=CsNewRoundStep),
        Field(2, "message", "new_valid_block", msg_cls=CsNewValidBlock),
        Field(3, "message", "proposal", msg_cls=CsProposal),
        Field(4, "message", "proposal_pol", msg_cls=CsProposalPOL),
        Field(5, "message", "block_part", msg_cls=CsBlockPart),
        Field(6, "message", "vote", msg_cls=CsVote),
        Field(7, "message", "has_vote", msg_cls=CsHasVote),
        Field(8, "message", "vote_set_maj23", msg_cls=CsVoteSetMaj23),
        Field(9, "message", "vote_set_bits", msg_cls=CsVoteSetBits),
        # Local extensions (no reference analog), field numbers far
        # above the reference oneof (1-9) so proto3 decoders that don't
        # know them skip them, and zero/empty values are omitted from
        # the wire entirely — unstamped frames stay byte-identical to
        # the reference schema.
        #
        # origin_ns: origin wall-clock in unix nanoseconds, stamped at
        # encode time on data-plane frames (proposal / block part /
        # vote) so the receive side can record gossip propagation
        # latency on shared-clock testnets (consensus/reactor.py).
        Field(1000, "fixed64", "origin_ns"),
        # origin_node: the stamping node's p2p id — together with
        # (height, round, msg kind) it forms the deterministic tmpath
        # journey key (trace.journey_key) that lets the lens merge
        # layer bind one frame's send and receive spans across node
        # processes without clock alignment
        Field(1001, "string", "origin_node"),
    ]


# ---------------------------------------------------------------- p2p wire
# ref: proto/tendermint/p2p/types.proto


class ProtocolVersionProto(Message):
    """tendermint.p2p.ProtocolVersion (proto/tendermint/p2p/types.proto:9)."""

    fields = [
        Field(1, "uint64", "p2p"),
        Field(2, "uint64", "block"),
        Field(3, "uint64", "app"),
    ]


class NodeInfoOtherProto(Message):
    fields = [
        Field(1, "string", "tx_index"),
        Field(2, "string", "rpc_address"),
    ]


class NodeInfoProto(Message):
    """tendermint.p2p.NodeInfo (proto/tendermint/p2p/types.proto:15)."""

    fields = [
        Field(1, "message", "protocol_version", always_emit=True, msg_cls=ProtocolVersionProto),
        Field(2, "string", "node_id"),
        Field(3, "string", "listen_addr"),
        Field(4, "string", "network"),
        Field(5, "string", "version"),
        Field(6, "bytes", "channels"),
        Field(7, "string", "moniker"),
        Field(8, "message", "other", always_emit=True, msg_cls=NodeInfoOtherProto),
    ]


# ---------------------------------------------------------- blocksync wire
# ref: proto/tendermint/blocksync/types.proto


class BlocksyncBlockRequest(Message):
    fields = [Field(1, "int64", "height")]


class BlocksyncNoBlockResponse(Message):
    fields = [Field(1, "int64", "height")]


class BlocksyncBlockResponse(Message):
    fields = [
        Field(1, "message", "block", msg_cls=Block),
        # populated for vote-extension heights (blocksync/types.proto:23)
        Field(2, "message", "ext_commit", msg_cls=ExtendedCommit),
    ]


class BlocksyncStatusRequest(Message):
    fields = []


class BlocksyncStatusResponse(Message):
    fields = [Field(1, "int64", "height"), Field(2, "int64", "base")]


class BlocksyncMessage(Message):
    """Message oneof (blocksync/types.proto:34-42)."""

    fields = [
        Field(1, "message", "block_request", msg_cls=BlocksyncBlockRequest),
        Field(2, "message", "no_block_response", msg_cls=BlocksyncNoBlockResponse),
        Field(3, "message", "block_response", msg_cls=BlocksyncBlockResponse),
        Field(4, "message", "status_request", msg_cls=BlocksyncStatusRequest),
        Field(5, "message", "status_response", msg_cls=BlocksyncStatusResponse),
    ]


# ------------------------------------------------------------- statesync wire
# ref: proto/tendermint/statesync/types.proto


class SnapshotsRequestProto(Message):
    fields = []


class SnapshotsResponseProto(Message):
    fields = [
        Field(1, "uint64", "height"),
        Field(2, "uint32", "format"),
        Field(3, "uint32", "chunks"),
        Field(4, "bytes", "hash"),
        Field(5, "bytes", "metadata"),
    ]


class ChunkRequestProto(Message):
    fields = [
        Field(1, "uint64", "height"),
        Field(2, "uint32", "format"),
        Field(3, "uint32", "index"),
    ]


class ChunkResponseProto(Message):
    fields = [
        Field(1, "uint64", "height"),
        Field(2, "uint32", "format"),
        Field(3, "uint32", "index"),
        Field(4, "bytes", "chunk"),
        Field(5, "bool", "missing"),
    ]


class LightBlockRequestProto(Message):
    fields = [Field(1, "uint64", "height")]


class LightBlockResponseProto(Message):
    fields = [Field(1, "message", "light_block", msg_cls=LightBlock)]


class ParamsRequestProto(Message):
    fields = [Field(1, "uint64", "height")]


class ParamsResponseProto(Message):
    fields = [
        Field(1, "uint64", "height"),
        Field(2, "message", "consensus_params", msg_cls=ConsensusParamsUpdate, always_emit=True),
    ]


class StatesyncMessage(Message):
    """Message oneof (statesync/types.proto:8-17)."""

    fields = [
        Field(1, "message", "snapshots_request", msg_cls=SnapshotsRequestProto),
        Field(2, "message", "snapshots_response", msg_cls=SnapshotsResponseProto),
        Field(3, "message", "chunk_request", msg_cls=ChunkRequestProto),
        Field(4, "message", "chunk_response", msg_cls=ChunkResponseProto),
        Field(5, "message", "light_block_request", msg_cls=LightBlockRequestProto),
        Field(6, "message", "light_block_response", msg_cls=LightBlockResponseProto),
        Field(7, "message", "params_request", msg_cls=ParamsRequestProto),
        Field(8, "message", "params_response", msg_cls=ParamsResponseProto),
    ]

