"""Canonical vote and vote-extension sign bytes (ref: types/canonical.go, types/vote.go:149).

The byte layout is the contract every commit signature is checked over;
it is byte-identical to the reference node's and to the JAX package's.
"""

from __future__ import annotations

from ..proto import messages as pb
from ..proto import wire
from ..proto.message import Message, _encode_scalar


def canonicalize_block_id(bid: pb.BlockID | None) -> pb.CanonicalBlockID | None:
    """Nil/empty block IDs canonicalize to an absent field
    (ref: types/canonical.go:18-34)."""
    if bid is None:
        return None
    psh = bid.part_set_header or pb.PartSetHeader()
    if not bid.hash and not psh.hash and not psh.total:
        return None
    return pb.CanonicalBlockID(
        hash=bid.hash,
        part_set_header=pb.CanonicalPartSetHeader(total=psh.total, hash=psh.hash),
    )


def canonicalize_vote(chain_id: str, vote: pb.Vote) -> pb.CanonicalVote:
    return pb.CanonicalVote(
        type=vote.type,
        height=vote.height,
        round=vote.round,
        block_id=canonicalize_block_id(vote.block_id),
        timestamp=vote.timestamp.copy() if vote.timestamp else pb.Timestamp(),
        chain_id=chain_id,
    )


def canonicalize_vote_extension(chain_id: str, vote: pb.Vote) -> pb.CanonicalVoteExtension:
    return pb.CanonicalVoteExtension(
        extension=vote.extension,
        height=vote.height,
        round=vote.round,
        chain_id=chain_id,
    )


def vote_sign_bytes(chain_id: str, vote: pb.Vote) -> bytes:
    """Varint-length-prefixed canonical vote encoding
    (ref: types/vote.go:149 VoteSignBytes)."""
    return canonicalize_vote(chain_id, vote).encode_delimited()


def vote_extension_sign_bytes(chain_id: str, vote: pb.Vote) -> bytes:
    """ref: types/vote.go:167 VoteExtensionSignBytes."""
    return canonicalize_vote_extension(chain_id, vote).encode_delimited()


def vote_sign_bytes_template(chain_id: str, type_: int, height: int, round_: int, block_id: pb.BlockID | None):
    """Prefix/suffix split of the canonical vote encoding around the
    timestamp field (the only per-validator variation inside one commit):
    returns make(seconds, nanos) -> sign bytes, byte-identical to
    `vote_sign_bytes` without the per-call proto object graph."""
    fields = {f.name: f for f in pb.CanonicalVote.fields}
    proto = pb.CanonicalVote(
        type=type_,
        height=height,
        round=round_,
        block_id=canonicalize_block_id(block_id),
        timestamp=pb.Timestamp(),
        chain_id=chain_id,
    )
    prefix = b"".join(
        Message._encode_field(fields[name], getattr(proto, name))
        for name in ("type", "height", "round", "block_id")
    )
    suffix = Message._encode_field(fields["chain_id"], chain_id)
    ts_tag = wire.encode_tag(fields["timestamp"].number, wire.WIRE_BYTES)
    encode_varint = wire.encode_varint

    def make(seconds: int, nanos: int) -> bytes:
        tsb = b""
        if seconds:
            tsb += b"\x08" + _encode_scalar("int64", seconds)
        if nanos:
            tsb += b"\x10" + _encode_scalar("int32", nanos)
        body = prefix + ts_tag + encode_varint(len(tsb)) + tsb + suffix
        return encode_varint(len(body)) + body

    return make
