"""Remote-signer wire messages (ref: proto/tendermint/privval/types.proto).

Field numbers mirror the reference exactly. Transport framing is
uvarint-length-delimited proto over a (secret) connection, the same
protoio convention the reference's SignerEndpoint uses.
"""

from __future__ import annotations

from ..proto.message import Field, Message
from ..proto.messages import Proposal, PublicKey, Vote

# Errors enum (privval/types.proto:10-17)
ERRORS_UNKNOWN = 0
ERRORS_UNEXPECTED_RESPONSE = 1
ERRORS_NO_CONNECTION = 2
ERRORS_CONNECTION_TIMEOUT = 3
ERRORS_READ_TIMEOUT = 4
ERRORS_WRITE_TIMEOUT = 5


class RemoteSignerError(Message):
    fields = [
        Field(1, "int32", "code"),
        Field(2, "string", "description"),
    ]


class PubKeyRequest(Message):
    fields = [Field(1, "string", "chain_id")]


class PubKeyResponse(Message):
    fields = [
        Field(1, "message", "pub_key", always_emit=True, msg_cls=PublicKey),
        Field(2, "message", "error", msg_cls=RemoteSignerError),
    ]


class SignVoteRequest(Message):
    fields = [
        Field(1, "message", "vote", msg_cls=Vote),
        Field(2, "string", "chain_id"),
    ]


class SignedVoteResponse(Message):
    fields = [
        Field(1, "message", "vote", always_emit=True, msg_cls=Vote),
        Field(2, "message", "error", msg_cls=RemoteSignerError),
    ]


class SignProposalRequest(Message):
    fields = [
        Field(1, "message", "proposal", msg_cls=Proposal),
        Field(2, "string", "chain_id"),
    ]


class SignedProposalResponse(Message):
    fields = [
        Field(1, "message", "proposal", always_emit=True, msg_cls=Proposal),
        Field(2, "message", "error", msg_cls=RemoteSignerError),
    ]


class PingRequest(Message):
    fields = []


class PingResponse(Message):
    fields = []


class PrivvalMessage(Message):
    """privval.Message oneof (privval/types.proto:66-77)."""

    fields = [
        Field(1, "message", "pub_key_request", msg_cls=PubKeyRequest),
        Field(2, "message", "pub_key_response", msg_cls=PubKeyResponse),
        Field(3, "message", "sign_vote_request", msg_cls=SignVoteRequest),
        Field(4, "message", "signed_vote_response", msg_cls=SignedVoteResponse),
        Field(5, "message", "sign_proposal_request", msg_cls=SignProposalRequest),
        Field(6, "message", "signed_proposal_response", msg_cls=SignedProposalResponse),
        Field(7, "message", "ping_request", msg_cls=PingRequest),
        Field(8, "message", "ping_response", msg_cls=PingResponse),
    ]

    def which(self) -> str | None:
        for f in self.fields:
            if getattr(self, f.name) is not None:
                return f.name
        return None
