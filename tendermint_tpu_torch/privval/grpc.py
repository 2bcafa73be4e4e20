"""gRPC remote signer (ref: privval/grpc/client.go, server.go,
proto/tendermint/privval/service.proto: service PrivValidatorAPI).

Role inversion vs the raw-socket privval: with gRPC the *signer* hosts
the service and the validator dials it (the reference's privval/grpc
package does the same), so there is no listener/dialer endpoint pair —
just a server wrapping a FilePV and a PrivValidator-shaped client.

Uses grpc's generic bytes API with privval/proto.py as the codec (same
approach as abci/grpc.py — no generated stubs, reference-compatible
field numbers).
"""

from __future__ import annotations

import threading

try:
    import grpc
except ImportError:  # pragma: no cover - grpcio is in the base image
    grpc = None

from ..crypto.ed25519 import Ed25519PubKey
from ..utils.grpcutil import GenericGrpcServer
from ..utils.grpcutil import require_grpc as _require_grpc
from ..utils.grpcutil import strip_scheme as _strip_scheme
from ..proto.messages import PublicKey
from ..types.proposal import Proposal
from ..types.vote import Vote
from ..utils.log import new_logger
from . import proto as pv

SERVICE = "tendermint.privval.PrivValidatorAPI"

_RPCS = {
    "GetPubKey": (pv.PubKeyRequest, pv.PubKeyResponse),
    "SignVote": (pv.SignVoteRequest, pv.SignedVoteResponse),
    "SignProposal": (pv.SignProposalRequest, pv.SignedProposalResponse),
}


class _SignerHandler(grpc.GenericRpcHandler if grpc else object):
    def __init__(self, file_pv, chain_id: str, logger):
        self._pv = file_pv
        self._chain_id = chain_id
        self._mtx = threading.Lock()  # last-sign-state file is not concurrent
        self._logger = logger

    def service(self, handler_call_details):
        service, _, rpc = handler_call_details.method.lstrip("/").partition("/")
        if service != SERVICE or rpc not in _RPCS:
            return None

        def unary(req_bytes, context, rpc=rpc):
            req = _RPCS[rpc][0].decode(req_bytes)
            return getattr(self, f"_{rpc}")(req).encode()

        return grpc.unary_unary_rpc_method_handler(unary)

    def _GetPubKey(self, req: pv.PubKeyRequest) -> pv.PubKeyResponse:
        pk = self._pv.get_pub_key()
        return pv.PubKeyResponse(pub_key=PublicKey(ed25519=pk.bytes()))

    def _SignVote(self, req: pv.SignVoteRequest) -> pv.SignedVoteResponse:
        try:
            vote = Vote.from_proto(req.vote)
            with self._mtx:
                self._pv.sign_vote(req.chain_id or self._chain_id, vote)
            return pv.SignedVoteResponse(vote=vote.to_proto())
        except Exception as e:  # double-sign guard etc. -> error response
            self._logger.error("remote sign_vote refused", err=repr(e))
            return pv.SignedVoteResponse(
                error=pv.RemoteSignerError(code=1, description=repr(e))
            )

    def _SignProposal(self, req: pv.SignProposalRequest) -> pv.SignedProposalResponse:
        try:
            proposal = Proposal.from_proto(req.proposal)
            with self._mtx:
                self._pv.sign_proposal(req.chain_id or self._chain_id, proposal)
            return pv.SignedProposalResponse(proposal=proposal.to_proto())
        except Exception as e:
            self._logger.error("remote sign_proposal refused", err=repr(e))
            return pv.SignedProposalResponse(
                error=pv.RemoteSignerError(code=1, description=repr(e))
            )


class GRPCSignerServer(GenericGrpcServer):
    """Signer process hosting PrivValidatorAPI over a FilePV
    (ref: privval/grpc/server.go)."""

    def __init__(self, file_pv, chain_id: str, addr: str = "127.0.0.1:0", logger=None):
        super().__init__(
            _SignerHandler(file_pv, chain_id, logger or new_logger("privval-grpc")),
            addr, max_workers=2, what="privval gRPC server",
        )


class GRPCSignerClient:
    """PrivValidator implementation dialing a gRPC signer
    (ref: privval/grpc/client.go). Same surface as remote.SignerClient."""

    def __init__(self, addr: str, chain_id: str, timeout: float = 10.0):
        _require_grpc()
        self._addr = _strip_scheme(addr)
        self.chain_id = chain_id
        self._timeout = timeout
        self._channel = None
        self._stubs = {}
        self._pub_key: Ed25519PubKey | None = None

    def start(self) -> None:
        self._channel = grpc.insecure_channel(self._addr)
        grpc.channel_ready_future(self._channel).result(timeout=self._timeout)
        for rpc in _RPCS:
            self._stubs[rpc] = self._channel.unary_unary(f"/{SERVICE}/{rpc}")

    def stop(self) -> None:
        if self._channel is not None:
            self._channel.close()
            self._channel = None

    def _call(self, rpc: str, req):
        if self._channel is None:
            self.start()
        res_bytes = self._stubs[rpc](req.encode(), timeout=self._timeout)
        return _RPCS[rpc][1].decode(res_bytes)

    def get_pub_key(self) -> Ed25519PubKey:
        if self._pub_key is None:
            resp = self._call("GetPubKey", pv.PubKeyRequest(chain_id=self.chain_id))
            if resp.error is not None:
                raise_remote_error(resp.error)
            kind, data = resp.pub_key.sum
            if kind != "ed25519":
                raise ValueError(f"unsupported remote key type {kind!r}")
            self._pub_key = Ed25519PubKey(data)
        return self._pub_key

    def address(self) -> bytes:
        return self.get_pub_key().address()

    def sign_vote(self, chain_id: str, vote: Vote) -> None:
        resp = self._call(
            "SignVote", pv.SignVoteRequest(vote=vote.to_proto(), chain_id=chain_id)
        )
        if resp.error is not None:
            raise_remote_error(resp.error)
        signed = Vote.from_proto(resp.vote)
        vote.signature = signed.signature
        vote.extension_signature = signed.extension_signature
        vote.timestamp = signed.timestamp

    def sign_proposal(self, chain_id: str, proposal: Proposal) -> None:
        resp = self._call(
            "SignProposal",
            pv.SignProposalRequest(proposal=proposal.to_proto(), chain_id=chain_id),
        )
        if resp.error is not None:
            raise_remote_error(resp.error)
        signed = Proposal.from_proto(resp.proposal)
        proposal.signature = signed.signature
        proposal.timestamp = signed.timestamp


def raise_remote_error(err: pv.RemoteSignerError):
    from .remote import RemoteSignerErrorException

    raise RemoteSignerErrorException(err.code or 0, err.description or "")
