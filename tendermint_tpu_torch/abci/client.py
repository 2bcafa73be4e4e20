"""ABCI client: the node's handle on the application.

ref: abci/client/client.go:25 (the interface), local_client.go (in-process,
one call at a time under a mutex). The socket transport (an app in a
process of its own over tcp:// or unix://) is abci/socket.py, the gRPC one
abci/grpc.py; both follow the same Client surface.
"""

from __future__ import annotations

import threading

from . import types as abci
from .types import Application


class Client:
    """Abstract client surface: one method per ABCI call
    (ref: abciclient.Client, abci/client/client.go:25)."""

    def info(self, req: abci.RequestInfo) -> abci.ResponseInfo: ...
    def query(self, req: abci.RequestQuery) -> abci.ResponseQuery: ...
    def check_tx(self, req: abci.RequestCheckTx) -> abci.ResponseCheckTx: ...

    def check_tx_batch(
        self, reqs: list[abci.RequestCheckTx]
    ) -> list[abci.ResponseCheckTx]:
        """Run a batch of CheckTx calls, responses in request order: a
        plain loop here; LocalClient takes the app mutex once a stride."""
        return [self.check_tx(r) for r in reqs]
    def init_chain(self, req: abci.RequestInitChain) -> abci.ResponseInitChain: ...
    def prepare_proposal(self, req: abci.RequestPrepareProposal) -> abci.ResponsePrepareProposal: ...
    def process_proposal(self, req: abci.RequestProcessProposal) -> abci.ResponseProcessProposal: ...
    def extend_vote(self, req: abci.RequestExtendVote) -> abci.ResponseExtendVote: ...
    def verify_vote_extension(self, req: abci.RequestVerifyVoteExtension) -> abci.ResponseVerifyVoteExtension: ...
    def finalize_block(self, req: abci.RequestFinalizeBlock) -> abci.ResponseFinalizeBlock: ...
    def commit(self) -> abci.ResponseCommit: ...
    def list_snapshots(self, req: abci.RequestListSnapshots) -> abci.ResponseListSnapshots: ...
    def offer_snapshot(self, req: abci.RequestOfferSnapshot) -> abci.ResponseOfferSnapshot: ...
    def load_snapshot_chunk(self, req: abci.RequestLoadSnapshotChunk) -> abci.ResponseLoadSnapshotChunk: ...
    def apply_snapshot_chunk(self, req: abci.RequestApplySnapshotChunk) -> abci.ResponseApplySnapshotChunk: ...

    def start(self) -> None:
        pass

    def stop(self) -> None:
        pass


class LocalClient(Client):
    """In-process client serializing calls with one mutex (ref:
    abci/client/local_client.go: "only one ABCI call at a time", the app's
    single-threaded execution model)."""

    def __init__(self, app: Application):
        self._app = app
        self._mu = threading.Lock()

    def _call(self, fn, *args):
        with self._mu:
            return fn(*args)

    def info(self, req):
        return self._call(self._app.info, req)

    def query(self, req):
        return self._call(self._app.query, req)

    def check_tx(self, req):
        return self._call(self._app.check_tx, req)

    # CheckTx calls a batch runs under one hold of the mutex: a flood pays
    # one lock handoff a stride, and a consensus call (finalize_block,
    # commit) waits at most this many CheckTx executions.
    CHECK_TX_BATCH_STRIDE = 64

    def check_tx_batch(self, reqs):
        out = []
        stride = self.CHECK_TX_BATCH_STRIDE
        for lo in range(0, len(reqs), stride):
            with self._mu:
                out.extend(self._app.check_tx(r) for r in reqs[lo : lo + stride])
        return out

    def init_chain(self, req):
        return self._call(self._app.init_chain, req)

    def prepare_proposal(self, req):
        return self._call(self._app.prepare_proposal, req)

    def process_proposal(self, req):
        return self._call(self._app.process_proposal, req)

    def extend_vote(self, req):
        return self._call(self._app.extend_vote, req)

    def verify_vote_extension(self, req):
        return self._call(self._app.verify_vote_extension, req)

    def finalize_block(self, req):
        return self._call(self._app.finalize_block, req)

    def commit(self):
        return self._call(self._app.commit)

    def list_snapshots(self, req):
        return self._call(self._app.list_snapshots, req)

    def offer_snapshot(self, req):
        return self._call(self._app.offer_snapshot, req)

    def load_snapshot_chunk(self, req):
        return self._call(self._app.load_snapshot_chunk, req)

    def apply_snapshot_chunk(self, req):
        return self._call(self._app.apply_snapshot_chunk, req)
