"""The remote app clients of the port (abci/proto.py, abci/socket.py,
abci/grpc.py) and its store commands (state/rollback.py, store/migrate.py)
held against the JAX package's.

- Every request and response of abci/proto.py, filled with seeded values
  (numpy's default_rng) in both packages alike, encodes to the same bytes,
  and the bytes decode to the same values in both; so do the CheckTx fast
  codec's frames.
- The port's socket and gRPC clients drive the reference's servers and the
  reference's clients the port's: one seeded script of calls (info, init,
  CheckTx one by one and in a batch, proposals, FinalizeBlock, Commit,
  queries, snapshots offered, loaded and applied, a raising app) gives the
  same responses over all four pairings of each transport.
- `rollback` and `key-migrate` on copies of one stopped node's home leave
  the same stores in both packages.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import typing

import numpy as np
import pytest

from tendermint_tpu.abci import kvstore as ref_kvstore
from tendermint_tpu.abci import proto as ref_apb
from tendermint_tpu.abci import types as ref_types
from tendermint_tpu.types import params as ref_params
from tendermint_tpu_torch.abci import kvstore as port_kvstore
from tendermint_tpu_torch.abci import proto as port_apb
from tendermint_tpu_torch.abci import types as port_types
from tendermint_tpu_torch.types import params as port_params

REF = {"apb": ref_apb, "types": ref_types, "params": ref_params, "kvstore": ref_kvstore}
PORT = {"apb": port_apb, "types": port_types, "params": port_params, "kvstore": port_kvstore}

# method -> (request type, response type); None: the method takes or gives nothing, str: a message
METHODS = {
    "echo": (str, str), "flush": (None, None), "info": ("RequestInfo", "ResponseInfo"),
    "init_chain": ("RequestInitChain", "ResponseInitChain"), "query": ("RequestQuery", "ResponseQuery"),
    "check_tx": ("RequestCheckTx", "ResponseCheckTx"), "commit": (None, "ResponseCommit"),
    "list_snapshots": ("RequestListSnapshots", "ResponseListSnapshots"),
    "offer_snapshot": ("RequestOfferSnapshot", "ResponseOfferSnapshot"),
    "load_snapshot_chunk": ("RequestLoadSnapshotChunk", "ResponseLoadSnapshotChunk"),
    "apply_snapshot_chunk": ("RequestApplySnapshotChunk", "ResponseApplySnapshotChunk"),
    "prepare_proposal": ("RequestPrepareProposal", "ResponsePrepareProposal"),
    "process_proposal": ("RequestProcessProposal", "ResponseProcessProposal"),
    "extend_vote": ("RequestExtendVote", "ResponseExtendVote"),
    "verify_vote_extension": ("RequestVerifyVoteExtension", "ResponseVerifyVoteExtension"),
    "finalize_block": ("RequestFinalizeBlock", "ResponseFinalizeBlock"),
}
SEEDS = range(4)


def _fill(tp, name, rng, pkg):
    """A seeded value of type tp; the same draws in both packages."""
    origin = typing.get_origin(tp)
    if origin is typing.Union or isinstance(tp, type(int | None)):
        args = [a for a in typing.get_args(tp) if a is not type(None)]
        return None if rng.integers(0, 2) == 0 else _fill(args[0], name, rng, pkg)
    if tp is object:  # consensus params: the dataclass, as the node hands them over
        P = pkg["params"]
        return P.ConsensusParams(block=P.BlockParams(max_bytes=int(rng.integers(1, 1 << 30)),
                                                     max_gas=int(rng.integers(-1, 1 << 20))))
    if name == "pub_key_type":
        return ["ed25519", "secp256k1", "sr25519"][int(rng.integers(0, 3))]
    if tp is bool:
        return bool(rng.integers(0, 2))
    if tp is int:
        return int(rng.integers(0, 1 << 31))
    if tp is bytes:
        return rng.bytes(int(rng.integers(1, 40)))
    if tp is str:
        return "".join(rng.choice(list("abcxyz=:/.-_ 019"), size=int(rng.integers(1, 16))))
    if tp is list:  # proof_ops: not on the wire
        return []
    if origin is list:
        (elem,) = typing.get_args(tp)
        return [_fill(elem, name, rng, pkg) for _ in range(int(rng.integers(0, 4)))]
    assert dataclasses.is_dataclass(tp), tp
    hints = typing.get_type_hints(tp, vars(pkg["types"]))
    return tp(**{f.name: _fill(hints[f.name], f.name, rng, pkg) for f in dataclasses.fields(tp)})


def _value(spec, seed, pkg):
    if spec is None:
        return None
    if spec is str:
        return _fill(str, "message", np.random.default_rng(seed), pkg)
    return _fill(getattr(pkg["types"], spec), "", np.random.default_rng(seed), pkg)


def _plain(x):
    """A value of either package as plain data, to compare across them."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__, {f.name: _plain(getattr(x, f.name)) for f in dataclasses.fields(x)})
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if hasattr(x, "encode") and hasattr(type(x), "fields"):  # a wire message
        return (type(x).__name__, x.encode())
    return x


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("method", sorted(METHODS))
def test_requests_and_responses_encode_as_the_reference(method, seed):
    req_spec, res_spec = METHODS[method]
    for side, spec, to_pb, from_pb, cls in (
            ("request", req_spec, "request_to_pb", "request_from_pb", "RequestPB"),
            ("response", res_spec, "response_to_pb", "response_from_pb", "ResponsePB")):
        ref_v, port_v = _value(spec, seed, REF), _value(spec, seed, PORT)
        assert _plain(ref_v) == _plain(port_v)
        raw = getattr(ref_apb, to_pb)(method, ref_v).encode()
        assert getattr(port_apb, to_pb)(method, port_v).encode() == raw, (side, method)
        ref_back = getattr(ref_apb, from_pb)(getattr(ref_apb, cls).decode(raw))
        port_back = getattr(port_apb, from_pb)(getattr(port_apb, cls).decode(raw))
        assert _plain(port_back) == _plain(ref_back), (side, method)


@pytest.mark.parametrize("seed", SEEDS)
def test_exception_and_check_tx_frames_as_the_reference(seed):
    raw = ref_apb.response_to_pb("exception", "boom %d" % seed).encode()
    assert port_apb.response_to_pb("exception", "boom %d" % seed).encode() == raw
    with pytest.raises(port_apb.ABCIRemoteError, match="boom %d" % seed):
        port_apb.response_from_pb(port_apb.ResponsePB.decode(raw))
    ref_req, port_req = _value("RequestCheckTx", seed, REF), _value("RequestCheckTx", seed, PORT)
    ref_res, port_res = _value("ResponseCheckTx", seed, REF), _value("ResponseCheckTx", seed, PORT)
    frame = ref_apb.encode_check_tx_request(ref_req)
    assert port_apb.encode_check_tx_request(port_req) == frame
    assert frame == ref_apb.request_to_pb("check_tx", ref_req).encode()
    assert _plain(port_apb.try_decode_check_tx_request(frame)) == _plain(ref_apb.try_decode_check_tx_request(frame))
    frame = ref_apb.encode_check_tx_response(ref_res)
    assert port_apb.encode_check_tx_response(port_res) == frame
    assert _plain(port_apb.try_decode_check_tx_response(frame)) == \
        _plain(ref_apb.try_decode_check_tx_response(frame))


# -- the transports across the packages ------------------------------------------------


class _Raising:
    """Wraps a kvstore whose query raises on one path, the app error the
    transports answer with ResponseException."""

    def __init__(self, app):
        self._app = app

    def __getattr__(self, name):
        return getattr(self._app, name)

    def query(self, req):
        if req.path == "/boom":
            raise RuntimeError("app refused /boom")
        return self._app.query(req)


def _server(pkg_name, transport):
    pkg = REF if pkg_name == "ref" else PORT
    app = _Raising(pkg["kvstore"].KVStoreApplication(snapshot_interval=2))
    if transport == "socket":
        mod = __import__(f"{'tendermint_tpu' if pkg_name == 'ref' else 'tendermint_tpu_torch'}.abci.socket",
                         fromlist=["SocketServer"])
        srv = mod.SocketServer(app, "tcp://127.0.0.1:0")
    else:
        mod = __import__(f"{'tendermint_tpu' if pkg_name == 'ref' else 'tendermint_tpu_torch'}.abci.grpc",
                         fromlist=["GRPCServer"])
        srv = mod.GRPCServer(app, "127.0.0.1:0")
    srv.start()
    return srv


def _client(pkg_name, transport, addr):
    name = "tendermint_tpu" if pkg_name == "ref" else "tendermint_tpu_torch"
    if transport == "socket":
        mod = __import__(f"{name}.abci.socket", fromlist=["SocketClient"])
        client = mod.SocketClient(addr, timeout=20.0)
    else:
        mod = __import__(f"{name}.abci.grpc", fromlist=["GRPCClient"])
        client = mod.GRPCClient(addr, timeout=20.0)
    client.start()
    return client


def _script(client, pkg):
    """One seeded sequence of calls; each response as plain data."""
    T, P, apb = pkg["types"], pkg["params"], pkg["apb"]
    rng = np.random.default_rng(7)
    out = []
    out.append(_plain(client.info(T.RequestInfo(version="0.35"))))
    out.append(_plain(client.init_chain(T.RequestInitChain(time_ns=1_700_000_000 * 10**9, chain_id="remote-chain",
                                                           consensus_params=P.ConsensusParams()))))
    for height in range(1, 6):
        txs = [b"k%d-%d=%s" % (height, i, rng.bytes(4).hex().encode()) for i in range(int(rng.integers(1, 5)))]
        out.append(_plain(client.check_tx(T.RequestCheckTx(tx=txs[0]))))
        out.append(_plain(client.check_tx_batch([T.RequestCheckTx(tx=tx) for tx in txs])))
        out.append(_plain(client.prepare_proposal(T.RequestPrepareProposal(max_tx_bytes=1 << 20, txs=txs,
                                                                           height=height))))
        out.append(_plain(client.process_proposal(T.RequestProcessProposal(txs=txs, height=height))))
        out.append(_plain(client.finalize_block(T.RequestFinalizeBlock(
            txs=txs, height=height, time_ns=(1_700_000_000 + height) * 10**9, hash=rng.bytes(32)))))
        out.append(_plain(client.commit()))
        out.append(_plain(client.query(T.RequestQuery(data=txs[0].split(b"=")[0]))))
    out.append(_plain(client.extend_vote(T.RequestExtendVote(hash=b"\x01" * 32, height=5))))
    out.append(_plain(client.verify_vote_extension(T.RequestVerifyVoteExtension(height=5, vote_extension=b"x"))))
    snaps = client.list_snapshots(T.RequestListSnapshots())
    out.append(_plain(snaps))
    snap = snaps.snapshots[-1]
    chunks = [client.load_snapshot_chunk(T.RequestLoadSnapshotChunk(height=snap.height, format=snap.format,
                                                                    chunk=i)).chunk for i in range(snap.chunks)]
    out.append(_plain(chunks))
    out.append(_plain(client.offer_snapshot(T.RequestOfferSnapshot(snapshot=snap, app_hash=b""))))
    out.append(_plain([client.apply_snapshot_chunk(T.RequestApplySnapshotChunk(index=i, chunk=c, sender="peer"))
                       for i, c in enumerate(chunks)]))
    out.append(_plain(client.info(T.RequestInfo())))
    with pytest.raises(apb.ABCIRemoteError, match="app refused /boom"):
        client.query(T.RequestQuery(path="/boom"))
    out.append(_plain(client.query(T.RequestQuery(path="/val", data=b"\x00"))))
    return out


@pytest.mark.parametrize("transport", ["socket", "grpc"])
def test_clients_and_servers_across_the_packages(transport):
    """The same script over (client, server) = (ref, ref), (port, ref),
    (ref, port), (port, port): equal responses in all four."""
    if transport == "grpc":
        pytest.importorskip("grpc")
    answers = {}
    for server_pkg in ("ref", "port"):
        for client_pkg in ("ref", "port"):
            srv = _server(server_pkg, transport)
            client = _client(client_pkg, transport, srv.listen_addr)
            try:
                answers[client_pkg, server_pkg] = _script(client, REF if client_pkg == "ref" else PORT)
            finally:
                client.stop()
                srv.stop()
    base = answers["ref", "ref"]
    assert len(base) > 40
    for pair, got in answers.items():
        assert got == base, pair


# -- rollback and key-migrate in both packages -----------------------------------------


def _stopped_home(tmp_path):
    """A one-validator port node run to height 4 or more, then stopped; its home."""
    from test_consensus import fast_params
    from tendermint_tpu_torch.cli import main as tmain
    from tendermint_tpu_torch.config import load_config
    from tendermint_tpu_torch.node import Node
    from tendermint_tpu_torch.types.genesis import GenesisDoc

    out = str(tmp_path / "net")
    assert tmain(["testnet", "--validators", "1", "--output", out, "--chain-id", "cmd-chain",
                  "--starting-port", "0"]) == 0
    home = os.path.join(out, "node0")
    gp = os.path.join(home, "config", "genesis.json")
    gd = GenesisDoc.from_file(gp)
    gd.consensus_params = fast_params()
    gd.save_as(gp)
    cfg = load_config(home)
    cfg.p2p.laddr = cfg.rpc.laddr = "tcp://127.0.0.1:0"
    cfg.save()
    node = Node(cfg, device="cpu")
    node.start()
    try:
        assert node.mempool.check_tx(b"cmd-key=cmd-value").code == 0
        import time

        deadline = time.monotonic() + 60
        while node.block_store.height() < 4 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert node.block_store.height() >= 4
    finally:
        node.stop()
    return home


def _db_items(home):
    from tendermint_tpu_torch.store.kv import FileDB

    data = os.path.join(home, "data")
    out = {}
    for name in sorted(os.listdir(data)):
        if name.endswith(".db"):
            db = FileDB(os.path.join(data, name))
            out[name] = list(db.iterator(None, None))
            db.close()
    return out


def _legacy_keys(home):
    """Rewrite some block store keys in the legacy ASCII-decimal layout, the
    input key-migrate upgrades (ref: scripts/keymigrate)."""
    from tendermint_tpu_torch.store.kv import FileDB

    db = FileDB(os.path.join(home, "data", "blockstore.db"))
    moved = 0
    for k, v in list(db.iterator(None, None)):
        if k.startswith(b"H:") and len(k) == 10:
            db.delete(k)
            db.set(b"H:%d" % int.from_bytes(k[2:], "big"), v)
            moved += 1
    db.close()
    return moved


def test_rollback_and_key_migrate_leave_equal_stores(tmp_path, capsys):
    """rollback, then key-migrate twice (the first over block store keys
    rewritten in the legacy layout), on two copies of one home: the same
    output and the same stores in both packages."""
    from tendermint_tpu.cli import main as ref_main
    from tendermint_tpu_torch.cli import main as port_main

    home = _stopped_home(tmp_path)
    capsys.readouterr()  # testnet's line
    mains = {"ref": ref_main, "port": port_main}
    homes, said, legacy = {}, {}, {}
    for pkg, main in mains.items():
        homes[pkg] = str(tmp_path / pkg)
        shutil.copytree(home, homes[pkg])
        assert main(["--home", homes[pkg], "rollback"]) == 0
        said[pkg] = [capsys.readouterr().out]
        legacy[pkg] = _legacy_keys(homes[pkg])
        for _ in range(2):
            assert main(["--home", homes[pkg], "key-migrate"]) == 0
            said[pkg].append(capsys.readouterr().out)
    assert said["port"] == said["ref"] and legacy["port"] == legacy["ref"] >= 4
    assert "rolled back state to height" in said["port"][0]
    assert f"total migrated: {legacy['port']} keys" in said["port"][1]
    assert "total migrated: 0 keys" in said["port"][2]
    assert _db_items(homes["port"]) == _db_items(homes["ref"])
