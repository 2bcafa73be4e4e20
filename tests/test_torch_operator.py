"""The operator's tools (ROADMAP A14b) held equal to the reference.

- A two-node chain, one port Node (device="cpu") and one reference Node
  meshed over TCP, blocks only for txs: the port's HTTPProvider gives the
  reference's light blocks, byte for byte, from either node's RPC, and the
  port's LightProxy (its LightClient on the CPU) answers every route as the
  reference's does, refusals included.
- The remote signer's frames (privval/proto.py messages in
  privval/remote.py's length-delimited framing) equal the reference's byte
  for byte, and each package's signer serves the other's client.
- The sqlite sink's rows equal the reference's; the flight recorder's
  samples carry the same keys.
- Deterministic forms of two unsteady reference cases:
  test_compact_reclaims_space (the height read after the node stopped) and
  test_proxy_proofs_batch_verifies_before_relaying (the txs in the mempool
  before the first proposal, so block 1 carries all three).
- chip_smoke.py's phase 17 rehearsed on the CPU: the light daemon through
  the CLI (its checks below the device cutover, on the host), its proxy's
  routes against the node's, SIGTERM; replay on two copies of the stopped
  node's home.
"""

from __future__ import annotations

import base64
import hashlib
import json
import os
import shutil
import sqlite3
import time
from types import SimpleNamespace

import pytest
import torch

import tendermint_tpu.config as jconfig
import tendermint_tpu_torch.config as tconfig

torch.set_num_threads(1)

CHAIN = "operator-chain"
DEADLINE_S = 120


def _wait(cond, timeout=DEADLINE_S):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.05)
    return False


def _settled(nodes):
    """Every node at the same height, which holds for a second."""
    same = lambda: len({n.block_store.height() for n in nodes}) == 1  # noqa: E731
    return _wait(lambda: same() and (time.sleep(1.0) or same()))


@pytest.fixture(scope="module")
def two_node_chain(tmp_path_factory):
    """Two validators from the port's `testnet`, node 0 a port Node on the
    CPU, node 1 the reference's, meshed over TCP; three txs committed."""
    from test_consensus import fast_params
    from tendermint_tpu.node import Node as JNode
    from tendermint_tpu_torch.cli import main as tmain
    from tendermint_tpu_torch.node import Node as TNode
    from tendermint_tpu_torch.rpc.client import HTTPClient
    from tendermint_tpu_torch.types.genesis import GenesisDoc

    out = str(tmp_path_factory.mktemp("operator") / "net")
    assert tmain(["testnet", "--validators", "2", "--output", out, "--chain-id", CHAIN, "--starting-port", "0"]) == 0
    gen = GenesisDoc.from_file(os.path.join(out, "node0", "config", "genesis.json"))
    gen.consensus_params = fast_params()
    nodes = []
    try:
        for i, cfg_mod in enumerate((tconfig, jconfig)):
            home = os.path.join(out, f"node{i}")
            gen.save_as(os.path.join(home, "config", "genesis.json"))
            cfg = cfg_mod.load_config(home)
            cfg.p2p.laddr = cfg.rpc.laddr = "tcp://127.0.0.1:0"
            cfg.p2p.persistent_peers = ""
            cfg.consensus.create_empty_blocks = False
            nodes.append(TNode(cfg, device="cpu") if cfg_mod is tconfig else JNode(cfg))
        for n in nodes:
            n.start()
        nodes[0].dial(nodes[1])
        nodes[1].dial(nodes[0])
        assert _wait(lambda: all(len(n.peer_manager.peers()) == 1 for n in nodes)), "the mesh"
        client = HTTPClient("http://%s:%d" % nodes[0].rpc_address, timeout=60)
        for i in range(3):
            res = client.call("broadcast_tx_commit", tx=f"op-key{i}=op-value{i}".encode().hex())
            assert res["tx_result"]["code"] == 0, res
        assert _settled(nodes) and nodes[0].block_store.height() >= 4
        urls = ["http://%s:%d" % n.rpc_address for n in nodes]
        yield SimpleNamespace(nodes=nodes, urls=urls, top=nodes[0].block_store.height(),
                              tx_height=int(res["height"]))
    finally:
        for n in nodes:
            n.stop()


def _providers():
    from tendermint_tpu.light.http_provider import HTTPProvider as JProvider
    from tendermint_tpu_torch.light.http_provider import HTTPProvider as TProvider

    return TProvider, JProvider


def test_http_provider_light_blocks_equal_the_reference(two_node_chain):
    """HTTPProvider.light_block at every height (0: the latest) equals the
    reference's: the port's over the port node against the reference's over
    the reference node, and both over one node."""
    c = two_node_chain
    TProvider, JProvider = _providers()
    pairs = [(TProvider(CHAIN, c.urls[0]), JProvider(CHAIN, c.urls[1])),
             (TProvider(CHAIN, c.urls[1]), JProvider(CHAIN, c.urls[1]))]
    for tp, jp in pairs:
        assert tp.id().replace(c.urls[0], c.urls[1]) == jp.id()
        for h in list(range(1, c.top)) + [0]:
            t, j = tp.light_block(h), jp.light_block(h)
            if h == 0:  # the latest carries each node's own seen commit
                assert t.signed_header.header.hash() == j.signed_header.header.hash()
                assert t.validator_set.hash() == j.validator_set.hash()
                continue
            assert t.to_proto().encode() == j.to_proto().encode(), h
            assert t.signed_header.hash() == j.signed_header.hash()
            assert [(v.address, v.voting_power, v.proposer_priority) for v in t.validator_set.validators] == \
                [(v.address, v.voting_power, v.proposer_priority) for v in j.validator_set.validators]
            assert t.validator_set.get_proposer().address == j.validator_set.get_proposer().address


def _proxies(c):
    from tendermint_tpu.light import LightClient as JClient
    from tendermint_tpu.light import TrustOptions as JTrust
    from tendermint_tpu.light.proxy import LightProxy as JProxy
    from tendermint_tpu_torch.light import LightClient as TClient
    from tendermint_tpu_torch.light import TrustOptions as TTrust
    from tendermint_tpu_torch.light.proxy import LightProxy as TProxy

    TProvider, JProvider = _providers()
    tp, jp = TProvider(CHAIN, c.urls[0]), JProvider(CHAIN, c.urls[1])
    root = tp.light_block(1).signed_header.hash()
    tclient = TClient(CHAIN, TTrust(period_ns=3600 * 10**9, height=1, hash=root), tp, device="cpu")
    jclient = JClient(CHAIN, JTrust(period_ns=3600 * 10**9, height=1, hash=root), jp)
    return TProxy(tclient, c.urls[0]), JProxy(jclient, c.urls[1])


def test_light_proxy_answers_equal_the_reference(two_node_chain):
    """The port's LightProxy over the port node and the reference's over the
    reference node: block, commit, header and validators at every height
    below the tip, light_batch and proofs_batch of the tx block's indices,
    the passthroughs, and each refusal, equal JSON; the divergence report
    of a tampered relay the same."""
    from tendermint_tpu_torch.rpc.client import HTTPClient, RPCClientError

    c = two_node_chain
    proxies = _proxies(c)
    for p in proxies:
        p.start()
    try:
        clients = [HTTPClient("http://%s:%d" % p.address, timeout=60) for p in proxies]

        def equal(method, **params):
            answers = [cl.call(method, **params) for cl in clients]
            assert json.dumps(answers[0], sort_keys=True) == json.dumps(answers[1], sort_keys=True), \
                (method, params)
            return answers[0]

        for h in range(1, c.top):
            for route in ("block", "commit", "header", "validators"):
                equal(route, height=str(h))
        n_txs = len(c.nodes[0].block_store.load_block(c.tx_height).txs)
        equal("proofs_batch", height=str(c.tx_height), indices=list(range(n_txs)))
        out = equal("light_batch", height=str(c.tx_height), indices=[0])
        assert out["proofs"]["root"] == c.nodes[0].block_store.load_block(c.tx_height).header.data_hash.hex().upper()
        for method in ("abci_info", "health", "num_unconfirmed_txs"):
            equal(method)
        refusals = [("block", {}), ("commit", {}), ("light_batch", {"height": str(10**6)}),
                    ("proofs_batch", {"height": str(c.tx_height), "indices": []}),
                    ("state_batch", {"height": "1", "keys": ["zz"]})]
        for method, params in refusals:
            errs = []
            for cl in clients:
                with pytest.raises(RPCClientError) as e:
                    cl.call(method, **params)
                errs.append((e.value.code, str(e.value)))
            assert errs[0] == errs[1], (method, errs)
        # a primary that tampers a proof is refused by both, and reported
        for p in proxies:
            real = p.primary.call

            def tampering(method, _real=real, **params):
                res = _real(method, **params)
                if method == "proofs_batch":
                    res["txs"] = [base64.b64encode(b"spoofed").decode()]
                return res

            p.primary.call = tampering
        errs = []
        for cl in clients:
            with pytest.raises(RPCClientError) as e:
                cl.call("proofs_batch", height=str(c.tx_height), indices=[0])
            errs.append((e.value.code, str(e.value)))
        assert errs[0] == errs[1] and "multiproof does not verify" in errs[0][1]
        reports = [p.divergence_report() for p in proxies]
        assert [r["divergences"] for r in reports] == [2, 2]  # the past-head refusal and the tampered proof
        assert [d["msg"] for d in reports[0]["recent"]] == [d["msg"] for d in reports[1]["recent"]]
    finally:
        for p in proxies:
            p.stop()


# -- the remote signer's frames ---------------------------------------------------


def _privval_pair():
    import tendermint_tpu.privval.proto as jpv
    import tendermint_tpu.privval.remote as jremote
    import tendermint_tpu_torch.privval.proto as tpv
    import tendermint_tpu_torch.privval.remote as tremote

    return (tpv, tremote), (jpv, jremote)


class _Capture:
    def __init__(self):
        self.frames = []

    def write(self, data):
        self.frames.append(bytes(data))
        return len(data)


def _messages(pkg):
    """Every privval message the remote signer exchanges, built in one
    package from the same fields."""
    import importlib

    base = pkg.__name__.rsplit(".", 2)[0]
    pv = importlib.import_module(f"{base}.privval.proto")
    msgs = importlib.import_module(f"{base}.proto.messages")
    from tendermint_tpu_torch.crypto import ed25519_ref as ref

    priv = ref.gen_privkey(b"\x42" * 32)
    pub = msgs.PublicKey(ed25519=priv[32:])
    bid = msgs.BlockID(hash=b"\x11" * 32, part_set_header=msgs.PartSetHeader(total=1, hash=b"\x22" * 32))
    ts = msgs.Timestamp(seconds=1_700_000_000, nanos=123)
    vote = msgs.Vote(type=msgs.SIGNED_MSG_TYPE_PREVOTE, height=5, round=1, block_id=bid, timestamp=ts,
                     validator_address=b"\x01" * 20, validator_index=3, signature=b"\x07" * 64)
    proposal = msgs.Proposal(type=msgs.SIGNED_MSG_TYPE_PROPOSAL, height=5, round=1, pol_round=-1, block_id=bid,
                             timestamp=ts, signature=b"\x08" * 64)
    err = pv.RemoteSignerError(code=2, description="double sign")
    P = pv.PrivvalMessage
    return [P(pub_key_request=pv.PubKeyRequest(chain_id=CHAIN)),
            P(pub_key_response=pv.PubKeyResponse(pub_key=pub)),
            P(pub_key_response=pv.PubKeyResponse(pub_key=msgs.PublicKey(), error=err)),
            P(sign_vote_request=pv.SignVoteRequest(vote=vote, chain_id=CHAIN)),
            P(signed_vote_response=pv.SignedVoteResponse(vote=vote)),
            P(signed_vote_response=pv.SignedVoteResponse(vote=msgs.Vote(), error=err)),
            P(sign_proposal_request=pv.SignProposalRequest(proposal=proposal, chain_id=CHAIN)),
            P(signed_proposal_response=pv.SignedProposalResponse(proposal=proposal)),
            P(ping_request=pv.PingRequest()), P(ping_response=pv.PingResponse())]


def test_remote_signer_frames_equal_the_reference():
    """Each message the remote signer sends, framed by _write_msg
    (varint length + body), is the reference's bytes, and each package's
    _read_msg decodes the other's frame to the same message."""
    (tpv, tremote), (jpv, jremote) = _privval_pair()
    tmsgs, jmsgs = _messages(tpv), _messages(jpv)
    assert len(tmsgs) == len(jmsgs) == 10
    for t, j in zip(tmsgs, jmsgs):
        tc, jc = _Capture(), _Capture()
        tremote._write_msg(tc, t)
        jremote._write_msg(jc, j)
        assert tc.frames == jc.frames and len(tc.frames) == 1
        frame = tc.frames[0]

        class Reader:
            def __init__(self, data):
                self.data = data

            def read_exact(self, n):
                out, self.data = self.data[:n], self.data[n:]
                return out

        assert tremote._read_msg(Reader(frame)).encode() == j.encode()
        assert jremote._read_msg(Reader(frame)).encode() == t.encode()


@pytest.mark.parametrize("server_pkg", ["port", "jax"])
def test_remote_signer_serves_the_other_package(tmp_path, server_pkg):
    """A port signer client and endpoint against the reference's signer
    server over a unix socket, and the other way round: the same public
    key, and a vote signed remotely carries the signature the signer's
    FilePV gives the same sign bytes."""
    import tendermint_tpu.privval as jprivval
    import tendermint_tpu.types.vote as jvote
    import tendermint_tpu_torch.privval as tprivval
    import tendermint_tpu_torch.types.vote as tvote
    from tendermint_tpu_torch.types.block import BlockID, PartSetHeader
    from tendermint_tpu_torch.utils.tmtime import Time

    (tpv, tremote), (jpv, jremote) = _privval_pair()
    key_f, state_f = str(tmp_path / "k.json"), str(tmp_path / "s.json")
    tprivval.FilePV.generate(key_f, state_f).save_key()
    server_mod, client_mod = (tremote, jremote) if server_pkg == "port" else (jremote, tremote)
    server_fpv = (tprivval if server_pkg == "port" else jprivval).FilePV.load(key_f, state_f)
    client_vote_mod = jvote if server_pkg == "port" else tvote
    addr = f"unix://{tmp_path}/signer.sock"
    endpoint = client_mod.SignerListenerEndpoint(addr)
    endpoint.start()
    server = server_mod.SignerServer(endpoint.bound_addr, server_fpv, CHAIN)
    server.start()
    try:
        client = client_mod.SignerClient(endpoint, CHAIN)
        assert client.get_pub_key().bytes() == server_fpv.get_pub_key().bytes()
        import importlib

        cbase = client_mod.__name__.rsplit(".", 2)[0]
        cblock = importlib.import_module(f"{cbase}.types.block")
        ctime = importlib.import_module(f"{cbase}.utils.tmtime")
        vote = client_vote_mod.Vote(type=1, height=7, round=0,
                                    block_id=cblock.BlockID(hash=b"\x11" * 32, part_set_header=cblock.PartSetHeader(
                                        total=1, hash=b"\x22" * 32)),
                                    timestamp=ctime.Time.now(), validator_address=b"\x01" * 20, validator_index=0)
        client.sign_vote(CHAIN, vote)
        assert len(vote.signature) == 64
        local = tvote.Vote(type=1, height=7, round=0,
                           block_id=BlockID(hash=b"\x11" * 32, part_set_header=PartSetHeader(total=1, hash=b"\x22" * 32)),
                           timestamp=Time.from_unix_ns(vote.timestamp.unix_ns()), validator_address=b"\x01" * 20,
                           validator_index=0)
        from tendermint_tpu_torch.crypto.ed25519 import Ed25519PubKey

        assert Ed25519PubKey(server_fpv.get_pub_key().bytes()).verify_signature(local.sign_bytes(CHAIN),
                                                                              vote.signature)
    finally:
        server.stop()
        endpoint.stop()


# -- the sqlite sink and the flight recorder ----------------------------------------


def _finalize(pkg):
    import importlib

    T = importlib.import_module(f"{pkg}.abci.types")
    ev = lambda t, **kv: T.Event(type=t, attributes=[T.EventAttribute(key=k, value=v, index=True)  # noqa: E731
                                                      for k, v in kv.items()])
    f_res = T.ResponseFinalizeBlock(events=[ev("begin", proposer="AB"), ev("end", size="3")])
    results = [T.ExecTxResult(code=0, data=b"\x01", log="ok", gas_wanted=5, gas_used=3,
                              events=[ev("transfer", sender="alice", amount="10")]),
               T.ExecTxResult(code=7, log="bad", codespace="app", events=[ev("fail", why="x")])]
    return f_res, results


def test_sql_sink_rows_equal_the_reference(tmp_path):
    """The same blocks, txs and events through each package's SQLSink: every
    row of blocks, tx_results (the serialized TxResult included), events
    and attributes equal, created_at aside; get_tx_by_hash decodes the same
    record."""
    from tendermint_tpu.indexer.sink_sql import SQLSink as JSink
    from tendermint_tpu_torch.eventbus.event_bus import tx_hash
    from tendermint_tpu_torch.indexer.sink_sql import SQLSink as TSink

    txs = [b"a=1", b"b=2"]
    sinks = []
    for name, Sink, pkg in (("port", TSink, "tendermint_tpu_torch"), ("jax", JSink, "tendermint_tpu")):
        sink = Sink(str(tmp_path / f"{name}.sqlite"), CHAIN)
        f_res, results = _finalize(pkg)
        for h in (1, 2):
            sink.index_block_events(h, f_res)
            sink.index_tx_events(h, txs, results)
        sink.index_tx_events(2, txs, results)  # idempotent
        sinks.append(sink)
    queries = ["SELECT rowid, height, chain_id FROM blocks ORDER BY rowid",
               "SELECT rowid, block_id, index_in_block, tx_hash, tx_result FROM tx_results ORDER BY rowid",
               "SELECT rowid, block_id, tx_id, type FROM events ORDER BY rowid",
               "SELECT event_id, key, composite_key, value FROM attributes ORDER BY event_id, key"]
    for q in queries:
        rows = [s.query(q) for s in sinks]
        assert rows[0] == rows[1] and rows[0], q
    t, j = (s.get_tx_by_hash(tx_hash(b"b=2")) for s in sinks)
    assert t.encode() == j.encode() and t.result.code == 7
    for s in sinks:
        s.close()
    with pytest.raises(sqlite3.ProgrammingError):
        sinks[0].query("SELECT 1")


def test_flight_recorder_samples_have_the_reference_keys(tmp_path):
    """Each package's FlightRecorder over the same metric groups, written
    to alike: the anchor record, a delta tick and a mark carry the same
    keys (and the same values, the time aside)."""
    import tendermint_tpu.metrics as jm
    import tendermint_tpu.metrics.flight as jflight
    import tendermint_tpu_torch.metrics as tm
    import tendermint_tpu_torch.metrics.flight as tflight

    records = []
    for name, m, flight in (("port", tm, tflight), ("jax", jm, jflight)):
        reg = m.Registry()
        cons, mem, fm = m.ConsensusMetrics(reg), m.MempoolMetrics(reg), m.FlightMetrics(reg)
        rec = flight.FlightRecorder([reg], str(tmp_path / f"{name}.jsonl"), interval=1.0, metrics=fm)
        cons.height.set(3)
        cons.total_txs.add(2)
        cons.step_duration.observe(0.25, "propose")
        first = rec.sample_once()
        cons.height.set(4)
        cons.total_txs.add(1)
        mem.size.set(9)
        second = rec.sample_once()
        rec.mark("stage")
        with open(rec.path) as f:
            lines = [json.loads(line) for line in f]
        records.append((first, second, lines))
    (t1, t2, tl), (j1, j2, jl) = records
    for a, b in ((t1, j1), (t2, j2)):
        assert set(a) == set(b)
        for part in ("c", "d", "g"):
            assert set(a.get(part, {})) == set(b.get(part, {})), part
            timed = lambda d: {k: v for k, v in (d or {}).items() if "sample_seconds_sum" not in k}  # noqa: E731
            assert timed(a.get(part)) == timed(b.get(part)), part  # the tick's own wall time aside
    assert [sorted(r) for r in tl] == [sorted(r) for r in jl]
    assert tl[-1]["mark"] == jl[-1]["mark"] == "stage"
    assert tflight.TIMESERIES_NAME == jflight.TIMESERIES_NAME
    assert set(tflight.__all__) == set(jflight.__all__)


# -- the two unsteady reference cases, held deterministically --------------------


def _held_node(tmp_path, txs=()):
    """A one-validator port node on the CPU whose first proposal waits until
    `txs` are in its mempool (block 1 carries all of them); returns it
    started, its home and its RPC URL."""
    from test_consensus import fast_params
    from tendermint_tpu_torch.cli import main as tmain
    from tendermint_tpu_torch.config import load_config
    from tendermint_tpu_torch.node import Node
    from tendermint_tpu_torch.types.genesis import GenesisDoc

    out = str(tmp_path / "net")
    assert tmain(["testnet", "--validators", "1", "--output", out, "--chain-id", CHAIN, "--starting-port", "0"]) == 0
    home = os.path.join(out, "node0")
    gp = os.path.join(home, "config", "genesis.json")
    gd = GenesisDoc.from_file(gp)
    gd.consensus_params = fast_params()
    gd.save_as(gp)
    cfg = load_config(home)
    cfg.p2p.laddr = cfg.rpc.laddr = "tcp://127.0.0.1:0"
    cfg.save()
    node = Node(cfg, device="cpu")
    start_consensus, node._start_consensus = node._start_consensus, lambda: None
    node.start()
    for tx in txs:
        assert node.mempool.check_tx(tx).code == 0
    node._start_consensus = start_consensus
    start_consensus()
    return node, home, "http://%s:%d" % node.rpc_address


def test_compact_after_the_node_stopped(tmp_path):
    """tests/test_cli_ops.py test_compact_reclaims_space with the height read
    after the node stopped: compact reclaims no negative space, the stores
    reopen and keep the chain to that height."""
    from tendermint_tpu_torch.cli import main as tmain
    from tendermint_tpu_torch.config import load_config
    from tendermint_tpu_torch.node.node import _make_db
    from tendermint_tpu_torch.store.blockstore import BlockStore

    node, home, _ = _held_node(tmp_path, [b"k%d=v%d" % (i, i) for i in range(3)])
    assert _wait(lambda: node.block_store.height() >= 3)
    node.stop()
    height = node.block_store.height()
    cfg = load_config(home)
    before = {f: os.path.getsize(os.path.join(cfg.db_dir, f)) for f in os.listdir(cfg.db_dir) if f.endswith(".db")}
    assert before
    assert tmain(["--home", home, "compact"]) == 0
    after = {f: os.path.getsize(os.path.join(cfg.db_dir, f)) for f in before}
    assert all(after[f] <= before[f] for f in before)
    bs = BlockStore(_make_db(cfg, "blockstore"))
    assert bs.height() == height
    assert bs.load_block(height) is not None and len(bs.load_block(1).txs) == 3


def test_proxy_proofs_batch_verifies_before_relaying_deterministically(tmp_path):
    """tests/test_light_proxy.py test_proxy_proofs_batch_verifies_before_relaying
    with the three txs in block 1 by construction: the proxy relays the
    multiproof only after it verifies against the verified data_hash, and
    refuses a tampered tx and a substituted index set."""
    from tendermint_tpu_torch.light import HTTPProvider, LightClient, TrustOptions
    from tendermint_tpu_torch.light.proxy import LightProxy
    from tendermint_tpu_torch.rpc.client import HTTPClient, RPCClientError
    from tendermint_tpu_torch.rpc.core import multiproof_from_json

    node, _, url = _held_node(tmp_path, [b"lpk%d=lpv%d" % (i, i) for i in range(3)])
    try:
        assert _wait(lambda: node.block_store.height() >= 2)
        assert len(node.block_store.load_block(1).txs) == 3
        primary = HTTPProvider(CHAIN, url)
        root = primary.light_block(1).signed_header.hash()
        proxy = LightProxy(LightClient(CHAIN, TrustOptions(period_ns=3600 * 10**9, height=1, hash=root), primary,
                                       device="cpu"), url)
        proxy.start()
        try:
            c = HTTPClient("http://%s:%d" % proxy.address)
            out = c.call("proofs_batch", height="1", indices=[0, 2])
            mp = multiproof_from_json(out["multiproof"])
            txs = [base64.b64decode(t) for t in out["txs"]]
            assert txs == [node.block_store.load_block(1).txs[i] for i in (0, 2)]
            assert mp.verify(bytes.fromhex(out["root"]), [hashlib.sha256(tx).digest() for tx in txs])
            real = proxy.primary.call

            def tampering(method, **params):
                res = real(method, **params)
                if method == "proofs_batch":
                    res["txs"] = [base64.b64encode(b"spoofed").decode()] + res["txs"][1:]
                return res

            proxy.primary.call = tampering
            with pytest.raises(RPCClientError, match="multiproof does not verify"):
                c.call("proofs_batch", height="1", indices=[0, 2])

            def substituting(method, **params):
                if method == "proofs_batch":
                    return real(method, **dict(params, indices=[1]))
                return real(method, **params)

            proxy.primary.call = substituting
            with pytest.raises(RPCClientError, match="different indices"):
                c.call("proofs_batch", height="1", indices=[0])
            assert proxy.divergence_report()["divergences"] == 2
        finally:
            proxy.stop()
    finally:
        node.stop()


# -- chip_smoke.py's phase 17, rehearsed on the CPU ---------------------------------


def test_phase_17_rehearsed_on_the_cpu(tmp_path, monkeypatch):
    """chip_smoke._light_daemon and _replay_phase on a one-validator chain on
    the CPU (every check below the device cutover, so the predictions are
    no launch): the daemon started through the CLI verifies the tip, its
    proxy's answers equal the node's (header and validators in the fields it
    serves), SIGTERM ends it and its session; replay on the three copies of
    the stopped node's home (phase 18 (b)'s over gRPC among them) ends at
    the node's app hash."""
    import chip_smoke as cs
    from tendermint_tpu_torch.rpc.client import HTTPClient

    node, home, url = _held_node(tmp_path, [b"p17-%d=v" % i for i in range(4)])
    client = HTTPClient(url, timeout=60)
    for i in range(2):
        assert client.call("broadcast_tx_commit", tx=(b"p17-more-%d=v" % i).hex())["tx_result"]["code"] == 0
    node.config.consensus.create_empty_blocks = False
    assert _wait(lambda: node.block_store.height() >= 5)
    node.consensus.stop()  # the chain idles at its tip, the RPC still serves
    top = node.block_store.height()
    harness = SimpleNamespace(
        blocks={h: node.block_store.load_block(h) for h in range(1, top + 1)},
        bids={h: node.block_store.load_block_meta(h).block_id for h in range(1, top + 1)},
        replica=SimpleNamespace(states=node.state_store))
    rpc = SimpleNamespace(rpc_url=url, rpc=client, home=home, call=client.call)
    monkeypatch.setattr(cs, "LIGHT_PROOF_INDICES", [0, 2])
    monkeypatch.setattr(cs, "CS_VALIDATORS", 1)
    monkeypatch.setattr(cs, "card", lambda: "the CPU")
    logged = []
    monkeypatch.setattr(cs, "log", logged.append)
    P = cs.plane("ed25519")
    procs, seen, totals, runs = [], {}, {}, []
    where = str(tmp_path / "p17")
    os.makedirs(where)
    try:
        cs._light_daemon(cs.cli_modules(), "ed25519", P, CHAIN, [rpc, rpc, rpc], harness, where, seen, totals,
                         procs)
        status = client.call("status")["sync_info"]
        prediction = cs.replay_prediction(P, harness, top)
    finally:
        node.stop()
        for c in procs:
            c.kill()
    assert procs[0].proc.returncode is not None
    assert prediction == ({}, [1] * (top - 1))
    cs._replay_phase("ed25519", P, home, status, where, prediction, totals, runs)
    assert totals == {} and [r["run"] for r in runs] == [
        "replay as it stands (17 c)", "replay with its state at genesis (17 c)",
        "replay with its state at genesis, its app over gRPC (18 b)"]
    text = "\n".join(logged)
    print(text)  # the phase's lines, shown when a check below fails
    assert f"verified the tip {top}" in text and "launches {}, as predicted" in text
    assert "(d) SIGTERM ended the light daemon" in text
    assert text.count(f"replayed to height {top} (app hash {status['latest_app_hash'][:16]})") == 3
    shutil.rmtree(where, ignore_errors=True)
