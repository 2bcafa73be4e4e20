"""The node slice (ROADMAP A14a) held equal to the reference: the config's
TOML read across the two packages and its refusals, the event queries of
both pubsubs, the kv indexer's keys, the files the CLI's `init` and
`testnet` write (read back by the reference), and a mixed network of two
port Nodes (device="cpu") and two reference Nodes, four validators over
TCP, whose RPC answers are equal JSON at every height both hold."""

from __future__ import annotations

import dataclasses
import json
import os
import time

import pytest
import torch

import tendermint_tpu.config as jconfig
import tendermint_tpu_torch.config as tconfig

torch.set_num_threads(1)

PACKAGES = {"port": "tendermint_tpu_torch", "jax": "tendermint_tpu"}
NET_DEADLINE_S = 120


def pkg_module(pkg, name):
    import importlib

    return importlib.import_module(f"{PACKAGES[pkg]}.{name}")


# -- config -------------------------------------------------------------------


def edited(cfg_mod, home):
    cfg = cfg_mod.default_config(home)
    cfg.base.moniker = "m\"oniker\\"
    cfg.base.mode = "full"
    cfg.rpc.laddr = "tcp://127.0.0.1:36657"
    cfg.p2p.persistent_peers = "a" * 40 + "@127.0.0.1:1"
    cfg.mempool.size = 777
    cfg.mempool.precheck_sigs = True
    cfg.consensus.create_empty_blocks = False
    cfg.tx_index.indexer = "null"
    cfg.instrumentation.prometheus = True
    return cfg


@pytest.mark.parametrize("writer,reader", [(tconfig, jconfig), (jconfig, tconfig), (tconfig, tconfig)])
def test_config_toml_reads_equal_across_packages(tmp_path, writer, reader):
    """A config.toml written by either package loads in the other to equal
    fields; the TOML text is the same bytes."""
    home = str(tmp_path / "home")
    cfg = edited(writer, home)
    cfg.save()
    back = reader.load_config(home)
    assert dataclasses.asdict(back) == dataclasses.asdict(cfg)
    assert edited(tconfig, home).to_toml() == edited(jconfig, home).to_toml()


def test_config_unknown_keys_equal(tmp_path):
    text = edited(jconfig, "").to_toml() + "\nstale-key = 1\n[rpc.sub]\nx = 1\n[bogus]\ny = 2\n"
    text = text.replace("[rpc]\n", "[rpc]\ntimeout-broadcast = 3\n")
    got = {pkg: mod.Config.from_toml(text, home="h") for pkg, mod in (("port", tconfig), ("jax", jconfig))}
    assert got["port"].unknown_keys == got["jax"].unknown_keys and len(got["port"].unknown_keys) == 4
    assert dataclasses.asdict(got["port"]) == dataclasses.asdict(got["jax"])


REFUSALS = [("base", "mode", "bogus"), ("base", "log_format", "xml"), ("mempool", "size", 0),
            ("mempool", "ttl_duration", -1.0), ("mempool", "ttl_num_blocks", -1)]


@pytest.mark.parametrize("section,attr,value", REFUSALS)
def test_config_validate_basic_refusals_equal(section, attr, value):
    errors = {}
    for pkg, mod in (("port", tconfig), ("jax", jconfig)):
        cfg = mod.default_config("h")
        setattr(getattr(cfg, section), attr, value)
        with pytest.raises(ValueError) as e:
            cfg.validate_basic()
        errors[pkg] = str(e.value)
    assert errors["port"] == errors["jax"]


# -- event queries and the kv index -------------------------------------------

QUERIES = ["tm.event = 'NewBlock'", "tm.event = 'Tx' AND tx.height = 3", "tx.height > 2 AND tx.height <= 5",
           "transfer.sender CONTAINS 'ali'", "account.number EXISTS", "transfer.amount >= 10.5",
           "tm.event = 'Tx' AND transfer.sender = 'bob' AND transfer.amount < 100",
           "block.time = '2023-06-01T00:00:00Z' AND tx.count < 3", "tx.count > 1.5"]
EVENT_MAPS = [{"tm.event": ["NewBlock"]}, {"tm.event": ["Tx"], "tx.height": ["3"], "transfer.sender": ["alice"]},
              {"tm.event": ["Tx"], "tx.height": ["5"], "transfer.sender": ["bob"], "transfer.amount": ["99"]},
              {"account.number": ["1", "2"], "transfer.amount": ["10.5"]},
              {"block.time": ["2023-06-01T00:00:00Z"], "tx.count": ["2", "x"]}, {}]


def test_queries_match_the_same_events():
    """Each query matches the same event maps in both packages, and both
    pubsub servers deliver each published message to the same subscribers."""
    got = {}
    for pkg in PACKAGES:
        ps = pkg_module(pkg, "pubsub")
        matches = [[ps.parse_query(q).matches(ev) for ev in EVENT_MAPS] for q in QUERIES]
        server = ps.Server()
        subs = [server.subscribe(f"c{i}", ps.parse_query(q)) for i, q in enumerate(QUERIES)]
        for i, ev in enumerate(EVENT_MAPS):
            server.publish(i, ev)
        delivered = []
        for sub in subs:
            seen = []
            while (msg := sub.next(timeout=0)) is not None:
                seen.append(msg.data)
            delivered.append(seen)
        got[pkg] = matches, delivered
    assert got["port"] == got["jax"]
    assert any(any(row) for row in got["port"][0]) and not all(all(row) for row in got["port"][0])


@pytest.mark.parametrize("bad", ["tm.event = ", "tx.height >> 5", "a.b = 'x' OR c.d = 'y'", "= 'x'",
                                 "a.b CONTAINS 5", "a.b = 'x' AND", "a.b EXISTS 'x'", "5 = a.b"])
def test_query_syntax_errors_equal(bad):
    errors = {}
    for pkg in PACKAGES:
        ps = pkg_module(pkg, "pubsub")
        with pytest.raises(ps.QueryError) as e:
            ps.parse_query(bad)
        errors[pkg] = str(e.value)
    assert errors["port"] == errors["jax"]


def test_kv_index_keys_equal():
    """The same tx and block results give the kv indexer the same keys and
    values, and the same answers to the same queries."""
    got = {}
    for pkg in PACKAGES:
        abci = pkg_module(pkg, "abci.types")
        kv = pkg_module(pkg, "indexer.kv")
        ps = pkg_module(pkg, "pubsub")
        db = pkg_module(pkg, "store.kv").MemDB()

        def ev(type_, **attrs):
            return abci.Event(type=type_, attributes=[abci.EventAttribute(key=k, value=v, index=True)
                                                      for k, v in attrs.items()])

        class FRes:
            def __init__(self, tx_results, events=()):
                self.tx_results, self.events = tx_results, list(events)

        idx = kv.KVIndexer(db)
        for h in (3, 4, 5):
            txs = [b"tx-%d-%d" % (h, i) for i in range(3)]
            results = [abci.ExecTxResult(code=i % 2, log=f"log {i}", gas_wanted=i, gas_used=i, events=[
                ev("transfer", sender=["alice", "bob", "carol"][i], amount=str(10 * h + i))]) for i in range(3)]
            idx.index_tx_events(h, txs, results)
            idx.index_block_events(h, FRes(results, [ev("rewards", validator=f"v{h}")]))
        answers = [idx.search_tx_events(ps.parse_query(q)) for q in (
            "transfer.sender = 'bob'", "tx.height >= 4", "transfer.amount > 40 AND tx.height = 5")]
        answers += [idx.search_block_events(ps.parse_query(q)) for q in ("rewards.validator = 'v4'",
                                                                          "block.height > 3")]
        got[pkg] = list(db.iterator()), answers
    assert got["port"] == got["jax"]
    assert got["port"][0] and all(got["port"][1])


# -- the CLI's files ------------------------------------------------------------

AMINO = {"ed25519": "tendermint/PubKeyEd25519", "sr25519": "tendermint/PubKeySr25519",
         "secp256k1": "tendermint/PubKeySecp256k1"}


def read_back(home):
    """The reference's reading of a home: its config's fields, its genesis
    as JSON, its private validator's public key and its node ID."""
    from tendermint_tpu.node import NodeKey
    from tendermint_tpu.privval import FilePV
    from tendermint_tpu.types.genesis import GenesisDoc

    cfg = jconfig.load_config(home)
    gen = GenesisDoc.from_file(cfg.genesis_file)
    pv = FilePV.load(cfg.priv_validator_key_file, cfg.priv_validator_state_file) \
        if os.path.exists(cfg.priv_validator_key_file) else None
    return (dataclasses.asdict(cfg), json.loads(gen.to_json()),
            pv and (pv.get_pub_key().type_name, pv.get_pub_key().bytes()), NodeKey.load_or_gen(cfg.node_key_file).node_id)


@pytest.mark.parametrize("key", ["ed25519", "sr25519", "secp256k1"])
@pytest.mark.parametrize("mode", ["validator", "full", "seed"])
def test_cli_init_files_read_by_the_reference(tmp_path, key, mode):
    """`init` writes a home the reference reads back to what the port reads:
    the same config fields as the reference's own `init`, a genesis with the
    validator's key of the type asked for."""
    from tendermint_tpu.cli import main as jmain
    from tendermint_tpu_torch.cli import main as tmain

    homes = {pkg: str(tmp_path / pkg) for pkg in PACKAGES}
    assert tmain(["--home", homes["port"], "init", mode, "--chain-id", "cli-chain", "--key", key]) == 0
    assert jmain(["--home", homes["jax"], "init", mode, "--chain-id", "cli-chain", "--key", key]) == 0
    port, jax = read_back(homes["port"]), read_back(homes["jax"])
    strip = lambda cfg: {**cfg, "base": {**cfg["base"], "home": ""}}  # noqa: E731
    assert strip(port[0]) == strip(jax[0])
    assert port[1]["chain_id"] == "cli-chain" and port[1]["consensus_params"] == jax[1]["consensus_params"]
    if mode == "validator":
        (val,) = port[1]["validators"]
        assert port[2][0] == key and val["pub_key"]["type"] == jax[1]["validators"][0]["pub_key"]["type"]
    else:
        assert port[1]["validators"] == [] and port[2] is None
    tgen = pkg_module("port", "types.genesis").GenesisDoc.from_file(os.path.join(homes["port"], "config",
                                                                                 "genesis.json"))
    assert json.loads(tgen.to_json()) == port[1]


@pytest.mark.parametrize("key", ["ed25519", "sr25519", "secp256k1"])
def test_cli_testnet_files_read_by_the_reference(tmp_path, key):
    """`testnet` writes homes whose config and genesis the reference reads
    back equal to the port's reading, one genesis for all, each validator's
    key in it, every other node a persistent peer."""
    from tendermint_tpu_torch.cli import main as tmain
    from tendermint_tpu_torch.config import load_config as tload

    out = str(tmp_path / "net")
    assert tmain(["testnet", "--validators", "3", "--output", out, "--chain-id", "net-chain", "--key", key,
                  "--starting-port", "30000"]) == 0
    homes = [os.path.join(out, f"node{i}") for i in range(3)]
    backs = [read_back(h) for h in homes]
    gens = {json.dumps(b[1], sort_keys=True) for b in backs}
    assert len(gens) == 1
    (gen,) = [b[1] for b in backs[:1]]
    assert [v["pub_key"]["type"] for v in gen["validators"]] == [AMINO[key]] * 3
    assert [__import__("base64").b64decode(v["pub_key"]["value"]) for v in gen["validators"]] == [
        b[2][1] for b in backs]
    for i, (home, back) in enumerate(zip(homes, backs)):
        assert dataclasses.asdict(tload(home)) == back[0]
        assert back[0]["p2p"]["laddr"] == f"tcp://127.0.0.1:{30000 + 2 * i}"
        assert sorted(back[0]["p2p"]["persistent_peers"].split(",")) == sorted(
            f"{backs[j][3]}@127.0.0.1:{30000 + 2 * j}" for j in range(3) if j != i)


# -- a mixed network over the CLI's homes --------------------------------------

MIXED = ("port", "port", "jax", "jax")
PER_HEIGHT = ("block", "commit", "validators", "block_results", "blockchain")


def _wait(cond, timeout=NET_DEADLINE_S):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.05)
    return False


@pytest.fixture(scope="module")
def mixed_net(tmp_path_factory):
    """Four validators from the port's `testnet`, the first two port Nodes on
    device="cpu", the others the reference's, meshed over TCP; blocks only
    for txs (create_empty_blocks = false), so the chain settles after the
    tx's block and the block that commits its app hash."""
    from test_consensus import fast_params
    from tendermint_tpu.node import Node as JNode
    from tendermint_tpu_torch.cli import main as tmain
    from tendermint_tpu_torch.node import Node as TNode
    from tendermint_tpu_torch.rpc.client import HTTPClient
    from tendermint_tpu_torch.types.genesis import GenesisDoc

    out = str(tmp_path_factory.mktemp("mixed") / "net")
    assert tmain(["testnet", "--validators", "4", "--output", out, "--chain-id", "mixed-chain",
                  "--starting-port", "0"]) == 0
    gen = GenesisDoc.from_file(os.path.join(out, "node0", "config", "genesis.json"))
    gen.consensus_params = fast_params()
    nodes = []
    try:
        for i, pkg in enumerate(MIXED):
            home = os.path.join(out, f"node{i}")
            gen.save_as(os.path.join(home, "config", "genesis.json"))
            cfg = (tconfig if pkg == "port" else jconfig).load_config(home)
            cfg.p2p.laddr = cfg.rpc.laddr = "tcp://127.0.0.1:0"
            cfg.p2p.persistent_peers = ""
            cfg.consensus.create_empty_blocks = False
            nodes.append(TNode(cfg, device="cpu") if pkg == "port" else JNode(cfg))
        for n in nodes:
            n.start()
        for n in nodes:
            for other in nodes:
                if other is not n:
                    n.dial(other)
        assert _wait(lambda: all(len(n.peer_manager.peers()) == 3 for n in nodes)), "the mesh"
        assert _wait(lambda: all(n.block_store.height() >= 1 for n in nodes)), "height 1"
        clients = [HTTPClient("http://%s:%d" % n.rpc_address, timeout=60) for n in nodes]
        tx = b"mixed-key=mixed-value"
        committed = clients[0].call("broadcast_tx_commit", tx=tx.hex())
        assert committed["tx_result"]["code"] == 0, committed
        # settled: every node at the same height, which holds, for a second
        settled = lambda: len({n.block_store.height() for n in nodes}) == 1  # noqa: E731
        assert _wait(lambda: settled() and nodes[0].block_store.height() >= 3
                     and (time.sleep(1.0) or settled())), [n.block_store.height() for n in nodes]
        yield nodes, clients, tx, committed
    finally:
        for n in nodes:
            n.stop()


def test_mixed_network_reaches_height_3(mixed_net):
    nodes, _, _, committed = mixed_net
    heights = {n.block_store.height() for n in nodes}
    assert len(heights) == 1 and heights.pop() >= 3 and int(committed["height"]) >= 1
    hashes = {n.block_store.load_block_meta(2).block_id.hash for n in nodes}
    assert len(hashes) == 1


@pytest.mark.parametrize("route", PER_HEIGHT)
def test_mixed_network_rpc_equal_at_every_height(mixed_net, route):
    """Each route gives equal JSON from every node at every height whose
    canonical commit all hold."""
    nodes, clients, _, _ = mixed_net
    top = min(n.block_store.height() for n in nodes)
    for h in range(1, top):
        params = {"minHeight": h, "maxHeight": h} if route == "blockchain" else {"height": h}
        answers = [c.call(route, **params) for c in clients]
        assert all(a == answers[0] for a in answers[1:]), (route, h)
        if route == "commit":
            assert answers[0]["canonical"] is True


def test_mixed_network_tx_routes_equal(mixed_net):
    """tx, tx_search, abci_query, genesis and consensus_params: equal JSON
    from every node, the committed tx found through each kv index."""
    nodes, clients, tx, committed = mixed_net
    from tendermint_tpu_torch.eventbus.event_bus import tx_hash

    h = tx_hash(tx).hex().upper()
    calls = [("tx", {"hash": h}), ("tx_search", {"query": f"tx.height = {committed['height']}"}),
             ("tx_search", {"query": f"tx.hash = '{h}'"}),
             ("abci_query", {"data": b"mixed-key".hex()}), ("abci_query", {"path": "/val", "data": "00"}),
             ("genesis", {}), ("consensus_params", {"height": 1}), ("consensus_params", {}),
             ("abci_info", {}), ("num_unconfirmed_txs", {})]
    for method, params in calls:
        answers = [c.call(method, **params) for c in clients]
        assert all(a == answers[0] for a in answers[1:]), (method, params, answers)
    assert clients[0].call("tx", hash=h)["tx"] == __import__("base64").b64encode(tx).decode()
    assert clients[2].call("tx_search", query=f"tx.height = {committed['height']}")["total_count"] == "1"


def test_mixed_network_status_equal_but_the_node(mixed_net):
    """status is equal JSON but for the fields that name the node (its ID,
    addresses, moniker, validator key); the channel bytes are equal too,
    state sync's four (0x60-0x63) among them since the port's node opens
    them (A15a)."""
    nodes, clients, _, _ = mixed_net
    answers = [c.call("status") for c in clients]
    for a in answers:
        ni = a["node_info"]
        for k in ("id", "listen_addr", "moniker"):
            ni.pop(k)
        ni["other"].pop("rpc_address")
        a.pop("validator_info")
    port_ch, jax_ch = (bytes.fromhex(answers[i]["node_info"]["channels"]) for i in (0, 2))
    assert port_ch == jax_ch and {0x60, 0x61, 0x62, 0x63} <= set(port_ch)
    assert all(a == answers[0] for a in answers[1:])
    assert answers[0]["sync_info"]["catching_up"] is False
