"""State sync in the port (statesync/, the kvstore's snapshots, the node's
_run_statesync) held against the JAX package's, on the CPU at a small size.

- A node of one package state-syncs over TCP from a validator of the
  other, through the node's own path: statesync.enable, the validator's
  RPC as the light client's primary (light/http_provider.py), a trust root
  at height 1, the snapshot over the statesync channels, the backfill, the
  tail by blocksync and the tip from the consensus gossip. The state it
  restored equals the one the validator's package builds for the same
  snapshot height (byte for byte in the state store's encoding), its app
  hash and app data equal the validator's, and every block and commit it
  stored equals the validator's. Both directions.
- The syncer's handling of seeded snapshots, chunks and app answers (the
  offer's refusals, CHUNK_RETRY, CHUNK_RETRY_SNAPSHOT, a rejected snapshot,
  a state provider that cannot verify a height, an app hash that does not
  match after the restore) gives the same calls, the same chunk requests and
  the same outcome in both packages.
- chip_smoke.py's phase 18 rehearsed on the CPU: its state-syncing node
  started through the CLI, its app the port's kvstore behind the socket
  server in a process of its own, its launch prediction (none below the
  cutover), then the gRPC replay and the store commands after the stop.
"""

from __future__ import annotations

import importlib
import os
import shutil
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

CHAIN = "ss-cross-chain"
DEADLINE_S = 120
SNAPSHOT_INTERVAL = 3
PKGS = {"ref": "tendermint_tpu", "port": "tendermint_tpu_torch"}


def _wait(cond, timeout=DEADLINE_S):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.05)
    return False


def _mod(pkg, name):
    return importlib.import_module(f"{PKGS[pkg]}.{name}")


def _node(pkg, cfg, **kw):
    return _mod(pkg, "node").Node(cfg, **({"device": "cpu"} if pkg == "port" else {}), **kw)


def _idle_validator(pkg, tmp_path, snapshot_interval=SNAPSHOT_INTERVAL, min_height=8):
    """A one-validator node of `pkg` from the port's `testnet`, its kvstore
    taking snapshots, run past min_height, then idle at its tip (round 0
    waits for txs). A lone validator never starts blocksync, so its reactor
    is started here to serve a joiner's status and block requests, as every
    validator of a network does."""
    from test_consensus import fast_params
    from tendermint_tpu_torch.cli import main as tmain

    out = str(tmp_path / "net")
    assert tmain(["testnet", "--validators", "1", "--output", out, "--chain-id", CHAIN,
                  "--starting-port", "0"]) == 0
    home = os.path.join(out, "node0")
    gen = _mod(pkg, "types.genesis").GenesisDoc.from_file(os.path.join(home, "config", "genesis.json"))
    gen.consensus_params = fast_params()
    gen.save_as(os.path.join(home, "config", "genesis.json"))
    cfg = _mod(pkg, "config").load_config(home)
    cfg.p2p.laddr = cfg.rpc.laddr = "tcp://127.0.0.1:0"
    cfg.base.proxy_app = f"builtin:kvstore:snapshot={snapshot_interval}"
    cfg.save()
    node = _node(pkg, cfg)
    node.start()
    for i in range(3):
        assert node.mempool.check_tx(b"ss-key%d=ss-value%d" % (i, i)).code == 0
    assert _wait(lambda: node.block_store.height() >= min_height)
    node.consensus.wait_for_txs = True
    heights = []
    assert _wait(lambda: heights.append(node.block_store.height()) or (len(heights) > 30 and heights[-1] ==
                                                                       heights[-30]))
    node.blocksync_reactor.start()
    return node, home


def _joiner(pkg, tmp_path, validator, vhome):
    """A full node of `pkg` that state-syncs from `validator` over its RPC
    and p2p; started, dialled to the validator, with the state its
    state sync returned recorded."""
    home = str(tmp_path / "joiner")
    gen = _mod(pkg, "types.genesis").GenesisDoc.from_file(os.path.join(vhome, "config", "genesis.json"))
    _mod(pkg, "node").init_files_home(home, mode="full", gen_doc=gen)
    cfg = _mod(pkg, "config").load_config(home)
    host, port = validator.rpc_address
    cfg.base.mode = "full"
    cfg.base.proxy_app = "kvstore"
    cfg.p2p.laddr = cfg.rpc.laddr = "tcp://127.0.0.1:0"
    cfg.p2p.persistent_peers = ""
    cfg.statesync.enable = True
    cfg.statesync.rpc_servers = f"http://{host}:{port},http://{host}:{port}"
    cfg.statesync.trust_height = 1
    cfg.statesync.trust_hash = validator.block_store.load_block_meta(1).block_id.hash.hex()
    cfg.save()
    node = _node(pkg, cfg)
    restored = []
    sync = node.statesync_reactor.sync

    def recorded(*args, **kw):
        out = sync(*args, **kw)
        restored.append(out)
        return out

    node.statesync_reactor.sync = recorded
    node.start()
    node.dial(validator)
    return node, restored


def _expected_state(pkg, validator, height):
    """The state `pkg`'s own state provider builds for `height` from the
    validator's stores."""
    light = _mod(pkg, "light")
    sp_mod = _mod(pkg, "statesync.stateprovider")
    provider = light.LocalProvider(CHAIN, validator.block_store, validator.state_store)
    lb1 = provider.light_block(1)
    tip = provider.light_block(0).signed_header.header.time.unix_ns()
    clock = _mod(pkg, "utils.tmtime").Time.from_unix_ns(tip + 10**9)
    kw = {"device": "cpu"} if pkg == "port" else {}
    lc = light.LightClient(CHAIN, light.TrustOptions(period_ns=24 * 3600 * 10**9, height=1,
                                                    hash=lb1.signed_header.hash()),
                           provider, clock=lambda: clock, **kw)
    return sp_mod.LightClientStateProvider(lc, validator.gen_doc).state(height)


def _state_bytes(pkg, state):
    kv = _mod(pkg, "store.kv")
    db = kv.MemDB()
    _mod(pkg, "state").StateStore(db).save(state)
    return list(db.iterator(None, None))


def _items(db):
    return list(db.iterator(None, None))


@pytest.mark.parametrize("joiner_pkg,validator_pkg", [("port", "ref"), ("ref", "port")],
                         ids=["port-from-reference", "reference-from-port"])
def test_node_state_syncs_from_the_other_package(tmp_path, joiner_pkg, validator_pkg):
    validator, vhome = _idle_validator(validator_pkg, tmp_path)
    joiner = None
    try:
        tip = validator.block_store.height()
        joiner, restored = _joiner(joiner_pkg, tmp_path, validator, vhome)
        assert _wait(lambda: bool(restored)), "state sync never returned"
        assert _wait(lambda: joiner.block_store.height() == tip and joiner.state_store.load().last_block_height
                     == tip), (joiner.block_store.height(), tip)
        state, commit = restored[0]
        h = state.last_block_height
        assert h % SNAPSHOT_INTERVAL == 0 and SNAPSHOT_INTERVAL <= h < tip
        assert _state_bytes(joiner_pkg, state) == _state_bytes(validator_pkg,
                                                               _expected_state(validator_pkg, validator, h))
        assert commit.to_proto().encode() == validator.block_store.load_block_commit(h).to_proto().encode()
        japp, vapp = joiner.app_client._app, validator.app_client._app
        assert japp.app_hash == vapp.app_hash and japp.height == vapp.height == tip
        assert _items(japp.db) == _items(vapp.db)
        for x in range(h + 1, tip + 1):
            assert joiner.block_store.load_block(x).to_proto().encode() == \
                validator.block_store.load_block(x).to_proto().encode()
        for x in range(1, h + 1):  # the backfill's commits and sets
            assert joiner.block_store.load_seen_commit(x).to_proto().encode() == \
                validator.block_store.load_block_commit(x).to_proto().encode()
            assert joiner.state_store.load_validators(x).hash() == validator.state_store.load_validators(x).hash()
    finally:
        if joiner is not None:
            joiner.stop()
        validator.stop()


# -- the syncer on seeded snapshots, chunks and answers ------------------------------


class _ScriptedApp:
    """An app whose snapshot answers come from a seeded table: the offer's
    result by snapshot, each chunk's result by (snapshot, index, attempt),
    and whether the restored app hash matches; every call recorded."""

    def __init__(self, abci, script, trace):
        self.abci, self.script, self.trace = abci, script, trace
        self.attempts = {}
        self.current = None

    def offer_snapshot(self, req):
        s = req.snapshot
        self.trace.append(("offer", s.height, s.format, s.chunks, req.app_hash))
        self.current = s
        return self.abci.ResponseOfferSnapshot(result=getattr(self.abci, self.script["offer"][s.height]))

    def apply_snapshot_chunk(self, req):
        key = (self.current.height, req.index)
        n = self.attempts[key] = self.attempts.get(key, 0) + 1
        result = self.script["chunks"].get((self.current.height, req.index, n), "CHUNK_ACCEPT")
        self.trace.append(("apply", self.current.height, req.index, req.chunk, req.sender, result))
        if result == "CHUNK_RETRY_SNAPSHOT":
            return self.abci.ResponseApplySnapshotChunk(result=self.abci.CHUNK_RETRY_SNAPSHOT,
                                                        refetch_chunks=[0, 1])
        return self.abci.ResponseApplySnapshotChunk(result=getattr(self.abci, result))

    def info(self, req):
        h = self.current.height
        good = h not in self.script["bad_hash"]
        self.trace.append(("info", h))
        return self.abci.ResponseInfo(last_block_height=h,
                                      last_block_app_hash=b"app%d" % h if good else b"wrong")


class _Provider:
    def __init__(self, script, trace):
        self.script, self.trace = script, trace

    def app_hash(self, h):
        self.trace.append(("app_hash", h))
        if h in self.script["unverifiable"]:
            raise ValueError(f"no light block at {h + 1}")
        return b"app%d" % h

    def state(self, h):
        self.trace.append(("state", h))
        return ("state", h)

    def commit(self, h):
        self.trace.append(("commit", h))
        return ("commit", h)


def _syncer_script(seed):
    """Seeded snapshots from three peers and the answers to give."""
    rng = np.random.default_rng(seed)
    heights = sorted(int(x) for x in rng.choice(np.arange(3, 40, 3), size=4, replace=False))
    peers = ["peer%d" % i for i in range(3)]
    offers = {h: str(rng.choice(["SNAPSHOT_ACCEPT"] * 3 + ["SNAPSHOT_REJECT", "SNAPSHOT_REJECT_FORMAT",
                                                           "SNAPSHOT_ABORT"])) for h in heights}
    chunks = {}
    for h in heights:
        for i in range(3):
            for attempt in (1, 2):
                r = rng.random()
                if r < 0.15:
                    chunks[h, i, attempt] = "CHUNK_RETRY"
                elif r < 0.22:
                    chunks[h, i, attempt] = "CHUNK_RETRY_SNAPSHOT"
                elif r < 0.27:
                    chunks[h, i, attempt] = "CHUNK_REJECT_SNAPSHOT"
    snapshots = [(p, h, 3) for h in heights for p in peers if rng.random() < 0.8] or [(peers[0], heights[0], 3)]
    return {"offer": offers, "chunks": chunks, "snapshots": snapshots,
            "unverifiable": {h for h in heights if rng.random() < 0.2},
            "bad_hash": {h for h in heights if rng.random() < 0.2}}


def _run_syncer(pkg, script):
    abci = _mod(pkg, "abci.types")
    syncer_mod = _mod(pkg, "statesync.syncer")
    trace = []
    syncer = None

    def request_snapshots():
        for peer, h, n in script["snapshots"]:
            added = syncer.add_snapshot(peer, abci.Snapshot(height=h, format=1, chunks=n, hash=b"h%d" % h))
            trace.append(("snapshot", peer, h, added))

    def request_chunk(snapshot, index, peers):
        trace.append(("request", snapshot.height, index, tuple(peers)))
        syncer.add_chunk(index, b"chunk-%d-%d" % (snapshot.height, index), peers[0])

    syncer = syncer_mod.Syncer(_ScriptedApp(abci, script, trace), _Provider(script, trace), request_snapshots,
                               request_chunk)
    syncer.DISCOVERY_WAIT = 0.05
    try:
        outcome = ("synced",) + syncer.sync_any(discovery_time=0.2)
    except syncer_mod.StateSyncError as e:
        outcome = ("error", type(e).__name__, str(e))
    return trace, outcome


@pytest.mark.parametrize("seed", range(12))
def test_syncer_retries_and_rejections_as_the_reference(seed):
    script = _syncer_script(seed)
    ref_trace, ref_outcome = _run_syncer("ref", script)
    port_trace, port_outcome = _run_syncer("port", script)
    assert port_outcome == ref_outcome
    assert port_trace == ref_trace
    assert any(t[0] == "apply" for t in ref_trace) or ref_outcome[0] == "error"


# -- chip_smoke.py's phase 18, rehearsed on the CPU ---------------------------------


def test_phase_18_rehearsed_on_the_cpu(tmp_path, monkeypatch):
    """chip_smoke._statesync_node, then _replay_phase (17 (c) with 18 (b)'s
    gRPC replay) and _store_commands, on a one-validator port chain on the
    CPU whose kvstore takes snapshots: the state-syncing node is started
    through the CLI with its app in a socket-server process; every check is
    below the device cutover, so the prediction is no launch."""
    import chip_smoke as cs
    from tendermint_tpu_torch.rpc.client import HTTPClient

    pytest.importorskip("grpc")
    node, home = _idle_validator("port", tmp_path, snapshot_interval=2, min_height=6)
    url = "http://%s:%d" % node.rpc_address
    client = HTTPClient(url, timeout=60)
    top = node.block_store.height()
    node.app_client._app._snapshots = {h: v for h, v in node.app_client._app._snapshots.items() if h <= top - 2}
    harness = SimpleNamespace(
        blocks={h: node.block_store.load_block(h) for h in range(1, top + 1)},
        replica=SimpleNamespace(states=node.state_store, client=node.app_client))
    rpc = SimpleNamespace(rpc_url=url, rpc=client, home=home, call=client.call)
    monkeypatch.setattr(cs, "CS_VALIDATORS", 1)
    monkeypatch.setattr(cs, "card", lambda: "the CPU")
    logged = []
    monkeypatch.setattr(cs, "log", logged.append)
    P = cs.plane("ed25519")
    where = str(tmp_path / "p18")
    os.makedirs(where)
    assert cs.cli_command(["init", "full", "--chain-id", CHAIN], os.path.join(where, "statesync"))
    node_id = node.node_id
    settings = {"p2p.laddr": "tcp://127.0.0.1:0", "rpc.laddr": "tcp://127.0.0.1:0", "p2p.persistent_peers": "",
                "p2p.bootstrap_peers": "%s@%s:%d" % (node_id, node.p2p_endpoint.host, node.p2p_endpoint.port),
                "instrumentation.prometheus": True, "instrumentation.prometheus_listen_addr": "127.0.0.1:0"}
    procs, seen, totals, runs = [], {}, {}, []
    try:
        ss = cs._statesync_node(cs.cli_modules(), "ed25519", P, CHAIN, node.gen_doc, [rpc, rpc], harness, where,
                                [os.sys.executable, "-m", "tendermint_tpu_torch"], settings, seen, totals, procs)
        status = client.call("status")["sync_info"]
        prediction = cs.replay_prediction(P, harness, top)
    finally:
        node.stop()
        for c in procs:
            c.kill()
    assert all(c.proc.returncode is not None for c in procs)
    cs._replay_phase("ed25519", P, home, status, where, prediction, totals, runs)
    cs._store_commands("ed25519", ss, where)
    assert totals == {} and seen["statesync"]["launches"] == {}
    assert [r["run"] for r in runs] == ["replay as it stands (17 c)", "replay with its state at genesis (17 c)",
                                        "replay with its state at genesis, its app over gRPC (18 b)"]
    text = "\n".join(logged)
    print(text)  # the phase's lines, shown when a check below fails
    assert "predicted to launch {}" in text and "its launches {}, as predicted" in text
    assert text.count(f"replayed to height {top} (app hash {status['latest_app_hash'][:16]})") == 3
    assert f"`rollback`: 'rolled back state to height {top - 1}" in text and "total migrated: 0 keys" in text
    shutil.rmtree(where, ignore_errors=True)
