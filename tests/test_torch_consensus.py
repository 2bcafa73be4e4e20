"""Consensus on one node in the port (consensus/: the state machine, round
state, messages, WAL, ticker and handshake) against the JAX package's.

- The reference's tests/test_consensus.py (the single-validator and
  four-validator threaded runs, the WAL's framing, rotation, repair and
  replay cases, the ticker, vote extensions, the restart checks),
  tests/test_consensus_locking.py (the locking rules) and
  tests/test_handshake.py (the eight handshake cases) run on the port
  (test_torch_refcases). Every threaded case waits on deadlines of its own.
- Each locking scenario runs through both packages with one stepped clock
  (tmtime.Time.now and the node's clock), a WAL on disk and the broadcasts
  collected: the same votes, WAL records and committed blocks, byte for byte.
- chip_smoke.ConsensusNet drives a node of each package through 8 heights
  (4 ed25519 validators with admission batches of signed-tx envelopes at 3,
  5 and 7; 7 sr25519 ones), then phase 14's refusals and restart, one
  memoizing signer and one stepped clock: every height's block, block ID,
  app hash, state_to_json and the node's votes, the WAL file, the refusals'
  verdicts and the handshake's replayed state are equal (the port on
  device="cpu"); a shadow replica holds each height's app hash and state.
- A kernel wrapper's ValueError (or a launch's RuntimeError) at the prevote's
  LastCommit check reaches on_fatal with no nil prevote signed, where the
  reference prevotes nil; a verdict on the same path (an altered LastCommit
  signature, the plain kernels at cutover 1) still prevotes nil.
"""

import contextlib
import json
import dataclasses
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import chip_smoke as cs
import test_consensus_locking as ref_locking
from test_torch_light import Signer, members
from test_torch_refcases import port_copy, reference_cases, run_reference_case
from test_torch_state import JAX as JSTATE
from tendermint_tpu import metrics as jmetrics
from tendermint_tpu.consensus import handshake as jhandshake
from tendermint_tpu.consensus import messages as jmessages
from tendermint_tpu.consensus import round_state as jround_state
from tendermint_tpu.consensus import state as jcstate
from tendermint_tpu.consensus import ticker as jticker
from tendermint_tpu.consensus import wal as jwal
from tendermint_tpu.crypto import ed25519 as jed25519
from tendermint_tpu.crypto import sr25519 as jsr25519
from tendermint_tpu.mempool import mempool as jmempool
from tendermint_tpu.mempool import preverify as jpreverify
from tendermint_tpu.privval import file_pv as jfile_pv
from tendermint_tpu.types import proposal as jproposal
from tendermint_tpu.types import vote_set as jvote_set
from tendermint_tpu.utils import tmtime as jtmtime
from tendermint_tpu_torch.consensus import wal as twal
from tendermint_tpu_torch.crypto import ed25519 as ted
from tendermint_tpu_torch.utils import tmtime as ttmtime

torch.set_num_threads(1)

CHAIN_ID = "consensus-test-chain"
PORT = cs.consensus_modules()
JAX = SimpleNamespace(**vars(JSTATE), metrics=jmetrics, handshake=jhandshake, messages=jmessages,
                      round_state=jround_state, ticker=jticker, wal=jwal, cstate=jcstate, mempool=jmempool,
                      preverify=jpreverify, file_pv=jfile_pv, proposal=jproposal, vote_set=jvote_set,
                      privs={"ed25519": jed25519.Ed25519PrivKey.generate, "sr25519": jsr25519.Sr25519PrivKey})
PACKAGES = (("port", PORT, {"device": "cpu"}), ("jax", JAX, {}))
FAULT = "no kernel for device cpu"


@pytest.mark.parametrize("name,test,kw", reference_cases("test_consensus") + reference_cases("test_consensus_locking")
                         + reference_cases("test_handshake"))
def test_reference_case_on_port(name, test, kw, request):
    run_reference_case(name, test, kw, request)


# -- the locking scenarios through both packages ------------------------------------------


def locking_run(mod, tm, wal, test, where, monkeypatch):
    """Run one scenario of the locking module `mod` with a stepped clock, a
    WAL and collected broadcasts on every Driver it builds; returns each
    Driver's WAL bytes, broadcast votes and stored blocks."""
    clock = cs.SteppedClock(SimpleNamespace(tmtime=tm))
    drivers = []
    real_init = mod.Driver.__init__

    def init(self, *a, **k):
        real_init(self, *a, **k)
        self.cs.now = clock
        self.cs.wal = wal.WAL(os.path.join(where, f"{len(drivers)}.wal"))
        self.sent = []
        self.cs.broadcast = self.sent.append
        drivers.append(self)

    monkeypatch.setattr(mod.Driver, "__init__", init)
    monkeypatch.setattr(tm.Time, "now", staticmethod(clock))
    getattr(mod, test)()
    out = []
    for d in drivers:
        d.cs.wal.close()
        with open(d.cs.wal._path, "rb") as f:
            wal_bytes = f.read()
        votes = [msg.vote.to_proto().encode() for msg in d.sent if hasattr(msg, "vote")]
        store = d.cs.block_store
        out.append((wal_bytes, votes, [store.load_block(h).encode() for h in range(1, store.height() + 1)]))
    return out


@pytest.mark.parametrize("test", sorted(n for n in vars(ref_locking) if n.startswith("test_")))
def test_locking_scenario_matches_reference(test, tmp_path, monkeypatch):
    got = {}
    for pkg, mod, tm, wal in (("port", port_copy("test_consensus_locking"), ttmtime, twal),
                              ("jax", ref_locking, jtmtime, jwal)):
        (tmp_path / pkg).mkdir()
        with monkeypatch.context() as mp:
            got[pkg] = locking_run(mod, tm, wal, test, str(tmp_path / pkg), mp)
    assert got["port"] == got["jax"]
    assert all(w for w, _, _ in got["port"])


# -- the driven node through both packages ------------------------------------------------


SETS = (("ed25519", 4), ("sr25519", 7))


def admissions(kind):
    """ed25519's admission batches at heights 3, 5 and 7: six envelopes,
    six more with the third tampered, two; sr25519 none (the envelope is
    ed25519 only)."""
    if kind != "ed25519":
        return {}
    from tendermint_tpu_torch.mempool.preverify import make_sig_tx

    batch = lambda r, k: [make_sig_tx(bytes([i + 1]) * 32, b"acct-%d=n%d" % (i, r)) for i in range(k)]
    tampered = batch(2, 6)
    tampered[2] = cs.tampered_envelope(tampered[2])
    return {3: ("valid", batch(1, 6), []), 5: ("tampered", tampered, []), 7: ("small", batch(3, 2), [])}


def drive(m, kw, kind, n, sign, where, fault=None, heights=cs.CS_HEIGHTS, route=None):
    """chip_smoke's phase 14 (a)-(d) at n validators on the package m, the
    refusals and the restart after `heights` heights (the refusals inside
    the context route(), where given)."""
    mem = members(kind, n, np.random.default_rng(60 + n))
    gen = cs.cs_genesis(m, mem, CHAIN_ID)
    key = cs.SignerKey(m, mem[cs.node_member(m, gen, mem)], sign)
    clock = cs.SteppedClock(m)
    mem_dbs = lambda: {name: m.kv.MemDB() for name in ("app", "state", "blocks", "evidence")}
    node = cs.cs_node(m, gen, mem_dbs(), key, where, clock, **kw)
    net = cs.ConsensusNet(m, node, mem, sign, CHAIN_ID, clock, shadow=cs.cs_stores(m, gen, mem_dbs(), **kw))
    batches = admissions(kind)
    for h in range(1, heights + 1):
        net.height(h, batches.get(h))
    with route() if route is not None else contextlib.nullcontext():
        seen = net.refusals(fault)
    state, n_blocks, clean_before, clean_after, cs2 = cs.cs_restart(m, net, gen, key, clock, **kw)
    with open(node.wal_path, "rb") as f:
        wal_bytes = f.read()
    cs2.wal.close()
    records = [dict(vars(r), outcomes=[(o.code, o.log) for o in r.outcomes]) for r in net.records]
    return SimpleNamespace(records=records, seen=vars(seen), wal=wal_bytes, node=node, cs2=cs2,
                           restart=(m.state_store.state_to_json(state), state.app_hash, n_blocks, clean_before,
                                    clean_after, cs2.rs.height, cs2.rs.round, node.cs.state.app_hash))


@pytest.mark.parametrize("kind,n", SETS)
def test_driven_node_matches_reference(kind, n, tmp_path):
    sign = Signer()
    out = {}
    for pkg, m, kw in PACKAGES:
        (tmp_path / pkg).mkdir()
        out[pkg] = drive(m, kw, kind, n, sign, str(tmp_path / pkg))
    port, jax = out["port"], out["jax"]
    assert port.records == jax.records
    assert port.seen == jax.seen and port.wal == jax.wal and port.restart == jax.restart
    assert [r["ours"] for r in port.records].count(True) >= 1
    assert port.seen["error"].startswith(f"ValueError: wrong signature (#{port.seen['tamper_index']}):")
    assert port.seen["forged_dropped"] and port.seen["reported"] == [(port.seen["conflict_index"],) * 2]
    state_json, app_hash, n_blocks, clean_before, clean_after, height, round_, node_hash = port.restart
    assert (n_blocks, clean_before, clean_after, height, round_) == (cs.CS_HEIGHTS, False, True, cs.CS_HEIGHTS + 1, 1)
    assert app_hash == node_hash and state_json == port.records[-1]["state"]
    if kind == "ed25519":
        by_height = {r["height"]: r for r in port.records}
        assert [o for o, _ in by_height[5]["outcomes"]] == [0, 0, 1, 0, 0, 0]
        assert by_height[5]["outcomes"][2][1] == "tx signature pre-verification failed"
        assert all(r["mempool"] == 0 for r in port.records) and len(by_height[3]["txs"]) == 6


@pytest.mark.parametrize("exc", [ValueError, RuntimeError])
def test_verifier_fault_at_prevote_reaches_on_fatal(exc, tmp_path, monkeypatch):
    """The port at both cutovers 1 (every LastCommit check on the device
    branch, the plain kernels on the CPU): the altered LastCommit is still a
    verdict (nil prevote); with the device entry points raising, round 1's
    proposal stops the node through on_fatal and no prevote of round 1 is
    signed. The reference reads either error as an invalid block."""
    @contextlib.contextmanager
    def route():
        with monkeypatch.context() as mp:
            mp.setattr(ted, "DEVICE_BATCH_CUTOVER", 1)
            mp.setattr(ted, "MSM_BATCH_CUTOVER", 1)
            mp.setenv("TM_TPU_ENGINE", "off")
            yield

    out = drive(PORT, {"device": "cpu"}, "ed25519", 4, Signer(), str(tmp_path),
                fault=cs.failing_entries(FAULT, exc), heights=4, route=route)
    assert out.seen["error"].startswith(f"ValueError: wrong signature (#{out.seen['tamper_index']}):")
    assert out.seen["fatal"] == [f"{exc.__name__}: {FAULT}"] and out.seen["prevote_r1"] is None
    assert out.node.pv.last_sign_state.round == 0  # nothing signed at round 1
    # the restarted node replays round 1's proposal without the fault: it prevotes it
    assert any(getattr(msg, "vote", None) is not None and msg.vote.round == 1 for msg in out.cs2.out)


def test_handshake_replay_runs_where_asked(tmp_path, monkeypatch):
    """Handshaker(device="cpu") replays through an executor on the CPU (the
    plain kernels at cutover 1); without a card, the default device raises
    on the first device check, as every entry point of the port does."""
    sign = Signer()
    built = drive(PORT, {"device": "cpu"}, "ed25519", 4, sign, str(tmp_path), heights=4)
    node = built.node
    monkeypatch.setattr(ted, "DEVICE_BATCH_CUTOVER", 1)
    monkeypatch.setenv("TM_TPU_ENGINE", "off")
    ran = []
    from tendermint_tpu_torch.ops import verify as tverify

    real = tverify.verify_kernel_cached_split_plain
    monkeypatch.setattr(tverify, "verify_kernel_cached_split_plain", lambda *a, **k: ran.append(1) or real(*a, **k))
    gen = cs.cs_genesis(PORT, members("ed25519", 4, np.random.default_rng(64)), CHAIN_ID)
    for device in ("cpu", None):
        states = PORT.state.StateStore(PORT.kv.MemDB())
        state = PORT.state.make_genesis_state(gen)
        states.save(state)
        kw = {} if device is None else {"device": device}
        h = PORT.handshake.Handshaker(states, state, node.blocks, gen, **kw)
        client = PORT.abci.LocalClient(PORT.kvstore.KVStoreApplication(PORT.kv.MemDB()))
        if device is None and not torch.cuda.is_available():
            with pytest.raises((RuntimeError, ValueError)):
                h.handshake(client)
        else:
            replayed = h.handshake(client)
            assert replayed.app_hash == node.cs.state.app_hash and h.n_blocks == 4
    assert len(ran) == 3


def test_fast_genesis_keeps_its_timeouts():
    """chip_smoke.cs_genesis(fast=True) carries tests/test_consensus.py's
    fast timeouts with bypass_commit_timeout into the node's state."""
    mem = members("ed25519", 4, np.random.default_rng(64))
    for _, m, _ in PACKAGES:
        st = m.state.make_genesis_state(cs.cs_genesis(m, mem, CHAIN_ID, fast=True))
        assert dataclasses.asdict(st.consensus_params.timeout) == cs.CS_FAST_TIMEOUTS


def test_live_run_times_the_node_apart_from_the_network(tmp_path):
    """chip_smoke.live_run (phase 14 (e)) at 4 validators on the CPU: the
    node decides every height through start() and the real ticker, and the
    node's own busy time and the network stand-in's are timed apart, each
    within the run's wall time."""
    mem = members("ed25519", 4, np.random.default_rng(65))
    sign = Signer()
    gen = cs.cs_genesis(PORT, mem, CHAIN_ID + "-live", fast=True)
    key = cs.SignerKey(PORT, mem[cs.node_member(PORT, gen, mem)], sign)
    decided, t0, spent = cs.live_run(PORT, gen, mem, key, sign, CHAIN_ID + "-live", str(tmp_path), heights=3,
                                     device="cpu", timeout=60)
    wall = decided[-1][1] - t0
    assert [h for h, _ in decided[:3]] == [1, 2, 3]
    assert 0 < spent["node"] < wall and 0 < spent["network"] < wall
    assert 0 < spent["node_cpu"] <= spent["node"] and spent["add_vote"] + spent["wal_write"] <= spent["node"]


def test_node_stop_closes_the_wal_only_after_the_consensus_thread_ends(tmp_path, monkeypatch):
    """C7: a node stopped while its consensus thread still handles a message
    (held past ConsensusState.stop's 5 s join) closes its WAL only once the
    thread has ended. No thread meets a closed file, and every record the
    handler wrote after the join gave up is in the WAL."""
    import threading

    from tendermint_tpu_torch.config import load_config
    from tendermint_tpu_torch.node import Node, init_files_home

    home = str(tmp_path / "home")
    init_files_home(home, chain_id="c7-chain")
    cfg = load_config(home)
    cfg.base.db_backend = "memdb"
    cfg.p2p.laddr = cfg.rpc.laddr = "tcp://127.0.0.1:0"
    cfg.rpc.enable = False
    raised = []
    monkeypatch.setattr(threading, "excepthook", lambda a: raised.append(a.exc_value))
    node = Node(cfg, device="cpu")
    node.start()
    cstate = node.consensus
    assert cstate._thread is not None and cstate._thread.is_alive()
    entered, release = threading.Event(), threading.Event()
    records = [twal.TimeoutInfo(0.5, 10**6 + i, 0, 1) for i in range(3)]
    dispatch = cstate._dispatch

    def held(item):
        if item != ("hold",):
            return dispatch(item)
        entered.set()
        release.wait(30)
        for rec in records:  # the message in hand writes after the join gave up
            cstate.wal.write(rec)

    cstate._dispatch = held
    cstate._queue.put(("hold",))
    assert entered.wait(10)
    stopper = threading.Thread(target=node.stop)
    stopper.start()
    stopper.join(30)
    assert not stopper.is_alive()
    assert cstate._thread.is_alive()  # the join timed out with the message in hand
    release.set()
    cstate._thread.join(10)
    assert not cstate._thread.is_alive()
    assert not [e for e in raised if "closed file" in str(e)], raised
    assert raised == []
    assert cstate.wal._f.closed
    with open(cfg.wal_file, "rb") as f:
        docs = [json.loads(p) for _, p in twal.iter_wal_records(f.read())]
    written = [twal._decode_msg(d) for d in docs if d["type"] == "timeout" and d["height"] >= 10**6]
    assert written == records
