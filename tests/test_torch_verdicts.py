"""A verifier fault is never a verdict (ROADMAP C6). With both cutovers at 1
and the engine off, so that every commit check of the evidence and light
paths takes the device branch on device="cpu", the device entry points
(the bitmaps, the cached bitmaps, the RLCs) made to raise a kernel
wrapper's ValueError, "no kernel for device cpu", as
test_torch_blocksync.py's test_wrapper_value_error_is_no_verdict does:
the error propagates as itself from verify_light_client_attack on a
lunatic attack, from verify_evidence, and from light/verifier.py's
verify_adjacent and verify_non_adjacent, on both planes, where the
reference wraps it as EvidenceVerifyError or ErrInvalidHeader. Beside
them, the same calls on a commit with an altered signature, on the same
device branch (the plain versions), still give the reference's error
class and message; the commit checks' host ValueErrors ("nil validator
set") are verdicts too."""

import copy
import re

import pytest
import torch

import chip_smoke as cs
from test_torch_light import chains  # noqa: F401 - the fixture
from test_torch_light import CHAIN_ID as LIGHT_CHAIN_ID
from test_torch_light import JAX as JAX_LIGHT
from test_torch_light_client import CHAIN_ID, HEIGHTS, PACKAGES, build
from tendermint_tpu_torch.crypto import ed25519 as ted
from tendermint_tpu_torch.types import validation as tvalidation

torch.set_num_threads(1)

FAULT = "no kernel for device cpu"
PORT_LIGHT = cs.light_modules()


@pytest.fixture
def device_branch(monkeypatch):
    monkeypatch.setattr(ted, "DEVICE_BATCH_CUTOVER", 1)
    monkeypatch.setattr(ted, "MSM_BATCH_CUTOVER", 1)
    monkeypatch.setenv("TM_TPU_ENGINE", "off")


_LUNATIC = {}


def lunatic(pkg, plane):
    """The package's module namespace, test_torch_light_client's chain on the
    plane, and the light client's evidence against its lunatic witness
    (found on the host route, once)."""
    built = build(plane)
    m, kw = {name: (mod, kw) for name, mod, kw in PACKAGES}[pkg]
    chain = built[pkg]
    if (pkg, plane) not in _LUNATIC:
        witness = cs.chain_provider(m, CHAIN_ID, {**chain.blocks, HEIGHTS: chain.lunatic}, "witness")
        now = m.tmtime.Time(cs.LIGHT_T0 + cs.LIGHT_DT * HEIGHTS + 60)
        trust = m.light.TrustOptions(period_ns=cs.TRUSTING_PERIOD_NS, height=1,
                                     hash=chain.blocks[1].signed_header.hash())
        c = m.light.LightClient(CHAIN_ID, trust, cs.chain_provider(m, CHAIN_ID, chain.blocks, "primary"),
                                witnesses=[witness], clock=lambda: now, **kw)
        assert cs.outcome(lambda: c.verify_light_block_at_height(HEIGHTS))[0] == "ErrLightClientAttack"
        _LUNATIC[pkg, plane] = c.latest_attack_evidence
    return m, chain, copy.deepcopy(_LUNATIC[pkg, plane])


def attack_call(pkg, plane, alter=False):
    """verify_light_client_attack and verify_evidence on the lunatic
    evidence (its conflicting commit's first signature altered where
    `alter`), as calls returning nothing."""
    m, chain, ev = lunatic(pkg, plane)
    if alter:
        sig = ev.conflicting_block.signed_header.commit.signatures[0]
        sig.signature = cs.tamper(sig.signature)
    kw = {"device": "cpu"} if pkg == "port" else {}
    blocks = {h: lb for h, lb in chain.blocks.items() if h <= HEIGHTS}
    node, state = cs.ChainStore(blocks), cs.chain_state(blocks, CHAIN_ID)
    common = chain.blocks[ev.common_height]
    trusted = chain.blocks[ev.conflicting_block.height].signed_header.header
    attack = lambda: m.ev.verify_light_client_attack(ev, common.signed_header.header, trusted, common.validator_set,
                                                     CHAIN_ID, **kw)
    evidence = lambda: m.ev.verify_evidence(ev, state, node, node, **kw)
    return {"verify_light_client_attack": attack, "verify_evidence": evidence}


@pytest.mark.parametrize("plane", cs.PLANES)
@pytest.mark.parametrize("call", ["verify_light_client_attack", "verify_evidence"])
def test_wrapper_value_error_propagates_from_evidence(plane, call, device_branch):
    fn = attack_call("port", plane)[call]
    with cs.failing_entries(FAULT), pytest.raises(ValueError, match=FAULT) as info:
        fn()
    assert type(info.value) is ValueError


@pytest.mark.parametrize("plane", cs.PLANES)
@pytest.mark.parametrize("call", ["verify_light_client_attack", "verify_evidence"])
def test_evidence_verdicts_keep_reference_errors(plane, call, device_branch):
    """The lunatic evidence passes the attack check in both packages; with an
    altered signature in its conflicting commit both refuse it alike."""
    for alter in (False, True):
        got = [cs.outcome(attack_call(pkg, plane, alter)[call]) for pkg in ("port", "jax")]
        assert got[0] == got[1], (alter, got)
    assert got[0][0] == "EvidenceVerifyError" and "verifying conflicting commit" in got[0][1]


def light_call(m, blocks, name, kw, alter=False):
    """verify_adjacent 1 -> 2 or verify_non_adjacent 1 -> last of
    test_torch_light's chain (the untrusted commit's first signature
    altered where `alter`)."""
    top = max(blocks)
    target = 2 if name == "verify_adjacent" else top
    untrusted = copy.deepcopy(blocks[target])
    if alter:
        sig = untrusted.signed_header.commit.signatures[0]
        sig.signature = cs.tamper(sig.signature)
    now = m.tmtime.Time(cs.LIGHT_T0 + cs.LIGHT_DT * (top + 1))
    trusted = blocks[1]
    if name == "verify_adjacent":
        return lambda: m.light.verify_adjacent(LIGHT_CHAIN_ID, trusted.signed_header, untrusted.signed_header,
                                               untrusted.validator_set, cs.TRUSTING_PERIOD_NS, now,
                                               cs.MAX_CLOCK_DRIFT_NS, **kw)
    return lambda: m.light.verify_non_adjacent(LIGHT_CHAIN_ID, trusted.signed_header, trusted.validator_set,
                                               untrusted.signed_header, untrusted.validator_set,
                                               cs.TRUSTING_PERIOD_NS, now, cs.MAX_CLOCK_DRIFT_NS, **kw)


@pytest.mark.parametrize("name", ["verify_adjacent", "verify_non_adjacent"])
def test_wrapper_value_error_propagates_from_light_verifier(chains, name, device_branch):  # noqa: F811
    blocks, _ = chains["port"]
    with cs.failing_entries(FAULT), pytest.raises(ValueError, match=FAULT) as info:
        light_call(PORT_LIGHT, blocks, name, {"device": "cpu"})()
    assert type(info.value) is ValueError


@pytest.mark.parametrize("name", ["verify_adjacent", "verify_non_adjacent"])
def test_light_verdicts_keep_reference_errors(chains, name, device_branch):  # noqa: F811
    got = {}
    for alter in (False, True):
        got[alter] = [cs.outcome(light_call(m, chains[pkg][0], name, kw, alter))
                      for pkg, m, kw in (("port", PORT_LIGHT, {"device": "cpu"}), ("jax", JAX_LIGHT, {}))]
        assert got[alter][0] == got[alter][1], (alter, got[alter])
    assert got[False][0][0] == "accepted"
    assert got[True][0][0] == "ErrInvalidHeader" and "wrong signature (#0)" in got[True][0][1]


def test_nil_validator_set_is_a_verdict():
    """The commit checks' host refusals of their input are
    CommitVerificationError (a ValueError, the reference's class by
    chip_smoke.error_name) with the reference's message."""
    from tendermint_tpu.types import validation as jvalidation

    for v, commit, kw in ((tvalidation, PORT_LIGHT.block.Commit(), {"device": "cpu"}),
                          (jvalidation, JAX_LIGHT.block.Commit(), {})):
        got = [cs.outcome(lambda: v.verify_commit_light_trusting(CHAIN_ID, None, commit, v.Fraction(1, 3), **kw)),
               cs.outcome(lambda: v.verify_commit_light(CHAIN_ID, None, commit.block_id, 0, commit, **kw))]
        assert got == [("ValueError", "nil validator set")] * 2
    assert issubclass(tvalidation.CommitVerificationError, ValueError)
    assert tvalidation.VERDICT_ERRORS == (tvalidation.CommitVerificationError,
                                          tvalidation.NotEnoughVotingPowerError)


# -- the reactors: a gossiped check's fault is no peer's fault -----------------

PEER = "ab" * 20
REACTOR_DEADLINE_S = 20


@pytest.fixture(params=["auto", "off"])
def engine_branch(request, monkeypatch):
    """device_branch's cutovers at 1, with the engine on (auto) or off."""
    monkeypatch.setattr(ted, "DEVICE_BATCH_CUTOVER", 1)
    monkeypatch.setattr(ted, "MSM_BATCH_CUTOVER", 1)
    monkeypatch.setenv("TM_TPU_ENGINE", request.param)
    return request.param


def run_reactor(make, envelopes):
    """A reactor make(channel, peers, on_fatal) started over a stub channel
    that delivers `envelopes`; once its receive loop has taken them all, the
    reactor is stopped and its threads joined (the loop finishes what it
    took first). Returns (what on_fatal got, the peer errors, the reactor)."""
    import time

    fatal = []
    ch = cs.StubChannel(envelopes)
    reactor = make(ch, cs.StubPeers(), fatal.append)
    reactor.start()
    deadline = time.monotonic() + REACTOR_DEADLINE_S
    while ch.inbox and time.monotonic() < deadline:
        time.sleep(0.01)
    reactor.stop()
    for t in reactor._threads:
        t.join(REACTOR_DEADLINE_S)
        assert not t.is_alive()
    return fatal, [(e.node_id, f"{type(e.err).__name__}: {e.err}") for e in ch.errors], reactor


def mempool_reactor(pkg, pool):
    from tendermint_tpu.mempool.reactor import MempoolReactor as JReactor
    from tendermint_tpu_torch.mempool.reactor import MempoolReactor as TReactor

    if pkg == "port":
        return lambda ch, peers, on_fatal: TReactor(pool, ch, peers, on_fatal=on_fatal)
    return lambda ch, peers, on_fatal: JReactor(pool, ch, peers)


def envelope(message):
    from tendermint_tpu_torch.p2p.types import Envelope

    return Envelope(message=message, from_=PEER)


def test_gossiped_admission_fault_reaches_mempool_on_fatal(engine_branch):
    """A frame of signed-tx envelopes gossiped in while the device entry
    points raise a kernel wrapper's ValueError: the mempool reactor hands the
    fault to on_fatal and stops; no peer is reported and nothing admitted;
    the same txs are admitted when submitted again."""
    from test_torch_mempool import App, envelopes
    from tendermint_tpu_torch.abci import types as tabci
    from tendermint_tpu_torch.mempool import mempool as tmempool
    from tendermint_tpu_torch.mempool import preverify as tpreverify

    pool = tmempool.TxMempool(App(tabci), pre_verify=tpreverify.EngineTxPreVerifier(device="cpu"))
    txs = envelopes()
    with cs.failing_entries(FAULT):
        fatal, errors, reactor = run_reactor(mempool_reactor("port", pool), [envelope(txs)])
    assert [f"{type(e).__name__}: {e}" for e in fatal] == [f"ValueError: {FAULT}"]
    assert errors == [] and pool.size() == 0 and reactor.fault is fatal[0] and reactor._stop.is_set()
    codes = [getattr(o, "code", type(o).__name__) for o in pool.check_tx_batch(txs)]
    assert codes == [0, 0, 0, 1, 0, 0, 0, 0, 0, 1, "TxInCacheError"] and pool.size() == 8


def test_gossiped_admission_verdicts_keep_reference_outcomes(engine_branch):
    """Without a fault, the port's reactor treats a frame as the reference's
    does, on the same device branch (the plain versions): a malformed frame
    reports its sender; a tx whose signature fails is refused (code 1) like
    an app's refusal, which reports no peer in the reference either; the
    pool admits the same txs."""
    from test_torch_mempool import App, envelopes
    from tendermint_tpu.abci import types as jabci
    from tendermint_tpu.mempool import mempool as jmempool
    from tendermint_tpu.mempool import preverify as jpreverify
    from tendermint_tpu_torch.abci import types as tabci
    from tendermint_tpu_torch.mempool import mempool as tmempool
    from tendermint_tpu_torch.mempool import preverify as tpreverify
    from tendermint_tpu_torch.mempool.reactor import TXS_FRAME_MAGIC

    got = {}
    for pkg, abci, mp, pv in (("port", tabci, tmempool, tpreverify.EngineTxPreVerifier(device="cpu")),
                              ("jax", jabci, jmempool, jpreverify.EngineTxPreVerifier())):
        pool = mp.TxMempool(App(abci), pre_verify=pv)
        fatal, errors, _ = run_reactor(mempool_reactor(pkg, pool),
                                       [envelope(envelopes()), envelope(TXS_FRAME_MAGIC + b"\x05\x01")])
        got[pkg] = (fatal, errors, sorted(pool.reap_max_txs(-1)))
    assert got["port"] == got["jax"]
    assert got["port"][1] == [(PEER, "ValueError: truncated Txs frame")] and len(got["port"][2]) == 8


def evidence_reactor(pkg, plane, device):
    """(make, evidence) for the plane's lunatic evidence: a reactor of the
    package over an EvidencePool on test_torch_light_client's chain."""
    from tendermint_tpu.evidence.pool import EvidencePool as JPool
    from tendermint_tpu.evidence.reactor import EvidenceReactor as JReactor
    from tendermint_tpu_torch.evidence.pool import EvidencePool as TPool
    from tendermint_tpu_torch.evidence.reactor import EvidenceReactor as TReactor

    m, chain, ev = lunatic(pkg, plane)
    blocks = {h: lb for h, lb in chain.blocks.items() if h <= HEIGHTS}

    class Stores(cs.ChainStore):
        def load(self):
            return cs.chain_state(blocks, CHAIN_ID)

    stores = Stores(blocks)
    if pkg == "port":
        pool = TPool(m.kv.MemDB(), stores, stores, device=device)
        return (lambda ch, peers, on_fatal: TReactor(pool, ch, peers, on_fatal=on_fatal)), pool, ev
    pool = JPool(m.kv.MemDB(), stores, stores)
    return (lambda ch, peers, on_fatal: JReactor(pool, ch, peers)), pool, ev


@pytest.mark.parametrize("plane", cs.PLANES)
def test_gossiped_evidence_fault_reaches_evidence_on_fatal(plane, engine_branch):
    """Lunatic evidence gossiped in while the device entry points raise: the
    evidence reactor hands the fault to on_fatal and stops, reporting no
    peer (the reference reports the honest sender); the pool holds nothing,
    and takes the same evidence once the card works."""
    make, pool, ev = evidence_reactor("port", plane, "cpu")
    with cs.failing_entries(FAULT):
        fatal, errors, reactor = run_reactor(make, [envelope(ev)])
    assert [f"{type(e).__name__}: {e}" for e in fatal] == [f"ValueError: {FAULT}"]
    assert errors == [] and pool.size() == 0 and reactor.fault is fatal[0]
    pool.add_evidence(ev)
    assert pool.size() == 1


@pytest.mark.parametrize("plane", cs.PLANES)
def test_gossiped_invalid_evidence_evicts_its_sender(plane, engine_branch):
    """Lunatic evidence whose conflicting commit carries an altered signature
    reports its sender in both packages, with the same error; valid evidence
    reports nobody and enters both pools."""
    got = {}
    for pkg in ("port", "jax"):
        make, pool, ev = evidence_reactor(pkg, plane, "cpu")
        bad = copy.deepcopy(ev)
        sig = bad.conflicting_block.signed_header.commit.signatures[0]
        sig.signature = cs.tamper(sig.signature)
        fatal, errors, _ = run_reactor(make, [envelope(bad), envelope(ev)])
        got[pkg] = (fatal, errors, pool.size())
    assert got["port"] == got["jax"]
    (peer, err), = got["port"][1]
    assert peer == PEER and err.startswith("EvidenceVerifyError") and "verifying conflicting commit" in err
    assert got["port"][2] == 1


# -- the RPC's routes (ROADMAP A14a) -------------------------------------------

RPC_DEADLINE_S = 20
# a verifier fault's answer, as the clients render it
FAULT_ANSWER = ("error", -32603, f"RPC error -32603: verifier fault: ValueError: {FAULT}")


class RPC:
    """A package's JSONRPCServer over an RPCEnvironment (a mempool, an event
    bus, an evidence pool), served on an ephemeral port; `on_fatal` records
    what the environment hands it (the port's only). call(method, **params)
    -> ("result", result) or ("error", code, message)."""

    def __init__(self, pkg, mempool=None, evidence_pool=None):
        mods = {"port": "tendermint_tpu_torch", "jax": "tendermint_tpu"}
        import importlib

        rpc = importlib.import_module(mods[pkg] + ".rpc")
        self.client_mod = importlib.import_module(mods[pkg] + ".rpc.client")
        bus = importlib.import_module(mods[pkg] + ".eventbus").EventBus()
        self.fatal = []
        kw = {"on_fatal": self.fatal.append} if pkg == "port" else {}
        env = rpc.RPCEnvironment(chain_id=CHAIN_ID, mempool=mempool, evidence_pool=evidence_pool, event_bus=bus,
                                 **kw)
        self.server = rpc.JSONRPCServer(rpc.build_routes(env), event_bus=bus)
        self.server.start()
        host, port = self.server.address
        self.client = self.client_mod.HTTPClient(f"http://{host}:{port}", timeout=RPC_DEADLINE_S)

    def call(self, method, **params):
        try:
            return ("result", self.client.call(method, **params))
        except self.client_mod.RPCClientError as e:
            return ("error", e.code, str(e))

    def close(self):
        self.client.close()
        self.server.stop()


def tx_pool(pkg):
    from test_torch_mempool import App
    from tendermint_tpu.abci import types as jabci
    from tendermint_tpu.mempool import mempool as jmempool
    from tendermint_tpu.mempool import preverify as jpreverify
    from tendermint_tpu_torch.abci import types as tabci
    from tendermint_tpu_torch.mempool import mempool as tmempool
    from tendermint_tpu_torch.mempool import preverify as tpreverify

    if pkg == "port":
        return tmempool.TxMempool(App(tabci), pre_verify=tpreverify.EngineTxPreVerifier(device="cpu"))
    return jmempool.TxMempool(App(jabci), pre_verify=jpreverify.EngineTxPreVerifier())


def wait_for(cond, timeout=RPC_DEADLINE_S):
    import time

    deadline = time.monotonic() + timeout
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.01)
    return cond()


@pytest.mark.parametrize("route", ["broadcast_tx_sync", "broadcast_tx_commit", "broadcast_tx"])
def test_rpc_admission_fault_is_an_internal_error(route, engine_branch):
    """A signed-tx envelope sent to a broadcast route while the device entry
    points raise a kernel wrapper's ValueError: the pre-verifier's marked
    fault is answered -32603, never as a CheckTx code (the reference answers
    code 1), and reaches on_fatal; nothing is admitted, and the same tx is
    admitted once the card works."""
    from test_torch_mempool import envelopes

    tx = envelopes()[0]
    pool = tx_pool("port")
    rpc = RPC("port", mempool=pool)
    try:
        with cs.failing_entries(FAULT):
            got = rpc.call(route, tx=tx.hex(), **({"timeout": 1} if route == "broadcast_tx_commit" else {}))
        assert got == FAULT_ANSWER
        assert [f"{type(e).__name__}: {e}" for e in rpc.fatal] == [f"ValueError: {FAULT}"]
        assert pool.size() == 0
        assert rpc.call("broadcast_tx_sync", tx=tx.hex())[1]["code"] == 0 and pool.size() == 1
    finally:
        rpc.close()


def test_rpc_async_admission_fault_is_an_internal_error(engine_branch):
    """broadcast_tx_async queues a signed-tx envelope (code 0, as in the
    reference); the admitter's batch meets the fault, which reaches on_fatal,
    and every later submission is answered -32603."""
    from test_torch_mempool import envelopes

    txs = envelopes()
    pool = tx_pool("port")
    rpc = RPC("port", mempool=pool)
    try:
        with cs.failing_entries(FAULT):
            got = rpc.call("broadcast_tx_async", tx=txs[0].hex())
            assert got[0] == "result" and got[1]["code"] == 0
            assert wait_for(lambda: rpc.fatal)
        assert [f"{type(e).__name__}: {e}" for e in rpc.fatal] == [f"ValueError: {FAULT}"]
        assert rpc.call("broadcast_tx_async", tx=txs[1].hex()) == FAULT_ANSWER
        assert pool.size() == 0
    finally:
        rpc.close()


@pytest.mark.parametrize("route", ["broadcast_tx_sync", "broadcast_tx_commit", "broadcast_tx_async"])
def test_rpc_admission_verdicts_keep_reference_answers(route, engine_branch):
    """Without a fault, a tampered envelope, an app's refusal, an app's error
    and a duplicate get the reference's answers, JSON for JSON, on the same
    device branch (the plain versions); nothing reaches on_fatal."""
    from test_torch_mempool import envelopes

    txs = envelopes()
    answers = {}
    for pkg in ("port", "jax"):
        pool = tx_pool(pkg)
        rpc = RPC(pkg, mempool=pool)
        try:
            kw = {"timeout": 0.2} if route == "broadcast_tx_commit" else {}
            answers[pkg] = [rpc.call(route, tx=tx.hex(), **kw) for tx in (txs[3], b"bad-plain=1", b"boom=1")]
            answers[pkg].append(rpc.call("broadcast_tx_sync", tx=txs[0].hex()))
            # the admitter takes txs in arrival order: the last one admitted, the others were judged
            assert wait_for(lambda: pool.size() == 1)
            answers[pkg].append(sorted(pool.reap_max_txs(-1)))
            assert rpc.fatal == []
        finally:
            rpc.close()
    assert answers["port"] == answers["jax"]
    if route == "broadcast_tx_sync":
        (_, tampered), (_, refused), (_, failed), (_, admitted), _ = answers["port"]
        assert tampered["code"] != 0 and refused["code"] == 1 and admitted["code"] == 0 and failed == {
            "code": 1, "data": "", "log": "the app failed", "hash": failed["hash"]}


def rpc_evidence(ev):
    """The evidence's protobuf bytes, hex, by its own package's codec."""
    import importlib

    mod = importlib.import_module(type(ev).__module__)
    return mod.evidence_to_proto(ev).encode().hex()


@pytest.mark.parametrize("plane", cs.PLANES)
def test_rpc_evidence_fault_is_an_internal_error(plane, engine_branch):
    """Lunatic evidence sent to broadcast_evidence while the device entry
    points raise: -32603 naming the fault, handed to on_fatal; the pool holds
    nothing, and takes the same evidence once the card works."""
    _, pool, ev = evidence_reactor("port", plane, "cpu")
    rpc = RPC("port", evidence_pool=pool)
    try:
        with cs.failing_entries(FAULT):
            got = rpc.call("broadcast_evidence", evidence=rpc_evidence(ev))
        assert got == FAULT_ANSWER
        assert [f"{type(e).__name__}: {e}" for e in rpc.fatal] == [f"ValueError: {FAULT}"] and pool.size() == 0
        assert rpc.call("broadcast_evidence", evidence=rpc_evidence(ev)) == (
            "result", {"hash": ev.hash().hex().upper()})
    finally:
        rpc.close()


@pytest.mark.parametrize("plane", cs.PLANES)
def test_rpc_invalid_evidence_keeps_reference_answer(plane, engine_branch):
    """Lunatic evidence whose conflicting commit carries an altered signature
    gets the reference's answer (its EvidenceVerifyError as an internal
    error), and valid evidence its hash, in both packages; nothing reaches
    on_fatal."""
    got = {}
    for pkg in ("port", "jax"):
        _, pool, ev = evidence_reactor(pkg, plane, "cpu")
        bad = copy.deepcopy(ev)
        sig = bad.conflicting_block.signed_header.commit.signatures[0]
        sig.signature = cs.tamper(sig.signature)
        rpc = RPC(pkg, evidence_pool=pool)
        try:
            got[pkg] = [rpc.call("broadcast_evidence", evidence=rpc_evidence(e)) for e in (bad, ev)] + [pool.size()]
            assert rpc.fatal == []
        finally:
            rpc.close()
    assert got["port"] == got["jax"]
    (status, code, message), (ok, _), size = got["port"]
    assert (status, code, ok, size) == ("error", -32603, "result", 1) and "verifying conflicting commit" in message


def test_rpc_fault_halts_the_node(tmp_path):
    """Through a started port Node: a marked pre-verifier fault in
    broadcast_tx_sync is answered -32603 and halts the node, its halt
    reason the fault."""
    from test_torch_mempool import envelopes
    from tendermint_tpu_torch.config import load_config
    from tendermint_tpu_torch.node import Node, init_files_home
    from tendermint_tpu_torch.rpc.client import HTTPClient, RPCClientError

    home = str(tmp_path / "home")
    init_files_home(home, chain_id="fault-chain")
    cfg = load_config(home)
    cfg.base.db_backend = "memdb"
    cfg.mempool.precheck_sigs = True
    cfg.p2p.laddr = cfg.rpc.laddr = "tcp://127.0.0.1:0"
    node = Node(cfg, device="cpu")

    def failing(txs):
        raise ValueError(FAULT)

    node.mempool._pre_verify = failing
    node.start()
    try:
        host, port = node.rpc_address
        with pytest.raises(RPCClientError) as err:
            HTTPClient(f"http://{host}:{port}", timeout=RPC_DEADLINE_S).call(
                "broadcast_tx_sync", tx=envelopes()[0].hex())
        assert ("error", err.value.code, str(err.value)) == FAULT_ANSWER
        assert wait_for(lambda: node.halted)
        assert f"{type(node.halt_reason).__name__}: {node.halt_reason}" == f"ValueError: {FAULT}"
    finally:
        if not node.halted:
            node.stop()


# -- the settings no slice covers yet -----------------------------------------


def _home(tmp_path):
    from tendermint_tpu_torch.config import load_config
    from tendermint_tpu_torch.node import init_files_home

    home = str(tmp_path / "home")
    init_files_home(home, chain_id="later-chain")
    cfg = load_config(home)
    cfg.base.db_backend = "memdb"
    cfg.p2p.laddr = cfg.rpc.laddr = "tcp://127.0.0.1:0"
    return cfg


LATER_SETTINGS = [
    ("proxy_app", "builtin:bank", "ROADMAP A15c"),
    # A15a's and A15b's settings, ported since: each is taken now (item None)
    ("proxy_app", "tcp://127.0.0.1:26658", None),
    ("proxy_app", "unix:///tmp/app.sock", None),
    ("proxy_app", "grpc://127.0.0.1:26658", None),
    ("proxy_app", "builtin:kvstore:snapshot=5", None),
    # A14b's settings, ported since: each is taken now (item None)
    ("priv_validator_laddr", "tcp://127.0.0.1:26659", None),
    ("priv_validator_laddr", "grpc://127.0.0.1:26659", None),
    ("tx_index.indexer", "sqlite", None),
    ("tx_index.indexer", "psql", None),
    ("instrumentation.flight_interval", 1.0, None),
    ("statesync.enable", True, None),
]


@pytest.mark.parametrize("key,value,item", LATER_SETTINGS, ids=[f"{k}={v}" for k, v, _ in LATER_SETTINGS])
def test_setting_outside_the_slice_names_its_item(tmp_path, key, value, item):
    """A node configured with a setting the port has not reached raises an
    error naming the item that brings it; nothing is remapped. A14b's and
    A15's settings (item None) are taken since those items were ported: a
    remote signer over a socket or over gRPC serves the node's key, the
    sqlite sink and the flight recorder are built, and the psql sink asks for
    its DSN as the reference's does; an app over tcp://, unix:// or grpc://
    answers through the socket or gRPC client, the builtin kvstore takes
    snapshots at the interval asked, and statesync.enable with no trust hash
    falls back, as the reference's node does, to consensus (a lone
    validator)."""
    from tendermint_tpu_torch.node import Node

    cfg = _home(tmp_path)
    if (key == "priv_validator_laddr" or str(value).startswith(("tcp://", "grpc://"))) and item is None:
        import socket  # a free port: the cases may run at once

        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            value = re.sub(r":2665[89]$", f":{sock.getsockname()[1]}", value)
    if value == "unix:///tmp/app.sock":
        value = f"unix://{tmp_path}/app.sock"
    section, _, attr = key.rpartition(".")
    setattr(getattr(cfg, section) if section else cfg.base, attr, value)
    if item is not None:
        with pytest.raises(NotImplementedError, match=item):
            Node(cfg, device="cpu")
        return
    if key == "tx_index.indexer" and value == "psql":
        with pytest.raises(ValueError, match="requires `psql-conn`"):
            Node(cfg, device="cpu")
        return
    server = None
    if key == "proxy_app" and "://" in value:
        from tendermint_tpu_torch.abci.kvstore import KVStoreApplication

        if value.startswith("grpc://"):
            pytest.importorskip("grpc")
            from tendermint_tpu_torch.abci.grpc import serve_app
        else:
            from tendermint_tpu_torch.abci.socket import serve_app
        app = KVStoreApplication()
        server = serve_app(app, value)
    if key == "priv_validator_laddr":
        from tendermint_tpu_torch.privval import FilePV
        from tendermint_tpu_torch.privval.grpc import GRPCSignerServer
        from tendermint_tpu_torch.privval.remote import SignerServer

        pv = FilePV.load(cfg.priv_validator_key_file, cfg.priv_validator_state_file)
        server = (GRPCSignerServer(pv, "later-chain", value) if value.startswith("grpc://")
                  else SignerServer(value, pv, "later-chain"))  # dials the node's listener until it is up
        server.start()
    try:
        node = Node(cfg, device="cpu")
        node.start()
        try:
            if key == "priv_validator_laddr":
                assert type(node.priv_validator).__name__ == ("GRPCSignerClient" if value.startswith("grpc://")
                                                              else "SignerClient")
                assert node.priv_validator.get_pub_key().bytes() == pv.get_pub_key().bytes()
            elif key == "tx_index.indexer":
                assert [type(s).__name__ for s in node.sql_sinks] == ["SQLSink"]
            elif key == "proxy_app" and "://" in value:
                from tendermint_tpu_torch.abci.types import RequestInfo

                assert type(node.app_client).__name__ == ("GRPCClient" if value.startswith("grpc://")
                                                          else "SocketClient")
                assert wait_for(lambda: node.app_client.info(RequestInfo()).last_block_height >= 1)
                assert app.height >= 1
            elif key == "proxy_app":
                assert node.app_client._app.snapshot_interval == 5
            elif key == "statesync.enable":
                assert node.statesync_reactor is not None
                assert wait_for(lambda: node.block_store.height() >= 1)  # the fallback: consensus
            else:
                assert node.flight_recorder is not None and node.flight_recorder.interval == value
        finally:
            node.stop()
    finally:
        if server is not None:
            server.stop()


@pytest.mark.parametrize("knob", ["TM_E2E_DELAYS_MS", "TM_TPU_LOCKCHECK", "TM_TPU_RACECHECK", "TM_TPU_BYZ",
                                  "TM_TPU_PROF"])
def test_tooling_knob_names_its_item(tmp_path, monkeypatch, knob):
    """The reference's e2e tooling knobs, set, make `start` (and the app
    factory, for the delays) raise, naming the tooling as not queued."""
    from tendermint_tpu_torch import cli

    cfg = _home(tmp_path)
    cfg.save()
    monkeypatch.setenv(knob, '{"check_tx": 1}' if knob == "TM_E2E_DELAYS_MS" else "1")
    with pytest.raises(NotImplementedError, match="tooling, not queued"):
        cli.main(["--home", cfg.base.home, "start"])


# the operator's commands of A14b and the store commands of A15b, ported
# since, and the later items' commands
A14B_COMMANDS = ("reset", "unsafe-reset-all", "inspect", "light", "debug", "replay", "reindex-event", "compact",
                 "wal2json", "json2wal", "config-migrate", "completion", "remote-signer")
A15_COMMANDS = ("rollback", "key-migrate")


@pytest.mark.parametrize("command", sorted(A14B_COMMANDS + A15_COMMANDS + tuple(
    __import__("tendermint_tpu_torch.cli", fromlist=["LATER"]).LATER)))
def test_command_outside_the_slice_names_its_item(command, capsys):
    """Every command of the reference's parser the port has not reached
    exits non-zero, naming its item. A14b's and A15's commands, ported
    since, run the reference's function of their name (`unsafe-reset-all`
    is `reset`'s)."""
    from tendermint_tpu_torch import cli

    if command in A14B_COMMANDS + A15_COMMANDS:
        assert command not in cli.LATER
        sub = next(a for a in cli.build_parser()._actions if a.dest == "command")
        fn = sub.choices[command].get_default("fn")
        assert fn.__name__ == "cmd_" + ("reset" if command == "unsafe-reset-all" else command.replace("-", "_"))
        assert fn.__module__ == "tendermint_tpu_torch.cli"
        return
    argv = {"completion": [], "e2e": ["m.toml"], "e2e-generate": ["--output", "o"], "debug": ["kill"],
            "wal2json": ["w"], "json2wal": ["i", "o"], "remote-signer": ["--addr", "a", "--chain-id", "c"],
            "light": ["c", "http://p"]}.get(command, [])
    assert cli.main([command] + argv) == 2
    assert f"comes with ROADMAP {cli.LATER[command]}" in capsys.readouterr().err
