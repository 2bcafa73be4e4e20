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
