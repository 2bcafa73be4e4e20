"""The port's light client (light/client.py, store.py, provider.py) and its
key-value store (store/kv.py) against the JAX package's, on the same seeded
chains: chip_smoke.rotation_chain at 6 validators and 12 heights, two of
them swapped out at heights 4, 7 and 10 (so no original validator signs
height 12 and the bisection meets the same exact-third failure as phase
11's 150-validator chain), built by both packages from one memoizing
signer. chip_smoke.client_script (phase 11's calls) runs on both: every
outcome, error class and message, the heights each mode fetches and
persists, the bisection trace, the evidence bytes and the DBLightStore
contents are equal, the port on device="cpu" with the device cutover
lowered to 4 so that its 2/3 commit checks take the device route (the plain
versions) through the engine. The client cases of tests/test_light.py,
rebuilt on these chains at the default cutover, give the reference's
verdicts and messages; MemDB, FileDB and both light stores hold the
reference's bytes."""

import copy
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import chip_smoke as cs
from test_torch_light import JAX as JAX_LIGHT
from test_torch_light import PORT, Signer, members
from tendermint_tpu.evidence import verify as jev
from tendermint_tpu.light import client as jclient
from tendermint_tpu.store import kv as jkv
from tendermint_tpu.types import evidence as jevidence
from tendermint_tpu.types import vote as jvote
from tendermint_tpu_torch.crypto import ed25519 as ted
from tendermint_tpu_torch.metrics import engine_metrics

torch.set_num_threads(1)

CHAIN_ID = "light-client-test-chain"
N_VALS = 6
HEIGHTS = 12
SWAPS = (4, 7, 10)
BACKWARDS_TO = 7

JAX = SimpleNamespace(**vars(JAX_LIGHT), client=jclient, kv=jkv, vote=jvote, evidence=jevidence, ev=jev)
PACKAGES = (("port", PORT, {"device": "cpu"}), ("jax", JAX, {}))


_BUILT = {}


def build(plane):
    """{"port": chain, "jax": chain, "members": the chain's members (kind,
    pub, secret), "sign": the signer} on one plane, built once."""
    if plane not in _BUILT:
        rng = np.random.default_rng(95 if plane == "ed25519" else 96)
        fresh = members(plane, N_VALS + len(SWAPS) * (N_VALS // 3), rng)
        sign = Signer()
        _BUILT[plane] = {name: cs.rotation_chain(m, fresh[:N_VALS], fresh[N_VALS:], sign, CHAIN_ID,
                                                 heights=HEIGHTS, swap_at=SWAPS)
                         for name, m, _ in PACKAGES}
        _BUILT[plane].update(members=fresh, sign=sign)
    return _BUILT[plane]


@pytest.fixture(scope="module", params=cs.PLANES)
def chains(request):
    """{"port": chain, "jax": chain} on one plane, and the plane."""
    return build(request.param), request.param


@pytest.fixture
def device_route(monkeypatch):
    monkeypatch.setattr(ted, "DEVICE_BATCH_CUTOVER", 4)
    monkeypatch.setenv("TM_TPU_CRYPTO", "on")


def _hits():
    return sum(v for _, lb, v in engine_metrics().kernel_launches.samples() if lb["kernel"] == "bitmap_cached")


def test_rotation_chain_matches_reference(chains):
    built, _ = chains
    port, jax = built["port"], built["jax"]
    for h in range(1, HEIGHTS + 1):
        assert port.blocks[h].to_proto().encode() == jax.blocks[h].to_proto().encode(), h
        port.blocks[h].validate_basic(CHAIN_ID)
    for name in ("lunatic", "equivocation"):
        lb, want = getattr(port, name), getattr(jax, name)
        assert lb.to_proto().encode() == want.to_proto().encode(), name
        lb.validate_basic(CHAIN_ID)
        assert lb.signed_header.hash() != port.blocks[HEIGHTS].signed_header.hash()
    assert [v.to_proto().encode() for v in port.votes] == [v.to_proto().encode() for v in jax.votes]
    sets = [port.blocks[h].validator_set for h in (1, 4, 7, 10)]
    addrs = [{v.address for v in s.validators} for s in sets]
    assert not addrs[0] & addrs[3]  # no original validator signs the last height
    assert [len(addrs[i] & addrs[i + 1]) for i in range(3)] == [4, 4, 4]
    # the bisection phase 11 meets on 150 validators: 6 -> 12 fails at exactly a third
    steps, mids = cs.bisection_model(port.blocks, 1, HEIGHTS)
    assert steps == [(1, 12, False), (1, 6, True), (6, 12, False), (6, 9, True), (9, 12, True)]
    assert mids == [6, 9]
    held = sum(v.voting_power for v in sets[1].validators if v.address in addrs[3])
    assert held * 3 == sets[1].total_voting_power()


def test_client_script_matches_reference(chains, device_route):
    """Phase 11's calls on both packages: outcomes, fetched and persisted
    heights, bisection traces, evidence and KV bytes. sr25519 runs the
    DBLightStore pass only, to keep the file near a minute."""
    built, plane = chains
    stores = ("mem", "db") if plane == "ed25519" else ("db",)
    results = {}
    for name, m, kw in PACKAGES:
        outs = []

        def step(label, call, checked, want, outs=outs):
            got = cs.outcome(call)
            outs.append((label, got, len(checked)))
            return got

        before = _hits()
        done = cs.run_script(cs.client_script(m, built[name], CHAIN_ID, stores=stores, backwards_to=BACKWARDS_TO,
                                              **kw), step)
        results[name] = outs, done, _hits() - before
    (outs, done, hits), (jouts, jdone, _) = results["port"], results["jax"]
    assert [o[:2] for o in outs] == [o[:2] for o in jouts]
    assert done["facts"] == jdone["facts"]
    assert [t[:4] for t in done["trace"]] == [t[:4] for t in jdone["trace"]]
    # every 2/3 check of the port ran a cache hit (5 of 6 signatures, at or
    # above the lowered cutover); the trusting checks (3) stayed on the host
    assert hits == sum(o[2] for o in outs)
    facts = done["facts"]
    assert facts["db skipping"][:2] == ([1, 6, 9, 12], [1, 12, 6, 9])
    assert facts["db sequential"][0] == list(range(1, 13))
    assert facts["db backwards"][:2] == ([7, 12], list(range(12, 6, -1)))
    for mode in ("skipping", "sequential", "backwards"):
        kv = facts[f"db {mode} kv"]
        assert [int.from_bytes(k[len(b"light/lb/"):], "big") for k, _ in kv] == facts[f"db {mode}"][0]
        for k, v in kv:
            h = int.from_bytes(k[len(b"light/lb/"):], "big")
            assert v == built["jax"].blocks[h].to_proto().encode()


def _client(m, chain, kw, trusted_at=1, witnesses=(), store=None, primary=None, **options):
    blocks = chain.blocks
    now = m.tmtime.Time(cs.LIGHT_T0 + cs.LIGHT_DT * HEIGHTS + 60)
    primary = primary or cs.chain_provider(m, CHAIN_ID, blocks, "primary")
    trust = m.light.TrustOptions(period_ns=cs.TRUSTING_PERIOD_NS, height=trusted_at,
                                 hash=options.pop("trust_hash", blocks[trusted_at].signed_header.hash()))
    return m.light.LightClient(CHAIN_ID, trust, primary, witnesses=list(witnesses),
                               trusted_store=store if store is not None else m.light.MemLightStore(),
                               clock=lambda: now, **options, **kw), primary


class _Down:
    def light_block(self, height):
        raise ConnectionError("witness down")


def case_update(m, chain, kw):
    c, primary = _client(m, chain, kw)
    lb = c.update()
    return [lb.height, cs.stored_heights(c.store), primary.fetched]


def case_update_at_trusted_height(m, chain, kw):
    """Update at the head: a no-op; a primary that rewrites the trusted
    header: a conflict error, never a silent overwrite."""
    c, _ = _client(m, chain, kw)
    c.verify_light_block_at_height(HEIGHTS)
    same = c.update()
    forged = copy.deepcopy(chain.blocks[HEIGHTS])
    forged.signed_header.header.app_hash = b"\x13" * 32
    c.primary = cs.chain_provider(m, CHAIN_ID, {**chain.blocks, HEIGHTS: forged}, "lying primary")
    return [same.height, cs.outcome(c.update)]


def case_below_trusted_state(m, chain, kw):
    c, primary = _client(m, chain, kw, trusted_at=HEIGHTS)
    c.verify_light_block_at_height(HEIGHTS)
    now = m.tmtime.Time(cs.LIGHT_T0 + cs.LIGHT_DT * HEIGHTS + 60)
    return [cs.outcome(lambda: c._verify_light_block(primary.light_block(1), now))]


def case_witness_down(m, chain, kw):
    honest = cs.chain_provider(m, CHAIN_ID, chain.blocks, "honest witness")
    c, _ = _client(m, chain, kw, witnesses=[_Down(), honest])
    return [c.verify_light_block_at_height(HEIGHTS).height, honest.fetched]


def case_all_witnesses_down(m, chain, kw):
    c, _ = _client(m, chain, kw, witnesses=[_Down(), _Down()])
    return [cs.outcome(lambda: c.verify_light_block_at_height(HEIGHTS)), cs.stored_heights(c.store)]


def case_lagging_witness(m, chain, kw):
    honest = cs.chain_provider(m, CHAIN_ID, chain.blocks, "lagging witness")

    class Lagging:
        calls = 0

        def light_block(self, height):
            self.calls += 1
            if self.calls <= 2:
                raise m.light.provider.ErrLightBlockNotFound(f"no light block at height {height}")
            return honest.light_block(height)

    lagging = Lagging()
    c, _ = _client(m, chain, kw, witnesses=[lagging])
    return [c.verify_light_block_at_height(HEIGHTS).height, lagging.calls]


def case_db_store_restores(m, chain, kw):
    """A second client over the same DB restores its trust without fetching
    the root."""
    db = m.kv.MemDB()
    c, _ = _client(m, chain, kw, store=m.light.DBLightStore(db))
    c.verify_light_block_at_height(HEIGHTS)
    c2, primary2 = _client(m, chain, kw, store=m.light.DBLightStore(db))
    return [c2.latest_trusted().height, primary2.fetched, list(db.iterator())]


def case_sequential_forged_witness(m, chain, kw):
    """Sequential mode with the lunatic witness: the attack is detected after
    all eleven checks, and none of the verified heights is persisted."""
    witness = cs.chain_provider(m, CHAIN_ID, {**chain.blocks, HEIGHTS: chain.lunatic}, "evil witness")
    c, primary = _client(m, chain, kw, witnesses=[witness], verification_mode=m.client.SEQUENTIAL)
    got = cs.outcome(lambda: c.verify_light_block_at_height(HEIGHTS))
    ev = c.latest_attack_evidence
    return [got, cs.stored_heights(c.store), ev.to_proto().encode(), ev.hash(), len(primary.evidence)]


def case_wrong_trust_root(m, chain, kw):
    return [cs.outcome(lambda: _client(m, chain, kw, trust_hash=b"\x01" * 32)),
            cs.outcome(lambda: _client(m, chain, kw, trust_hash=b"\x01" * 31))]


def case_trust_options(m, chain, kw):
    h = chain.blocks[1].signed_header.hash()
    out = []
    for period, height, hash_, level in ((1, 0, h, None), (1, 1, h[:31], None), (0, 1, h, None),
                                         (1, 1, h, m.validation.Fraction(1, 4)),
                                         (1, 1, h, m.validation.Fraction(3, 2)), (1, 1, h, None)):
        extra = {} if level is None else {"trust_level": level}
        out.append(cs.outcome(m.light.TrustOptions(period_ns=period, height=height, hash=hash_, **extra).validate))
    return out


def case_expired_trust_root(m, chain, kw):
    """A sync whose trust root is past its trusting period."""
    c, _ = _client(m, chain, kw)
    late = m.tmtime.Time(cs.LIGHT_T0 + cs.LIGHT_DT * HEIGHTS + 60).add(cs.TRUSTING_PERIOD_NS)
    return [cs.outcome(lambda: c.verify_light_block_at_height(HEIGHTS, now=late)), cs.stored_heights(c.store)]


CASES = {f.__name__[len("case_"):]: f for f in (
    case_update, case_update_at_trusted_height, case_below_trusted_state, case_witness_down,
    case_all_witnesses_down, case_lagging_witness, case_db_store_restores, case_sequential_forged_witness,
    case_wrong_trust_root, case_trust_options, case_expired_trust_root)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_client_case_matches_reference(case):
    """tests/test_light.py's client cases and a few more, on the ed25519
    chain at the default cutover, so every commit check verifies on the
    host (client_script holds the device route on both planes)."""
    built = build("ed25519")
    outs = [CASES[case](m, built[name], kw) for name, m, kw in PACKAGES]
    assert outs[0] == outs[1]
    if case in EXPECTED:
        assert outs[0] == EXPECTED[case]


# what the cases must give, beside giving the reference's
EXPECTED = {
    "update": [12, [1, 6, 9, 12], [1, 0, 6, 9]],
    "below_trusted_state": [("LightClientError", "no trusted state below requested height")],
    "witness_down": [12, [12]],
    "lagging_witness": [12, 3],
}


def _kv_ops(kv, path=None):
    """One sequence of writes on a MemDB (path None) or a FileDB of kv's
    package; returns every read, and the file's bytes."""
    db = kv.MemDB() if path is None else kv.FileDB(str(path))
    reads = []
    for i in (5, 1, 9, 3, 7):
        db.set(b"k%02d" % i, b"v%d" % i * i)
    db.set(b"k03", b"overwritten")
    db.delete(b"k09")
    db.delete(b"absent")
    db.batch().set(b"k00", b"batched").delete(b"k05").set(b"\xff", b"").write()
    reads.append([db.get(k) for k in (b"k00", b"k03", b"k05", b"k09", b"\xff")])
    reads.append([db.has(k) for k in (b"k00", b"k05")])
    for start, end in ((None, None), (b"k01", b"k07"), (b"k02", None), (None, b"k03"), (b"k08", b"k01")):
        reads.append(list(db.iterator(start, end)))
        reads.append(list(db.reverse_iterator(start, end)))
    raw = None
    if path is not None:
        db.close()
        raw = path.read_bytes()
        again = kv.FileDB(str(path))
        reads.append(list(again.iterator()))
        reads.append(again.compact())
        again.close()
        reads.append(path.read_bytes())
        with open(path, "ab") as f:
            f.write(raw[:7])  # a torn tail record
        torn = kv.FileDB(str(path))
        reads.append(list(torn.iterator()))
        torn.close()
        reads.append(path.read_bytes())
    return reads, raw


def test_kv_stores_match_reference(tmp_path):
    assert _kv_ops(PORT.kv) == _kv_ops(JAX.kv)
    port = _kv_ops(PORT.kv, tmp_path / "port" / "db.log")
    jax = _kv_ops(JAX.kv, tmp_path / "jax" / "db.log")
    assert port == jax
    assert port[1] and port[0][-1] == port[0][-3]  # the torn tail was truncated


@pytest.mark.parametrize("kind", ["mem", "memdb", "filedb"])
def test_light_stores_match_reference(kind, tmp_path):
    """MemLightStore and DBLightStore (over MemDB and FileDB): the same
    queries give the reference's heights and LightBlock bytes, and a FileDB
    holds the reference's bytes."""
    built = build("ed25519")
    outs = []
    for name, m, _ in PACKAGES:
        path = tmp_path / name / "light.db"
        if kind == "mem":
            store = m.light.MemLightStore()
        else:
            store = m.light.DBLightStore(m.kv.MemDB() if kind == "memdb" else m.kv.FileDB(str(path)))
        blocks = built[name].blocks
        got = [store.latest_light_block(), store.first_light_block(), store.size()]
        for h in (7, 2, 11, 4, 12, 1, 9):
            store.save_light_block(blocks[h])
        enc = lambda lb: None if lb is None else lb.to_proto().encode()
        got += [enc(store.latest_light_block()), enc(store.first_light_block()), store.size()]
        got += [enc(store.light_block_before(h)) for h in (1, 2, 5, 12, 13)]
        got += [enc(store.light_block(h)) for h in (3, 4)]
        got.append(store.delete_light_blocks_before(4))
        store.prune(3)
        got += [cs.stored_heights(store), store.size()]
        if kind == "filedb":
            store.db.close()
            got.append(path.read_bytes())
        outs.append(got)
    assert outs[0] == outs[1]
    assert outs[0][-3 if kind == "filedb" else -2] == [9, 11, 12]
