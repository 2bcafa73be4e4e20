"""The port's light-client slice against the JAX package's: the same seeded
chain (chip_smoke.light_chain at 6 validators and 6 heights, the set
changing once at height 4, and a rival block whose set holds a third of the
trusted power) built by both packages, one signer for both. Header and
validator-set hashes and the Header, Commit, ValidatorSet and LightBlock
proto bytes are equal; every phase 10 (a) case (chip_smoke.light_cases:
adjacent and non-adjacent verification, a forged data_hash, the wrong set,
a tampered signature, an expired trusted header, a set the trusted
validators cannot vouch for) gives the reference's verdict, error class and
message, the port on device="cpu" with the device cutover lowered to 4 so
that its commit checks take the device route (the plain versions) through
the engine; the hash memos are cleared by every mutator and any Header
field write (as the reference's tests/test_hash_cache.py holds them); and
mixed-key commits (ed25519 with secp256k1) give the reference's verdicts and
messages under an ed25519 and a secp256k1 proposer."""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import chip_smoke as cs
from tendermint_tpu import light as JL
from tendermint_tpu.crypto import ed25519 as jed
from tendermint_tpu.crypto import merkle as jmerkle
from tendermint_tpu.crypto import secp256k1 as jsecp
from tendermint_tpu.crypto import sr25519 as jsr
from tendermint_tpu.light import verifier as jverifier
from tendermint_tpu.types import block as jblock
from tendermint_tpu.types import light_block as jlb
from tendermint_tpu.types import validation as jval
from tendermint_tpu.types import validator_set as jvs
from tendermint_tpu.utils import tmtime as jtm
from tendermint_tpu_torch.crypto import ed25519 as ted
from tendermint_tpu_torch.crypto import ed25519_ref as ref
from tendermint_tpu_torch.crypto import secp256k1 as tsecp
from tendermint_tpu_torch.crypto import sr25519 as tsr
from tendermint_tpu_torch.metrics import engine_metrics, hash_metrics
from tendermint_tpu_torch.types import block as tblock
from tendermint_tpu_torch.types import validator_set as tvs
from tendermint_tpu_torch.utils import tmtime as ttm

torch.set_num_threads(1)

CHAIN_ID = "light-test-chain"
N_VALS = 6
HEIGHTS = 6
SWAP_AT = 4

PORT = cs.light_modules()
JAX = SimpleNamespace(
    light=JL, block=jblock, light_block=jlb, validation=jval, vs=jvs, tmtime=jtm, merkle=jmerkle,
    keys={"ed25519": jed.Ed25519PubKey, "sr25519": jsr.Sr25519PubKey,
          "secp256k1": jsecp.Secp256k1PubKey})


class Signer:
    """Signs each (key, message) once: both packages' chains carry the same
    signature bytes even where a signer is randomized."""

    def __init__(self):
        self.memo = {}

    def __call__(self, secrets, msgs):
        return [self.memo.setdefault((kind, seed, m), self.sign(kind, seed, m))
                for (kind, seed), m in zip(secrets, msgs)]

    @staticmethod
    def sign(kind, seed, msg):
        if kind == "ed25519":
            return ref.sign(ref.gen_privkey(seed), msg)
        if kind == "sr25519":
            return tsr.Sr25519PrivKey(seed).sign(msg)
        return tsecp.Secp256k1PrivKey.generate(seed).sign(msg)


def members(kind, n, rng):
    out = []
    for _ in range(n):
        seed = rng.bytes(32)
        if kind == "ed25519":
            pub = ref.gen_privkey(seed)[32:]
        elif kind == "sr25519":
            pub = tsr.Sr25519PrivKey(seed).pub_key().bytes()
        else:
            pub = tsecp.Secp256k1PrivKey.generate(seed).pub_key().bytes()
        out.append((kind, pub, (kind, seed)))
    return out


@pytest.fixture(scope="module", params=cs.PLANES)
def chains(request):
    """{"port": (blocks, rival), "jax": (blocks, rival)} on one plane."""
    rng = np.random.default_rng(91 if request.param == "ed25519" else 92)
    fresh = members(request.param, N_VALS + 1 + N_VALS - N_VALS // 3, rng)
    sign = Signer()
    return {name: cs.light_chain(m, fresh[:N_VALS], [fresh[N_VALS]], fresh[N_VALS + 1:], sign, CHAIN_ID,
                                 heights=HEIGHTS, swap_at=(SWAP_AT,))
            for name, m in (("port", PORT), ("jax", JAX))}


def test_chain_hashes_and_protos_equal(chains):
    (port, rival), (jax, jrival) = chains["port"], chains["jax"]
    assert port[1].validator_set.hash() != port[HEIGHTS].validator_set.hash()  # the set changed
    for h in range(1, HEIGHTS + 1):
        lb, want = port[h], jax[h]
        sh, jsh = lb.signed_header, want.signed_header
        assert sh.header.hash() == jsh.header.hash() == sh.commit.block_id.hash
        assert lb.validator_set.hash() == want.validator_set.hash() == sh.header.validators_hash
        assert sh.commit.hash() == jsh.commit.hash()
        for a, b in ((sh.header, jsh.header), (sh.commit, jsh.commit),
                     (lb.validator_set, want.validator_set), (lb, want)):
            assert a.to_proto().encode() == b.to_proto().encode(), type(a).__name__
        back = PORT.light_block.LightBlock.from_proto(type(lb.to_proto()).decode(want.to_proto().encode()))
        assert back.to_proto().encode() == lb.to_proto().encode()
        assert back.signed_header.header.hash() == sh.header.hash()
        assert back.validator_set.hash() == lb.validator_set.hash()
        lb.validate_basic(CHAIN_ID)
        want.validate_basic(CHAIN_ID)
        if h > 1:
            assert sh.header.last_commit_hash == port[h - 1].signed_header.commit.hash()
    assert rival.to_proto().encode() == jrival.to_proto().encode()


def test_light_cases_match_reference(chains, monkeypatch):
    monkeypatch.setattr(ted, "DEVICE_BATCH_CUTOVER", 4)
    monkeypatch.setenv("TM_TPU_CRYPTO", "on")
    launches = lambda: sum(v for _, lb, v in engine_metrics().kernel_launches.samples()
                           if lb["kernel"] == "bitmap_cached")
    before = launches()
    port = cs.light_cases(PORT, *chains["port"], CHAIN_ID, device="cpu")
    jax = cs.light_cases(JAX, *chains["jax"], CHAIN_ID)
    assert [c[0] for c in port] == [c[0] for c in jax]
    for (label, call, *_, want), (_, jcall, *_) in zip(port, jax):
        got = cs.outcome(call)
        assert got == cs.outcome(jcall), label
        assert got[0] == want[0] and want[1] in got[1], label
    # every accepted case and the tampered signature ran a cached bitmap
    assert launches() - before == sum(c[2] is not None for c in port)


def test_trust_level_and_expiry_match_reference():
    for num, den in ((1, 3), (2, 3), (1, 1), (1, 4), (4, 3), (0, 0), (1, 0)):
        outs = []
        for validate in (PORT.light.validate_trust_level, jverifier.validate_trust_level):
            outs.append(cs.outcome(lambda: validate(PORT.validation.Fraction(num, den))))
        assert outs[0] == outs[1], (num, den)
    rng = np.random.default_rng(93)
    sign = Signer()
    fresh = members("ed25519", N_VALS + 1 + N_VALS - N_VALS // 3, rng)
    blocks, _ = cs.light_chain(PORT, fresh[:N_VALS], [fresh[N_VALS]], fresh[N_VALS + 1:], sign, CHAIN_ID,
                               heights=2, swap_at=(2,))
    jblocks, _ = cs.light_chain(JAX, fresh[:N_VALS], [fresh[N_VALS]], fresh[N_VALS + 1:], sign, CHAIN_ID,
                                heights=2, swap_at=(2,))
    t = blocks[1].signed_header.header.time
    for period, dt in ((10**9, 0), (10**9, 10**9), (10**9, 10**9 - 1), (0, 0), (5, -3)):
        now = t.add(dt)
        assert PORT.light.header_expired(blocks[1].signed_header, period, now) == jverifier.header_expired(
            jblocks[1].signed_header, period, jtm.Time(now.seconds, now.nanos))


# -- the hash memos (the reference's tests/test_hash_cache.py, on the port) -------


def _pk(i):
    return ted.Ed25519PubKey(bytes([i & 0xFF, i >> 8]) + bytes(30))


def _vals(n, power=10):
    return [tvs.Validator.new(_pk(i), power + i) for i in range(n)]


def _reference_hash(vs):
    """What the JAX package hashes for the same validators."""
    return jvs.ValidatorSet(validators=[
        jvs.Validator(v.address, jed.Ed25519PubKey(v.pub_key.bytes()), v.voting_power)
        for v in vs.validators]).hash()


def test_valset_memo_cleared_by_every_mutator():
    vs = tvs.ValidatorSet.new(_vals(10))
    h = vs.hash()
    assert vs._hash_cache == h == _reference_hash(vs) and vs.hash() == h
    for change in ([tvs.Validator.new(_pk(0), 999)], [tvs.Validator.new(_pk(77), 5)],
                   [tvs.Validator(_pk(77).address(), _pk(77), 0)]):
        before = vs.hash()
        vs.update_with_change_set(change)
        assert vs._hash_cache is None
        assert vs.hash() != before and vs.hash() == _reference_hash(vs)
    before = vs.hash()
    vs.increment_proposer_priority(3)
    assert vs._hash_cache is None and vs.hash() == before
    vs.rescale_priorities(1)
    assert vs._hash_cache is None and vs.hash() == before
    c = vs.copy_increment_proposer_priority(2)
    assert c._hash_cache is None and c.hash() == before
    c.update_with_change_set([tvs.Validator.new(_pk(1), 12345)])
    assert c.hash() != before and vs.hash() == before
    assert tvs.ValidatorSet.from_proto(vs.to_proto()).hash() == before


def test_validator_bytes_guard_rechecks_inputs():
    v = tvs.Validator.new(_pk(1), 10)
    b1 = v.bytes()
    assert v.bytes() is b1
    v.voting_power = 11
    b2 = v.bytes()
    assert b2 != b1
    v.pub_key = _pk(2)
    assert v.bytes() != b2
    c = v.copy()
    assert c.bytes() == v.bytes()
    c.voting_power = 99
    assert c.bytes() != v.bytes()
    assert v.bytes() == jvs.Validator.new(jed.Ed25519PubKey(_pk(2).bytes()), 11).bytes()


def _header(pkg, **overrides):
    block, tm = pkg
    kw = dict(chain_id="cache-test", height=7, time=tm.Time(1700000000, 5),
              last_commit_hash=b"\x01" * 32, data_hash=b"\x02" * 32,
              validators_hash=b"\x03" * 32, next_validators_hash=b"\x04" * 32,
              consensus_hash=b"\x05" * 32, app_hash=b"\x06" * 32,
              last_results_hash=b"\x07" * 32, evidence_hash=b"\x08" * 32,
              proposer_address=b"\x09" * 20)
    kw.update(overrides)
    return block.Header(**kw)


def test_header_memo_cleared_by_every_field_write():
    hd = _header((tblock, ttm))
    h = hd.hash()
    assert hd._hash_cache == h == _header((jblock, jtm)).hash() and hd.hash() == h
    mutations = dict(
        version_block=12, version_app=3, chain_id="other", height=8,
        time=(1700000001, 6), last_block_id=b"\x0a" * 32,
        last_commit_hash=b"\x11" * 32, data_hash=b"\x12" * 32,
        validators_hash=b"\x13" * 32, next_validators_hash=b"\x14" * 32,
        consensus_hash=b"\x15" * 32, app_hash=b"\x16" * 32,
        last_results_hash=b"\x17" * 32, evidence_hash=b"\x18" * 32,
        proposer_address=b"\x19" * 20)
    assert set(mutations) == {f.name for f in dataclasses.fields(tblock.Header)}

    def value(pkg, name, raw):
        block, tm = pkg
        if name == "time":
            return tm.Time(*raw)
        return block.BlockID(hash=raw) if name == "last_block_id" else raw

    for name, raw in mutations.items():
        hd = _header((tblock, ttm))
        before = hd.hash()
        setattr(hd, name, value((tblock, ttm), name, raw))
        assert hd._hash_cache is None, name
        after = hd.hash()
        assert after != before, name
        assert after == _header((jblock, jtm), **{name: value((jblock, jtm), name, raw)}).hash(), name
    bare = tblock.Header(chain_id="x", height=1)
    assert bare.hash() is None
    bare.validators_hash = b"\x03" * 32
    assert bare.hash() is not None


def _commit(pkg, n_sigs=2):
    block, tm = pkg
    return block.Commit(height=6, round=0, block_id=block.BlockID(hash=b"\x21" * 32), signatures=[
        block.CommitSig.new_commit(bytes([40 + i]) * 20, tm.Time(1, i), bytes([50 + i]) * 64)
        for i in range(n_sigs)])


def test_commit_memo_rechecks_signatures_and_counts_events():
    count = lambda site, event: sum(v for _, lb, v in hash_metrics().cache_events.samples()
                                    if lb == {"site": site, "event": event})
    c = _commit((tblock, ttm))
    miss0, hit0 = count("commit", "miss"), count("commit", "hit")
    h1 = c.hash()
    assert c.hash() == h1 == _commit((jblock, jtm)).hash()
    assert (count("commit", "miss"), count("commit", "hit")) == (miss0 + 1, hit0 + 1)
    c.signatures.append(tblock.CommitSig.new_commit(b"\x60" * 20, ttm.Time(2, 0), b"\x61" * 64))
    h2 = c.hash()
    want = _commit((jblock, jtm))
    want.signatures.append(jblock.CommitSig.new_commit(b"\x60" * 20, jtm.Time(2, 0), b"\x61" * 64))
    assert h2 != h1 and h2 == want.hash()
    c.signatures = list(c.signatures[:2])
    assert c.hash() == h1
    vs = tvs.ValidatorSet.new(_vals(4))
    inv0 = count("validator_set", "invalidate")
    vs.hash()
    vs.update_with_change_set([tvs.Validator.new(_pk(0), 77)])
    assert count("validator_set", "invalidate") == inv0 + 1


def test_validate_basic_matches_reference():
    """Commit, CommitSig, BlockID and Header validate_basic raise where the
    reference's raise, with its messages."""
    cases = [
        lambda b, tm: b.Commit(height=-1).validate_basic(),
        lambda b, tm: b.Commit(height=2, round=-1).validate_basic(),
        lambda b, tm: b.Commit(height=2).validate_basic(),
        lambda b, tm: b.Commit(height=2, block_id=b.BlockID(hash=b"\x01" * 32)).validate_basic(),
        lambda b, tm: b.Commit(height=2, block_id=b.BlockID(hash=b"\x01" * 32), signatures=[
            b.CommitSig(2, b"\x01" * 19, tm.Time(1, 0), b"s")]).validate_basic(),
        lambda b, tm: b.CommitSig(1, b"\x01" * 20).validate_basic(),
        lambda b, tm: b.CommitSig(5).validate_basic(),
        lambda b, tm: b.CommitSig(2, b"\x01" * 20, tm.Time(1, 0), b"s" * 65).validate_basic(),
        lambda b, tm: b.BlockID(hash=b"\x01" * 31).validate_basic(),
        lambda b, tm: b.PartSetHeader(1, b"\x01" * 33).validate_basic(),
        lambda b, tm: b.Header(chain_id="", height=1).validate_basic(),
        lambda b, tm: b.Header(chain_id="c" * 51, height=1).validate_basic(),
        lambda b, tm: b.Header(chain_id="c", height=0).validate_basic(),
        lambda b, tm: b.Header(chain_id="c", height=1, proposer_address=b"\x01" * 19).validate_basic(),
        lambda b, tm: b.Header(chain_id="c", height=1, proposer_address=b"\x01" * 20).validate_basic(),
    ]
    for i, case in enumerate(cases):
        assert cs.outcome(lambda: case(tblock, ttm)) == cs.outcome(lambda: case(jblock, jtm)), i


# -- mixed key types ------------------------------------------------------------------


@pytest.mark.parametrize("proposer_kind", ["ed25519", "secp256k1"])
def test_mixed_key_commits_match_reference(proposer_kind, monkeypatch):
    """4 ed25519 and 2 secp256k1 validators: under an ed25519 proposer the
    first secp256k1 key leaves the batch and the commit verifies serially,
    under a secp256k1 proposer it never batches; the verdicts and messages
    are the reference's either way."""
    monkeypatch.setattr(ted, "DEVICE_BATCH_CUTOVER", 4)
    monkeypatch.setenv("TM_TPU_CRYPTO", "on")
    rng = np.random.default_rng(94)
    mixed = members("ed25519", 4, rng) + members("secp256k1", 2, rng)
    mixed = [mixed[i] for i in (0, 4, 1, 2, 5, 3)]
    sign = Signer()
    built = {}
    for name, m in (("port", PORT), ("jax", JAX)):
        vals, secrets = cs.light_vals(m, mixed, [k for k, _, _ in mixed].index(proposer_kind))
        bid = m.block.BlockID(b"\x07" * 32, m.block.PartSetHeader(1, b"\x08" * 32))
        built[name] = m, vals, bid, cs.signed_commit(m, vals, secrets, sign, CHAIN_ID, 30, bid,
                                                     cs.LIGHT_T0)
    kinds = [v.pub_key.type_name for v in built["port"][1].validators]
    assert built["port"][1].get_proposer().pub_key.type_name == proposer_kind
    assert built["port"][1].hash() == built["jax"][1].hash()
    for bad in (None, kinds.index("secp256k1", 1), kinds.index("ed25519", 1)):
        outs = []
        for name, (m, vals, bid, commit) in built.items():
            c = commit if bad is None else cs.tampered_commit(m, commit, bad)
            kw = {"device": "cpu"} if name == "port" else {}
            outs.append(cs.outcome(lambda: m.validation.verify_commit(CHAIN_ID, vals, bid, 30, c, **kw)))
        assert outs[0] == outs[1], bad
        assert outs[0][0] == "accepted" if bad is None else outs[0][1].startswith(f"wrong signature (#{bad}):")


def test_helpers_match_reference(chains):
    """tx_hash, txs_hash, cdc_encode, Message.which(), the tmtime helpers
    and ValidatorSet.get_by_index give the reference's values."""
    from tendermint_tpu.proto import messages as jpb
    from tendermint_tpu_torch.proto import messages as tpb

    txs = [b"", b"tx", bytes(range(256)) * 3] + [b"t%d" % i for i in range(20)]
    assert [tblock.tx_hash(t) for t in txs] == [jblock.tx_hash(t) for t in txs]
    for k in (0, 1, 3, 23):
        assert tblock.txs_hash(txs[:k]) == jblock.txs_hash(txs[:k])
    for item in (None, "", "chain", 0, 7, -1, 2**63 - 1, b"", b"\x01" * 32):
        assert tblock.cdc_encode(item) == jblock.cdc_encode(item), item
    lb = chains["port"][0][2]
    for port_msg, ref_cls in ((lb.to_proto(), jpb.LightBlock),
                              (tpb.LightBlock(validator_set=lb.validator_set.to_proto()), jpb.LightBlock),
                              (tpb.LightBlock(), jpb.LightBlock)):
        assert port_msg.which() == ref_cls.decode(port_msg.encode()).which()
    t = ttm.Time(1_700_000_000, 999_999_999)
    for ns in (0, 1, -1, 10**9, -(10**12)):
        moved = t.add(ns)
        want = jtm.Time(t.seconds, t.nanos).add(ns)
        assert (moved.seconds, moved.nanos) == (want.seconds, want.nanos)
        assert moved.sub(t) == ns and moved.unix_ns() == want.unix_ns()
        back = ttm.Time.from_unix_ns(moved.unix_ns())
        assert back == moved and str(back) == str(want)
    assert ttm.Time().is_zero() and not t.is_zero() and ttm.Time.now().unix_ns() > t.unix_ns()
    vals = lb.validator_set
    jvals = chains["jax"][0][2].validator_set
    for i in (-1, 0, len(vals.validators) - 1, len(vals.validators)):
        addr, v = vals.get_by_index(i)
        jaddr, jv = jvals.get_by_index(i)
        assert addr == jaddr and (v is None) == (jv is None)
        if v is not None:
            assert v.to_proto().encode() == jv.to_proto().encode() and v is not vals.validators[i]
