"""The port's votes (types/vote.py), evidence (types/evidence.py) and
evidence verification (evidence/verify.py) against the JAX package's, on
test_torch_light_client's seeded ed25519 chain (6 validators, 12 heights, a
third of the set swapped at 4, 7 and 10) and its forged blocks, built by
both packages from one memoizing signer: Vote, ExtendedCommit and evidence
bytes, sign bytes, hash() (the reference's 31-byte copy of the header hash
included), validate_basic, the byzantine validators of a lunatic, an
equivocation and an amnesia attack in the reference's order,
evidence_from_proto of the reference's bytes, and every verdict, error
class and message of verify_evidence, verify_duplicate_vote and
verify_light_client_attack across the cases of tests/test_evidence.py that
need no node or pool (the stores are chip_smoke.ChainStore stand-ins). The
port's commit checks take the device route (the plain versions) with the
cutover lowered to 4; without CUDA the default device raises."""

import copy
import dataclasses
import hashlib

import pytest
import torch

import chip_smoke as cs
from test_torch_light_client import CHAIN_ID, HEIGHTS, PACKAGES, build
from tendermint_tpu.proto import messages as jpb
from tendermint_tpu_torch.crypto import ed25519 as ted
from tendermint_tpu_torch.metrics import EvidenceMetrics, Registry, evidence_metrics
from tendermint_tpu_torch.proto import messages as tpb
from tendermint_tpu_torch.proto import wire

torch.set_num_threads(1)


_EVIDENCE = {}


def attack_evidence(name):
    """{"port": ev, "jax": ev}: the light client's evidence against the
    lunatic or the equivocating witness, on the host route."""
    if name not in _EVIDENCE:
        built = build("ed25519")
        out = {}
        for pkg, m, _ in PACKAGES:
            chain = built[pkg]
            witness = cs.chain_provider(m, CHAIN_ID, {**chain.blocks, HEIGHTS: getattr(chain, name)}, "witness")
            now = m.tmtime.Time(cs.LIGHT_T0 + cs.LIGHT_DT * HEIGHTS + 60)
            trust = m.light.TrustOptions(period_ns=cs.TRUSTING_PERIOD_NS, height=1,
                                         hash=chain.blocks[1].signed_header.hash())
            c = m.light.LightClient(CHAIN_ID, trust, cs.chain_provider(m, CHAIN_ID, chain.blocks, "primary"),
                                    witnesses=[witness], clock=lambda: now)
            assert cs.outcome(lambda: c.verify_light_block_at_height(HEIGHTS))[0] == "ErrLightClientAttack"
            out[pkg] = c.latest_attack_evidence
        _EVIDENCE[name] = out
    return {k: copy.deepcopy(v) for k, v in _EVIDENCE[name].items()}


def secret_of(address):
    for kind, pub, secret in build("ed25519")["members"]:
        if build_key(kind, pub).address() == address:
            return secret
    raise KeyError(address.hex())


def build_key(kind, pub):
    return cs.light_modules().keys[kind](pub)


OUTSIDER = ("ed25519", bytes(range(32)))


def make_vote(m, height, round_, tag, val_index=0, outsider=False, **fields):
    """A precommit at `height` by validator #val_index of the last set (or by
    an outsider key), for a block ID made from `tag`, signed."""
    built = build("ed25519")
    sign = built["sign"]
    vals = built["port"].blocks[HEIGHTS].validator_set
    if outsider:
        from tendermint_tpu_torch.crypto import ed25519_ref as ref

        pub = ref.gen_privkey(OUTSIDER[1])[32:]
        address, secret = build_key("ed25519", pub).address(), OUTSIDER
    else:
        address = vals.validators[val_index].address
        secret = secret_of(address)
    v = m.vote.Vote(type=m.vote.PRECOMMIT, height=height, round=round_,
                    block_id=m.block.BlockID(cs.tagged(tag, height),
                                             m.block.PartSetHeader(1, cs.tagged(tag + b" parts", height))),
                    timestamp=m.tmtime.Time(cs.LIGHT_T0 + cs.LIGHT_DT * height, 1000 * height),
                    validator_address=address, validator_index=val_index, **fields)
    v.signature = sign([secret], [v.sign_bytes(CHAIN_ID)])[0]
    return v


def both(fn):
    """fn(package name, m, kw) on both packages; the outcomes must be equal.
    Returns the port's."""
    outs = [fn(name, m, kw) for name, m, kw in PACKAGES]
    assert outs[0] == outs[1]
    return outs[0]


def enc(x):
    return x.to_proto().encode()


# -- votes ---------------------------------------------------------------------------


def test_vote_bytes_and_sign_bytes_match_reference():
    def run(name, m, kw):
        out = []
        for h, r, tag, fields in ((HEIGHTS, 0, b"a", {}), (3, 2, b"b", {}),
                                  (5, 1, b"c", {"extension": b"ext", "extension_signature": b"s" * 64})):
            v = make_vote(m, h, r, tag, **fields)
            out += [enc(v), v.sign_bytes(CHAIN_ID), v.extension_sign_bytes(CHAIN_ID), v.is_nil(),
                    enc(m.vote.Vote.from_proto(type(v.to_proto()).decode(enc(v)))), v.to_commit_sig()]
        nil = m.vote.Vote(type=m.vote.PREVOTE, height=4, validator_address=b"\x01" * 20, signature=b"s")
        out += [enc(nil), nil.sign_bytes(CHAIN_ID), nil.is_nil(), enc(m.vote.Vote()), m.vote.Vote().sign_bytes("")]
        return [repr(o) if not isinstance(o, (bytes, bool)) else o for o in out]

    both(run)


def test_vote_validate_basic_and_verify_match_reference():
    def run(name, m, kw):
        good = make_vote(m, HEIGHTS, 0, b"a")
        key = good.validator_address
        vals = build("ed25519")[name].blocks[HEIGHTS].validator_set
        pub = vals.get_by_address(key)[1].pub_key
        variants = [
            {}, {"type": 7}, {"height": -1}, {"round": -1},
            {"block_id": m.block.BlockID(b"\x01" * 31)},
            {"block_id": m.block.BlockID(b"\x01" * 32)},
            {"block_id": m.block.BlockID()},
            {"validator_address": b"\x01" * 19}, {"validator_index": -1}, {"signature": b""},
            {"signature": b"s" * 65}, {"extension": b"x"}, {"extension": b"x", "extension_signature": b"s"},
            {"extension_signature": b"s" * 65}, {"type": m.vote.PREVOTE, "extension": b"x"},
            {"type": m.vote.PREVOTE, "extension_signature": b"s"},
            {"block_id": m.block.BlockID(), "extension_signature": b"s"},
        ]
        out = [cs.outcome(dataclasses.replace(good, **v).validate_basic) for v in variants]
        out.append(cs.outcome(lambda: good.verify(CHAIN_ID, pub)))
        out.append(cs.outcome(lambda: good.verify("other-chain", pub)))
        other = vals.validators[1].pub_key
        out.append(cs.outcome(lambda: good.verify(CHAIN_ID, other)))
        out.append(cs.outcome(lambda: good.verify_with_extension(CHAIN_ID, pub)))
        ext = make_vote(m, HEIGHTS, 0, b"a", extension=b"ext")
        ext.extension_signature = build("ed25519")["sign"]([secret_of(key)], [ext.extension_sign_bytes(CHAIN_ID)])[0]
        out.append(cs.outcome(lambda: ext.verify_with_extension(CHAIN_ID, pub)))
        ext.extension = b"other"
        out.append(cs.outcome(lambda: ext.verify_with_extension(CHAIN_ID, pub)))
        return out

    outs = both(run)
    assert outs[0] == ("accepted", "") and outs[-6:] == [("accepted", ""), ("ValueError", "invalid signature"),
                                                        ("ValueError", "invalid validator address"),
                                                        ("ValueError", "invalid extension signature"),
                                                        ("accepted", ""), ("ValueError", "invalid extension signature")]


def test_extended_commit_and_votes_match_reference():
    """ExtendedCommit / ExtendedCommitSig (the reference's later, effective
    definitions) encode alike, and votes_from_extended_commit rebuilds the
    reference's precommits, absent slots as None."""
    schema = lambda cls: [(f.number, f.ftype, f.name, f.repeated, f.always_emit,
                           f.message_class() and f.message_class().__name__) for f in cls.fields]
    for cls in ("ExtendedCommit", "ExtendedCommitSig", "CanonicalVoteExtension", "DuplicateVoteEvidence",
                "LightClientAttackEvidence", "Evidence", "EvidenceList"):
        assert schema(getattr(tpb, cls)) == schema(getattr(jpb, cls)), cls

    def run(name, m, kw):
        pb = tpb if name == "port" else jpb
        bid = m.block.BlockID(b"\x07" * 32, m.block.PartSetHeader(2, b"\x08" * 32))
        sigs = [pb.ExtendedCommitSig(block_id_flag=2, validator_address=b"\x01" * 20,
                                     timestamp=pb.Timestamp(seconds=5, nanos=6), signature=b"s" * 64,
                                     extension=b"e", extension_signature=b"x" * 64),
                pb.ExtendedCommitSig(block_id_flag=1),
                pb.ExtendedCommitSig(block_id_flag=3, validator_address=b"\x02" * 20,
                                     timestamp=pb.Timestamp(seconds=7), signature=b"t" * 64)]
        ec = pb.ExtendedCommit(height=9, round=1, block_id=bid.to_proto(), extended_signatures=sigs)
        raw = ec.encode()
        votes = m.vote.votes_from_extended_commit(pb.ExtendedCommit.decode(raw))
        return [raw] + [None if v is None else enc(v) for v in votes]

    out = both(run)
    assert out[2] is None and len(out) == 4


# -- evidence types ------------------------------------------------------------------


def test_duplicate_vote_evidence_matches_reference():
    def run(name, m, kw):
        vals = build("ed25519")[name].blocks[HEIGHTS].validator_set
        t = m.tmtime.Time(cs.LIGHT_T0, 5)
        a, b = make_vote(m, HEIGHTS, 0, b"a"), make_vote(m, HEIGHTS, 0, b"b")
        out = []
        for x, y in ((a, b), (b, a)):
            ev = m.evidence.DuplicateVoteEvidence.new(x, y, t, vals)
            out += [enc(ev), ev.hash(), ev.height, ev.abci_height(), repr(ev.time), cs.outcome(ev.validate_basic)]
            raw = m.evidence.evidence_to_proto(ev).encode()
            back = m.evidence.evidence_from_proto(type(m.evidence.evidence_to_proto(ev)).decode(raw))
            out += [raw, enc(back)]
        ev = m.evidence.DuplicateVoteEvidence.new(a, b, t, vals)
        swapped = dataclasses.replace(ev, vote_a=ev.vote_b, vote_b=ev.vote_a)
        same = dataclasses.replace(ev, vote_b=ev.vote_a)
        broken = dataclasses.replace(ev, vote_b=dataclasses.replace(ev.vote_b, signature=b""))
        out += [cs.outcome(x.validate_basic) for x in (swapped, same, broken)]
        out.append(cs.outcome(lambda: m.evidence.DuplicateVoteEvidence.new(None, b, t, vals)))
        out.append(cs.outcome(lambda: m.evidence.DuplicateVoteEvidence.new(
            make_vote(m, HEIGHTS, 0, b"a", outsider=True), b, t, vals)))
        ev.generate_abci(vals.validators[1], vals, m.tmtime.Time(9, 9))
        out += [enc(ev), cs.outcome(lambda: m.evidence.evidence_to_proto(object()))]
        out.append(cs.outcome(lambda: m.evidence.evidence_from_proto(type(m.evidence.evidence_to_proto(ev))())))
        return [repr(o) if isinstance(o, tuple) and o and o[0] == "TypeError" else o for o in out]

    out = both(run)
    assert out[5] == ("accepted", "")


@pytest.mark.parametrize("name", ["lunatic", "equivocation"])
def test_light_client_attack_evidence_matches_reference(name):
    evs = attack_evidence(name)
    built = build("ed25519")

    def run(pkg, m, kw):
        ev = evs[pkg]
        chain = built[pkg]
        raw = m.evidence.evidence_to_proto(ev).encode()
        out = [enc(ev), ev.hash(), ev.height, repr(ev.time), ev.common_height, ev.total_voting_power,
               [v.address for v in ev.byzantine_validators], raw, cs.outcome(ev.validate_basic)]
        # the reference's bytes decode into the port's evidence
        ref_raw = jpb.Evidence.decode(raw).encode() if pkg == "port" else raw
        back = m.evidence.evidence_from_proto(type(m.evidence.evidence_to_proto(ev)).decode(ref_raw))
        out.append(enc(back))
        # hash(): HASH_SIZE - 1 bytes of the header hash, a zero, the zigzag height
        header_hash = ev.conflicting_block.signed_header.header.hash()
        want = hashlib.sha256(header_hash[:31] + b"\x00" + wire.encode_zigzag(ev.common_height)).digest()
        out.append(ev.hash() == want)
        trusted = chain.blocks[HEIGHTS].signed_header
        common = chain.blocks[ev.common_height].validator_set
        out.append(ev.conflicting_header_is_invalid(trusted.header))
        for sh in (trusted, m.light_block.SignedHeader(trusted.header, dataclasses.replace(
                trusted.commit, round=1))):
            out.append([(v.address, v.voting_power) for v in ev.get_byzantine_validators(common, sh)])
        for changes in ({"common_height": 0}, {"common_height": HEIGHTS + 1}, {"total_voting_power": 0},
                        {"conflicting_block": None}):
            out.append(cs.outcome(dataclasses.replace(ev, **changes).validate_basic))
        other = copy.deepcopy(ev)
        other.conflicting_block.signed_header.header.chain_id = "x"
        out.append(cs.outcome(other.validate_basic))
        regen = copy.deepcopy(ev)
        regen.generate_abci(common, trusted, m.tmtime.Time(3, 4))
        out.append(enc(regen))
        return out

    out = both(run)
    assert out[8] == ("accepted", "") and out[10] is True
    byz_lunatic, byz_amnesia = out[12], out[13]
    assert len(byz_lunatic) == 6  # every validator signed both headers
    assert byz_amnesia == ([] if name == "equivocation" else byz_lunatic)
    assert out[11] is (name == "lunatic")


def test_hash_keeps_the_31_byte_copy():
    """A header hash differing only in its last byte gives the same evidence
    hash, as the reference's fixed-array copy does."""
    ev = attack_evidence("lunatic")

    def run(pkg, m, kw):
        e = ev[pkg]
        header = e.conflicting_block.signed_header.header
        real = header.hash()
        e.conflicting_block.signed_header.header.hash = lambda: real[:31] + bytes([real[31] ^ 0xFF])
        return e.hash()

    assert both(run) == attack_evidence("lunatic")["port"].hash()


# -- verification --------------------------------------------------------------------


def _node(m, chain, top=HEIGHTS):
    blocks = {h: lb for h, lb in chain.blocks.items() if h <= top}
    return cs.ChainStore(blocks), cs.chain_state(blocks, CHAIN_ID)


def verify_cases(name, m, kw):
    """Every verify case: [(label, outcome)]."""
    built = build("ed25519")
    chain = built[name]
    V = m.ev
    node, state = _node(m, chain)
    vals = chain.blocks[HEIGHTS].validator_set
    t = chain.blocks[HEIGHTS].signed_header.header.time
    a, b = make_vote(m, HEIGHTS, 0, b"a"), make_vote(m, HEIGHTS, 0, b"b")
    dup = m.evidence.DuplicateVoteEvidence.new(a, b, t, vals)
    lun = attack_evidence("lunatic")[name]
    eq = attack_evidence("equivocation")[name]
    out = []

    def case(label, fn):
        out.append((label, cs.outcome(fn)))

    verify = lambda ev, n=node, s=state: lambda: V.verify_evidence(ev, s, n, n, **kw)
    case("duplicate vote valid", lambda: V.verify_duplicate_vote(dup, CHAIN_ID, vals))
    same = m.evidence.DuplicateVoteEvidence(vote_a=a, vote_b=copy.deepcopy(a), total_voting_power=60,
                                            validator_power=10, timestamp=t)
    case("same block id", lambda: V.verify_duplicate_vote(same, CHAIN_ID, vals))
    bad_sig = copy.deepcopy(dup)
    bad_sig.vote_b.signature = b"\x00" * 64
    case("bad signature", lambda: V.verify_duplicate_vote(bad_sig, CHAIN_ID, vals))
    oa, ob = (make_vote(m, HEIGHTS, 0, tag, outsider=True) for tag in (b"a", b"b"))
    outsider = m.evidence.DuplicateVoteEvidence(vote_a=oa, vote_b=ob, total_voting_power=60, validator_power=10,
                                                timestamp=t)
    case("not a validator", lambda: V.verify_duplicate_vote(outsider, CHAIN_ID, vals))
    case("other chain id", lambda: V.verify_duplicate_vote(dup, "some-other-chain", vals))
    hrs = m.evidence.DuplicateVoteEvidence(vote_a=a, vote_b=make_vote(m, HEIGHTS - 1, 0, b"b"),
                                           total_voting_power=60, validator_power=10, timestamp=t)
    case("h/r/s mismatch", lambda: V.verify_duplicate_vote(hrs, CHAIN_ID, vals))
    two = m.evidence.DuplicateVoteEvidence(vote_a=a, vote_b=make_vote(m, HEIGHTS, 0, b"b", val_index=1),
                                           total_voting_power=60, validator_power=10, timestamp=t)
    case("two validators", lambda: V.verify_duplicate_vote(two, CHAIN_ID, vals))
    case("verify_evidence duplicate vote", verify(dup))
    power = copy.deepcopy(dup)
    power.total_voting_power = 999
    errs = {}

    def abci(ev, key):
        def call():
            try:
                V.verify_evidence(ev, state, node, node, **kw)
            except V.EvidenceABCIError as e:
                errs[key] = e
                raise
        return call

    case("duplicate vote wrong total power", abci(power, "dup"))
    errs["dup"].regenerate()
    case("duplicate vote regenerated", verify(power))
    out.append(("regenerated bytes", enc(power) == enc(dup)))
    stamp = copy.deepcopy(dup)
    stamp.timestamp = m.tmtime.Time(1, 1)
    case("duplicate vote wrong time", verify(stamp))
    expired_state = copy.copy(state)
    expired_state.consensus_params = type(state.consensus_params)(evidence=type(state.consensus_params.evidence)(
        max_age_num_blocks=1, max_age_duration=1, max_bytes=1))
    old = m.evidence.DuplicateVoteEvidence.new(make_vote(m, 2, 0, b"a", val_index=0),
                                               make_vote(m, 2, 0, b"b", val_index=0),
                                               chain.blocks[2].signed_header.header.time,
                                               vals)
    case("expired", verify(old, node, expired_state))
    far = m.evidence.DuplicateVoteEvidence.new(make_vote(m, HEIGHTS + 50, 0, b"a"),
                                               make_vote(m, HEIGHTS + 50, 0, b"b"), t, vals)
    case("unknown height", verify(far))
    invalid = copy.deepcopy(dup)
    invalid.vote_a, invalid.vote_b = invalid.vote_b, invalid.vote_a
    case("votes out of order", verify(invalid))
    case("not evidence", lambda: V.verify_evidence(object(), state, node, node, **kw))

    case("lunatic valid", verify(lun))
    case("equivocation valid", verify(eq))
    tampered = copy.deepcopy(lun)
    tampered.total_voting_power += 7
    case("lunatic tampered total power", abci(tampered, "lca"))
    errs["lca"].regenerate()
    case("lunatic regenerated", verify(tampered))
    for label, change in (("timestamp", lambda e: setattr(e, "timestamp", m.tmtime.Time(5, 5))),
                          ("byzantine dropped", lambda e: e.byzantine_validators.pop()),
                          ("byzantine reordered", lambda e: e.byzantine_validators.reverse()),
                          ("byzantine power", lambda e: setattr(e.byzantine_validators[0], "voting_power", 3))):
        bad = copy.deepcopy(lun)
        change(bad)
        case(f"lunatic {label}", verify(bad))
    rewritten = copy.deepcopy(lun)
    rewritten.conflicting_block.signed_header.header.proposer_address = b"\x01" * 20
    case("header rewritten after signing", verify(rewritten))
    unknown = copy.deepcopy(lun)
    unknown.common_height = HEIGHTS + 100
    case("unknown common height", verify(unknown))
    forged = copy.deepcopy(lun)
    forged.conflicting_block.signed_header.commit.signatures[0].signature = bytes(64)
    case("lunatic forged signature", verify(forged))
    forged_eq = copy.deepcopy(eq)
    forged_eq.conflicting_block.signed_header.commit.signatures[0].signature = bytes(64)
    case("equivocation forged signature", verify(forged_eq))
    common_h = lun.common_height
    common_header = chain.blocks[common_h].signed_header.header
    trusted_header = chain.blocks[HEIGHTS].signed_header.header
    common_vals = chain.blocks[common_h].validator_set
    case("lca other chain id", lambda: V.verify_light_client_attack(
        lun, common_header, trusted_header, common_vals, "some-other-chain", **kw))
    wrong = copy.deepcopy(lun)
    wrong.conflicting_block.signed_header.header.validators_hash = b"\x13" * 32
    case("lca wrong validator hash", lambda: V.verify_light_client_attack(
        wrong, trusted_header, trusted_header, common_vals, CHAIN_ID, **kw))
    honest = copy.deepcopy(eq)
    honest.conflicting_block = copy.deepcopy(chain.blocks[HEIGHTS])
    case("lca equal headers", lambda: V.verify_light_client_attack(
        honest, trusted_header, trusted_header, chain.blocks[HEIGHTS].validator_set, CHAIN_ID, **kw))
    # a node one block behind: the conflicting block is past its head
    behind, behind_state = _node(m, chain, HEIGHTS - 1)
    case("forward lunatic past the head", verify(lun, behind, behind_state))
    future = copy.deepcopy(eq)
    case("forward equivocation past the head", verify(future, behind, behind_state))
    case("lca at a later time than the trusted header", lambda: V.verify_light_client_attack(
        lun, common_header, chain.blocks[HEIGHTS - 1].signed_header.header, common_vals, CHAIN_ID, **kw))
    return out


EXPECTED = {
    "duplicate vote valid": ("accepted", ""),
    "same block id": ("EvidenceVerifyError", "block IDs are the same"),
    "bad signature": ("EvidenceVerifyError", "verifying VoteB: invalid signature"),
    "not a validator": ("EvidenceVerifyError", "was not a validator"),
    "other chain id": ("EvidenceVerifyError", "verifying VoteA: invalid signature"),
    "h/r/s mismatch": ("EvidenceVerifyError", "h/r/s does not match"),
    "two validators": ("EvidenceVerifyError", "validator addresses do not match"),
    "verify_evidence duplicate vote": ("accepted", ""),
    "duplicate vote wrong total power": ("EvidenceABCIError", "ABCI component mismatch"),
    "duplicate vote regenerated": ("accepted", ""),
    "regenerated bytes": True,
    "duplicate vote wrong time": ("EvidenceABCIError", "ABCI component mismatch"),
    "expired": ("EvidenceVerifyError", "too old; min height"),
    "unknown height": ("EvidenceVerifyError", "don't have header at height"),
    "votes out of order": ("EvidenceVerifyError", "invalid evidence: duplicate votes in invalid order"),
    "not evidence": ("AttributeError", ""),
    "lunatic valid": ("accepted", ""),
    "equivocation valid": ("accepted", ""),
    "lunatic tampered total power": ("EvidenceABCIError", "total voting power"),
    "lunatic regenerated": ("accepted", ""),
    "lunatic timestamp": ("EvidenceABCIError", "different time"),
    "lunatic byzantine dropped": ("EvidenceABCIError", "byzantine validators from evidence"),
    "lunatic byzantine reordered": ("EvidenceABCIError", "unexpected byzantine validator address"),
    "lunatic byzantine power": ("EvidenceABCIError", "unexpected byzantine validator power"),
    "header rewritten after signing": ("EvidenceVerifyError", "invalid evidence"),
    "unknown common height": ("EvidenceVerifyError", "common height has to be less than equal"),
    "lunatic forged signature": ("EvidenceVerifyError", "verifying conflicting commit: wrong signature (#0)"),
    "equivocation forged signature": ("EvidenceVerifyError", "verifying conflicting commit: wrong signature (#0)"),
    "lca other chain id": ("EvidenceVerifyError", "verifying conflicting commit"),
    "lca wrong validator hash": ("EvidenceVerifyError", "does not match trusted"),
    "lca equal headers": ("EvidenceVerifyError", "headers are equal"),
    "forward lunatic past the head": ("EvidenceVerifyError", "latest block time is before conflicting block time"),
    "forward equivocation past the head": ("EvidenceVerifyError", "don't have header at height"),
    "lca at a later time than the trusted header": (
        "EvidenceVerifyError", "conflicting block doesn't violate monotonically increasing time"),
}


@pytest.mark.parametrize("route", ["device", "host"])
def test_verify_cases_match_reference(route, monkeypatch):
    """The port on device="cpu", its commit checks on the device route
    (cutover 4: the equivocation checks' 5 signatures) or on the host."""
    if route == "device":
        monkeypatch.setattr(ted, "DEVICE_BATCH_CUTOVER", 4)
    monkeypatch.setenv("TM_TPU_CRYPTO", "on")
    out = both(verify_cases)
    assert [label for label, _ in out] == list(EXPECTED)
    for label, got in out:
        want = EXPECTED[label]
        assert got == want if isinstance(want, bool) else (got[0] == want[0] and want[1] in got[1]), (label, got)


def test_verify_evidence_times_into_metrics():
    """verify_evidence observes every check into EvidenceMetrics, refusals
    included; evidence_metrics() is the process-wide group."""
    built = build("ed25519")
    reg = Registry()
    metrics = EvidenceMetrics(reg)
    m = cs.light_modules()
    node, state = _node(m, built["port"])
    vals = built["port"].blocks[HEIGHTS].validator_set
    t = built["port"].blocks[HEIGHTS].signed_header.header.time
    good = m.evidence.DuplicateVoteEvidence.new(make_vote(m, HEIGHTS, 0, b"a"), make_vote(m, HEIGHTS, 0, b"b"), t,
                                                vals)
    m.ev.verify_evidence(good, state, node, node, metrics=metrics, device="cpu")
    bad = copy.deepcopy(good)
    bad.vote_b.signature = bytes(64)
    with pytest.raises(m.ev.EvidenceVerifyError):
        m.ev.verify_evidence(bad, state, node, node, metrics=metrics, device="cpu")
    assert "tendermint_evidence_verify_seconds_count 2" in reg.gather()
    assert evidence_metrics() is evidence_metrics()
    from tendermint_tpu.metrics import EvidenceMetrics as JEvidenceMetrics
    from tendermint_tpu.metrics import Registry as JRegistry

    jreg, preg = JRegistry(), Registry()
    JEvidenceMetrics(jreg), EvidenceMetrics(preg)
    assert preg.gather() == jreg.gather()


def test_default_device_without_cuda_raises(monkeypatch):
    """With no card, the client's initial trust check and both evidence
    commit checks raise on the default device once they reach the device
    route; nothing falls back to the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("TM_TPU_CRYPTO", "auto")
    monkeypatch.setattr(ted, "DEVICE_BATCH_CUTOVER", 2)
    m = cs.light_modules()
    chain = build("ed25519")["port"]
    trust = m.light.TrustOptions(period_ns=cs.TRUSTING_PERIOD_NS, height=1,
                                 hash=chain.blocks[1].signed_header.hash())
    primary = cs.chain_provider(m, CHAIN_ID, chain.blocks, "primary")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        m.light.LightClient(CHAIN_ID, trust, primary)
    node, state = _node(m, chain)
    for name in ("lunatic", "equivocation"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            m.ev.verify_evidence(attack_evidence(name)["port"], state, node, node)
    # the same calls on device="cpu" verify
    m.light.LightClient(CHAIN_ID, trust, primary, device="cpu")
    m.ev.verify_evidence(attack_evidence("lunatic")["port"], state, node, node, device="cpu")
