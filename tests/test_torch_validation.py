"""The port's slice as a whole: the same validator keys and the same commit
built in both packages, verified by both. Sign bytes and commit hashes are
byte-identical; verify_commit, verify_commit_light and
verify_commit_light_trusting accept in both and reject a tampered
signature or short power with the same error. The port runs its plain
versions on the CPU (device="cpu"); the JAX package takes its direct
dispatch path (TM_TPU_ENGINE=off)."""

import numpy as np
import pytest
import torch

from tendermint_tpu.crypto import ed25519 as jed
from tendermint_tpu.crypto import ed25519_ref as ref
from tendermint_tpu.types import block as jblock
from tendermint_tpu.types import canonical as jcanon
from tendermint_tpu.types import validation as jval
from tendermint_tpu.types import validator_set as jvs
from tendermint_tpu.utils import tmtime as jtime
from tendermint_tpu_torch.crypto import ed25519 as ted
from tendermint_tpu_torch.types import block as tblock
from tendermint_tpu_torch.types import canonical as tcanon
from tendermint_tpu_torch.types import validation as tval
from tendermint_tpu_torch.types import validator_set as tvs
from tendermint_tpu_torch.utils import tmtime as ttime

# The plain versions run many small ops: one intra-op thread per test
# worker keeps parallel workers from oversubscribing the cores.
torch.set_num_threads(1)

CHAIN_ID = "port-test-chain"
HEIGHT = 12
N_VALS = 8


def build(pkg, privs, absent=()):
    """(vals, block_id, commit) of one package from the same keys."""
    ed, block, vs, tm = pkg
    vals = vs.ValidatorSet.new([vs.Validator.new(ed.Ed25519PubKey(p[32:]), 10) for p in privs])
    rng = np.random.default_rng(51)
    bid = block.BlockID(rng.bytes(32), block.PartSetHeader(3, rng.bytes(32)))
    sigs = []
    for i, v in enumerate(vals.validators):
        if i in absent:
            sigs.append(block.CommitSig.new_absent())
        else:
            sigs.append(block.CommitSig.new_commit(v.address, tm.Time(1_700_000_000 + i, 17 * i), b""))
    commit = block.Commit(height=HEIGHT, round=1, block_id=bid, signatures=sigs)
    by_addr = {p[32:]: p for p in privs}
    for i, v in enumerate(vals.validators):
        if i not in absent:
            sigs[i].signature = ref.sign(by_addr[v.pub_key.bytes()], commit.vote_sign_bytes(CHAIN_ID, i))
    return vals, bid, commit


JAX_PKG = (jed, jblock, jvs, jtime)
PORT_PKG = (ted, tblock, tvs, ttime)


@pytest.fixture(scope="module")
def privs():
    rng = np.random.default_rng(50)
    return [ref.gen_privkey(rng.bytes(32)) for _ in range(N_VALS)]


@pytest.fixture
def routed(monkeypatch):
    """Both verifiers on their device paths for batches of 4 or more, the
    RLC phase off (the default cutover of 256 is above these batches)."""
    monkeypatch.setenv("TM_TPU_ENGINE", "off")
    monkeypatch.setenv("TM_TPU_CRYPTO", "on")
    for mod in (jed, ted):
        monkeypatch.setattr(mod, "DEVICE_BATCH_CUTOVER", 4)
    return monkeypatch


def test_sign_bytes_and_hashes_identical(privs):
    jv, jb, jc = build(JAX_PKG, privs, absent={5})
    tv, tb, tc = build(PORT_PKG, privs, absent={5})
    assert [v.address for v in tv.validators] == [v.address for v in jv.validators]
    assert tv.get_proposer().address == jv.get_proposer().address
    assert tv.total_voting_power() == jv.total_voting_power()
    for i in range(N_VALS):
        assert tc.vote_sign_bytes(CHAIN_ID, i) == jc.vote_sign_bytes(CHAIN_ID, i)
        assert tcanon.vote_sign_bytes(CHAIN_ID, tc.get_vote(i)) == jcanon.vote_sign_bytes(CHAIN_ID, jc.get_vote(i))
        assert tc.signatures[i].signature == jc.signatures[i].signature
    assert tc.hash() == jc.hash()


def _call(mod, path, vals, bid, commit, **kw):
    if path == "commit":
        return mod.verify_commit(CHAIN_ID, vals, bid, HEIGHT, commit, **kw)
    if path == "light":
        return mod.verify_commit_light(CHAIN_ID, vals, bid, HEIGHT, commit, **kw)
    return mod.verify_commit_light_trusting(CHAIN_ID, vals, commit, mod.Fraction(2, 3), **kw)


def _outcome(fn):
    try:
        fn()
    except Exception as e:  # the error surface is what is compared
        return type(e).__name__, str(e)
    return "accepted", ""


@pytest.mark.parametrize("tampered", [False, True], ids=["valid", "tampered"])
@pytest.mark.parametrize("path", ["commit", "light", "trusting"])
def test_same_verdict_and_error(privs, routed, path, tampered):
    jv, jb, jc = build(JAX_PKG, privs)
    tv, tb, tc = build(PORT_PKG, privs)
    if tampered:
        for c in (jc, tc):
            sig = c.signatures[2].signature
            c.signatures[2].signature = sig[:40] + bytes([sig[40] ^ 1]) + sig[41:]
    want = _outcome(lambda: _call(jval, path, jv, jb, jc))
    got = _outcome(lambda: _call(tval, path, tv, tb, tc, device="cpu"))
    assert got == want
    if tampered:
        assert got[0] == "ValueError" and got[1].startswith("wrong signature (#2): ")
    else:
        assert got == ("accepted", "")


def test_short_power_same_error(privs, routed):
    absent = {0, 1, 3, 4, 6}
    jv, jb, jc = build(JAX_PKG, privs, absent=absent)
    tv, tb, tc = build(PORT_PKG, privs, absent=absent)
    want = _outcome(lambda: _call(jval, "commit", jv, jb, jc))
    got = _outcome(lambda: _call(tval, "commit", tv, tb, tc, device="cpu"))
    assert got == want
    assert got == ("NotEnoughVotingPowerError",
                   "invalid commit -- insufficient voting power: got 30, needed more than 53")


def test_two_phase_rlc_path(privs, routed):
    """With the RLC cutover lowered on both, phase 1 (RLC) accepts the valid
    commit and phase 2 (bitmap) localizes the tampered one."""
    for mod in (jed, ted):
        routed.setattr(mod, "MSM_BATCH_CUTOVER", 4)
    jv, jb, jc = build(JAX_PKG, privs)
    tv, tb, tc = build(PORT_PKG, privs)
    assert (_outcome(lambda: _call(jval, "commit", jv, jb, jc))
            == _outcome(lambda: _call(tval, "commit", tv, tb, tc, device="cpu")) == ("accepted", ""))
    for c in (jc, tc):
        sig = c.signatures[6].signature
        c.signatures[6].signature = sig[:40] + bytes([sig[40] ^ 1]) + sig[41:]
    want = _outcome(lambda: _call(jval, "commit", jv, jb, jc))
    got = _outcome(lambda: _call(tval, "commit", tv, tb, tc, device="cpu"))
    assert got == want and got[1].startswith("wrong signature (#6): ")


def test_host_path_when_crypto_off(privs, routed):
    routed.setenv("TM_TPU_CRYPTO", "off")
    tv, tb, tc = build(PORT_PKG, privs)
    assert _outcome(lambda: _call(tval, "commit", tv, tb, tc)) == ("accepted", "")
    sig = tc.signatures[1].signature
    tc.signatures[1].signature = sig[:40] + bytes([sig[40] ^ 1]) + sig[41:]
    assert _outcome(lambda: _call(tval, "commit", tv, tb, tc))[1].startswith("wrong signature (#1): ")
