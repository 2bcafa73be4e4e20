"""The port's sr25519 host plane against the JAX package's: keccak-f1600,
Merlin transcripts (scalar and batched), the challenges, the ristretto
codec (RFC 9496 vectors and bad encodings), keys and signature bytes are
equal byte for byte; the batch verifier routes on the CPU; and
verify_commit, verify_commit_light and verify_commit_light_trusting on an
sr25519 validator set give the reference's verdict and `wrong signature
(#i)` index, mixed ed25519/sr25519 sets included. The port runs its plain
versions on the CPU (device="cpu"); the reference verifies these small
commits on its host path."""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from tendermint_tpu.crypto import ed25519 as jed
from tendermint_tpu.crypto import merlin as jmerlin
from tendermint_tpu.crypto import merlin_batch as jmb
from tendermint_tpu.crypto import sr25519 as jsr
from tendermint_tpu.types import block as jblock
from tendermint_tpu.types import validation as jval
from tendermint_tpu.types import validator_set as jvs
from tendermint_tpu.utils import tmtime as jtime
from tendermint_tpu_torch.crypto import batch as tbatch
from tendermint_tpu_torch.crypto import ed25519 as ted
from tendermint_tpu_torch.crypto import ed25519_ref as ref
from tendermint_tpu_torch.crypto import merlin as tmerlin
from tendermint_tpu_torch.crypto import merlin_batch as tmb
from tendermint_tpu_torch.crypto import sr25519 as tsr
from tendermint_tpu_torch.types import block as tblock
from tendermint_tpu_torch.types import validation as tval
from tendermint_tpu_torch.types import validator_set as tvs
from tendermint_tpu_torch.utils import tmtime as ttime

# The plain versions run many small ops: one intra-op thread per test
# worker keeps parallel workers from oversubscribing the cores.
torch.set_num_threads(1)

# RFC 9496 appendix A.2: encodings every ristretto255 decoder rejects
# (non-canonical s, negative s, non-square x^2, negative xy, s = -1).
BAD_ENCODINGS = [
    "00ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff",
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff7f",
    "f3ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff7f",
    "edffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff7f",
    "0100000000000000000000000000000000000000000000000000000000000000",
    "01ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff7f",
    "ed57ffd8c914fb201471d1c3d245ce3c746fcbe63a3679d51b6a516ebebe0e20",
    "26948d35ca62e643e26a83177332e6b6afeb9d08e4268b650f1f5bbd8d81d371",
    "4eac077a713c57b4f4397629a4145982c661f48044dd3f96427d40b147d9742f",
    "3eb858e78f5a7254d8c9731174a94f76755fd3941c0ac93735c07ba14579630e",
    "ecffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff7f",
    "c7176a703d4dd84fba3c0b760d10670f2a2053fa2c39ccc64ec7fd7792ac037a",
]


def test_keccak_and_strobe_match_reference():
    rng = np.random.default_rng(60)
    for _ in range(4):
        lanes = [int(x) for x in rng.integers(0, 2**63, 25, dtype=np.int64)]
        assert tmerlin.keccak_f1600(list(lanes)) == jmerlin.keccak_f1600(list(lanes))
    t, j = tmerlin.Transcript(b"test protocol"), jmerlin.Transcript(b"test protocol")
    for tr in (t, j):
        tr.append_message(b"some label", b"some data")
    assert t.strobe.state == j.strobe.state
    # the merlin crate's published vector
    assert t.challenge_bytes(b"challenge", 32).hex() == (
        "d5a21972d0d5fe320c0d263fac7fffb8145aa640af6e9bca177c03c7efcf0615"
    )
    j.challenge_bytes(b"challenge", 32)
    assert t.strobe.state == j.strobe.state


def test_batch_transcript_matches_reference():
    """The numpy batch transcript, lane by lane, through a squeeze longer
    than the STROBE rate."""
    rng = np.random.default_rng(61)
    data = rng.integers(0, 256, (8, 300), dtype=np.uint8)
    out = []
    for mod, mb in ((tmerlin, tmb), (jmerlin, jmb)):
        prefix = mod.Transcript(b"batch")
        bt = mb.BatchTranscript(prefix, 8)
        bt.append_message(b"data", data)
        bt.append_scalar(b"label", b"x" * 40)
        out.append(bt.challenge_bytes(b"c", 200))
    np.testing.assert_array_equal(out[0], out[1])
    t = tmerlin.Transcript(b"batch")
    t.append_message(b"data", data[3].tobytes())
    t.append_message(b"label", b"x" * 40)
    assert t.challenge_bytes(b"c", 200) == out[0][3].tobytes()


@pytest.fixture(scope="module")
def keys():
    """Seeded mini secrets and both packages' keys from them."""
    rng = np.random.default_rng(62)
    minis = [rng.bytes(32) for _ in range(8)]
    return minis, [tsr.Sr25519PrivKey(m) for m in minis]


def test_keys_and_signatures_match_reference(keys):
    minis, privs = keys
    for i, (mini, priv) in enumerate(zip(minis, privs)):
        jpriv = jsr.Sr25519PrivKey(mini)
        assert priv.pub_key().bytes() == jpriv.pub_key().bytes()
        assert priv.pub_key().address() == jpriv.pub_key().address()
        msg = b"vote-%d" % i
        sig = priv.sign(msg)
        assert sig == jpriv.sign(msg) and sig[63] & 0x80
        bad = sig[:40] + bytes([sig[40] ^ 1]) + sig[41:]
        nomark = sig[:63] + bytes([sig[63] & 0x7F])
        for m, s in ((msg, sig), (msg, bad), (msg, nomark), (msg + b"!", sig)):
            assert tsr.verify(priv.pub_key().bytes(), m, s) == jsr.verify(priv.pub_key().bytes(), m, s)
        assert tsr.verify(priv.pub_key().bytes(), msg, sig) and not tsr.verify(priv.pub_key().bytes(), msg, bad)
    assert tsr.Sr25519PrivKey.generate(b"s").bytes() == jsr.Sr25519PrivKey.generate(b"s").bytes()
    assert tsr._expand_ed25519(minis[0]) == jsr._expand_ed25519(minis[0])


def test_challenges_batch_matches_reference(keys):
    """Lanes grouped by message length: two batched groups and a group of
    fewer than 4 that takes the scalar transcript."""
    _, privs = keys
    pks = [p.pub_key().bytes() for p in privs] * 2
    msgs = [b"M" * 40 + bytes([i]) for i in range(8)] + [b"longer-" + bytes([i]) * 9 for i in range(5)]
    msgs += [b"x", b"yy", b"zz"]
    rng = np.random.default_rng(63)
    r_encs = [rng.bytes(32) for _ in msgs]
    got = tsr.challenges_batch(pks, msgs, r_encs)
    assert got == jsr.challenges_batch(pks, msgs, r_encs)
    for i in (0, 9, 13, 15):
        t = tsr._signing_transcript(msgs[i])
        assert got[i] == tsr._challenge(t, pks[i], r_encs[i])


def test_host_ristretto_codec_matches_reference():
    assert tsr.INVSQRT_A_MINUS_D == jsr.INVSQRT_A_MINUS_D
    assert tsr.ristretto_encode(ref.IDENTITY) == b"\x00" * 32
    assert tsr.ristretto_encode(ref.BASE).hex() == (
        "e2f2ae0a6abc4e71a884a961c500515f58e30b6aa582dd8db6a65945e08d2d76"
    )
    for k in range(1, 17):
        enc = tsr.ristretto_encode(ref.scalar_mult(k, ref.BASE))
        assert enc == jsr.ristretto_encode(ref.scalar_mult(k, ref.BASE))
        assert tsr.ristretto_encode(tsr.ristretto_decode(enc)) == enc
    for h in BAD_ENCODINGS:
        assert tsr.ristretto_decode(bytes.fromhex(h)) is None
        assert jsr.ristretto_decode(bytes.fromhex(h)) is None
    rng = np.random.default_rng(64)
    for _ in range(32):
        b = rng.bytes(32)
        assert tsr.ristretto_decode(b) == jsr.ristretto_decode(b)


def _jobs(privs, tamper=()):
    pks = [p.pub_key() for p in privs]
    msgs = [b"batch-%d" % i for i in range(len(privs))]
    sigs = [p.sign(m) for p, m in zip(privs, msgs)]
    for i in tamper:
        sigs[i] = sigs[i][:5] + bytes([sigs[i][5] ^ 1]) + sigs[i][6:]
    return pks, msgs, sigs


@pytest.mark.parametrize("route", ["host", "bitmap", "uncached", "rlc"])
def test_batch_verifier_routes(keys, monkeypatch, route):
    """Every route of the sr25519 batch verifier on the CPU gives the host
    bitmap: serial host checks, the cached bitmap, the uncached bitmap, and
    the RLC first with the bitmap on failure."""
    _, privs = keys
    monkeypatch.setenv("TM_TPU_CRYPTO", "on")
    monkeypatch.setattr(ted, "DEVICE_BATCH_CUTOVER", 64 if route == "host" else 4)
    monkeypatch.setattr(ted, "MSM_BATCH_CUTOVER", 4 if route == "rlc" else 256)
    monkeypatch.setenv("TM_TPU_PK_CACHE", "off" if route == "uncached" else "on")
    for tamper in ((), (2, 6)):
        bv = tbatch.create_batch_verifier(privs[0].pub_key(), device="cpu")
        assert isinstance(bv, tsr.Sr25519BatchVerifier)
        pks, msgs, sigs = _jobs(privs, tamper)
        for pk, m, s in zip(pks, msgs, sigs):
            bv.add(pk, m, s)
        bits = [i not in tamper for i in range(len(privs))]
        assert bv.verify() == (not tamper, bits)
    with pytest.raises(ValueError, match="pubkey is not sr25519"):
        bv.add(ted.Ed25519PubKey(b"\x01" * 32), b"", b"\x00" * 64)
    with pytest.raises(ValueError, match="malformed signature"):
        bv.add(pks[0], b"", b"\x00" * 63)


# -- the slice as a whole ----------------------------------------------------

CHAIN_ID = "port-sr-chain"
HEIGHT = 9


def build(pkg, privs):
    """(vals, block_id, commit) of one package from the same keys; privs
    are ("ed25519" | "sr25519", secret) pairs."""
    ed, sr, block, vs, tm = pkg

    def priv_of(kind, secret):
        return sr.Sr25519PrivKey(secret) if kind == "sr25519" else ed.Ed25519PrivKey.generate(secret)

    keys = [priv_of(kind, secret) for kind, secret in privs]
    # the first key carries most power, so it is the proposer
    vals = vs.ValidatorSet.new([vs.Validator.new(k.pub_key(), 100 if i == 0 else 10)
                                for i, k in enumerate(keys)])
    rng = np.random.default_rng(65)
    bid = block.BlockID(rng.bytes(32), block.PartSetHeader(2, rng.bytes(32)))
    sigs = [block.CommitSig.new_commit(v.address, tm.Time(1_700_000_000 + i, 31 * i), b"")
            for i, v in enumerate(vals.validators)]
    commit = block.Commit(height=HEIGHT, round=0, block_id=bid, signatures=sigs)
    by_addr = {k.pub_key().address(): k for k in keys}
    for i, v in enumerate(vals.validators):
        sigs[i].signature = by_addr[v.address].sign(commit.vote_sign_bytes(CHAIN_ID, i))
    return vals, bid, commit


JAX_PKG = (jed, jsr, jblock, jvs, jtime)
PORT_PKG = (ted, tsr, tblock, tvs, ttime)


def _call(mod, path, vals, bid, commit, **kw):
    if path == "commit":
        return mod.verify_commit(CHAIN_ID, vals, bid, HEIGHT, commit, **kw)
    if path == "light":
        return mod.verify_commit_light(CHAIN_ID, vals, bid, HEIGHT, commit, **kw)
    return mod.verify_commit_light_trusting(CHAIN_ID, vals, commit, mod.Fraction(1, 3), **kw)


def _outcome(fn):
    try:
        fn()
    except Exception as e:  # the error surface is what is compared
        return cs.error_name(e), str(e)
    return "accepted", ""


@pytest.fixture
def routed(monkeypatch):
    """The port on its device plane (plain versions on the CPU) for
    batches of 4 or more, the RLC first; the reference on its host path."""
    monkeypatch.setenv("TM_TPU_ENGINE", "off")
    monkeypatch.setenv("TM_TPU_CRYPTO", "on")
    monkeypatch.setattr(ted, "DEVICE_BATCH_CUTOVER", 4)
    monkeypatch.setattr(ted, "MSM_BATCH_CUTOVER", 4)
    return monkeypatch


SR_SET = [("sr25519", bytes([i + 1]) * 32) for i in range(8)]
ED_KEYS = [("ed25519", bytes([i]) * 32) for i in (9, 10, 11, 12)]
# mixed sets fall back to serial verification, whichever plane proposes
KEYSETS = {"sr25519": SR_SET, "mixed": ED_KEYS[:1] + SR_SET[1:5] + ED_KEYS[1:],
           "mixed_sr_proposer": SR_SET[:5] + ED_KEYS[1:]}


@pytest.mark.parametrize("tampered", [None, 2, 7], ids=["valid", "tampered2", "tampered7"])
@pytest.mark.parametrize("path", ["commit", "light", "trusting"])
@pytest.mark.parametrize("keyset", sorted(KEYSETS))
def test_same_verdict_and_error(routed, keyset, path, tampered):
    privs = KEYSETS[keyset]
    jv, jb, jc = build(JAX_PKG, privs)
    tv, tb, tc = build(PORT_PKG, privs)
    assert [v.address for v in tv.validators] == [v.address for v in jv.validators]
    assert tc.signatures[3].signature == jc.signatures[3].signature
    assert tv.get_proposer().pub_key.type_name == privs[0][0]
    if tampered is not None:
        for c in (jc, tc):
            sig = c.signatures[tampered].signature
            c.signatures[tampered].signature = sig[:40] + bytes([sig[40] ^ 1]) + sig[41:]
    want = _outcome(lambda: _call(jval, path, jv, jb, jc))
    got = _outcome(lambda: _call(tval, path, tv, tb, tc, device="cpu"))
    assert got == want
    if tampered is None:
        assert got == ("accepted", "")


def test_sr25519_commit_needs_the_card_by_default(monkeypatch):
    """No quiet fallback: without a card the sr25519 device path raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("TM_TPU_CRYPTO", "auto")
    monkeypatch.setattr(ted, "DEVICE_BATCH_CUTOVER", 4)
    tv, tb, tc = build(PORT_PKG, SR_SET)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tval.verify_commit(CHAIN_ID, tv, tb, HEIGHT, tc)
    monkeypatch.setenv("TM_TPU_CRYPTO", "off")
    tval.verify_commit(CHAIN_ID, tv, tb, HEIGHT, tc)
