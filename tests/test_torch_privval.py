"""The port's file signer (privval/file_pv.py) against the JAX package's:
the reference's tests/test_privval.py cases run on the port
(test_torch_refcases), then one script of signing requests through both
packages' FilePVs on all three key types, over one memoizing signer
(sr25519 and secp256k1 signatures are randomized): the signatures, the
timestamps handed back on a same-HRS reuse, the extension signatures, the
last-sign-state file's and its journal's bytes after every request, and
every refusal's class and message; and the key file FilePV.generate writes
for each key type, loaded back."""

import os

import numpy as np
import pytest

import chip_smoke as cs
from test_torch_light import Signer, members
from test_torch_refcases import reference_cases, run_reference_case
from tendermint_tpu.privval import file_pv as jfp
from tendermint_tpu.types import block as jblock
from tendermint_tpu.types import proposal as jproposal
from tendermint_tpu.types import vote as jvote
from tendermint_tpu.utils import tmtime as jtmtime
from tendermint_tpu_torch.privval import file_pv as tfp
from tendermint_tpu_torch.types import block as tblock
from tendermint_tpu_torch.types import proposal as tproposal
from tendermint_tpu_torch.types import vote as tvote
from tendermint_tpu_torch.utils import tmtime as ttmtime

CHAIN = "pv-chain"
KINDS = ("ed25519", "sr25519", "secp256k1")
PACKAGES = {
    "port": dict(fp=tfp, block=tblock, proposal=tproposal, vote=tvote, tmtime=ttmtime),
    "jax": dict(fp=jfp, block=jblock, proposal=jproposal, vote=jvote, tmtime=jtmtime),
}


@pytest.mark.parametrize("name,test,kw", reference_cases("test_privval"))
def test_reference_case_on_port(name, test, kw, request):
    run_reference_case(name, test, kw, request)


def bid(m, tag: int):
    return m["block"].BlockID(hash=bytes([tag]) * 32, part_set_header=m["block"].PartSetHeader(1, bytes([tag + 1]) * 32))


def requests(m):
    """The script: (label, request) pairs, each request a callable of the
    FilePV returning what it handed back."""
    V, T = m["vote"], m["tmtime"].Time

    def vote(type_, h, r, tag, t, ext=b""):
        v = V.Vote(type=type_, height=h, round=r, block_id=bid(m, tag) if tag else m["block"].BlockID(),
                   timestamp=T(1_700_000_000 + t, 7), validator_address=b"\x01" * 20, validator_index=0,
                   extension=ext)
        return v

    def sign_vote(v):
        def run(pv):
            pv.sign_vote(CHAIN, v)
            return (v.signature, v.extension_signature, v.timestamp.seconds, v.timestamp.nanos)
        return run

    def sign_proposal(h, r, tag, t):
        def run(pv):
            p = m["proposal"].Proposal(height=h, round=r, pol_round=-1, block_id=bid(m, tag),
                                       timestamp=T(1_700_000_000 + t, 9))
            pv.sign_proposal(CHAIN, p)
            return p.signature
        return run

    return [
        ("proposal 1/0", sign_proposal(1, 0, 10, 0)),
        ("same proposal again", sign_proposal(1, 0, 10, 0)),
        ("another proposal at 1/0", sign_proposal(1, 0, 12, 0)),
        ("prevote 1/0", sign_vote(vote(V.PREVOTE, 1, 0, 10, 1))),
        ("prevote 1/0 again", sign_vote(vote(V.PREVOTE, 1, 0, 10, 1))),
        ("prevote 1/0, another timestamp", sign_vote(vote(V.PREVOTE, 1, 0, 10, 5))),
        ("prevote 1/0 for another block", sign_vote(vote(V.PREVOTE, 1, 0, 12, 1))),
        ("precommit 1/0 with an extension", sign_vote(vote(V.PRECOMMIT, 1, 0, 10, 2, ext=b"ext-1"))),
        ("the precommit again, another extension", sign_vote(vote(V.PRECOMMIT, 1, 0, 10, 2, ext=b"ext-2"))),
        ("prevote 1/0 after the precommit", sign_vote(vote(V.PREVOTE, 1, 0, 10, 1))),
        ("nil prevote with an extension", sign_vote(vote(V.PREVOTE, 1, 1, 0, 3, ext=b"x"))),
        ("nil prevote 1/1", sign_vote(vote(V.PREVOTE, 1, 1, 0, 3))),
        ("prevote at round 0 after round 1", sign_vote(vote(V.PREVOTE, 1, 0, 10, 4))),
        ("precommit 2/0", sign_vote(vote(V.PRECOMMIT, 2, 0, 20, 6))),
        ("prevote at height 1 after height 2", sign_vote(vote(V.PREVOTE, 1, 2, 10, 7))),
    ]


def run_script(pkg, member, sign, where):
    m = PACKAGES[pkg]
    key = cs.SignerKey(cs.light_modules() if pkg == "port" else _jax_keys(), member, sign)
    path = os.path.join(where, pkg, "priv_validator_state.json")
    os.makedirs(os.path.dirname(path))
    pv = m["fp"].FilePV(priv_key=key, last_sign_state=m["fp"].LastSignState(file_path=path))
    out = []
    for label, run in requests(m):
        try:
            got = ("ok", run(pv))
        except Exception as e:  # noqa: BLE001 - the outcome is compared
            got = (type(e).__name__, str(e))
        with open(path, "rb") as f, open(path + ".journal", "rb") as j:
            out.append((label, got, f.read(), j.read()))
    reloaded = m["fp"].LastSignState.load(path)
    out.append(("reloaded", (reloaded.height, reloaded.round, reloaded.step, reloaded.signature,
                             reloaded.sign_bytes)))
    return out


def _jax_keys():
    from types import SimpleNamespace

    from tendermint_tpu.crypto import ed25519, sr25519
    from tendermint_tpu.crypto import secp256k1 as jsecp

    return SimpleNamespace(keys={"ed25519": ed25519.Ed25519PubKey, "sr25519": sr25519.Sr25519PubKey,
                                 "secp256k1": jsecp.Secp256k1PubKey})


@pytest.mark.parametrize("kind", KINDS)
def test_signing_script_matches_reference(kind, tmp_path):
    member = members(kind, 1, np.random.default_rng(40 + KINDS.index(kind)))[0]
    sign = Signer()
    port, jax = (run_script(pkg, member, sign, str(tmp_path)) for pkg in ("port", "jax"))
    assert port == jax
    outcomes = {label: got[0] for label, got, *_ in port[:-1]}
    assert outcomes["another proposal at 1/0"] == "DoubleSignError"
    assert outcomes["prevote 1/0 for another block"] == "DoubleSignError"
    assert outcomes["prevote 1/0 after the precommit"] == "DoubleSignError"
    assert outcomes["nil prevote with an extension"] == "ValueError"
    assert outcomes["prevote at height 1 after height 2"] == "DoubleSignError"
    # a same-HRS reuse hands back the stored signature and timestamp
    by = {label: got for label, got, *_ in port[:-1]}
    assert by["prevote 1/0, another timestamp"][1][0] == by["prevote 1/0"][1][0]
    assert by["prevote 1/0, another timestamp"][1][2] == by["prevote 1/0"][1][2]


@pytest.mark.parametrize("kind", KINDS)
def test_generated_key_files_match_reference(kind, tmp_path):
    """FilePV.generate from one seed: the same key file bytes and address in
    both packages; each package loads the other's files; a loaded key's
    signature verifies under the other package's public key."""
    seed = bytes(range(32)) if kind != "secp256k1" else bytes(range(1, 33))
    files = {}
    for pkg, m in PACKAGES.items():
        d = tmp_path / pkg
        d.mkdir()
        pv = m["fp"].FilePV.generate(str(d / "key.json"), str(d / "state.json"), seed=seed, key_type=kind)
        files[pkg] = ((d / "key.json").read_bytes(), (d / "state.json").read_bytes(), pv.address)
    assert files["port"] == files["jax"]
    for pkg, other in (("port", "jax"), ("jax", "port")):
        m = PACKAGES[pkg]
        pv = m["fp"].FilePV.load(str(tmp_path / other / "key.json"), str(tmp_path / other / "state.json"))
        assert pv.address == files[other][2]
        msg = b"signed by the %s package" % pkg.encode()
        sig = pv.priv_key.sign(msg)
        theirs = PACKAGES[other]["fp"].FilePV.load(str(tmp_path / other / "key.json"),
                                                   str(tmp_path / other / "state.json"))
        assert theirs.get_pub_key().verify_signature(msg, sig)


def test_state_file_is_fsynced_before_the_signature(tmp_path, monkeypatch):
    """The last-sign state reaches the disk (os.fsync of the state file's
    temporary and of its journal) before sign_vote returns a signature, as
    in the reference (privval/file_pv.py:111,168)."""
    m = PACKAGES["port"]
    synced = []
    real = os.fsync
    monkeypatch.setattr(tfp.os, "fsync", lambda fd: (synced.append(os.readlink(f"/proc/self/fd/{fd}")), real(fd)))
    pv = m["fp"].FilePV.generate(seed=b"\x05" * 32, state_file_path=str(tmp_path / "state.json"))
    synced.clear()
    v = requests(m)[3][1]
    v(pv)
    assert [os.path.basename(p) for p in synced] == ["state.json.tmp", "state.json.journal"]
