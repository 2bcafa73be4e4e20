"""The port's secp256k1 key type (crypto/secp256k1.py on crypto/softcrypto.py)
and key codec (crypto/encoding.py) against the JAX package's, on seeded
inputs: deterministic keygen, public keys and addresses; signatures made by
one package verify in the other, on each of the port's two routes (the
`cryptography` package's OpenSSL curve and the pure-Python curve, selected
by monkeypatching `_HAVE_OSSL`); the pure-Python route's RFC 6979 signatures
equal the reference's byte for byte; verdicts on the edge cases (high S,
r = 0, s = 0, r >= n, 63- and 65-byte signatures, undecodable keys) equal
the reference's on both routes; and the codec round-trips all three key
types to the reference's proto bytes."""

import numpy as np
import pytest

from tendermint_tpu.crypto import encoding as jenc
from tendermint_tpu.crypto import ed25519 as jed
from tendermint_tpu.crypto import secp256k1 as jsecp
from tendermint_tpu.crypto import softcrypto as jsoft
from tendermint_tpu.crypto import sr25519 as jsr
from tendermint_tpu.proto import messages as jpb
from tendermint_tpu_torch.crypto import ed25519 as ted
from tendermint_tpu_torch.crypto import encoding as tenc
from tendermint_tpu_torch.crypto import secp256k1 as tsecp
from tendermint_tpu_torch.crypto import softcrypto as tsoft
from tendermint_tpu_torch.crypto import sr25519 as tsr
from tendermint_tpu_torch.proto import messages as tpb

N = tsecp._N
ROUTES = ("cryptography", "softcrypto")


def secrets(n=3, seed=71):
    rng = np.random.default_rng(seed)
    return [rng.bytes(32) for _ in range(n)]


@pytest.fixture(params=ROUTES)
def route(request, monkeypatch):
    """The port on one route; the reference on its default one."""
    monkeypatch.setattr(tsecp, "_HAVE_OSSL", request.param == "cryptography")
    assert tsecp.route() == request.param
    return request.param


def soft_reference(monkeypatch):
    """The reference's secp256k1 on its pure-Python route (its softcrypto is
    only imported without `cryptography`, so it is handed over here)."""
    monkeypatch.setattr(jsecp, "_HAVE_OSSL", False)
    monkeypatch.setattr(jsecp, "_soft", jsoft, raising=False)


def test_softcrypto_curve_matches_reference():
    rng = np.random.default_rng(72)
    for _ in range(3):
        k = int.from_bytes(rng.bytes(32), "big") % N or 1
        pt = tsoft.secp_mult(k)
        assert pt == jsoft.secp_mult(k)
        enc = tsoft.secp_compress(pt)
        assert enc == jsoft.secp_compress(pt) and tsoft.secp_decompress(enc) == pt
        digest = rng.bytes(32)
        assert tsoft._rfc6979_k(k, digest) == jsoft._rfc6979_k(k, digest)
    for bad in (b"\x05" + bytes(32), b"\x02" + (tsoft.SECP_P + 1).to_bytes(32, "big"), b"\x02" * 32):
        assert tsoft.secp_decompress(bad) is None and jsoft.secp_decompress(bad) is None


def test_keys_and_addresses_match_reference(route):
    for secret in secrets():
        priv, want = tsecp.Secp256k1PrivKey.generate(secret), jsecp.Secp256k1PrivKey.generate(secret)
        assert priv.bytes() == want.bytes()
        pub = priv.pub_key()
        assert pub.bytes() == want.pub_key().bytes() and len(pub.bytes()) == 33
        assert pub.address() == want.pub_key().address() and len(pub.address()) == 20
        assert pub.type_name == "secp256k1"
    with pytest.raises(ValueError):
        tsecp.Secp256k1PubKey(b"\x02" * 32)
    with pytest.raises(ValueError):
        tsecp.Secp256k1PrivKey(b"\x01" * 31)


def test_signatures_verify_across_packages(route):
    for i, secret in enumerate(secrets(2)):
        msg = b"cross-package %d" % i
        priv, jpriv = tsecp.Secp256k1PrivKey.generate(secret), jsecp.Secp256k1PrivKey.generate(secret)
        sig, jsig = priv.sign(msg), jpriv.sign(msg)
        assert len(sig) == 64 and int.from_bytes(sig[32:], "big") <= N >> 1  # low S
        assert jpriv.pub_key().verify_signature(msg, sig)
        assert priv.pub_key().verify_signature(msg, jsig)
        assert not priv.pub_key().verify_signature(msg + b"x", jsig)


def test_softcrypto_signatures_equal_reference(monkeypatch):
    """RFC 6979 nonces: the pure-Python route signs deterministically, to the
    reference's pure-Python route's bytes."""
    monkeypatch.setattr(tsecp, "_HAVE_OSSL", False)
    soft_reference(monkeypatch)
    for i, secret in enumerate(secrets(2, seed=73)):
        msg = b"rfc6979 %d" % i
        sig = tsecp.Secp256k1PrivKey.generate(secret).sign(msg)
        assert sig == jsecp.Secp256k1PrivKey.generate(secret).sign(msg)
        assert sig == tsecp.Secp256k1PrivKey.generate(secret).sign(msg)


def edge_cases():
    """(label, pubkey bytes, msg, sig) on one honest key."""
    priv = jsecp.Secp256k1PrivKey.generate(b"edge")
    pub, msg = priv.pub_key().bytes(), b"edge cases"
    sig = priv.sign(msg)
    r, s = int.from_bytes(sig[:32], "big"), int.from_bytes(sig[32:], "big")
    enc = lambda r_, s_: r_.to_bytes(32, "big") + s_.to_bytes(32, "big")
    return [
        ("honest", pub, msg, sig),
        ("high S", pub, msg, enc(r, N - s)),
        ("r = 0", pub, msg, enc(0, s)),
        ("s = 0", pub, msg, enc(r, 0)),
        ("r >= n", pub, msg, enc(N + 1, s)),
        ("r = n", pub, msg, enc(N, s)),
        ("63 bytes", pub, msg, sig[:63]),
        ("65 bytes", pub, msg, sig + b"\x00"),
        ("x not on the curve", b"\x02" + bytes(31) + b"\x05", msg, sig),
        ("x >= p", b"\x03" + b"\xff" * 32, msg, sig),
        ("bad prefix", b"\x05" + pub[1:], msg, sig),
        ("other parity", bytes([pub[0] ^ 1]) + pub[1:], msg, sig),
    ]


@pytest.mark.parametrize("reference_route", ROUTES)
def test_edge_verdicts_match_reference(route, reference_route, monkeypatch):
    if reference_route == "softcrypto":
        soft_reference(monkeypatch)
    verdicts = []
    for label, pub, msg, sig in edge_cases():
        got = tsecp.Secp256k1PubKey(pub).verify_signature(msg, sig)
        want = jsecp.Secp256k1PubKey(pub).verify_signature(msg, sig)
        assert got == want, label
        verdicts.append(got)
    assert verdicts == [True] + [False] * (len(verdicts) - 1)


def test_key_codec_round_trips_to_reference_bytes():
    rng = np.random.default_rng(74)
    sr_priv = tsr.Sr25519PrivKey(rng.bytes(32))
    secp = tsecp.Secp256k1PrivKey.generate(rng.bytes(32)).pub_key()
    cases = [(ted.Ed25519PubKey(rng.bytes(32)), jed.Ed25519PubKey),
             (secp, jsecp.Secp256k1PubKey),
             (sr_priv.pub_key(), jsr.Sr25519PubKey)]
    for pk, ref_cls in cases:
        proto = tenc.pubkey_to_proto(pk)
        want = jenc.pubkey_to_proto(ref_cls(pk.bytes())).encode()
        assert proto.encode() == want and len(want) == 2 + len(pk.bytes())
        back = tenc.pubkey_from_proto(tpb.PublicKey.decode(want))
        assert back == pk and type(back) is type(pk)
        assert jenc.pubkey_from_proto(jpb.PublicKey.decode(proto.encode())).bytes() == pk.bytes()
        assert proto.sum == (pk.type_name, pk.bytes())
    with pytest.raises(ValueError, match="unsupported proto pubkey arm"):
        tenc.pubkey_from_proto(tpb.PublicKey())
