"""The port's TCP transport and secret connection (tendermint_tpu_torch/p2p:
transport_tcp, secret_connection; crypto/softcrypto's X25519, HKDF and
ChaCha20-Poly1305; native/prep.c's AEAD) against the JAX package's.

The primitives match the RFC 7748, RFC 5869 and RFC 8439 vectors and the
reference's on random inputs over the port's three routes: the
`cryptography` package, softcrypto with prep.c's libcrypto AEAD, and
softcrypto under TM_TPU_NATIVE=0. A port SecretConnection and a reference
one handshake over a socketpair and exchange frames both ways on each route.
Then the reference's own cases run on the port: tests/test_mconn.py whole,
and the TCP and secret-connection cases of tests/test_p2p.py (its faultnet
cases wait for that tooling, ROADMAP A13)."""

import os
import socket
import threading

import numpy as np
import pytest

from tendermint_tpu.crypto import softcrypto as jsoft
from tendermint_tpu.crypto.ed25519 import Ed25519PrivKey as JKey
from tendermint_tpu.p2p import secret_connection as jsc
from tendermint_tpu_torch import native as N
from tendermint_tpu_torch.crypto import softcrypto as tsoft
from tendermint_tpu_torch.crypto.ed25519 import Ed25519PrivKey as TKey
from tendermint_tpu_torch.p2p import secret_connection as tsc

from test_torch_refcases import reference_cases, run_reference_case

ROUTES = ("cryptography", "native", "python")
TCP_CASES = ("test_secret_connection_roundtrip", "test_secret_connection_large_payload",
             "test_tcp_transport_router_roundtrip", "test_node_info_compatibility",
             "test_network_disconnect_is_a_real_partition", "test_peer_veto_is_asymmetric_per_link")

# RFC 7748 §6.1 (Diffie-Hellman), RFC 5869 A.3 (no salt, no info), RFC 8439 §2.8.2
ALICE = bytes.fromhex("77076d0a7318a57d3c16c17251b26645df4c2f87ebc0992ab177fba51db92c2a")
ALICE_PUB = bytes.fromhex("8520f0098930a754748b7ddcb43ef75a0dbf3a0d26381af4eba4a98eaa9b4e6a")
BOB = bytes.fromhex("5dab087e624a8a4b79e17f8b83800ee66f3bb1292618b6fd1c2f8b27ff88e0eb")
BOB_PUB = bytes.fromhex("de9edb7d7b7dc1b4d35b61c2ece435373f8343c85b78674dadfc7e146f882b4f")
SHARED = bytes.fromhex("4a5d9d5ba4ce2de1728e3bf480350f25e07e21c947d19e3376f09b3c1e161742")
HKDF_OKM = bytes.fromhex("8da4e775a563c18f715f802a063c5a31b8a11f5c5ee1879ec3454e5f3c738d2d"
                         "9d201395faa4b61a96c8")
AEAD_KEY = bytes(range(0x80, 0xA0))
AEAD_NONCE = bytes.fromhex("070000004041424344454647")
AEAD_AAD = bytes.fromhex("50515253c0c1c2c3c4c5c6c7")
AEAD_PLAIN = (b"Ladies and Gentlemen of the class of '99: If I could offer you only one tip for "
              b"the future, sunscreen would be it.")
AEAD_TAG = bytes.fromhex("1ae10b594f09e26a7e902ecbd0600691")


@pytest.fixture(params=ROUTES)
def route(request, monkeypatch):
    """The port's secret connection on one route of primitives."""
    name = request.param
    if name == "cryptography":
        if not tsc._HAVE_OSSL:
            pytest.fail("the cryptography package does not import here")
        monkeypatch.delenv("TM_TPU_NATIVE", raising=False)
    else:
        monkeypatch.setattr(tsc, "_HAVE_OSSL", False)
        if name == "python":
            monkeypatch.setenv("TM_TPU_NATIVE", "0")
        else:
            monkeypatch.delenv("TM_TPU_NATIVE", raising=False)
    assert tsc.route() == name
    return name


def port_private(raw):
    """An X25519 private key of the route in use, from its raw scalar."""
    if tsc._HAVE_OSSL:
        return tsc.X25519PrivateKey.from_private_bytes(raw)
    return tsoft.X25519PrivateKey(raw)


def test_x25519_rfc7748_and_reference(route):
    a, b = port_private(ALICE), port_private(BOB)
    assert a.public_key().public_bytes_raw() == ALICE_PUB
    assert b.public_key().public_bytes_raw() == BOB_PUB
    assert a.exchange(tsc._x25519_public(BOB_PUB)) == SHARED == b.exchange(tsc._x25519_public(ALICE_PUB))
    rng = np.random.default_rng(7)
    for _ in range(8):
        k, u = rng.bytes(32), jsoft.x25519(rng.bytes(32), (9).to_bytes(32, "little"))
        want = jsoft.X25519PrivateKey(k).exchange(jsoft.X25519PublicKey(u))
        assert port_private(k).exchange(tsc._x25519_public(u)) == want
        assert tsoft.x25519(k, u) == jsoft.x25519(k, u)


def test_hkdf_rfc5869_and_reference(route):
    assert tsc.hkdf_sha256(b"\x0b" * 22, 42, b"") == HKDF_OKM
    rng = np.random.default_rng(8)
    for n in (32, 64, 96, 200):
        ikm, info = rng.bytes(32), rng.bytes(int(rng.integers(0, 60)))
        assert tsc.hkdf_sha256(ikm, n, info) == jsoft.hkdf_sha256(ikm, n, info)
    dh = rng.bytes(32)
    for least in (True, False):
        assert tsc.derive_secrets(dh, least) == jsc.derive_secrets(dh, least)


def test_chacha20poly1305_rfc8439_and_reference(route):
    aead = tsc._aead(AEAD_KEY)
    sealed = aead.encrypt(AEAD_NONCE, AEAD_PLAIN, AEAD_AAD)
    assert sealed[-16:] == AEAD_TAG and sealed[:4].hex() == "d31a8d34"
    assert sealed == jsoft.ChaCha20Poly1305(AEAD_KEY).encrypt(AEAD_NONCE, AEAD_PLAIN, AEAD_AAD)
    assert aead.decrypt(AEAD_NONCE, sealed, AEAD_AAD) == AEAD_PLAIN
    rng = np.random.default_rng(9)
    for size in (0, 1, 63, 64, 65, 1028, 5000):
        key, nonce, msg = rng.bytes(32), rng.bytes(12), rng.bytes(size)
        for aad in (None, b"", rng.bytes(13)):
            want = jsoft.ChaCha20Poly1305(key).encrypt(nonce, msg, aad)
            assert tsc._aead(key).encrypt(nonce, msg, aad) == want
            assert tsc._aead(key).decrypt(nonce, want, aad) == msg
    bad = bytearray(sealed)
    bad[5] ^= 1
    with pytest.raises(Exception) as err:
        aead.decrypt(AEAD_NONCE, bytes(bad), AEAD_AAD)
    assert type(err.value).__name__ == "InvalidTag"
    with pytest.raises(Exception) as err:
        aead.decrypt(AEAD_NONCE, sealed, b"other aad")
    assert type(err.value).__name__ == "InvalidTag"


def test_softcrypto_aead_routes_give_the_same_bytes(monkeypatch):
    """softcrypto's seal through prep.c and in Python, byte for byte, and a
    forged tag refused as InvalidTag on both."""
    rng = np.random.default_rng(10)
    key, nonce, msg, aad = rng.bytes(32), rng.bytes(12), rng.bytes(1028), rng.bytes(7)
    monkeypatch.delenv("TM_TPU_NATIVE", raising=False)
    native = tsoft.ChaCha20Poly1305(key).encrypt(nonce, msg, aad)
    monkeypatch.setenv("TM_TPU_NATIVE", "0")
    assert tsoft.ChaCha20Poly1305(key).encrypt(nonce, msg, aad) == native
    forged = native[:-1] + bytes([native[-1] ^ 0x80])
    for setting in ("0", ""):
        monkeypatch.setenv("TM_TPU_NATIVE", setting)
        with pytest.raises(tsoft.InvalidTag):
            tsoft.ChaCha20Poly1305(key).decrypt(nonce, forged, aad)


def test_native_aead_raises_without_libcrypto(monkeypatch):
    """With libcrypto hidden (the C side returns -2) the native AEAD raises,
    on seal and on open, and never falls back to the Python cipher; under
    TM_TPU_NATIVE=0 the Python cipher is the one asked for."""
    calls = []

    class NoLibcrypto:
        def tm_aead_chacha20poly1305(self, *args):
            calls.append(args[0])
            return -2

    aead = tsoft.ChaCha20Poly1305(b"\x01" * 32)
    with monkeypatch.context() as mp:
        mp.delenv("TM_TPU_NATIVE", raising=False)
        mp.setattr(N, "load_prep", lambda: NoLibcrypto())
        mp.setattr(tsoft, "_xor_bytes", lambda *a: pytest.fail("the Python cipher ran"))
        with pytest.raises(RuntimeError, match="no usable libcrypto"):
            aead.encrypt(b"\x00" * 12, b"frame", None)
        with pytest.raises(RuntimeError, match="no usable libcrypto"):
            aead.decrypt(b"\x00" * 12, b"\x00" * 32, None)
    assert calls == [1, 0]
    monkeypatch.setenv("TM_TPU_NATIVE", "0")
    sealed = aead.encrypt(b"\x00" * 12, b"frame", None)
    assert sealed == jsoft.ChaCha20Poly1305(b"\x01" * 32).encrypt(b"\x00" * 12, b"frame", None)


def test_native_aead_with_libcrypto_hidden_in_a_subprocess(tmp_path):
    """The real library, loaded where no libcrypto resolves: a process whose
    dlopen finds none (LD_LIBRARY_PATH cannot hide a system library, so the
    library is rebuilt from a copy of prep.c with the names it looks for
    changed) raises on seal; nothing falls back."""
    import subprocess
    import sys

    src = N.SRC.read_text().replace('"libcrypto.so.3", "libcrypto.so.1.1", "libcrypto.so", 0',
                                    '"libcrypto-hidden.so.3", 0')
    assert "libcrypto-hidden" in src
    (tmp_path / "prep.c").write_text(src)
    script = f"""
import pathlib, sys
sys.path.insert(0, {os.path.dirname(os.path.dirname(os.path.abspath(__file__)))!r})
from tendermint_tpu_torch import native as N
N.SRC = pathlib.Path({str(tmp_path / "prep.c")!r})
N.BUILD_DIR = pathlib.Path({str(tmp_path / "_build")!r})
from tendermint_tpu_torch.crypto import softcrypto
try:
    softcrypto.ChaCha20Poly1305(b"\\x01" * 32).encrypt(b"\\x00" * 12, b"frame", None)
except RuntimeError as e:
    print("raised:", e)
else:
    print("sealed")
"""
    env = dict(os.environ)
    env.pop("TM_TPU_NATIVE", None)
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True, env=env, timeout=120)
    assert "raised: native prep: tm_aead_chacha20poly1305 found no usable libcrypto" in out.stdout, out


def _pair(left, right, payloads):
    """left(sock) and right(sock) make secret connections over a socketpair;
    each writes its payload and reads the other's. Returns both
    connections' remote keys and what each read."""
    sa, sb = socket.socketpair()
    got, errors = {}, []

    def side(name, make, sock, mine, theirs):
        try:
            sc = make(sock)
            sc.write(mine)
            got[name] = (sc.remote_pub_key.bytes(), sc.read_exact(len(theirs)))
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    t = threading.Thread(target=side, args=("right", right, sb, payloads[1], payloads[0]), daemon=True)
    t.start()
    side("left", left, sa, payloads[0], payloads[1])
    t.join(10)
    sa.close()
    sb.close()
    assert not errors and not t.is_alive(), errors
    return got


@pytest.mark.parametrize("port_side", ["dialer", "acceptor"])
def test_secret_connection_with_the_reference(route, port_side):
    """A port SecretConnection and a reference one handshake over a
    socketpair (ephemeral X25519, HKDF, the auth signatures) and exchange
    sealed frames both ways: a short message and a 5,000-byte one that
    spans five frames."""
    tkey, jkey = TKey.generate(b"\x51" * 32), JKey.generate(b"\x52" * 32)
    port = lambda s: tsc.SecretConnection(s, tkey)
    ref = lambda s: jsc.SecretConnection(s, jkey)
    payloads = (b"hello from the left", bytes(range(256)) * 20)
    left, right = (port, ref) if port_side == "dialer" else (ref, port)
    got = _pair(left, right, payloads)
    keys = {"left": tkey, "right": jkey} if port_side == "dialer" else {"left": jkey, "right": tkey}
    assert got["left"] == (keys["right"].pub_key().bytes(), payloads[1])
    assert got["right"] == (keys["left"].pub_key().bytes(), payloads[0])


def test_secret_connection_refuses_a_forged_frame(route):
    """A sealed frame altered on the wire fails its tag: the reader raises
    InvalidTag (a verdict on the frame), on every route."""
    sa, sb = socket.socketpair()
    made = {}
    t = threading.Thread(target=lambda: made.setdefault("b", jsc.SecretConnection(sb, JKey.generate(b"\x62" * 32))),
                         daemon=True)
    t.start()
    a = tsc.SecretConnection(sa, TKey.generate(b"\x61" * 32))
    t.join(10)
    frame = bytearray(b"\x00" * tsc.TOTAL_FRAME_SIZE)
    frame[:4] = (5).to_bytes(4, "little")
    frame[4:9] = b"hello"
    sealed = bytearray(made["b"]._send_aead.encrypt(made["b"]._send_nonce.next(), bytes(frame), None))
    sealed[7] ^= 1
    sb.sendall(bytes(sealed))
    with pytest.raises(Exception) as err:
        a.read_exact(5)
    assert type(err.value).__name__ == "InvalidTag"
    sa.close()
    sb.close()


@pytest.mark.parametrize("name,test,kw", reference_cases("test_mconn") + reference_cases("test_p2p", only=TCP_CASES))
def test_reference_case(name, test, kw, request):
    run_reference_case(name, test, kw, request)
