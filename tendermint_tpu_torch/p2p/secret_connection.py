"""SecretConnection: Station-to-Station authenticated encryption over a
byte stream (ref: internal/p2p/conn/secret_connection.go:92-455), a copy of
the JAX package's p2p/secret_connection.py with the same wire bytes.

The protocol:
  1. exchange 32-byte ephemeral X25519 public keys (unauthenticated);
  2. DH, then HKDF-SHA256 (info "TENDERMINT_SECRET_CONNECTION_KEY_AND_CHALLENGE_GEN")
     derives 96 bytes: two ChaCha20-Poly1305 keys and a 32-byte challenge,
     the keys assigned by the sorted ephemeral keys (deriveSecrets :337);
  3. all further traffic in sealed frames: a 4-byte LE length and a
     1,024-byte data chunk, the nonce a 96-bit LE counter (:55-58);
  4. each side sends (node public key, signature over the challenge)
     through the sealed stream; the signature is checked on the host, and
     the peer's identity is authenticated (:193-222).

The primitives come from the `cryptography` package when it imports, as in
the reference, else from crypto/softcrypto.py, whose AEAD runs through
native/prep.c's libcrypto unless TM_TPU_NATIVE=0. `route()` names the one
taken. Nothing here runs device code.
"""

from __future__ import annotations

import struct

from ..crypto import softcrypto as _soft
from ..crypto.ed25519 import Ed25519PubKey
from ..native import native_disabled
from ..proto import messages as pb
from ..proto.wire import encode_varint, read_delimited

try:
    from cryptography.hazmat.primitives import hashes
    from cryptography.hazmat.primitives.asymmetric.x25519 import X25519PrivateKey, X25519PublicKey
    from cryptography.hazmat.primitives.ciphers.aead import ChaCha20Poly1305
    from cryptography.hazmat.primitives.kdf.hkdf import HKDF

    _HAVE_OSSL = True
except ImportError:  # no `cryptography` package: softcrypto's primitives
    _HAVE_OSSL = False

DATA_LEN_SIZE = 4
DATA_MAX_SIZE = 1024
TOTAL_FRAME_SIZE = DATA_MAX_SIZE + DATA_LEN_SIZE
AEAD_TAG_SIZE = 16
SEALED_FRAME_SIZE = TOTAL_FRAME_SIZE + AEAD_TAG_SIZE

_HKDF_INFO = b"TENDERMINT_SECRET_CONNECTION_KEY_AND_CHALLENGE_GEN"


def route() -> str:
    """The primitives in use: "cryptography", "native" (softcrypto's, the
    AEAD through prep.c's libcrypto) or "python" (TM_TPU_NATIVE=0)."""
    if _HAVE_OSSL:
        return "cryptography"
    return "python" if native_disabled() else "native"


def _x25519_generate():
    return X25519PrivateKey.generate() if _HAVE_OSSL else _soft.X25519PrivateKey.generate()


def _x25519_public(raw: bytes):
    return X25519PublicKey.from_public_bytes(raw) if _HAVE_OSSL else _soft.X25519PublicKey.from_public_bytes(raw)


def _aead(key: bytes):
    return ChaCha20Poly1305(key) if _HAVE_OSSL else _soft.ChaCha20Poly1305(key)


def hkdf_sha256(ikm: bytes, length: int, info: bytes) -> bytes:
    """HKDF-SHA256 with no salt, on the route in use."""
    if _HAVE_OSSL:
        return HKDF(algorithm=hashes.SHA256(), length=length, salt=None, info=info).derive(ikm)
    return _soft.hkdf_sha256(ikm, length, info)


class _NonceCounter:
    """96-bit little-endian counter nonce (ref: secret_connection.go:469)."""

    __slots__ = ("counter",)

    def __init__(self):
        self.counter = 0

    def next(self) -> bytes:
        n = struct.pack("<4xQ", self.counter)
        self.counter += 1
        if self.counter >= 1 << 64:
            raise OverflowError("nonce counter overflow")
        return n


def derive_secrets(dh_secret: bytes, loc_is_least: bool) -> tuple[bytes, bytes, bytes]:
    """HKDF -> (recv_key, send_key, challenge) (ref: deriveSecrets :337)."""
    okm = hkdf_sha256(dh_secret, 96, _HKDF_INFO)
    if loc_is_least:
        recv_key, send_key = okm[0:32], okm[32:64]
    else:
        send_key, recv_key = okm[0:32], okm[32:64]
    return recv_key, send_key, okm[64:96]


class SecretConnection:
    """Wraps a duplex byte stream (an object with sendall/recv/close: a
    socket) in authenticated encryption."""

    def __init__(self, sock, priv_key):
        self._sock = sock
        self._raw_buf = bytearray()
        self.local_pub_key = priv_key.pub_key()
        self.remote_pub_key: Ed25519PubKey | None = None

        # 1. ephemeral key exchange
        eph_priv = _x25519_generate()
        eph_pub = eph_priv.public_key().public_bytes_raw()
        self._write_all(eph_pub)
        remote_eph_pub = self._read_exact(32)

        # 2. derive keys; the "least" side by raw public key comparison (:128)
        dh = eph_priv.exchange(_x25519_public(remote_eph_pub))
        loc_is_least = eph_pub < remote_eph_pub
        recv_key, send_key, challenge = derive_secrets(dh, loc_is_least)
        self._send_aead = _aead(send_key)
        self._recv_aead = _aead(recv_key)
        self._send_nonce = _NonceCounter()
        self._recv_nonce = _NonceCounter()
        self._recv_buf = b""

        # 4. authenticate: sign the shared challenge with the node key and
        # exchange proto AuthSigMessage, length-delimited like the
        # reference's protoio.WriteDelimited (:193-222 shareAuthSignature)
        sig = priv_key.sign(challenge)
        auth = pb.AuthSigMessage(
            pub_key=pb.PublicKey(ed25519=self.local_pub_key.bytes()), sig=sig
        ).encode()
        self.write(encode_varint(len(auth)) + auth)
        peer_auth = pb.AuthSigMessage.decode(self._read_delimited(4096))
        kind, key_bytes = peer_auth.pub_key.sum if peer_auth.pub_key else (None, None)
        if kind != "ed25519" or key_bytes is None:
            raise ValueError(f"unsupported auth key type {kind!r}")
        peer_pub = Ed25519PubKey(key_bytes)
        if not peer_pub.verify_signature(challenge, peer_auth.sig or b""):
            raise ValueError("challenge verification failed")
        self.remote_pub_key = peer_pub

    # ----------------------------------------------------------- raw stream

    def _write_all(self, data: bytes) -> None:
        self._sock.sendall(data)

    def _read_exact(self, n: int) -> bytes:
        """Resumable exact read: on a socket timeout the partial bytes stay
        buffered, so the next call resumes mid-frame instead of
        desynchronizing the AEAD stream."""
        while len(self._raw_buf) < n:
            chunk = self._sock.recv(n - len(self._raw_buf))
            if not chunk:
                raise ConnectionError("connection closed")
            self._raw_buf += chunk
        out, self._raw_buf = self._raw_buf[:n], self._raw_buf[n:]
        return bytes(out)

    # ------------------------------------------------------- sealed stream

    def _read_delimited(self, max_size: int) -> bytes:
        """Read a uvarint-length-prefixed message from the sealed stream
        (ref: internal/libs/protoio ReadDelimited)."""
        return read_delimited(self.read_exact, max_size)

    def write(self, data: bytes) -> int:
        """Frame, seal and send (ref: secret_connection.go:243 Write)."""
        n = 0
        view = memoryview(data)
        while view:
            chunk = bytes(view[:DATA_MAX_SIZE])
            view = view[len(chunk):]
            frame = struct.pack("<I", len(chunk)) + chunk
            frame += b"\x00" * (TOTAL_FRAME_SIZE - len(frame))
            sealed = self._send_aead.encrypt(self._send_nonce.next(), frame, None)
            self._write_all(sealed)
            n += len(chunk)
        return n

    def _read_frame(self) -> bytes:
        sealed = self._read_exact(SEALED_FRAME_SIZE)
        frame = self._recv_aead.decrypt(self._recv_nonce.next(), sealed, None)
        (chunk_len,) = struct.unpack("<I", frame[:DATA_LEN_SIZE])
        if chunk_len > DATA_MAX_SIZE:
            raise ValueError("chunk length exceeds frame size")
        return frame[DATA_LEN_SIZE : DATA_LEN_SIZE + chunk_len]

    def read(self, n: int) -> bytes:
        """Read up to n plaintext bytes (ref: :274 Read)."""
        if not self._recv_buf:
            self._recv_buf = self._read_frame()
        out, self._recv_buf = self._recv_buf[:n], self._recv_buf[n:]
        return out

    def read_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self.read(n - len(buf))
            if not chunk:
                raise ConnectionError("connection closed")
            buf += chunk
        return buf

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass
