"""Remote signer endpoints (ref: privval/signer_listener_endpoint.go,
privval/signer_dialer_endpoint.go, privval/signer_server.go,
privval/signer_client.go).

Topology matches the reference: the VALIDATOR listens; the SIGNER dials
in and then serves signing requests over the established connection.
tcp:// connections are wrapped in SecretConnection (X25519 + ChaCha20-
Poly1305 + challenge auth); unix:// sockets are used raw. Messages are
uvarint-length-delimited `privval.Message` protos.
"""

from __future__ import annotations

import socket
import threading
import time
from urllib.parse import urlparse

from ..crypto.ed25519 import Ed25519PrivKey, Ed25519PubKey
from ..p2p.secret_connection import SecretConnection
from ..proto.wire import encode_varint, read_delimited
from ..types.proposal import Proposal
from ..types.vote import Vote
from ..utils.log import new_logger
from . import proto as pv

DEFAULT_TIMEOUT_READ_WRITE = 5.0
DEFAULT_TIMEOUT_ACCEPT = 30.0
# ping at 2/3 of the read/write timeout (ref: signer_listener_endpoint.go:29)
PING_FRACTION = 2.0 / 3.0
MAX_MSG_SIZE = 1 << 20


class RemoteSignerErrorException(Exception):
    def __init__(self, code: int, description: str):
        super().__init__(f"remote signer error {code}: {description}")
        self.code = code
        self.description = description


class _PlainConn:
    """Raw-socket adapter exposing the SecretConnection read/write API."""

    def __init__(self, sock):
        self._sock = sock
        self._buf = bytearray()
        self.remote_pub_key = None

    def write(self, data: bytes) -> int:
        self._sock.sendall(data)
        return len(data)

    def read_exact(self, n: int) -> bytes:
        while len(self._buf) < n:
            chunk = self._sock.recv(n - len(self._buf))
            if not chunk:
                raise ConnectionError("connection closed")
            self._buf += chunk
        out, self._buf = self._buf[:n], self._buf[n:]
        return bytes(out)

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


def _write_msg(conn, msg: pv.PrivvalMessage) -> None:
    body = msg.encode()
    conn.write(encode_varint(len(body)) + body)


def _read_msg(conn) -> pv.PrivvalMessage:
    """Read one privval message. A timeout BEFORE any byte is consumed
    re-raises socket.timeout (the caller's idle poll); a timeout
    mid-message would desync the plaintext stream, so it becomes a
    ConnectionError and the endpoint reconnects."""
    started = False

    def read_exact(n: int) -> bytes:
        nonlocal started
        try:
            data = conn.read_exact(n)
        except socket.timeout:
            if started:
                raise ConnectionError("timeout mid-message: privval stream desynced")
            raise
        started = True
        return data

    body = read_delimited(read_exact, MAX_MSG_SIZE)
    return pv.PrivvalMessage.decode(body)


def _parse_addr(addr: str):
    u = urlparse(addr)
    if u.scheme == "unix":
        return socket.AF_UNIX, (u.netloc + u.path), False
    if u.scheme == "tcp":
        port = u.port if u.port is not None else 26659
        return socket.AF_INET, (u.hostname or "127.0.0.1", port), True
    raise ValueError(f"unsupported privval address {addr!r} (want tcp:// or unix://)")


class SignerListenerEndpoint:
    """Validator-side endpoint: listens for the signer to dial in, keeps
    one connection, serializes requests over it
    (ref: privval/signer_listener_endpoint.go:33)."""

    def __init__(
        self,
        addr: str,
        priv_key: Ed25519PrivKey | None = None,
        timeout_accept: float = DEFAULT_TIMEOUT_ACCEPT,
        timeout_read_write: float = DEFAULT_TIMEOUT_READ_WRITE,
        logger=None,
    ):
        self.addr = addr
        # node key for the SecretConnection handshake on tcp
        self.priv_key = priv_key or Ed25519PrivKey.generate()
        self.timeout_accept = timeout_accept
        self.timeout_read_write = timeout_read_write
        self.logger = logger or new_logger("privval-listener")
        self._listener: socket.socket | None = None
        self._conn = None
        self._conn_ready = threading.Event()
        self._instance_lock = threading.Lock()  # serializes send_request
        # guards the (_conn, _conn_ready) pair: the accept loop swaps in
        # a fresh dial while send_request may still be failing on the
        # old one — held only for the reference swap, never across I/O,
        # so a wedged request cannot block new accepts
        self._conn_lock = threading.Lock()
        self._stop = threading.Event()
        self._accept_thread: threading.Thread | None = None
        self._ping_thread: threading.Thread | None = None

    # ------------------------------------------------------------ lifecycle

    def start(self) -> None:
        family, sockaddr, _ = _parse_addr(self.addr)
        self._listener = socket.socket(family, socket.SOCK_STREAM)
        if family == socket.AF_INET:
            self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind(sockaddr)
        self._listener.listen(1)
        self._listener.settimeout(0.2)
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name="privval-accept"
        )
        self._accept_thread.start()
        self._ping_thread = threading.Thread(
            target=self._ping_loop, daemon=True, name="privval-ping"
        )
        self._ping_thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._conn is not None:
            self._conn.close()
        if self._listener is not None:
            self._listener.close()
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=2)
        if self._ping_thread is not None:
            self._ping_thread.join(timeout=2)

    def _ping_loop(self) -> None:
        """Keepalive at 2/3 of the read/write timeout — detects a dead or
        NAT-dropped signer connection before a sign request has to block
        on it (ref: signer_listener_endpoint.go:29 pingInterval)."""
        interval = self.timeout_read_write * PING_FRACTION
        while not self._stop.wait(timeout=interval):
            if not self._conn_ready.is_set():
                continue
            try:
                self.send_request(pv.PrivvalMessage(ping_request=pv.PingRequest()))
            except Exception:
                pass  # send_request already dropped the dead connection

    @property
    def bound_addr(self) -> str:
        """Actual listen address (for ephemeral ports in tests)."""
        family, _, _ = _parse_addr(self.addr)
        if family == socket.AF_UNIX:
            return self.addr
        host, port = self._listener.getsockname()[:2]
        return f"tcp://{host}:{port}"

    def _accept_loop(self) -> None:
        """Keep (re)accepting the signer connection; the newest dial wins
        (ref: serviceLoop signer_listener_endpoint.go:161)."""
        _, _, is_tcp = _parse_addr(self.addr)
        while not self._stop.is_set():
            try:
                sock, _ = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            try:
                sock.settimeout(self.timeout_read_write)
                conn = SecretConnection(sock, self.priv_key) if is_tcp else _PlainConn(sock)
            except Exception as e:
                self.logger.error("signer handshake failed", err=str(e))
                try:
                    sock.close()
                except OSError:
                    pass
                continue
            with self._conn_lock:
                old, self._conn = self._conn, conn
                self._conn_ready.set()
            if old is not None:
                old.close()
            self.logger.info("signer connected")

    # ------------------------------------------------------------ requests

    def wait_for_connection(self, timeout: float | None = None) -> bool:
        return self._conn_ready.wait(timeout if timeout is not None else self.timeout_accept)

    def send_request(self, msg: pv.PrivvalMessage) -> pv.PrivvalMessage:
        """One request/response exchange (ref: SendRequest
        signer_listener_endpoint.go:94). Raises on timeout/connection
        loss; the caller decides retry policy."""
        with self._instance_lock:
            if not self.wait_for_connection():
                raise TimeoutError("no signer connected")
            with self._conn_lock:
                conn = self._conn
            if conn is None:
                raise TimeoutError("no signer connected")
            try:
                _write_msg(conn, msg)
                while True:
                    resp = _read_msg(conn)
                    # absorb stray pong frames from the keepalive
                    if resp.ping_response is not None and msg.ping_request is None:
                        continue
                    return resp
            except Exception:
                # drop the dead connection; the signer will redial.
                # Clearing readiness is PAIRED with the null-out under
                # the lock: if the accept loop already swapped in a
                # fresh dial, that connection is live and readiness
                # must stay set — an unconditional clear here stranded
                # the endpoint until the signer happened to redial
                with self._conn_lock:
                    if self._conn is conn:
                        self._conn = None
                        self._conn_ready.clear()
                conn.close()
                raise


class SignerClient:
    """PrivValidator implementation backed by a SignerListenerEndpoint
    (ref: privval/signer_client.go)."""

    def __init__(self, endpoint: SignerListenerEndpoint, chain_id: str):
        self.endpoint = endpoint
        self.chain_id = chain_id
        self._pub_key: Ed25519PubKey | None = None

    def get_pub_key(self) -> Ed25519PubKey:
        """ref: signer_client.go GetPubKey (cached after first fetch)."""
        if self._pub_key is None:
            resp = self.endpoint.send_request(
                pv.PrivvalMessage(pub_key_request=pv.PubKeyRequest(chain_id=self.chain_id))
            )
            pkr = resp.pub_key_response
            if pkr is None:
                raise ValueError("unexpected response to PubKeyRequest")
            if pkr.error is not None:
                raise RemoteSignerErrorException(pkr.error.code or 0, pkr.error.description or "")
            kind, data = pkr.pub_key.sum
            if kind != "ed25519":
                raise ValueError(f"unsupported remote key type {kind!r}")
            self._pub_key = Ed25519PubKey(data)
        return self._pub_key

    def address(self) -> bytes:
        return self.get_pub_key().address()

    def sign_vote(self, chain_id: str, vote: Vote) -> None:
        """ref: signer_client.go SignVote — the signed vote comes back
        whole; copy signature fields into the caller's vote."""
        resp = self.endpoint.send_request(
            pv.PrivvalMessage(
                sign_vote_request=pv.SignVoteRequest(vote=vote.to_proto(), chain_id=chain_id)
            )
        )
        svr = resp.signed_vote_response
        if svr is None:
            raise ValueError("unexpected response to SignVoteRequest")
        if svr.error is not None:
            raise RemoteSignerErrorException(svr.error.code or 0, svr.error.description or "")
        signed = Vote.from_proto(svr.vote)
        vote.signature = signed.signature
        vote.extension_signature = signed.extension_signature
        vote.timestamp = signed.timestamp

    def sign_proposal(self, chain_id: str, proposal: Proposal) -> None:
        resp = self.endpoint.send_request(
            pv.PrivvalMessage(
                sign_proposal_request=pv.SignProposalRequest(
                    proposal=proposal.to_proto(), chain_id=chain_id
                )
            )
        )
        spr = resp.signed_proposal_response
        if spr is None:
            raise ValueError("unexpected response to SignProposalRequest")
        if spr.error is not None:
            raise RemoteSignerErrorException(spr.error.code or 0, spr.error.description or "")
        signed = Proposal.from_proto(spr.proposal)
        proposal.signature = signed.signature
        proposal.timestamp = signed.timestamp

    def ping(self) -> bool:
        resp = self.endpoint.send_request(pv.PrivvalMessage(ping_request=pv.PingRequest()))
        return resp.ping_response is not None


class SignerServer:
    """Signer-side: dials the validator and serves signing requests with
    a local FilePV (ref: privval/signer_server.go + signer_dialer_endpoint.go).

    Reconnects with backoff; the FilePV's last-sign-state file gives
    double-sign protection across signer restarts."""

    def __init__(
        self,
        addr: str,
        file_pv,
        chain_id: str,
        priv_key: Ed25519PrivKey | None = None,
        retry_wait: float = 0.2,
        max_dial_retries: int = 100,
        logger=None,
    ):
        self.addr = addr
        self.file_pv = file_pv
        self.chain_id = chain_id
        self.priv_key = priv_key or Ed25519PrivKey.generate()
        self.retry_wait = retry_wait
        self.max_dial_retries = max_dial_retries
        self.logger = logger or new_logger("signer-server")
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, daemon=True, name="signer-server")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            # a signer thread outliving stop() can redial an ephemeral
            # port later reused by an unrelated validator (observed as a
            # rare cross-test flake) — wait for real thread death
            self._thread.join(timeout=2 * DEFAULT_TIMEOUT_READ_WRITE + 2)
            if self._thread.is_alive():
                self.logger.error("signer thread did not exit cleanly")

    def _dial(self):
        family, sockaddr, is_tcp = _parse_addr(self.addr)
        sock = socket.socket(family, socket.SOCK_STREAM)
        sock.settimeout(DEFAULT_TIMEOUT_READ_WRITE)
        sock.connect(sockaddr)
        return SecretConnection(sock, self.priv_key) if is_tcp else _PlainConn(sock)

    def _run(self) -> None:
        retries = 0
        while not self._stop.is_set() and retries < self.max_dial_retries:
            try:
                conn = self._dial()
            except OSError:
                retries += 1
                time.sleep(self.retry_wait)
                continue
            if self._stop.is_set():
                conn.close()
                return
            retries = 0
            self.logger.info("connected to validator", addr=self.addr)
            try:
                self._serve(conn)
            except Exception as e:
                # any escape here must lead back to the redial loop — a
                # dead signer thread means the validator can never sign
                self.logger.error("signer connection error", err=repr(e))
            finally:
                conn.close()

    def _serve(self, conn) -> None:
        while not self._stop.is_set():
            try:
                req = _read_msg(conn)
            except socket.timeout:
                continue  # idle poll; mid-message timeouts raise ConnectionError
            _write_msg(conn, self._handle(req))

    def _handle(self, req: pv.PrivvalMessage) -> pv.PrivvalMessage:
        """ref: privval/signer_requestHandler.go DefaultValidationRequestHandler.
        Always answers — malformed request contents become error
        responses, never a dead connection."""
        from ..proto.messages import PublicKey

        if req.ping_request is not None:
            return pv.PrivvalMessage(ping_response=pv.PingResponse())
        if req.pub_key_request is not None:
            pk = self.file_pv.get_pub_key()
            return pv.PrivvalMessage(
                pub_key_response=pv.PubKeyResponse(pub_key=PublicKey(ed25519=pk.bytes()))
            )
        if req.sign_vote_request is not None:
            svr = req.sign_vote_request
            try:
                vote = Vote.from_proto(svr.vote)
                self.file_pv.sign_vote(svr.chain_id or self.chain_id, vote)
                return pv.PrivvalMessage(
                    signed_vote_response=pv.SignedVoteResponse(vote=vote.to_proto())
                )
            except Exception as e:
                return pv.PrivvalMessage(
                    signed_vote_response=pv.SignedVoteResponse(
                        error=pv.RemoteSignerError(code=pv.ERRORS_UNKNOWN, description=str(e))
                    )
                )
        if req.sign_proposal_request is not None:
            spr = req.sign_proposal_request
            try:
                proposal = Proposal.from_proto(spr.proposal)
                self.file_pv.sign_proposal(spr.chain_id or self.chain_id, proposal)
                return pv.PrivvalMessage(
                    signed_proposal_response=pv.SignedProposalResponse(proposal=proposal.to_proto())
                )
            except Exception as e:
                return pv.PrivvalMessage(
                    signed_proposal_response=pv.SignedProposalResponse(
                        error=pv.RemoteSignerError(code=pv.ERRORS_UNKNOWN, description=str(e))
                    )
                )
        return pv.PrivvalMessage(
            pub_key_response=pv.PubKeyResponse(
                error=pv.RemoteSignerError(
                    code=pv.ERRORS_UNEXPECTED_RESPONSE, description="unknown request"
                )
            )
        )
