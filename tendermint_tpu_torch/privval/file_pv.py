"""FilePV — disk-backed private validator with double-sign protection
(ref: privval/file.go).

The last-sign-state {height, round, step, signbytes, signature} is
persisted BEFORE a signature is released (saveSigned, file.go:470), so
a crash between signing and broadcasting can never produce two
different signatures for the same HRS: on restart the same-HRS request
either matches the stored sign-bytes (reuse), differs only by
timestamp (reuse with stored timestamp), or conflicts (refuse).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

from ..crypto import PrivKey, PubKey
from ..crypto.ed25519 import Ed25519PrivKey
from ..proto import messages as pb
from ..types.proposal import Proposal
from ..types.vote import PRECOMMIT, PREVOTE, Vote
from ..utils.tmtime import Time

STEP_NONE = 0
STEP_PROPOSE = 1
STEP_PREVOTE = 2
STEP_PRECOMMIT = 3


def vote_to_step(vote: Vote) -> int:
    if vote.type == PREVOTE:
        return STEP_PREVOTE
    if vote.type == PRECOMMIT:
        return STEP_PRECOMMIT
    raise ValueError(f"unknown vote type: {vote.type}")


class DoubleSignError(Exception):
    pass


@dataclass
class LastSignState:
    """ref: FilePVLastSignState (privval/file.go:110)."""

    height: int = 0
    round: int = 0
    step: int = STEP_NONE
    signature: bytes = b""
    sign_bytes: bytes = b""
    file_path: str = ""

    def check_hrs(self, height: int, round_: int, step: int) -> bool:
        """Returns True if we already signed this exact HRS (caller may
        reuse); raises on regression (ref: checkHRS file.go:135)."""
        if self.height > height:
            raise DoubleSignError(f"height regression. Got {height}, last height {self.height}")
        if self.height == height:
            if self.round > round_:
                raise DoubleSignError(
                    f"round regression at height {height}. Got {round_}, last round {self.round}"
                )
            if self.round == round_:
                if self.step > step:
                    raise DoubleSignError(
                        f"step regression at height {height} round {round_}. Got {step}, last step {self.step}"
                    )
                if self.step == step:
                    if self.sign_bytes:
                        if not self.signature:
                            raise RuntimeError("pv: Signature is nil but SignBytes is not!")
                        return True
                    raise DoubleSignError("no SignBytes found")
        return False

    # journal compaction threshold: one line per signed step, rewritten
    # down to the single latest record once it grows past this
    _JOURNAL_MAX_LINES = 512

    def _doc(self) -> dict:
        return {
            "height": str(self.height),
            "round": self.round,
            "step": self.step,
            "signature": self.signature.hex(),
            "signbytes": self.sign_bytes.hex(),
        }

    def save(self) -> None:
        if not self.file_path:
            return
        doc = self._doc()
        _atomic_write(self.file_path, json.dumps(doc, indent=2).encode())
        self._journal_append(doc)

    def _journal_append(self, doc: dict) -> None:
        """Defense against last-sign-state rollback: the state file is a
        single atomically-replaced snapshot, so an operator (or a crash-
        looping supervisor restoring from backup) replaying a STALE copy
        silently lowers the double-sign guard — check_hrs sees an older
        height and hands out a fresh conflicting signature. The journal
        is append-only; `load` adopts its tail whenever the tail is
        ahead of the snapshot, so only deleting BOTH files (or a signer
        that skips FilePV entirely) can double-sign."""
        path = self.file_path + ".journal"
        line = json.dumps(doc, separators=(",", ":")) + "\n"
        with open(path, "a") as f:
            f.write(line)
            f.flush()
            os.fsync(f.fileno())
        try:
            with open(path) as f:
                n = sum(1 for _ in f)
        except OSError:
            return
        if n > self._JOURNAL_MAX_LINES:
            _atomic_write(path, line.encode())

    @staticmethod
    def _journal_tail(path: str) -> dict | None:
        """Last parseable journal record (a torn final line — crash mid
        append — falls back to the previous one)."""
        try:
            with open(path) as f:
                lines = f.read().splitlines()
        except OSError:
            return None
        for raw in reversed(lines):
            try:
                doc = json.loads(raw)
            except ValueError:
                continue
            if isinstance(doc, dict):
                return doc
        return None

    @classmethod
    def load(cls, path: str) -> "LastSignState":
        if not os.path.exists(path):
            return cls(file_path=path)
        with open(path, "rb") as f:
            doc = json.loads(f.read() or b"{}")
        tail = cls._journal_tail(path + ".journal")
        if tail is not None:
            snap_hrs = (int(doc.get("height", "0")), doc.get("round", 0), doc.get("step", STEP_NONE))
            tail_hrs = (int(tail.get("height", "0")), tail.get("round", 0), tail.get("step", STEP_NONE))
            if tail_hrs > snap_hrs:
                doc = tail  # stale snapshot replayed under a newer journal
        return cls(
            height=int(doc.get("height", "0")),
            round=doc.get("round", 0),
            step=doc.get("step", STEP_NONE),
            signature=bytes.fromhex(doc.get("signature", "")),
            sign_bytes=bytes.fromhex(doc.get("signbytes", "")),
            file_path=path,
        )


def _atomic_write(path: str, data: bytes) -> None:
    """ref: internal/libs/tempfile.WriteFileAtomic."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


@dataclass
class FilePV:
    """ref: privval.FilePV (privval/file.go:186)."""

    priv_key: PrivKey
    key_file_path: str = ""
    last_sign_state: LastSignState = field(default_factory=LastSignState)

    # ------------------------------------------------------ construction

    @classmethod
    def generate(cls, key_file_path: str = "", state_file_path: str = "", seed: bytes | None = None,
                 key_type: str = "ed25519") -> "FilePV":
        """ref: privval.GenFilePV with a key type (file.go:200)."""
        if key_type == "ed25519":
            priv = Ed25519PrivKey.generate(seed)
        elif key_type == "sr25519":
            from ..crypto.sr25519 import Sr25519PrivKey

            priv = Sr25519PrivKey.generate(seed)
        elif key_type == "secp256k1":
            from ..crypto.secp256k1 import Secp256k1PrivKey

            priv = Secp256k1PrivKey.generate(seed)
        else:
            raise ValueError(f"unsupported key type {key_type!r}")
        pv = cls(
            priv_key=priv,
            key_file_path=key_file_path,
            last_sign_state=LastSignState(file_path=state_file_path),
        )
        if key_file_path:
            pv.save_key()
        if state_file_path:
            pv.last_sign_state.save()
        return pv

    @classmethod
    def load(cls, key_file_path: str, state_file_path: str) -> "FilePV":
        with open(key_file_path, "rb") as f:
            doc = json.loads(f.read())
        import base64

        ktype = doc.get("priv_key", {}).get("type")
        raw = base64.b64decode(doc["priv_key"]["value"])
        if ktype == "tendermint/PrivKeyEd25519":
            priv = Ed25519PrivKey(raw)
        elif ktype == "tendermint/PrivKeySr25519":
            from ..crypto.sr25519 import Sr25519PrivKey

            priv = Sr25519PrivKey(raw)
        elif ktype == "tendermint/PrivKeySecp256k1":
            from ..crypto.secp256k1 import Secp256k1PrivKey

            priv = Secp256k1PrivKey(raw)
        else:
            raise ValueError(f"unsupported priv key type {ktype}")
        return cls(
            priv_key=priv,
            key_file_path=key_file_path,
            last_sign_state=LastSignState.load(state_file_path),
        )

    @classmethod
    def load_or_generate(cls, key_file_path: str, state_file_path: str, seed: bytes | None = None,
                         key_type: str = "ed25519") -> "FilePV":
        if os.path.exists(key_file_path):
            return cls.load(key_file_path, state_file_path)
        return cls.generate(key_file_path, state_file_path, seed, key_type=key_type)

    _JSON_KEY_TAGS = {
        "ed25519": ("tendermint/PubKeyEd25519", "tendermint/PrivKeyEd25519"),
        "sr25519": ("tendermint/PubKeySr25519", "tendermint/PrivKeySr25519"),
        "secp256k1": ("tendermint/PubKeySecp256k1", "tendermint/PrivKeySecp256k1"),
    }

    def save_key(self) -> None:
        import base64

        pub = self.priv_key.pub_key()
        pub_tag, priv_tag = self._JSON_KEY_TAGS[self.priv_key.type_name]
        doc = {
            "address": pub.address().hex().upper(),
            "pub_key": {"type": pub_tag, "value": base64.b64encode(pub.bytes()).decode()},
            "priv_key": {
                "type": priv_tag,
                "value": base64.b64encode(self.priv_key.bytes()).decode(),
            },
        }
        _atomic_write(self.key_file_path, json.dumps(doc, indent=2).encode())

    # --------------------------------------------------------- interface

    def get_pub_key(self) -> PubKey:
        return self.priv_key.pub_key()

    @property
    def address(self) -> bytes:
        return self.priv_key.pub_key().address()

    def sign_vote(self, chain_id: str, vote: Vote) -> None:
        """Sign (mutating vote.signature / extension_signature) with the
        double-sign guard (ref: signVote file.go:359)."""
        step = vote_to_step(vote)
        lss = self.last_sign_state
        same_hrs = lss.check_hrs(vote.height, vote.round, step)

        sign_bytes = vote.sign_bytes(chain_id)

        # Extensions are re-signed every time (app may produce a different
        # extension); only non-nil precommits carry them (file.go:380).
        ext_sig = b""
        if vote.type == PRECOMMIT and not vote.block_id.is_nil():
            ext_sig = self.priv_key.sign(vote.extension_sign_bytes(chain_id))
        elif vote.extension:
            raise ValueError("unexpected vote extension - extensions are only allowed in non-nil precommits")

        if same_hrs:
            if sign_bytes == lss.sign_bytes:
                vote.signature = lss.signature
            else:
                ts = _votes_only_differ_by_timestamp(lss.sign_bytes, sign_bytes)
                if ts is None:
                    raise DoubleSignError("conflicting data")
                vote.timestamp = ts
                vote.signature = lss.signature
            vote.extension_signature = ext_sig
            return

        sig = self.priv_key.sign(sign_bytes)
        self._save_signed(vote.height, vote.round, step, sign_bytes, sig)
        vote.signature = sig
        vote.extension_signature = ext_sig

    def sign_proposal(self, chain_id: str, proposal: Proposal) -> None:
        """ref: signProposal (file.go:434)."""
        lss = self.last_sign_state
        same_hrs = lss.check_hrs(proposal.height, proposal.round, STEP_PROPOSE)
        sign_bytes = proposal.sign_bytes(chain_id)
        if same_hrs:
            if sign_bytes != lss.sign_bytes:
                raise DoubleSignError("conflicting data")
            proposal.signature = lss.signature
            return
        sig = self.priv_key.sign(sign_bytes)
        self._save_signed(proposal.height, proposal.round, STEP_PROPOSE, sign_bytes, sig)
        proposal.signature = sig

    def _save_signed(self, height: int, round_: int, step: int, sign_bytes: bytes, sig: bytes) -> None:
        lss = self.last_sign_state
        lss.height, lss.round, lss.step = height, round_, step
        lss.signature, lss.sign_bytes = sig, sign_bytes
        lss.save()


def _votes_only_differ_by_timestamp(last_sign_bytes: bytes, new_sign_bytes: bytes) -> Time | None:
    """If the two canonical vote encodings differ only in timestamp,
    return the LAST timestamp to reuse; else None
    (ref: checkVotesOnlyDifferByTimestamp file.go:498)."""
    last_vote, _ = pb.CanonicalVote.decode_delimited(last_sign_bytes)
    new_vote, _ = pb.CanonicalVote.decode_delimited(new_sign_bytes)
    last_ts = last_vote.timestamp or pb.Timestamp()
    now = pb.Timestamp(seconds=0, nanos=0)
    last_vote.timestamp = now
    new_vote.timestamp = now
    if last_vote.encode() == new_vote.encode():
        return Time(last_ts.seconds or 0, last_ts.nanos or 0)
    return None
