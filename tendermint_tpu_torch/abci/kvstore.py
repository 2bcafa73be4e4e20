"""The kvstore example application (ref: abci/example/kvstore/kvstore.go,
persistent_kvstore.go), the reference's app for tests and replays.

Transactions are "key=value" (raw bytes without "=" mean key = value =
tx) or "val:[type:]base64pubkey!power" validator-set updates; the app
state is the JSON {size, height, app_hash} under stateKey; the app hash is
the 8-byte varint of size; a duplicate vote costs its validator one power
in FinalizeBlock. With a snapshot_interval, the app takes a chunked
snapshot of its committed state at every multiple of it (ref:
test/e2e/app/snapshots.go) and serves and restores them for state sync.
"""

from __future__ import annotations

import base64
import json
import threading

from ..store.kv import KVStore, MemDB
from . import types as abci

STATE_KEY = b"stateKey"
KV_PAIR_PREFIX_KEY = b"kvPairKey:"
VALIDATOR_PREFIX = "val:"
PROTOCOL_VERSION = 0x1

CODE_TYPE_ENCODING_ERROR = 1
CODE_TYPE_BAD_NONCE = 2
CODE_TYPE_UNAUTHORIZED = 3
CODE_TYPE_EXECUTED = 5


def _put_varint(n: int) -> bytes:
    """Go binary.PutVarint zigzag encoding into an 8-byte buffer
    (ref: kvstore.go:201-203 AppHash layout)."""
    ux = (n << 1) ^ (n >> 63) if n < 0 else n << 1
    out = bytearray()
    while ux >= 0x80:
        out.append((ux & 0x7F) | 0x80)
        ux >>= 7
    out.append(ux)
    out.extend(b"\x00" * (8 - len(out)))
    return bytes(out[:8])


def prefix_key(key: bytes) -> bytes:
    return KV_PAIR_PREFIX_KEY + key


class KVStoreApplication(abci.Application):
    """ref: kvstore.Application (abci/example/kvstore/kvstore.go:74)."""

    SNAPSHOT_CHUNK_SIZE = 16 * 1024  # ref: test/e2e/app/snapshots.go snapshotChunkSize

    def __init__(self, db: KVStore | None = None, retain_blocks: int = 0, snapshot_interval: int = 0):
        self._mu = threading.Lock()
        self.db = db if db is not None else MemDB()
        self.retain_blocks = retain_blocks
        self.snapshot_interval = snapshot_interval
        self.size = 0
        self.height = 0
        self.app_hash = b""
        self.val_updates: list[abci.ValidatorUpdate] = []
        self.val_addr_to_pubkey: dict[bytes, tuple[str, bytes]] = {}
        self._snapshots: dict[int, tuple[abci.Snapshot, list[bytes]]] = {}
        self._restore: tuple[abci.Snapshot, list[bytes | None]] | None = None
        # FinalizeBlock effects are buffered here (key -> value, None =
        # delete) and published to the db at Commit: Info can then
        # honestly report the last PERSISTED height (the ABCI contract),
        # and a node that crashed mid-block can reconnect to an
        # out-of-process app and replay the block without double-applying
        # (reload_committed drops the buffer).
        self._pending: dict[bytes, bytes | None] = {}
        self._committed = (0, 0, b"")  # (height, size, app_hash)
        self._load_state()

    # ------------------------------------------------------------ state io

    def _load_state(self) -> None:
        raw = self.db.get(STATE_KEY)
        if raw:
            doc = json.loads(raw)
            self.size = doc.get("size", 0)
            self.height = doc.get("height", 0)
            self.app_hash = base64.b64decode(doc.get("app_hash") or "")
        else:
            # No persisted state: reset any dirty in-memory values so a
            # reload after a crash mid-first-block (FinalizeBlock done,
            # Commit never arrived) reports genesis, not the uncommitted
            # height whose effects were just discarded.
            self.size = 0
            self.height = 0
            self.app_hash = b""
        self._committed = (self.height, self.size, self.app_hash)
        self.val_addr_to_pubkey = {}
        for k, v in self.db.iterator(b"val:", b"val;"):
            kt, _ = self._parse_val_value(v)
            self.val_addr_to_pubkey[self._pub_to_addr(kt, k[4:])] = (kt, k[4:])

    def reload_committed(self) -> None:
        """Drop uncommitted FinalizeBlock effects and return to the last
        persisted state. Called by the out-of-process transports when a
        (possibly restarted) node connects: the node's handshake will
        decide what to replay based on Info, which must not include a
        block whose Commit never arrived."""
        with self._mu:
            self._rollback_pending_locked()

    def _rollback_pending_locked(self) -> None:
        self._pending.clear()
        self.val_updates = []
        self._load_state()

    # merged (committed + pending) views used inside a block
    def _db_get(self, key: bytes):
        if key in self._pending:
            return self._pending[key]
        return self.db.get(key)

    def _db_has(self, key: bytes) -> bool:
        if key in self._pending:
            return self._pending[key] is not None
        return self.db.has(key)

    def _iter_merged(self, start: bytes, end: bytes):
        merged = {k: v for k, v in self.db.iterator(start, end)}
        for k, v in self._pending.items():
            if start <= k < end:
                if v is None:
                    merged.pop(k, None)
                else:
                    merged[k] = v
        return sorted(merged.items())

    def _save_state(self) -> None:
        doc = {
            "size": self.size,
            "height": self.height,
            "app_hash": base64.b64encode(self.app_hash).decode(),
        }
        self.db.set(STATE_KEY, json.dumps(doc).encode())
        self._committed = (self.height, self.size, self.app_hash)

    @staticmethod
    def _pub_to_addr(key_type: str, pub: bytes) -> bytes:
        """Address derivation per key type: ed25519/sr25519 share the
        sha256[:20] address hash; secp256k1 uses RIPEMD160(SHA256)."""
        if key_type == "secp256k1":
            from ..crypto.secp256k1 import Secp256k1PubKey

            return Secp256k1PubKey(pub).address()
        from ..crypto.ed25519 import address_hash

        return address_hash(pub)

    @staticmethod
    def _parse_val_value(v: bytes) -> tuple[str, int]:
        """Stored val: entry value 'type:power' (bare 'power' = ed25519,
        the pre-multi-keytype format and the reference's)."""
        if b":" in v:
            kt, power = v.split(b":", 1)
            return kt.decode(), int(power)
        return "ed25519", int(v)

    # ------------------------------------------------------------ abci

    def info(self, req: abci.RequestInfo) -> abci.ResponseInfo:
        with self._mu:
            # committed values ONLY: reporting a height whose Commit has
            # not happened would make a reconnecting node skip replaying
            # a block the app never persisted (ABCI contract:
            # last_block_height = latest persisted height)
            c_height, c_size, c_app_hash = self._committed
            return abci.ResponseInfo(
                data='{"size":%d}' % c_size,
                version="0.17.0",
                app_version=PROTOCOL_VERSION,
                last_block_height=c_height,
                last_block_app_hash=c_app_hash,
            )

    def init_chain(self, req: abci.RequestInitChain) -> abci.ResponseInitChain:
        with self._mu:
            for v in req.validators:
                r = self._update_validator(v)
                if r.code != abci.CODE_TYPE_OK:
                    raise RuntimeError(f"problem updating validators: {r.log}")
            return abci.ResponseInitChain()

    def check_tx(self, req: abci.RequestCheckTx) -> abci.ResponseCheckTx:
        return abci.ResponseCheckTx(code=abci.CODE_TYPE_OK, gas_wanted=1)

    def finalize_block(self, req: abci.RequestFinalizeBlock) -> abci.ResponseFinalizeBlock:
        with self._mu:
            # Replay of an in-flight block whose Commit never arrived
            # (crash between FinalizeBlock(h) and Commit, then handshake
            # replays h): roll back to the persisted state first so the
            # block is not applied on top of its own dirty effects. This
            # keeps replay idempotent even when the transport-level
            # reload was skipped (e.g. a monitoring connection was open
            # at reconnect time, or the reconnect raced the dead
            # connection's cleanup).
            if (
                req.height
                and req.height == self._committed[0] + 1
                and self.height == req.height
            ):
                self._rollback_pending_locked()
            self.val_updates = []
            for ev in req.misbehavior:
                if ev.type == abci.MISBEHAVIOR_DUPLICATE_VOTE:
                    entry = self.val_addr_to_pubkey.get(ev.validator.address)
                    if entry is None:
                        # The reference app panics here too (kvstore.go:186)
                        raise RuntimeError(f"wanted to punish val {ev.validator.address.hex()} but can't find it")
                    self._update_validator(
                        abci.ValidatorUpdate(pub_key_type=entry[0], pub_key_bytes=entry[1], power=ev.validator.power - 1)
                    )
            tx_results = [self._handle_tx(tx) for tx in req.txs]
            self.app_hash = self._compute_app_hash()
            self.height += 1
            return abci.ResponseFinalizeBlock(
                tx_results=tx_results,
                validator_updates=list(self.val_updates),
                app_hash=self.app_hash,
            )

    def commit(self) -> abci.ResponseCommit:
        with self._mu:
            # publish the block's buffered writes, then the state doc
            for k, v in self._pending.items():
                if v is None:
                    self.db.delete(k)
                else:
                    self.db.set(k, v)
            self._pending.clear()
            self._save_state()
            if self.snapshot_interval and self.height > 0 and self.height % self.snapshot_interval == 0:
                self._take_snapshot()
            resp = abci.ResponseCommit()
            if self.retain_blocks > 0 and self.height >= self.retain_blocks:
                resp.retain_height = self.height - self.retain_blocks + 1
            return resp

    def _compute_app_hash(self) -> bytes:
        """App hash at the end of FinalizeBlock (called under _mu): the
        8-byte varint of size (kvstore.go:201-203)."""
        return _put_varint(self.size)

    # ----------------------------------------------------------- snapshots
    # ref: test/e2e/app/snapshots.go, the e2e app's chunked state export

    def _iter_state_items(self):
        """(key, value) pairs of the committed state in key order."""
        yield from self.db.iterator(None, None)

    def _iter_serialized_state(self):
        """The snapshot document, json.dumps({height, size, app_hash,
        items}, sort_keys=True) of the committed state, in pieces, without
        the whole string: the JSON keys in sorted order (app_hash < height <
        items < size), the items in key order, which is their hex order."""
        yield ('{"app_hash": "%s", "height": %d, "items": ['
               % (self.app_hash.hex(), self.height)).encode()
        first = True
        for k, v in self._iter_state_items():
            piece = '["%s", "%s"]' % (k.hex(), v.hex())
            yield (piece if first else ", " + piece).encode()
            first = False
        yield ('], "size": %d}' % self.size).encode()

    def _take_snapshot(self) -> None:
        import hashlib

        hasher = hashlib.sha256()
        chunks: list[bytes] = []
        buf = bytearray()
        for piece in self._iter_serialized_state():
            hasher.update(piece)
            buf += piece
            while len(buf) >= self.SNAPSHOT_CHUNK_SIZE:
                chunks.append(bytes(buf[: self.SNAPSHOT_CHUNK_SIZE]))
                del buf[: self.SNAPSHOT_CHUNK_SIZE]
        if buf or not chunks:
            chunks.append(bytes(buf))
        snap = abci.Snapshot(
            height=self.height,
            format=1,
            chunks=len(chunks),
            hash=hasher.digest(),
        )
        self._snapshots[self.height] = (snap, chunks)
        # keep the newest eight, so that a sync in flight can still fetch
        # its chunks
        for h in sorted(self._snapshots)[:-8]:
            del self._snapshots[h]

    def list_snapshots(self, req: abci.RequestListSnapshots) -> abci.ResponseListSnapshots:
        with self._mu:
            return abci.ResponseListSnapshots(
                snapshots=[s for s, _ in sorted(self._snapshots.values(), key=lambda t: t[0].height)]
            )

    def offer_snapshot(self, req: abci.RequestOfferSnapshot) -> abci.ResponseOfferSnapshot:
        with self._mu:
            if req.snapshot.format != 1:
                return abci.ResponseOfferSnapshot(result=abci.SNAPSHOT_REJECT_FORMAT)
            if req.snapshot.chunks <= 0:
                return abci.ResponseOfferSnapshot(result=abci.SNAPSHOT_REJECT)
            self._restore = (req.snapshot, [None] * req.snapshot.chunks)
            return abci.ResponseOfferSnapshot(result=abci.SNAPSHOT_ACCEPT)

    def load_snapshot_chunk(self, req: abci.RequestLoadSnapshotChunk) -> abci.ResponseLoadSnapshotChunk:
        with self._mu:
            entry = self._snapshots.get(req.height)
            if entry is None or entry[0].format != req.format or req.chunk >= len(entry[1]):
                return abci.ResponseLoadSnapshotChunk(chunk=b"")
            return abci.ResponseLoadSnapshotChunk(chunk=entry[1][req.chunk])

    def apply_snapshot_chunk(self, req: abci.RequestApplySnapshotChunk) -> abci.ResponseApplySnapshotChunk:
        import hashlib

        with self._mu:
            if self._restore is None:
                return abci.ResponseApplySnapshotChunk(result=abci.CHUNK_ABORT)
            snap, chunks = self._restore
            if req.index >= len(chunks):
                return abci.ResponseApplySnapshotChunk(result=abci.CHUNK_REJECT_SNAPSHOT)
            chunks[req.index] = req.chunk
            if any(c is None for c in chunks):
                return abci.ResponseApplySnapshotChunk(result=abci.CHUNK_ACCEPT)
            data = b"".join(chunks)
            if hashlib.sha256(data).digest() != snap.hash:
                self._restore = (snap, [None] * len(chunks))
                return abci.ResponseApplySnapshotChunk(
                    result=abci.CHUNK_RETRY_SNAPSHOT, refetch_chunks=list(range(len(chunks))),
                    reject_senders=[req.sender] if req.sender else [],
                )
            doc = json.loads(data)
            # the snapshot is the whole state: effects still buffered (a
            # state-syncing node's InitChain writes) would overlay the
            # restored db and fork the app hash at the first block after it
            self._pending.clear()
            self.val_updates = []
            for k, v in self.db.iterator(None, None):
                self.db.delete(k)
            for k_hex, v_hex in doc["items"]:
                self.db.set(bytes.fromhex(k_hex), bytes.fromhex(v_hex))
            self.height = doc["height"]
            self.size = doc["size"]
            self.app_hash = bytes.fromhex(doc["app_hash"])
            self.val_addr_to_pubkey = {}
            for k, v in self.db.iterator(b"val:", b"val;"):
                kt, _ = self._parse_val_value(v)
                self.val_addr_to_pubkey[self._pub_to_addr(kt, k[4:])] = (kt, k[4:])
            self._save_state()
            self._restore = None
            return abci.ResponseApplySnapshotChunk(result=abci.CHUNK_ACCEPT)

    def query(self, req: abci.RequestQuery) -> abci.ResponseQuery:
        with self._mu:
            if req.path == "/val":
                value = self.db.get(b"val:" + req.data)
                return abci.ResponseQuery(key=req.data, value=value or b"")
            value = self.db.get(prefix_key(req.data))
            resp = abci.ResponseQuery(
                key=req.data, value=value or b"", height=self.height,
                log="exists" if value is not None else "does not exist",
            )
            return resp

    # ------------------------------------------------------------ tx exec

    def _handle_tx(self, tx: bytes) -> abci.ExecTxResult:
        """ref: kvstore.go:121 handleTx."""
        if tx.startswith(VALIDATOR_PREFIX.encode()):
            return self._exec_validator_tx(tx)
        parts = tx.split(b"=")
        if len(parts) == 2:
            key, value = parts[0], parts[1]
        else:
            key, value = tx, tx
        self._pending[prefix_key(key)] = value
        self.size += 1
        events = [
            abci.Event(
                type="app",
                attributes=[
                    abci.EventAttribute("creator", "Cosmoshi Netowoko", True),
                    abci.EventAttribute("key", key.decode("utf-8", "replace"), True),
                    abci.EventAttribute("index_key", "index is working", True),
                    abci.EventAttribute("noindex_key", "index is working", False),
                ],
            )
        ]
        return abci.ExecTxResult(code=abci.CODE_TYPE_OK, events=events)

    def _exec_validator_tx(self, tx: bytes) -> abci.ExecTxResult:
        """ref: kvstore.go:343 execValidatorTx: "val:base64pubkey!power"."""
        body = tx[len(VALIDATOR_PREFIX):]
        parts = body.split(b"!")
        if len(parts) != 2:
            return abci.ExecTxResult(
                code=CODE_TYPE_ENCODING_ERROR,
                log=f"Expected 'pubkey!power'. Got {body!r}",
            )
        pub_s, power_s = parts
        # optional key-type prefix "type:base64pub" (bare base64 =
        # ed25519, byte-compatible with the reference's MakeValSetChangeTx;
        # ':' cannot appear in base64, so the split is unambiguous)
        key_type = "ed25519"
        if b":" in pub_s:
            kt, pub_s = pub_s.split(b":", 1)
            key_type = kt.decode("utf-8", "replace")
            if key_type not in ("ed25519", "sr25519", "secp256k1"):
                return abci.ExecTxResult(
                    code=CODE_TYPE_ENCODING_ERROR, log=f"Unknown key type {key_type!r}"
                )
        try:
            pub = base64.b64decode(pub_s, validate=True)
        except Exception:
            return abci.ExecTxResult(code=CODE_TYPE_ENCODING_ERROR, log=f"Pubkey ({pub_s!r}) is invalid base64")
        try:
            power = int(power_s)
        except ValueError:
            return abci.ExecTxResult(code=CODE_TYPE_ENCODING_ERROR, log=f"Power ({power_s!r}) is not an int")
        return self._update_validator(abci.ValidatorUpdate(pub_key_type=key_type, pub_key_bytes=pub, power=power))

    def _update_validator(self, v: abci.ValidatorUpdate) -> abci.ExecTxResult:
        """ref: kvstore.go:380 updateValidator: stored under val:pubkeybytes
        and listed in val_updates for the block's response."""
        key = b"val:" + v.pub_key_bytes
        addr = self._pub_to_addr(v.pub_key_type, v.pub_key_bytes)
        if v.power == 0:
            if not self._db_has(key):
                pub_str = base64.b64encode(v.pub_key_bytes).decode()
                return abci.ExecTxResult(
                    code=CODE_TYPE_UNAUTHORIZED,
                    log=f"Cannot remove non-existent validator {pub_str}",
                )
            self._pending[key] = None
            self.val_addr_to_pubkey.pop(addr, None)
        else:
            self._pending[key] = f"{v.pub_key_type}:{v.power}".encode()
            self.val_addr_to_pubkey[addr] = (v.pub_key_type, v.pub_key_bytes)
        self.val_updates = [u for u in self.val_updates if u.pub_key_bytes != v.pub_key_bytes]
        self.val_updates.append(v)
        return abci.ExecTxResult(code=abci.CODE_TYPE_OK)

    def validators(self) -> list[abci.ValidatorUpdate]:
        """Current validator set from the tree (ref: kvstore.go:306)."""
        out = []
        with self._mu:
            for k, v in self._iter_merged(b"val:", b"val;"):
                kt, power = self._parse_val_value(v)
                out.append(abci.ValidatorUpdate(pub_key_type=kt, pub_key_bytes=k[4:], power=power))
        return out


def make_validator_tx(pub_key_bytes: bytes, power: int, key_type: str = "ed25519") -> bytes:
    """ref: kvstore.go:334 MakeValSetChangeTx. Non-ed25519 key types
    carry a 'type:' prefix (the bare form stays byte-compatible with
    the reference's ed25519-only txs)."""
    prefix = b"" if key_type == "ed25519" else key_type.encode() + b":"
    return b"val:" + prefix + base64.b64encode(pub_key_bytes) + b"!" + str(power).encode()
