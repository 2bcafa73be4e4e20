"""Mempool gossip reactor (ref: internal/mempool/reactor.go), a copy of the
JAX package's mempool/reactor.py with the same wire bytes.

One broadcast thread PER PEER walks the mempool's tx list (the
reference's clist walk, reactor.go:279 broadcastTxRoutine), batching
every tx the peer hasn't seen into multi-tx `Txs` frames on channel
0x30 — one frame per wakeup instead of one frame per tx per 20 ms
sweep. Threads are condition-driven: they sleep until the mempool
admits new txs (TxMempool.add_new_tx_listener) or a peer arrives, so an
idle pool costs zero sweeps; and a slow peer blocks only its own
thread, never the others (the old single shared broadcast thread
stalled ALL peers behind one 0.5 s send timeout).

Wire format: a Txs frame is TXS_FRAME_MAGIC | uvarint count |
(uvarint len | tx bytes)*; any frame NOT starting with the magic is
decoded as a legacy single-tx frame (the previous one-tx-per-frame
format). Compatibility is RECEIVE-side: this node understands legacy
senders, but always emits multi-tx frames itself — a pre-PR-6 peer
cannot decode them, so tx gossip toward such a peer requires upgrading
it (the repo deploys one version per net; there is no cross-version
negotiation anywhere in this p2p stack). The recv path feeds whole
frames into TxMempool.check_tx_batch — gossip floods admit through the
same coalesced pipeline RPC uses. Channel 0x30, priority 5.

Port-only: a fault of the signature pre-verifier (crypto/batch.py
mark_fault: a kernel wrapper's guard, a failed build or launch) is not a
verdict on the batch. Where the reference drops the whole batch on any
error of check_tx_batch, this reactor drops it on the other errors (the
app's, its transport's) but, on a marked fault, stops its loops and hands
the fault to `on_fatal`. The pre-verifier runs before the cache takes the
txs, so they may be submitted again. The reactor itself runs no device
code and takes no `device`: the TxMempool's EngineTxPreVerifier does.
"""

from __future__ import annotations

import threading

from ..crypto.batch import is_fault
from ..p2p.types import CHANNEL_MEMPOOL, ChannelDescriptor, PEER_STATUS_UP, PeerError
from ..utils.varint import encode_uvarint as _uvarint
from ..utils.varint import read_uvarint as _read_uvarint
from .mempool import TxInCacheError, TxMempool, TxPolicyError, tx_key, tx_keys_batch

__all__ = [
    "MempoolReactor",
    "mempool_channel_descriptor",
    "encode_txs_frame",
    "decode_txs_frame",
    "TXS_FRAME_MAGIC",
    "tx_key",
]

# Multi-tx frame marker. A legacy peer's raw single-tx frame that
# happens to start with these bytes would mis-decode; the sequence is
# chosen to be invalid UTF-8 and absent from every app tx format in the
# repo (kvstore "k=v", signed-tx envelopes).
TXS_FRAME_MAGIC = b"\xf1\x00TXS"

# Per-frame caps: stay well under the channel's 1 MiB
# recv_message_capacity and keep one slow frame from monopolizing a
# peer's send queue slot.
MAX_FRAME_TXS = 256
MAX_FRAME_BYTES = 512 * 1024
# Receive-side hard cap (generous slack over the send cap for future
# senders): one malicious frame declaring millions of tiny txs must be
# a protocol fault, not an unbounded check_tx_batch that stalls
# consensus behind a multi-second settle.
MAX_DECODE_TXS = 4096


def encode_txs_frame(txs) -> bytes:
    """list of txs -> one length-prefixed multi-tx wire frame."""
    parts = [TXS_FRAME_MAGIC, _uvarint(len(txs))]
    for tx in txs:
        parts.append(_uvarint(len(tx)))
        parts.append(tx)
    return b"".join(parts)


def decode_txs_frame(frame: bytes) -> list[bytes]:
    """Wire frame -> list of txs. A frame without the magic prefix is a
    legacy single-tx frame (a tx IS bytes on the wire in the old
    format) and decodes to a one-element list. Malformed multi-tx
    frames raise ValueError (a protocol fault the reactor reports)."""
    frame = bytes(frame)
    if not frame.startswith(TXS_FRAME_MAGIC):
        return [frame]
    try:
        pos = len(TXS_FRAME_MAGIC)
        count, pos = _read_uvarint(frame, pos)
        if count > MAX_DECODE_TXS:
            raise ValueError(f"Txs frame declares {count} txs (max {MAX_DECODE_TXS})")
        txs: list[bytes] = []
        for _ in range(count):
            ln, pos = _read_uvarint(frame, pos)
            if pos + ln > len(frame):
                raise ValueError("truncated Txs frame")
            txs.append(frame[pos : pos + ln])
            pos += ln
    except IndexError:
        raise ValueError("truncated Txs frame") from None
    if pos != len(frame):
        raise ValueError("trailing bytes in Txs frame")
    return txs


def _encode_message(msg) -> bytes:
    """Channel codec: a list of txs becomes a multi-tx frame; plain
    bytes stay a legacy single-tx frame (compat path)."""
    if isinstance(msg, (list, tuple)):
        return encode_txs_frame(msg)
    return msg


class MalformedTxsFrame:
    """Decode-failure marker delivered IN-BAND to the reactor: the
    transport/router run the channel decoder before the reactor ever
    sees the envelope, and an exception there tears down the whole
    multiplexed peer connection (consensus channels included) with no
    eviction bookkeeping. The reactor instead receives this marker and
    reports a proper PeerError."""

    __slots__ = ("err",)

    def __init__(self, err: Exception):
        self.err = err


def _decode_message(frame):
    try:
        return decode_txs_frame(frame)
    except ValueError as e:
        return MalformedTxsFrame(e)


def mempool_channel_descriptor() -> ChannelDescriptor:
    """ref: internal/mempool/types.go:14, reactor.go:83-86."""
    return ChannelDescriptor(
        id=CHANNEL_MEMPOOL,
        name="mempool",
        priority=5,
        send_queue_capacity=512,
        recv_message_capacity=1048576,
        encode=_encode_message,
        decode=_decode_message,
    )


class _PeerState:
    __slots__ = ("sent", "wake", "gone")

    def __init__(self):
        self.sent: set[bytes] = set()  # tx keys sent to / known by the peer
        self.wake = threading.Event()
        self.gone = threading.Event()


class MempoolReactor:
    SEND_TIMEOUT = 0.2  # per-frame send timeout (blocks only this peer)
    IDLE_WAIT = 0.5  # wakeup cadence with no new-tx signal (prune, retry)
    PRUNE_EVERY = 64  # prune sent-sets every N wakeups per peer

    def __init__(self, mempool: TxMempool, channel, peer_manager, on_fatal=None):
        """on_fatal(exc) receives a verifier fault of an admission, after
        which the reactor has stopped (`fault` holds it)."""
        self.mempool = mempool
        self.channel = channel
        self.peer_manager = peer_manager
        self.on_fatal = on_fatal or (lambda exc: None)
        self.fault: BaseException | None = None
        self._peers: dict[str, _PeerState] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []

    def start(self) -> None:
        self.mempool.add_new_tx_listener(self._wake_all)
        self.peer_manager.subscribe(self._on_peer_update)
        for nid in self.peer_manager.peers():
            self._add_peer(nid)
        t = threading.Thread(target=self._recv_loop, daemon=True, name="_recv_loop")
        t.start()
        self._threads.append(t)

    def stop(self) -> None:
        self._stop.set()
        self.mempool.remove_new_tx_listener(self._wake_all)
        self.peer_manager.unsubscribe(self._on_peer_update)
        with self._lock:
            for st in self._peers.values():
                st.gone.set()
                st.wake.set()

    def _wake_all(self) -> None:
        with self._lock:
            for st in self._peers.values():
                st.wake.set()

    def _on_peer_update(self, update) -> None:
        if update.status == PEER_STATUS_UP:
            self._add_peer(update.node_id)
        else:
            with self._lock:
                st = self._peers.pop(update.node_id, None)
            if st is not None:
                st.gone.set()
                st.wake.set()

    def _add_peer(self, nid: str) -> None:
        with self._lock:
            if nid in self._peers or self._stop.is_set():
                return
            st = self._peers[nid] = _PeerState()
        # NOT tracked in _threads: peer threads exit on their own when
        # the peer departs (st.gone), and holding dead Thread objects
        # across peer churn would leak
        threading.Thread(
            target=self._peer_loop, args=(nid, st), daemon=True,
            name=f"mempool-gossip-{nid[:8]}",
        ).start()

    # ------------------------------------------------------------ broadcast

    def _peer_loop(self, nid: str, st: _PeerState) -> None:
        """Per-peer broadcast routine (ref: reactor.go:279
        broadcastTxRoutine): drain everything the peer hasn't seen into
        multi-tx frames, then sleep until new txs arrive."""
        wakeups = 0
        while not self._stop.is_set() and not st.gone.is_set():
            # clear BEFORE scanning: a tx admitted after the scan sets
            # the event and the next wait returns immediately
            st.wake.clear()
            batch: list = []
            batch_bytes = 0
            sent_any = False
            for wtx in self.mempool.all_txs():
                if wtx.key in st.sent or nid in wtx.peers:
                    continue  # don't echo a tx back to its source
                batch.append(wtx)
                batch_bytes += len(wtx.tx)
                if len(batch) >= MAX_FRAME_TXS or batch_bytes >= MAX_FRAME_BYTES:
                    if not self._send_frame(nid, st, batch):
                        break
                    sent_any = True
                    batch = []
                    batch_bytes = 0
            if batch:
                if self._send_frame(nid, st, batch):
                    sent_any = True
            wakeups += 1
            if wakeups % self.PRUNE_EVERY == 0:
                # keys no longer in the mempool can be forgotten —
                # bounds memory and lets a re-submitted tx re-propagate
                live = {w.key for w in self.mempool.all_txs()}
                st.sent &= live
            if not sent_any:
                # nothing went out (idle, or the peer's queue is full):
                # wait for new txs, with a cadence floor for retries
                st.wake.wait(self.IDLE_WAIT)

    def _send_frame(self, nid: str, st: _PeerState, batch: list) -> bool:
        """One multi-tx frame to one peer; marks the txs sent on
        success. A timeout/full queue leaves them unmarked for retry and
        stalls only THIS peer's thread."""
        if self._stop.is_set() or st.gone.is_set():
            return False
        if self.channel.send_to(nid, [w.tx for w in batch], timeout=self.SEND_TIMEOUT):
            st.sent.update(w.key for w in batch)
            return True
        return False

    # ----------------------------------------------------------------- recv

    def _recv_loop(self) -> None:
        """ref: reactor.go:119 handleMempoolMessage → CheckTx, batched:
        each received frame (and everything else already queued) admits
        through ONE check_tx_batch call."""
        while not self._stop.is_set():
            env = self.channel.receive_one(timeout=0.2)
            if env is None:
                continue
            txs: list[bytes] = []
            senders: list[str] = []
            while True:
                try:
                    if isinstance(env.message, MalformedTxsFrame):
                        # decoded by the channel codec (TCP path): the
                        # failure arrives in-band so it costs a peer
                        # eviction, not the whole connection teardown
                        raise env.message.err
                    frame = (
                        list(env.message)
                        if isinstance(env.message, (list, tuple))
                        else decode_txs_frame(env.message)
                    )
                except ValueError as e:
                    self.channel.send_error(PeerError(node_id=env.from_, err=e))
                    frame = []
                for tx in frame:
                    txs.append(bytes(tx))
                    senders.append(env.from_)
                if len(txs) >= MAX_FRAME_TXS * 4:
                    break  # bound one admission batch
                env = self.channel.receive_one(timeout=0)
                if env is None:
                    break
            if not txs:
                continue
            keys = tx_keys_batch(txs)
            with self._lock:
                for key, nid in zip(keys, senders):
                    st = self._peers.get(nid)
                    if st is not None:
                        st.sent.add(key)
            try:
                outcomes = self.mempool.check_tx_batch(txs, senders, keys=keys)
            except Exception as e:  # noqa: BLE001
                if is_fault(e):
                    # the verifier failed, not the txs or their senders:
                    # stop, and let the node decide
                    self.fault = e
                    self.stop()
                    self.on_fatal(e)
                    return
                # OUR ABCI client/transport failed, not the peers —
                # evicting whoever happened to be first in the batch
                # would shrink the peer set exactly when this node is
                # already degraded; drop the batch and keep the peers
                continue
            for tx, nid, out in zip(txs, senders, outcomes):
                if isinstance(out, (TxInCacheError, TxPolicyError)):
                    # duplicate (normal gossip redundancy) or policy
                    # rejection (gas/size caps may differ across peers
                    # mid-params-change) — not a peer fault
                    continue
                if isinstance(out, RuntimeError):
                    # full pool: OUR backpressure, not their misbehavior
                    # (the reference logs and drops, reactor.go:131)
                    continue
                if isinstance(out, Exception):
                    # oversize and protocol-class failures evict
                    self.channel.send_error(PeerError(node_id=nid, err=out))
