"""Evidence gossip reactor (ref: internal/evidence/reactor.go), a copy of
the JAX package's evidence/reactor.py with the same wire bytes.

Broadcasts pending evidence to every peer from one thread walking the pool
(the reference walks a clist, reactor.go:159 broadcastEvidenceLoop);
inbound evidence is added to the pool, invalid senders are reported.

Port-only: a fault of the verifier beneath add_evidence (crypto/batch.py
mark_fault: a kernel wrapper's guard, a failed build or launch) says
nothing of the evidence or its sender. Where the reference reports any
error of add_evidence as the sender's, this reactor, on a marked fault,
reports no peer, stops its loops and hands the fault to `on_fatal`. The
reactor runs no device code and takes no `device`: the EvidencePool does.
"""

from __future__ import annotations

import threading

from ..crypto.batch import is_fault
from ..p2p.types import (
    CHANNEL_EVIDENCE,
    ChannelDescriptor,
    PEER_STATUS_UP,
    PeerError,
)
from ..proto import messages as pb
from ..types.evidence import evidence_from_proto, evidence_to_proto
from .pool import EvidencePool


def evidence_channel_descriptor() -> ChannelDescriptor:
    """Channel 0x38, priority 6 (ref: evidence/reactor.go:21,36-39)."""
    return ChannelDescriptor(
        id=CHANNEL_EVIDENCE,
        name="evidence",
        priority=6,
        recv_message_capacity=1048576,
        encode=lambda ev: evidence_to_proto(ev).encode(),
        decode=lambda b: evidence_from_proto(pb.Evidence.decode(b)),
    )


class EvidenceReactor:
    BROADCAST_INTERVAL = 0.5  # re-scan cadence for new pending evidence

    def __init__(self, pool: EvidencePool, channel, peer_manager, on_fatal=None):
        """on_fatal(exc) receives a verifier fault of add_evidence, after
        which the reactor has stopped (`fault` holds it)."""
        self.pool = pool
        self.channel = channel
        self.peer_manager = peer_manager
        self.on_fatal = on_fatal or (lambda exc: None)
        self.fault: BaseException | None = None
        self._peers: dict[str, set[bytes]] = {}  # peer → hashes already sent
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []

    def start(self) -> None:
        self.peer_manager.subscribe(self._on_peer_update)
        for nid in self.peer_manager.peers():
            self._add_peer(nid)
        t = threading.Thread(target=self._recv_loop, daemon=True, name="evidence-recv")
        t.start()
        self._threads.append(t)
        t2 = threading.Thread(target=self._broadcast_loop, daemon=True, name="evidence-bcast")
        t2.start()
        self._threads.append(t2)

    def stop(self) -> None:
        self._stop.set()
        self.peer_manager.unsubscribe(self._on_peer_update)

    def _on_peer_update(self, update) -> None:
        if update.status == PEER_STATUS_UP:
            self._add_peer(update.node_id)
        else:
            with self._lock:
                self._peers.pop(update.node_id, None)

    def _add_peer(self, nid: str) -> None:
        with self._lock:
            self._peers.setdefault(nid, set())

    def _broadcast_loop(self) -> None:
        """Send every pending evidence to every peer exactly once
        (ref: reactor.go:159 broadcastEvidenceLoop)."""
        while not self._stop.is_set():
            pending, _ = self.pool.pending_evidence(1 << 20)
            with self._lock:
                peers = list(self._peers.items())
            for nid, sent in peers:
                for ev in pending:
                    h = ev.hash()
                    if h in sent:
                        continue
                    if self.channel.send_to(nid, ev, timeout=1.0):
                        sent.add(h)
                        if self.pool.metrics is not None:
                            self.pool.metrics.gossiped.add(1)
            self._stop.wait(self.BROADCAST_INTERVAL)

    def _recv_loop(self) -> None:
        """ref: reactor.go:109 handleEvidenceMessage."""
        while not self._stop.is_set():
            env = self.channel.receive_one(timeout=0.2)
            if env is None:
                continue
            try:
                self.pool.add_evidence(env.message)
                with self._lock:
                    sent = self._peers.get(env.from_)
                    if sent is not None:
                        sent.add(env.message.hash())
            except Exception as e:
                if is_fault(e):
                    self.fault = e
                    self.stop()
                    self.on_fatal(e)
                    return
                self.channel.send_error(PeerError(node_id=env.from_, err=e))
