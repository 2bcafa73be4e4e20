"""Light-block + params dispatch over the statesync p2p channels
(ref: internal/statesync/dispatcher.go).

Correlates LightBlockResponse / ParamsResponse frames (which carry no
request ids) to outstanding requests by height, so the p2p state
provider can fetch the trust chain without any RPC server — the
reference's `use-p2p` statesync mode (stateprovider.go:33-361, p2p
variant)."""

from __future__ import annotations

import queue
import threading

from ..light.provider import ErrNoResponse, Provider
from .reactor import LightBlockRequest, ParamsRequest


class Dispatcher:
    """Installs itself as the reactor's light-block/params response
    waiter. Correlation is per peer with one outstanding request each
    (the wire responses carry no request ids — same constraint and
    solution as the reference's dispatcher): a response from peer X
    resolves X's outstanding request, INCLUDING explicit misses
    (LightBlockResponse without a block), so "don't have it" fails fast
    instead of burning the timeout. Requests go to one peer at a time,
    rotating on miss/timeout — no N-peer fan-out per height."""

    def __init__(self, reactor):
        self.reactor = reactor
        self._lock = threading.Lock()
        self._outstanding: dict[tuple[str, str], tuple[int, queue.Queue]] = {}
        reactor._lb_waiter = self._on_light_block
        reactor._params_waiter = self._on_params

    # ------------------------------------------------------- response sinks

    def _resolve(self, kind: str, peer_id: str, height_of, payload) -> None:
        with self._lock:
            entry = self._outstanding.get((kind, peer_id))
        if entry is None:
            return  # unsolicited
        want_height, q = entry
        if payload is not None and height_of(payload) != want_height:
            # a late reply to an earlier timed-out request: drop it and
            # keep waiting — turning it into a miss would let one slow
            # response poison every subsequent request to this peer
            return
        q.put(payload)

    def _on_light_block(self, peer_id: str, lb) -> None:
        self._resolve("lb", peer_id, lambda b: b.signed_header.header.height, lb)

    def _on_params(self, peer_id: str, msg) -> None:
        self._resolve("params", peer_id, lambda m: m.height, msg)

    # ------------------------------------------------------------ requests

    def _ask(self, kind: str, send, height: int, peers, timeout: float):
        """One peer at a time, rotating on miss/timeout
        (ref: dispatcher.go LightBlock round-robin). `timeout` is per
        peer."""
        for peer in peers:
            q = queue.Queue()
            with self._lock:
                self._outstanding[(kind, peer)] = (height, q)
            try:
                send(peer, height)
                payload = q.get(timeout=timeout)
                if payload is not None:
                    return payload
                # explicit miss: next peer immediately
            except queue.Empty:
                pass
            finally:
                with self._lock:
                    self._outstanding.pop((kind, peer), None)
        raise ErrNoResponse(f"no peer had height {height}")

    def light_block(self, height: int, peers, timeout: float = 10.0):
        """First matching light block any peer returns for height
        (verification is the light client's job)."""
        return self._ask(
            "lb",
            lambda p, h: self.reactor.lb_ch.send_to(p, LightBlockRequest(h), timeout=1.0),
            height, peers, timeout,
        )

    def consensus_params(self, height: int, peers, timeout: float = 10.0):
        msg = self._ask(
            "params",
            lambda p, h: self.reactor.params_ch.send_to(p, ParamsRequest(h), timeout=1.0),
            height, peers, timeout,
        )
        return msg.params


class P2PLightProvider(Provider):
    """light.Provider backed by the statesync LightBlock channel
    (ref: statesync/stateprovider.go p2p provider + dispatcher)."""

    def __init__(self, chain_id: str, dispatcher: Dispatcher, peers_fn):
        """peers_fn() -> current peer ids (tried one at a time)."""
        self._chain_id = chain_id
        self.dispatcher = dispatcher
        self.peers_fn = peers_fn

    def chain_id(self) -> str:
        return self._chain_id

    def light_block(self, height: int):
        if height <= 0:
            # responses correlate by height; "latest" (0) cannot be
            # matched — statesync always asks explicit heights
            raise ErrNoResponse("p2p provider requires an explicit height")
        peers = list(self.peers_fn())
        if not peers:
            raise ErrNoResponse("no peers to request light blocks from")
        lb = self.dispatcher.light_block(height, peers)
        lb.validate_basic(self._chain_id)
        return lb
