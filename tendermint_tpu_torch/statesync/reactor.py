"""Statesync reactor — serves and consumes snapshots, chunks, light
blocks, and consensus params over 4 channels
(ref: internal/statesync/reactor.go:36-45,78-109).

  0x60 Snapshot   p6 — SnapshotsRequest/Response
  0x61 Chunk      p3 — ChunkRequest/Response
  0x62 LightBlock p5 — LightBlockRequest/Response
  0x63 Params     p2 — ParamsRequest/Response
"""

from __future__ import annotations

import threading

from ..abci import types as abci
from ..p2p.types import (
    CHANNEL_CHUNK,
    CHANNEL_LIGHT_BLOCK,
    CHANNEL_PARAMS,
    CHANNEL_SNAPSHOT,
    ChannelDescriptor,
    PEER_STATUS_UP,
    PeerError,
)
from ..proto import messages as pb
from ..types.light_block import LightBlock


# ------------------------------------------------------------------ messages


class SnapshotsRequest:
    pass


class SnapshotsResponse:
    def __init__(self, snapshot: abci.Snapshot):
        self.snapshot = snapshot


class ChunkRequest:
    def __init__(self, height: int, format: int, index: int):
        self.height, self.format, self.index = height, format, index


class ChunkResponse:
    def __init__(self, height: int, format: int, index: int, chunk: bytes, missing: bool = False):
        self.height, self.format, self.index, self.chunk, self.missing = height, format, index, chunk, missing


class LightBlockRequest:
    def __init__(self, height: int):
        self.height = height


class LightBlockResponse:
    def __init__(self, light_block: LightBlock | None):
        self.light_block = light_block


class ParamsRequest:
    def __init__(self, height: int):
        self.height = height


class ParamsResponse:
    def __init__(self, height: int, params):
        self.height, self.params = height, params


def _env(**kw) -> bytes:
    return pb.StatesyncMessage(**kw).encode()


def _enc_snapshot_ch(msg) -> bytes:
    """Wire bytes on every statesync channel = the reference's Message
    oneof (proto/tendermint/statesync/types.proto:8-17)."""
    if isinstance(msg, SnapshotsRequest):
        return _env(snapshots_request=pb.SnapshotsRequestProto())
    s = msg.snapshot
    return _env(snapshots_response=pb.SnapshotsResponseProto(
        height=s.height, format=s.format, chunks=s.chunks,
        hash=s.hash, metadata=s.metadata))


def _dec_snapshot_ch(data: bytes):
    env = pb.StatesyncMessage.decode(data)
    if env.snapshots_request is not None:
        return SnapshotsRequest()
    r = env.snapshots_response
    if r is None:
        raise ValueError("unexpected message on snapshot channel")
    return SnapshotsResponse(
        abci.Snapshot(height=r.height or 0, format=r.format or 0, chunks=r.chunks or 0,
                      hash=r.hash or b"", metadata=r.metadata or b"")
    )


def _enc_chunk_ch(msg) -> bytes:
    if isinstance(msg, ChunkRequest):
        return _env(chunk_request=pb.ChunkRequestProto(
            height=msg.height, format=msg.format, index=msg.index))
    return _env(chunk_response=pb.ChunkResponseProto(
        height=msg.height, format=msg.format, index=msg.index,
        chunk=msg.chunk, missing=msg.missing))


def _dec_chunk_ch(data: bytes):
    env = pb.StatesyncMessage.decode(data)
    if env.chunk_request is not None:
        r = env.chunk_request
        return ChunkRequest(r.height or 0, r.format or 0, r.index or 0)
    r = env.chunk_response
    if r is None:
        raise ValueError("unexpected message on chunk channel")
    return ChunkResponse(r.height or 0, r.format or 0, r.index or 0,
                         r.chunk or b"", bool(r.missing))


def _enc_lb_ch(msg) -> bytes:
    if isinstance(msg, LightBlockRequest):
        return _env(light_block_request=pb.LightBlockRequestProto(height=msg.height))
    # a response with no light_block means "don't have it" (reference
    # sends the empty LightBlockResponse the same way)
    if msg.light_block is None:
        return _env(light_block_response=pb.LightBlockResponseProto())
    return _env(light_block_response=pb.LightBlockResponseProto(
        light_block=msg.light_block.to_proto()))


def _dec_lb_ch(data: bytes):
    env = pb.StatesyncMessage.decode(data)
    if env.light_block_request is not None:
        return LightBlockRequest(env.light_block_request.height or 0)
    r = env.light_block_response
    if r is None:
        raise ValueError("unexpected message on light-block channel")
    if r.light_block is None:
        return LightBlockResponse(None)
    return LightBlockResponse(LightBlock.from_proto(r.light_block))


def _enc_params_ch(msg) -> bytes:
    if isinstance(msg, ParamsRequest):
        return _env(params_request=pb.ParamsRequestProto(height=msg.height))
    return _env(params_response=pb.ParamsResponseProto(
        height=msg.height, consensus_params=msg.params.to_proto_update()))


def _dec_params_ch(data: bytes):
    from ..types.params import ConsensusParams

    env = pb.StatesyncMessage.decode(data)
    if env.params_request is not None:
        return ParamsRequest(env.params_request.height or 0)
    r = env.params_response
    if r is None:
        raise ValueError("unexpected message on params channel")
    return ParamsResponse(
        r.height or 0, ConsensusParams().update_consensus_params(r.consensus_params)
    )


def statesync_channel_descriptors() -> list[ChannelDescriptor]:
    """ref: reactor.go:36-45 channel table."""
    return [
        ChannelDescriptor(id=CHANNEL_SNAPSHOT, name="snapshot", priority=6,
                          encode=_enc_snapshot_ch, decode=_dec_snapshot_ch),
        ChannelDescriptor(id=CHANNEL_CHUNK, name="chunk", priority=3, recv_message_capacity=16 << 20,
                          encode=_enc_chunk_ch, decode=_dec_chunk_ch),
        ChannelDescriptor(id=CHANNEL_LIGHT_BLOCK, name="light-block", priority=5,
                          encode=_enc_lb_ch, decode=_dec_lb_ch),
        ChannelDescriptor(id=CHANNEL_PARAMS, name="params", priority=2,
                          encode=_enc_params_ch, decode=_dec_params_ch),
    ]


class StateSyncReactor:
    """ref: internal/statesync/reactor.go Reactor."""

    def __init__(
        self,
        app_client,
        state_store,
        block_store,
        snapshot_ch,
        chunk_ch,
        lb_ch,
        params_ch,
        peer_manager,
        local_provider=None,
        metrics=None,
    ):
        self.app = app_client
        self.state_store = state_store
        self.block_store = block_store
        self.snapshot_ch = snapshot_ch
        self.chunk_ch = chunk_ch
        self.lb_ch = lb_ch
        self.params_ch = params_ch
        self.peer_manager = peer_manager
        self.metrics = metrics  # StateSyncMetrics
        self.local_provider = local_provider
        self.syncer = None  # set by sync()
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []

    # ----------------------------------------------------------- lifecycle

    def start(self) -> None:
        self.peer_manager.subscribe(self._on_peer_update)
        for fn, ch in (
            (self._recv_snapshot, self.snapshot_ch),
            (self._recv_chunk, self.chunk_ch),
            (self._recv_light_block, self.lb_ch),
            (self._recv_params, self.params_ch),
        ):
            t = threading.Thread(target=fn, args=(ch,), daemon=True, name=fn.__name__)
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        self._stop.set()
        self.peer_manager.unsubscribe(self._on_peer_update)

    def _on_peer_update(self, update) -> None:
        if update.status != PEER_STATUS_UP and self.syncer is not None:
            self.syncer.remove_peer(update.node_id)

    # ------------------------------------------------------------- serving

    def _recv_snapshot(self, ch) -> None:
        """ref: reactor.go:238 handleSnapshotMessage."""
        while not self._stop.is_set():
            env = ch.receive_one(timeout=0.2)
            if env is None:
                continue
            msg, nid = env.message, env.from_
            try:
                if isinstance(msg, SnapshotsRequest):
                    res = self.app.list_snapshots(abci.RequestListSnapshots())
                    for s in res.snapshots[-10:]:
                        ch.send_to(nid, SnapshotsResponse(s), timeout=1.0)
                elif isinstance(msg, SnapshotsResponse) and self.syncer is not None:
                    self.syncer.add_snapshot(nid, msg.snapshot)
            except Exception as e:
                ch.send_error(PeerError(node_id=nid, err=e))

    def _recv_chunk(self, ch) -> None:
        """ref: reactor.go:291 handleChunkMessage."""
        while not self._stop.is_set():
            env = ch.receive_one(timeout=0.2)
            if env is None:
                continue
            msg, nid = env.message, env.from_
            try:
                if isinstance(msg, ChunkRequest):
                    res = self.app.load_snapshot_chunk(
                        abci.RequestLoadSnapshotChunk(height=msg.height, format=msg.format, chunk=msg.index)
                    )
                    ch.send_to(
                        nid,
                        ChunkResponse(msg.height, msg.format, msg.index, res.chunk, missing=not res.chunk),
                        timeout=1.0,
                    )
                elif isinstance(msg, ChunkResponse) and self.syncer is not None:
                    if msg.missing:
                        self.syncer.note_missing(msg.height, msg.format)
                    else:
                        self.syncer.add_chunk(msg.index, msg.chunk, nid)
            except Exception as e:
                ch.send_error(PeerError(node_id=nid, err=e))

    def _recv_light_block(self, ch) -> None:
        """p2p light-block serving (ref: reactor.go:765)."""
        while not self._stop.is_set():
            env = ch.receive_one(timeout=0.2)
            if env is None:
                continue
            msg, nid = env.message, env.from_
            try:
                if isinstance(msg, LightBlockRequest):
                    lb = None
                    if self.local_provider is not None:
                        try:
                            lb = self.local_provider.light_block(msg.height)
                        except Exception:
                            lb = None
                    ch.send_to(nid, LightBlockResponse(lb), timeout=1.0)
                elif isinstance(msg, LightBlockResponse):
                    handler = getattr(self, "_lb_waiter", None)
                    if handler is not None:
                        handler(nid, msg.light_block)
            except Exception as e:
                ch.send_error(PeerError(node_id=nid, err=e))

    def _recv_params(self, ch) -> None:
        """ref: reactor.go params channel handling."""
        while not self._stop.is_set():
            env = ch.receive_one(timeout=0.2)
            if env is None:
                continue
            msg, nid = env.message, env.from_
            try:
                if isinstance(msg, ParamsRequest):
                    # serve ONLY params actually recorded for that height —
                    # labeling our latest params with the requested height
                    # would hand a statesyncing peer wrong params and fork
                    # it at the first divergence (the requester treats the
                    # label as authoritative)
                    params = self.state_store.load_consensus_params(msg.height)
                    if params is None:
                        state = self.state_store.load()
                        if state is not None and state.last_block_height <= msg.height:
                            # at/above our tip the current params ARE the
                            # params for that height
                            params = state.consensus_params
                    if params is not None:
                        ch.send_to(nid, ParamsResponse(msg.height, params), timeout=1.0)
                elif isinstance(msg, ParamsResponse):
                    handler = getattr(self, "_params_waiter", None)
                    if handler is not None:
                        handler(nid, msg)
            except Exception as e:
                ch.send_error(PeerError(node_id=nid, err=e))

    # ------------------------------------------------------------- syncing

    def sync(self, state_provider, gen_doc, discovery_time: float = 15.0):
        """Run the syncer to completion; returns (state, commit)
        (ref: reactor.go:180 Sync)."""
        from .syncer import Syncer

        def request_snapshots():
            self.snapshot_ch.broadcast(SnapshotsRequest(), timeout=1.0)

        def request_chunk(snapshot, index, peers):
            import random

            peer = random.choice(peers)
            self.chunk_ch.send_to(
                peer, ChunkRequest(snapshot.height, snapshot.format, index), timeout=1.0
            )

        self.syncer = Syncer(self.app, state_provider, request_snapshots, request_chunk,
                             metrics=self.metrics)
        state, commit = self.syncer.sync_any(discovery_time=discovery_time, stop_event=self._stop)

        # persist: BOOTSTRAP state + seen commit so consensus/blocksync
        # can continue from the snapshot height (reactor.go:Sync end —
        # the reference calls stateStore.Bootstrap, not Save, and the
        # difference matters: Save writes the next-height validator
        # entry as a sparse pointer to last_height_validators_changed,
        # a height a statesync-fresh store never stored — the first
        # post-restore apply_block then cannot load the validator set
        # and halts the node (backfill usually papers over it, but a
        # pruned provider can cut backfill short)
        self.state_store.bootstrap(state)
        self.block_store.save_seen_commit(state.last_block_height, commit)
        return state, commit

    # ------------------------------------------------------------ backfill

    def backfill(self, state, fetch_light_block, stop_height: int | None = None) -> int:
        """Fetch + hash-chain-verify historical light blocks back to the
        evidence window, persisting validator sets and commits
        (ref: reactor.go:416 Backfill)."""
        params = state.consensus_params.evidence
        target = max(
            state.last_block_height - params.max_age_num_blocks + 1,
            state.initial_height,
            stop_height or 1,
        )
        height = state.last_block_height
        trusted_lb = fetch_light_block(height)
        if trusted_lb is None:
            return 0
        # Root the hash chain at the state's own LastBlockID: a malicious
        # provider must not be able to seed a forged history (ref:
        # reactor.go:432,550 — trustedBlockID from state, per-block
        # ValidateBasic before persisting).
        if state.last_block_id is not None and state.last_block_id.hash:
            if trusted_lb.signed_header.hash() != state.last_block_id.hash:
                raise ValueError(
                    f"backfill: light block at {height} does not match state.last_block_id"
                )
        trusted_lb.validate_basic(state.chain_id)
        stored = 0
        cur = trusted_lb
        self.state_store.save_validator_sets(cur.height, cur.height, cur.validator_set)
        while cur.height > target and not self._stop.is_set():
            prev = fetch_light_block(cur.height - 1)
            if prev is None:
                break
            if prev.signed_header.hash() != cur.signed_header.header.last_block_id.hash:
                raise ValueError(
                    f"backfill: header at {prev.height} does not hash-chain to {cur.height}"
                )
            prev.validate_basic(state.chain_id)
            self.state_store.save_validator_sets(prev.height, prev.height, prev.validator_set)
            self.block_store.save_seen_commit(prev.height, prev.signed_header.commit)
            stored += 1
            if self.metrics is not None:
                self.metrics.backfilled_blocks.add(1)
            cur = prev
        return stored
