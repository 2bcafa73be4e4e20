"""Consensus reactor: gossips the state machine over the P2P layer
(ref: internal/consensus/reactor.go), a copy of the JAX package's
consensus/reactor.py with the same wire bytes.

Four channels (reactor.go:36-71):
  0x20 State     p8  — NewRoundStep / NewValidBlock / HasVote / VoteSetMaj23
  0x21 Data      p12 — Proposal / ProposalPOL / BlockPart
  0x22 Vote      p10 — Vote
  0x23 VoteSetBits p5 — VoteSetBits

Outbound control messages come from the ConsensusState `broadcast` hook;
data-plane delivery is pull-gossip: one gossipData + one gossipVotes
thread per peer reads the (GIL-shared) RoundState and this peer's
PeerState and sends exactly what the peer is missing (reactor.go:501,736).
All inbound handling is idempotent, so the additional push of our own
proposal/parts/votes costs duplicates at worst.

The reactor runs no device code and takes no `device`: the proposal's
checks run in the BlockExecutor the ConsensusState holds, and a verifier
fault there reaches the ConsensusState's on_fatal. The receive loops'
catches wrap no device call (add_peer_message only queues).
"""

from __future__ import annotations

import threading
import time

from .. import trace as _trace
from ..p2p.types import (
    CHANNEL_CONSENSUS_DATA,
    CHANNEL_CONSENSUS_STATE,
    CHANNEL_CONSENSUS_VOTE,
    CHANNEL_CONSENSUS_VOTE_SET_BITS,
    ChannelDescriptor,
    PEER_STATUS_UP,
    PeerError,
)
from ..proto import messages as pb
from ..types.block import BlockID, PartSetHeader
from ..types.part_set import Part
from ..types.proposal import Proposal
from ..types.vote import PRECOMMIT, PREVOTE, Vote
from ..utils.bits import BitArray
from .messages import (
    BlockPartMessage,
    HasVoteMessage,
    NewRoundStepMessage,
    NewValidBlockMessage,
    ProposalMessage,
    ProposalPOLMessage,
    VoteMessage,
    VoteSetBitsMessage,
    VoteSetMaj23Message,
)
from .peer_state import PeerState
from .round_state import STEP_NEW_HEIGHT, STEP_PRECOMMIT, STEP_PROPOSE

# ------------------------------------------------------------------ codecs
#
# Wire format: the reference's `tendermint.consensus.Message` proto oneof
# (proto/tendermint/consensus/types.proto) — byte-compatible field
# numbers end to end; no framework-internal encodings remain.


def _ba_to_proto(ba: BitArray | None) -> pb.BitArrayProto | None:
    if ba is None:
        return None
    raw = ba.to_bytes()
    raw += b"\x00" * (-len(raw) % 8)  # pad to whole uint64 words
    elems = [int.from_bytes(raw[i : i + 8], "little") for i in range(0, len(raw), 8)]
    return pb.BitArrayProto(bits=ba.bits, elems=elems)


def _ba_from_proto(p: pb.BitArrayProto | None) -> BitArray | None:
    if p is None:
        return None
    bits = p.bits or 0
    raw = b"".join(int(w).to_bytes(8, "little") for w in (p.elems or []))
    return BitArray.from_bytes(bits, raw[: (bits + 7) // 8])


def _msg_height_round(msg) -> tuple[int, int]:
    """(height, round) of a data-plane message — the journey-key
    coordinates shared by the frame's sender and receiver."""
    if isinstance(msg, ProposalMessage):
        return msg.proposal.height, msg.proposal.round
    if isinstance(msg, VoteMessage):
        return msg.vote.height, msg.vote.round
    return msg.height, msg.round  # BlockPartMessage


def _journey_send(msg, kind: str, origin_node: str, metrics) -> None:
    """Per-peer send instrumentation of a stamped data-plane frame: the
    journey_frames counter and (tracing on) a journey.send instant
    whose deterministic key the RECEIVER re-derives from the frame's
    origin_node — one send/recv pair per hop, no clock alignment.
    UNSTAMPED frames (bare codec, no node identity wired) emit
    nothing, mirroring the receive side: counting them would break the
    sent/received symmetry, and an anonymous '@-' send key would
    collide across nodes and draw false cross-node arrows in the
    merged trace."""
    if not origin_node:
        return
    if metrics is not None:
        metrics.journey_frames.add(1, kind, "sent")
    if _trace.enabled():
        h, r = _msg_height_round(msg)
        _trace.instant(
            "journey.send", "journey", height=h, type=kind,
            journey=_trace.journey_key(h, r, kind, origin_node),
        )


def encode_consensus_msg(msg, origin_node: str = "", metrics=None) -> bytes:
    """ref: internal/consensus/msgs.go MsgToProto.

    Data-plane frames (proposal / block part / vote) additionally carry
    an origin wall-clock stamp (ConsensusMessage.origin_ns, a local
    field-1000 extension): the encoder runs once per peer send, so the
    stamp is the FRAME's origin time, and the receive side's
    now - origin is pure network propagation — what splits a slow step
    into network vs compute on shared-clock testnets. `origin_node`
    (when the node wires its p2p id in via
    consensus_channel_descriptors) rides field 1001 so the receiver can
    re-derive the same tmpath journey key; empty values are omitted, so
    unstamped frames stay byte-identical to the reference schema."""
    if isinstance(msg, NewRoundStepMessage):
        wrapped = pb.ConsensusMessage(new_round_step=pb.CsNewRoundStep(
            height=msg.height, round=msg.round, step=msg.step,
            seconds_since_start_time=msg.seconds_since_start_time,
            last_commit_round=msg.last_commit_round))
    elif isinstance(msg, NewValidBlockMessage):
        wrapped = pb.ConsensusMessage(new_valid_block=pb.CsNewValidBlock(
            height=msg.height, round=msg.round,
            block_part_set_header=(msg.block_part_set_header or PartSetHeader()).to_proto(),
            block_parts=_ba_to_proto(msg.block_parts), is_commit=msg.is_commit))
    elif isinstance(msg, ProposalMessage):
        wrapped = pb.ConsensusMessage(proposal=pb.CsProposal(proposal=msg.proposal.to_proto()),
                                      origin_ns=time.time_ns(), origin_node=origin_node)
        _journey_send(msg, "proposal", origin_node, metrics)
    elif isinstance(msg, ProposalPOLMessage):
        wrapped = pb.ConsensusMessage(proposal_pol=pb.CsProposalPOL(
            height=msg.height, proposal_pol_round=msg.proposal_pol_round,
            proposal_pol=_ba_to_proto(msg.proposal_pol)))
    elif isinstance(msg, BlockPartMessage):
        wrapped = pb.ConsensusMessage(block_part=pb.CsBlockPart(
            height=msg.height, round=msg.round, part=msg.part.to_proto()),
            origin_ns=time.time_ns(), origin_node=origin_node)
        _journey_send(msg, "block_part", origin_node, metrics)
    elif isinstance(msg, VoteMessage):
        wrapped = pb.ConsensusMessage(vote=pb.CsVote(vote=msg.vote.to_proto()),
                                      origin_ns=time.time_ns(), origin_node=origin_node)
        _journey_send(msg, "vote", origin_node, metrics)
    elif isinstance(msg, HasVoteMessage):
        wrapped = pb.ConsensusMessage(has_vote=pb.CsHasVote(
            height=msg.height, round=msg.round, type=msg.type, index=msg.index))
    elif isinstance(msg, VoteSetMaj23Message):
        wrapped = pb.ConsensusMessage(vote_set_maj23=pb.CsVoteSetMaj23(
            height=msg.height, round=msg.round, type=msg.type,
            block_id=msg.block_id.to_proto()))
    elif isinstance(msg, VoteSetBitsMessage):
        wrapped = pb.ConsensusMessage(vote_set_bits=pb.CsVoteSetBits(
            height=msg.height, round=msg.round, type=msg.type,
            block_id=msg.block_id.to_proto(), votes=_ba_to_proto(msg.votes)))
    else:
        raise TypeError(f"unknown consensus message {type(msg)}")
    return wrapped.encode()


def decode_consensus_msg(data: bytes):
    """ref: internal/consensus/msgs.go MsgFromProto."""
    w = pb.ConsensusMessage.decode(data)
    if w.new_round_step is not None:
        p = w.new_round_step
        return NewRoundStepMessage(p.height or 0, p.round or 0, p.step or 0,
                                   p.seconds_since_start_time or 0, p.last_commit_round or 0)
    if w.new_valid_block is not None:
        p = w.new_valid_block
        return NewValidBlockMessage(
            p.height or 0, p.round or 0, PartSetHeader.from_proto(p.block_part_set_header),
            _ba_from_proto(p.block_parts), bool(p.is_commit))
    if w.proposal is not None:
        return ProposalMessage(Proposal.from_proto(w.proposal.proposal),
                               origin_ns=w.origin_ns or 0,
                               origin_node=w.origin_node or "")
    if w.proposal_pol is not None:
        p = w.proposal_pol
        return ProposalPOLMessage(p.height or 0, p.proposal_pol_round or 0,
                                  _ba_from_proto(p.proposal_pol))
    if w.block_part is not None:
        p = w.block_part
        return BlockPartMessage(p.height or 0, p.round or 0, Part.from_proto(p.part),
                                origin_ns=w.origin_ns or 0,
                                origin_node=w.origin_node or "")
    if w.vote is not None:
        return VoteMessage(Vote.from_proto(w.vote.vote), origin_ns=w.origin_ns or 0,
                           origin_node=w.origin_node or "")
    if w.has_vote is not None:
        p = w.has_vote
        return HasVoteMessage(p.height or 0, p.round or 0, p.type or 0, p.index or 0)
    if w.vote_set_maj23 is not None:
        p = w.vote_set_maj23
        return VoteSetMaj23Message(p.height or 0, p.round or 0, p.type or 0,
                                   BlockID.from_proto(p.block_id))
    if w.vote_set_bits is not None:
        p = w.vote_set_bits
        return VoteSetBitsMessage(p.height or 0, p.round or 0, p.type or 0,
                                  BlockID.from_proto(p.block_id), _ba_from_proto(p.votes))
    raise ValueError("empty consensus message")


def consensus_channel_descriptors(origin_node: str = "", metrics=None) -> list[ChannelDescriptor]:
    """ref: reactor.go:36-71 (GetChannelDescriptors). `origin_node` (the
    node's p2p id) and `metrics` (its ConsensusMetrics) thread into the
    per-send encoder so data-plane frames carry the tmpath journey
    origin; the defaults leave frames unstamped (byte-identical to the
    reference schema) for tests and tooling that build bare codecs."""
    encode = lambda m: encode_consensus_msg(m, origin_node, metrics)
    mk = lambda cid, name, prio: ChannelDescriptor(
        id=cid,
        name=name,
        priority=prio,
        send_queue_capacity=64,
        encode=encode,
        decode=decode_consensus_msg,
    )
    return [
        mk(CHANNEL_CONSENSUS_STATE, "cs-state", 8),
        mk(CHANNEL_CONSENSUS_DATA, "cs-data", 12),
        mk(CHANNEL_CONSENSUS_VOTE, "cs-vote", 10),
        mk(CHANNEL_CONSENSUS_VOTE_SET_BITS, "cs-votebits", 5),
    ]


class ConsensusReactor:
    """ref: internal/consensus/reactor.go Reactor."""

    GOSSIP_SLEEP = 0.05  # ref: gossipSleepDuration (100ms in reference)
    QUERY_MAJ23_SLEEP = 2.0
    # origin stamps farther than this from our clock are cross-host
    # clock skew, not latency — recording them would poison the
    # propagation histogram (stamps are only meaningful on the
    # shared-clock local testnets the e2e/bench planes run)
    PROPAGATION_MAX_S = 60.0

    def __init__(self, cs, state_ch, data_ch, vote_ch, bits_ch, peer_manager, block_store):
        self.cs = cs
        self.state_ch = state_ch
        self.data_ch = data_ch
        self.vote_ch = vote_ch
        self.bits_ch = bits_ch
        self.peer_manager = peer_manager
        self.block_store = block_store
        self.peers: dict[str, PeerState] = {}
        self._peer_threads: dict[str, list[threading.Thread]] = {}
        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        cs.broadcast = self._on_state_broadcast

    # ----------------------------------------------------------- lifecycle

    def start(self) -> None:
        self.peer_manager.subscribe(self._on_peer_update)
        for nid in self.peer_manager.peers():
            self._add_peer(nid)
        for fn, ch in (
            (self._recv_state, self.state_ch),
            (self._recv_data, self.data_ch),
            (self._recv_vote, self.vote_ch),
            (self._recv_bits, self.bits_ch),
        ):
            t = threading.Thread(target=fn, args=(ch,), daemon=True, name=fn.__name__)
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        self._stop.set()
        self.peer_manager.unsubscribe(self._on_peer_update)
        with self._lock:
            for ps in self.peers.values():
                ps.running = False

    # --------------------------------------------------------------- peers

    def _on_peer_update(self, update) -> None:
        if update.status == PEER_STATUS_UP:
            self._add_peer(update.node_id)
        else:
            with self._lock:
                ps = self.peers.pop(update.node_id, None)
                if ps is not None:
                    ps.running = False
                self._peer_threads.pop(update.node_id, None)

    def _add_peer(self, nid: str) -> None:
        """Spawn gossip threads for a new peer (ref: reactor.go:1324
        processPeerUpdate → spawning gossipDataRoutine etc.)."""
        with self._lock:
            if nid in self.peers:
                return
            ps = PeerState(nid)
            self.peers[nid] = ps
            threads = [
                threading.Thread(target=self._gossip_data_routine, args=(ps,), daemon=True, name=f"gossip-data:{nid[:8]}"),
                threading.Thread(target=self._gossip_votes_routine, args=(ps,), daemon=True, name=f"gossip-votes:{nid[:8]}"),
                threading.Thread(target=self._query_maj23_routine, args=(ps,), daemon=True, name=f"maj23:{nid[:8]}"),
            ]
            self._peer_threads[nid] = threads
        # announce our current state so the peer can gossip to us
        rs = self.cs.rs
        self.state_ch.send_to(
            nid,
            NewRoundStepMessage(
                height=rs.height,
                round=rs.round,
                step=rs.step,
                seconds_since_start_time=0,
                last_commit_round=rs.last_commit.round if rs.last_commit is not None else 0,
            ),
        )
        for t in threads:
            t.start()

    # ------------------------------------------------- state-machine events

    def _on_state_broadcast(self, msg) -> None:
        """Hook from ConsensusState: control messages on the State
        channel, our own data-plane messages pushed to all peers
        (ref: broadcastNewRoundStepMessage reactor.go:350)."""
        if isinstance(msg, (NewRoundStepMessage, HasVoteMessage, NewValidBlockMessage)):
            self.state_ch.broadcast(msg, timeout=0.5)
        elif isinstance(msg, (ProposalMessage, BlockPartMessage)):
            self.data_ch.broadcast(msg, timeout=0.5)
        elif isinstance(msg, VoteMessage):
            self.vote_ch.broadcast(msg, timeout=0.5)

    # ------------------------------------------------------- receive loops

    def _recv_state(self, ch) -> None:
        """ref: reactor.go:1013 handleStateMessage."""
        while not self._stop.is_set():
            env = ch.receive_one(timeout=0.2)
            if env is None:
                continue
            msg, nid = env.message, env.from_
            ps = self._peer_state(nid)
            if ps is None:
                continue
            try:
                if isinstance(msg, NewRoundStepMessage):
                    ps.apply_new_round_step(msg)
                    ps.ensure_vote_bit_arrays(msg.height, self.cs.state.validators.size())
                    ps.ensure_vote_bit_arrays(msg.height - 1, self.cs.state.last_validators.size())
                elif isinstance(msg, NewValidBlockMessage):
                    ps.apply_new_valid_block(msg)
                elif isinstance(msg, HasVoteMessage):
                    ps.apply_has_vote(msg)
                elif isinstance(msg, VoteSetMaj23Message):
                    self._handle_vote_set_maj23(ps, msg)
            except Exception as e:
                ch.send_error(PeerError(node_id=nid, err=e))

    def _handle_vote_set_maj23(self, ps: PeerState, msg) -> None:
        """Record the peer's claimed majority, reply with our vote bits
        (ref: reactor.go:1041-1086)."""
        rs = self.cs.rs
        if rs.height != msg.height or rs.votes is None:
            return
        votes = rs.votes.prevotes(msg.round) if msg.type == PREVOTE else rs.votes.precommits(msg.round)
        if votes is None:
            return
        votes.set_peer_maj23(ps.peer_id, msg.block_id)
        our_bits = votes.bit_array_by_block_id(msg.block_id)
        if our_bits is None:
            our_bits = BitArray(votes.size())
        self.bits_ch.send_to(
            ps.peer_id,
            VoteSetBitsMessage(msg.height, msg.round, msg.type, msg.block_id, our_bits),
        )

    def _recv_data(self, ch) -> None:
        """ref: reactor.go:1094 handleDataMessage."""
        while not self._stop.is_set():
            env = ch.receive_one(timeout=0.2)
            if env is None:
                continue
            msg, nid = env.message, env.from_
            ps = self._peer_state(nid)
            if ps is None:
                continue
            try:
                if isinstance(msg, ProposalMessage):
                    self._observe_propagation(msg, "proposal")
                    ps.set_has_proposal(msg.proposal)
                    self.cs.add_peer_message(msg, nid)
                elif isinstance(msg, BlockPartMessage):
                    self._observe_propagation(msg, "block_part")
                    ps.set_has_proposal_block_part(msg.height, msg.round, msg.part.index)
                    self.cs.add_peer_message(msg, nid)
                elif isinstance(msg, ProposalPOLMessage):
                    ps.apply_proposal_pol(msg)
            except Exception as e:
                ch.send_error(PeerError(node_id=nid, err=e))

    def _recv_vote(self, ch) -> None:
        """ref: reactor.go:1138 handleVoteMessage."""
        while not self._stop.is_set():
            env = ch.receive_one(timeout=0.2)
            if env is None:
                continue
            msg, nid = env.message, env.from_
            ps = self._peer_state(nid)
            if ps is None:
                continue
            try:
                if isinstance(msg, VoteMessage):
                    self._observe_propagation(msg, "vote")
                    height = self.cs.rs.height
                    val_size = self.cs.state.validators.size()
                    last_size = self.cs.state.last_validators.size()
                    ps.ensure_vote_bit_arrays(height, val_size)
                    ps.ensure_vote_bit_arrays(height - 1, last_size)
                    ps.set_has_vote(msg.vote)
                    self.cs.add_peer_message(msg, nid)
            except Exception as e:
                ch.send_error(PeerError(node_id=nid, err=e))

    def _recv_bits(self, ch) -> None:
        """ref: reactor.go:1172 handleVoteSetBitsMessage."""
        while not self._stop.is_set():
            env = ch.receive_one(timeout=0.2)
            if env is None:
                continue
            msg, nid = env.message, env.from_
            ps = self._peer_state(nid)
            if ps is None:
                continue
            try:
                if isinstance(msg, VoteSetBitsMessage):
                    rs = self.cs.rs
                    our_votes = None
                    if rs.height == msg.height and rs.votes is not None:
                        votes = rs.votes.prevotes(msg.round) if msg.type == PREVOTE else rs.votes.precommits(msg.round)
                        if votes is not None:
                            our_votes = votes.bit_array_by_block_id(msg.block_id)
                    ps.apply_vote_set_bits(msg, our_votes)
            except Exception as e:
                ch.send_error(PeerError(node_id=nid, err=e))

    def _peer_state(self, nid: str) -> PeerState | None:
        with self._lock:
            return self.peers.get(nid)

    def _observe_propagation(self, msg, type_label: str) -> None:
        """Record origin-to-receive latency of a stamped gossip frame
        (consensus_msg_propagation_seconds{type}). Unstamped frames
        (origin_ns 0: legacy peer, WAL replay) and stamps outside the
        skew window are skipped; a small negative dt (same-host clock
        step) clamps to 0. An origin_node stamp additionally yields a
        journey.recv instant whose key matches the sender's
        journey.send — the receive half of the tmpath hop flow."""
        metrics = getattr(self.cs, "metrics", None)
        origin = getattr(msg, "origin_ns", 0)
        origin_node = getattr(msg, "origin_node", "")
        if metrics is not None and origin:
            dt = (time.time_ns() - origin) / 1e9
            if -1.0 <= dt <= self.PROPAGATION_MAX_S:
                metrics.msg_propagation.observe(max(0.0, dt), type_label)
        if not origin_node:
            return
        if metrics is not None:
            metrics.journey_frames.add(1, type_label, "received")
        if _trace.enabled():
            h, r = _msg_height_round(msg)
            _trace.instant(
                "journey.recv", "journey", height=h, type=type_label,
                journey=_trace.journey_key(h, r, type_label, origin_node),
            )

    # ---------------------------------------------------------- gossip data

    def _gossip_data_routine(self, ps: PeerState) -> None:
        """ref: reactor.go:501 gossipDataRoutine."""
        while ps.running and not self._stop.is_set():
            rs = self.cs.rs
            prs = ps.prs
            try:
                # 1. peer is missing a part of the current proposal block
                if (
                    rs.proposal_block_parts is not None
                    and rs.height == prs.height
                    and prs.proposal_block_parts is not None
                    and rs.proposal_block_parts.has_header(prs.proposal_block_parts_header)
                ):
                    missing = rs.proposal_block_parts.bit_array().sub(prs.proposal_block_parts)
                    idx, ok = missing.pick_random()
                    if ok:
                        part = rs.proposal_block_parts.get_part(idx)
                        if part is not None:
                            if self.data_ch.send_to(ps.peer_id, BlockPartMessage(rs.height, rs.round, part), timeout=1.0):
                                ps.set_has_proposal_block_part(prs.height, prs.round, idx)
                            continue

                # 2. peer is on an older height: feed committed block parts
                #    (reactor.go:437 gossipDataForCatchup)
                if 0 < prs.height < rs.height and prs.height >= self.block_store.base():
                    if self._gossip_catchup(ps, prs):
                        # rate-limit: catchup parts are re-sent until the
                        # peer advances (no delivery ack — marking them
                        # "had" would wedge a peer that wasn't ready yet)
                        time.sleep(self.GOSSIP_SLEEP * 4)
                        continue

                # 3. peer needs the proposal itself
                if rs.proposal is not None and rs.height == prs.height and rs.round == prs.round and not prs.proposal:
                    self.data_ch.send_to(ps.peer_id, ProposalMessage(rs.proposal), timeout=1.0)
                    ps.set_has_proposal(rs.proposal)
                    # also send POL prevote bits (reactor.go:679)
                    if 0 <= rs.proposal.pol_round and rs.votes is not None:
                        pol = rs.votes.prevotes(rs.proposal.pol_round)
                        if pol is not None:
                            self.data_ch.send_to(
                                ps.peer_id,
                                ProposalPOLMessage(rs.height, rs.proposal.pol_round, pol.bit_array()),
                                timeout=1.0,
                            )
                    continue
            except Exception:
                pass
            time.sleep(self.GOSSIP_SLEEP)

    def _gossip_catchup(self, ps: PeerState, prs) -> bool:
        """Send one missing part of a committed block (reactor.go:437)."""
        if prs.proposal_block_parts is None:
            # init from the stored block meta so part bits line up
            meta = self.block_store.load_block_meta(prs.height)
            if meta is None:
                return False
            ps.init_proposal_block_parts(meta.block_id.part_set_header)
            return True
        if prs.proposal_block_parts_header is None:
            return False
        meta = self.block_store.load_block_meta(prs.height)
        if meta is None or meta.block_id.part_set_header != prs.proposal_block_parts_header:
            # the peer is assembling a DIFFERENT part set than our
            # stored committed block (its own in-flight round proposal)
            # — our parts can never prove into its header, and sending
            # them just feeds the peer "invalid proof" errors
            # (ref: reactor.go gossipDataForCatchup's
            # PartSetHeader.Equals guard)
            return False
        missing = BitArray(prs.proposal_block_parts_header.total).not_().sub(prs.proposal_block_parts)
        idx, ok = missing.pick_random()
        if not ok:
            return False
        part = self.block_store.load_block_part(prs.height, idx)
        if part is None:
            return False
        self.data_ch.send_to(ps.peer_id, BlockPartMessage(prs.height, prs.round, part), timeout=1.0)
        # deliberately NOT set_has_proposal_block_part: there is no ack,
        # and a part sent before the peer enters commit is dropped on
        # their side — keep resending until their NewRoundStep advances
        return True

    # --------------------------------------------------------- gossip votes

    def _gossip_votes_routine(self, ps: PeerState) -> None:
        """ref: reactor.go:736 gossipVotesRoutine."""
        while ps.running and not self._stop.is_set():
            rs = self.cs.rs
            prs = ps.prs
            try:
                if rs.height == prs.height:
                    if self._gossip_votes_for_height(rs, ps, prs):
                        continue
                # peer is on the previous height: send last-commit precommits
                if prs.height != 0 and rs.height == prs.height + 1 and rs.last_commit is not None:
                    if self._pick_send_vote(ps, rs.last_commit):
                        continue
                # peer is further behind: send precommits from the stored
                # commit at their height (reactor.go:789). When vote
                # extensions were enabled at that height the peer's
                # extended vote set rejects commit-derived votes, so
                # serve the stored EXTENDED commit instead.
                if prs.height != 0 and rs.height >= prs.height + 2 and self.block_store.base() <= prs.height:
                    if self.cs.state.consensus_params.abci.vote_extensions_enabled(prs.height):
                        votes = self.block_store.load_extended_commit(prs.height)
                        if votes and self._pick_send_extended(ps, prs, votes):
                            continue
                    else:
                        commit = self.block_store.load_block_commit(prs.height)
                        if commit is not None and self._pick_send_commit_sig(ps, prs, commit):
                            continue
            except Exception:
                pass
            time.sleep(self.GOSSIP_SLEEP)

    def _gossip_votes_for_height(self, rs, ps: PeerState, prs) -> bool:
        """ref: reactor.go:685 gossipVotesForHeight."""
        if rs.votes is None:
            return False
        # catchup: peer in earlier round wants that round's precommits? —
        # reference order: LastCommit → round prevotes/precommits → POL
        if prs.step == STEP_NEW_HEIGHT and rs.last_commit is not None:
            if self._pick_send_vote(ps, rs.last_commit):
                return True
        if prs.step <= STEP_PROPOSE and prs.round != -1 and prs.round <= rs.round and prs.proposal_pol_round >= 0:
            pol = rs.votes.prevotes(prs.proposal_pol_round)
            if pol is not None and self._pick_send_vote(ps, pol):
                return True
        if prs.step <= STEP_PRECOMMIT and prs.round != -1 and prs.round <= rs.round:
            prevotes = rs.votes.prevotes(prs.round)
            if prevotes is not None and self._pick_send_vote(ps, prevotes):
                return True
            precommits = rs.votes.precommits(prs.round)
            if precommits is not None and self._pick_send_vote(ps, precommits):
                return True
        if prs.round != -1 and prs.round <= rs.round:
            precommits = rs.votes.precommits(prs.round)
            if precommits is not None and self._pick_send_vote(ps, precommits):
                return True
        if prs.proposal_pol_round != -1:
            pol = rs.votes.prevotes(prs.proposal_pol_round)
            if pol is not None and self._pick_send_vote(ps, pol):
                return True
        return False

    def _pick_send_vote(self, ps: PeerState, votes) -> bool:
        """ref: reactor.go:717 pickSendVote."""
        vote = ps.pick_vote_to_send(votes)
        if vote is None:
            return False
        if self.vote_ch.send_to(ps.peer_id, VoteMessage(vote), timeout=1.0):
            ps.set_has_vote(vote)
            return True
        return False

    def _pick_send_commit_sig(self, ps: PeerState, prs, commit) -> bool:
        """Reconstruct one precommit from a stored Commit for a lagging
        peer (ref: reactor.go:789 via types.CommitToVoteSet)."""
        vals = self.cs.block_exec.store.load_validators(prs.height)
        if vals is None:
            return False
        ps.ensure_catchup_commit_round(prs.height, commit.round, vals.size())
        ps.ensure_vote_bit_arrays(prs.height, vals.size())
        from ..types.vote_set import VoteSet

        vote_set = VoteSet(self.cs.state.chain_id, commit.height, commit.round, PRECOMMIT, vals)
        for idx, cs_sig in enumerate(commit.signatures):
            if cs_sig.absent():
                continue
            vote = Vote(
                type=PRECOMMIT,
                height=commit.height,
                round=commit.round,
                block_id=cs_sig.block_id(commit.block_id),
                timestamp=cs_sig.timestamp,
                validator_address=cs_sig.validator_address,
                validator_index=idx,
                signature=cs_sig.signature,
            )
            vote_set.add_vote(vote)
        return self._pick_send_vote(ps, vote_set)

    def _pick_send_extended(self, ps: PeerState, prs, votes) -> bool:
        """Serve one stored EXTENDED precommit to a lagging peer whose
        vote set verifies extension signatures (ref: the extended-commit
        path of catch-up gossip)."""
        vals = self.cs.block_exec.store.load_validators(prs.height)
        if vals is None or not votes:
            return False
        # Absent validator slots are None entries; the round must come
        # from the first PRESENT vote (slot 0 may legitimately be absent).
        round_ = next((v.round for v in votes if v is not None), None)
        if round_ is None:
            return False
        ps.ensure_catchup_commit_round(prs.height, round_, vals.size())
        ps.ensure_vote_bit_arrays(prs.height, vals.size())
        from ..types.vote_set import VoteSet

        vote_set = VoteSet.extended(
            self.cs.state.chain_id, prs.height, round_, PRECOMMIT, vals
        )
        for vote in votes:
            if vote is None:
                continue
            try:
                vote_set.add_vote(vote)
            except Exception:
                continue  # skip any vote that fails re-verification
        return self._pick_send_vote(ps, vote_set)

    # ---------------------------------------------------------- maj23 query

    def _query_maj23_routine(self, ps: PeerState) -> None:
        """Periodically tell peers about our observed majorities
        (ref: reactor.go:808 queryMaj23Routine)."""
        while ps.running and not self._stop.is_set():
            time.sleep(self.QUERY_MAJ23_SLEEP)
            rs = self.cs.rs
            prs = ps.prs
            try:
                if rs.height != prs.height or rs.votes is None:
                    continue
                for vote_type, votes in (
                    (PREVOTE, rs.votes.prevotes(prs.round)),
                    (PRECOMMIT, rs.votes.precommits(prs.round)),
                ):
                    if votes is None:
                        continue
                    maj23, ok = votes.two_thirds_majority()
                    if ok:
                        self.state_ch.send_to(
                            ps.peer_id,
                            VoteSetMaj23Message(rs.height, prs.round, vote_type, maj23),
                            timeout=1.0,
                        )
            except Exception:
                pass
