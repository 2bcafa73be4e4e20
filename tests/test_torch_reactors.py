"""The port's reactors (consensus/reactor.py with consensus/peer_state.py,
mempool/reactor.py, evidence/reactor.py, p2p/pex.py) against the JAX
package's.

Every ConsensusMessage variant (stamped with an origin and not), every PEX
message, the mempool's Txs frames (multi-tx, legacy, malformed) and both
evidence frames encode to the reference's bytes through the channels'
codecs and decode back. The reference's own cases run on the port:
tests/test_consensus_reactor.py, tests/test_mempool_reactor.py and
tests/test_pex.py (but its seed-node case, which needs the node, its config
and CLI: ROADMAP A14). Then a mixed network: two port nodes and two
reference nodes, four validators, each a router over TCP with a secret
connection on every link, reach height 3 together, every node committing
the same blocks."""

import importlib
import time
from types import SimpleNamespace

import pytest
import torch

import helpers
import test_consensus
from test_torch_evidence import attack_evidence
from test_torch_evidence_pool import duplicate_vote
from test_torch_refcases import port_copy, reference_cases, run_reference_case
from test_torch_state import build
from tendermint_tpu_torch.utils.varint import encode_uvarint

torch.set_num_threads(1)

MIXED_CHAIN = "mixed-tcp-chain"
MIXED_DEADLINE_S = 90
ORIGIN_NS = 1_700_000_123_456_789_012
ORIGIN_NODE = "ab" * 20


def modules(pkg):
    """The modules of a package (tendermint_tpu or tendermint_tpu_torch)
    the wire tests read, under shared names."""
    g = lambda name: importlib.import_module(f"{pkg}.{name}")
    return SimpleNamespace(
        name=pkg, msgs=g("consensus.messages"), reactor=g("consensus.reactor"), block=g("types.block"),
        part_set=g("types.part_set"), proposal=g("types.proposal"), vote=g("types.vote"), bits=g("utils.bits"),
        tmtime=g("utils.tmtime"), pb=g("proto.messages"), pex=g("p2p.pex"), mempool_reactor=g("mempool.reactor"),
        evidence_reactor=g("evidence.reactor"), p2p=g("p2p"), tcp=g("p2p.transport_tcp"),
        transport=g("p2p.transport"))


PORT, JAX = modules("tendermint_tpu_torch"), modules("tendermint_tpu")


@pytest.fixture
def fixed_origin(monkeypatch):
    """Both reactors stamp data-plane frames with the same origin time."""
    for m in (PORT, JAX):
        monkeypatch.setattr(m.reactor, "time", SimpleNamespace(time_ns=lambda: ORIGIN_NS))


def consensus_messages(m):
    """One of each consensus message, with empty and None bit arrays, a vote
    with an extension and a nil one."""
    M, bits = m.msgs, m.bits.BitArray
    psh = m.block.PartSetHeader(2, b"\x02" * 32)
    bid = m.block.BlockID(b"\x01" * 32, psh)
    ba = bits(10)
    for i in (0, 3, 9):
        ba.set_index(i, True)
    wide = bits(150)
    for i in range(0, 150, 7):
        wide.set_index(i, True)
    parts = m.part_set.PartSet.from_data(bytes(range(256)) * 9, 1000)
    t = m.tmtime.Time(1_700_000_000, 5)
    prop = m.proposal.Proposal(height=5, round=1, pol_round=0, block_id=bid, timestamp=t, signature=b"\x03" * 64)
    vote = lambda type_, block_id, **kw: m.vote.Vote(type=type_, height=5, round=1, block_id=block_id, timestamp=t,
                                                     validator_address=b"\x04" * 20, validator_index=3,
                                                     signature=b"\x05" * 64, **kw)
    return [
        M.NewRoundStepMessage(5, 1, 3, 10, 0), M.NewRoundStepMessage(1, 0, 1),
        M.NewValidBlockMessage(5, 1, psh, ba, True), M.NewValidBlockMessage(5, 1, psh, None, False),
        M.ProposalMessage(prop), M.ProposalPOLMessage(5, 0, ba), M.ProposalPOLMessage(5, 0, bits(0)),
        M.BlockPartMessage(5, 1, parts.get_part(1)),
        M.VoteMessage(vote(m.vote.PREVOTE, bid)), M.VoteMessage(vote(m.vote.PRECOMMIT, m.block.BlockID())),
        M.VoteMessage(vote(m.vote.PRECOMMIT, bid, extension=b"ext", extension_signature=b"\x06" * 64)),
        M.HasVoteMessage(5, 1, 1, 3), M.VoteSetMaj23Message(5, 1, 2, bid),
        M.VoteSetBitsMessage(5, 1, 2, bid, wide), M.VoteSetBitsMessage(5, 1, 1, m.block.BlockID(), bits(0)),
    ]


@pytest.mark.parametrize("origin", ["", ORIGIN_NODE])
def test_consensus_messages_are_the_reference_bytes(fixed_origin, origin):
    pairs = list(zip(consensus_messages(PORT), consensus_messages(JAX)))
    for port_msg, jax_msg in pairs:
        got = PORT.reactor.encode_consensus_msg(port_msg, origin)
        want = JAX.reactor.encode_consensus_msg(jax_msg, origin)
        assert got == want, type(port_msg).__name__
        back = PORT.reactor.decode_consensus_msg(want)
        assert type(back) is type(port_msg)
        assert PORT.reactor.encode_consensus_msg(back, origin) == want
        if not hasattr(back, "origin_ns"):
            assert back == port_msg
        elif origin:
            assert (back.origin_ns, back.origin_node) == (ORIGIN_NS, origin)
    descs = [PORT.reactor.consensus_channel_descriptors(), JAX.reactor.consensus_channel_descriptors()]
    assert [(d.id, d.name, d.priority, d.send_queue_capacity) for d in descs[0]] == \
        [(d.id, d.name, d.priority, d.send_queue_capacity) for d in descs[1]]
    with pytest.raises(ValueError, match="empty consensus message"):
        PORT.reactor.decode_consensus_msg(b"")


def pex_messages(m):
    pb = m.pb
    return [pb.PexMessage(pex_request=pb.PexRequest()),
            pb.PexMessage(pex_response=pb.PexResponse(addresses=[])),
            pb.PexMessage(pex_response=pb.PexResponse(addresses=[
                pb.PexAddress(url=f"mconn://{'%02x' % i * 20}@127.0.0.1:{26656 + i}") for i in range(5)]))]


def test_pex_messages_are_the_reference_bytes():
    port_d, jax_d = PORT.pex.pex_channel_descriptor(), JAX.pex.pex_channel_descriptor()
    assert (port_d.id, port_d.priority, port_d.send_queue_capacity, port_d.recv_message_capacity) == \
        (jax_d.id, jax_d.priority, jax_d.send_queue_capacity, jax_d.recv_message_capacity)
    for port_msg, jax_msg in zip(pex_messages(PORT), pex_messages(JAX)):
        want = jax_d.encode(jax_msg)
        assert port_d.encode(port_msg) == want
        assert port_d.encode(port_d.decode(want)) == want
    auth = [m.pb.AuthSigMessage(pub_key=m.pb.PublicKey(ed25519=b"\x07" * 32), sig=b"\x08" * 64).encode()
            for m in (PORT, JAX)]
    assert auth[0] == auth[1]
    assert PORT.pb.AuthSigMessage.decode(auth[1]).encode() == auth[1]


def test_txs_frames_are_the_reference_bytes():
    P, J = PORT.mempool_reactor, JAX.mempool_reactor
    assert (P.TXS_FRAME_MAGIC, P.MAX_FRAME_TXS, P.MAX_FRAME_BYTES, P.MAX_DECODE_TXS) == \
        (J.TXS_FRAME_MAGIC, J.MAX_FRAME_TXS, J.MAX_FRAME_BYTES, J.MAX_DECODE_TXS)
    txs = [b"k%d=v" % i * (i % 5 + 1) for i in range(300)] + [b"", bytes(range(256)) * 3]
    pd, jd = P.mempool_channel_descriptor(), J.mempool_channel_descriptor()
    for msg in (txs, txs[:1], [], b"legacy=1"):
        want = jd.encode(msg)
        assert pd.encode(msg) == want == (P.encode_txs_frame(msg) if isinstance(msg, list) else msg)
        assert pd.decode(want) == jd.decode(want)
    frame = P.encode_txs_frame(txs[:3])
    malformed = [frame[:-1], frame + b"x", P.TXS_FRAME_MAGIC + encode_uvarint(P.MAX_DECODE_TXS + 1),
                 P.TXS_FRAME_MAGIC + b"\xff" * 11]
    for bad in malformed:
        got, want = pd.decode(bad), jd.decode(bad)
        assert type(got).__name__ == type(want).__name__ == "MalformedTxsFrame"
        assert (type(got.err).__name__, str(got.err)) == (type(want.err).__name__, str(want.err))


def test_evidence_frames_are_the_reference_bytes():
    built = build("ed25519")
    pd, jd = PORT.evidence_reactor.evidence_channel_descriptor(), JAX.evidence_reactor.evidence_channel_descriptor()
    assert (pd.id, pd.priority, pd.recv_message_capacity) == (jd.id, jd.priority, jd.recv_message_capacity)
    from test_torch_state import PACKAGES

    mods = {name: m for name, m, _ in PACKAGES}
    dup = {name: duplicate_vote(mods[name], built[name], 3)[0] for name in ("port", "jax")}
    for pair in [dup] + [attack_evidence(which) for which in ("lunatic", "equivocation")]:
        want = jd.encode(pair["jax"])
        assert pd.encode(pair["port"]) == want
        back = pd.decode(want)
        assert type(back).__name__ == type(pair["port"]).__name__
        assert pd.encode(back) == want and back.hash() == pair["jax"].hash()


# -- the reference's cases on the port ----------------------------------------

# tests/test_pex.py's fixture, on the port: pytest finds it by name here
reactor = port_copy("test_pex").reactor


@pytest.mark.parametrize("name,test,kw", reference_cases("test_consensus_reactor")
                         + reference_cases("test_mempool_reactor")
                         + reference_cases("test_pex"))
def test_reference_case(name, test, kw, request):
    run_reference_case(name, test, kw, request)


# -- a mixed network over TCP --------------------------------------------------


def tcp_node(m, tc, keys, idx, gen_doc):
    """A validator of package m (its test_consensus module tc builds the
    node), with a router on a TcpTransport bound to 127.0.0.1 and the
    consensus reactor."""
    cs = tc.make_node(keys, idx, gen_doc)
    key = keys[idx]
    nid = m.p2p.node_id_from_pubkey(key.pub_key())
    descs = m.reactor.consensus_channel_descriptors()
    transport = m.tcp.TcpTransport(descs)
    pm = m.p2p.PeerManager(nid, m.p2p.PeerManagerOptions(max_connected=8))
    router = m.p2p.Router(m.p2p.NodeInfo(node_id=nid, network=MIXED_CHAIN), key, pm, [transport])
    chans = [router.open_channel(d) for d in descs]
    reactor = m.reactor.ConsensusReactor(cs, *chans, pm, cs.block_store)
    return SimpleNamespace(m=m, cs=cs, nid=nid, transport=transport, pm=pm, router=router, reactor=reactor)


def test_mixed_port_and_reference_network_over_tcp():
    """Validators 0 and 2 run the port, 1 and 3 the reference; each dials
    the nodes after it. All four reach height 3 within the deadline, and
    every committed block and app hash is the same on all four."""
    port_tc, port_helpers = port_copy("test_consensus"), port_copy("helpers")
    nodes = []
    for i in range(4):
        m, tc, hp = (PORT, port_tc, port_helpers) if i % 2 == 0 else (JAX, test_consensus, helpers)
        keys = hp.make_keys(4)
        gen_doc = hp.make_genesis_doc(keys, MIXED_CHAIN)
        gen_doc.consensus_params = tc.fast_params()
        nodes.append(tcp_node(m, tc, keys, i, gen_doc))
    try:
        for n in nodes:
            n.router.start()
            n.reactor.start()
            n.cs.start()
        for i, a in enumerate(nodes):
            for b in nodes[i + 1:]:
                ep = b.transport.endpoint()
                a.pm.add(a.m.transport.Endpoint(protocol="mconn", host=ep.host, port=ep.port, node_id=b.nid))
        deadline = time.monotonic() + MIXED_DEADLINE_S
        while time.monotonic() < deadline and min(n.cs.block_store.height() for n in nodes) < 3:
            time.sleep(0.05)
        heights = [n.cs.block_store.height() for n in nodes]
        assert min(heights) >= 3, f"heights {heights} after {MIXED_DEADLINE_S} s"
        assert [len(n.pm.peers()) for n in nodes] == [3] * 4
    finally:
        for n in nodes:
            n.cs.stop()
            n.reactor.stop()
            n.router.stop()
    for h in range(1, 4):
        blocks = {n.cs.block_store.load_block(h).hash() for n in nodes}
        assert len(blocks) == 1, (h, blocks)
    assert len({n.cs.block_store.load_block(3).header.app_hash for n in nodes}) == 1
