"""The port's p2p layer (tendermint_tpu_torch/p2p: types, channel, transport,
transport_memory, conn_tracker, peermanager, router) against the JAX
package's, on the scenarios of tests/test_p2p.py that need no TCP, secret
connection or faultnet, each run on both packages with the outcomes held
equal: endpoint parsing and its round trip; NodeInfo compatibility and its
to_proto bytes; the conn tracker's limits; the three per-peer queue
disciplines; the peer manager's dial backoff, upgrade eviction, connection
limits and its JSON peer store (equal bytes under a fixed clock); and two
routers over a MemoryNetwork: a round trip on every queue type, a peer
error that evicts, the network switch and the per-peer veto, the
handshake's node-ID check, and the P2PMetrics the router writes. The
routers' node IDs come from the same seeds in both packages."""

import time
from types import SimpleNamespace

import pytest

import tendermint_tpu.metrics as JM
from tendermint_tpu.crypto.ed25519 import Ed25519PrivKey as JKey
from tendermint_tpu.p2p import conn_tracker as jconn
from tendermint_tpu.p2p import peermanager as jpm
from tendermint_tpu.p2p import router as jrouter
from tendermint_tpu.p2p import transport as jtransport
from tendermint_tpu.p2p import transport_memory as jmem
from tendermint_tpu.p2p import types as jtypes
from tendermint_tpu.proto import messages as jpb
from tendermint_tpu.store.kv import MemDB as JMemDB
from tendermint_tpu_torch import metrics as TM
from tendermint_tpu_torch.crypto.ed25519 import Ed25519PrivKey as TKey
from tendermint_tpu_torch.p2p import conn_tracker as tconn
from tendermint_tpu_torch.p2p import peermanager as tpm
from tendermint_tpu_torch.p2p import router as trouter
from tendermint_tpu_torch.p2p import transport as ttransport
from tendermint_tpu_torch.p2p import transport_memory as tmem
from tendermint_tpu_torch.p2p import types as ttypes
from tendermint_tpu_torch.proto import messages as tpb
from tendermint_tpu_torch.store.kv import MemDB as TMemDB

PORT = SimpleNamespace(name="port", Key=TKey, conn=tconn, pm=tpm, router=trouter,
                       transport=ttransport, mem=tmem, types=ttypes, pb=tpb, MemDB=TMemDB, metrics=TM)
JAX = SimpleNamespace(name="jax", Key=JKey, conn=jconn, pm=jpm, router=jrouter,
                      transport=jtransport, mem=jmem, types=jtypes, pb=jpb, MemDB=JMemDB, metrics=JM)
PACKAGES = (PORT, JAX)
CH = 0x77
A, B, C = "aa" * 20, "bb" * 20, "cc" * 20


def both(scenario, *args):
    """The scenario's outcome on each package, held equal; returns it."""
    got, want = (scenario(m, *args) for m in PACKAGES)
    assert got == want
    return got


def wait_until(cond, timeout=10.0, interval=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(interval)
    return False


def outcome(call):
    try:
        return ("ok", call())
    except Exception as e:  # noqa: BLE001 - the outcome is compared
        return (type(e).__name__, str(e))


def mem_endpoint(m, nid):
    return m.transport.Endpoint(protocol="memory", host=nid, node_id=nid)


# -- types and transport ------------------------------------------------------


@pytest.mark.parametrize("text", [
    "mconn://" + "ab" * 20 + "@127.0.0.1:26656", "memory:" + "cd" * 20, "memory:" + "cd" * 20 + "@" + "ef" * 20,
    "ab" * 20 + "@10.0.0.7:26656", "tcp://example.org:80", "mconn://host-only", "memory:"])
def test_endpoint_parse_round_trip(text):
    def parse(m):
        ep = m.transport.Endpoint.parse(text)
        again = m.transport.Endpoint.parse(str(ep))
        return (ep.protocol, ep.host, ep.port, ep.node_id, str(ep), (again.protocol, again.host, again.port,
                                                                     again.node_id))
    got = both(parse)
    if text.startswith("mconn://ab"):
        assert got[:4] == ("mconn", "127.0.0.1", 26656, "ab" * 20) and got[5] == got[:4]
    if text == "memory:" + "cd" * 20:
        assert got[0] == "memory" and got[3] == "cd" * 20


def test_peer_list_and_node_ids():
    def run(m):
        eps = m.transport.parse_peer_list(f" {A}@1.2.3.4:26656, ,mconn://{B}@h:1,{C}@[::1]:7 ")
        key = m.Key.generate(b"\x07" * 32)
        checks = [outcome(lambda nid=nid: m.types.validate_node_id(nid)) for nid in (A, A.upper(), A[:-2], "zz" * 20)]
        return [str(e) for e in eps], m.types.node_id_from_pubkey(key.pub_key()), checks
    eps, nid, checks = both(run)
    assert len(eps) == 3 and len(nid) == 40
    assert [c[0] for c in checks] == ["ok", "ValueError", "ValueError", "ValueError"]


def node_info(m, nid, **kw):
    return m.types.NodeInfo(node_id=nid, **kw)


def test_node_info_compatibility_and_proto_bytes():
    def run(m):
        a = node_info(m, A, network="net-1", channels=bytes([0x20]), listen_addr="memory:" + A, moniker="a",
                      rpc_address="tcp://0.0.0.0:26657", tx_index="off")
        others = [node_info(m, B, network="net-1", channels=bytes([0x20, 0x21])),
                  node_info(m, C, network="net-2", channels=bytes([0x20])),
                  node_info(m, B, network="net-1", channels=bytes([0x40])),
                  node_info(m, B, network="net-1"),
                  node_info(m, B, network="net-1", protocol_version=m.types.ProtocolVersion(block=10))]
        compat = [outcome(lambda o=o: a.compatible_with(o)) for o in others]
        wire = [x.to_proto().encode() for x in [a] + others]
        back = m.types.NodeInfo.from_proto(m.pb.NodeInfoProto.decode(wire[0]))
        return compat, wire, back.to_proto().encode(), outcome(lambda: node_info(m, "x", network="n").validate())
    compat, wire, back, invalid = both(run)
    assert [c[0] for c in compat] == ["ok", "ValueError", "ValueError", "ok", "ValueError"]
    assert back == wire[0] and invalid[0] == "ValueError"
    # each package decodes the other's bytes
    for src, dst in ((PORT, JAX), (JAX, PORT)):
        info = node_info(src, A, network="n", channels=b"\x40\x20", moniker="m")
        decoded = dst.types.NodeInfo.from_proto(dst.pb.NodeInfoProto.decode(info.to_proto().encode()))
        assert decoded.to_proto().encode() == info.to_proto().encode()


def test_conn_tracker_limits_per_ip():
    """tests/test_p2p.py test_conn_tracker_limits_per_ip on both packages."""
    def run(m):
        t = m.conn.ConnTracker(max_per_ip=2, window=0.0)
        out = [outcome(lambda: t.add_conn("10.0.0.1")) for _ in range(3)]
        out += [outcome(lambda: t.add_conn("10.0.0.2")), t.remove_conn("10.0.0.1"),
                outcome(lambda: t.add_conn("10.0.0.1")), t.len("10.0.0.1"), t.len("10.0.0.2")]
        t.remove_conn("10.0.0.2")
        out.append(t.len("10.0.0.2"))
        t2 = m.conn.ConnTracker(max_per_ip=8, window=10.0)
        out += [outcome(lambda: t2.add_conn("10.0.0.3")), outcome(lambda: t2.add_conn("10.0.0.3"))[0]]
        return out
    out = both(run)
    assert out[2][0] == "ConnectionRefusedError" and "too many" in out[2][1]
    assert out[6:9] == [2, 1, 0] and out[-1] == "ConnectionRefusedError"


# -- the per-peer queue disciplines ----------------------------------------------


def fill_queue(m, queue_type):
    """tests/test_p2p.py's priority and simple-priority scripts, and the
    fifo queue's, on one queue of 4: what each put returned, what was
    dropped, the order of the gets, and a put after close."""
    priorities = {0x20: 8, 0x30: 5, 0x00: 1}
    dropped = []
    if queue_type == "fifo":
        q = m.router._PeerQueue(4)
    else:
        cls = m.router._PriorityPeerQueue if queue_type == "priority" else m.router._SimplePriorityPeerQueue
        q = cls(4, priorities, on_drop=dropped.append)
    mk = lambda ch, n: m.types.Envelope(channel_id=ch, message=n)  # noqa: E731
    puts = [q.put(mk(ch, n), timeout=0.01) for ch, n in ((0x00, "pex1"), (0x30, "mp1"), (0x30, "mp2"),
                                                       (0x00, "pex2"), (0x20, "cs1"), (0x00, "pex3"))]
    size = q.qsize()
    got = []
    while (env := q.get(timeout=0.01)) is not None:
        got.append(env.message)
    q.close()
    return puts, size, got, dropped, getattr(q, "dropped", None), q.put(mk(0x20, "after-close"), timeout=0.01)


@pytest.mark.parametrize("queue_type", ["fifo", "priority", "simple-priority"])
def test_peer_queue_disciplines(queue_type):
    puts, size, got, dropped, n_dropped, after = both(fill_queue, queue_type)
    assert after is False and size == 4
    if queue_type == "fifo":
        assert puts == [True] * 4 + [False] * 2 and got == ["pex1", "mp1", "mp2", "pex2"]
    elif queue_type == "priority":
        # consensus evicts pex; the incoming pex then ranks lowest
        assert puts == [True] * 5 + [False] and n_dropped == 2 and dropped == [0x00]
        assert got == ["cs1", "mp1", "mp2", "pex1"]
    else:
        assert got == ["pex1", "mp1", "mp2", "cs1"] and dropped == [0x00]


# -- the peer manager ------------------------------------------------------------


def test_peer_manager_dial_retry_backoff():
    def run(m):
        pm = m.pm.PeerManager(A, m.pm.PeerManagerOptions(max_connected=4, min_retry_time=60.0))
        ep = mem_endpoint(m, B)
        added = [pm.add(ep), pm.add(ep), pm.add(mem_endpoint(m, A))]
        got = pm.try_dial_next()
        pm.dial_failed(ep)
        return added, str(got), pm.try_dial_next(), pm.store.get(B).score()
    added, got, again, score = both(run)
    assert added == [True, False, False] and got == f"memory:{B}@{B}" and again is None and score == -1


def test_peer_manager_upgrade_eviction():
    """A persistent (max-score) candidate evicts a low-scored peer at capacity."""
    def run(m):
        pm = m.pm.PeerManager(A, m.pm.PeerManagerOptions(max_connected=1, persistent_peers=[C]))
        updates = []
        pm.subscribe(lambda u: updates.append((u.node_id, u.status)))
        pm.add(mem_endpoint(m, B))
        ep1 = pm.try_dial_next()
        pm.dialed(ep1)
        pm.ready(B, set())
        pm.add(mem_endpoint(m, C))
        ep2 = pm.try_dial_next()
        pm.dialed(ep2)
        victim = pm.try_evict_next()
        pm.disconnected(victim)
        return ep2.node_id, victim, updates, pm.scores(), pm.connected_count()
    ep2, victim, updates, scores, connected = both(run)
    assert ep2 == C and victim == B and updates == [(B, "up"), (B, "down")] and connected == 1


def test_peer_manager_connection_limits():
    def run(m):
        pm = m.pm.PeerManager(A, m.pm.PeerManagerOptions(max_connected=1, max_connected_upgrade=0))
        out = [outcome(lambda: pm.accepted(B)), outcome(lambda: pm.accepted(C)), outcome(lambda: pm.accepted(B)),
               outcome(lambda: pm.accepted(A))]
        pm.errored(B, "bad")
        out.append(pm.try_evict_next())
        return out
    out = both(run)
    assert out[0] == ("ok", None) and out[1][0] == out[2][0] == out[3][0] == "ValueError" and out[4] == B


def test_peer_store_persistence(monkeypatch):
    """The JSON address book: equal bytes in both packages under a fixed
    clock, read back by a second manager over the same store."""
    def run(m):
        monkeypatch.setattr(m.pm.time, "time", lambda: 1700000000.5)
        db = m.MemDB()
        pm = m.pm.PeerManager(A, m.pm.PeerManagerOptions(persistent_peers=[C]), db=db)
        pm.add(mem_endpoint(m, B))
        pm.add(m.transport.Endpoint(protocol="mconn", host="10.0.0.2", port=26656, node_id=B))
        pm.dial_failed(pm.try_dial_next())
        pm.add(mem_endpoint(m, C))
        pm.dialed(pm.try_dial_next())
        pm.report_peer(B, -3)
        pm2 = m.pm.PeerManager(A, db=db)
        info = pm2.store.get(B)
        return (list(db.iterator()), sorted(str(ai.endpoint) for ai in info.address_info.values()),
                [p.node_id for p in pm2.store.ranked()], [a.endpoint.node_id for a in [*info.address_info.values()]])
    rows, eps, ranked, _ = both(run)
    assert [k for k, _ in rows] == [b"p2p/peer/" + B.encode(), b"p2p/peer/" + C.encode()]
    assert eps == sorted([f"memory:{B}@{B}", f"mconn://{B}@10.0.0.2:26656"]) and ranked == [C, B]
    # each package reads the other's book
    for src, dst in ((PORT, JAX), (JAX, PORT)):
        db = src.MemDB()
        src.pm.PeerManager(A, db=db).add(mem_endpoint(src, B))
        other = dst.MemDB()
        for k, v in db.iterator():
            other.set(k, v)
        assert str(next(iter(dst.pm.PeerManager(A, db=other).store.get(B).address_info.values())).endpoint) == \
            f"memory:{B}@{B}"


# -- routers over a MemoryNetwork ---------------------------------------------------


def make_node(m, net, seed, queue_type="fifo", metrics=None, chain="p2p-test"):
    key = m.Key.generate(bytes([seed]) * 32)
    nid = m.types.node_id_from_pubkey(key.pub_key())
    transport = net.create_transport(nid)
    pm = m.pm.PeerManager(nid, m.pm.PeerManagerOptions(max_connected=8), metrics=metrics)
    router = m.router.Router(m.types.NodeInfo(node_id=nid, network=chain, listen_addr=f"memory:{nid}"), key, pm,
                             [transport], options=m.router.RouterOptions(queue_type=queue_type), metrics=metrics)
    ch = router.open_channel(m.types.ChannelDescriptor(id=CH, name="test", priority=5))
    return SimpleNamespace(nid=nid, pm=pm, router=router, ch=ch)


def running(m, seeds, **kw):
    net = m.mem.MemoryNetwork()
    nodes = [make_node(m, net, s, **kw) for s in seeds]
    for n in nodes:
        n.router.start()
    return nodes


def stop(nodes):
    for n in nodes:
        n.router.stop()


def round_trip(m, queue_type):
    a, b = nodes = running(m, (1, 2), queue_type=queue_type)
    try:
        a.pm.add(mem_endpoint(m, b.nid))
        up = wait_until(lambda: b.nid in a.pm.peers()) and wait_until(lambda: a.nid in b.pm.peers())
        a.ch.send_to(b.nid, {"hello": "world"})
        env = b.ch.receive_one(timeout=10)
        b.ch.broadcast({"reply": 42})
        env2 = a.ch.receive_one(timeout=10)
        unknown = a.ch.send_to(C, "nobody")
        return (up, env.message, env.from_ == a.nid, env.channel_id, env2.message, env2.from_ == b.nid, unknown,
                b.ch.receive_one(timeout=0.3), a.router.channel_ids(), a.nid, b.nid)
    finally:
        stop(nodes)


@pytest.mark.parametrize("queue_type", ["fifo", "priority", "simple-priority"])
def test_router_two_nodes_round_trip(queue_type):
    got = both(round_trip, queue_type)
    assert got[:8] == (True, {"hello": "world"}, True, CH, {"reply": 42}, True, True, None)


def peer_error_evicts(m):
    a, b = nodes = running(m, (3, 4))
    updates = []
    a.pm.subscribe(lambda u: updates.append(u.status))
    try:
        a.pm.add(mem_endpoint(m, b.nid))
        up = wait_until(lambda: b.nid in a.pm.peers())
        a.ch.send_error(m.types.PeerError(node_id=b.nid, err="bad peer"))
        # evicted, then disconnected (the dialer may reconnect: eviction
        # does not blacklist the address)
        down = wait_until(lambda: "down" in updates)
        return up, down, updates[0]
    finally:
        stop(nodes)


def test_router_peer_error_evicts():
    assert both(peer_error_evicts) == (True, True, "up")


def network_switch(m):
    """router.set_network_enabled: closing every link now, refusing new ones
    while off, reconnecting through the dial retries once on."""
    a, b = nodes = running(m, (0x31, 0x32))
    try:
        a.pm.add(mem_endpoint(m, b.nid))
        out = [wait_until(lambda: b.nid in a.pm.peers())]
        b.router.set_network_enabled(False)
        out.append(wait_until(lambda: b.nid not in a.pm.peers() and a.nid not in b.pm.peers()))
        held = []
        for _ in range(10):
            held.append(a.nid in b.pm.peers())
            time.sleep(0.05)
        out += [any(held), b.router.network_enabled]
        b.router.set_network_enabled(True)
        out.append(wait_until(lambda: b.nid in a.pm.peers(), timeout=30))
        return out
    finally:
        stop(nodes)


def test_router_network_switch():
    assert both(network_switch) == [True, True, False, False, True]


def peer_veto(m):
    """router.set_peer_veto on one link of three nodes: that link closes on
    both sides and stays down on the vetoing side, the other lives, and an
    empty veto heals it."""
    a, b, c = nodes = running(m, (0x41, 0x42, 0x43))
    try:
        a.pm.add(mem_endpoint(m, b.nid))
        a.pm.add(mem_endpoint(m, c.nid))
        out = [wait_until(lambda: {b.nid, c.nid} <= set(a.pm.peers()))]
        b.router.set_peer_veto({a.nid.upper()})
        out.append(b.router.peer_veto == {a.nid})
        out.append(wait_until(lambda: b.nid not in a.pm.peers() and a.nid not in b.pm.peers()))
        seen = []
        for _ in range(10):
            seen.append(a.nid in b.pm.peers())
            time.sleep(0.05)
        out += [any(seen), c.nid in a.pm.peers()]
        b.router.set_peer_veto(())
        out.append(wait_until(lambda: b.nid in a.pm.peers(), timeout=30))
        return out
    finally:
        stop(nodes)


def test_router_peer_veto():
    assert both(peer_veto) == [True, True, True, False, True, True]


def test_memory_handshake_checks_node_id():
    """A peer whose NodeInfo names another node than its key is refused by
    the memory handshake; an unknown queue type by the router."""
    def run(m):
        import threading

        net = m.mem.MemoryNetwork()
        key_a, key_b = m.Key.generate(b"\x51" * 32), m.Key.generate(b"\x52" * 32)
        nid_a = m.types.node_id_from_pubkey(key_a.pub_key())
        t_a = net.create_transport(nid_a)
        t_b = net.create_transport(B)
        out = [outcome(lambda: net.create_transport(B))]
        conn = t_b.dial(t_a.endpoint())
        remote = t_a.accept(timeout=1)
        res = {}
        th = threading.Thread(target=lambda: res.update(a=outcome(lambda: remote.handshake(
            m.types.NodeInfo(node_id=nid_a), key_a, timeout=2)[0].node_id)))
        th.start()
        out.append(outcome(lambda: conn.handshake(m.types.NodeInfo(node_id=B), key_b, timeout=2)[0].node_id))
        th.join()
        out.append(res["a"])
        out.append(outcome(lambda: t_b.dial(m.transport.Endpoint(protocol="memory", host=C, node_id=C))))
        out.append(outcome(lambda: m.router.Router(m.types.NodeInfo(node_id=A), key_a, m.pm.PeerManager(A), [],
                                                   options=m.router.RouterOptions(queue_type="lifo"))))
        conn.close()
        out.append(outcome(lambda: remote.receive_message(timeout=1)))
        t_a.close()
        out.append(outcome(lambda: t_a.accept(timeout=1)))
        return out, nid_a
    out, nid_a = both(run)
    assert out[0][0] == "ValueError" and out[1] == ("ok", nid_a)
    assert out[2] == ("ValueError", "peer's public key does not match its node ID")
    assert out[3][0] == "ConnectionError" and out[4][0] == "ValueError"
    assert out[5][0] == out[6][0] == "ConnectionClosed"


# -- P2PMetrics ------------------------------------------------------------------


@pytest.mark.parametrize("group", ["P2PMetrics", "BlockSyncMetrics"])
def test_metric_groups_equal_reference(group):
    """An empty registry with the group renders the reference's exposition,
    and once each series is written, the same samples."""
    port_reg, ref_reg = TM.Registry(), JM.Registry()
    port, want = getattr(TM, group)(port_reg), getattr(JM, group)(ref_reg)
    assert port_reg.gather() == ref_reg.gather()
    for name in vars(want):
        for metric in (getattr(port, name), getattr(want, name)):
            labels = tuple(f"l{i}" for i in range(len(metric.label_names)))
            if metric.kind == "gauge":
                metric.set(3.5, *labels)
            else:
                metric.add(2, *labels)
    assert port_reg.gather() == ref_reg.gather()


def router_metrics(m):
    metrics = m.metrics.P2PMetrics(m.metrics.Registry())
    a, b = nodes = running(m, (5, 6), metrics=metrics)
    try:
        a.pm.add(mem_endpoint(m, b.nid))
        wait_until(lambda: b.nid in a.pm.peers() and a.nid in b.pm.peers())
        a.ch.send_to(b.nid, "x")
        b.ch.receive_one(timeout=10)
        return sorted((tuple(sorted(lb.items())), v) for _, lb, v in metrics.peer_connections.samples()), \
            metrics.dial_attempts.samples(), metrics.peers.samples()
    finally:
        stop(nodes)


def test_router_writes_p2p_metrics():
    """Two routers sharing one P2PMetrics: a connection each way, one
    dial that succeeded, one peer a router."""
    conns, dials, peers = both(router_metrics)
    assert conns == [((("dir", "in"),), 1), ((("dir", "out"),), 1)]
    assert [(lb, v) for _, lb, v in dials] == [({"result": "ok"}, 1)]
    assert [v for *_, v in peers] == [1]
