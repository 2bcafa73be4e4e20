"""The port's blocksync (tendermint_tpu_torch/blocksync: pool.py, reactor.py)
against the JAX package's, exactly, on test_torch_state's chains
(chip_smoke.state_chain at 6 validators and 16 heights on each plane, built
by both packages from one memoizing signer over MemDBs, the port on
device="cpu"): the five blocksync messages encode to the reference's bytes
and each package decodes the other's, a BlockResponse with a block and an
ExtendedCommit included; the BlockPool's request window, peeks, bans,
refusal of unsolicited blocks, retry_height, peer timeouts, settle window
and reanchor; a fresh node of each package synced through _try_sync_one to
equal store bytes, states and app hashes at every height, the verify-ahead
consumed from height 2; a tampered second block reporting both senders and
redoing both heights; the verify-ahead catching a tampered commit;
_validate_ext_commit's shape rules and refusals on an ExtendedCommit with
real extension signatures; a threaded sync over two routers and a
MemoryNetwork to on_caught_up; a 97-validator chain whose 65-signature
light checks take the port's device branch (the cached bitmap's plain
versions); and the port's refusal to re-verify on the host after its
extension batch fails (no quiet fallback)."""

import copy
from types import SimpleNamespace

import pytest
import torch

import chip_smoke as cs
from test_torch_state import CHAIN_ID, HEIGHTS, JAX, build, kv_bytes, mem_dbs
from tendermint_tpu import blocksync as jblocksync
from tendermint_tpu import metrics as jmetrics
from tendermint_tpu import p2p as jp2p
from tendermint_tpu.blocksync import pool as jbs_pool
from tendermint_tpu.blocksync import reactor as jreactor
from tendermint_tpu.crypto import batch as jbatch
from tendermint_tpu.crypto import ed25519 as jed
from tendermint_tpu.crypto.ed25519 import Ed25519PrivKey as JKey
from tendermint_tpu.proto import messages as jpb
from tendermint_tpu_torch.crypto import ed25519 as ted
from tendermint_tpu_torch.metrics import engine_metrics

torch.set_num_threads(1)

PORT = cs.blocksync_modules()
JAXB = SimpleNamespace(**vars(JAX), blocksync=jblocksync, bs_pool=jbs_pool, reactor=jreactor, p2p=jp2p, pb=jpb,
                       metrics=jmetrics, batch=jbatch, node_key=JKey)
SYNC = (("port", PORT, {"device": "cpu"}), ("jax", JAXB, {}))
PEER_A, PEER_B, PEER_C = cs.BLOCKSYNC_PEERS
TAMPER = 2  # the LastCommit signature the tampered blocks alter


@pytest.fixture(scope="module", params=cs.PLANES)
def chains(request):
    return build(request.param), request.param


def both(run):
    """run(name, m, kw) on each package, the outcomes held equal."""
    got, want = (run(name, m, kw) for name, m, kw in SYNC)
    assert got == want
    return got


def outcome(call):
    try:
        return ("ok", call())
    except Exception as e:  # noqa: BLE001 - the outcome is compared
        return (cs.error_name(e), str(e))


# -- the wire messages ------------------------------------------------------------


def messages(m, block, ec):
    r = m.reactor
    return [r.BlockRequest(7), r.NoBlockResponse(9), r.StatusRequest(), r.StatusResponse(1, 42),
            r.BlockResponse(block), r.BlockResponse(block, ext_commit=ec)]


def test_messages_encode_to_reference_bytes(chains):
    built, _ = chains
    h = cs.STATE_DOUBLE_SIGN_AT + 1  # a block that carries evidence
    wire = {}
    for name, m, _ in SYNC:
        chain = built[name]
        ec = cs.extended_commit(m, chain.node.blocks.load_seen_commit(h), chain.secrets, built["sign"], CHAIN_ID)
        wire[name] = [m.reactor.encode_blocksync_msg(msg) for msg in messages(m, chain.chain[h][1], ec)]
    assert wire["port"] == wire["jax"]
    for (src, _, _), (dst, m, _) in ((SYNC[0], SYNC[1]), (SYNC[1], SYNC[0])):
        for data in wire[src]:
            msg = m.reactor.decode_blocksync_msg(data)
            assert m.reactor.encode_blocksync_msg(msg) == data
    decoded = PORT.reactor.decode_blocksync_msg(wire["jax"][-1])
    assert decoded.block.hash() == built["jax"].chain[h][2].hash
    assert len(decoded.ext_commit.extended_signatures) == built["port"].chain[h][0].validators.size()
    for name, m, _ in SYNC:
        assert outcome(lambda: m.reactor.decode_blocksync_msg(b""))[0] == "ValueError"
        assert outcome(lambda: m.reactor.encode_blocksync_msg(object()))[0] == "TypeError"
        # a block_response without its block
        empty = m.pb.BlocksyncMessage(block_response=m.pb.BlocksyncBlockResponse()).encode()
        assert outcome(lambda: m.reactor.decode_blocksync_msg(empty)) == (
            "ValueError", "block_response without a block")
        desc = m.reactor.blocksync_channel_descriptor()
        assert (desc.id, desc.priority, desc.send_queue_capacity, desc.recv_buffer_capacity) == (0x40, 5, 1000, 1024)


# -- the pool ---------------------------------------------------------------------


class FakeBlock:
    def __init__(self, h):
        self.header = SimpleNamespace(height=h)


def pool_run(m, script):
    """script(pool, sent, errors) on a fresh BlockPool at height 1 whose
    requests and peer errors are recorded."""
    sent, errors = [], []
    pool = m.bs_pool.BlockPool(1, lambda h, p: sent.append((h, p)), lambda e, p: errors.append((p, str(e))))
    return script(pool, sent, errors)


def pool_both(script):
    got, want = (pool_run(m, script) for m in (PORT, JAXB))
    assert got == want
    return got


def _requests_and_ordering(pool, sent, errors):
    pool.set_peer_range(PEER_A, 1, 5)
    pool._fill_requests()
    return sorted(h for h, _ in sent), pool.is_caught_up(), pool.status()


def _add_peek_pop(pool, sent, errors):
    pool.set_peer_range(PEER_A, 1, 3)
    pool._fill_requests()
    added = [pool.add_block(PEER_A, FakeBlock(h)) for h in (1, 2, 2)]
    peeks = []
    for _ in range(2):
        first, second = pool.peek_two_blocks()
        peeks.append((first and first.header.height, second and second.header.height,
                       pool.peek_third_block(), pool.block_sender(1)))
        pool.pop_request()
    return added, peeks, pool.height, sorted(pool.requesters)


def _redo_bans(pool, sent, errors):
    pool.set_peer_range(PEER_A, 1, 3)
    pool.set_peer_range(PEER_B, 1, 5)
    pool._fill_requests()
    by_peer = {h: p for h, p in sent}
    for h, p in sorted(by_peer.items()):
        pool.add_block(p, FakeBlock(h))
    bad = pool.redo_request(1)
    return (bad, sorted(pool.peers), sorted(pool.blocks), sorted(pool.requesters), pool.max_peer_height,
            pool.redo_request(9))


def _unsolicited(pool, sent, errors):
    pool.set_peer_range(PEER_A, 1, 2)
    pool._fill_requests()
    out = [pool.add_block(PEER_B, FakeBlock(1)), pool.add_block(PEER_A, FakeBlock(3)),
           pool.add_block(PEER_A, FakeBlock(1), ext_commit="ec-1"), pool.take_ext_commit(1), pool.take_ext_commit(1)]
    return out, errors


def _retry_height(pool, sent, errors):
    """A NoBlockResponse: the height is unassigned (no ban), its peer's range
    shrinks below it, and the next request goes to the other peer."""
    pool.set_peer_range(PEER_A, 1, 4)
    pool.set_peer_range(PEER_B, 1, 4)
    pool._fill_requests()
    owner = dict(sent)[3]
    pool.retry_height(3, PEER_C)  # not the requester: nothing happens
    kept = dict(pool.requesters)
    pool.retry_height(3, owner)
    ranges = {p: (v.base, v.height, v.pending) for p, v in pool.peers.items()}
    sent.clear()
    pool._fill_requests()
    return owner, kept, sorted(pool.requesters), ranges, sent, errors


def _peer_timeouts(pool, sent, errors):
    pool.set_peer_range(PEER_A, 1, 3)
    pool.set_peer_range(PEER_B, 4, 4)
    pool._fill_requests()
    pool.add_block(PEER_B, FakeBlock(4))  # nothing pending from B: no timeout
    pool.peers[PEER_A].last_block_at -= PEER_TIMEOUT_PAST
    pool.peers[PEER_B].last_block_at -= PEER_TIMEOUT_PAST
    pool._check_peer_timeouts()
    return sorted(pool.peers), errors, sorted(pool.requesters), sorted(pool.blocks), pool.max_peer_height


def _settle_and_reanchor(pool, sent, errors):
    out = [pool.is_caught_up()]
    pool.set_peer_range(PEER_A, 0, 0)
    out.append(pool.is_caught_up())  # inside the settle window
    pool.settle_seconds = 0.0
    out.append(pool.is_caught_up())  # height 1 < max 0 is false: caught up
    pool.reanchor(7)
    pool.set_peer_range(PEER_B, 1, 9)
    out += [pool.is_caught_up(), (pool.height, pool.start_height)]
    pool._fill_requests()
    out.append(sorted(h for h, _ in sent))
    pool.remove_peer(PEER_B)
    out += [sorted(pool.requesters), pool.max_peer_height]
    return out


PEER_TIMEOUT_PAST = 60.0  # seconds the peers' last block is moved back, past PEER_TIMEOUT


@pytest.mark.parametrize("script", [_requests_and_ordering, _add_peek_pop, _redo_bans, _unsolicited,
                                    _retry_height, _peer_timeouts, _settle_and_reanchor],
                         ids=lambda f: f.__name__.strip("_"))
def test_pool_matches_reference(script):
    got = pool_both(script)
    if script is _requests_and_ordering:
        assert got[0] == [1, 2, 3, 4, 5] and got[1] is False
    if script is _add_peek_pop:
        assert got[0] == [True, True, False] and got[1][0][:2] == (1, 2) and got[1][1][:2] == (2, None)
    if script is _redo_bans:
        assert got[0] is not None and got[0] not in got[1] and got[5] is None
    if script is _unsolicited:
        assert got[0] == [False, False, True, "ec-1", None] and [p for p, _ in got[1]] == [PEER_B, PEER_A]
    if script is _retry_height:
        owner, kept, _, ranges, resent, errors = got
        other = PEER_B if owner == PEER_A else PEER_A
        assert kept[3] == owner and ranges[owner][1] == 2 and resent == [(3, other)] and errors == []
    if script is _peer_timeouts:
        assert got == ([PEER_B], [(PEER_A, "peer did not send us anything")], [4], [4], 4)
    if script is _settle_and_reanchor:
        assert got[:3] == [False, False, True] and got[4] == (7, 7) and got[5] == [7, 8, 9] and got[6] == []


def test_pool_constants_match_reference():
    names = ("REQUEST_INTERVAL", "MAX_PENDING_REQUESTS_PER_PEER", "MAX_TOTAL_REQUESTERS", "PEER_TIMEOUT",
             "STATUS_SETTLE_SECONDS")
    assert [getattr(PORT.bs_pool, n) for n in names] == [getattr(JAXB.bs_pool, n) for n in names]
    r = (PORT.reactor.BlockSyncReactor, JAXB.reactor.BlockSyncReactor)
    assert [(c.STATUS_UPDATE_INTERVAL, c.SWITCH_CHECK_INTERVAL) for c in r] == [(2.0, 0.5)] * 2


# -- syncing a chain through _try_sync_one ------------------------------------------


def fresh_reactor(built, name, m, kw):
    return cs.sync_node(m, built[name].gen, mem_dbs(m), **kw)


def sync_all(built, name, m, kw, block_at=None):
    """A fresh node synced from blocks 1-16 of the package's chain: per
    height whether a verify-ahead was waiting, the result, the store bytes,
    state_to_json and app hash."""
    chain = built[name]
    node, reactor, ch = fresh_reactor(built, name, m, kw)
    cs.serve(reactor, block_at or chain.node.blocks.load_block, PEER_A, 1, HEIGHTS)
    out = []
    for _ in range(1, HEIGHTS):
        ahead = reactor._verify_ahead is not None
        ok = reactor._try_sync_one()
        h = reactor.state.last_block_height
        out.append((ahead, ok, h, m.state_store.state_to_json(reactor.state), reactor.state.app_hash))
    return out, kv_bytes(node.dbs["blocks"]), kv_bytes(node.dbs["state"]), kv_bytes(node.dbs["app"]), ch.errors


def test_sync_matches_reference(chains):
    built, _ = chains
    steps, blocks, states, app, errors = both(lambda name, m, kw: sync_all(built, name, m, kw))
    assert [s[:3] for s in steps] == [(h > 1, True, h) for h in range(1, HEIGHTS)]
    for h, (_, _, _, doc, app_hash) in enumerate(steps, 1):
        assert (doc, app_hash) == (built["port"].chain[h][4], built["port"].chain[h][3])
    assert errors == []
    # the synced block store holds the source's blocks, metas and seen commits
    src = built["port"].node.blocks
    synced = PORT.blockstore.BlockStore(copy_db(PORT, blocks))
    for h in range(1, HEIGHTS):
        for load in ("load_block", "load_block_meta", "load_seen_commit"):
            assert getattr(synced, load)(h).to_proto().encode() == getattr(src, load)(h).to_proto().encode()


def copy_db(m, rows):
    db = m.kv.MemDB()
    for k, v in rows:
        db.set(k, v)
    return db


def tampered_sync(built, name, m, kw, at):
    """Blocks 1..at-1 from PEER_A, at..16 from PEER_B with block `at`'s
    LastCommit signature #TAMPER altered; synced until the refusal; then
    PEER_C serves the honest blocks and the sync completes."""
    chain = built[name]
    node, reactor, ch = fresh_reactor(built, name, m, kw)
    bad = cs.tampered_block(m, chain.node.blocks.load_block(at), TAMPER)
    cs.serve(reactor, chain.node.blocks.load_block, PEER_A, 1, at - 1)
    cs.serve(reactor, lambda h: bad if h == at else chain.node.blocks.load_block(h), PEER_B, at, HEIGHTS)
    results = []
    while not results or results[-1]:
        results.append(reactor._try_sync_one())
    pool = reactor.pool
    after = (sorted(pool.peers), pool.height, sorted(pool.requesters), sorted(pool.blocks),
             [(e.node_id, str(e.err)) for e in ch.errors])
    cs.serve(reactor, chain.node.blocks.load_block, PEER_C, pool.height, HEIGHTS)
    while reactor._try_sync_one():
        pass
    return results, after, m.state_store.state_to_json(reactor.state), kv_bytes(node.dbs["blocks"])


@pytest.mark.parametrize("at", [2, cs.BLOCKSYNC_TAMPER_AT])
def test_tampered_second_block_reports_both_senders(chains, at):
    """Block `at` (its LastCommit proves at - 1) from a second peer with a
    signature altered: the light check of at - 1 refuses (at 12, through
    the verify-ahead dispatched at 10), both senders are reported, both
    heights redone; the honest blocks then complete the sync."""
    built, _ = chains
    results, after, doc, _ = both(lambda name, m, kw: tampered_sync(built, name, m, kw, at))
    assert results == [True] * (at - 2) + [False]
    peers, height, requesters, blocks, errors = after
    assert (peers, height, requesters, blocks) == ([], at - 1, [], [])
    assert [e[0] for e in errors] == [PEER_B, PEER_A]
    assert all(e[1].startswith(f"wrong signature (#{TAMPER}):") for e in errors)
    assert doc == built["port"].chain[HEIGHTS - 1][4]


def verify_ahead_tampering(built, name, m, kw):
    """Blocks 1-3 from one peer, block 3's LastCommit (proving 2) altered:
    height 1 syncs and dispatches the verify-ahead of 2 on the altered
    commit, whose completion refuses height 2."""
    chain = built[name]
    node, reactor, ch = fresh_reactor(built, name, m, kw)
    bad = cs.tampered_block(m, chain.node.blocks.load_block(3), TAMPER)
    cs.serve(reactor, lambda h: bad if h == 3 else chain.node.blocks.load_block(h), PEER_B, 1, 3)
    first = reactor._try_sync_one()
    ahead = reactor._verify_ahead is not None and reactor._verify_ahead[0]
    second = reactor._try_sync_one()
    return first, ahead, second, [(e.node_id, str(e.err)) for e in ch.errors], reactor.state.last_block_height


def test_verify_ahead_catches_tampering(chains):
    built, _ = chains
    first, ahead, second, errors, height = both(lambda name, m, kw: verify_ahead_tampering(built, name, m, kw))
    assert (first, ahead, second, height) == (True, 2, False, 1)
    assert [e[0] for e in errors] == [PEER_B] and errors[0][1].startswith(f"wrong signature (#{TAMPER}):")


# -- extended commits -------------------------------------------------------------------


def ext_cases(m, ec, h, first_id, vals):
    """_validate_ext_commit's shape rules and cryptographic refusals, by label."""
    pb = m.pb
    absent = pb.ExtendedCommitSig(block_id_flag=1, timestamp=pb.Timestamp())

    def with_sig(i, **changes):
        e = copy.deepcopy(ec)
        for k, v in changes.items():
            setattr(e.extended_signatures[i], k, v)
        return e

    wrong_bid = m.block.BlockID(hash=b"\xcc" * 32, part_set_header=first_id.part_set_header)
    swapped = copy.deepcopy(ec)
    sigs = swapped.extended_signatures
    sigs[0].validator_address, sigs[1].validator_address = sigs[1].validator_address, sigs[0].validator_address
    return {
        "honest": (ec, first_id, vals),
        "honest, no set": (ec, first_id, None),
        "missing": (None, first_id, vals),
        "wrong height": (pb.ExtendedCommit(height=h + 1, round=ec.round, block_id=ec.block_id,
                                           extended_signatures=ec.extended_signatures), first_id, vals),
        "wrong block": (ec, wrong_bid, vals),
        "commit slot without extension signature": (with_sig(1, extension_signature=b""), first_id, vals),
        "nil slot with extension data": (with_sig(1, block_id_flag=3, extension_signature=b""), first_id, None),
        "absent slot": (with_sig(1, block_id_flag=1, validator_address=b"", signature=b"", extension=b"",
                                 extension_signature=b""), first_id, vals),
        "extension signature altered": (cs.altered_ext(ec, 3, "extension_signature"), first_id, vals),
        "vote signature altered": (cs.altered_ext(ec, TAMPER, "signature"), first_id, vals),
        "validator addresses swapped": (swapped, first_id, vals),
        "a slot short": (pb.ExtendedCommit(height=h, round=ec.round, block_id=ec.block_id,
                                           extended_signatures=ec.extended_signatures[:-1]), first_id, vals),
        "no signatures": (pb.ExtendedCommit(height=h, round=ec.round, block_id=ec.block_id,
                                            extended_signatures=[]), first_id, vals),
        "only absent": (pb.ExtendedCommit(height=h, round=ec.round, block_id=ec.block_id,
                                          extended_signatures=[absent] * vals.size()), first_id, vals),
    }


def ext_outcomes(built, name, m, kw):
    chain = built[name]
    h = cs.BLOCKSYNC_EXT_AT
    vals, first_id = chain.chain[h][0].validators, chain.chain[h][2]
    ec = cs.extended_commit(m, chain.node.blocks.load_seen_commit(h), chain.secrets, built["sign"], CHAIN_ID)
    _, reactor, _ = fresh_reactor(built, name, m, kw)
    out = {}
    for label, (e, bid, vs) in ext_cases(m, ec, h, first_id, vals).items():
        err = reactor._validate_ext_commit(e, h, bid, vs, CHAIN_ID)
        out[label] = None if err is None else (type(err).__name__, str(err))
    return out, ec.encode()


def test_validate_ext_commit_matches_reference(chains):
    built, _ = chains
    out, ec_bytes = both(lambda name, m, kw: ext_outcomes(built, name, m, kw))
    accepted = {label for label, err in out.items() if err is None}
    assert accepted == {"honest", "honest, no set", "absent slot"}
    assert out["extension signature altered"][1] == "extended commit has an invalid extension signature"
    assert out["vote signature altered"][1].startswith(
        f"extended commit votes failed verification: wrong signature (#{TAMPER})")
    assert "wrong validator address" in out["validator addresses swapped"][1]
    assert out["missing"][1].endswith("arrived without extended commit")


def test_ext_commit_extension_signatures_verify(chains):
    """The extended commits' extension signatures are real: each verifies
    under its validator's key over the canonical vote-extension bytes."""
    built, _ = chains
    chain = built["port"]
    h = cs.BLOCKSYNC_EXT_AT
    ec = cs.extended_commit(PORT, chain.node.blocks.load_seen_commit(h), chain.secrets, built["sign"], CHAIN_ID)
    vals = chain.chain[h][0].validators
    votes = PORT.vote.votes_from_extended_commit(ec)
    assert all(vals.validators[i].pub_key.verify_signature(v.extension_sign_bytes(CHAIN_ID), v.extension_signature)
               for i, v in enumerate(votes))


class FailingBatch:
    """A batch verifier whose collect raises what it is given."""

    def __init__(self, exc):
        self.exc, self.rows = exc, 0

    def add(self, pk, msg, sig):
        self.rows += 1

    def verify_async(self):
        def collect():
            raise self.exc
        return collect


@pytest.mark.parametrize("exc", [RuntimeError("device launch failed"), ValueError("no kernel for device cpu")])
def test_extension_batch_failure_is_not_verified_on_host(chains, monkeypatch, exc):
    """An error of the extension batch's collect, a RuntimeError (a device,
    build or launch failure) or a kernel wrapper's ValueError, propagates
    from the port's _validate_ext_commit and no extension is verified on
    the host. The reference verifies on the host after either."""
    built, plane = chains
    chain = built["port"]
    h = cs.BLOCKSYNC_EXT_AT
    vals, first_id = chain.chain[h][0].validators, chain.chain[h][2]
    ec = cs.extended_commit(PORT, chain.node.blocks.load_seen_commit(h), chain.secrets, built["sign"], CHAIN_ID)
    _, reactor, _ = fresh_reactor(built, "port", PORT, {"device": "cpu"})
    batches, host = [], []
    real_batch = PORT.batch.create_batch_verifier

    def batch_verifier(pk, device=None):
        # the vote batch first (verify_commit_async), then the extension batch
        batches.append(real_batch(pk, device=device) if not batches else FailingBatch(exc))
        return batches[-1]

    monkeypatch.setattr(PORT.batch, "create_batch_verifier", batch_verifier)
    key_cls = type(vals.validators[0].pub_key)
    real = key_cls.verify_signature
    monkeypatch.setattr(key_cls, "verify_signature", lambda self, msg, sig: host.append(1) or real(self, msg, sig))
    with pytest.raises(type(exc), match=str(exc)):
        reactor._validate_ext_commit(ec, h, first_id, vals, CHAIN_ID)
    assert host == []
    assert len(batches) == 2 and batches[1].rows == vals.size()


def test_device_failure_in_light_check_propagates(chains, monkeypatch):
    """A light check that fails for a reason other than its verdict (here a
    RuntimeError from the batch verifier) propagates from _try_sync_one: no
    peer is reported, nothing is redone. The reference bans the senders."""
    built, _ = chains
    node, reactor, ch = fresh_reactor(built, "port", PORT, {"device": "cpu"})
    cs.serve(reactor, built["port"].node.blocks.load_block, PEER_A, 1, 3)

    def broken(*a, **k):
        raise RuntimeError("device launch failed")

    monkeypatch.setattr(PORT.reactor, "verify_commit_light", broken)
    with pytest.raises(RuntimeError, match="device launch failed"):
        reactor._try_sync_one()
    assert ch.errors == [] and sorted(reactor.pool.peers) == [PEER_A] and sorted(reactor.pool.blocks) == [1, 2, 3]


@pytest.mark.parametrize("where", ["light check", "verify-ahead", "extended commit"])
def test_wrapper_value_error_is_no_verdict(chains, monkeypatch, where):
    """A kernel wrapper's ValueError (here the RLC entry point's "no kernel
    for device", reached with both cutovers at 1 and the engine off) is a
    fault of this node, not a verdict on the block: it propagates from the
    light check, the verify-ahead's completion and _validate_ext_commit; no
    peer is reported, nothing is redone and nothing is verified on the host.
    The reference bans the senders, or verifies the extensions on the host."""
    built, plane = chains
    chain = built["port"]
    monkeypatch.setenv("TM_TPU_ENGINE", "off")
    monkeypatch.setattr(ted, "DEVICE_BATCH_CUTOVER", 1)
    monkeypatch.setattr(ted, "MSM_BATCH_CUTOVER", 1)
    from tendermint_tpu_torch.ops import msm

    calls = []
    # the verify-ahead case lets the light check of height 1 through
    good = {"light check": 0, "verify-ahead": 1, "extended commit": 1}[where]

    def rlc(real):
        def entry(*a, **k):
            calls.append(1)
            if len(calls) > good:
                raise ValueError("no kernel for device cpu")
            return real(*a, **k)
        return entry

    for name in ("verify_batch_rlc_async", "verify_batch_rlc_cached_async", "verify_batch_rlc_sr_async"):
        monkeypatch.setattr(msm, name, rlc(getattr(msm, name)))
    host = []
    vals = chain.chain[1][0].validators
    key_cls = type(vals.validators[0].pub_key)
    real = key_cls.verify_signature
    monkeypatch.setattr(key_cls, "verify_signature", lambda self, msg, sig: host.append(1) or real(self, msg, sig))
    node, reactor, ch = fresh_reactor(built, "port", PORT, {"device": "cpu"})
    if where == "extended commit":
        h = cs.BLOCKSYNC_EXT_AT
        ec = cs.extended_commit(PORT, chain.node.blocks.load_seen_commit(h), chain.secrets, built["sign"], CHAIN_ID)
        with pytest.raises(ValueError, match="no kernel for device"):
            reactor._validate_ext_commit(ec, h, chain.chain[h][2], chain.chain[h][0].validators, CHAIN_ID)
    else:
        cs.serve(reactor, chain.node.blocks.load_block, PEER_A, 1, 3)
        if where == "verify-ahead":
            assert reactor._try_sync_one() and reactor._verify_ahead[0] == 2
        with pytest.raises(ValueError, match="no kernel for device"):
            reactor._try_sync_one()
        assert sorted(reactor.pool.peers) == [PEER_A] and sorted(reactor.pool.blocks) == list(range(good + 1, 4))
    assert ch.errors == [] and host == [] and len(calls) == good + 1


# -- a threaded sync over two routers ------------------------------------------------------


def threaded(built, name, m, kw):
    chain = built[name]
    node = cs.state_node(m, chain.gen, mem_dbs(m), **kw)
    n, state, _ = cs.threaded_sync(m, chain.node, node, CHAIN_ID, timeout=120, **kw)
    return n, m.state_store.state_to_json(state), kv_bytes(node.dbs["blocks"])


def test_threaded_sync_over_two_routers(chains):
    """A server (block_sync=False over the source's stores) and a fresh node
    on two Routers over one MemoryNetwork, as tests/test_blocksync.py's
    BSNode builds them: on_caught_up with 15 blocks synced, the state and the
    block store equal in both packages and to the source's."""
    built, _ = chains
    n, doc, blocks = both(lambda name, m, kw: threaded(built, name, m, kw))
    assert n == HEIGHTS - 1 and doc == built["port"].chain[HEIGHTS - 1][4]
    synced = PORT.blockstore.BlockStore(copy_db(PORT, blocks))
    src = built["port"].node.blocks
    assert [synced.load_block(h).encode() for h in range(1, HEIGHTS)] == [
        src.load_block(h).encode() for h in range(1, HEIGHTS)]


def test_blocksync_metrics(chains):
    """The reactor's BlockSyncMetrics: one num_blocks a synced block, in both
    packages alike."""
    built, _ = chains

    def run(name, m, kw):
        node, reactor, _ = fresh_reactor(built, name, m, kw)
        reg = m.metrics.Registry()
        reactor.metrics = m.metrics.BlockSyncMetrics(reg)
        cs.serve(reactor, built[name].node.blocks.load_block, PEER_A, 1, 4)
        while reactor._try_sync_one():
            pass
        return reg.gather()

    assert "tendermint_blocksync_num_blocks 3" in both(run)


# -- the device branch -------------------------------------------------------------------


def test_device_branch_on_a_97_validator_chain(monkeypatch):
    """97 ed25519 validators of equal power: each light check tallies 65
    signatures, above the 64-signature device cutover, so the port
    (device="cpu") runs the cached bitmap's plain versions for it and for
    each validate_block (97 signatures), while the reference verifies on
    the host; the synced stores and states are equal."""
    monkeypatch.setattr(jed, "DEVICE_BATCH_CUTOVER", 10**9)  # the reference on its host path
    monkeypatch.setenv("TM_TPU_CRYPTO", "on")
    built = build("ed25519", n_vals=97, heights=4)
    assert len(cs.light_counted(built["port"].chain[1][0].validators)) == 65 >= ted.DEVICE_BATCH_CUTOVER

    def hits():
        return sum(v for _, lb, v in engine_metrics().kernel_launches.samples() if lb["kernel"] == "bitmap_cached")

    def run(name, m, kw):
        chain = built[name]
        node, reactor, ch = fresh_reactor(built, name, m, kw)
        cs.serve(reactor, chain.node.blocks.load_block, PEER_A, 1, 4)
        before = hits()
        steps = [reactor._try_sync_one() for _ in range(3)]
        return steps, hits() - before, kv_bytes(node.dbs["blocks"]), m.state_store.state_to_json(reactor.state)

    port, jax = (run(name, m, kw) for name, m, kw in SYNC)
    assert port[0] == jax[0] == [True] * 3
    # the light checks of 1, 2 and 3 and validate_block's of 2 and 3
    assert port[1] == 5 and jax[1] == 0
    assert port[2:] == jax[2:]
    assert port[3] == built["port"].chain[3][4]

