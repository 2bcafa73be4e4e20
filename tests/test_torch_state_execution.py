"""The port's BlockExecutor (state/execution.py) over its kvstore app
(abci/kvstore.py) through LocalClient (abci/client.py) against the JAX
package's, on test_torch_state's chains (chip_smoke.state_chain at 6
validators and 16 heights on each plane): at every height the app hash,
state_to_json, the tx results hash and the validator updates taking effect
at H + 2 (a joiner by a val: transaction, a double signer's power cut by
one) are equal; a tampered LastCommit is refused with the reference's error;
a 64-validator ed25519 chain applied with device="cpu" takes the port's
device branch (the plain versions of the cached bitmap) and still equals
the reference's; and each package carries on from FileDB stores that the
other wrote. The app's kv transactions, queries, validator transactions
and its refusal of a snapshot interval are held to the reference too."""

import base64

import numpy as np
import pytest
import torch

import chip_smoke as cs
from test_torch_light import Signer, members
from test_torch_state import CHAIN_ID, HEIGHTS, JAX, PACKAGES, PORT, build
from tendermint_tpu.crypto import ed25519 as jed
from tendermint_tpu_torch.crypto import ed25519 as ted
from tendermint_tpu_torch.metrics import engine_metrics

torch.set_num_threads(1)

N_BAD = 2  # the tampered LastCommit signature
N_VALS_FILE = 5


@pytest.fixture(scope="module", params=cs.PLANES)
def chains(request):
    return build(request.param), request.param


def test_chain_matches_reference(chains):
    built, plane = chains
    port, jax = built["port"], built["jax"]
    for h in range(1, HEIGHTS + 1):
        before, block, block_id, app_hash, doc, results_hash = port.chain[h]
        jbefore, jblock, jblock_id, japp_hash, jdoc, jresults_hash = jax.chain[h]
        assert (block.encode(), block_id.hash, app_hash, doc, results_hash) == (
            jblock.encode(), jblock_id.hash, japp_hash, jdoc, jresults_hash), h
        assert PORT.state_store.state_to_json(before) == JAX.state_store.state_to_json(jbefore)
    # the joiner's val: transaction at 5 and the double signer's punishment
    # at 9 take effect at H + 2
    joiner = cs.member_secrets(PORT, [built["joiner"]])
    (address,) = joiner
    sets = {h: port.chain[h][0].validators for h in port.chain}
    assert not sets[cs.STATE_JOIN_AT + 1].has_address(address)
    assert sets[cs.STATE_JOIN_AT + 2].has_address(address)
    signer = sets[cs.STATE_DOUBLE_SIGN_AT].validators[0]
    powers = [sets[h].get_by_address(signer.address)[1].voting_power
              for h in (cs.STATE_DOUBLE_SIGN_AT + 2, cs.STATE_DOUBLE_SIGN_AT + 3)]
    assert powers == [10, 9]
    ev = port.chain[cs.STATE_DOUBLE_SIGN_AT + 1][1].evidence
    assert [type(e).__name__ for e in ev] == ["DuplicateVoteEvidence"]
    assert ev[0].to_proto().encode() == jax.chain[cs.STATE_DOUBLE_SIGN_AT + 1][1].evidence[0].to_proto().encode()
    infos = [n.node.client.info(m.abci_types.RequestInfo()) for n, m in ((port, PORT), (jax, JAX))]
    assert repr(infos[0]) == repr(infos[1])
    assert infos[0].last_block_height == HEIGHTS
    join_tx = port.chain[cs.STATE_JOIN_AT][1].txs[-1]
    assert join_tx.startswith(b"val:" + (b"" if plane == "ed25519" else b"sr25519:"))


def test_bad_last_commit_rejected_like_reference(chains):
    built, _ = chains
    outs = []
    idx = N_BAD
    for name, m, kw in PACKAGES:
        state, block = built[name].chain[cs.STATE_REJECT_AT][:2]
        node = built[name].node
        bad = cs.tampered_block(m, block, idx)
        outs.append(cs.outcome(lambda: node.executor.validate_block(state, bad)))
        # a signature of another height's commit: a valid signature, the wrong message
        swapped = cs.tampered_block(m, block, idx)
        swapped.last_commit.signatures[idx].signature = built[name].chain[3][1].last_commit.signatures[idx].signature
        swapped.header.last_commit_hash = swapped.last_commit.hash()
        outs.append(cs.outcome(lambda: node.executor.validate_block(state, swapped)))
        short = cs.tampered_block(m, block, idx)
        short.last_commit.signatures = short.last_commit.signatures[:-1]
        short.header.last_commit_hash = short.last_commit.hash()
        outs.append(cs.outcome(lambda: node.executor.validate_block(state, short)))
    assert outs[:3] == outs[3:]
    assert outs[0][0] == "ValueError" and outs[0][1].startswith(f"wrong signature (#{idx}):")
    assert outs[1][1].startswith(f"wrong signature (#{idx}):")


def test_device_branch_on_a_64_validator_chain(monkeypatch):
    """64 ed25519 validators: each LastCommit check batches 64 signatures,
    the device cutover, so the port (device="cpu") runs the cached bitmap's
    plain versions (a fill on the first sight of the keys, then hits),
    while the reference verifies on the host; the chains are equal."""
    monkeypatch.setattr(jed, "DEVICE_BATCH_CUTOVER", 10**9)  # the reference on its host path
    monkeypatch.setenv("TM_TPU_CRYPTO", "on")
    hits = lambda: sum(v for _, lb, v in engine_metrics().kernel_launches.samples()  # noqa: E731
                       if lb["kernel"] == "bitmap_cached")
    before = hits()
    built = build("ed25519", n_vals=64, heights=4)
    assert hits() - before == 3  # heights 2, 3 and 4
    for h in range(1, 5):
        assert built["port"].chain[h][3:] == built["jax"].chain[h][3:], h
        assert built["port"].chain[h][1].encode() == built["jax"].chain[h][1].encode()


def replay_more(m, node, chain, secrets, sign, heights):
    """Apply `heights` more blocks on node (over its reopened stores),
    proposing each with the last seen commit; returns each height's app hash
    and state_to_json."""
    state = node.states.load()
    last_commit = node.blocks.load_seen_commit(state.last_block_height)
    out = []
    for h in range(state.last_block_height + 1, state.last_block_height + 1 + heights):
        node.mempool.txs = [b"more-%d=%d" % (h, h)]
        block = node.executor.create_proposal_block(h, state, last_commit, state.validators.get_proposer().address,
                                                    block_time=m.tmtime.Time(cs.STATE_T0 + cs.STATE_DT * h, 5))
        parts = block.make_part_set(m.block.BLOCK_PART_SIZE_BYTES)
        block_id = m.block.BlockID(block.hash(), parts.header)
        seen = cs.signed_commit(m, state.validators, secrets, sign, CHAIN_ID, h, block_id,
                                cs.STATE_T0 + cs.STATE_DT * h)
        node.blocks.save_block(block, parts, seen)
        state = node.executor.apply_block(state, block_id, block)
        out.append((state.app_hash, m.state_store.state_to_json(state)))
        last_commit = seen
    return out


def test_filedb_round_trip_both_directions(tmp_path):
    """Each package writes a chain over FileDBs; the other reopens them (the
    same state, block store, pool and app) and carries on for two more
    heights, where both directions agree."""
    rng = np.random.default_rng(99)
    fresh = members("ed25519", N_VALS_FILE + 1, rng)
    sign = Signer()
    results = {}
    for (writer, wm, wkw), (reader, rm, rkw) in ((PACKAGES[0], PACKAGES[1]), (PACKAGES[1], PACKAGES[0])):
        where = str(tmp_path / writer)
        src = cs.state_chain(wm, fresh[:-1], fresh[-1], sign, CHAIN_ID, cs.file_dbs(wm, where), heights=10, **wkw)
        for db in src.node.dbs.values():
            db.close()
        gen = rm.genesis.GenesisDoc.from_json(src.gen.to_json())
        node = cs.state_node(rm, gen, cs.file_dbs(rm, where), **rkw)
        assert rm.state_store.state_to_json(node.state) == wm.state_store.state_to_json(src.node.state)
        assert (node.blocks.base(), node.blocks.height()) == (1, 10)
        assert node.blocks.load_block(10).encode() == src.chain[10][1].encode()
        assert node.pool.size() == 0
        info = node.client.info(rm.abci_types.RequestInfo())
        assert (info.last_block_height, info.last_block_app_hash) == (10, src.node.state.app_hash)
        results[reader] = replay_more(rm, node, src.chain, src.secrets, sign, 2)
        for db in node.dbs.values():
            db.close()
    assert results["port"] == results["jax"]



def test_kvstore_app_matches_reference():
    """The app alone: kv and raw transactions, validator transactions of
    each key type (adding, changing, removing, refused), queries, Info, and
    a duplicate vote's punishment; with a snapshot interval, the same
    snapshot and chunks (the port refused the interval until state sync
    came)."""
    outs = []
    pub = bytes(range(32))
    for name, m, _ in PACKAGES:
        A = m.abci_types
        app = m.kvstore.KVStoreApplication()
        out = [repr(app.init_chain(A.RequestInitChain(validators=[
            A.ValidatorUpdate(pub_key_type="ed25519", pub_key_bytes=pub, power=10)])))]
        txs = [b"a=1", b"raw", b"val:" + base64.b64encode(bytes(32)) + b"!5",
               b"val:sr25519:" + base64.b64encode(bytes([7]) * 32) + b"!3", b"val:bogus:AAAA!1",
               b"val:" + base64.b64encode(bytes([9]) * 32) + b"!0", b"val:!!", b"val:AAAA!x", b"val:***!1"]
        address = PORT.keys["ed25519"](pub).address()
        res = app.finalize_block(A.RequestFinalizeBlock(txs=txs, height=1, misbehavior=[A.Misbehavior(
            type=A.MISBEHAVIOR_DUPLICATE_VOTE, validator=A.Validator(address=address, power=10))]))
        out += [repr(res), repr(app.info(A.RequestInfo())), repr(app.commit())]
        out += [repr(app.query(A.RequestQuery(data=d, path=p))) for d, p in
                ((b"a", ""), (b"raw", ""), (b"none", ""), (pub, "/val"))]
        out += [repr(app.validators()), repr(app.info(A.RequestInfo()))]
        accepted = cs.outcome(lambda: m.kvstore.KVStoreApplication(snapshot_interval=2))
        assert accepted == ("accepted", ""), (name, accepted)
        snapper = m.kvstore.KVStoreApplication(snapshot_interval=1)
        snapper.finalize_block(A.RequestFinalizeBlock(txs=txs[:2], height=1))
        snapper.commit()
        snaps = snapper.list_snapshots(A.RequestListSnapshots()).snapshots
        out += [repr(snaps)] + [repr(snapper.load_snapshot_chunk(A.RequestLoadSnapshotChunk(
            height=1, format=1, chunk=i))) for i in range(snaps[0].chunks)]
        outs.append(out)
    assert outs[0] == outs[1]


def test_default_device_without_cuda_raises(monkeypatch):
    """validate_block and BlockExecutor run their commit checks on the card
    unless told device="cpu": without CUDA the default raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("TM_TPU_CRYPTO", "auto")
    monkeypatch.setattr(ted, "DEVICE_BATCH_CUTOVER", 4)
    built = build("ed25519")["port"]
    state, block = built.chain[3][:2]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PORT.state_validation.validate_block(state, block)
    executor = PORT.execution.BlockExecutor(built.node.states, built.node.client)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        executor.validate_block(state, block)
    PORT.state_validation.validate_block(state, block, device="cpu")
    PORT.execution.BlockExecutor(built.node.states, built.node.client, device="cpu").validate_block(state, block)
