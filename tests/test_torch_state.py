"""The port's state layer (state/state.py, state/store.py,
state/validation.py, store/blockstore.py) against the JAX package's, on the
same seeded chain: chip_smoke.state_chain at 6 validators and 16 heights on
each plane (a validator joining by a val: transaction at height 5, a double
sign at 8 whose evidence block 9 carries and the app punishes), built by
BlockExecutor over the kvstore app in both packages from one memoizing
signer, the port on device="cpu". make_genesis_state, every state_to_json,
and the state store's and block store's key-value bytes (the sparse
validator checkpoints, the consensus params, the FinalizeBlock responses,
block metas, parts, commits and seen commits) are equal; so are the loads,
prune_states and prune_blocks, extended commits, and every altered header's
error class and message (tests/test_state_execution.py:172's cases, on
states built by apply_block)."""

import copy
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import chip_smoke as cs
from test_torch_light import Signer, members
from test_torch_light_client import JAX as JAX_CLIENT
from tendermint_tpu import abci as jabci
from tendermint_tpu import state as jstate
from tendermint_tpu.abci import kvstore as jkvstore
from tendermint_tpu.abci import types as jabci_types
from tendermint_tpu.evidence import pool as jpool
from tendermint_tpu.proto import messages as jpb
from tendermint_tpu.state import execution as jexecution
from tendermint_tpu.state import state as jstate_
from tendermint_tpu.state import store as jstore
from tendermint_tpu.state import validation as jvalidation
from tendermint_tpu.store import blockstore as jblockstore
from tendermint_tpu.types import genesis as jgenesis
from tendermint_tpu.types import params as jparams
from tendermint_tpu.types import part_set as jpart_set
from tendermint_tpu.utils import bits as jbits
from tendermint_tpu_torch.proto import messages as tpb

torch.set_num_threads(1)

CHAIN_ID = "state-test-chain"
N_VALS = 6
HEIGHTS = cs.STATE_HEIGHTS

PORT = cs.state_modules()
JAX = SimpleNamespace(**vars(JAX_CLIENT), abci=jabci, abci_types=jabci_types, kvstore=jkvstore, state=jstate,
                      state_=jstate_, state_store=jstore, state_validation=jvalidation, execution=jexecution,
                      pool=jpool, blockstore=jblockstore, genesis=jgenesis, params=jparams, part_set=jpart_set,
                      bits=jbits)
PACKAGES = (("port", PORT, {"device": "cpu"}), ("jax", JAX, {}))


def mem_dbs(m):
    return {name: m.kv.MemDB() for name in ("app", "state", "blocks", "evidence")}


_BUILT = {}


def build(plane, n_vals=N_VALS, heights=HEIGHTS):
    """{"port": chain, "jax": chain, "members", "joiner", "sign"}: the state
    chain of chip_smoke.state_chain built by both packages over MemDBs, the
    port's on device="cpu"; built once."""
    key = (plane, n_vals, heights)
    if key not in _BUILT:
        rng = np.random.default_rng(97 if plane == "ed25519" else 98)
        fresh = members(plane, n_vals + 1, rng)
        sign = Signer()
        out = {name: cs.state_chain(m, fresh[:-1], fresh[-1], sign, CHAIN_ID, mem_dbs(m), heights=heights, **kw)
               for name, m, kw in PACKAGES}
        out.update(members=fresh[:-1], joiner=fresh[-1], sign=sign)
        _BUILT[key] = out
    return _BUILT[key]


@pytest.fixture(scope="module", params=cs.PLANES)
def chains(request):
    return build(request.param), request.param


def kv_bytes(db):
    return list(db.iterator())


def copy_db(m, db):
    out = m.kv.MemDB()
    for k, v in db.iterator():
        out.set(k, v)
    return out


def test_genesis_state_matches_reference(chains):
    built, _ = chains
    docs, dbs = [], []
    for name, m, _ in PACKAGES:
        gen = built[name].gen
        state = m.state.make_genesis_state(gen)
        docs.append(m.state_store.state_to_json(state))
        db = m.kv.MemDB()
        store = m.state.StateStore(db)
        store.save(state)
        dbs.append(kv_bytes(db))
        assert m.state_store.state_to_json(store.load()) == docs[-1]
        assert store.load_validators(1).hash() == state.validators.hash()
        assert store.load_validators(2).hash() == state.next_validators.hash()
    assert docs[0] == docs[1]
    assert dbs[0] == dbs[1]
    assert docs[0]["last_height_validators_changed"] == 1 and docs[0]["app_hash"] == ""


def test_state_update_and_store_bytes_match_reference(chains):
    """Every height's state_to_json, the state store's bytes (sparse
    validator checkpoints: a full set only at genesis and where it changed),
    its loads, and prune_states on copies."""
    built, _ = chains
    port, jax = built["port"], built["jax"]
    for h in range(1, HEIGHTS + 1):
        assert port.chain[h][4] == jax.chain[h][4], h
        assert port.chain[h][3] == jax.chain[h][3], h
    assert kv_bytes(port.node.dbs["state"]) == kv_bytes(jax.node.dbs["state"])
    full = [int.from_bytes(k[len(b"validatorsKey:"):], "big") for k, v in kv_bytes(port.node.dbs["state"])
            if k.startswith(b"validatorsKey:") and b"validator_set" in v]
    assert full == [1, cs.STATE_JOIN_AT + 2, cs.STATE_DOUBLE_SIGN_AT + 3]
    for h in range(1, HEIGHTS + 2):
        sets = [n.node.states.load_validators(h) for n in (port, jax)]
        assert sets[0].to_proto().encode() == sets[1].to_proto().encode(), h
        params = [n.node.states.load_consensus_params(h) for n in (port, jax)]
        assert params[0].hash_consensus_params() == params[1].hash_consensus_params()
    for h in range(1, HEIGHTS + 1):
        resp = [n.node.states.load_finalize_block_responses(h) for n in (port, jax)]
        assert repr(resp[0]) == repr(resp[1]), h
    for retain in (3, cs.STATE_JOIN_AT + 3, HEIGHTS):
        outs = []
        for name, m, _ in PACKAGES:
            db = copy_db(m, built[name].node.dbs["state"])
            store = m.state.StateStore(db)
            pruned = store.prune_states(retain)
            outs.append((pruned, kv_bytes(db), store.load_validators(HEIGHTS).to_proto().encode(),
                         store.load_validators(retain).to_proto().encode()))
        assert outs[0] == outs[1], retain
    for name, m, _ in PACKAGES:
        with pytest.raises(ValueError, match="must be greater than 0"):
            m.state.StateStore(m.kv.MemDB()).prune_states(0)


def test_state_json_round_trip(chains):
    built, _ = chains
    for name, m, _ in PACKAGES:
        state = built[name].node.state
        doc = m.state_store.state_to_json(state)
        assert m.state_store.state_to_json(m.state_store.state_from_json(doc)) == doc
    port_doc = PORT.state_store.state_to_json(built["port"].node.state)
    assert JAX.state_store.state_to_json(JAX.state_store.state_from_json(port_doc)) == port_doc


def test_block_store_bytes_match_reference(chains):
    built, _ = chains
    port, jax = built["port"], built["jax"]
    assert kv_bytes(port.node.dbs["blocks"]) == kv_bytes(jax.node.dbs["blocks"])
    for h in range(1, HEIGHTS + 1):
        blocks = [n.node.blocks.load_block(h) for n in (port, jax)]
        assert blocks[0].encode() == blocks[1].encode() == jax.chain[h][1].encode()
        assert blocks[0].hash() == port.chain[h][2].hash
        metas = [n.node.blocks.load_block_meta(h).to_proto().encode() for n in (port, jax)]
        assert metas[0] == metas[1]
        for load in ("load_block_commit", "load_seen_commit"):
            commits = [getattr(n.node.blocks, load)(h) for n in (port, jax)]
            encoded = [c and c.to_proto().encode() for c in commits]
            assert encoded[0] == encoded[1], (load, h)
        parts = [n.node.blocks.load_block_part(h, 0).to_proto().encode() for n in (port, jax)]
        assert parts[0] == parts[1]
        by_hash = port.node.blocks.load_block_by_hash(port.chain[h][2].hash)
        assert by_hash.encode() == blocks[0].encode()
    assert port.node.blocks.load_block_commit(HEIGHTS) is None
    assert (port.node.blocks.base(), port.node.blocks.height(), port.node.blocks.size()) == (1, HEIGHTS, HEIGHTS)


def extended_commit(pb, commit, tag):
    """An ExtendedCommit of pb's package: the commit's signatures, each with
    a made-up vote extension."""
    return pb.ExtendedCommit(
        height=commit.height, round=commit.round, block_id=commit.block_id.to_proto(),
        extended_signatures=[pb.ExtendedCommitSig(
            block_id_flag=cs_.block_id_flag, validator_address=cs_.validator_address,
            timestamp=pb.Timestamp(seconds=cs_.timestamp.seconds, nanos=cs_.timestamp.nanos),
            signature=cs_.signature, extension=tag + bytes([i]), extension_signature=b"x" * 64)
            for i, cs_ in enumerate(commit.signatures)])


def test_block_store_extended_commits_and_pruning(chains):
    """save_block with extended commits in the same batch, their loads, the
    contiguity refusals, and prune_blocks, in both packages over fresh
    stores: equal bytes throughout."""
    built, _ = chains
    outs = []
    for name, m, _ in PACKAGES:
        src = built[name].node.blocks
        db = m.kv.MemDB()
        store = m.blockstore.BlockStore(db)
        pb = tpb if name == "port" else jpb
        for h in range(1, 7):
            block = src.load_block(h)
            seen = src.load_seen_commit(h)
            store.save_block(block, block.make_part_set(m.block.BLOCK_PART_SIZE_BYTES), seen,
                             extended_commit=extended_commit(pb, seen, b"ext-%d" % h) if h % 2 else None)
        errors = [cs.outcome(lambda: store.save_block(src.load_block(8), src.load_block(8).make_part_set(65536),
                                                      src.load_seen_commit(8)))]
        incomplete = m.part_set.PartSet(src.load_block(7).make_part_set(64).header)
        errors.append(cs.outcome(lambda: store.save_block(src.load_block(7), incomplete, src.load_seen_commit(7))))
        errors.append(cs.outcome(lambda: store.save_block(None, incomplete, src.load_seen_commit(7))))
        ext = [store.load_extended_commit(h) for h in range(1, 7)]
        ext_bytes = [None if e is None else [v and v.to_proto().encode() for v in e] for e in ext]
        snapshot = kv_bytes(db)
        pruned = store.prune_blocks(4)
        prune_errors = [cs.outcome(lambda: store.prune_blocks(0)), cs.outcome(lambda: store.prune_blocks(99)),
                        store.prune_blocks(2)]
        reopened = m.blockstore.BlockStore(db)
        outs.append((snapshot, ext_bytes, errors, pruned, prune_errors, kv_bytes(db),
                     (reopened.base(), reopened.height()), store.load_block(3), store.load_block(4).encode()))
    assert outs[0] == outs[1]
    assert outs[0][3] == 3 and outs[0][6] == (4, 6) and outs[0][7] is None
    assert [e is None for e in outs[0][1]] == [False, True, False, True, False, True]


def mutation_outcomes(m, kw, state, block):
    return {field: cs.outcome(lambda: m.state_validation.validate_block(
        state, cs.mutated_block(block, field, value), **kw)) for field, value in cs.header_mutations(
        m, state, block.header.height).items()}


@pytest.mark.parametrize("height", [1, cs.STATE_REJECT_AT])
def test_mutated_headers_rejected_like_reference(chains, height):
    """tests/test_state_execution.py:172's sweep on states built by
    apply_block: each altered field raises the reference's class and
    message, which starts as chip_smoke.HEADER_MUTATIONS says; the
    unaltered block passes."""
    built, _ = chains
    outs = []
    for name, m, kw in PACKAGES:
        state, block = built[name].chain[height][:2]
        m.state_validation.validate_block(state, copy.deepcopy(block), **kw)
        outs.append(mutation_outcomes(m, kw, state, block))
    assert outs[0] == outs[1]
    for field, (cls, fragment) in cs.HEADER_MUTATIONS.items():
        assert outs[0][field][0] == cls and fragment in outs[0][field][1], (field, outs[0][field])
    assert set(outs[0]) == set(cs.HEADER_MUTATIONS)
