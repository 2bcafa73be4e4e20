"""The port's Block (types/block.py), PartSet (types/part_set.py) and
BitArray (utils/bits.py) against the JAX package's: every block of
test_torch_state's chains (kv and validator transactions, duplicate-vote
evidence at height 9) and a block carrying both kinds of evidence hash and
encode alike and decode across packages; validate_basic refuses the same
blocks with the same messages; make_part_set gives the same header, parts
and merkle proofs at several part sizes, parts rebuild the block through
add_part and refuse a bad proof alike; BitArray's operations agree."""

import copy
import random

import pytest

import chip_smoke as cs
from test_torch_evidence import attack_evidence
from test_torch_state import HEIGHTS, JAX, PACKAGES, PORT, build

PART_SIZES = (64, 257, 4096, 65536)


@pytest.fixture(scope="module", params=cs.PLANES)
def chains(request):
    return build(request.param)


def test_chain_blocks_hash_and_encode_like_reference(chains):
    for h in range(1, HEIGHTS + 1):
        port, jax = chains["port"].chain[h][1], chains["jax"].chain[h][1]
        assert port.hash() == jax.hash() and port.encode() == jax.encode(), h
        assert PORT.block.Block.decode(jax.encode()).encode() == jax.encode()
        assert JAX.block.Block.decode(port.encode()).hash() == port.hash()
        assert port.hashes_to(jax.hash()) and not port.hashes_to(b"")
    evidenced = chains["port"].chain[cs.STATE_DOUBLE_SIGN_AT + 1][1]
    assert len(evidenced.evidence) == 1 and evidenced.header.evidence_hash == PORT.block.evidence_list_hash(
        evidenced.evidence)


def attack_block(name, m):
    """Block 9 of m's package's state chain with two more txs and the
    light-client tests' lunatic and equivocation evidence beside its
    duplicate vote."""
    block = copy.deepcopy(build("ed25519")[name].chain[cs.STATE_DOUBLE_SIGN_AT + 1][1])
    block.evidence = block.evidence + [attack_evidence("lunatic")[name], attack_evidence("equivocation")[name]]
    block.txs = block.txs + [b"x" * 300, b""]
    block.header.data_hash = b""
    block.header.evidence_hash = b""
    block.fill_header()
    return block


def test_block_with_every_evidence_kind_matches_reference():
    blocks = {name: attack_block(name, m) for name, m, _ in PACKAGES}
    assert blocks["port"].encode() == blocks["jax"].encode()
    assert blocks["port"].hash() == blocks["jax"].hash()
    assert [e.hash() for e in PORT.block.Block.decode(blocks["jax"].encode()).evidence] == [
        e.hash() for e in blocks["jax"].evidence]
    assert PORT.block.evidence_list_hash([]) == JAX.block.evidence_list_hash([])


def broken(m, block):
    """Copies of block that Block.validate_basic refuses."""
    out = []
    for field in ("last_commit_hash", "data_hash", "evidence_hash"):
        b = copy.deepcopy(block)
        setattr(b.header, field, b"\x09" * 32)
        out.append(b)
    b = copy.deepcopy(block)
    b.last_commit = None
    out.append(b)
    b = copy.deepcopy(block)
    b.header.chain_id = "c" * 51
    out.append(b)
    b = copy.deepcopy(block)
    b.last_commit.signatures[0].signature = b""
    b.header.last_commit_hash = b.last_commit.hash()
    out.append(b)
    return out


def test_validate_basic_refusals_match_reference(chains):
    outs = []
    for name, m, _ in PACKAGES:
        block = chains[name].chain[cs.STATE_REJECT_AT][1]
        block.validate_basic()
        outs.append([cs.outcome(b.validate_basic) for b in broken(m, block)])
    assert outs[0] == outs[1]
    assert all(o[0] == "ValueError" for o in outs[0])


@pytest.mark.parametrize("part_size", PART_SIZES)
def test_part_sets_match_reference(chains, part_size):
    h = cs.STATE_DOUBLE_SIGN_AT + 1
    sets = {name: chains[name].chain[h][1].make_part_set(part_size) for name, _, _ in PACKAGES}
    port, jax = sets["port"], sets["jax"]
    assert port.header.to_proto().encode() == jax.header.to_proto().encode()
    assert port.total() == jax.total() == -(-port.byte_size // part_size)
    for i in range(port.total()):
        assert port.get_part(i).to_proto().encode() == jax.get_part(i).to_proto().encode(), i
    # the parts, read back, rebuild the block in the other package
    for m, src in ((PORT, jax), (JAX, port)):
        rebuilt = m.part_set.PartSet(src.header)
        for i in reversed(range(src.total())):
            proto = src.get_part(i).to_proto()
            part = m.part_set.Part.from_proto(type(proto).decode(proto.encode()))
            assert rebuilt.add_part(part) and not rebuilt.add_part(part)
        assert rebuilt.is_complete() and rebuilt.get_data() == src.get_data()
        assert m.block.Block.decode(rebuilt.get_data()).hash() == chains["port"].chain[h][2].hash
        assert str(rebuilt.bit_array()) == "x" * src.total()
    # refusals alike
    outs = []
    for m, src in ((PORT, port), (JAX, jax)):
        fresh = m.part_set.PartSet(src.header)
        bad = copy.deepcopy(src.get_part(0))
        bad.bytes_ = bad.bytes_[:-1] + bytes([bad.bytes_[-1] ^ 1])
        far = copy.deepcopy(src.get_part(0))
        far.index = src.total()
        outs.append([cs.outcome(lambda: fresh.add_part(bad)), cs.outcome(lambda: fresh.add_part(far)),
                     cs.outcome(fresh.get_data), str(fresh.bit_array()), fresh.has_part(0), fresh.get_part(-1),
                     cs.outcome(lambda: src.get_part(0).validate_basic(part_size - 1))])
    assert outs[0] == outs[1]


def test_empty_data_is_one_part():
    sets = [m.part_set.PartSet.from_data(b"", 64) for m in (PORT, JAX)]
    assert [s.total() for s in sets] == [1, 1]
    assert sets[0].header.hash == sets[1].header.hash


def bit_ops(m, rng_seed):
    B = m.bits.BitArray
    rng = random.Random(rng_seed)
    a, b = B(37), B(21)
    for i in rng.sample(range(37), 15):
        a.set_index(i, True)
    for i in rng.sample(range(21), 9):
        b.set_index(i, True)
    a.set_index(3, False)
    c = a.copy()
    c.update(b)
    full = B(9)
    for i in range(9):
        full.set_index(i, True)
    return [str(a), str(b), str(a.or_(b)), str(a.and_(b)), str(a.not_()), str(a.sub(b)), a.to_bytes(),
            str(B.from_bytes(13, a.to_bytes())), a.true_indices(), a.is_empty(), B(5).is_empty(), full.is_full(),
            a.is_full(), a.get_index(-1), a.get_index(99), a.set_index(99, True), a.pick_random(random.Random(5)),
            B(4).pick_random(), str(c), c == b, a == a.copy(), a.size(), cs.outcome(lambda: B(-1))]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_bit_array_matches_reference(seed):
    assert bit_ops(PORT, seed) == bit_ops(JAX, seed)
