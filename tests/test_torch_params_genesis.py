"""The port's consensus params (types/params.py, the params protos of
proto/messages.py) and genesis document (types/genesis.py) against the JAX
package's: hash_consensus_params, the full proto image, validation with each
refusal's message, updates from ABCI ConsensusParamsUpdate bytes, the
genesis file's JSON and hash with ed25519, sr25519 and secp256k1
validators, each package reading the other's JSON, the genesis refusals,
and the RFC 3339 times the genesis file carries."""

import dataclasses

import numpy as np
import pytest

import chip_smoke as cs
from test_torch_light import members
from test_torch_state import JAX, PORT
from tendermint_tpu.proto import messages as jpb
from tendermint_tpu_torch.proto import messages as tpb

PACKAGES = (("port", PORT, tpb), ("jax", JAX, jpb))
SECOND = 10**9


def variants(m):
    """Consensus params of m's package: the defaults and one change in each
    section."""
    P = m.params
    d = P.ConsensusParams()
    return [
        d,
        dataclasses.replace(d, block=P.BlockParams(max_bytes=1 << 20, max_gas=5_000_000)),
        dataclasses.replace(d, evidence=P.EvidenceParams(max_age_num_blocks=7, max_age_duration=3 * SECOND,
                                                         max_bytes=512)),
        dataclasses.replace(d, validator=P.ValidatorParams(pub_key_types=("sr25519", "ed25519"))),
        dataclasses.replace(d, version=P.VersionParams(app_version=3)),
        dataclasses.replace(d, synchrony=P.SynchronyParams(precision=7, message_delay=11)),
        dataclasses.replace(d, timeout=P.TimeoutParams(propose=1, propose_delta=2, vote=3, vote_delta=4, commit=5,
                                                       bypass_commit_timeout=True)),
        dataclasses.replace(d, abci=P.ABCIParams(vote_extensions_enable_height=9, recheck_tx=False)),
    ]


def invalid(m):
    P = m.params
    d = P.ConsensusParams()
    e = d.evidence
    return [
        dataclasses.replace(d, block=P.BlockParams(max_bytes=0)),
        dataclasses.replace(d, block=P.BlockParams(max_bytes=P.MAX_BLOCK_SIZE_BYTES + 1)),
        dataclasses.replace(d, block=P.BlockParams(max_gas=-2)),
        dataclasses.replace(d, evidence=dataclasses.replace(e, max_age_num_blocks=0)),
        dataclasses.replace(d, evidence=dataclasses.replace(e, max_age_duration=0)),
        dataclasses.replace(d, evidence=dataclasses.replace(e, max_bytes=d.block.max_bytes + 1)),
        dataclasses.replace(d, evidence=dataclasses.replace(e, max_bytes=-1)),
        dataclasses.replace(d, synchrony=P.SynchronyParams(message_delay=0)),
        dataclasses.replace(d, synchrony=P.SynchronyParams(precision=0)),
        dataclasses.replace(d, validator=P.ValidatorParams(pub_key_types=())),
        dataclasses.replace(d, validator=P.ValidatorParams(pub_key_types=("bls12381",))),
    ]


def both(fn):
    outs = [fn(m, pb) for _, m, pb in PACKAGES]
    assert outs[0] == outs[1]
    return outs[0]


def test_params_hash_and_proto_match_reference():
    out = both(lambda m, pb: [(p.hash_consensus_params(), p.to_proto_update().encode(), m.genesis._params_to_json(p))
                              for p in variants(m)])
    assert len({h for h, _, _ in out}) == 2  # only the block section is hashed
    hp = tpb.HashedParams(block_max_bytes=22020096, block_max_gas=-1).encode()
    assert hp == JAX.params.HashedParams(block_max_bytes=22020096, block_max_gas=-1).encode()


def test_validate_consensus_params_refusals_match_reference():
    out = both(lambda m, pb: [cs.outcome(p.validate_consensus_params) for p in variants(m) + invalid(m)])
    assert all(o == ("accepted", "") for o in out[:8])
    assert all(o[0] == "ValueError" for o in out[8:])


def updates(pb):
    """ConsensusParamsUpdate protos of pb's package, sections partly set."""
    D = pb.Duration.from_ns
    return [
        None,
        pb.ConsensusParamsUpdate(),
        pb.ConsensusParamsUpdate(block=pb.BlockParamsProto(max_bytes=4096, max_gas=10)),
        pb.ConsensusParamsUpdate(evidence=pb.EvidenceParamsProto(max_age_num_blocks=3, max_bytes=100),
                                 version=pb.VersionParamsProto(app_version=2)),
        pb.ConsensusParamsUpdate(evidence=pb.EvidenceParamsProto(max_age_num_blocks=3,
                                                                 max_age_duration=D(5 * SECOND + 7))),
        pb.ConsensusParamsUpdate(validator=pb.ValidatorParamsProto(pub_key_types=["secp256k1"]),
                                 synchrony=pb.SynchronyParamsProto(precision=D(9))),
        pb.ConsensusParamsUpdate(timeout=pb.TimeoutParamsProto(vote=D(2 * SECOND), bypass_commit_timeout=True),
                                 abci=pb.ABCIParamsProto(vote_extensions_enable_height=4)),
    ]


def test_update_consensus_params_matches_reference():
    """The reference's update protos, carried across as bytes, give the same
    params in both packages."""
    def run(m, pb):
        out = []
        for u, ju in zip(updates(pb), updates(jpb)):
            if u is not None:
                assert u.encode() == ju.encode()
                u = pb.ConsensusParamsUpdate.decode(ju.encode())
            p = m.params.default_consensus_params().update_consensus_params(u)
            out.append((m.genesis._params_to_json(p), cs.outcome(p.validate_consensus_params)))
        return out

    out = both(run)
    assert out[0] == out[1]  # None and an empty update change nothing


KINDS = {"ed25519": ["ed25519"] * 4, "sr25519": ["sr25519"] * 4, "secp256k1": ["secp256k1"] * 4,
         "mixed": ["ed25519", "sr25519", "secp256k1", "ed25519"]}


def genesis_members(kinds):
    rng = np.random.default_rng(len(kinds) + sum(len(k) for k in kinds))
    return [members(kind, 1, rng)[0] for kind in kinds]


def make_genesis(m, fresh, chain_id="genesis-test-chain", **extra):
    return m.genesis.GenesisDoc(
        chain_id=chain_id, genesis_time=m.tmtime.Time(1_700_000_000, 123_456_789),
        consensus_params=m.params.ConsensusParams(validator=m.params.ValidatorParams(
            pub_key_types=tuple(sorted({k for k, _, _ in fresh})))),
        validators=[m.genesis.GenesisValidator(address=m.keys[k](pub).address(), pub_key=m.keys[k](pub),
                                               power=10 + i, name=f"val-{i}")
                    for i, (k, pub, _) in enumerate(fresh)],
        app_hash=b"\x01\x02", **extra)


@pytest.mark.parametrize("kinds", sorted(KINDS))
def test_genesis_json_and_hash_match_reference(kinds):
    fresh = genesis_members(KINDS[kinds])

    def run(m, pb):
        doc = make_genesis(m, fresh, app_state=b'{"accounts": [1, 2]}')
        doc.validate_and_complete()
        state = m.state.make_genesis_state(doc)
        return doc.to_json(), doc.hash(), state.validators.hash(), m.state_store.state_to_json(state)

    text, digest, vals_hash, doc = both(run)
    # each package reads the other's file
    for m in (PORT, JAX):
        read = m.genesis.GenesisDoc.from_json(text)
        assert read.to_json() == text and read.hash() == digest
        assert [v.pub_key.type_name for v in read.validators] == KINDS[kinds]
        assert m.state.make_genesis_state(read).validators.hash() == vals_hash


def test_genesis_refusals_match_reference():
    fresh = genesis_members(KINDS["mixed"])

    def run(m, pb):
        out = []
        for change in ({"chain_id": ""}, {"chain_id": "x" * 51}, {"initial_height": -1}):
            doc = dataclasses.replace(make_genesis(m, fresh), **change)
            out.append(cs.outcome(doc.validate_and_complete))
        doc = make_genesis(m, fresh)
        doc.validators[1].power = 0
        out.append(cs.outcome(doc.validate_and_complete)[0])
        doc = make_genesis(m, fresh)
        doc.validators[2].address = b"\x07" * 20
        out.append(cs.outcome(doc.validate_and_complete))
        text = make_genesis(m, fresh).to_json().replace("tendermint/PubKeySr25519", "tendermint/PubKeyBLS")
        out.append(cs.outcome(lambda: m.genesis.GenesisDoc.from_json(text)))
        doc = make_genesis(m, fresh, initial_height=0)
        doc.consensus_params = None
        doc.validators[0].address = b""
        doc.validate_and_complete()
        out.append((doc.initial_height, doc.consensus_params.hash_consensus_params(),
                    doc.validators[0].address == doc.validators[0].pub_key.address()))
        return out

    out = both(run)
    assert out[-1][0] == 1 and out[-1][2]


@pytest.mark.parametrize("text", [
    "2023-11-14T22:13:20Z", "2023-11-14T22:13:20.123456789Z", "2023-11-14T22:13:20.5+02:00",
    "1-01-01T00:00:00Z", "0001-01-01T00:00:00Z", "1970-01-01T00:00:00.000000001Z"])
def test_parse_rfc3339_matches_reference(text):
    seconds, nanos = both(lambda m, pb: (lambda t: (t.seconds, t.nanos))(m.tmtime.Time.parse_rfc3339(text)))
    t = PORT.tmtime.Time(seconds, nanos)
    assert PORT.tmtime.Time.parse_rfc3339(t.rfc3339()) == t
