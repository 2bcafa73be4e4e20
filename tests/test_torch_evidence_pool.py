"""The port's evidence pool (evidence/pool.py) and evidence_to_abci
(types/evidence.py) against the JAX package's, over the stores of
test_torch_state's ed25519 chain (6 validators, 16 heights, built by
apply_block in both packages), mirroring tests/test_evidence.py:122-194:
the add, check and update lifecycle, conflicting votes reported by
consensus materializing at update, persistence across a restart,
pending_evidence's byte budget and the pruning of expired evidence. Each
step's outcome (error class and message), the pool's size and its
key-value bytes are equal; the port runs with device="cpu"."""

import copy
import dataclasses

import pytest
import torch

import chip_smoke as cs
from test_torch_evidence import attack_evidence
from test_torch_state import CHAIN_ID, HEIGHTS, PACKAGES, build

torch.set_num_threads(1)


def pool_env(name, m, kw):
    """A fresh pool over the chain's state and block stores, and the chain."""
    built = build("ed25519")[name]
    return m.pool.EvidencePool(m.kv.MemDB(), built.node.states, built.node.blocks, **kw), built


def duplicate_vote(m, built, height, val_index=0, tags=(b"a", b"b")):
    """DuplicateVoteEvidence of validator #val_index of the set at `height`,
    at the block's time, signed by the chain's signer."""
    vals = built.chain[height][0].validators
    val = vals.validators[val_index]
    sign = build("ed25519")["sign"]
    time_ = built.node.blocks.load_block_meta(height).header.time
    votes = []
    for tag in tags:
        v = m.vote.Vote(type=m.vote.PRECOMMIT, height=height, round=0,
                        block_id=m.block.BlockID(cs.tagged(tag, height),
                                                 m.block.PartSetHeader(1, cs.tagged(tag + b" parts", height))),
                        timestamp=time_, validator_address=val.address, validator_index=val_index)
        v.signature = sign([built.secrets[val.address]], [v.sign_bytes(CHAIN_ID)])[0]
        votes.append(v)
    return m.evidence.DuplicateVoteEvidence.new(*votes, time_, vals), votes


def advanced(state, by=1, **changes):
    new = state.copy()
    new.last_block_height += by
    return dataclasses.replace(new, **changes) if changes else new


def both(fn):
    outs = [fn(name, m, kw) for name, m, kw in PACKAGES]
    assert outs[0] == outs[1]
    return outs[0]


def test_pool_add_check_update_lifecycle():
    def run(name, m, kw):
        pool, built = pool_env(name, m, kw)
        ev, _ = duplicate_vote(m, built, 3)
        out = [cs.outcome(lambda: pool.add_evidence(ev)), pool.size()]
        pending, size = pool.pending_evidence(1 << 20)
        out += [[e.hash() for e in pending], size]
        out.append(cs.outcome(lambda: pool.check_evidence([ev])))
        out.append(cs.outcome(lambda: pool.check_evidence([ev, ev])))
        out.append(cs.outcome(lambda: pool.add_evidence(ev)))  # idempotent
        pool.update(advanced(built.node.state), [ev])
        out += [pool.size(), cs.outcome(lambda: pool.check_evidence([ev])), cs.outcome(lambda: pool.add_evidence(ev))]
        out.append(cs.outcome(lambda: pool.update(built.node.state, [])))
        out.append(list(pool.db.iterator()))
        return out

    out = both(run)
    assert out[0] == ("accepted", "") and out[1] == 1 and out[3] > 0
    assert out[5] == ("EvidenceError", "duplicate evidence in list")
    assert out[7:9] == [0, ("EvidenceError", "evidence was already committed")]
    assert out[10][0] == "ValueError" and "not greater than previous" in out[10][1]


def test_pool_refusals_match_reference():
    """check_evidence and add_evidence on evidence the pool must refuse (a
    forged vote signature, a height past the chain's), and a tampered total
    power, refused but stored regenerated."""
    def run(name, m, kw):
        pool, built = pool_env(name, m, kw)
        out = []
        ev, votes = duplicate_vote(m, built, 4)
        forged = copy.deepcopy(ev)
        forged.vote_b.signature = bytes(64)
        late = copy.deepcopy(ev)
        for vote in (late.vote_a, late.vote_b):
            vote.height = HEIGHTS + 5
        for bad in (forged, late):
            out.append(cs.outcome(lambda: pool.check_evidence([bad])))
            out.append(cs.outcome(lambda: pool.add_evidence(bad)))
        tampered = copy.deepcopy(ev)
        tampered.total_voting_power += 3
        out.append(cs.outcome(lambda: pool.add_evidence(tampered)))
        out.append([e.hash() for e in pool.pending_evidence(1 << 20)[0]])  # the regenerated one
        return out

    out = both(run)
    assert out[0][0] == "EvidenceError" and out[1][0] == "EvidenceVerifyError"
    assert out[4][0] == "EvidenceABCIError" and len(out[5]) == 1


def test_pool_report_conflicting_votes_materializes():
    def run(name, m, kw):
        pool, built = pool_env(name, m, kw)
        ev, votes = duplicate_vote(m, built, 6, val_index=1)
        pool.report_conflicting_votes(*votes)
        out = [pool.size()]
        pool.update(advanced(built.node.state), [])
        pending = pool.pending_evidence(1 << 20)[0]
        out += [pool.size(), [e.to_proto().encode() for e in pending], pending[0].hash() == ev.hash()]
        return out

    out = both(run)
    assert (out[0], out[1], out[3]) == (0, 1, True)


def test_pool_persistence_across_restart():
    def run(name, m, kw):
        pool, built = pool_env(name, m, kw)
        evs = [duplicate_vote(m, built, h)[0] for h in (2, 5)]
        for ev in evs:
            pool.add_evidence(ev)
        again = m.pool.EvidencePool(pool.db, built.node.states, built.node.blocks, **kw)
        return [again.size(), [e.hash() for e in again.pending_evidence(1 << 20)[0]],
                sorted(e.hash() for e in evs), list(pool.db.iterator())]

    out = both(run)
    assert out[0] == 2 and sorted(out[1]) == out[2]


@pytest.mark.parametrize("budget", [0, 1, "one", "two", 1 << 20])
def test_pending_evidence_byte_budget(budget):
    def run(name, m, kw):
        pool, built = pool_env(name, m, kw)
        evs = [duplicate_vote(m, built, h)[0] for h in (7, 2, 5)]
        for ev in evs:
            pool.add_evidence(ev)
        one = len(evs[0].bytes()) + 8
        cap = {"one": one, "two": 2 * one + 3}.get(budget, budget)
        got, size = pool.pending_evidence(cap)
        return [e.height for e in got], size

    heights, size = both(run)
    assert heights == {0: [], 1: [], "one": [2], "two": [2, 5], 1 << 20: [2, 5, 7]}[budget]


def test_pool_prunes_expired_evidence():
    """Pending evidence is dropped once both its height and its time window
    lapse, and kept while either holds."""
    def run(name, m, kw):
        pool, built = pool_env(name, m, kw)
        for h in (2, 9):
            pool.add_evidence(duplicate_vote(m, built, h)[0])
        state = built.node.state
        params = state.consensus_params

        def window(blocks, seconds):
            return dataclasses.replace(params, evidence=m.params.EvidenceParams(
                max_age_num_blocks=blocks, max_age_duration=seconds * 10**9, max_bytes=params.evidence.max_bytes))

        out = []
        # both heights' windows lapse, their time windows hold: kept
        pool.update(advanced(state, 1, consensus_params=window(5, 10 * 86400)), [])
        out.append(pool.size())
        # both time windows lapse, height 9's height window holds: 2 goes
        late = state.last_block_time.add(10 * 60 * 10**9)
        pool.update(advanced(state, 2, consensus_params=window(10, 60), last_block_time=late), [])
        out += [pool.size(), [e.height for e in pool.pending_evidence(1 << 20)[0]], list(pool.db.iterator())]
        return out

    out = both(run)
    assert out[:3] == [2, 1, [9]]


def test_evidence_to_abci_matches_reference():
    def run(name, m, kw):
        _, built = pool_env(name, m, kw)
        dup, _ = duplicate_vote(m, built, 3)
        out = [repr(m.evidence.evidence_to_abci([dup]))]
        for kind in ("lunatic", "equivocation"):
            out.append(repr(m.evidence.evidence_to_abci([attack_evidence(kind)[name], dup])))
        out.append(cs.outcome(lambda: m.evidence.evidence_to_abci([object()])))
        return out

    out = both(run)
    assert "MISBEHAVIOR" not in out[0] and out[3][0] == "TypeError"
