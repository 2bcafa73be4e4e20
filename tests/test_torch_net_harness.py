"""chip_smoke.py's network harness (phases 15 and 16) on the CPU: what it
reads from a node's WAL when the gossip lost a node's vote, proposal or
round step, and how its waits turn to that reading after the grace period.

A node's router drops a message to a peer whose send queue stays full, and
the harness announces no round state that would make the nodes gossip it
again; so a wait the gossip has not met reads each node's WAL, where the
node fsyncs its own votes and proposal as it signs them."""

from __future__ import annotations

import threading
import time
from types import SimpleNamespace

import pytest

import chip_smoke as cs


@pytest.fixture(scope="module")
def m():
    return cs.consensus_modules()


def _vote(m, h, r, type_, index, tag=b"\x01"):
    return m.vote.Vote(type=type_, height=h, round=r, block_id=m.block.BlockID(tag * 32),
                       timestamp=m.tmtime.Time.now(), validator_address=bytes([index]) * 20,
                       validator_index=index, signature=tag * 64)


def _proposal(m, h):
    return m.proposal.Proposal(height=h, round=0, block_id=m.block.BlockID(b"\x02" * 32),
                               timestamp=m.tmtime.Time.now(), signature=b"\x03" * 64)


def _write_wal(m, path, max_file_size=8 << 20):
    """A node's WAL: its own votes at 4 and 5 and its proposal at 5, a peer's
    vote, round steps up to (6, 0, 4) written out of order, an end of height;
    returns the own votes and the proposal."""
    W, Msgs = m.wal, m.messages
    wal = W.WAL(path, max_file_size=max_file_size)
    own = [_vote(m, 4, 0, m.vote.PRECOMMIT, 2), _vote(m, 5, 0, m.vote.PREVOTE, 2),
           _vote(m, 5, 0, m.vote.PRECOMMIT, 2)]
    prop = _proposal(m, 5)
    wal.write_sync(W.MsgInfo(Msgs.VoteMessage(own[0]), ""))
    wal.write(W.MsgInfo(Msgs.VoteMessage(_vote(m, 4, 0, m.vote.PRECOMMIT, 7)), "a-peer"))
    wal.write(W.EndHeightMessage(4))
    for step in ((5, 0, 3), (5, 0, 4)):
        wal.write(W.EventRoundStep(*step))
    wal.write_sync(W.MsgInfo(Msgs.ProposalMessage(prop), ""))
    wal.write_sync(W.MsgInfo(Msgs.VoteMessage(own[1]), ""))
    wal.write(W.EventRoundStep(6, 0, 4))
    wal.write(W.EventRoundStep(6, 0, 1))
    wal.write_sync(W.MsgInfo(Msgs.VoteMessage(own[2]), ""))
    wal.close()
    return own, prop


@pytest.mark.parametrize("rotated", [False, True], ids=["one-file", "rotated"])
def test_wal_own_records_reads_own_votes_proposals_and_the_latest_step(tmp_path, m, rotated):
    path = str(tmp_path / "cs.wal")
    own, prop = _write_wal(m, path, max_file_size=300 if rotated else 8 << 20)
    with open(path, "ab") as f:  # a torn last record, as a node writing at the time leaves it
        f.write(b"\x00\x01\x02\x03\xff\x00\x00\x00{\"type\"")
    if rotated:
        assert len(list(tmp_path.glob("cs.wal.*"))) > 1
    votes, proposals, step = cs.wal_own_records(m, path)
    assert [v.to_proto().encode() for v in votes] == [v.to_proto().encode() for v in own]
    assert [p.to_proto().encode() for p in proposals] == [prop.to_proto().encode()]
    assert step == (6, 0, 4)


def test_wal_own_records_of_a_missing_wal_is_empty(tmp_path, m):
    assert cs.wal_own_records(m, str(tmp_path / "none")) == ([], [], None)


def _stub(m, children):
    return SimpleNamespace(m=m, children=children, votes={}, proposals={}, steps={}, step_times={},
                           cond=threading.Condition(), recovered=[])


def test_recover_adds_only_what_the_harness_lacks(tmp_path, m):
    path = str(tmp_path / "cs.wal")
    own, prop = _write_wal(m, path)
    h = _stub(m, [SimpleNamespace(index=1, nid="n1", wal=path), SimpleNamespace(index=2, nid="n2")])
    gossiped = _vote(m, 4, 0, m.vote.PRECOMMIT, 2, tag=b"\x09")
    h.votes[(4, 0, m.vote.PRECOMMIT)] = {2: gossiped}
    got = cs.NetHarness._recover(h)
    assert got == [f"node 1's vote (5, 0, {m.vote.PREVOTE})", f"node 1's vote (5, 0, {m.vote.PRECOMMIT})",
                   "node 1's proposal (5, 0)", "node 1's step (6, 0, 4)"]
    assert h.votes[(4, 0, m.vote.PRECOMMIT)][2] is gossiped  # the gossiped vote stays
    assert h.votes[(5, 0, m.vote.PRECOMMIT)][2].to_proto().encode() == own[2].to_proto().encode()
    assert h.proposals[(5, 0)].to_proto().encode() == prop.to_proto().encode()
    assert h.steps == {"n1": (6, 0, 4)} and set(h.step_times) == {("n1", 6, 4)}
    assert cs.NetHarness._recover(h) == []  # nothing twice
    h.steps["n1"] = (7, 0, 1)  # the gossip already shows a later step
    assert cs.NetHarness._recover(h) == [] and h.steps["n1"] == (7, 0, 1)


@pytest.mark.parametrize("outcome", ["gossip", "wal", "neither"])
def test_wait_reads_the_wals_only_after_the_grace_period(monkeypatch, m, outcome):
    monkeypatch.setattr(cs, "NET_GOSSIP_GRACE_S", 0.3)
    h = _stub(m, [])
    reads = []

    def recover():
        reads.append(time.monotonic())
        if outcome == "wal":
            h.votes["k"] = 1
            return ["node 0's vote"]
        return []

    h._recover = recover
    if outcome == "gossip":
        threading.Timer(0.1, lambda: (h.votes.__setitem__("k", 1), h.cond.acquire(), h.cond.notify_all(),
                                      h.cond.release())).start()
    t0 = time.monotonic()
    if outcome == "neither":
        with pytest.raises(AssertionError, match="the vote within 1.5 s"):
            cs.NetHarness.wait(h, "the vote", lambda: "k" in h.votes, timeout=1.5)
        assert 1.5 <= time.monotonic() - t0 < 3
        assert len(reads) >= 2 and reads[0] - t0 >= 0.3
        return
    cs.NetHarness.wait(h, "the vote", lambda: "k" in h.votes, timeout=5)
    if outcome == "gossip":
        assert reads == [] and h.recovered == []
    else:
        assert len(reads) == 1 and reads[0] - t0 >= 0.3
        assert h.recovered == [("the vote", ["node 0's vote"])]
