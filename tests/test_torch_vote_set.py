"""The port's VoteSet (types/vote_set.py) against the JAX package's: one
script of votes on a seeded set of 4, 7 and 10 validators of each key type
(one memoizing signer, so both packages carry the same signature bytes),
added to both packages' vote sets in one order: every add's outcome (added,
duplicate, or the error's class and message: a wrong step, index or
address, a bad signature, unexpected extension data, a conflicting vote and
the ConflictingVoteError's two votes), and after each add the majority
state (has_two_thirds_any, has_two_thirds_majority, two_thirds_majority,
has_all, the bit array); a peer's maj23 claim; then the bytes of
make_commit and, on an extended precommit set with real extension
signatures, of make_extended_commit. Each vote is verified on the host in
both packages (vote_set.py:108-110)."""

import copy

import numpy as np
import pytest

import chip_smoke as cs
from test_torch_light import Signer, members
from test_torch_state import JAX as JSTATE
from tendermint_tpu.types import vote_set as jvote_set
from tendermint_tpu_torch.types import vote_set as tvote_set

CHAIN_ID = "vote-set-chain"
PORT = cs.state_modules()
PACKAGES = (("port", PORT, tvote_set), ("jax", JSTATE, jvote_set))
SETS = [("ed25519", 4), ("sr25519", 7), ("ed25519", 10)]


def bid(m, tag):
    return m.block.BlockID(cs.tagged(tag, 1), m.block.PartSetHeader(1, cs.tagged(tag + b" parts", 1)))


def signed(m, vals, secrets, sign, type_, idx, block_id, t=7, height=1, round_=0, ext=b"", forge=False):
    v = vals.validators[idx]
    vote = m.vote.Vote(type=type_, height=height, round=round_, block_id=block_id,
                       timestamp=m.tmtime.Time(cs.STATE_T0 + t, 1000 + idx), validator_address=v.address,
                       validator_index=idx, extension=ext)
    vote.signature = sign([secrets[v.address]], [vote.sign_bytes(CHAIN_ID)])[0]
    if ext and type_ == m.vote.PRECOMMIT and not block_id.is_nil():
        vote.extension_signature = sign([secrets[v.address]], [vote.extension_sign_bytes(CHAIN_ID)])[0]
    if forge:
        vote.signature = cs.tamper(vote.signature)
    return vote


def state_of(vs):
    bid_, ok = vs.two_thirds_majority()
    return (vs.has_two_thirds_any(), vs.has_two_thirds_majority(), ok, bid_.hash, vs.has_all(),
            str(vs.bit_array()))


def outcome(call):
    try:
        return ("ok", call())
    except Exception as e:  # noqa: BLE001 - the outcome is compared
        extra = ()
        if type(e).__name__ == "ConflictingVoteError":
            extra = (e.vote_a.to_proto().encode(), e.vote_b.to_proto().encode())
        return (cs.error_name(e), str(e), *extra)


def script(m, vsm, kind, n, sign):
    mem = members(kind, n, np.random.default_rng(70 + n))
    vals, secrets = cs.light_vals(m, mem)
    P, PC = m.vote.PREVOTE, m.vote.PRECOMMIT
    a, b, nil = bid(m, b"block a"), bid(m, b"block b"), m.block.BlockID()
    out = []
    prevotes = vsm.VoteSet(CHAIN_ID, 1, 0, P, vals)

    def add(label, vote):
        out.append((label, outcome(lambda: prevotes.add_vote(vote)), state_of(prevotes)))

    add("a wrong step", signed(m, vals, secrets, sign, P, 0, a, round_=1))
    wrong_index = signed(m, vals, secrets, sign, P, 0, a)
    wrong_index.validator_index = n
    add("an index past the set", wrong_index)
    wrong_addr = signed(m, vals, secrets, sign, P, 1, a)
    wrong_addr.validator_address = vals.validators[0].address
    add("another validator's address", wrong_addr)
    add("a bad signature", signed(m, vals, secrets, sign, P, 0, a, forge=True))
    add("extension data on a prevote", signed(m, vals, secrets, sign, P, 0, a, ext=b"smuggled"))
    for i in range(n):
        add(f"validator {i} for a" if i % 3 else f"validator {i} for nil",
            signed(m, vals, secrets, sign, P, i, a if i % 3 else nil))
    add("a duplicate", signed(m, vals, secrets, sign, P, 1, a))
    add("validator 1 for b: a conflict", signed(m, vals, secrets, sign, P, 1, b))
    prevotes.set_peer_maj23("peer", b)
    add("validator 2 for b after a maj23 claim", signed(m, vals, secrets, sign, P, 2, b))
    out.append(("by block b", str(prevotes.bit_array_by_block_id(b))))

    precommits = vsm.VoteSet(CHAIN_ID, 1, 0, PC, vals)
    for i in range(n):
        if n < 7 or i != n - 1:  # on the larger sets one validator absent, one for nil
            precommits.add_vote(signed(m, vals, secrets, sign, PC, i, a if i or n < 7 else nil, t=9))
    out.append(("commit", state_of(precommits), precommits.make_commit().to_proto().encode()))

    extended = vsm.VoteSet.extended(CHAIN_ID, 1, 0, PC, vals)
    for i in range(n):
        vote = signed(m, vals, secrets, sign, PC, i, a if i % 4 else nil, t=11, ext=b"ext-%d" % i if i % 4 else b"")
        out.append((f"extended {i}", outcome(lambda: extended.add_vote(vote))))
    no_ext = signed(m, vals, secrets, sign, PC, 1, b, t=12)
    out.append(("extended: a precommit without its extension signature", outcome(lambda: extended.add_vote(no_ext))))
    out.append(("extended commit", state_of(extended), extended.make_extended_commit().encode()))
    return out


@pytest.mark.parametrize("kind,n", SETS)
def test_vote_set_script_matches_reference(kind, n):
    sign = Signer()
    port, jax = (script(m, vsm, kind, n, sign) for _, m, vsm in PACKAGES)
    assert port == jax
    by = {row[0]: row for row in port}
    assert by["a duplicate"][1] == ("ok", False)
    assert by["validator 1 for b: a conflict"][1][0] == "ConflictingVoteError"
    assert by["validator 2 for b after a maj23 claim"][1][0] == "ConflictingVoteError"
    assert by["a bad signature"][1][0] == "ValueError"
    assert by["commit"][1][1] and by["extended commit"][1][1]


def test_make_commit_before_a_majority_raises_like_reference():
    """make_commit without a +2/3 majority for a block raises the
    reference's error class and message in both packages."""
    sign = Signer()
    outs = []
    for _, m, vsm in PACKAGES:
        mem = members("ed25519", 4, np.random.default_rng(74))
        vals, secrets = cs.light_vals(m, mem)
        vs = vsm.VoteSet(CHAIN_ID, 1, 0, m.vote.PRECOMMIT, vals)
        vs.add_vote(signed(m, vals, secrets, sign, m.vote.PRECOMMIT, 0, bid(m, b"block a")))
        outs.append((outcome(vs.make_commit), outcome(copy.copy(vs).make_extended_commit)))
    assert outs[0] == outs[1] and outs[0][0][0] != "ok"
