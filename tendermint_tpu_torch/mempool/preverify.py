"""Opt-in tx signature pre-verification, routed through the unified
verification engine (ops/engine.py).

Apps whose txs carry ed25519 signatures (the flood bench, future
stateful apps with account-signed transfers; NOT the kvstore, whose txs
are unsigned) waste the dominant share of admission cost verifying
signatures one at a time. This module gives the mempool a `pre_verify`
hook that recognizes a self-describing signed-tx envelope and verifies
a whole admission batch in ONE engine submit — concurrent RPC and
gossip admitters coalesce into single launches, the same pattern
blocksync and consensus already use for commit signatures (EdDSA batch
amortization per the committee-consensus study, arxiv 2302.00418).

Envelope layout (SIGTX_MAGIC | pubkey(32) | sig(64) | payload): the
signature covers the payload only, so the app sees the same tx bytes
the sender hashed. Txs without the magic pass through untouched
(verdict None) — the hook is safe to enable on a mixed tx stream.

Wiring: hand an EngineTxPreVerifier to TxMempool (the reference's node
does so under `mempool.precheck-sigs = true`). Off by default. The
verifier takes `device`, where the engine runs a device group: the card
when None, the plain versions on the host with "cpu". An error of the
engine (a kernel wrapper's guard, a failed launch) propagates: it is no
verdict on any signature.
"""

from __future__ import annotations

SIGTX_MAGIC = b"\xd4sigtx1"
_PK_LEN = 32
_SIG_LEN = 64
_HEADER = len(SIGTX_MAGIC) + _PK_LEN + _SIG_LEN


def make_sig_tx(priv_key_seed_or_sk, payload: bytes) -> bytes:
    """Build a signed-tx envelope from a 64-byte expanded secret key
    (ed25519_ref.gen_privkey output) or a 32-byte seed. Test/bench
    helper — real clients assemble the same bytes out-of-process."""
    from ..crypto import ed25519_ref as ref

    sk = priv_key_seed_or_sk
    if len(sk) == 32:
        sk = ref.gen_privkey(sk)
    pk = sk[32:]
    sig = ref.sign(sk, payload)
    return SIGTX_MAGIC + pk + sig + payload


def parse_sig_tx(tx: bytes):
    """(pubkey, sig, payload) for a signed-tx envelope, else None."""
    if len(tx) < _HEADER or not tx.startswith(SIGTX_MAGIC):
        return None
    off = len(SIGTX_MAGIC)
    return (
        tx[off : off + _PK_LEN],
        tx[off + _PK_LEN : off + _PK_LEN + _SIG_LEN],
        tx[_HEADER:],
    )


class EngineTxPreVerifier:
    """The TxMempool pre_verify hook: batch-verifies every signed-tx
    envelope in the admission batch through the engine (one coalesced
    submit per batch; the engine merges concurrent admitters into
    single device/host-C launches). With TM_TPU_ENGINE=off the batch
    takes the direct dispatch, routed by size onto the same `device`,
    byte-identical in verdicts.

    Verdicts: True (valid), False (invalid — the mempool rejects before
    the app sees the tx), None (no envelope: pass through)."""

    def __init__(self, device=None):
        self.device = device

    def __call__(self, txs) -> list:
        idx: list[int] = []
        pks: list[bytes] = []
        msgs: list[bytes] = []
        sigs: list[bytes] = []
        out: list = [None] * len(txs)
        for i, tx in enumerate(txs):
            parsed = parse_sig_tx(tx)
            if parsed is not None:
                idx.append(i)
                pks.append(parsed[0])
                sigs.append(parsed[1])
                msgs.append(parsed[2])
        if not idx:
            return out
        from ..crypto.ed25519 import dispatch_batch

        _, bools = dispatch_batch("ed25519", pks, msgs, sigs, self.device)()
        for i, ok in zip(idx, bools):
            out[i] = bool(ok)
        return out
