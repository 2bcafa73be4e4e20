"""The port's RLC plane (tendermint_tpu_torch/ops/msm.py) against the JAX
package's at 8 rows: the plain version of the RLC kernel gives the JAX
program's verdict on the same inputs and the same z_raw, in both
polarities, and the host scalar math and guards are the reference's."""

import numpy as np
import pytest
import torch

from tendermint_tpu.crypto import ed25519_ref as ref
from tendermint_tpu.ops import msm as JM
from tendermint_tpu.ops import verify as JV
from tendermint_tpu_torch.ops import msm as M

from test_torch_verify import seeded_jobs

# The plain versions run many small ops: one intra-op thread per test
# worker keeps parallel workers from oversubscribing the cores.
torch.set_num_threads(1)

Z16 = bytes(range(1, 17))


def valid_edge_jobs():
    """7 honest signatures and the small-order key with identity R and
    s = 0: an all-valid batch that only the cofactored equation accepts."""
    pks, msgs, sigs = seeded_jobs(41, 7)
    pks.append(ref.small_order_points()[1])
    msgs.append(b"anything")
    sigs.append(ref.compress(ref.IDENTITY) + b"\x00" * 32)
    return pks, msgs, sigs


def _rows(pks, msgs, sigs, z_raw):
    a, r, s, k, pre = JV._prepare_batch_py(pks, msgs, sigs)
    assert pre.all()
    zk, z, zs = JM._rlc_scalars_py(s, k, len(sigs), z_raw)
    return a, r, zk, z, zs


@pytest.mark.parametrize("case", ["valid", "tampered", "wrong_key"])
def test_msm_plain_matches_jax(case):
    pks, msgs, sigs = valid_edge_jobs()
    if case == "tampered":
        sigs[3] = sigs[3][:40] + bytes([sigs[3][40] ^ 1]) + sigs[3][41:]
    elif case == "wrong_key":
        pks[5] = seeded_jobs(42, 1)[0][0]
    rows = _rows(pks, msgs, sigs, Z16 * 8)
    want = bool(JM.msm_verify_kernel(*rows))
    got = M.msm_verify_kernel(*[torch.from_numpy(np.array(x)) for x in rows])
    assert got.dtype == torch.bool and got.shape == ()
    assert bool(got) == want == (case == "valid")


def test_verify_batch_rlc_matches_reference():
    pks, msgs, sigs = valid_edge_jobs()
    z_raw = np.random.default_rng(43).bytes(16 * 8)
    assert M.collect_rlc(M.verify_batch_rlc_async(pks, msgs, sigs, z_raw=z_raw, device="cpu")) is True
    assert JM.verify_batch_rlc(pks, msgs, sigs, z_raw=z_raw) is True
    # an s >= L row is refused on the host before any launch
    s = int.from_bytes(sigs[0][32:], "little")
    sigs[0] = sigs[0][:32] + (s + ref.L).to_bytes(32, "little")
    assert M.verify_batch_rlc_async(pks, msgs, sigs, z_raw=z_raw, device="cpu") is None
    assert M.collect_rlc(None) is False


def test_rlc_scalars_match_reference():
    pks, msgs, sigs = seeded_jobs(44, 5)
    a, r, s, k, _ = JV._prepare_batch_py(pks, msgs, sigs)
    (s, k) = JV.pad_pow2_rows([s, k], 5)
    z_raw = np.random.default_rng(45).bytes(16 * 5)
    for got, want in zip(M._rlc_scalars_py(s, k, 5, z_raw), JM._rlc_scalars_py(s, k, 5, z_raw)):
        np.testing.assert_array_equal(got, want)


def test_stream_divisibility_guard(monkeypatch):
    """A row count that the stream count does not divide raises instead of
    dropping the tail rows from the sum (ops/msm.py:92-101)."""
    monkeypatch.setattr(M, "G_STREAMS", 8)
    rows = [torch.zeros((12, w), dtype=torch.uint8) for w in (32, 32, 32, 16)]
    with pytest.raises(ValueError, match="not a multiple of the stream count 8"):
        M.msm_verify_kernel(*rows, torch.zeros((1, 32), dtype=torch.uint8))
    assert M._streams(16) == 8 and M._streams(4) == 4


def test_z_raw_validation():
    assert len(M._ensure_z_raw(3, None)) == 48
    assert M._ensure_z_raw(2, Z16 * 2) == Z16 * 2
    with pytest.raises(ValueError, match="z_raw must be 32 bytes"):
        M._ensure_z_raw(2, Z16)
    assert M.verify_batch_rlc_async([], [], [], device="cpu") is None
