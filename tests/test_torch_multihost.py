"""The port's multi-process entry points (tendermint_tpu_torch/parallel/
multihost.py) on torch.distributed's gloo backend, on the CPU: initialize()
without an address is a no-op; with one in-process rank
verify_batch_sharded_local is verify_batch_sharded; four ranks, each its
own process, hold a quarter of a batch each, and their concatenated local
bitmaps equal the JAX package's verify_batch_sharded on the whole batch,
with its verdict on every rank. The ranks meet through a file:// rendezvous
under the test's tmp_path and run under a timeout, so a hung rendezvous
fails the test instead of stalling the suite."""

import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from tendermint_tpu.parallel import sharded_verify as jsv
from tendermint_tpu_torch.parallel import multihost as mh
from tendermint_tpu_torch.parallel import sharded_verify as sv

from test_torch_sharded import _same, _tamper, sr_jobs
from test_torch_verify import seeded_jobs

# The plain versions run many small ops: one intra-op thread per test
# worker keeps parallel workers from oversubscribing the cores.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4


def test_initialize_without_address_is_a_noop():
    assert mh.initialize() is None
    assert not dist.is_initialized()
    assert mh.global_mesh(device="cpu").devices == (torch.device("cpu"),)


def test_one_rank_is_the_sharded_path(tmp_path):
    job = seeded_jobs(151, 16, tamper={3})
    mesh = sv.make_mesh(2, device="cpu")
    want = sv.verify_batch_sharded(mesh, *job)
    mh.initialize(f"file://{tmp_path / 'rendezvous'}", 1, 0, device="cpu")
    try:
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
        mh.initialize("localhost:1", 4, 3)  # joined already: a no-op
        before = sv.verify_batch_sharded.launches
        _same(mh.verify_batch_sharded_local(mesh, *job), want)
        assert sv.verify_batch_sharded.launches == before + 1
        assert mh.global_mesh(device="cpu").devices == (torch.device("cpu"),)
    finally:
        dist.destroy_process_group()
    assert want[0].tolist() == [i != 3 for i in range(16)] and want[1] is False


# Each rank joins the group, verifies its quarter of every batch in the
# .npz and writes its local bitmaps and verdicts to rank<r>.npz.
_RANKS = r'''
import sys

import numpy as np
import torch


def unpack(flat, lengths):
    ends = np.cumsum(lengths)
    return [flat[e - n:e].tobytes() for e, n in zip(ends, lengths)]


def rank_main(rank, world, init, path, out_dir):
    torch.set_num_threads(1)
    from tendermint_tpu_torch.parallel import multihost as mh

    mh.initialize(init, world, rank, device="cpu")
    mesh = mh.global_mesh(device="cpu")
    data = np.load(path)
    out = {}
    for case in data["cases"]:
        cols = [unpack(data[f"{case}_{c}"], data[f"{case}_{c}_len"]) for c in ("pk", "msg", "sig")]
        per = len(cols[0]) // world
        local = [c[rank * per:(rank + 1) * per] for c in cols]
        bitmap, ok = mh.verify_batch_sharded_local(mesh, *local, key_type=str(data["key_type"]))
        out[f"{case}_bitmap"], out[f"{case}_ok"] = bitmap, np.array(ok)
    np.savez(f"{out_dir}/rank{rank}.npz", **out)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    import torch.multiprocessing as mp

    world, init, path, out_dir = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
    mp.spawn(rank_main, args=(world, init, path, out_dir), nprocs=world, join=True)
'''


def _pack(items):
    return np.frombuffer(b"".join(items), np.uint8), np.array([len(x) for x in items], np.int64)


def _batches(kind):
    """Three batches of 4 ranks' jobs: all valid, one tampered row (rank 1's),
    one signature of a bad length (rank 2's, refused by the host precheck)."""
    job = seeded_jobs(152, 16 * WORLD) if kind == "ed25519" else sr_jobs(8 * WORLD)
    per = len(job[2]) // WORLD
    bad_len = list(job[2])
    bad_len[2 * per + 1] = bad_len[2 * per + 1][:63]
    return {"valid": job, "tampered": job[:2] + (_tamper(job[2], per + 2),),
            "bad_length": job[:2] + (bad_len,)}


@pytest.mark.parametrize("kind", ["ed25519", "sr25519"])
def test_four_gloo_ranks_match_jax(tmp_path, kind):
    batches = _batches(kind)
    arrays = {"cases": np.array(list(batches)), "key_type": np.array(kind)}
    for case, job in batches.items():
        for col, items in zip(("pk", "msg", "sig"), job):
            arrays[f"{case}_{col}"], arrays[f"{case}_{col}_len"] = _pack(items)
    np.savez(tmp_path / "jobs.npz", **arrays)
    (tmp_path / "ranks.py").write_text(_RANKS)
    env = dict(os.environ, PYTHONPATH=ROOT)
    # its own session, so that a hang kills the launcher and every rank
    proc = subprocess.Popen(
        [sys.executable, str(tmp_path / "ranks.py"), str(WORLD), f"file://{tmp_path / 'rendezvous'}",
         str(tmp_path / "jobs.npz"), str(tmp_path)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=180)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        pytest.fail(f"the four ranks hung past 180 s:\n{out[-4000:]}")
    assert proc.returncode == 0, out[-4000:]
    ranks = [np.load(tmp_path / f"rank{r}.npz") for r in range(WORLD)]
    for case, job in batches.items():
        want = jsv.verify_batch_sharded(jsv.make_mesh(8), *job, key_type=kind)
        bitmap = np.concatenate([r[f"{case}_bitmap"] for r in ranks])
        _same((bitmap, bool(ranks[0][f"{case}_ok"])), want)
        assert {bool(r[f"{case}_ok"]) for r in ranks} == {case == "valid"}
        per = len(job[2]) // WORLD
        assert [i for i, ok in enumerate(bitmap) if not ok] == {
            "valid": [], "tampered": [per + 2], "bad_length": [2 * per + 1]}[case]
