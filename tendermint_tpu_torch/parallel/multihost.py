"""Multi-process entry points for the sharded verification plane.

The port of tendermint_tpu/parallel/multihost.py on torch.distributed.
Every process runs the same program over its own devices and passes only
its local jobs; one `all_reduce` (SUM) of one int32 on the process group
-- the process's device fail count plus its host precheck failures --
gives every process the global verdict, where the JAX package psums the
device counts over ICI and DCN and allgathers the host prechecks. The
collective is NCCL's between cards and gloo's on the host, as psum is
XLA's: communication, not compute to write by hand. On one process
verify_batch_sharded_local is exactly verify_batch_sharded.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from ..ops import verify as V
from . import sharded_verify as sv


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, device=None) -> None:
    """Join the process group of num_processes processes as process_id. A
    no-op without an address (a single controller) and when this process
    has joined already. The address is host:port (tcp://) or a whole
    init_method URL (tcp:// or file://). The backend is NCCL, for the
    card; gloo only when device="cpu" is asked for. Any other error is
    raised."""
    if coordinator_address is None or dist.is_initialized():
        return
    init = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    backend = "gloo" if device is not None and torch.device(device).type == "cpu" else "nccl"
    dist.init_process_group(
        backend, init_method=init,
        world_size=-1 if num_processes is None else num_processes,
        rank=-1 if process_id is None else process_id,
    )


def _world(group=None) -> int:
    return dist.get_world_size(group) if dist.is_initialized() else 1


def global_mesh(device=None) -> sv.Mesh:
    """This process's part of the job's mesh. On a single controller every
    CUDA device (make_mesh), or `device`; across processes one device a
    process, cuda:{LOCAL_RANK} or `device`, with the process group."""
    if _world() == 1:
        return sv.make_mesh(device=device)
    if device is None:
        V.resolve_device()  # raises without a card
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}"
    return sv.Mesh([device], group=dist.group.WORLD)


def verify_batch_sharded_local(mesh: sv.Mesh, pubkeys, msgs, sigs, key_type: str = "ed25519"):
    """Multi-process verify_batch_sharded: each process passes only its
    LOCAL jobs, the global batch being their concatenation over the
    processes; every process calls it, with the same number of jobs, so
    that every process pads to the same shards. Returns (local bitmap
    (n,), global all-valid bool)."""
    if _world(mesh.group) == 1:
        return sv.verify_batch_sharded(mesh, pubkeys, msgs, sigs, key_type)
    oks, counts, precheck = sv._bitmap_shards(mesh, pubkeys, msgs, sigs, key_type)
    with sv._on(mesh.devices[0]):
        fails = sv.fail_count(sv._gather(mesh, counts)) + int(np.count_nonzero(~precheck))
        dist.all_reduce(fails, op=dist.ReduceOp.SUM, group=mesh.group)
        host = torch.cat([sv._gather(mesh, oks), fails == 0]).cpu().numpy()
    return host[:len(sigs)] & precheck, bool(host[-1])
