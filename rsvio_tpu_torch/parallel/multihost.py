"""Multi-process setup: the process group and each rank's landmark shard.

Port of rsvio_tpu/parallel/multihost.py. Every rank is a process (torchrun
starts one per card, or pass the init method, count and rank yourself);
``initialize_distributed`` makes the default group that
``mesh.make_mesh`` / ``global_mesh`` build on. JAX feeds each host its
shard of a global array; here every rank holds the replicated arrays and
``shard_landmark_arrays`` takes its own slice (the sharded solvers do it
themselves).
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from .mesh import Mesh, check_nccl_ranks, make_mesh


def initialize_distributed(init_method: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None) -> None:
    """Make the default process group. The count and rank default to
    torchrun's WORLD_SIZE and RANK, the init method to "env://"
    (MASTER_ADDR / MASTER_PORT) under torchrun; give
    "tcp://host:port" or "file:///path" otherwise. No-op at one process
    and when a group exists. backend: default NCCL when CUDA is available,
    else gloo; NCCL with more ranks on this host (LOCAL_WORLD_SIZE, else
    the count) than cards raises. With NCCL the rank's card
    (LOCAL_RANK, else the rank) becomes the current device before the
    group is made."""
    if num_processes is None and "WORLD_SIZE" in os.environ:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and "RANK" in os.environ:
        process_id = int(os.environ["RANK"])
    if num_processes in (None, 1) or dist.is_initialized():
        return
    if init_method is None:
        init_method = "env://"
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    check_nccl_ranks(backend, int(os.environ.get("LOCAL_WORLD_SIZE",
                                                 num_processes)))
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", process_id)))
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_processes, rank=process_id)


def global_mesh(devices=None) -> Mesh:
    """The landmark mesh over every rank of the default group (all hosts'
    cards: NCCL routes within a host over NVLink and between hosts over
    the network)."""
    return make_mesh(devices=devices)


def host_local_slice(global_len: int):
    """(start, stop) of this rank's shard of a landmark axis of length
    global_len (which must divide by the rank count); (0, global_len)
    without a process group."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    r = dist.get_rank() if dist.is_initialized() else 0
    per = global_len // n
    return r * per, (r + 1) * per


def shard_landmark_arrays(mesh: Mesh, *arrays, axis_index: int = 0):
    """This rank's shard of each array along `axis_index` (the landmark
    axis), on the mesh's device."""
    out = []
    for a in arrays:
        sl = mesh.shard(a.shape[axis_index])
        idx = (slice(None),) * axis_index + (sl,)
        out.append(torch.as_tensor(a)[idx].to(mesh.device))
    return tuple(out) if len(out) > 1 else out[0]
