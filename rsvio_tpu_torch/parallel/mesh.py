"""The landmark mesh: one torch.distributed process group, one rank per
landmark shard.

Port of rsvio_tpu/parallel/mesh.py. JAX's mesh is a 1-D device array whose
``psum`` the XLA compiler routes; here each rank is a process with its own
device, and the two collectives the sharded solvers need are methods of
``Mesh``: ``all_reduce_packed`` (JAX's tuple ``psum``: the tensors are
concatenated, summed in ONE ``all_reduce`` and split back) and
``all_gather`` (the landmark shards concatenated back in rank order). Both
count their calls and bytes in ``Mesh.counts``, a host dict read from the
tensors' shapes, so counting costs no device sync.

Backends: NCCL with one rank per card, gloo for several ranks on one card
(it stages CUDA tensors through the host: a device sync per collective) or
on the CPU. NCCL's collectives can be captured in a CUDA graph
(``Mesh.capturable``) once the communicator exists (``Mesh.warm_up``);
gloo's cannot.
"""

from __future__ import annotations

import functools

import torch
import torch.distributed as dist

LANDMARK_AXIS = "lm"


def default_backend(device_type: str) -> str:
    """NCCL on CUDA, gloo on the CPU."""
    return "nccl" if device_type == "cuda" else "gloo"


def check_nccl_ranks(backend: str, local_ranks: int) -> None:
    """NCCL runs one rank per card: more ranks than this host's cards is an
    error, never a quiet switch to gloo."""
    if backend == "nccl":
        n_cards = torch.cuda.device_count()
        if local_ranks > n_cards:
            raise ValueError(
                f"backend='nccl' runs one rank per card: {local_ranks} ranks "
                f"on this host but {n_cards} cards (pass backend='gloo' to "
                f"put several ranks on one card)")


class Mesh:
    """A 1-D landmark mesh over a process group: this rank's index and
    device, the world size, the backend, and the collective counts."""

    def __init__(self, group, rank: int, size: int, device: torch.device,
                 backend: str):
        self.group = group
        self.rank = rank
        self.size = size
        self.device = device
        self.backend = backend
        self.counts = {}
        self.reset_counts()
        self._warm = False

    @property
    def capturable(self) -> bool:
        """Whether the collectives can run inside a CUDA graph: NCCL on a
        CUDA device, not gloo (it stages through the host and syncs)."""
        return self.backend == "nccl" and self.device.type == "cuda"

    def warm_up(self) -> None:
        """One eager all-reduce and all-gather outside any capture, on every
        rank, once: NCCL makes its communicator at the first collective,
        which a capture (or the sync debug mode of a graph's first run)
        would refuse. Not counted in `counts`."""
        if self._warm:
            return
        x = torch.zeros(1, device=self.device)
        dist.all_reduce(x, group=self.group)
        dist.all_gather([torch.empty_like(x) for _ in range(self.size)], x,
                        group=self.group)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._warm = True

    def reset_counts(self) -> None:
        self.counts.update(all_reduce_calls=0, all_reduce_bytes=0,
                           all_gather_calls=0, all_gather_bytes=0)

    def all_reduce_packed(self, *tensors):
        """The sums over all ranks of `tensors`, in one all-reduce of their
        flat concatenation in the promoted dtype (integer counts then sum
        in float: exact below 2**24 in float32), each returned in its own
        shape and dtype."""
        dtype = functools.reduce(torch.promote_types,
                                 (t.dtype for t in tensors))
        flat = torch.cat([t.reshape(-1).to(dtype) for t in tensors])
        self.counts["all_reduce_calls"] += 1
        self.counts["all_reduce_bytes"] += flat.numel() * flat.element_size()
        dist.all_reduce(flat, group=self.group)
        out, at = [], 0
        for t in tensors:
            n = t.numel()
            out.append(flat[at:at + n].reshape(t.shape).to(t.dtype))
            at += n
        return tuple(out)

    def all_gather(self, x, dim: int = 0):
        """The ranks' `x` concatenated along `dim` in rank order (each rank
        holds its contiguous landmark shard)."""
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.size)]
        self.counts["all_gather_calls"] += 1
        self.counts["all_gather_bytes"] += \
            x.numel() * x.element_size() * self.size
        dist.all_gather(parts, x, group=self.group)
        return torch.cat(parts, dim=dim)

    def shard(self, n: int) -> slice:
        """This rank's contiguous slice of an axis of length n, which must
        divide by the world size."""
        if n % self.size:
            raise ValueError(
                f"landmark count {n} not divisible by mesh size {self.size}")
        per = n // self.size
        return slice(self.rank * per, (self.rank + 1) * per)


def make_mesh(n_devices: int | None = None, devices=None,
              backend: str | None = None) -> Mesh:
    """The landmark mesh over the default process group (create it first
    with multihost.initialize_distributed, or torchrun). Without a group,
    a one-rank group is made here (an in-memory store), so a single
    process still runs its collectives.

    n_devices: the expected world size (checked). devices: "cuda" (the
    default: rank r on card r mod the card count), "cpu", or a sequence
    of one device per rank. backend: the backend of the group made here
    (default NCCL on CUDA, gloo on the CPU); with a group already made, it
    must match it.
    """
    if devices is None or isinstance(devices, (str, torch.device)):
        kind = torch.device(devices or "cuda").type
    else:
        kind = torch.device(devices[0]).type
    if kind == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_mesh: no CUDA device (pass devices='cpu')")
    if not dist.is_initialized():
        backend = backend or default_backend(kind)
        check_nccl_ranks(backend, 1)
        if backend == "nccl":
            torch.cuda.set_device(0)
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    group_backend = str(dist.get_backend())
    if backend is not None and backend != group_backend:
        raise ValueError(f"make_mesh: backend {backend!r} asked, but the "
                         f"process group runs {group_backend!r}")
    rank, size = dist.get_rank(), dist.get_world_size()
    if n_devices is not None and n_devices != size:
        raise ValueError(f"make_mesh: {n_devices} devices asked, but the "
                         f"process group has {size} ranks")
    if devices is None or isinstance(devices, (str, torch.device)):
        device = (torch.device("cuda", rank % torch.cuda.device_count())
                  if kind == "cuda" else torch.device("cpu"))
    else:
        if len(devices) != size:
            raise ValueError(f"make_mesh: {len(devices)} devices for "
                             f"{size} ranks")
        device = torch.device(devices[rank])
    if group_backend == "nccl":
        if device.type != "cuda":
            raise ValueError("make_mesh: NCCL needs a CUDA device a rank")
        torch.cuda.set_device(device)
    return Mesh(dist.group.WORLD, rank, size, device, group_backend)
