"""The 1-D device mesh of the sharded frame — counterpart of
``dynamicfusion_body_tpu/parallel/mesh.py``, on ``torch.distributed``.

The layout is the JAX package's: the voxel grid is sharded along its
leading (x) axis, each rank holding a contiguous slab of R / world planes;
the node pool, poses, depth maps and the live volume are replicated (whole
on every rank); vertex-parallel arrays are per-rank blocks of one fixed
size. Where JAX's ``shard_map`` bodies call ``lax.psum``, ``axis_index``
and ``ppermute``, the port's rank functions call :meth:`Mesh.psum`
(``all_reduce(SUM)``), read :attr:`Mesh.rank` and exchange halo planes
with :meth:`Mesh.send_recv` (``batch_isend_irecv``); the all-gather of a
per-rank block is :meth:`Mesh.all_gather` (``all_gather_into_tensor``).

Every rank runs the same Python code; a branch taken on a value read on
the host must read a value that is the same on every rank (an all-reduced
one), or the ranks' collectives stop matching and the job hangs until the
group's timeout.
"""

from __future__ import annotations

import datetime
from dataclasses import dataclass

import torch
import torch.distributed as dist

# a mismatched collective fails after this instead of hanging
GROUP_TIMEOUT_S = 60.0


@dataclass
class Mesh:
    """One rank's view of the job: its rank, the world size and its
    device. :meth:`close` leaves the process group."""

    rank: int
    world: int
    device: torch.device

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the ranks (``lax.psum``), a new tensor."""
        y = x.detach().clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM)
        return y

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` (one size on every rank) stacked along dim 0
        in rank order."""
        x = x.contiguous()
        out = x.new_empty((self.world * x.shape[0],) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x)
        return out

    def send_recv(self, sends: dict, recv_like: dict) -> dict:
        """Point-to-point exchange (``lax.ppermute``): ``sends`` maps a peer
        rank to the tensor sent to it, ``recv_like`` a peer rank to a
        tensor shaped like the one received from it. Returns {peer:
        received tensor}."""
        ops, out = [], {}
        for peer, t in sends.items():
            ops.append(dist.P2POp(dist.isend, t.contiguous(), peer))
        for peer, like in recv_like.items():
            out[peer] = torch.empty_like(like)
            ops.append(dist.P2POp(dist.irecv, out[peer], peer))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return out

    def close(self) -> None:
        """Destroy the process group."""
        if dist.is_initialized():
            dist.destroy_process_group()


def make_mesh(n_devices: int, init_file: str, backend: str = "nccl",
              rank: int = 0) -> Mesh:
    """Join this job's process group as ``rank`` of ``n_devices`` through
    a ``FileStore`` at ``init_file`` (a path no earlier job used) and
    return the mesh, on ``backend``: "nccl" (the default) on
    ``cuda:<rank>``, the ranks of one host, or "gloo" on the CPU. NCCL
    takes one card per rank: more ranks than cards raise (two ranks on
    one card fail or hang inside NCCL). A failing NCCL init raises;
    nothing falls back to another backend or device. Every collective
    fails after ``GROUP_TIMEOUT_S``. ``parallel/launch.py`` starts the
    ranks and calls this in each."""
    device = _device(backend, rank, n_devices)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, store=dist.FileStore(init_file, n_devices), rank=rank,
        world_size=n_devices,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    return Mesh(rank, n_devices, device)


def _device(backend: str, rank: int, world: int) -> torch.device:
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: the NCCL backend needs a CUDA "
                               "device; pass backend='gloo' for the CPU")
        n_cards = torch.cuda.device_count()
        if world > n_cards:
            raise RuntimeError(f"make_mesh: {world} NCCL ranks need {world} "
                               f"cards, this host has {n_cards}")
        return torch.device("cuda", rank)
    if backend == "gloo":
        return torch.device("cpu")
    raise ValueError(f"make_mesh: unsupported backend {backend!r}: use "
                     "'nccl' or 'gloo'")
