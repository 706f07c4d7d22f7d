"""Multi-process runtime — torch.distributed bring-up and process-spanning meshes.

Counterpart of `oclpathtracer_tpu.parallel.multihost`. The reference has no
distributed story at all (SURVEY.md §2.3). Here:

  * `initialize` brings up torch.distributed (gloo for CPU devices, NCCL for CUDA)
    at an explicit coordinator address, world size and rank: nothing on a machine
    tells a program of its cluster;
  * one GLOBAL 1-D 'tiles' axis spans every device of every process: rank 0's local
    devices, then rank 1's, and so on (the local devices are the visible CUDA
    devices, or the one CPU device of a gloo process);
  * each process feeds only its contiguous share of the pixel space
    (host_local_pixel_slice), and the only collective a step needs is one
    `torch.distributed.all_reduce` of a local sum (the parameter gradients' psum);
  * sample streams key on absolute pixel ids (core/rng.py), so the N-process render
    is bit for bit the 1-process render.
"""

from __future__ import annotations

import datetime
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from oclpathtracer_tpu_torch.parallel.mesh import Mesh


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device="cuda",
               timeout: float = 60.0) -> None:
    """Bring up the process group (no-op for a single process).

    coordinator_address: 'host:port' of rank 0's store; num_processes: the world
    size; process_id: this process's rank; all three are needed for more than one
    process. `device`'s type picks the backend: gloo for "cpu", NCCL for "cuda".
    `timeout` (seconds) bounds the rendezvous and every collective, so that a peer
    that never comes cannot hang the caller.
    """
    if not (num_processes is not None and num_processes > 1 or coordinator_address):
        return
    if not coordinator_address or num_processes is None or process_id is None:
        raise ValueError("a multi-process run needs coordinator_address, num_processes "
                         "and process_id")
    backend = "gloo" if torch.device(device).type == "cpu" else "nccl"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout))


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_coordinator() -> bool:
    return process_index() == 0


def local_devices(devices: Optional[Sequence] = None) -> list:
    """This process's devices: `devices` if given, else the CPU for a gloo process
    group, else every visible CUDA device (RuntimeError without one)."""
    if devices is not None:
        return [torch.device(d) for d in devices]
    if dist.is_initialized() and dist.get_backend() == "gloo":
        return [torch.device("cpu")]
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass devices for a mesh on the host")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _global_devices(devices: Optional[Sequence] = None) -> list:
    """Every process's local devices, in rank order: [(rank, device name), ...]."""
    mine = [str(d) for d in local_devices(devices)]
    if process_count() == 1:
        return [(0, name) for name in mine]
    every = [None] * process_count()
    dist.all_gather_object(every, mine)
    return [(rank, name) for rank, names in enumerate(every) for name in names]


def global_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """1-D 'tiles' mesh over every device of every process, in rank order (another
    process's entries name its devices, which only it can reach). `devices`: this
    process's local devices, as for local_devices. With more than one process every
    rank must call this together (it gathers the ranks' device lists)."""
    return Mesh(tuple(name for _, name in _global_devices(devices)))


def host_local_pixel_slice(n_pixels: int, devices: Optional[Sequence] = None) -> slice:
    """The contiguous pixel range this process feeds.

    Pixels shard evenly over the global device order (global_mesh's); a process owns
    the union of its devices' shards, which is contiguous under the 1-D layout.
    Non-divisible pixel counts pad-and-mask: each device owns ceil(n/n_dev) padded
    rows (as parallel.sharded.shard_pixels lays them out), and the slice is clipped
    to the real pixel range, so a trailing process may own fewer real pixels, or
    none, never an error. With more than one process every rank must call this
    together, as global_mesh.
    """
    owners = [rank for rank, _ in _global_devices(devices)]
    per_dev = (n_pixels + len(owners) - 1) // len(owners)  # padded rows per device
    me = process_index()
    pos = [i for i, rank in enumerate(owners) if rank == me]
    lo, hi = pos[0], pos[-1]
    if pos != list(range(lo, hi + 1)):
        raise ValueError("the process's devices are not contiguous in the global order")
    return slice(min(lo * per_dev, n_pixels), min((hi + 1) * per_dev, n_pixels))


def all_reduce_sum(tensors: Sequence[torch.Tensor]) -> list:
    """Each tensor summed over every process (the tensors themselves for a single
    process): the one collective of the sharded steps, one all_reduce of the tensors
    flattened together. NCCL reduces on the first tensor's card, gloo on the CPU."""
    if process_count() == 1:
        return list(tensors)
    dev = tensors[0].device
    on = torch.device("cpu") if dist.get_backend() == "gloo" else dev
    flat = torch.cat([t.detach().reshape(-1).to(on) for t in tensors])
    dist.all_reduce(flat)
    parts = flat.split([t.numel() for t in tensors])
    return [p.reshape(t.shape).to(dev) for p, t in zip(parts, tensors)]
