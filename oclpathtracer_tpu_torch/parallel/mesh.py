"""Mesh construction and canonical shardings.

Counterpart of `oclpathtracer_tpu.parallel.mesh`. One axis, 'tiles': pixels and rays
are embarrassingly parallel, so a 1-D layout wastes nothing. A mesh here is an
ordered tuple of torch devices; an entry may repeat a device (the tests' mesh is 8 ×
`cpu`, a card's n × `cuda:0`), and each entry renders its own range of absolute
pixel ids there. torch has no sharded array: a sharded tensor is the list of its
shards, one on each entry's device, in mesh order.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence

import torch

TILE_AXIS = "tiles"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Devices in mesh order (row-major over the axes), with the axes' names and
    sizes: `Mesh(devices)` is one 'tiles' axis over all of them. Devices may be
    given as names ("cpu", "cuda:0")."""

    devices: tuple
    axis_names: tuple = (TILE_AXIS,)
    axis_sizes: tuple = ()

    def __post_init__(self):
        devs = tuple(torch.device(d) for d in self.devices)
        sizes = tuple(int(s) for s in self.axis_sizes) or (len(devs),)
        names = tuple(self.axis_names)
        if len(sizes) != len(names) or math.prod(sizes) != len(devs) or not devs:
            raise ValueError(f"mesh {sizes} over axes {names} does not hold "
                             f"{len(devs)} devices")
        object.__setattr__(self, "devices", devs)
        object.__setattr__(self, "axis_names", names)
        object.__setattr__(self, "axis_sizes", sizes)

    @property
    def shape(self) -> dict:
        """Axis name → size, as `jax.sharding.Mesh.shape`."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return len(self.devices)


def tile_devices(mesh: Mesh) -> tuple:
    """The devices of a 1-D 'tiles' mesh, in order; ValueError for any other mesh."""
    if mesh.axis_names != (TILE_AXIS,):
        raise ValueError(f"the sharded steps take a 1-D {TILE_AXIS!r} mesh, got axes "
                         f"{mesh.axis_names}")
    return mesh.devices


def default_mesh(devices: Optional[Sequence] = None, n: Optional[int] = None) -> Mesh:
    """1-D mesh over `devices` (default: every visible CUDA device; RuntimeError
    without one), or their first n."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass devices (e.g. ['cpu'] * 8) for a "
                               "mesh on the host")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devs = list(devices)
    if n is not None:
        devs = devs[:n]
    return Mesh(tuple(devs))


def tile_sharding(mesh: Mesh) -> Callable[[torch.Tensor], list]:
    """Shard the leading (pixel/ray) axis over 'tiles': x → its equal contiguous
    blocks in mesh order, each on its entry's device (ValueError unless the mesh
    divides the axis)."""
    devices = tile_devices(mesh)

    def put(x: torch.Tensor) -> list:
        if x.shape[0] % len(devices):
            raise ValueError(f"leading axis {x.shape[0]} not divisible by "
                             f"{len(devices)} mesh entries")
        return [part.to(d) for part, d in zip(x.split(x.shape[0] // len(devices)), devices)]

    return put


def replicated(mesh: Mesh) -> Callable:
    """A copy on each entry: x → [x.to(device) for each entry] (no copy where x is
    already there, so entries on one device share it). `x` is anything with
    `.to(device)`: a tensor, a Scene."""
    def put(x) -> list:
        return [x.to(d) for d in mesh.devices]

    return put
