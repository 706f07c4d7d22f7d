"""Device discovery and queries.

Counterpart of `oclpathtracer_tpu.runtime.devices`: the reference's device bring-up
stack (SURVEY.md §3.1: clewInit → DeviceCL::initialize → platform/device enumeration,
clew.cpp:165-210, AdlCL.cpp:68-271) is CUDA's runtime under torch here; this module
exposes the same *queries* the reference offers (name, memory totals/usage —
Adl.h:139-194, AdlCL.cpp:385-483), plus mesh construction for the parallel layer
(`parallel/mesh.py`), a multi-device path the reference never had.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import torch


@dataclasses.dataclass(frozen=True)
class DeviceInfo:
    """Device queries ≡ Device::getDeviceName/getDeviceVendor/... (Adl.h:161-170)."""

    index: int
    platform: str
    kind: str
    memory_total: Optional[int]       # bytes, if the backend reports it
    memory_in_use: Optional[int]      # bytes, if the backend reports it


def get_devices(backend: Optional[str] = None) -> list:
    """The CUDA devices (≡ DeviceUtils::getNDevices, Adl.cpp:83-104), `[]` without a
    card; `get_devices("cpu")` is `[torch.device("cpu")]`."""
    if backend == "cpu":
        return [torch.device("cpu")]
    if backend not in (None, "cuda"):
        raise ValueError(f"backend must be None, 'cuda' or 'cpu', got {backend!r}")
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def memory_stats(device) -> dict:
    """Live memory accounting (≡ Device::getUsedMemory/Peak, Adl.h:168-170):
    `torch.cuda.memory_stats` of a CUDA device, `{}` on the CPU."""
    device = torch.device(device)
    return torch.cuda.memory_stats(device) if device.type == "cuda" else {}


def device_info(device=None) -> DeviceInfo:
    """The queries of `device`, the first CUDA device by default (RuntimeError
    without one)."""
    if device is None:
        devices = get_devices()
        if not devices:
            raise RuntimeError("no CUDA device: pass device='cpu' for the host")
        device = devices[0]
    device = torch.device(device)
    if device.type != "cuda":
        return DeviceInfo(index=0, platform="cpu", kind="cpu", memory_total=None,
                          memory_in_use=None)
    index = device.index if device.index is not None else torch.cuda.current_device()
    return DeviceInfo(index=index, platform="gpu", kind=torch.cuda.get_device_name(index),
                      memory_total=torch.cuda.get_device_properties(index).total_memory,
                      memory_in_use=torch.cuda.memory_allocated(index))


def make_mesh(axis_sizes: Sequence[int], axis_names: Sequence[str],
              devices: Optional[Sequence] = None):
    """Build a device mesh, e.g. make_mesh((8,), ('tiles',), ['cpu'] * 8).

    `devices` defaults to every visible CUDA device; the mesh takes the first
    prod(axis_sizes) of them (ValueError if there are fewer). The tests pass 8 ×
    `cpu`, a card n × `cuda:0`.
    """
    from oclpathtracer_tpu_torch.parallel.mesh import Mesh  # parallel/ imports runtime/

    devs = list(devices) if devices is not None else get_devices()
    total = math.prod(axis_sizes)
    if len(devs) < total:
        raise ValueError(f"need {total} devices for mesh {tuple(axis_sizes)}, have {len(devs)}")
    return Mesh(tuple(devs[:total]), tuple(axis_names), tuple(axis_sizes))
