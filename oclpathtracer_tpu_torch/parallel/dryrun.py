"""The multi-device dry run: the full sharded training step on tiny shapes.

Counterpart of the root `__graft_entry__.dryrun_multichip`: on a mesh of N entries
(the card's n × `cuda:0`, or n × `cpu` when asked) it renders the target with the
sharded batched integrator, takes one sharded inverse-render train step (pixels and
target shard, params replicate, gradients add), runs the sharded `auto` kernel step
on a 2-entry sub-mesh, and prints one line with the loss, the kernel image's mean and
segments, the scan, and the crc32 of both images' float32 bytes (any bit that moves in
either integrator's output changes a hash).
"""

from __future__ import annotations

import math
import zlib

import numpy as np
import torch

from oclpathtracer_tpu_torch.config import RenderConfig
from oclpathtracer_tpu_torch.core import rng
from oclpathtracer_tpu_torch.diff import extract_params, make_sharded_train_step
from oclpathtracer_tpu_torch.kernels.megakernel import prepare_scan
from oclpathtracer_tpu_torch.parallel.mesh import Mesh
from oclpathtracer_tpu_torch.parallel.sharded import render_progressive_sharded, shard_pixels
from oclpathtracer_tpu_torch.parallel.sharded_pallas import make_sharded_kernel_step
from oclpathtracer_tpu_torch.runtime.devices import get_devices
from oclpathtracer_tpu_torch.scene import load_cornell_box


def _devices(n_devices: int, device=None) -> list:
    """The dry run's mesh entries: n × `device` where it is given; else the first n
    CUDA devices, or n × the first where there are fewer (RuntimeError without a
    card)."""
    if device is not None:
        return [torch.device(device)] * n_devices
    devs = get_devices()
    if not devs:
        raise RuntimeError("no CUDA device: pass device='cpu' for a mesh on the host")
    return devs[:n_devices] if len(devs) >= n_devices else [devs[0]] * n_devices


def dryrun_multichip(n_devices: int, device=None) -> str:
    """One sharded inverse-render training step on an n_devices 'tiles' mesh, and
    the sharded kernel step on its first two entries; prints and returns the line."""
    mesh = Mesh(tuple(_devices(n_devices, device)))
    dev0 = mesh.devices[0]
    scene = load_cornell_box(device=dev0)
    # Tiny shapes: 16x16 image, 2 bounces, 2 spp — but the REAL sharded train step.
    cfg = RenderConfig(width=16, height=16, bounces=2)
    key = rng.make_key(0, dev0)
    pixel_ids = shard_pixels(cfg, mesh)

    target = render_progressive_sharded(scene, cfg, mesh, total_spp=2, samples_per_step=2)
    params = extract_params(scene, albedo=True, emissive=True)
    step = make_sharded_train_step(scene, cfg, mesh, spp=2, lr=1e-3)
    params, loss = step(params, target, pixel_ids, 0, key)
    if not math.isfinite(float(loss)):
        raise RuntimeError(f"non-finite loss {float(loss)}")

    # The kernel path too, on a 2-entry sub-mesh (the layout does not move a bit:
    # absolute-id RNG), folded into the printed line so that kernel changes move it.
    kmesh = Mesh(mesh.devices[:min(2, n_devices)])
    scan, table, emi, classes = prepare_scan(scene, "auto")
    kstep = make_sharded_kernel_step(cfg, kmesh, 2, scan=scan, emi_const=emi,
                                     classes=classes)
    kimg, ksegs = kstep(table, 0)
    kmean = float(kimg.mean()) / 2
    if not (bool(torch.isfinite(kimg).all()) and int(ksegs) > 0):
        raise RuntimeError("the sharded kernel step's image is not finite or traced nothing")
    jnp_hash = zlib.crc32(target.cpu().numpy().astype(np.float32).tobytes())
    kernel_hash = zlib.crc32(kimg.cpu().numpy().astype(np.float32).tobytes())
    line = (f"dryrun_multichip({n_devices}): ok, loss={float(loss):.6f}, "
            f"kernel_mean={kmean:.6f}, kernel_segs={int(ksegs)}, "
            f"scan={scan}, jnp_hash={jnp_hash:08x}, kernel_hash={kernel_hash:08x}")
    print(line, flush=True)
    return line

