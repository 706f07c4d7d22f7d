"""Worker process for tests/test_torch_parallel.py::test_multihost_two_process.

Runs as `python _torch_multihost_worker.py <rank> <nproc> <port> <outdir>`: brings up
a REAL torch.distributed process group (gloo, one CPU device a process) through
`parallel.multihost`, renders this process's strip of the pixel space, runs the one
cross-process collective (an all_reduce of the strip's sum), takes one sharded twin
train step on its strip (the loss and gradients all-reduced), and writes all three
for the parent test to check. Imports nothing of JAX.
"""

import os
import sys

import numpy as np
import torch

torch.set_num_threads(1)

from oclpathtracer_tpu_torch.config import RenderConfig
from oclpathtracer_tpu_torch.core import rng
from oclpathtracer_tpu_torch.diff import extract_params, make_sharded_train_step
from oclpathtracer_tpu_torch.diff.inverse import render_spp
from oclpathtracer_tpu_torch.parallel import multihost
from oclpathtracer_tpu_torch.parallel.mesh import Mesh
from oclpathtracer_tpu_torch.scene import load_cornell_box

rank, nproc, port, outdir = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                             sys.argv[4])

multihost.initialize(coordinator_address=f"localhost:{port}", num_processes=nproc,
                     process_id=rank, device="cpu", timeout=60.0)
assert multihost.process_count() == nproc, multihost.process_count()
assert multihost.is_coordinator() == (rank == 0)
mesh = multihost.global_mesh()
assert mesh.shape["tiles"] == nproc, mesh

scene = load_cornell_box(device="cpu")
cfg = RenderConfig(width=32, height=16, bounces=2)

# This process's contiguous strip of the global pixel space (512 px / 2 processes).
sl = multihost.host_local_pixel_slice(cfg.n_pixels)
assert sl.stop - sl.start == cfg.n_pixels // nproc, sl
pixel_ids = torch.arange(sl.start, sl.stop, dtype=torch.int64)

# Absolute-pixel-id keying: each strip is bit for bit those rows of the 1-process
# render (no communication in the forward pass).
img = render_spp(scene, cfg, 2, rng.make_key(5, device="cpu"), pixel_ids=pixel_ids)
np.save(os.path.join(outdir, f"strip_{rank}.npy"), img.numpy())

(total,) = multihost.all_reduce_sum([img.sum()])
np.save(os.path.join(outdir, f"psum_{rank}.npy"), total.numpy())

# The twin train step on this process's strip (a 1-entry mesh of its own): its loss
# and gradients are all-reduced, so every rank takes the 1-process step.
step = make_sharded_train_step(scene, cfg, Mesh(("cpu",)), spp=2, lr=1.0)
target = torch.full((sl.stop - sl.start, 3), 0.5)
params, loss = step(extract_params(scene, albedo=True, emissive=True), target, pixel_ids, 0,
                    rng.make_key(0, device="cpu"))
np.savez(os.path.join(outdir, f"step_{rank}.npz"), loss=loss.numpy(),
         albedo=params.albedo.numpy(), emissive=params.emissive.numpy())
torch.distributed.destroy_process_group()
print(f"worker {rank}: ok, psum={float(total):.6f}")
