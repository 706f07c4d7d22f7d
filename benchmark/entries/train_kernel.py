"""Inverse rendering through the adjoint kernel: each unit is one step of
`diff.fast.make_kernel_train_step` (material-class albedo and emission, two forward
and two adjoint launches a step, plain SGD at the configuration's learning rate,
projected back to albedo in [0, 1] and emission >= 0), its loss the pairwise
(a − t)(b − t) mean over two disjoint frame ranges of the reference's streams chosen
by the step index, which advances. The loss is read to the host every
`read_loss_every` steps.

Target, start and check as for the twin (`train_twin.py`), with one row of
parameters a material class (the distinct material records) and the derivative
through max(radiance, 0) taken as 1, as the adjoint kernel's is.
"""

from __future__ import annotations

import torch

from benchmark.entries.train_twin import TrainEntry
from benchmark.reference import pathtrace as pt
from benchmark.reference import scene as rs

COUNT_CHUNK = 512  # samples a counting launch


class Entry(TrainEntry):
    def groups(self):
        return rs.material_classes(self.sd)

    def build(self):
        from oclpathtracer_tpu_torch.diff import fast

        step = fast.make_kernel_train_step(self.scene, self.cfg, self.spp, lr=self.lr)
        return step, fast.ClassParams(self.p0[0].clone(), self.p0[1].clone())

    def update(self, p, g):
        return [torch.clamp(p[0] - self.lr * g[0], 0.0, 1.0),
                torch.clamp(p[1] - self.lr * g[1], min=0.0)]

    def reference_loss(self, g, r, leaves, k):
        albedo, emissive = leaves[0][self.rows], leaves[1][self.rows]
        a, b = (pt.mean_image(g, r, f * self.spp, self.spp, albedo, emissive,
                              clamp_grad="identity") for f in (2 * k, 2 * k + 1))
        return torch.mean((a - self.target) * (b - self.target))

    def counts(self, units: int) -> dict:
        """Segments a forward traces over the window's steps' frames (the adjoint
        traces the same paths again)."""
        from oclpathtracer_tpu_torch.kernels import grad_megakernel as gk

        table, ct, n_classes, _ = gk.prepare_grad_scene(self.scene)
        first, n = 2 * self.first_steps * self.spp, 2 * units * self.spp
        total = 0
        for s in range(first, first + n, COUNT_CHUNK):
            total = total + gk.render_grads_pallas_stats(
                table, ct, self.cfg, s, min(COUNT_CHUNK, first + n - s), n_classes,
                with_grads=False)[2]
        return {"segments": int(total), "paths": n * self.cfg.n_pixels}


def fault_patches(fault: str) -> list:
    """The port's functions a planted fault replaces (`faults.py`)."""
    from oclpathtracer_tpu_torch.diff import fast
    from oclpathtracer_tpu_torch.kernels import grad_megakernel as gk

    if fault == "unchanged":
        orig = fast.make_kernel_train_step

        def make(*a, **kw):
            step = orig(*a, **kw)
            return lambda params, target, k: (params, step(params, target, k)[1])

        return [(fast, "make_kernel_train_step", make)]
    pair = fast._pair_and_grads
    if fault == "altered":
        def shifted(table, ct, cfg, spp, n_classes, target, step_idx, *a, **kw):
            return pair(table, ct, cfg, spp, n_classes, target, step_idx + 1, *a, **kw)

        return [(fast, "_pair_and_grads", shifted)]

    def loss_and_grads(scene, cfg, spp):
        table, ct0, n_classes, _ = gk.prepare_grad_scene(scene)
        n = cfg.n_pixels // 2

        def lg(params, target, step_idx):
            ct = torch.cat([params.albedo, params.emissive, ct0[:, 6:8]], dim=1)
            t = target[:n]
            a, b, g = pair(table, ct, cfg, spp, n_classes, t, step_idx, 3 * n, 0, n)
            return (torch.mean((a - t) * (b - t)),
                    fast.ClassParams(albedo=g[:, 0:3], emissive=g[:, 3:6]))
        return lg

    return [(fast, "_kernel_loss_and_grads", loss_and_grads)]
