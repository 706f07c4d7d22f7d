"""Inverse rendering through autograd of the twin: each unit is one step of
`diff.inverse.make_train_step` (per-material albedo and emission, plain SGD at the
configuration's learning rate, its loss the squared error to the target summed and
divided by the pixel count) on the threefry streams of the seed's key, the step
index advancing. The loss is read to the host every `read_loss_every` steps.

The target is the reference's render of materials drawn from the seed; the start
parameters are drawn from the seed too. Set-up takes the first `first_steps` steps
through the same call; those are checked against the reference following them from
the same start: each step's loss, the first gradient (from the parameters after
step one) and the parameters' change after the last.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import common, compare
from benchmark.reference import pathtrace as pt
from benchmark.reference import scene as rs
from benchmark.reference import streams

# The target's samples: from here on, disjoint from every step's.
TARGET_FIRST = 1_000_000


def materials(gen, sd: rs.SceneData, device, rows: torch.Tensor):
    """Albedo U(0.1, 0.9) and emission 30 U(0.8, 1.2) on the light's rows (0 else) for
    the (K,) rows of the material groups `rows` maps each material record to."""
    k = int(rows.max()) + 1
    light = torch.zeros(k, dtype=torch.bool, device=device)
    light[rows[torch.as_tensor(rs.light_materials(sd), device=device)]] = True
    albedo = common.draw(gen, 0.1, 0.9, (k, 3), device)
    emissive = torch.where(light[:, None], 30.0 * common.draw(gen, 0.8, 1.2, (k, 3), device),
                           torch.zeros((k, 3), device=device))
    return albedo, emissive


class TrainEntry:
    """What both training entries share: the seeded target and start, the first
    steps in set-up, the loop's unit and the check. A subclass gives `groups` (each
    material record's trainable row), `build` (the program's step and its start),
    `reference_loss` and, where its step projects, `update`."""

    wait_each = False

    def __init__(self, cell, seed: int, device: torch.device):
        c, t = cell.config, cell.traffic
        self.cell, self.seed, self.device = cell, seed, device
        self.spp, self.lr = c["spp"], c["lr"]
        self.read_every, self.first_steps = t["read_loss_every"], t["first_steps"]
        self.sd = rs.scene_data(cell)
        self.rows = torch.as_tensor(self.groups(), device=device)
        gen = torch.Generator(device=device).manual_seed(seed)
        ta, te = materials(gen, self.sd, device, self.rows)
        self.p0 = materials(gen, self.sd, device, self.rows)
        g = pt.geometry(self.sd, device)
        self.target = pt.mean_image(g, common.reference_render(cell), TARGET_FIRST,
                                    c["target_spp"], ta[self.rows], te[self.rows])
        del g
        common.fresh_peak(device)

        self.scene, self.cfg = common.program_scene(cell, device)
        self.step, params = self.build()
        losses, after = [], []
        for k in range(self.first_steps):
            params, loss = self.step(params, self.target, k)
            losses.append(loss)
            after.append(params)
        self.params = params
        self.first = (losses, after[0], after[-1])
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def unit(self, i: int) -> None:
        self.params, loss = self.step(self.params, self.target, i)
        if (i + 1) % self.read_every == 0:
            float(loss)

    def counts(self, units: int) -> dict:
        return {}

    def outputs(self, units: int) -> dict:
        losses, p1, pn = self.first
        out = {"losses": [float(x) for x in losses],
               "p1": [x.detach().double().cpu() for x in p1[:2]],
               "pn": [x.detach().double().cpu() for x in pn[:2]]}
        self.params = self.first = self.step = self.scene = None
        common.free(self.device)
        return out

    def reference(self, dtype=torch.float32) -> dict:
        """The reference's first steps from p0, its parameters kept in float32 as the
        program's are: losses, first gradient, parameters after the first and the
        last step."""
        g = pt.geometry(self.sd, self.device, dtype)
        r = common.reference_render(self.cell)
        p = [x.clone() for x in self.p0]
        losses, after = [], []
        for k in range(self.first_steps):
            leaves = [x.detach().requires_grad_() for x in p]
            loss = self.reference_loss(g, r, leaves, k)
            grads = torch.autograd.grad(loss, leaves)
            losses.append(float(loss.detach()))
            if k == 0:
                g0 = [x.detach().double().cpu() for x in grads]
            p = [x.float() for x in self.update([x.detach() for x in leaves], grads)]
            after.append([x.detach().double().cpu() for x in p])
        return {"losses": losses, "g0": g0, "p1": after[0], "pn": after[-1]}

    def update(self, p, g):
        return [x - self.lr * d for x, d in zip(p, g)]

    def numbers(self, outputs: dict) -> dict:
        return self.compare(outputs, self.reference())

    def compare(self, outputs: dict, ref: dict) -> dict:
        p0 = [x.double().cpu() for x in self.p0]
        keep = compare.counted_leaves(ref["g0"])

        def first_gradient(p1):
            return [(a - b) / self.lr for a, b in zip(p0, p1)]

        def change(pn):
            return [b - a for a, b in zip(p0, pn)]

        return {"loss_gap": compare.loss_gap(outputs["losses"], ref["losses"]),
                "grad_gap": compare.leaf_gap(first_gradient(outputs["p1"]),
                                             first_gradient(ref["p1"]), keep),
                "change_gap": compare.leaf_gap(change(outputs["pn"]), change(ref["pn"]), keep)}

    def control_outputs(self, outputs: dict) -> dict:
        """The reference in bfloat16 in the program's place."""
        low = self.reference(torch.bfloat16)
        return {"losses": low["losses"], "p1": low["p1"], "pn": low["pn"]}


class Entry(TrainEntry):
    def groups(self):
        return np.arange(self.sd.albedo.shape[0])

    def build(self):
        from oclpathtracer_tpu_torch.core import rng
        from oclpathtracer_tpu_torch.diff import inverse

        key = rng.make_key(self.seed, self.device)
        step = inverse.make_train_step(self.scene, self.cfg, self.spp, lr=self.lr)
        start = inverse.SceneParams(albedo=self.p0[0].clone(), emissive=self.p0[1].clone())
        return (lambda params, target, k: step(params, target, k, key)), start

    def reference_loss(self, g, r, leaves, k):
        key = streams.fold_key(streams.key(self.seed), k)
        img = pt.mean_image(g, r, 0, self.spp, leaves[0], leaves[1], stream=("threefry", key))
        return ((img - self.target) ** 2).sum() / img.shape[0]


def fault_patches(fault: str) -> list:
    """The port's functions a planted fault replaces (`faults.py`)."""
    from oclpathtracer_tpu_torch.diff import inverse

    if fault == "unchanged":
        orig = inverse.make_train_step

        def make(*a, **kw):
            step = orig(*a, **kw)

            def same(params, target, k, key):
                return params, step(params, target, k, key)[1]
            return same

        return [(inverse, "make_train_step", make)]
    render, l2 = inverse.render_spp, inverse.l2_loss

    def render_spp(scene, cfg, spp, key, pixel_ids=None, base_sample=0):
        if fault == "altered":
            return render(scene, cfg, spp, key, pixel_ids, base_sample + 1)
        ids = torch.arange(cfg.n_pixels // 2, dtype=torch.int64, device=key.device)
        return render(scene, cfg, spp, key, ids, base_sample)

    def l2_loss(img, target):
        return l2(img, target[:img.shape[0]])

    return [(inverse, "render_spp", render_spp), (inverse, "l2_loss", l2_loss)]
