"""Inverse rendering demo: recover perturbed wall albedos from a rendered target by
gradient descent through the path tracer (autograd of the batched integrator).

    python -m oclpathtracer_tpu_torch.examples.inverse_albedo [--steps 40] [--size 32]
        [--device cuda]
"""

from __future__ import annotations

import argparse
import functools
import sys

import torch

from oclpathtracer_tpu_torch.config import RenderConfig
from oclpathtracer_tpu_torch.core import rng
from oclpathtracer_tpu_torch.diff import SceneParams, apply_params, extract_params
from oclpathtracer_tpu_torch.diff.inverse import make_optax_train_step, render_spp
from oclpathtracer_tpu_torch.scene import load_cornell_box


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--size", type=int, default=32)
    ap.add_argument("--spp", type=int, default=2)
    ap.add_argument("--target-spp", type=int, default=16)
    ap.add_argument("--lr", type=float, default=0.02)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    scene = load_cornell_box(device=args.device)
    device = scene.geometry.p1.device
    cfg = RenderConfig(width=args.size, height=args.size, bounces=4)
    key = rng.make_key(0, device)

    # Target rendered with the TRUE albedos (more spp than the optimization renders:
    # otherwise gradient descent fits the target's own Monte-Carlo noise).
    target = render_spp(scene, cfg, args.target_spp, rng.make_key(7, device))
    true_albedo = scene.materials.albedo
    init = SceneParams(albedo=torch.clamp(extract_params(scene).albedo + 0.2, 0.0, 1.0))
    params = init
    err0 = float((params.albedo - true_albedo).abs().mean())

    # Adam handles the ~100x gradient-scale spread between wall and small-face albedos
    # that plain SGD oscillates on.
    step, opt_init = make_optax_train_step(scene, cfg, args.spp,
                                           functools.partial(torch.optim.Adam, lr=args.lr))
    opt_state = opt_init(params)
    for i in range(args.steps):
        # step_idx = i: a fresh sample set per step, so stochastic gradients average
        # the noise out instead of fitting one realization.
        params, opt_state, loss = step(params, opt_state, target, i, key)
        if i % 5 == 0 or i == args.steps - 1:
            err = float((params.albedo - true_albedo).abs().mean())
            print(f"step {i:3d}  loss {float(loss):10.3f}  mean|albedo err| {err:.4f}")
    err1 = float((params.albedo - true_albedo).abs().mean())
    print(f"albedo error: {err0:.4f} -> {err1:.4f}")

    # Image-space error is the actual objective; parameter error includes coordinates
    # the image cannot identify (faces barely visible at this resolution).
    eval_key = rng.make_key(99, device)
    with torch.no_grad():
        img_true, img_rec, img_init = (render_spp(apply_params(scene, p), cfg, 16, eval_key)
                                       for p in (SceneParams(), params, init))
        mse = [float(torch.mean((x - img_true) ** 2)) for x in (img_init, img_rec)]
    print(f"image MSE vs truth: init {mse[0]:.3f} -> recovered {mse[1]:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
