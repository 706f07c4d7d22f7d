"""Kernel-speed inverse rendering: recover material-CLASS attributes with the
adjoint kernel (`kernels/csrc/grad_megakernel.cu`), forward AND backward.

    python -m oclpathtracer_tpu_torch.examples.train_kernel [--steps 80] [--size 128]
        [--spp 8] [--device cuda]

Unlike inverse_albedo (autograd of the batched integrator: flexible, differentiates
anything) this is the kernel training path: gradients with respect to the scene's
deduplicated material classes (5 for the Cornell box) from
`diff.fast.make_kernel_train_step`, four kernel launches a step.
"""

from __future__ import annotations

import argparse
import sys

import torch

from oclpathtracer_tpu_torch.config import RenderConfig
from oclpathtracer_tpu_torch.diff.fast import (
    ClassParams,
    extract_class_params,
    make_kernel_train_step,
)
from oclpathtracer_tpu_torch.kernels.grad_megakernel import (
    prepare_grad_scene,
    render_grads_pallas,
)
from oclpathtracer_tpu_torch.scene import load_cornell_box

TARGET_START = 1_000_000  # the target's first frame: disjoint from every step's frames


def target_image(scene, cfg: RenderConfig, target_spp: int) -> torch.Tensor:
    """The MEAN image at the TRUE class attributes over frames TARGET_START ..
    TARGET_START + target_spp − 1, from the adjoint kernel's forward."""
    table, ct, n_classes, _ = prepare_grad_scene(scene)
    img, _ = render_grads_pallas(table, ct, cfg, TARGET_START, target_spp, n_classes,
                                 with_grads=False)
    return img / target_spp


def perturbed(true: ClassParams, offset: float = 0.25) -> ClassParams:
    """The start: class albedos + offset (clipped to [0, 1]); emissive true, but
    trainable (the step projects it back to >= 0 each update)."""
    return ClassParams(albedo=torch.clamp(true.albedo + offset, 0.0, 1.0),
                       emissive=true.emissive.clone())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=80)
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--spp", type=int, default=8)
    ap.add_argument("--target-spp", type=int, default=64)
    ap.add_argument("--bounces", type=int, default=4)
    ap.add_argument("--lr", type=float, default=3e-2)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    scene = load_cornell_box(device=args.device)
    cfg = RenderConfig(width=args.size, height=args.size, bounces=args.bounces)
    target = target_image(scene, cfg, args.target_spp)
    true = extract_class_params(scene)
    params = perturbed(true)
    err0 = float((params.albedo - true.albedo).abs().mean())

    step = make_kernel_train_step(scene, cfg, args.spp, lr=args.lr)
    for i in range(args.steps):
        params, loss = step(params, target, i)
        if i % 10 == 0 or i == args.steps - 1:
            err = float((params.albedo - true.albedo).abs().mean())
            emi_err = float((params.emissive - true.emissive).abs().mean())
            print(f"step {i:3d}  loss {float(loss):10.4f}  "
                  f"|albedo err| {err:.4f}  |emissive err| {emi_err:.3f}")
    err1 = float((params.albedo - true.albedo).abs().mean())
    print(f"class-albedo error: {err0:.4f} -> {err1:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
