"""Differentiable rendering — losses, parameters, inverse-render train steps.

Counterpart of `oclpathtracer_tpu.diff`, for the names ported so far: gradients of
the rendered image w.r.t. material albedo and emission (and, through plain
autograd, roughness and vertex positions' interior terms), from torch autograd
through the batched integrators (`inverse.py`), from the kernel forward with a twin
backward (`fast.make_fast_renderer`), or from the adjoint kernel
(`fast.make_kernel_train_step`). The boundary terms of vertex gradients (`edge.py`,
`secondary.py`, `vertex.py`) and the sharded steps are not ported yet.
"""

from oclpathtracer_tpu_torch.diff.losses import l2_loss, mse_loss
from oclpathtracer_tpu_torch.diff.inverse import (
    SceneParams,
    apply_params,
    extract_params,
    make_loss_fn,
    make_optax_train_step,
    make_train_step,
    make_unbiased_loss_fn,
    value_and_grad,
)

__all__ = [
    "mse_loss",
    "l2_loss",
    "SceneParams",
    "apply_params",
    "extract_params",
    "make_loss_fn",
    "make_unbiased_loss_fn",
    "make_optax_train_step",
    "make_train_step",
    "value_and_grad",
]
