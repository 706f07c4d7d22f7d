"""Differentiable rendering — losses, parameters, inverse-render train steps.

Counterpart of `oclpathtracer_tpu.diff`: gradients of the rendered image w.r.t.
material albedo and emission (and, through plain autograd, roughness and the
interior terms of vertex positions) from torch autograd through the batched
integrators (`inverse.py`), from the kernel forward with a twin backward
(`fast.make_fast_renderer`), or from the adjoint kernel
(`fast.make_kernel_train_step`); the boundary terms of vertex gradients
(`edge.py` for the silhouettes the camera sees, `secondary.py` for the light's rim
seen from the first path vertices) and the kernel-speed vertex step (`vertex.py`).
The sharded steps (`inverse.make_sharded_train_step`,
`fast.make_sharded_kernel_train_step`) split the pixels over a mesh (`parallel/`).
"""

from oclpathtracer_tpu_torch.diff.losses import l2_loss, mse_loss
from oclpathtracer_tpu_torch.diff.inverse import (
    SceneParams,
    apply_params,
    extract_params,
    make_loss_fn,
    make_optax_train_step,
    make_sharded_train_step,
    make_train_step,
    make_unbiased_loss_fn,
    value_and_grad,
)
from oclpathtracer_tpu_torch.diff.edge import (
    boundary_vertex_grads,
    make_edge_aware_loss_fn,
    project_to_screen,
)
from oclpathtracer_tpu_torch.diff.secondary import secondary_boundary_vertex_grads
from oclpathtracer_tpu_torch.diff.vertex import make_vertex_train_step

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
    "make_sharded_train_step",
    "value_and_grad",
    "boundary_vertex_grads",
    "make_edge_aware_loss_fn",
    "project_to_screen",
    "secondary_boundary_vertex_grads",
    "make_vertex_train_step",
]
