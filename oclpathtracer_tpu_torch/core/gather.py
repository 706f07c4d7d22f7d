"""Rows of a small table gathered by a per-lane index: the twins' material lookups.

`gather_rows(table, idx)` is `table[idx]`, the same operation and the same bits. Where
autograd will differentiate it on the card (a float32 table of one or two dimensions
on CUDA that requires grad, under grad mode, its rows fitting the kernel's shared
memory), its backward is the hand-written fixed-order sum of `kernels/gather_grad.py`
(two launches, bitwise repeatable) in place of autograd's `index_put_(accumulate=True)`,
which gives each distinct index one thread a column that adds every duplicate in
series: 65,536 lanes onto a Cornell box's 18 materials. Everywhere else (the CPU,
`no_grad`, a frozen table) it is plain indexing with autograd's own backward; a CUDA
table too wide for the kernel counts `gather_grad.fallback`.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from oclpathtracer_tpu_torch.kernels import gather_grad as gg
from oclpathtracer_tpu_torch.runtime import profiling


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.table_shape = table.shape
        return table[idx]

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        shape = ctx.table_shape
        g = gg.gather_grad(idx.reshape(-1), grad.reshape(idx.numel(), -1), shape[0])
        return g.reshape(shape), None


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx] for a table of M rows (M,) or (M, C) and an integer index tensor."""
    if not (table.requires_grad and torch.is_grad_enabled() and table.is_cuda
            and table.dtype == torch.float32 and table.dim() in (1, 2)):
        return table[idx]
    if not gg.fits(table.shape[0], table.shape[1] if table.dim() == 2 else 1):
        profiling.count("gather_grad.fallback")
        return table[idx]
    return _GatherRows.apply(table, idx)
