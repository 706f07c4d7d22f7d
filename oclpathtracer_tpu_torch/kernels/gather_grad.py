"""Backward of a gather of rows from a small table: host side, plain PyTorch version
and CUDA wrapper.

    grad_table[m, c] = Σ grad[i, c] over the rows i with idx[i] = m

This replaces no TPU kernel: it is the port's own, the backward of the twins' material
gathers (`core/gather.py`), where autograd's `index_put_(accumulate=True)` adds each
index's duplicates in series in one thread a column, and `index_add_` sums with float
atomics. The kernel (`csrc/gather_grad.cu`) runs the adjoint kernel's two passes: each
thread adds its `ROWS` rows, `BLOCK` apart, in order into its own (M·C) slots; the block
reduces each slot by a fixed shuffle tree in each warp, then over the warps in order,
into (n_blocks, M·C) partials; `grad_sum` (`csrc/fixed_sum.cuh`) adds the partials over
the blocks in the same fixed order. Sums in f32 with no atomic, so a launch repeats
its bits, and `gather_grad_plain` repeats them on any device.

`gather_grad` launches the kernel for CUDA tensors (two launches) and runs the plain
version for CPU tensors.
"""

from __future__ import annotations

import torch

from oclpathtracer_tpu_torch.kernels.megakernel import SMEM_TABLE_MAX_BYTES
from oclpathtracer_tpu_torch.runtime import profiling

BLOCK = 128  # threads a block (csrc/trace.cuh)
WARPS = BLOCK // 32
ROWS = 4     # rows a thread (csrc/gather_grad.cu GATHER_ROWS)


def fits(m: int, c: int) -> bool:
    """Whether an (m, c) table's slots, one set a thread and one a warp, fit in a
    block's shared memory: the kernel takes it, else it refuses the launch."""
    return (BLOCK + WARPS) * m * c * 4 <= SMEM_TABLE_MAX_BYTES


def _check(idx: torch.Tensor, grad: torch.Tensor, m: int) -> None:
    if idx.dtype not in (torch.int32, torch.int64) or idx.dim() != 1:
        raise ValueError(f"idx must be a 1-D int32 or int64 tensor, got {tuple(idx.shape)} "
                         f"{idx.dtype}")
    if grad.dtype != torch.float32 or grad.dim() != 2 or grad.shape[0] != idx.shape[0]:
        raise ValueError(f"grad must be ({idx.shape[0]}, C) float32, got "
                         f"{tuple(grad.shape)} {grad.dtype}")
    if grad.device != idx.device:
        raise ValueError("idx and grad must be on one device")
    if m < 1 or grad.shape[1] < 1 or not fits(m, grad.shape[1]):
        raise ValueError(f"a ({m}, {grad.shape[1]}) table does not fit the kernel's shared "
                         f"memory ({SMEM_TABLE_MAX_BYTES} bytes a block)")


# ---- plain PyTorch version -----------------------------------------------------

def _block_sum(x: torch.Tensor) -> torch.Tensor:
    """(..., BLOCK, S) -> (..., S): the kernels' block reduction, a shuffle tree in
    each warp (lane i adds lane i + off, off = 16, 8, 4, 2, 1), then the warps' sums
    in order."""
    x = x.reshape(*x.shape[:-2], WARPS, 32, x.shape[-1])
    off = 16
    while off:
        x = x[..., :off, :] + x[..., off:2 * off, :]
        off //= 2
    total = x[..., 0, 0, :]
    for w in range(1, WARPS):
        total = total + x[..., w, 0, :]
    return total


def gather_grad_plain(idx: torch.Tensor, grad: torch.Tensor, m: int) -> torch.Tensor:
    """The kernel's plain version: (m, C) f32, in the kernel's order of addition.
    Thread t of block b adds the rows b·BLOCK·ROWS + k·BLOCK + t, k = 0..ROWS-1, in
    order from 0 into its slots (a slot the row does not select adds 0, which leaves
    the bits of a slot that started at +0 as they are), then `_block_sum` gives the
    block's row of partials; thread j of grad_sum adds the rows j, j + BLOCK, ... in
    order from 0, and `_block_sum` again gives each slot."""
    _check(idx, grad, m)
    n, c = grad.shape
    dev = grad.device
    per_block = BLOCK * ROWS
    n_blocks = -(-n // per_block)
    pad = n_blocks * per_block - n
    idx = idx.to(torch.int64)
    idx = torch.where(idx < 0, idx + m, idx)
    idx = torch.cat([idx, torch.full((pad,), -1, dtype=torch.int64, device=dev)])
    idx = idx.reshape(n_blocks, ROWS, BLOCK)
    g = torch.cat([grad, torch.zeros((pad, c), dtype=torch.float32, device=dev)])
    g = g.reshape(n_blocks, ROWS, BLOCK, 1, c)
    rows = torch.arange(m, device=dev)
    slots = torch.zeros((n_blocks, BLOCK, m, c), dtype=torch.float32, device=dev)
    for k in range(ROWS):
        sel = (idx[:, k, :, None] == rows)[..., None]
        slots = slots + torch.where(sel, g[:, k], 0.0)
    partials = _block_sum(slots.reshape(n_blocks, BLOCK, m * c))
    n_runs = -(-n_blocks // BLOCK)
    partials = torch.cat([partials, torch.zeros((n_runs * BLOCK - n_blocks, m * c),
                                                dtype=torch.float32, device=dev)])
    acc = torch.zeros((BLOCK, m * c), dtype=torch.float32, device=dev)
    for j in range(n_runs):
        acc = acc + partials[j * BLOCK:(j + 1) * BLOCK]
    return _block_sum(acc).reshape(m, c)


# ---- the kernel's entry point ----------------------------------------------------

@profiling.spanned("kernel.gather_grad")
def gather_grad(idx: torch.Tensor, grad: torch.Tensor, m: int) -> torch.Tensor:
    """grad_table (m, C) f32 for idx (N,) int32 or int64 and grad (N, C) f32: the sum
    of the rows of `grad` whose index selects each table row (an index below 0 counts
    from the end, as in torch's indexing). CUDA tensors launch `csrc/gather_grad.cu`;
    CPU tensors run the plain version."""
    _check(idx, grad, m)
    if idx.device.type == "cpu":
        return gather_grad_plain(idx, grad, m)
    from oclpathtracer_tpu_torch.kernels import cuda_build

    n, c = grad.shape
    out = torch.empty((m, c), dtype=torch.float32, device=grad.device)
    if n == 0:
        return out.zero_()
    partials = torch.empty((-(-n // (BLOCK * ROWS)), m * c), dtype=torch.float32,
                           device=grad.device)
    cuda_build.launch("opt_gather_grad_launch", (idx.contiguous(), grad.contiguous()), (),
                      [n, m, c, int(idx.dtype == torch.int64)], partials, out)
    profiling.count("launch.gather_grad")
    return out
