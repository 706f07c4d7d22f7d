"""The material gathers' backward (`core/gather.py` gather_rows, `kernels/gather_grad.py`).

On the CPU: gather_rows is plain indexing with autograd's own backward, bit for bit,
and never launches the kernel; the kernel's plain version `gather_grad_plain` repeats
a thread-by-thread emulation of `csrc/gather_grad.cu`'s order of addition bit for bit
and agrees with a float64 sum. On the card (marker `cuda`; run with `python -m pytest
--noconftest tests/test_torch_gather_grad.py -q`, this file imports no jax): the kernel
bit for bit its plain version at the inverse-rendering cell's shape (the Cornell box's
mat_ids at 256², an (18, 3) table), at a row count no multiple of a block with more
blocks than a block has threads, and for a 1-D table; a rerun the same bits; within
1e-6 of the float64 sum, and as close to autograd's index_put_ gradient as that one
is to the float64 sum (index_put_ adds in series in f32: about 1.7e-6 off it at the
cell's shape), for one gather and for one twin step's leaves; that step's launches;
a table past the shared-memory cap falling back to autograd. Whether there is a card
is decided inside the fixture, never at import.
"""

import numpy as np
import pytest
import torch

from oclpathtracer_tpu_torch.core.gather import gather_rows
from oclpathtracer_tpu_torch.kernels import gather_grad as gg
from oclpathtracer_tpu_torch.runtime import profiling

torch.set_num_threads(1)

CELL_SIZE = 256  # the inverse-rendering cells: 256², 4 bounces, 8 spp
CELL_BOUNCES = 4
CELL_SPP = 8


def _counts(*names):
    now = profiling.counts()
    return tuple(now.get(n, 0) for n in names)


def _inputs(n, m, c, seed=0, dtype=torch.int32, device="cpu"):
    r = np.random.default_rng(seed)
    idx = torch.from_numpy(r.integers(-m, m, size=n)).to(dtype).to(device)
    grad = torch.from_numpy(r.normal(size=(n, c)).astype(np.float32)).to(device)
    return idx, grad


def _emulated(idx, grad, m):
    """csrc/gather_grad.cu thread by thread in float32: each thread's rows in order into
    its slots, the shuffle tree in each warp (lane i adds lane i + off), the warps in
    order; grad_sum's thread j adding the blocks j, j + 128, ... in order, then the
    same block reduction."""
    idx, grad = idx.numpy().astype(np.int64), grad.numpy()
    n, c = grad.shape
    per_block = gg.BLOCK * gg.ROWS
    n_blocks = -(-n // per_block)
    slots = np.zeros((n_blocks, gg.BLOCK, m * c), np.float32)
    for b in range(n_blocks):
        for t in range(gg.BLOCK):
            for k in range(gg.ROWS):
                i = b * per_block + k * gg.BLOCK + t
                if i >= n:
                    break
                row = idx[i] + m if idx[i] < 0 else idx[i]
                if 0 <= row < m:
                    for ch in range(c):
                        slots[b, t, row * c + ch] += grad[i, ch]

    def block(v):
        sums = []
        for w in range(gg.WARPS):
            lanes = v[32 * w:32 * (w + 1)].copy()
            for off in (16, 8, 4, 2, 1):
                lanes = np.stack([lanes[i] + lanes[i + off] if i + off < 32 else lanes[i]
                                  for i in range(32)])
            sums.append(lanes[0])
        total = sums[0]
        for s in sums[1:]:
            total = total + s
        return total

    partials = np.stack([block(slots[b]) for b in range(n_blocks)])
    acc = np.zeros((gg.BLOCK, m * c), np.float32)
    for j in range(gg.BLOCK):
        for b in range(j, n_blocks, gg.BLOCK):
            acc[j] = acc[j] + partials[b]
    return torch.from_numpy(block(acc).reshape(m, c))


# ---- CPU ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(18, 3), (18,)], ids=["2-D", "1-D"])
@pytest.mark.parametrize("requires_grad", [True, False])
def test_gather_rows_on_cpu_is_plain_indexing_bitwise(shape, requires_grad):
    r = np.random.default_rng(1)
    base = torch.from_numpy(r.normal(size=shape).astype(np.float32))
    idx = torch.from_numpy(r.integers(0, shape[0], size=4099)).to(torch.int32)
    w = torch.from_numpy(r.normal(size=(4099, *shape[1:])).astype(np.float32))
    before = _counts("launch.gather_grad", "gather_grad.fallback")
    a = base.clone().requires_grad_(requires_grad)
    b = base.clone().requires_grad_(requires_grad)
    got, want = gather_rows(a, idx), b[idx]
    assert torch.equal(got, want)
    if requires_grad:
        assert torch.equal(torch.autograd.grad((got * w).sum(), a)[0],
                           torch.autograd.grad((want * w).sum(), b)[0])
    assert _counts("launch.gather_grad", "gather_grad.fallback") == before


@pytest.mark.parametrize("n, m, c", [(1000, 5, 3), (70_001, 18, 3), (3_000, 7, 1)],
                         ids=["one block", "137 blocks", "1-D"])
def test_gather_grad_plain_is_the_kernels_order_bitwise(n, m, c):
    idx, grad = _inputs(n, m, c, seed=n)
    assert torch.equal(gg.gather_grad_plain(idx, grad, m), _emulated(idx, grad, m))


@pytest.mark.parametrize("n, m, c, dtype", [(65_536, 18, 3, torch.int32),
                                            (70_001, 18, 3, torch.int64),
                                            (4_099, 18, 1, torch.int32)],
                         ids=["cell shape", "uneven int64", "1-D"])
def test_gather_grad_plain_matches_a_float64_sum(n, m, c, dtype):
    idx, grad = _inputs(n, m, c, seed=7, dtype=dtype)
    want = torch.zeros((m, c), dtype=torch.float64).index_add_(
        0, torch.where(idx < 0, idx + m, idx).long(), grad.double())
    got = gg.gather_grad_plain(idx, grad, m).double()
    assert float((got - want).norm() / want.norm()) < 1e-6
    assert torch.equal(gg.gather_grad(idx, grad, m), gg.gather_grad_plain(idx, grad, m))


@pytest.mark.parametrize("case", ["float64 grad", "int16 idx", "2-D idx", "past the cap"])
def test_gather_grad_refuses_what_the_kernel_does_not_take(case):
    idx, grad, m = *_inputs(64, 18, 3), 18
    if case == "float64 grad":
        grad = grad.double()
    elif case == "int16 idx":
        idx = idx.to(torch.int16)
    elif case == "2-D idx":
        idx = idx.reshape(8, 8)
    else:
        m = 600
    assert gg.fits(18, 3) and not gg.fits(600, 3)
    with pytest.raises(ValueError):
        gg.gather_grad(idx, grad, m)


@pytest.mark.parametrize("shape", [(18, 3), (18,)], ids=["2-D", "1-D"])
def test_gather_rows_function_gives_the_plain_versions_gradient(shape):
    """The autograd Function the card takes, run on the CPU (its backward then runs the
    kernel's plain version): the forward is table[idx] bit for bit, the gradient the
    plain version's of the flattened rows, in the table's shape."""
    from oclpathtracer_tpu_torch.core.gather import _GatherRows

    idx, w = _inputs(4099, 18, 3 if len(shape) == 2 else 1, seed=2)
    w = w.reshape(4099, *shape[1:])
    base = torch.from_numpy(np.random.default_rng(3).normal(size=shape).astype(np.float32))
    a = base.clone().requires_grad_()
    out = _GatherRows.apply(a, idx)
    assert torch.equal(out, base[idx])
    got = torch.autograd.grad((out * w).sum(), a)[0]
    assert torch.equal(got, gg.gather_grad_plain(idx, w.reshape(4099, -1), 18).reshape(shape))


# ---- on the card -------------------------------------------------------------------

@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU or interpret mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def cornell_ids(card):
    """The Cornell box's mat_id of every pixel's primary hit at 256²: 65,536 rows onto
    the 18 materials."""
    from oclpathtracer_tpu_torch.config import RenderConfig
    from oclpathtracer_tpu_torch.kernels import selfcheck
    from oclpathtracer_tpu_torch.scene import load_cornell_box

    scene = load_cornell_box(device=card)
    ids = selfcheck.primary_mat_ids(scene, RenderConfig(CELL_SIZE, CELL_SIZE))
    return ids, scene.materials.num_materials


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["cell shape", "uneven 70001 int64", "1-D table"])
def test_kernel_is_its_plain_version_bitwise_and_repeats(card, cornell_ids, case):
    ids, m = cornell_ids
    if case == "cell shape":
        idx, c = ids, 3
    elif case == "uneven 70001 int64":
        idx, c = torch.cat([ids, ids[:70_001 - ids.shape[0]]]).long(), 3
    else:
        idx, c = ids, 1
    _, grad = _inputs(idx.shape[0], m, c, seed=3, device=card)
    before = _counts("launch.gather_grad")
    got = gg.gather_grad(idx, grad, m)
    again = gg.gather_grad(idx, grad, m)
    torch.cuda.synchronize()
    assert _counts("launch.gather_grad") == (before[0] + 2,)
    assert torch.equal(got, gg.gather_grad_plain(idx, grad, m))
    assert torch.equal(got, again)


class _ExactGather(torch.autograd.Function):
    """table[idx] whose backward sums each table row's gradient in float64, then rounds
    once: the exact sum that both f32 backwards approximate."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.table_shape = table.shape
        return table[idx]

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        g = grad.reshape(idx.numel(), -1).double()
        out = torch.zeros((ctx.table_shape[0], g.shape[1]), dtype=torch.float64,
                          device=g.device).index_add_(0, idx.reshape(-1).long(), g)
        return out.float().reshape(ctx.table_shape), None


def _exact_rows(table, idx):
    return _ExactGather.apply(table, idx) if table.requires_grad else table[idx]


def _gap(got, want):
    return float((got.double() - want.double()).norm() / want.double().norm())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(18, 3), (18,)], ids=["2-D", "1-D"])
def test_gather_rows_on_the_card_keeps_the_forward_and_sums_closer_than_autograd(
        card, cornell_ids, shape):
    """Forward bit for bit table[idx]; the gradient within 1e-6 (over its norm) of the
    float64 sum, and as close to autograd's index_put_ gradient as that one is to the
    float64 sum, plus 1e-6: index_put_ adds a row's duplicates in series in f32, about
    1.7e-6 off the float64 sum at this shape, the kernel's tree under 1e-7."""
    ids, m = cornell_ids
    r = np.random.default_rng(5)
    base = torch.from_numpy(r.normal(size=(m, *shape[1:])).astype(np.float32)).to(card)
    w = torch.from_numpy(r.normal(size=(ids.shape[0], *shape[1:])).astype(np.float32)).to(card)
    a, b, e = (base.clone().requires_grad_() for _ in range(3))
    got, want = gather_rows(a, ids), b[ids]
    assert torch.equal(got, want)
    g_kernel = torch.autograd.grad((got * w).sum(), a)[0]
    g_autograd = torch.autograd.grad((want * w).sum(), b)[0]
    g_exact = torch.autograd.grad((_exact_rows(e, ids) * w).sum(), e)[0]
    gaps = (_gap(g_kernel, g_exact), _gap(g_autograd, g_exact), _gap(g_kernel, g_autograd))
    assert gaps[0] < 1e-6 and gaps[2] < gaps[1] + 1e-6, gaps


@pytest.mark.cuda
def test_twin_step_launches_the_kernel_for_each_reached_gather(card, monkeypatch):
    """One value_and_grad of make_train_step's loss at 256² b4 8 spp: the backward reaches
    each sample's 4 emissive and 3 albedo gathers (the last bounce's albedo feeds only
    the mask, which nothing reads after it), one kernel call each, and no fallback. The
    loss is bit for bit the one through plain indexing; each leaf's gradient is within
    1e-6 (over its norm) of the one whose gathers sum in float64, and as close to
    plain indexing's as that one is to it, plus 1e-6."""
    from oclpathtracer_tpu_torch.config import RenderConfig
    from oclpathtracer_tpu_torch.core import rng
    from oclpathtracer_tpu_torch.diff import inverse
    from oclpathtracer_tpu_torch.integrators import path
    from oclpathtracer_tpu_torch.scene import load_cornell_box

    scene = load_cornell_box(device=card)
    cfg = RenderConfig(CELL_SIZE, CELL_SIZE, bounces=CELL_BOUNCES)
    params = inverse.extract_params(scene, albedo=True, emissive=True)
    loss_fn = inverse.make_loss_fn(scene, cfg, CELL_SPP)
    key = rng.make_key(11, card)
    target = torch.full((cfg.n_pixels, 3), 0.5, device=card)
    before = _counts("launch.gather_grad", "gather_grad.fallback")
    loss, grads = inverse.value_and_grad(loss_fn, params, target, key)
    torch.cuda.synchronize()
    after = _counts("launch.gather_grad", "gather_grad.fallback")
    assert after[0] - before[0] == CELL_SPP * (2 * CELL_BOUNCES - 1)
    assert after[1] == before[1]
    monkeypatch.setattr(path, "gather_rows", lambda table, idx: table[idx])
    plain_loss, plain = inverse.value_and_grad(loss_fn, params, target, key)
    monkeypatch.setattr(path, "gather_rows", _exact_rows)
    _, exact = inverse.value_and_grad(loss_fn, params, target, key)
    assert torch.equal(loss, plain_loss)
    for g, p, e in zip(*(inverse.params_leaves(x) for x in (grads, plain, exact))):
        gaps = (_gap(g, e), _gap(p, e), _gap(g, p))
        assert gaps[0] < 1e-6 and gaps[2] < gaps[1] + 1e-6, gaps


@pytest.mark.cuda
def test_a_table_past_the_cap_falls_back_to_autograd_bitwise(card):
    m = 600
    assert not gg.fits(m, 3)
    idx, w = _inputs(65_536, m, 3, seed=9, device=card)
    idx = torch.where(idx < 0, idx + m, idx)
    base = torch.rand((m, 3), device=card)
    a, b = base.clone().requires_grad_(), base.clone().requires_grad_()
    before = _counts("launch.gather_grad", "gather_grad.fallback")
    got = torch.autograd.grad((gather_rows(a, idx) * w).sum(), a)[0]
    assert _counts("launch.gather_grad", "gather_grad.fallback") == (before[0], before[1] + 1)
    assert torch.equal(got, torch.autograd.grad((b[idx] * w).sum(), b)[0])
