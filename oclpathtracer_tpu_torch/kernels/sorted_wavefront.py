"""Sorted wavefront: per-bounce kernel launches over ray state in device memory.

Counterpart of `oclpathtracer_tpu.kernels.sorted_wavefront`. The fused kernels keep
whole paths in one thread; this renderer keeps every path of `n_samples` frames in
a structure-of-arrays state in device memory (o, d, mask, rad (3, R) f32, live (R,)
f32, rng (R,) u32, R = pixels × samples) and advances it one segment a launch of
the bounce kernel (`csrc/sorted_wavefront.cu`): the skip-link walk with parity
leaves, then the megakernel's shading. The first launch starts the rays from the
camera (ray r: pixel r mod n_pix, sample start + r div n_pix).

Between launches, with `sort=True`, the state is reordered by `_sort_key`
(direction octant, then a 16³ cell of the origin in the BVH root box; dead rays
last), with a stable argsort and gathers in torch, as the JAX package does in XLA.
The ray index rides along. At the end max(rad, 0) goes back to each ray's index (a
permutation write) and the samples are added in order, so the image equals the
skip-link kernel's (`render_samples_bvh_stats`, parity, same leaf size) bit for bit,
with the sort on or off. The JAX package's own version agrees with its BVH kernel
only within 1e-5: it builds its camera in jnp and scatter-adds the pixels.

The JAX package measured on its chip that the sort buys no traversal time
(`sorted_wavefront.py:30-40` there), so `sort=False` is the default. Its SMEM
placement switch for the tables schedules the TPU only and has no counterpart.

`_bounce_step` launches the kernel for CUDA tensors and runs its plain version
(`_bounce_plain`: `bvh_megakernel._skip_walk_nearest` and `megakernel._shade`, the
same f32 operations vectorized over rays) for CPU tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from oclpathtracer_tpu_torch.config import RenderConfig
from oclpathtracer_tpu_torch.kernels import bvh_megakernel as bk
from oclpathtracer_tpu_torch.kernels import megakernel as mk
from oclpathtracer_tpu_torch.kernels import rng as krng
from oclpathtracer_tpu_torch.scene.types import Scene

# Origin-cell quantization for the sort key: 16^3 cells x 8 octants = 32k bins.
_CELLS = 16

# Bounce-kernel launches made by _bounce_step on CUDA tensors.
LAUNCHES = 0


class RayState(NamedTuple):
    """The SoA ray state; rng holds u32 bits in int32."""

    o: torch.Tensor
    d: torch.Tensor
    mask: torch.Tensor
    rad: torch.Tensor
    live: torch.Tensor
    rng: torch.Tensor

    @staticmethod
    def empty(n: int, device) -> "RayState":
        def f(*shape):
            return torch.empty(shape, dtype=torch.float32, device=device)

        return RayState(f(3, n), f(3, n), f(3, n), f(3, n), f(n),
                        torch.empty((n,), dtype=torch.int32, device=device))

    def gather(self, perm: torch.Tensor) -> "RayState":
        return RayState(*(x[..., perm] for x in self))


def _bounce_plain(table, nodes_f, nodes_i, cfg: RenderConfig, state: RayState,
                  segs: torch.Tensor, first: bool, start_sample: int, n_pix: int) -> None:
    """The bounce kernel's plain PyTorch version, in place: live rays (every ray on
    the first launch, started from the camera) take one segment; dead rays keep
    their state."""
    k = mk._Consts.of(cfg)
    n = state.live.shape[0]
    if first:
        r = torch.arange(n, dtype=torch.int64, device=table.device)
        path = mk._camera_path(k, cfg, r % n_pix, int(start_sample) + r // n_pix)
    else:
        live = state.live > 0.5
        path = (*(tuple(x) for x in state[:4]), live,
                state.rng.to(torch.int64) & krng.MASK32)
    live = path[4]
    segs += live.sum()
    nearest = bk._skip_walk_nearest(mk._PlainScene(table, (), "parity"), nodes_f, nodes_i)
    new = mk._shade(k, path, nearest(0, path[0], path[1], live))
    for dst, old, val in zip(state[:4], path[:4], new[:4]):
        dst.copy_(torch.stack(mk._where3(live, val, old)))
    state.live.copy_(torch.where(live, new[4].to(torch.float32), state.live))
    state.rng.copy_(torch.where(live, new[5], path[5]).to(torch.int32))


def _bounce_step(table, nodes_f, nodes_i, cfg: RenderConfig, state: RayState,
                 segs: torch.Tensor, first: bool, start_sample: int, n_pix: int) -> None:
    """One segment for every live ray of `state`, in place; `segs` (1,) int64 gains
    the rays traced. A CUDA table launches `csrc/sorted_wavefront.cu`; a CPU table
    runs the plain version."""
    global LAUNCHES
    if table.device.type == "cpu":
        return _bounce_plain(table, nodes_f, nodes_i, cfg, state, segs, first, start_sample,
                             n_pix)
    from oclpathtracer_tpu_torch.kernels import cuda_build

    bk.check_aligned16(table=table, nodes_f=nodes_f, nodes_i=nodes_i)
    floats, ints = mk.host_params(cfg, "parity", (), False, table.shape[0], start_sample, 1, 0,
                                  state.live.shape[0], n_nodes=nodes_f.shape[0])
    cuda_build.launch("opt_sorted_bounce_launch", (table, nodes_f, nodes_i), floats,
                      ints + [int(first), n_pix], *state, segs)
    LAUNCHES += 1


def _sort_key(o, d, live, lo, hi):
    """i32 bin: direction octant (major) | origin cell (minor); dead rays last."""
    key = ((d[0] > 0).to(torch.int32) * 4 + (d[1] > 0).to(torch.int32) * 2
           + (d[2] > 0).to(torch.int32))
    for a in range(3):
        q = torch.clamp(((o[a] - lo[a]) / (hi[a] - lo[a] + 1e-9) * _CELLS).to(torch.int32),
                        0, _CELLS - 1)
        key = key * _CELLS + q
    return torch.where(live > 0.5, key, 8 * _CELLS ** 3)


def _trace_sorted(step, table, nodes_f, nodes_i, cfg: RenderConfig, start_sample: int,
                  n_samples: int, sort: bool):
    """All bounces of the n_samples frames: (final state, the ray index of each
    slot, segments (1,) int64)."""
    n_pix = cfg.n_pixels
    n = n_pix * n_samples
    state = RayState.empty(n, table.device)
    ridx = torch.arange(n, dtype=torch.int64, device=table.device)
    segs = torch.zeros((1,), dtype=torch.int64, device=table.device)
    lo, hi = nodes_f[0, 0:3], nodes_f[0, 3:6]  # the BVH root box
    for b in range(cfg.bounces):
        if b > 0 and sort:
            perm = torch.argsort(_sort_key(state.o, state.d, state.live, lo, hi), stable=True)
            state, ridx = state.gather(perm), ridx[perm]
        step(table, nodes_f, nodes_i, cfg, state, segs, b == 0, start_sample, n_pix)
    return state, ridx, segs


def _assemble(rad: torch.Tensor, ridx: torch.Tensor, n_pix: int, n_samples: int):
    """max(rad, 0) back at each ray's index, the samples added in order: (n_pix, 3)."""
    paths = torch.empty((ridx.shape[0], 3), dtype=torch.float32, device=rad.device)
    paths[ridx] = torch.clamp(rad, min=0.0).t()
    paths = paths.reshape(n_samples, n_pix, 3)
    acc = torch.zeros((n_pix, 3), dtype=torch.float32, device=rad.device)
    for s in range(n_samples):
        acc = acc + paths[s]
    return acc


def _render_sorted_stats(step, table, nodes_f, nodes_i, cfg, start_sample, n_samples,
                         max_leaf, sort):
    bk.check_bvh_call(table, nodes_f, nodes_i, cfg, n_samples, max_leaf, "parity", (), 8, 4)
    state, ridx, segs = _trace_sorted(step, table, nodes_f, nodes_i, cfg, start_sample,
                                      n_samples, sort)
    return _assemble(state.rad, ridx, cfg.n_pixels, n_samples), segs[0]


def _render_samples_sorted_stats_plain(table, nodes_f, nodes_i, cfg: RenderConfig,
                                       start_sample: int, n_samples: int, max_leaf: int = 32,
                                       sort: bool = False):
    """The sorted wavefront with the bounce kernel's plain version on any device."""
    return _render_sorted_stats(_bounce_plain, table, nodes_f, nodes_i, cfg, start_sample,
                                n_samples, max_leaf, sort)


def render_samples_sorted_stats(table, nodes_f, nodes_i, cfg: RenderConfig, start_sample: int,
                                n_samples: int, max_leaf: int = 32, sort: bool = False):
    """SUM of `n_samples` progressive frames + traced-segment count: (img (n_pixels, 3)
    f32, segments () int64), as render_samples_bvh_stats returns them (parity leaves;
    the tables are pack_bvh_scene's with leaf size max_leaf). `sort` reorders the ray
    state by coherence between bounces."""
    return _render_sorted_stats(_bounce_step, table, nodes_f, nodes_i, cfg, start_sample,
                                n_samples, max_leaf, sort)


def render_sorted(scene: Scene, cfg: RenderConfig, total_spp: int, samples_per_call: int = 0,
                  leaf_size: int = 32) -> torch.Tensor:
    """Progressive mean image via the sorted wavefront, on the scene's device."""
    table, nodes_f, nodes_i = bk.pack_bvh_scene(scene, leaf_size=leaf_size)
    chunk = samples_per_call or min(total_spp, 8)
    acc = torch.zeros((cfg.n_pixels, 3), dtype=torch.float32, device=table.device)
    s = 0
    while s < total_spp:
        n = min(chunk, total_spp - s)
        img, _ = render_samples_sorted_stats(table, nodes_f, nodes_i, cfg, s, n,
                                             max_leaf=leaf_size)
        acc = acc + img
        s += n
    return acc / total_spp
