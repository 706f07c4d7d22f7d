"""Sorted wavefront: per-bounce kernel launches over ray state in device memory.

Counterpart of `oclpathtracer_tpu.kernels.sorted_wavefront`. The fused kernels keep
whole paths in one thread; this renderer keeps every path of `n_samples` frames in
device memory (`RayState`: o, d, mask, rad, live, rng, a 64-byte row a ray; R =
pixels × samples) and advances it one segment a launch of the bounce kernel
(`csrc/sorted_wavefront.cu`): the skip-link walk with parity leaves, then the
megakernel's shading. The first launch starts the rays from the
camera (ray r: pixel r mod n_pix, sample start + r div n_pix). Each launch writes
the slots still live after it to a list on the device (`LiveLists`, two lists
written in turn), and the next launch traces only those, reading the list's count
from device memory: the host neither waits for a launch nor learns how many rays
are live. The host params are packed and the tables' alignment checked once a call
(`Bounce.of`); a launch sets only its mode and which list it writes.

With `sort=True` the rays are traced in `_sort_key`'s order (direction octant,
then a 16³ cell of the origin in the BVH root box; dead rays last): each launch
writes the key of every ray it traces, and a stable argsort of the keys in torch
(as the JAX package sorts in XLA) becomes the next launch's list, whose first
`count` entries are the live slots. The JAX package gathers the state into that
order; here no state moves, each ray keeps its slot. At the end max(rad, 0) of
each slot is added in sample order, so the image equals the skip-link kernel's
(`render_samples_bvh_stats`, parity, same leaf size) bit for bit, with the sort on
or off. The JAX package's own version agrees with its BVH kernel only within 1e-5:
it builds its camera in jnp and scatter-adds the pixels.

The JAX package measured on its chip that the sort buys no traversal time
(`sorted_wavefront.py:30-40` there), so `sort=False` is the default. Its SMEM
placement switch for the tables schedules the TPU only and has no counterpart.

`_bounce_step` launches the kernel for CUDA tensors and runs its plain version
(`_bounce_plain`: `bvh_megakernel._skip_walk_nearest` and `megakernel._shade`, the
same f32 operations vectorized over the traced rays) for CPU tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from oclpathtracer_tpu_torch.config import RenderConfig
from oclpathtracer_tpu_torch.kernels import bvh_megakernel as bk
from oclpathtracer_tpu_torch.kernels import megakernel as mk
from oclpathtracer_tpu_torch.kernels import rng as krng
from oclpathtracer_tpu_torch.runtime import profiling
from oclpathtracer_tpu_torch.scene.types import Scene

# Origin-cell quantization for the sort key: 16^3 cells x 8 octants = 32k bins.
_CELLS = 16


# The bounce launch's modes (csrc/sorted_wavefront.cu MODE_*): start every ray from
# the camera; trace the first `count` entries of the other list.
MODE_FIRST, MODE_LIST = 0, 1


# A ray's state row (csrc/sorted_wavefront.cu load_state): o 0:3 | d 3:6 | mask 6:9 |
# rad 9:12 | live 12 | rng 13 (u32 bits) | 14:16 unused; 64 bytes, 4 float4s.
STATE_COLS = 16
_LIVE, _RNG = 12, 13
# The live lists' counters, one 128-byte line each (csrc COUNTER_STRIDE ints).
_COUNTER_STRIDE = 32


class RayState(NamedTuple):
    """The ray state, one (R, STATE_COLS) f32 row a ray, so that the kernel reads and
    writes a ray in four 16-byte accesses of its own row whichever rays a warp
    traces. o, d, mask and rad are (3, R) views, live (R,) f32 (1 live, 0 dead) and
    rng (R,) the u32 bits as int32, views of the rows."""

    rows: torch.Tensor

    @staticmethod
    def empty(n: int, device) -> "RayState":
        return RayState(torch.empty((n, STATE_COLS), dtype=torch.float32, device=device))

    def vec(self, c: int) -> torch.Tensor:
        return self.rows[:, c:c + 3].t()

    @property
    def o(self):
        return self.vec(0)

    @property
    def d(self):
        return self.vec(3)

    @property
    def mask(self):
        return self.vec(6)

    @property
    def rad(self):
        return self.vec(9)

    @property
    def live(self):
        return self.rows[:, _LIVE]

    @property
    def rng(self):
        return self.rows[:, _RNG].view(torch.int32)


class LiveLists(NamedTuple):
    """The two live lists a call's launches write in turn: slots (2, R) i32, and
    counts (4, 32) i32, whose column 0 holds the count and queue head of list 0,
    then of list 1 (a row each, so that no two counters share a 128-byte line). A
    launch that writes list `dst` zeroes its two first, in stream order, and reads
    list 1 - dst. With the sort on, keys (R,) i32 holds each ray's `_sort_key` as of
    the last launch that traced it."""

    slots: torch.Tensor
    counts: torch.Tensor
    keys: torch.Tensor | None = None

    @staticmethod
    def empty(n: int, device, sort: bool = False) -> "LiveLists":
        keys = torch.empty((n,), dtype=torch.int32, device=device) if sort else None
        return LiveLists(torch.empty((2, n), dtype=torch.int32, device=device),
                         torch.zeros((4, _COUNTER_STRIDE), dtype=torch.int32, device=device),
                         keys)

    def count(self, b: int) -> torch.Tensor:
        """List b's count, on the device."""
        return self.counts[2 * b, 0]


class Bounce(NamedTuple):
    """What every bounce launch of a call shares: the tables, the config, the first
    sample and the pixel count, and on CUDA tables the kernel's launch with its host
    params packed and its tables' alignment checked once a call."""

    table: torch.Tensor
    nodes_f: torch.Tensor
    nodes_i: torch.Tensor
    cfg: RenderConfig
    start_sample: int
    n_pix: int
    launch: object = None  # cuda_build.Launch, None on the CPU

    @staticmethod
    def of(table, nodes_f, nodes_i, cfg: RenderConfig, start_sample: int, n_rays: int,
           n_pix: int) -> "Bounce":
        if table.device.type == "cpu":
            return Bounce(table, nodes_f, nodes_i, cfg, start_sample, n_pix)
        from oclpathtracer_tpu_torch.kernels import cuda_build

        bk.check_aligned16(table=table, nodes_f=nodes_f, nodes_i=nodes_i)
        floats, ints = mk.host_params(cfg, "parity", (), False, table.shape[0], start_sample, 1,
                                      0, n_rays, n_nodes=nodes_f.shape[0])
        launch = cuda_build.Launch("opt_sorted_bounce_launch", (table, nodes_f, nodes_i), floats,
                                   ints + [MODE_FIRST, n_pix, 0])
        return Bounce(table, nodes_f, nodes_i, cfg, start_sample, n_pix, launch)


def _bounce_plain(ctx: Bounce, state: RayState, lists: LiveLists, segs: torch.Tensor,
                  mode: int, dst: int) -> None:
    """The bounce kernel's plain PyTorch version, in place: the rays of `mode` (every
    ray, started from the camera; or the first `count` entries of list 1 - dst) take
    one segment and write their sort keys (with the sort on), the others keep their
    state, and the slots still live go to list `dst` in the order traced (the
    kernel's order is its warps')."""
    k = mk._Consts.of(ctx.cfg)
    n = state.live.shape[0]
    dev = ctx.table.device
    vecs = (state.o, state.d, state.mask, state.rad)
    if mode == MODE_FIRST:
        r = torch.arange(n, dtype=torch.int64, device=dev)
        path = mk._camera_path(k, ctx.cfg, r % ctx.n_pix, int(ctx.start_sample) + r // ctx.n_pix)
    else:
        src = 1 - dst
        r = lists.slots[src, :int(lists.count(src))].to(torch.int64)
        path = (*(tuple(x[:, r]) for x in vecs), torch.ones_like(r, dtype=torch.bool),
                state.rng[r].to(torch.int64) & krng.MASK32)
    segs += r.shape[0]
    nearest = bk._skip_walk_nearest(mk._PlainScene(ctx.table, (), "parity"), ctx.nodes_f,
                                    ctx.nodes_i)
    new = mk._shade(k, path, nearest(0, path[0], path[1], path[4]))
    for vec, val in zip(vecs, new[:4]):
        vec[:, r] = torch.stack(val)
    state.live[r] = new[4].to(torch.float32)
    state.rng[r] = new[5].to(torch.int32)
    if lists.keys is not None:
        root = ctx.nodes_f[0]
        lists.keys[r] = _sort_key(new[0], new[1], new[4].to(torch.float32), root[0:3],
                                  root[3:6])
    kept = r[new[4]]
    lists.slots[dst, :kept.shape[0]] = kept.to(torch.int32)
    lists.counts[2 * dst:2 * dst + 2, 0] = torch.tensor([kept.shape[0], 0], dtype=torch.int32)


def _bounce_step(ctx: Bounce, state: RayState, lists: LiveLists, segs: torch.Tensor,
                 mode: int, dst: int) -> None:
    """One segment for every ray of `mode`, in place (see _bounce_plain); `segs` (1,)
    int64 gains the rays traced. A CUDA table launches `csrc/sorted_wavefront.cu`; a
    CPU table runs the plain version."""
    if ctx.launch is None:
        return _bounce_plain(ctx, state, lists, segs, mode, dst)
    ints = ctx.launch.ints
    ints[len(ints) - 3] = mode
    ints[len(ints) - 1] = dst
    bk.check_aligned16(state=state.rows)
    ctx.launch(state.rows, segs, *lists)
    profiling.count("launch.sorted")


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
    """All bounces of the n_samples frames: (final state, segments (1,) int64)."""
    n_pix = cfg.n_pixels
    n = n_pix * n_samples
    dev = table.device
    ctx = Bounce.of(table, nodes_f, nodes_i, cfg, start_sample, n, n_pix)
    state, lists = RayState.empty(n, dev), LiveLists.empty(n, dev, sort)
    segs = torch.zeros((1,), dtype=torch.int64, device=dev)
    for b in range(cfg.bounces):
        if b > 0 and sort:  # the live slots first, in key order: the next launch's list
            lists.slots[1 - b % 2] = torch.argsort(lists.keys, stable=True)
        step(ctx, state, lists, segs, MODE_FIRST if b == 0 else MODE_LIST, b % 2)
    return state, segs


def _assemble(rad: torch.Tensor, n_pix: int, n_samples: int):
    """max(rad, 0) of each slot (ray r: pixel r mod n_pix of sample r div n_pix), the
    samples added in order: (n_pix, 3)."""
    paths = torch.clamp(rad, min=0.0).t().reshape(n_samples, n_pix, 3)
    acc = torch.zeros((n_pix, 3), dtype=torch.float32, device=rad.device)
    for s in range(n_samples):
        acc = acc + paths[s]
    return acc


def _render_sorted_stats(step, table, nodes_f, nodes_i, cfg, start_sample, n_samples,
                         max_leaf, sort):
    bk.check_bvh_call(table, nodes_f, nodes_i, cfg, n_samples, max_leaf, "parity", (), 8, 4)
    state, segs = _trace_sorted(step, table, nodes_f, nodes_i, cfg, start_sample, n_samples,
                                sort)
    return _assemble(state.rad, cfg.n_pixels, n_samples), segs[0]


def _render_samples_sorted_stats_plain(table, nodes_f, nodes_i, cfg: RenderConfig,
                                       start_sample: int, n_samples: int, max_leaf: int = 32,
                                       sort: bool = False):
    """The sorted wavefront with the bounce kernel's plain version on any device."""
    return _render_sorted_stats(_bounce_plain, table, nodes_f, nodes_i, cfg, start_sample,
                                n_samples, max_leaf, sort)


@profiling.spanned("kernel.sorted")
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
    """Progressive mean image via the sorted wavefront, on the scene's device. The
    skip-link build of every call is the span `sorted.prepare`."""
    with profiling.span("sorted.prepare"):
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
