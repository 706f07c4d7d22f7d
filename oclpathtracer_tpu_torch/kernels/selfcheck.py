"""Hold the CUDA kernels against their plain PyTorch versions on the card.

Both run on the same CUDA tables: the kernel through its wrapper, the plain version
called directly. They differ only where an ulp flips a hit decision, and one flip
changes the rest of that path, so a case is judged by the share of pixels that
agree and by the segment counts, not by the worst pixel:

  * |segments(kernel) − segments(plain)| ≤ max(2, 1e-5 · segments);
  * at least 99.9% of pixels allclose at rtol = atol = 1e-4.

The adjoint kernel (grad_checks) is held to its plain version more tightly: image
and segments bit for bit, each class row of the gradients within GRAD_REL_TOL of its
largest entry (see compare_grads).

The megakernel (linear_runs_agree) and the arbitrary-ray kernel
(trace_rays_checks) are held to their plain versions bit for bit, images and
segments, at runs of 1, 2 and all samples a lane, as are a ragged pixel range, a
rerun and a table read from global memory. So are the
AO and direct-NEE kernels (fast_integrator_checks), on the whole image, a ragged
pixel range and a table in global memory (AO also at 1, 2 and 32 lanes a pixel,
direct at 1, 2, 8 and 32 and n = 3 and 5 on both routes),
and the sorted wavefront (sorted_checks), which must also give the skip-link
kernel's image and segments bit for bit, with its sort on and off, also on a ray
count that is no multiple of the block and on a call whose rays all die in the
first launch.

Scenes: the Cornell box with its own camera; sphere_field(3, 1, seed=2) (244
triangles, tp-capable), sphere_field() (5,124 triangles, 18 material classes, so
the fast scan) and sphere_field(80, 3) (102,404 triangles) with the JAX package's
camera for procedural scenes; `deep_scene` (488 triangles whose leaf-16 and leaf-32
trees are 14 levels deep) with its own camera.

Used by `chip_smoke.py`, `tests/test_torch_cuda.py` and `tests/test_torch_gather_grad.py`.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from oclpathtracer_tpu_torch.config import CameraConfig, RenderConfig
from oclpathtracer_tpu_torch.core.camera import generate_rays
from oclpathtracer_tpu_torch.core.intersect import intersect_world
from oclpathtracer_tpu_torch.kernels import bvh_megakernel as bk
from oclpathtracer_tpu_torch.kernels import fast_integrators as fi
from oclpathtracer_tpu_torch.kernels import grad_megakernel as gk
from oclpathtracer_tpu_torch.kernels import megakernel as mk
from oclpathtracer_tpu_torch.kernels import sorted_wavefront as sw
from oclpathtracer_tpu_torch.kernels import wavefront as wf
from oclpathtracer_tpu_torch.kernels import wide_bvh as wb
from oclpathtracer_tpu_torch.scene import load_cornell_box
from oclpathtracer_tpu_torch.scene.procgen import sphere_field

RTOL = ATOL = 1e-4
MIN_PIXEL_FRACTION = 0.999
START_SAMPLE = 3
N_SAMPLES = 8  # k = 4 wavefront streams then trace two samples each
BVH_SAMPLES = 2
PROCGEN_EYE = (0.0, 3.0, 9.0)  # the JAX package's camera for procedural scenes
DEEP_EYE = (-0.3, -0.2, -0.25)
# The 8-wide leaf render/driver.py builds for sphere_field() and sphere_field(80, 3)
# (its WIDE_BVH_LEAF; tests/test_torch_bvh.py holds the two equal).
DRIVER_WIDE_LEAF = 6


def deep_scene(device="cuda", n_chain: int = 88, n_fill: int = 400, ratio: float = 2.53):
    """A scene whose BVH is deep: `n_chain` triangles 0.01 across at distances
    ratio**i from the origin along the axes x, y, z in turn, and `n_fill` in a
    0.08-wide cluster at the origin, all facing DEEP_EYE. ratio**3 > 16, so along
    each split's longest centroid axis the farthest triangle sits alone in the top
    of the binned SAH's 16 bins (core/bvh.py) and is peeled off by itself: a node
    takes 7 of the chain, and at leaf 16 (render/driver.py's at this size) and at leaf 32
    the 8-wide tree is 14 levels deep. The farthest lies 2.4e33 from the origin, inside f32."""
    from oclpathtracer_tpu_torch.convert import scene_from_numpy

    i = np.arange(n_chain)
    c = np.zeros((n_chain, 3))
    c[i, i % 3] = ratio ** i
    c = np.concatenate([c, np.random.default_rng(0).uniform(-0.04, 0.04, (n_fill, 3))])
    w = np.asarray(DEEP_EYE) - c
    w /= np.linalg.norm(w, axis=1, keepdims=True)
    a = np.where(np.abs(w[:, :1]) > 0.5, [[0.0, 1.0, 0.0]], [[1.0, 0.0, 0.0]])
    u = np.cross(a, w)
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    v = np.cross(w, u)
    f32, i32 = np.float32, np.int32
    p1, p2, p3 = c - 0.01 * (u + v), c + 0.01 * (u - v), c + 0.01 * v
    geometry = (p1.astype(f32), p2.astype(f32), p3.astype(f32),
                (np.arange(c.shape[0]) % 2).astype(i32))
    materials = (np.array([[0.8, 0.7, 0.6], [0.5, 0.5, 0.5]], f32),
                 np.array([[2, 2, 2], [0, 0, 0]], f32), np.array([0.0, 0.3], f32),
                 np.array([1, 2], i32))
    lights = (np.array([0], i32), np.array([1.0], f32), np.array([[2, 2, 2]], f32))
    return scene_from_numpy(geometry, materials, lights, device=device)


SCENES = {"cornell": load_cornell_box,
          "spheres244": functools.partial(sphere_field, 3, 1, seed=2),
          "spheres5k": sphere_field,
          "spheres102k": functools.partial(sphere_field, 80, 3),
          "deep": deep_scene}


@dataclasses.dataclass(frozen=True)
class Case:
    kernel: str        # "megakernel" | "wavefront" | "bvh" | "widebvh"
    scan: str          # "parity" | "fast" | "tp"
    width: int
    height: int
    bounces: int
    tp0: bool = True   # megakernel only
    interleave: int = 1  # wavefront only
    scene: str = "cornell"
    leaf: int = 32     # BVH kernels only
    run: int | None = None  # linear kernels only: samples a lane takes at a time

    @property
    def name(self) -> str:
        run = "" if self.run is None else f" run={self.run}"
        extra = {"megakernel": f"tp0={int(self.tp0)}{run}",
                 "wavefront": f"k={self.interleave}{run}"}
        return (f"{self.kernel} {self.scan} {extra.get(self.kernel, f'leaf={self.leaf}')} "
                f"{self.scene} {self.width}x{self.height} b{self.bounces}")

    @property
    def cfg(self) -> RenderConfig:
        return scene_cfg(self.scene, self.width, self.height, self.bounces)

    @property
    def n_samples(self) -> int:
        return N_SAMPLES if self.kernel in ("megakernel", "wavefront") else BVH_SAMPLES


def scene_cfg(scene: str, width: int, height: int, bounces: int) -> RenderConfig:
    """The scene's render config: the Cornell box's own camera, deep_scene's looking
    from DEEP_EYE at the origin, else PROCGEN_EYE."""
    if scene == "cornell":
        cam = CameraConfig()
    elif scene == "deep":
        cam = CameraConfig(eye=DEEP_EYE, look=tuple(-x for x in DEEP_EYE))
    else:
        cam = CameraConfig(eye=PROCGEN_EYE)
    return RenderConfig(width=width, height=height, bounces=bounces, camera=cam)


def cases(width: int, height: int, ragged=(100, 77)) -> list:
    """The linear kernels' cases on the Cornell box: megakernel parity, fast, tp with
    tp0 on and off at 4 and 16 bounces; wavefront parity, fast and tp at 16 bounces
    with k = 1 and 4; and a ragged image size that is no multiple of the block."""
    out = []
    for b in (4, 16):
        out += [Case("megakernel", "parity", width, height, b),
                Case("megakernel", "fast", width, height, b),
                Case("megakernel", "tp", width, height, b, tp0=True),
                Case("megakernel", "tp", width, height, b, tp0=False)]
    for scan in ("parity", "fast", "tp"):
        for k in (1, 4):
            out.append(Case("wavefront", scan, width, height, 16, interleave=k))
    if ragged:
        rw, rh = ragged
        out += [Case("megakernel", "parity", rw, rh, 4),
                Case("megakernel", "tp", rw, rh, 4, tp0=True),
                Case("wavefront", "tp", rw, rh, 16, interleave=4)]
    return out


def bvh_cases(width: int, height: int, bounces: int = 4) -> list:
    """The BVH kernels' cases: parity, fast and tp on sphere_field(3, 1) at leaf 32;
    parity and fast on sphere_field() at leaf 32 and at DRIVER_WIDE_LEAF; parity, fast
    and tp on the Cornell box at leaf 4, where every ray hits."""
    out = []
    for scene, scans, leaf in (("spheres244", ("parity", "fast", "tp"), 32),
                               ("spheres5k", ("parity", "fast"), 32),
                               ("spheres5k", ("parity", "fast"), DRIVER_WIDE_LEAF),
                               ("cornell", ("parity", "fast", "tp"), 4)):
        for scan in scans:
            for kernel in ("bvh", "widebvh"):
                out.append(Case(kernel, scan, width, height, bounces, scene=scene, leaf=leaf))
    return out


class Tables:
    """Each scene's packed tables on one device, made at first use. `scenes` adds
    name → scene-maker entries to SCENES."""

    def __init__(self, device, scenes: dict | None = None):
        self.device = device
        self.scenes = {**SCENES, **(scenes or {})}

    @functools.lru_cache(maxsize=None)
    def scene(self, name: str):
        return self.scenes[name](device=self.device)

    @functools.lru_cache(maxsize=None)
    def linear(self, name: str, scan: str):
        """(table, emi_const, classes) of prepare_scan."""
        _, table, emi, classes = mk.prepare_scan(self.scene(name), scan)
        return table, emi, classes

    @functools.lru_cache(maxsize=None)
    def lights(self, name: str):
        """(light_table, total_area) of pack_lights."""
        return fi.pack_lights(self.scene(name))

    @functools.lru_cache(maxsize=None)
    def grad(self, name: str):
        """(table, class_table, n_classes, mat_class) of prepare_grad_scene."""
        return gk.prepare_grad_scene(self.scene(name))

    @functools.lru_cache(maxsize=None)
    def bvh(self, name: str, scan: str, leaf: int):
        """(table, nodes_f, nodes_i, emi_const, classes) of prepare_bvh_scan."""
        return bk.prepare_bvh_scan(self.scene(name), scan, leaf_size=leaf)[1:]

    @functools.lru_cache(maxsize=None)
    def wide(self, name: str, scan: str, leaf: int):
        """(table, wn_f, wn_i, depth, emi_const, classes)."""
        scene = self.scene(name)
        table, wn_f, wn_i, depth, classes = wb.pack_wide_bvh_scene(scene, leaf, scan)
        emi = mk.scene_emissive_const(scene) if scan == "fast" else mk.NO_EMI
        return table, wn_f, wn_i, depth, emi, classes

    @functools.lru_cache(maxsize=None)
    def record(self, name: str, scan: str, leaf: int):
        """group_record of wide(name, scan, leaf)."""
        return wb.group_record(*self.wide(name, scan, leaf)[1:3])

    @functools.lru_cache(maxsize=None)
    def scan_table(self, name: str, scan: str):
        """wavefront.scan_table of linear(name, scan)."""
        return wf.scan_table(self.linear(name, scan)[0], scan)


def run(case: Case, tables: Tables, plain: bool = False, start: int = START_SAMPLE,
        n: int | None = None):
    """(img, segments) of the case's kernel, or of its plain version, on the tables."""
    n = case.n_samples if n is None else n
    cfg = case.cfg
    if case.kernel in ("megakernel", "wavefront"):
        table, emi, classes = tables.linear(case.scene, case.scan)
        if case.kernel == "megakernel":
            if plain:
                return mk._render_samples_stats_plain(table, cfg, start, n, 0, cfg.n_pixels,
                                                      case.scan, classes, case.tp0,
                                                      emi_const=emi)
            return mk.render_samples_pallas_stats(table, cfg, start, n, scan=case.scan,
                                                  classes=classes, tp0=case.tp0,
                                                  emi_const=emi, run=case.run)
        if plain:
            return wf._render_samples_wavefront_plain(table, cfg, start, n, case.interleave,
                                                      case.scan, classes, 0, cfg.n_pixels,
                                                      emi)
        return wf.render_samples_wavefront_stats(table, cfg, start, n,
                                                 interleave=case.interleave, scan=case.scan,
                                                 classes=classes, emi_const=emi,
                                                 scan_tbl=tables.scan_table(case.scene,
                                                                            case.scan),
                                                 run=case.run)
    if case.kernel == "bvh":
        table, nf, ni, emi, classes = tables.bvh(case.scene, case.scan, case.leaf)
        fn = bk._render_samples_bvh_stats_plain if plain else bk.render_samples_bvh_stats
        return fn(table, nf, ni, cfg, start, n, max_leaf=case.leaf, scan=case.scan,
                  emi_const=emi, classes=classes)
    table, wn_f, wn_i, depth, emi, classes = tables.wide(case.scene, case.scan, case.leaf)
    if plain:
        return wb._render_samples_wide_bvh_stats_plain(table, wn_f, wn_i, cfg, start, n,
                                                       scan=case.scan, emi_const=emi,
                                                       classes=classes, depth=depth)
    return wb.render_samples_wide_bvh_stats(table, wn_f, wn_i, cfg, start, n,
                                            max_leaf=case.leaf, max_depth=depth,
                                            scan=case.scan, emi_const=emi, classes=classes,
                                            record=tables.record(case.scene, case.scan,
                                                                 case.leaf))


def padded_past_shared(table: torch.Tensor) -> torch.Tensor:
    """The table with zero rows (never hit) appended until the linear kernels read it,
    and the wavefront its 48-byte-a-row scan table, from global memory instead of
    shared memory."""
    rows = mk.SMEM_TABLE_MAX_BYTES // 48 + 1 - table.shape[0]
    big = torch.cat([table, torch.zeros((rows, mk.TABLE_COLS), device=table.device)])
    assert mk.table_in_shared(table) and not mk.table_in_shared(big)
    assert not wf.scan_in_shared(wf.scan_table(big, "parity"))
    return big


def compare(img_k, segs_k, img_p, segs_p) -> dict:
    """The pass rule above, as a dict of what it measured and `ok`."""
    a = img_k.detach().cpu().numpy()
    b = img_p.detach().cpu().numpy()
    sk, sp = int(segs_k), int(segs_p)
    close = np.isclose(a, b, rtol=RTOL, atol=ATOL).all(axis=1)
    frac = float(close.mean())
    seg_ok = abs(sk - sp) <= max(2, 1e-5 * sp)
    return {"pixel_fraction": frac, "max_abs_err": float(np.abs(a - b).max()),
            "segments_kernel": sk, "segments_plain": sp,
            "bitwise": bool(np.array_equal(a, b) and sk == sp),
            "finite": bool(np.isfinite(a).all()),
            "ok": bool(seg_ok and frac >= MIN_PIXEL_FRACTION and np.isfinite(a).all())}


def check_case(case: Case, tables: Tables) -> dict:
    img_k, segs_k = run(case, tables)
    torch.cuda.synchronize()
    img_p, segs_p = run(case, tables, plain=True)
    return compare(img_k, segs_k, img_p, segs_p)


def _same(a, b) -> bool:
    return bool(torch.equal(a[0], b[0]) and int(a[1]) == int(b[1]))


def wavefront_k1_equals_megakernel(tables: Tables, width, height, bounces=16) -> dict:
    """Wavefront k = 1 vs the megakernel (tp0 off), both kernels: bit for bit."""
    return {scan: _same(run(Case("megakernel", scan, width, height, bounces, tp0=False),
                            tables),
                        run(Case("wavefront", scan, width, height, bounces, interleave=1),
                            tables))
            for scan in ("parity", "fast", "tp")}


def matches_parity(tables: Tables, scan: str) -> dict:
    """The JAX package's fast/tp-vs-parity contract (tests/test_kernels.py,
    test_tp_scan_matches_parity_megakernel and test_fast_scan_matches_parity_*) on
    the linear kernels: 64×32, 6 bounces, 2 frames from 0; |Δsegments| ≤ 2 and
    allclose at rtol = atol = 1e-4."""
    out = {}
    for kernel in ("megakernel", "wavefront"):
        ref = run(Case(kernel, "parity", 64, 32, 6), tables, start=0, n=2)
        got = run(Case(kernel, scan, 64, 32, 6), tables, start=0, n=2)
        a, b = got[0].cpu().numpy(), ref[0].cpu().numpy()
        out[kernel] = {"segments_parity": int(ref[1]), f"segments_{scan}": int(got[1]),
                       "max_abs_err": float(np.abs(a - b).max()),
                       "ok": bool(abs(int(ref[1]) - int(got[1])) <= 2
                                  and np.allclose(a, b, rtol=RTOL, atol=ATOL))}
    return {"ok": all(r["ok"] for r in out.values()), **out}


def global_table_matches_shared(tables: Tables, width, height) -> dict:
    """The Cornell table padded with zero rows past shared memory (the kernels then
    read it from global memory) renders bit for bit as the table in shared memory:
    zero rows are never hit. Megakernel (3 samples at runs of 1, 2 and all) and
    wavefront, each scan."""
    out = {}
    for scan in ("parity", "fast", "tp"):
        table, emi, classes = tables.linear("cornell", scan)
        big = padded_past_shared(table)
        cfg = RenderConfig(width=width, height=height, bounces=4)
        kw = dict(scan=scan, classes=classes, emi_const=emi)
        mk_kw = dict(kw, tp0=False)  # the tp0 gate counts rows: keep both launches alike
        out[f"megakernel {scan}"] = all(
            _same(mk.render_samples_pallas_stats(table, cfg, 1, 3, run=r, **mk_kw),
                  mk.render_samples_pallas_stats(big, cfg, 1, 3, run=r, **mk_kw))
            for r in (1, 2, 3))
        out[f"wavefront {scan}"] = _same(wf.render_samples_wavefront_stats(table, cfg, 1, 2, **kw),
                                         wf.render_samples_wavefront_stats(big, cfg, 1, 2, **kw))
    return out


def linear_runs_agree(tables: Tables, width, height) -> dict:
    """Every megakernel case of `cases` (parity, fast, tp with the tp0 peel on and
    off, 4 and 16 bounces, a ragged image) at runs of 1, 2 and all samples a lane,
    bit for bit against the plain version; and the pixels [1000, 1000 + 2001) of the tp0 and parity cases at 4
    bounces (a ragged range from a pid_base) against the plain version of that range
    and against the whole image's rows."""
    out = {}
    for case in cases(width, height):
        if case.kernel != "megakernel":
            continue
        want = run(case, tables, plain=True)
        out[case.name] = all(_same(run(dataclasses.replace(case, run=r), tables), want)
                             for r in (1, 2, case.n_samples))
    for scan, tp0 in (("tp", True), ("parity", False)):
        table, emi, classes = tables.linear("cornell", scan)
        cfg = RenderConfig(width=width, height=height, bounces=4)
        kw = dict(scan=scan, classes=classes, tp0=tp0, emi_const=emi)
        whole = mk.render_samples_pallas_stats(table, cfg, START_SAMPLE, N_SAMPLES, **kw)
        want = mk._render_samples_stats_plain(table, cfg, START_SAMPLE, N_SAMPLES, 1000, 2001,
                                              **kw)
        ok = True
        for r in (1, 2, N_SAMPLES):
            got = mk.render_samples_pallas_stats(table, cfg, START_SAMPLE, N_SAMPLES, 1000, 2001,
                                                 run=r, **kw)
            ok = ok and _same(got, want) and torch.equal(got[0], whole[0][1000:3001])
        out[f"megakernel {scan} tp0={int(tp0)} pid_base 1000 n_rays 2001"] = ok
    return out


def wide_equals_skip_walk(tables: Tables, width, height, bounces=4) -> dict:
    """The 8-wide kernel vs the skip-link kernel on the same build: bit for bit, on
    bvh_cases' scenes and on deep_scene (a 14-level tree) in each leaf form."""
    out = {}
    deep = [Case("bvh", scan, width, height, bounces, scene="deep")
            for scan in ("parity", "fast", "tp")]
    for case in bvh_cases(width, height, bounces) + deep:
        if case.kernel == "bvh":
            wide = dataclasses.replace(case, kernel="widebvh")
            out[f"{case.scene} {case.scan} leaf {case.leaf}"] = _same(run(case, tables),
                                                                    run(wide, tables))
    return out


def wide_chunks_agree(tables: Tables, width, height, bounces=4, n_samples=3) -> dict:
    """The 8-wide and skip-link kernels' launches split by their scratch budget (one
    sample a launch, each sum going on from the last), and a wide launch with the
    largest stack (WIDE_MAX_DEPTH levels, 227 KB of shared memory a block), against
    one launch with the tree's own stack: bit for bit, each leaf form on
    sphere_field(3, 1)."""
    out = {}
    for scan in ("parity", "fast", "tp"):
        case = Case("widebvh", scan, width, height, bounces, scene="spheres244")
        table, wn_f, wn_i, depth, emi, classes = tables.wide(case.scene, scan, case.leaf)

        def render(**kw):
            return wb.render_samples_wide_bvh_stats(
                table, wn_f, wn_i, case.cfg, START_SAMPLE, n_samples, max_leaf=case.leaf,
                scan=scan, emi_const=emi, classes=classes,
                record=tables.record(case.scene, scan, case.leaf), **kw)

        ref = run(case, tables, n=n_samples)
        out[f"{scan} one sample a launch"] = _same(
            render(max_depth=depth, scratch_bytes=12 * width * height), ref)
        out[f"{scan} {wb.WIDE_MAX_DEPTH}-level stack"] = _same(
            render(max_depth=wb.WIDE_MAX_DEPTH), ref)
        tb, nf, ni, emi, classes = tables.bvh(case.scene, scan, case.leaf)
        out[f"{scan} skip-link one sample a launch"] = _same(
            bk.render_samples_bvh_stats(tb, nf, ni, case.cfg, START_SAMPLE, n_samples,
                                        max_leaf=case.leaf, scan=scan, emi_const=emi,
                                        classes=classes, scratch_bytes=12 * width * height),
            run(dataclasses.replace(case, kernel="bvh"), tables, n=n_samples))
    return out


WAVEFRONT_RUNS = (None, 2, 5)  # the default, runs of 2, and all 5 samples


def wavefront_splits_agree(tables: Tables, width, height, bounces=16, n_samples=5) -> dict:
    """The wavefront kernel on the Cornell box gives the same bits (image and
    segments) for every work split and scan-table place: runs of the default (one
    sample), of 2 (2, 2, 1 of 5 samples) and of all n_samples (a pixel a thread),
    with k = 1 and 3, its scan table in shared memory (as it is, and padded with zero
    rows past the 48 KB a block gets without opting in) and, padded past 227 KB, in
    global memory; in each scan form. Keys "scan k=…", values whether every variant
    equals the pixel-a-thread launch from shared memory."""
    out = {}
    cfg = RenderConfig(width=width, height=height, bounces=bounces)
    for scan in ("parity", "fast", "tp"):
        table, emi, classes = tables.linear("cornell", scan)
        big = padded_past_shared(table)
        mid = torch.cat([table, torch.zeros((49152 // 48 + 1 - table.shape[0], mk.TABLE_COLS),
                                            device=table.device)])
        for k in (1, 3):
            def render(tbl, m):
                return wf.render_samples_wavefront_stats(tbl, cfg, START_SAMPLE, n_samples,
                                                         interleave=k, scan=scan,
                                                         classes=classes, emi_const=emi, run=m)

            ref = render(table, n_samples)
            out[f"{scan} k={k}"] = all(_same(render(tbl, m), ref) for m in WAVEFRONT_RUNS
                                       for tbl in (table, mid, big))
    return out


def bvh_matches_linear(tables: Tables, width, height, scene="spheres5k", scan="fast",
                       bounces=4) -> dict:
    """The BVH kernels against the linear megakernel on the scene in original order
    (an independent brute-force search: on sphere_field() its table is past shared
    memory, so the linear kernel reads it from global memory), under compare's rule."""
    lin = run(Case("megakernel", scan, width, height, bounces, tp0=False, scene=scene),
              tables, n=BVH_SAMPLES)
    out = {}
    for kernel in ("bvh", "widebvh"):
        got = run(Case(kernel, scan, width, height, bounces, scene=scene), tables)
        out[kernel] = compare(got[0], got[1], *lin)
    return out


# ---- the adjoint kernel (kernels/grad_megakernel.py) ----------------------------

# Block sums add in another order than torch's. Each class row (C, 6) is held to
# its own largest entry, with a floor of GRAD_FLOOR_TOL · max|g| for rows near 0:
# walls see about 100× the gradient of small faces, so one bound set by the
# largest entry would pass a zeroed small class.
GRAD_REL_TOL = 1e-4
GRAD_FLOOR_TOL = 1e-6


def primary_mat_ids(scene, cfg: RenderConfig) -> torch.Tensor:
    """(n_pixels,) mat_id of each pixel's primary hit through its centre, on the scene's
    device: the rows of the twins' first material gathers (65,536 onto the Cornell
    box's 18 materials at 256²), which the gathers' backward kernel is checked on."""
    dev = scene.geometry.p1.device
    pid = torch.arange(cfg.n_pixels, device=dev)
    half = torch.full((cfg.n_pixels,), 0.5, device=dev)
    o, d = generate_rays(pid % cfg.width, pid // cfg.width, cfg.width, cfg.height, half, half,
                         cfg.camera)
    return intersect_world(o, d, scene.geometry).mat_id


def grad_points(tables: Tables) -> dict:
    """Class tables of the Cornell box to differentiate at: the true classes (zero
    attributes on the boundary), an interior point (albedo in [0.12, 0.95],
    emissive + 0.3) and a point where max(rad, 0) binds (class 0's albedo < 0)."""
    ct = tables.grad("cornell")[1]
    interior = ct.clone()
    interior[:, 0:3] = interior[:, 0:3].clamp(0.12, 0.95)
    interior[:, 3:6] += 0.3
    clamped = ct.clone()
    clamped[0, 0:3] = torch.tensor([-0.4, -0.3, -0.35])
    return {"true": ct, "interior": interior, "clamp binds": clamped}


def grad_weight(n: int, device) -> torch.Tensor:
    """A seeded (n, 3) loss weight."""
    w = np.random.default_rng(0).normal(size=(n, 3)).astype(np.float32)
    return torch.from_numpy(w).to(device)


def run_grad(tables: Tables, cfg: RenderConfig, ct: torch.Tensor, weight, plain=False,
             start: int = START_SAMPLE, n: int = 2):
    """(img, grads or None, segments) of the adjoint kernel, or of its plain
    version, on the Cornell box; weight None is the forward alone."""
    table, _, n_classes, _ = tables.grad("cornell")
    kw = dict(with_grads=weight is not None, weight=weight)
    if plain:
        return gk._render_grads_plain(table, ct, cfg, start, n, n_classes, **kw)
    return gk.render_grads_pallas_stats(table, ct, cfg, start, n, n_classes, **kw)


def compare_grads(got, want) -> dict:
    """Kernel vs plain: image and segments bit for bit; the (C, 6) gradients (when
    there are any) with each class row c within GRAD_REL_TOL · max|g_c| +
    GRAD_FLOOR_TOL · max|g|. `grad_worst_row` is the largest row error over its
    bound (≤ 1 passes)."""
    img_k, g_k, s_k = got
    img_p, g_p, s_p = want
    out = {"image_bitwise": bool(torch.equal(img_k, img_p)), "segments": int(s_k),
           "segments_equal": int(s_k) == int(s_p),
           "max_abs_err": float((img_k - img_p).abs().max())}
    ok = out["image_bitwise"] and out["segments_equal"]
    if g_p is not None:
        scale = float(g_p.abs().max())
        row_err = (g_k - g_p).abs().amax(dim=1)
        bound = GRAD_REL_TOL * g_p.abs().amax(dim=1) + GRAD_FLOOR_TOL * scale
        if scale > 0:
            worst = float((row_err / bound).max())
        else:
            worst = 0.0 if float(row_err.max()) == 0.0 else float("inf")
        out.update(grad_max_abs_err=float(row_err.max()), grad_max_abs=scale,
                   grad_worst_row=worst, grad_finite=bool(torch.isfinite(g_k).all()))
        ok = ok and worst <= 1.0 and out["grad_finite"]
    return {**out, "ok": bool(ok)}


def hybrid_forward_check(tables: Tables, width, height, bounces=4, n_samples=8) -> dict:
    """The hybrid renderer's forward (diff/fast.make_fast_renderer) on the Cornell
    box: pack_scene on the card gives the host's table bit for bit, and the forward
    (the parity megakernel on that table) against the megakernel's plain version on
    the same table under compare's rule, and bit for bit against the kernel."""
    from oclpathtracer_tpu_torch.diff import fast, inverse

    scene = tables.scene("cornell")
    cfg = RenderConfig(width=width, height=height, bounces=bounces)
    table = mk.pack_scene(scene)
    host = mk.pack_scene(scene.to("cpu"))
    render, _ = fast.make_fast_renderer(scene, cfg, n_samples)
    img = render(inverse.extract_params(scene, albedo=True, emissive=True), 0)
    img_k, segs_k = mk.render_samples_pallas_stats(table, cfg, 0, n_samples, scan="parity")
    img_p, segs_p = mk._render_samples_stats_plain(table, cfg, 0, n_samples, 0, cfg.n_pixels,
                                                   "parity", (), True)
    r = compare(img, segs_k, img_p / n_samples, segs_p)
    table_ok = bool(torch.equal(table.cpu(), host) and table.device == img.device)
    kernel_ok = bool(torch.equal(img, img_k / n_samples))
    return {**r, "table_on_card_bitwise_host": table_ok, "forward_bitwise_kernel": kernel_ok,
            "ok": bool(r["ok"] and table_ok and kernel_ok)}


def grad_checks(tables: Tables, width, height, bounces=4, n_samples=2) -> dict:
    """The adjoint kernel on the card: the forward bit for bit against its plain
    version and against the tp megakernel (tp0 off); the adjoint against its plain
    version at the true, interior and clamp-binding points; two launches of the
    adjoint give the same bits, as does the table read from global memory; and the
    adjoint on a ragged pixel range (pid_base 1000, 2,001 pixels) against its plain
    version, its image bit for bit the whole image's rows."""
    cfg = RenderConfig(width=width, height=height, bounces=bounces)
    points = grad_points(tables)
    w = grad_weight(cfg.n_pixels, tables.device)
    out = {"forward vs plain": compare_grads(
        run_grad(tables, cfg, points["true"], None, n=n_samples),
        run_grad(tables, cfg, points["true"], None, plain=True, n=n_samples))}
    img, _, segs = run_grad(tables, cfg, points["true"], None, n=n_samples)
    table, _, classes = tables.linear("cornell", "tp")
    img2, segs2 = mk.render_samples_pallas_stats(table, cfg, START_SAMPLE, n_samples, scan="tp",
                                                 classes=classes, tp0=False)
    out["forward vs tp megakernel (tp0 off)"] = {
        "ok": bool(torch.equal(img, img2) and int(segs) == int(segs2))}
    for name, ct in points.items():
        out[f"adjoint vs plain at the {name} point"] = compare_grads(
            run_grad(tables, cfg, ct, w, n=n_samples),
            run_grad(tables, cfg, ct, w, plain=True, n=n_samples))
    first = run_grad(tables, cfg, points["interior"], w, n=n_samples)
    again = run_grad(tables, cfg, points["interior"], w, n=n_samples)
    out["adjoint rerun, same bits"] = {"ok": bool(torch.equal(first[0], again[0])
                                                  and torch.equal(first[1], again[1]))}
    # The table padded with zero rows (never hit) past shared memory: the kernel
    # reads it from global memory, with the same bits.
    table, ct, n_classes, _ = tables.grad("cornell")
    rows = mk.SMEM_TABLE_MAX_BYTES // (4 * mk.TABLE_COLS) + 1 - table.shape[0]
    big = torch.cat([table, torch.zeros((rows, mk.TABLE_COLS), device=table.device)])
    assert gk.grad_table_in_shared(table) and not gk.grad_table_in_shared(big)
    far = gk.render_grads_pallas_stats(big, points["interior"], cfg, START_SAMPLE, n_samples,
                                       n_classes, weight=w)
    out["table in global memory, same bits"] = {
        "ok": bool(torch.equal(far[0], first[0]) and torch.equal(far[1], first[1])
                   and int(far[2]) == int(first[2]))}
    # A pixel range whose paths fill no whole block (blocks straddle samples).
    kw = dict(weight=w[1000:3001], pid_base=1000, n_rays=2001)
    part = gk.render_grads_pallas_stats(table, points["interior"], cfg, START_SAMPLE, n_samples,
                                        n_classes, **kw)
    r = compare_grads(part, gk._render_grads_plain(table, points["interior"], cfg, START_SAMPLE,
                                                   n_samples, n_classes, **kw))
    rows_ok = torch.equal(part[0], first[0][1000:3001])
    out["adjoint on pixels [1000, 3001) vs plain and the whole image's rows"] = {
        **r, "whole_image_rows_bitwise": bool(rows_ok), "ok": bool(r["ok"] and rows_ok)}
    return out


# ---- the arbitrary-ray kernel (megakernel.trace_rays_pallas_stats) ---------------

def occluder_arrays():
    """The JAX package's occluder scene (tests/test_diff.py) as numpy leaves for
    convert.scene_from_numpy: a black triangle at z = −2 in front of an emissive
    backdrop quad at z = −5, both facing the camera. The loss's finite differences
    in the occluder's vertices are pure primary boundary term."""
    a, b, c, d = [-4, -1, -5], [4, -1, -5], [4, 6.5, -5], [-4, 6.5, -5]
    o1, o2, o3 = [-1.0, 1.6, -2.0], [1.2, 2.0, -2.0], [0.1, 4.0, -2.0]
    f32, i32 = np.float32, np.int32
    geometry = (np.array([a, c, o1], f32), np.array([b, d, o2], f32),
                np.array([c, a, o3], f32), np.array([0, 0, 1], i32))
    materials = (np.array([[1, 1, 1], [0, 0, 0]], f32), np.array([[5, 5, 5], [0, 0, 0]], f32),
                 np.array([0, 0], f32), np.array([1, 1], i32))
    lights = (np.array([0], i32), np.array([30.0], f32), np.array([[0, 0, 1]], f32))
    return geometry, materials, lights


PROBE_START = 1 << 20  # the vertex step's probe sample range
PROBE_ROW_BASE = 7


def probe_rays(scene, n: int, cfg: RenderConfig, seed: int = 0):
    """(o, d) (n, 3) on the scene's device: the first half through seeded continuous
    pixel coords of `cfg`'s camera (diff/edge.rays_at, the edge probes' rays), the
    rest from seeded points inside the scene's bounding box (shrunk by 10 %) in
    seeded directions (the rim probes' rays start on surfaces inside the box)."""
    from oclpathtracer_tpu_torch.diff.edge import rays_at

    g = np.random.default_rng(seed)
    dev = scene.geometry.p1.device
    half = n // 2
    coords = g.uniform((0.0, 0.0), (cfg.width, cfg.height), (half, 2)).astype(np.float32)
    o_cam, d_cam = rays_at(torch.from_numpy(coords).to(dev), cfg)
    verts = torch.cat([scene.geometry.p1, scene.geometry.p2, scene.geometry.p3]).cpu().numpy()
    lo, hi = verts.min(0), verts.max(0)
    mid, ext = (lo + hi) / 2, (hi - lo) / 2 * 0.9
    o_in = g.uniform(mid - ext, mid + ext, (n - half, 3)).astype(np.float32)
    d_in = g.normal(size=(n - half, 3)).astype(np.float32)
    d_in /= np.linalg.norm(d_in, axis=1, keepdims=True)
    o = torch.cat([o_cam, torch.from_numpy(o_in).to(dev)]).contiguous()
    d = torch.cat([d_cam, torch.from_numpy(d_in).to(dev)]).contiguous()
    return o, d


def run_trace_rays(tables: Tables, scan: str, o, d, cfg: RenderConfig, n_samples: int,
                   plain: bool = False, table=None, scene: str = "cornell", run=None):
    """(img, segments) of trace_rays (at `run` samples a lane), or of its plain
    version, on the scene's table for `scan` (or on `table`, e.g. a padded one), rows
    from PROBE_ROW_BASE, samples from PROBE_START."""
    own, emi, classes = tables.linear(scene, scan)
    table = own if table is None else table
    kw = dict(row_base=PROBE_ROW_BASE, start_sample=PROBE_START, scan=scan, classes=classes,
              emi_const=emi)
    if plain:
        return mk._trace_rays_stats_plain(table, o, d, cfg, n_samples, **kw)
    return mk.trace_rays_pallas_stats(table, o, d, cfg, n_samples, run=run, **kw)


def trace_rays_checks(tables: Tables, n_rows: int, bounces: int = 4, n_samples: int = 4,
                      camera: int = 256) -> dict:
    """The arbitrary-ray kernel on the Cornell box, at runs of 1, 2 and all samples a
    lane: against its plain version in each scan form, bit for bit (images and
    segments, compare's dict with `ok` requiring `bitwise` at every run); a rerun
    giving the same bits; and the table padded with zero rows past shared memory
    (read from global memory) giving the same bits."""
    scene = tables.scene("cornell")
    cfg = RenderConfig(width=camera, height=camera, bounces=bounces)
    o, d = probe_rays(scene, n_rows, cfg)
    runs = (1, 2, n_samples)
    out = {}
    for scan in ("parity", "fast", "tp"):
        got = run_trace_rays(tables, scan, o, d, cfg, n_samples)
        torch.cuda.synchronize()
        want = run_trace_rays(tables, scan, o, d, cfg, n_samples, plain=True)
        r = compare(*got, *want)
        by_run = {m: _same(run_trace_rays(tables, scan, o, d, cfg, n_samples, run=m), want)
                  for m in runs}
        out[f"kernel vs plain, {scan}"] = {**r, "runs_bitwise": by_run,
                                           "ok": r["ok"] and r["bitwise"] and all(by_run.values())}
    first = run_trace_rays(tables, "parity", o, d, cfg, n_samples)
    again = run_trace_rays(tables, "parity", o, d, cfg, n_samples)
    out["rerun, same bits"] = {"ok": _same(first, again)}
    big = padded_past_shared(tables.linear("cornell", "parity")[0])
    out["table in global memory, same bits"] = {"ok": all(
        _same(run_trace_rays(tables, "parity", o, d, cfg, n_samples, table=big, run=m), first)
        for m in runs)}
    return out


# ---- the AO and direct-NEE kernels (kernels/fast_integrators.py) ----------------

def run_fast(kind: str, tables: Tables, cfg: RenderConfig, start: int, n: int,
             plain: bool = False, pid_base: int = 0, n_rays: int | None = None, table=None,
             counts: dict | None = None, lanes: int | None = None):
    """The (n_rays, 3) SUM of the AO ("ao") or direct ("direct") kernel (at `lanes`
    lanes a pixel, default the wrapper's), or of its plain version (which adds to
    `counts`), on the Cornell box's parity table (or on `table`)."""
    own, _, _ = tables.linear("cornell", "parity")
    table = own if table is None else table
    kw = dict(pid_base=pid_base, n_rays=n_rays)
    if kind == "ao":
        if plain:
            return fi._render_ao_plain(table, cfg, start, n, counts=counts,
                                       lanes=fi.ao_lanes(n), **kw)
        return fi.render_ao_pallas(table, cfg, start, n, lanes=lanes, **kw)
    lt, area = tables.lights("cornell")
    if plain:
        return fi._render_direct_plain(table, lt, area, cfg, start, n, counts=counts, **kw)
    return fi.render_direct_pallas(table, lt, area, cfg, start, n, lanes=lanes, **kw)


def run_fast_stats(kind: str, tables: Tables, cfg: RenderConfig, start: int, n: int,
                   pid_base: int = 0, n_rays: int | None = None, table=None,
                   lanes: int | None = None):
    """(SUM image, rays cast) of the AO or direct kernel's stats entry on the Cornell
    box's parity table (or on `table`)."""
    own, _, _ = tables.linear("cornell", "parity")
    table = own if table is None else table
    kw = dict(pid_base=pid_base, n_rays=n_rays, lanes=lanes)
    if kind == "ao":
        return fi.render_ao_stats(table, cfg, start, n, **kw)
    lt, area = tables.lights("cornell")
    return fi.render_direct_stats(table, lt, area, cfg, start, n, **kw)


DIRECT_SPLIT_SAMPLES = (3, 5)  # no multiple of 2, 8 or 32 lanes
RAY_SAMPLES = (1, 5)
RAY_LANES = (1, 2, 4, 8, 16, 32)


def fast_ray_checks(tables: Tables, width, height) -> dict:
    """The AO and direct kernels' rays cast (an int64 on the card) against the camera
    and second rays their plain versions count, with each image bit for bit the plain
    version's: at 1 and 5 samples a pixel, at 1 to 32 lanes a pixel, with the table
    in shared and in global memory, on the whole image and on pixels [1000, 6001).
    The image holds at least 6001 pixels."""
    cfg = RenderConfig(width=width, height=height)
    big = padded_past_shared(tables.linear("cornell", "parity")[0])
    out = {}
    for kind in ("ao", "direct"):
        wrong, rays = [], {}
        for n in RAY_SAMPLES:
            for pid_base, n_rays in ((0, None), (1000, 5001)):
                counts = fi._new_counts()
                want = run_fast(kind, tables, cfg, START_SAMPLE, n, plain=True,
                                pid_base=pid_base, n_rays=n_rays, counts=counts)
                want_rays = rays[f"n={n} from {pid_base}"] = fi.rays_cast(counts)
                for lanes in RAY_LANES:
                    for route, table in (("shared", None), ("global", big)):
                        img, got = run_fast_stats(kind, tables, cfg, START_SAMPLE, n,
                                                  pid_base, n_rays, table, lanes)
                        if not (got.dtype == torch.int64 and got.shape == ()
                                and int(got) == want_rays and torch.equal(img, want)):
                            wrong.append(f"n={n} from {pid_base} {lanes} lanes {route}: "
                                         f"{int(got)} rays")
        out[f"{kind} rays cast are the plain version's count, image bit for bit"] = {
            "ok": not wrong, "rays": rays, "wrong": wrong}
    return out


def fast_integrator_checks(tables: Tables, width, height, n_samples: int = 4) -> dict:
    """The AO and direct kernels on the Cornell box, bit for bit: against their plain
    versions on the whole image; on pixels [1000, 1000 + 5001) (a ragged count from a
    pid_base), against the plain version and against the whole image's rows; with the
    table padded past shared memory (read from global memory), the same bits; AO at
    1, 2 and 32 lanes a pixel, the same bits; direct at 1, 2, 8 and 32 lanes a pixel
    and n = 3 and 5, on both routes and (8 lanes) on pixels [1000, 6001), the plain
    version's bits and the default's; the rays each casts (fast_ray_checks). The image
    holds at least 6001 pixels."""
    cfg = RenderConfig(width=width, height=height)
    big = padded_past_shared(tables.linear("cornell", "parity")[0])
    out, fulls = {}, {}
    for kind in ("ao", "direct"):
        full = fulls[kind] = run_fast(kind, tables, cfg, START_SAMPLE, n_samples)
        torch.cuda.synchronize()
        want = run_fast(kind, tables, cfg, START_SAMPLE, n_samples, plain=True)
        out[f"{kind} kernel vs plain"] = {
            "ok": bool(torch.equal(full, want)),
            "max_abs_err": float((full - want).abs().max()),
            "mean": float(full.mean()) / n_samples}
        part = run_fast(kind, tables, cfg, START_SAMPLE, n_samples, pid_base=1000, n_rays=5001)
        part_p = run_fast(kind, tables, cfg, START_SAMPLE, n_samples, plain=True,
                          pid_base=1000, n_rays=5001)
        out[f"{kind} pid_base 1000 n_rays 5001 vs plain and vs the image's rows"] = {
            "ok": bool(torch.equal(part, part_p) and torch.equal(part, full[1000:6001]))}
        far = run_fast(kind, tables, cfg, START_SAMPLE, n_samples, table=big)
        out[f"{kind} table in global memory, same bits"] = {"ok": bool(torch.equal(far, full))}
    same = {lanes: bool(torch.equal(run_fast("ao", tables, cfg, START_SAMPLE, n_samples,
                                             lanes=lanes), fulls["ao"]))
            for lanes in (1, 2, 32)}
    out["ao at 1, 2 and 32 lanes a pixel, same bits"] = {"ok": all(same.values()), **same}
    same = {}
    for n in DIRECT_SPLIT_SAMPLES:
        want = run_fast("direct", tables, cfg, START_SAMPLE, n, plain=True)
        default = run_fast("direct", tables, cfg, START_SAMPLE, n)
        same[f"n={n} default"] = bool(torch.equal(default, want))
        for lanes in (1, 2, 8, 32):
            for route, table in (("shared", None), ("global", big)):
                got = run_fast("direct", tables, cfg, START_SAMPLE, n, table=table, lanes=lanes)
                same[f"n={n} {lanes} lanes {route}"] = bool(torch.equal(got, want))
        part = run_fast("direct", tables, cfg, START_SAMPLE, n, pid_base=1000, n_rays=5001,
                        lanes=8)
        same[f"n={n} 8 lanes pid_base 1000 n_rays 5001"] = bool(torch.equal(part,
                                                                            want[1000:6001]))
    out["direct at 1, 2, 8 and 32 lanes a pixel, n = 3 and 5, both routes, same bits"] = {
        "ok": all(same.values()), **same}
    out.update(fast_ray_checks(tables, width, height))
    return out


# ---- the sorted wavefront (kernels/sorted_wavefront.py) -------------------------

SORTED_LEAF = 32  # render_sorted's


def run_sorted(tables: Tables, scene: str, cfg: RenderConfig, start: int, n: int,
               sort: bool = False, plain: bool = False):
    """(img, segments) of the sorted wavefront (bounce kernel or its plain version)
    on the scene's parity BVH tables at leaf SORTED_LEAF."""
    tb, nf, ni, _, _ = tables.bvh(scene, "parity", SORTED_LEAF)
    fn = sw._render_samples_sorted_stats_plain if plain else sw.render_samples_sorted_stats
    return fn(tb, nf, ni, cfg, start, n, max_leaf=SORTED_LEAF, sort=sort)


def sorted_checks(tables: Tables, width, height, bounces: int = 4, n_samples: int = 2) -> dict:
    """The sorted wavefront on the Cornell box and sphere_field(), sort off and on, bit
    for bit (images and segments) against its plain version and against the skip-link
    kernel (parity, the same leaf); also on the Cornell box at 13x11 with 3 samples
    (429 rays, no multiple of the block) and looking out of its open side (every ray
    dies in the first launch)."""
    out = {}
    away = RenderConfig(width=width, height=height, bounces=bounces,
                        camera=CameraConfig(look=(0.0, 0.0, 1.0)))
    for scene, name, cfg, n in (
            ("cornell", "cornell", scene_cfg("cornell", width, height, bounces), n_samples),
            ("spheres5k", "spheres5k", scene_cfg("spheres5k", width, height, bounces),
             n_samples),
            ("cornell", "cornell 13x11 3spp", scene_cfg("cornell", 13, 11, bounces), 3),
            ("cornell", "cornell looking away", away, n_samples)):
        tb, nf, ni, _, _ = tables.bvh(scene, "parity", SORTED_LEAF)
        ref = bk.render_samples_bvh_stats(tb, nf, ni, cfg, START_SAMPLE, n, max_leaf=SORTED_LEAF)
        for sort in (False, True):
            got = run_sorted(tables, scene, cfg, START_SAMPLE, n, sort)
            torch.cuda.synchronize()
            want = run_sorted(tables, scene, cfg, START_SAMPLE, n, sort, plain=True)
            out[f"{name} sort={sort} kernel vs plain"] = {
                "ok": _same(got, want), "segments": int(got[1]),
                "max_abs_err": float((got[0] - want[0]).abs().max())}
            out[f"{name} sort={sort} vs the skip-link kernel"] = {"ok": _same(got, ref)}
        if name == "cornell looking away":
            out[f"{name}: one segment a ray"] = {"ok": int(ref[1]) == cfg.n_pixels * n}
    return out
