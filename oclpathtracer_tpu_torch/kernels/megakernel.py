"""Fused path-trace megakernel: host side, plain PyTorch version and CUDA wrapper.

Counterpart of `oclpathtracer_tpu.kernels.megakernel`. The kernel
(`csrc/megakernel.cu`, its loop in `csrc/regen.cuh`, device code in `csrc/trace.cuh`)
traces the paths of (pixel, run of samples) items that persistent blocks take from a
queue: camera generation, the bounce loop, the first-min linear triangle scan, BRDF
sampling and the sum over samples. The scene table sits in shared memory while it
fits (`table_in_shared`) and is read from global memory beyond; the results do not
depend on which. `run`, the samples of one pixel a lane takes at a time, moves no
bit: with run < n_samples each sample's max(rad, 0) goes to a (n_samples, n_pix, 3)
scratch buffer that a second kernel adds in sample order (`sample_sum_plain`).

Sample streams are the reference's RNG (kernels/rng.py): seed = pixel_id +
hash(frame), wang+LCG per draw, keyed on ABSOLUTE pixel ids so any split of the
image into `pid_base`/`n_rays` ranges gives the same bits.

Semantics ≡ reference traceRays (GenerateColors.cl:223-261) with all quirks:
backface cull (:100), first-min hit (:144-150), emissive ×3 (:241), GGX ×2 (:217),
flat bg on miss (:227), 0.01 respawn offset (:257), ≤`bounces` segments.

Scans: "parity" reproduces the reference's intersectTriangle arithmetic; "fast" is
the division-free form (t kept as a fraction, the inside test on undivided
numerators, material packed into the code column 23, emitters sharing
`emi_const`); "tp" is the triple-product scan over `pack_scene_tp`'s constants,
with the tp0 bounce-0 peel. fast and tp hit decisions may move from parity's only at
ulp comparison boundaries; images are allclose (the JAX package's contract).

`render_samples_pallas_stats` keeps the JAX name so readers find it. For a CUDA
table it launches the kernel, or raises; for a CPU table it runs the plain version
`_render_samples_stats_plain`, which has the same arithmetic vectorized over pixels.
`trace_rays_pallas_stats` is the same trace from given rays (`csrc/trace_rays.cu`,
plain version `_trace_rays_stats_plain`): the boundary estimators' radiance probes.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from oclpathtracer_tpu_torch.config import RenderConfig
from oclpathtracer_tpu_torch.kernels import rng as krng
from oclpathtracer_tpu_torch.runtime import profiling
from oclpathtracer_tpu_torch.scene.types import Scene

INV_PI = 0.31830988618
TWO_PI = 6.28318530718
T_MAX = 1e20

# Scene table layout (T, 24) f32 — columns:
#  0:3 p1 | 3:6 e1 | 6:9 e2 | 9:12 n=normalize(cross(e2,e1)) | 12:15 albedo
#  15:18 emissive | 18 roughness | 19 mtype (1.0 diffuse / 2.0 specular) |
#  20:23 pad | 23 fast-scan fused code = rough + 4*mtype + 16*is_emitter
TABLE_COLS = 24

# The linear kernels stage the table in one block's shared memory up to 227 KB on
# Hopper (about 2,420 triangles) and read it from global memory beyond.
SMEM_TABLE_MAX_BYTES = 232_448

# The tp0 peel's gate, inherited from the JAX kernel (its scan-unroll cap and
# bounce range). The peel's collapsed forms round differently from the generic tp
# scan, so the gate decides which numbers come out, not only how fast.
TP0_MAX_TRIS = 128
TP0_MAX_BOUNCES = 8

TP_CLASS_CAP = 16  # classes travel by value in the kernel parameters
CLASS_COLS = 8     # albedo 3 | emissive 3 | roughness | mtype

# Numeric-extent gate for the tp scan: every vertex within TP_ORIGIN_FACTOR × the
# scene's bounding-box diagonal of the origin (its forms cancel in f32 far from it).
TP_ORIGIN_FACTOR = 64.0

# tp table layout (T, 24) f32 — columns:
#  0:3 N | 3:6 e1 | 6:9 e2 | 9:12 C1 | 12:15 C2 | 15 k |
#  16 code = material class index + 1 (0 = "no hit") |
#  17:24 pad, UNLESS the tp0 peel is on: augment_table_tp0 fills them with
#  17:20 U | 20:23 V | 23 t0 (the collapsed bounce-0 scan constants)

# Samples a lane takes at a time by default (`run`) in the linear kernels (the
# megakernel, trace_rays, the wavefront), the fastest on the card at their main
# shapes (PERF.md), while the scratch buffer stays within SCRATCH_MAX_BYTES
# (default_run).
DEFAULT_RUN = 1


# ---- scene packing (bit for bit as the JAX package builds it in numpy) --------

def pack_scene(scene: Scene) -> torch.Tensor:
    """Flatten the scene into the kernel's (T, 24) table, in torch on the scene's
    tensors and device: the same f32 operations in numpy's order, so parameter
    values that live on the card are packed there without a copy to the host."""
    g, m = scene.geometry, scene.materials
    p1 = g.p1.to(torch.float32)
    e1 = g.p2.to(torch.float32) - p1
    e2 = g.p3.to(torch.float32) - p1
    n = torch.stack([e2[:, 1] * e1[:, 2] - e2[:, 2] * e1[:, 1],
                     e2[:, 2] * e1[:, 0] - e2[:, 0] * e1[:, 2],
                     e2[:, 0] * e1[:, 1] - e2[:, 1] * e1[:, 0]], dim=1)
    # numpy's sqrtf is correctly rounded and torch's CPU sqrt can miss by an ulp;
    # the square root of the f32 sum taken in f64 rounds back to numpy's bits.
    sq = n[:, 0] * n[:, 0] + n[:, 1] * n[:, 1] + n[:, 2] * n[:, 2]
    norm = torch.sqrt(sq.double()).float()
    n = n / torch.clamp(norm, min=1e-20)[:, None]
    mid = g.mat_id.long()
    emissive = m.emissive.to(torch.float32)[mid]
    rough = m.roughness.to(torch.float32)[mid]
    mty = m.mtype[mid].to(torch.float32)
    is_emit = (emissive != 0.0).any(dim=1).to(torch.float32)
    pad = torch.zeros((p1.shape[0], 3), dtype=torch.float32, device=p1.device)
    return torch.cat([p1, e1, e2, n, m.albedo.to(torch.float32)[mid], emissive,
                      rough[:, None], mty[:, None], pad,
                      (rough + 4.0 * mty + 16.0 * is_emit)[:, None]], dim=1)


def fast_scan_supported(scene: Scene) -> bool:
    """True if the materials survive the fast scan's fused-code encoding: one shared
    emitter RGB, roughness < 4, and diffuse/specular mtypes."""
    m = scene.materials
    emi = m.emissive.cpu().numpy()
    rough = m.roughness.cpu().numpy()
    mty = m.mtype.cpu().numpy()
    emitters = emi[(emi != 0.0).any(axis=-1)]
    return bool(
        (emitters.shape[0] == 0 or (emitters == emitters[0]).all())
        and np.all((rough >= 0.0) & (rough < 4.0))
        and np.all((mty == 1) | (mty == 2)))


def scene_emissive_const(scene: Scene) -> tuple[float, float, float]:
    """The shared emitter RGB the fast scan bakes in (0,0,0 if no emitters)."""
    emi = scene.materials.emissive.cpu().numpy()
    emitters = emi[(emi != 0.0).any(axis=-1)]
    if emitters.shape[0] == 0:
        return (0.0, 0.0, 0.0)
    return tuple(float(c) for c in emitters[0])


def material_classes(scene: Scene):
    """Deduplicate materials into (albedo, emissive, roughness, mtype) classes.

    Returns (classes, per-material class index). Cornell has 18 material records
    but only 5 distinct classes."""
    m = scene.materials
    alb = m.albedo.cpu().numpy().astype(np.float32)
    emi = m.emissive.cpu().numpy().astype(np.float32)
    rough = m.roughness.cpu().numpy().astype(np.float32)
    mty = m.mtype.cpu().numpy().astype(np.float32)
    seen: dict = {}
    classes = []
    idx = np.zeros(alb.shape[0], np.int32)
    for i in range(alb.shape[0]):
        key = (tuple(alb[i].tolist()), tuple(emi[i].tolist()),
               float(rough[i]), float(mty[i]))
        if key not in seen:
            seen[key] = len(classes)
            classes.append(key)
        idx[i] = seen[key]
    return tuple(classes), idx


def tp_scan_supported(scene: Scene) -> bool:
    """True if the materials dedupe to ≤ TP_CLASS_CAP diffuse/specular classes AND
    every vertex lies within TP_ORIGIN_FACTOR × the bbox diagonal of the origin."""
    classes, _ = material_classes(scene)
    mty = scene.materials.mtype.cpu().numpy()
    if not (len(classes) <= TP_CLASS_CAP and np.all((mty == 1) | (mty == 2))):
        return False
    g = scene.geometry
    verts = np.concatenate([g.p1.cpu().numpy().astype(np.float64),
                            g.p2.cpu().numpy().astype(np.float64),
                            g.p3.cpu().numpy().astype(np.float64)])
    if verts.shape[0] == 0:
        return True
    diag = float(np.linalg.norm(verts.max(0) - verts.min(0)))
    dist = float(np.linalg.norm(verts, axis=-1).max())
    return dist <= TP_ORIGIN_FACTOR * max(diag, 1e-12)


def pack_scene_tp(scene: Scene):
    """Pack the scene for the tp scan: ((T, 24) table on the scene's device,
    class tuple)."""
    g = scene.geometry
    p1 = g.p1.cpu().numpy().astype(np.float32)
    e1 = g.p2.cpu().numpy().astype(np.float32) - p1
    e2 = g.p3.cpu().numpy().astype(np.float32) - p1
    nrm = np.cross(e2, e1)
    classes, cls_of_mat = material_classes(scene)
    mid = g.mat_id.cpu().numpy()
    tbl = np.zeros((p1.shape[0], TABLE_COLS), np.float32)
    tbl[:, 0:3] = nrm
    tbl[:, 3:6] = e1
    tbl[:, 6:9] = e2
    tbl[:, 9:12] = np.cross(e2, p1)
    tbl[:, 12:15] = np.cross(e1, p1)
    tbl[:, 15] = np.einsum("ij,ij->i", p1, nrm)
    tbl[:, 16] = (cls_of_mat[mid] + 1).astype(np.float32)
    return torch.from_numpy(tbl).to(g.p1.device), classes


def augment_table_tp0(table: torch.Tensor, eye) -> torch.Tensor:
    """Fill a pack_scene_tp table's pad columns with the bounce-0 constants.

    Every path's first segment starts at the eye, so with m = cross(eye, d):
        unum = d·(e2×eye − C1) = d·U,  vnum = d·(C2 − e1×eye) = d·V,
        tnum = k − eye·N = t0.
    Columns 17:20 = U, 20:23 = V, 23 = t0, each one f32 operation at a time in a
    fixed order (the JAX package's `@` may sum in another; allclose to it)."""
    ex, ey, ez = (float(np.float32(c)) for c in eye)
    e1 = table[:, 3:6]
    e2 = table[:, 6:9]
    c1 = table[:, 9:12]
    c2 = table[:, 12:15]
    nv = table[:, 0:3]

    def cross_eye(a):
        return torch.stack([a[:, 1] * ez - a[:, 2] * ey,
                            a[:, 2] * ex - a[:, 0] * ez,
                            a[:, 0] * ey - a[:, 1] * ex], dim=1)

    u = cross_eye(e2) - c1
    v = c2 - cross_eye(e1)
    t0 = table[:, 15] - (nv[:, 0] * ex + nv[:, 1] * ey + nv[:, 2] * ez)
    return torch.cat([table[:, :17], u, v, t0[:, None]], dim=1).contiguous()


def _camera_constants(cfg: RenderConfig):
    """Host-side camera basis in float64, cast to f32 (as the JAX kernel bakes it)."""
    look = np.asarray(cfg.camera.look, np.float64)
    up = np.asarray(cfg.camera.up, np.float64)
    view = look / np.linalg.norm(look)
    hol = np.cross(view, up)
    hol = hol / np.linalg.norm(hol)
    upd = np.cross(hol, view)
    upd = upd / np.linalg.norm(upd)
    angle = math.tan(0.5 * math.radians(cfg.camera.vfov_degrees))
    return (tuple(np.float32(v) for v in view), tuple(np.float32(v) for v in hol),
            tuple(np.float32(v) for v in upd), np.float32(angle),
            tuple(np.float32(v) for v in cfg.camera.eye))


def resolve_scan(scene: Scene, requested: str = "auto") -> str:
    """'auto' = the fastest scan the scene's materials support (tp, else fast, else
    parity), as in the JAX package. Explicit requests pass through."""
    if requested != "auto":
        return requested
    if tp_scan_supported(scene):
        return "tp"
    if fast_scan_supported(scene):
        return "fast"
    return "parity"


NO_EMI = (0.0, 0.0, 0.0)


def prepare_scan(scene: Scene, requested: str = "auto"):
    """Resolve the scan and pack its table: (scan, table, emi_const, classes), the
    JAX package's tuple: the kernels' `scan`, table, `emi_const` (the fast scan's
    shared emitter RGB, else zeros) and `classes` (tp's, else ()).

    An explicitly requested 'tp' or 'fast' is validated against its support
    predicate and raises ValueError on a scene it can't encode."""
    scan = resolve_scan(scene, requested)
    if scan == "tp":
        if requested == "tp" and not tp_scan_supported(scene):
            raise ValueError(
                "scan='tp' requested but tp_scan_supported(scene) is False; "
                "use scan='auto' to fall back")
        table, classes = pack_scene_tp(scene)
        return scan, table, NO_EMI, classes
    if scan == "fast":
        if not fast_scan_supported(scene):
            raise ValueError(
                "scan='fast' requested but fast_scan_supported(scene) is False "
                "(emitters with differing RGBs, roughness >= 4, or mtype not "
                "diffuse/specular); use scan='auto' to fall back")
        return scan, pack_scene(scene), scene_emissive_const(scene), ()
    if scan != "parity":
        raise ValueError(f"scan must be 'auto', 'parity', 'fast' or 'tp', got {scan!r}")
    return scan, pack_scene(scene), NO_EMI, ()


# ---- launch parameters shared by both kernels and their plain versions --------

def tp0_enabled(scan: str, tp0: bool, n_tris: int, bounces: int) -> bool:
    return bool(tp0 and scan == "tp" and n_tris <= TP0_MAX_TRIS
                and 1 <= bounces <= TP0_MAX_BOUNCES)


def tp0_table_for(table: torch.Tensor, cfg: RenderConfig, scan: str,
                  tp0: bool = True) -> torch.Tensor | None:
    """augment_table_tp0 for `cfg`'s eye, or None where the peel is off. Every launch
    of a render shares the table and the eye, so a render makes this once and passes
    it on as `tp0_table` instead of redoing its ~15 small device ops per launch."""
    if not tp0_enabled(scan, tp0, table.shape[0], cfg.bounces):
        return None
    return augment_table_tp0(table, cfg.camera.eye)


def _peel_table(table: torch.Tensor, cfg: RenderConfig,
                tp0_table: torch.Tensor | None) -> torch.Tensor:
    """The table a tp0-peeled launch reads: the caller's `tp0_table`, else made here."""
    if tp0_table is None:
        return augment_table_tp0(table, cfg.camera.eye)
    if (tp0_table.shape != table.shape or tp0_table.dtype != table.dtype
            or tp0_table.device != table.device or not tp0_table.is_contiguous()):
        raise ValueError("tp0_table must be tp0_table_for(table, cfg, 'tp'): contiguous, "
                         "with the table's shape, dtype and device")
    return tp0_table


def table_in_shared(table: torch.Tensor) -> bool:
    """Whether the linear kernels stage `table` in shared memory (else they read it
    from global memory): a function of its size only."""
    return table.numel() * table.element_size() <= SMEM_TABLE_MAX_BYTES


def check_table(name: str, t: torch.Tensor, cols: int, dtype=torch.float32) -> None:
    """Raise unless `t` is a contiguous (rows, cols) tensor of `dtype` on CUDA or CPU."""
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name} must be a CUDA or CPU tensor, got {t.device}")
    if t.dtype != dtype or t.dim() != 2 or t.shape[1] != cols:
        raise ValueError(f"{name} must be (N, {cols}) {dtype}, got "
                         f"{tuple(t.shape)} {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_call(table: torch.Tensor, cfg: RenderConfig, n_samples: int, scan: str,
               classes: tuple, n_rays: int) -> None:
    """Raise on anything the kernels do not take."""
    check_table("table", table, TABLE_COLS)
    if scan not in ("parity", "fast", "tp"):
        raise ValueError(f"scan must be 'parity', 'fast' or 'tp', got {scan!r}")
    if scan == "tp" and not 1 <= len(classes) <= TP_CLASS_CAP:
        raise ValueError(f"scan='tp' needs 1..{TP_CLASS_CAP} classes from pack_scene_tp")
    if cfg.bounces < 1 or n_samples < 1 or n_rays < 1:
        raise ValueError("bounces, n_samples and n_rays must be >= 1")
    if cfg.width < 1 or cfg.height < 1:
        raise ValueError("width and height must be >= 1")


class _Consts(NamedTuple):
    """The render's f32 constants as Python floats (exact), in the order
    `csrc/trace.cuh:params_from_host` reads them. 1/W etc. are rounded to f32 once,
    as the JAX kernel's weakly typed constants are."""

    view: tuple
    hol: tuple
    upd: tuple
    eye: tuple
    bg: tuple
    angle: float
    aspect: float
    inv_w: float
    inv_h: float
    eboost: float
    roffset: float

    @staticmethod
    @functools.lru_cache(maxsize=64)  # numpy's camera basis costs the host ~0.15 ms
    def of(cfg: RenderConfig) -> "_Consts":
        view, hol, upd, angle, eye = _camera_constants(cfg)

        def f32(*xs):
            return tuple(float(np.float32(x)) for x in xs)

        return _Consts(f32(*view), f32(*hol), f32(*upd), f32(*eye), f32(*cfg.bg_color),
                       *f32(angle, cfg.width / cfg.height, 1.0 / cfg.width,
                            1.0 / cfg.height, cfg.emissive_boost, cfg.ray_offset))

    def flat(self) -> list:
        return [x for v in self for x in (v if isinstance(v, tuple) else (v,))]


SCAN_CODES = {"parity": 0, "tp": 1, "fast": 2}  # csrc/trace.cuh SCAN_*


def host_params(cfg: RenderConfig, scan: str, classes: tuple, tp0_on: bool, n_tris: int,
                start_sample: int, n_samples: int, pid_base: int, n_rays: int,
                interleave: int = 1, emi_const: tuple = NO_EMI, smem: bool = False,
                n_nodes: int = 0, depth: int = 0):
    """(floats, ints) in the order `csrc/trace.cuh:params_from_host` reads them."""
    floats = _Consts.of(cfg).flat()
    floats += [float(np.float32(c)) for c in (emi_const if scan == "fast" else NO_EMI)]
    if scan == "tp":
        for alb, emi, rough, mty in classes:
            floats += [*alb, *emi, rough, mty]
    ints = [cfg.width, cfg.bounces, SCAN_CODES[scan], int(tp0_on), n_tris,
            len(classes) if scan == "tp" else 0, int(start_sample), n_samples,
            int(pid_base), n_rays, interleave, int(smem), n_nodes, depth]
    return floats, ints


# ---- plain PyTorch version -----------------------------------------------------
#
# Vectorized over pixels, with a Python loop over bounces and an in-order loop over
# the triangles (strict '<'); the same f32 operations in the same order as
# csrc/trace.cuh. Vectors are tuples of three tensors or Python floats (the table's
# f32 values, exact as Python floats).

def _dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _cross3(a, b):
    return (a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def _scale3(a, s):
    return (a[0] * s, a[1] * s, a[2] * s)


def _add3(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def _neg3(a):
    return (-a[0], -a[1], -a[2])


def _where3(c, a, b):
    return tuple(torch.where(c, x, y) for x, y in zip(a, b))


def _normalize3(a):
    return _scale3(a, torch.rsqrt(torch.clamp(_dot3(a, a), min=1e-40)))


def _safe_denom(x, eps=1e-8):
    return torch.where(torch.abs(x) > eps, x,
                       torch.where(x >= 0.0, torch.full_like(x, eps),
                                   torch.full_like(x, -eps)))


def _cols(rows: torch.Tensor, c: int):
    return (rows[:, c], rows[:, c + 1], rows[:, c + 2])


class _PlainScene:
    """The table plus the gather sources for the winners. tp's `classes` is the
    class tuple of pack_scene_tp or a (C, 8) class-table tensor on the table's
    device (the adjoint kernel's dynamic classes)."""

    def __init__(self, table: torch.Tensor, classes, scan: str,
                 emi_const: tuple = NO_EMI):
        self.n_tris = table.shape[0]
        self.scan = scan
        self.emi = tuple(float(np.float32(c)) for c in emi_const)
        # Row n_tris is the no-hit row: zeros, like the kernel's fresh best-hit state.
        self.table = torch.cat([table, torch.zeros((1, TABLE_COLS), dtype=table.dtype,
                                                   device=table.device)])
        if scan == "tp":
            # Row 0 is decode_tp_tc's default (no class selected): zeros, diffuse.
            if not isinstance(classes, torch.Tensor):
                classes = torch.tensor([[*a, *e, r, m] for a, e, r, m in classes],
                                       dtype=torch.float32, device=table.device)
            default = torch.tensor([[0.0] * 7 + [1.0]], dtype=torch.float32,
                                   device=table.device)
            self.classes = torch.cat([default, classes.reshape(-1, CLASS_COLS)])

    @functools.cached_property
    def rows(self) -> list:
        """The table as Python floats, for the linear scans' per-triangle loop."""
        return self.table[:self.n_tris].tolist()


# One triangle of each scan form, split in two. The test (`_tri_*`) gives the
# triangle's candidacy, its t (parity) or t numerator (fast, tp) and the
# denominator det (fast, tp); `_take` then orders it against the running best
# (num, den, row): t < best_t for parity, tnum * den < num * det for fast and tp.
# `col(c)` is column c of the triangle: a Python float (the linear scans' loop over
# table rows) or a tensor of gathered rows (the BVH leaves, which test a whole leaf
# window at once and order it one triangle at a time). csrc/trace.cuh test_parity /
# test_fast / test_tp, the same f32 operations in the same order.

def _fresh_best(ps: _PlainScene, n: int, device):
    return (torch.full((n,), T_MAX, dtype=torch.float32, device=device),
            torch.ones((n,), dtype=torch.float32, device=device),
            torch.full((n,), ps.n_tris, dtype=torch.int64, device=device))


def _take(cand, value, det, j, best):
    """Fold one triangle's test into the running best, in table order."""
    num, den, idx = best
    if det is None:
        sel = cand & (value < num)
        return torch.where(sel, value, num), den, torch.where(sel, j, idx)
    sel = cand & (value * den < num * det)
    return torch.where(sel, value, num), torch.where(sel, det, den), torch.where(sel, j, idx)


def _tri_parity(col, o, d, m):
    p1 = (col(0), col(1), col(2))
    e1 = (col(3), col(4), col(5))
    e2 = (col(6), col(7), col(8))
    pvec = _cross3(d, e2)
    det = _dot3(e1, pvec)
    front = det >= 1e-8
    inv_det = torch.reciprocal(torch.where(front, det, 1.0))
    tvec = (o[0] - p1[0], o[1] - p1[1], o[2] - p1[2])
    u = _dot3(tvec, pvec) * inv_det
    qvec = _cross3(tvec, e1)
    v = _dot3(d, qvec) * inv_det
    t = _dot3(e2, qvec) * inv_det
    cand = front & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 0.0)
    return cand, t, None


def _inside3(unum, vnum, det):
    return torch.minimum(torch.minimum(unum, vnum), det - (unum + vnum)) >= 0.0


def _tri_fast(col, o, d, m):
    p1 = (col(0), col(1), col(2))
    e1 = (col(3), col(4), col(5))
    e2 = (col(6), col(7), col(8))
    pvec = _cross3(d, e2)
    det = _dot3(e1, pvec)
    tvec = (o[0] - p1[0], o[1] - p1[1], o[2] - p1[2])
    unum = _dot3(tvec, pvec)
    qvec = _cross3(tvec, e1)
    vnum = _dot3(d, qvec)
    tnum = _dot3(e2, qvec)
    return (det >= 1e-8) & _inside3(unum, vnum, det) & (tnum > 0.0), tnum, det


def _tri_tp(col, o, d, m):
    nv = (col(0), col(1), col(2))
    e1 = (col(3), col(4), col(5))
    e2 = (col(6), col(7), col(8))
    c1 = (col(9), col(10), col(11))
    c2 = (col(12), col(13), col(14))
    det = _dot3(d, nv)
    tnum = col(15) - _dot3(o, nv)
    unum = _dot3(e2, m) - _dot3(d, c1)
    vnum = _dot3(d, c2) - _dot3(e1, m)
    return (det >= 1e-8) & _inside3(unum, vnum, det) & (tnum > 0.0), tnum, det


TRI_TESTS = {"parity": _tri_parity, "fast": _tri_fast, "tp": _tri_tp}


def _decode(ps: _PlainScene, best):
    """The best hit as shading attributes (best_t, n, albedo, emissive, rough, mtype):
    csrc/trace.cuh decode_parity / decode_fast / decode_tp."""
    num, den, idx = best
    win = ps.table[idx]
    if ps.scan == "parity":
        return num, _cols(win, 9), _cols(win, 12), _cols(win, 15), win[:, 18], win[:, 19]
    best_t = num / den
    if ps.scan == "fast":
        code = win[:, 23]
        emit = code >= 15.5
        code2 = code - torch.where(emit, 16.0, 0.0)
        spec = code2 >= 7.5
        rough = torch.clamp(code2 - torch.where(spec, 8.0, 4.0), min=0.0)
        mty = torch.where(spec, 2.0, 1.0)
        zero = torch.zeros_like(code)
        emi = tuple(torch.where(emit, zero + c, zero) for c in ps.emi)
        return best_t, _cols(win, 9), _cols(win, 12), emi, rough, mty
    bN = _cols(win, 0)
    inv = torch.reciprocal(torch.sqrt(torch.clamp(_dot3(bN, bN), min=1e-40)))
    cls = ps.classes[win[:, 16].to(torch.int64)]
    return (best_t, _scale3(bN, inv), _cols(cls, 0), _cols(cls, 3), cls[:, 6],
            cls[:, 7])


def _scan_best(ps: _PlainScene, o, d):
    """The first-min scan over every row in order: the best (num, den, row)."""
    best = _fresh_best(ps, d[0].shape[0], d[0].device)
    m = _cross3(o, d) if ps.scan == "tp" else None
    test = TRI_TESTS[ps.scan]
    for j, r in enumerate(ps.rows):
        best = _take(*test(r.__getitem__, o, d, m), j, best)
    return best


def _scan_linear(ps: _PlainScene, o, d):
    """The first-min scan, decoded (csrc/trace.cuh scan_linear)."""
    return _decode(ps, _scan_best(ps, o, d))


def _scan_tp0(ps: _PlainScene, d):
    best = _fresh_best(ps, d[0].shape[0], d[0].device)
    for j, r in enumerate(ps.rows):
        t0 = r[23]
        if not t0 > 0.0:
            continue
        det = _dot3(d, r[0:3])
        unum = _dot3(d, r[17:20])
        vnum = _dot3(d, r[20:23])
        best = _take((det >= 1e-8) & _inside3(unum, vnum, det), t0, det, j, best)
    return _decode(ps, best)


def _face_forward(n, d):
    """The normal flipped against the ray (csrc/trace.cuh face_forward)."""
    return _where3(_dot3(n, d) < 0.0, n, _neg3(n))


def _tangent_frame(n):
    """(ss, tt) completing n (csrc/trace.cuh tangent_frame)."""
    use_y = torch.abs(n[0]) > 0.001
    one = torch.ones_like(n[0])
    zero = torch.zeros_like(n[0])
    axis = _where3(use_y, (zero, one, zero), (one, zero, zero))
    tt = _normalize3(_cross3(axis, n))
    return _cross3(n, tt), tt


def _compose_dir(ss, tt, n, cphi, sphi, sin_t, cos_t):
    """csrc/trace.cuh compose_dir."""
    return _normalize3(_add3(_add3(_scale3(ss, cphi * sin_t), _scale3(tt, sphi * sin_t)),
                             _scale3(n, cos_t)))


def _sample_lobe(state, d, bn, brough, bmty):
    """The sampled BRDF lobe at the hits (csrc/trace.cuh sample_lobe): (state, n, wi,
    pdf, q), with n the normal flipped against the ray and q the albedo-free part of
    the BRDF (f = albedo * q): 1/pi diffuse, the GGX term specular, 0 where wi leaves
    the hemisphere."""
    n = _face_forward(bn, d)
    wo = _neg3(d)

    state, ud1 = krng.next_float(state)
    state, ud2 = krng.next_float(state)

    ss, tt = _tangent_frame(n)

    phi = TWO_PI * ud1
    cphi = torch.cos(phi)
    sphi = torch.sin(phi)

    wi_d = _compose_dir(ss, tt, n, cphi, sphi, torch.sqrt(ud2), torch.sqrt(1.0 - ud2))
    pdf_d = _dot3(wi_d, n) * INV_PI

    r2 = brough * brough
    cos_h = torch.sqrt((1.0 - ud2) / torch.clamp(ud2 * (r2 - 1.0) + 1.0, min=1e-12))
    sin_h = torch.sqrt(torch.clamp(1.0 - cos_h * cos_h, min=0.0))
    wh = _compose_dir(ss, tt, n, cphi, sphi, sin_h, cos_h)
    wi_s = _add3(_neg3(wo), _scale3(wh, 2.0 * _dot3(wo, wh)))
    same_hemi = _dot3(wi_s, n) * _dot3(wo, n) >= 0.0
    denom_ndf = cos_h * cos_h * (r2 - 1.0) + 1.0
    d_ndf = r2 * INV_PI / torch.clamp(denom_ndf * denom_ndf, min=1e-12)
    pdf_s = d_ndf * cos_h / _safe_denom(4.0 * _dot3(wo, wh))
    q_s = d_ndf / _safe_denom(4.0 * _dot3(wi_s, n) * _dot3(wo, n)) * 2.0  # ×2 :217
    pdf_s = torch.where(same_hemi, pdf_s, 0.0)
    q_s = torch.where(same_hemi, q_s, 0.0)

    bspec = bmty >= 1.5
    wi = _where3(bspec, wi_s, wi_d)
    pdf = torch.where(bspec, pdf_s, pdf_d)
    q = torch.where(bspec, q_s, INV_PI)
    return state, n, wi, pdf, q


def _advance(k: _Consts, o, d, mask, best_t, balb, n, wi, pdf, q, active):
    """Carry the paths along their lobes (csrc/trace.cuh advance): (o, d, mask,
    alive). A dead lane's f = albedo * q is never used."""
    alive = active & (pdf > 0.0)
    factor = _dot3(wi, n) / torch.where(pdf > 0.0, pdf, 1.0)
    f = _scale3(balb, q)
    mask = tuple(torch.where(alive, mask[c] * f[c] * factor, mask[c]) for c in range(3))

    hitp = _add3(o, _scale3(d, best_t))
    o = _add3(hitp, _scale3(wi, k.roffset))
    d = _where3(alive, wi, d)
    return o, d, mask, alive


def _shade(k: _Consts, path, hit):
    """Post-scan part of one bounce (megakernel.py shade_one)."""
    o, d, mask, rad, active, state = path
    best_t, bn, balb, bemi, brough, bmty = hit
    hit_mask = best_t < T_MAX

    miss = active & ~hit_mask
    rad = tuple(rad[c] + torch.where(miss, mask[c] * k.bg[c], 0.0) for c in range(3))
    active = active & hit_mask
    rad = tuple(rad[c] + torch.where(active, mask[c] * bemi[c] * k.eboost, 0.0)
                for c in range(3))

    state, n, wi, pdf, q = _sample_lobe(state, d, bn, brough, bmty)
    o, d, mask, alive = _advance(k, o, d, mask, best_t, balb, n, wi, pdf, q, active)
    return o, d, mask, rad, alive, state


def _camera_path(k: _Consts, cfg: RenderConfig, pid: torch.Tensor, frame: int):
    """Seed and camera ray of one frame (csrc/trace.cuh camera_path): the path state
    (o, d, mask, rad, active, rng state)."""
    px = (pid % cfg.width).to(torch.float32)
    py = (pid // cfg.width).to(torch.float32)

    state = krng.seed_from(pid, frame)
    state, u1 = krng.next_float(state)
    state, u2 = krng.next_float(state)
    x = px + u1 - 0.5
    y = py + u2 - 0.5
    sx = (2.0 * ((x + 0.5) * k.inv_w) - 1.0) * k.angle * k.aspect
    sy = -(1.0 - 2.0 * ((y + 0.5) * k.inv_h)) * k.angle
    d = _normalize3(tuple(sx * k.hol[c] - sy * k.upd[c] + k.view[c] for c in range(3)))
    zero = torch.zeros_like(px)
    o = tuple(zero + k.eye[c] for c in range(3))
    return (o, d, (zero + 1.0, zero + 1.0, zero + 1.0), (zero, zero, zero),
            torch.ones_like(px, dtype=torch.bool), state)


def _ray_path(o: torch.Tensor, d: torch.Tensor, rows: torch.Tensor, sample: int):
    """Seed and given rays (N, 3) of one sample (csrc/trace.cuh ray_path): no camera
    draws, so the stream's first two draws are bounce 0's."""
    zero = torch.zeros_like(o[:, 0])
    return (_cols(o, 0), _cols(d, 0), (zero + 1.0, zero + 1.0, zero + 1.0),
            (zero, zero, zero), torch.ones_like(zero, dtype=torch.bool),
            krng.seed_from(rows, sample))


def _trace_sample_plain(cfg: RenderConfig, pid: torch.Tensor, frame: int, nearest):
    """One 1-spp frame for pixels `pid`: (max(rad, 0) (N, 3), segments (N,) int32)."""
    k = _Consts.of(cfg)
    return _trace_path_plain(k, cfg, _camera_path(k, cfg, pid, frame), nearest)


def _trace_path_plain(k: _Consts, cfg: RenderConfig, path, nearest):
    """Trace started paths to their end: (max(rad, 0) (N, 3), segments (N,) int32).

    `nearest(bounce, o, d, active)` returns the decoded best hit of every ray; rays
    whose `active` is False may get any hit (the shading ignores them)."""
    segs = torch.zeros_like(path[4], dtype=torch.int32)

    for b in range(cfg.bounces):
        active = path[4]
        if not bool(active.any()):
            break
        segs = segs + active.to(torch.int32)
        path = _shade(k, path, nearest(b, path[0], path[1], active))
    rad = torch.stack(path[3], dim=1)
    return torch.clamp(rad, min=0.0), segs


def linear_nearest(ps: _PlainScene, tp0_on: bool = False):
    """`nearest` for _trace_sample_plain: the linear scan, tp0 on bounce 0 if on."""
    def nearest(b, o, d, active):
        if tp0_on and b == 0:
            return _scan_tp0(ps, d)
        return _scan_linear(ps, o, d)
    return nearest


def render_frames_plain(cfg: RenderConfig, start_sample: int, n_samples: int,
                        pid_base: int, n_pix: int, device, nearest):
    """Sum of `n_samples` frames in sample order + the segment count (int64)."""
    pid = torch.arange(pid_base, pid_base + n_pix, dtype=torch.int64, device=device)
    acc = torch.zeros((n_pix, 3), dtype=torch.float32, device=device)
    segs = torch.zeros((n_pix,), dtype=torch.int32, device=device)
    for s in range(n_samples):
        rad, sg = _trace_sample_plain(cfg, pid, int(start_sample) + s, nearest)
        acc = acc + rad
        segs = segs + sg
    return acc, segs.sum(dtype=torch.int64)


# The most (n_samples, n_pix, 3) f32 scratch a split kernel launch takes
# (csrc/split.cuh): the linear kernels give each pixel (or row) to one lane past it,
# the 8-wide kernel splits the samples over launches.
SCRATCH_MAX_BYTES = 1 << 30


def default_run(n_samples: int, n_pix: int) -> int:
    """DEFAULT_RUN while the (n_samples, n_pix, 3) f32 scratch buffer fits
    SCRATCH_MAX_BYTES, else n_samples (a pixel or row a lane, no scratch)."""
    return DEFAULT_RUN if n_samples * n_pix * 12 <= SCRATCH_MAX_BYTES else n_samples


def render_frames_split_plain(cfg: RenderConfig, start_sample: int, n_samples: int,
                              pid_base: int, n_pix: int, device, nearest):
    """The split kernels' first pass (csrc/split.cuh): each sample's max(rad, 0)
    in a (n_samples, n_pix, 3) scratch buffer + the segment count (int64)."""
    pid = torch.arange(pid_base, pid_base + n_pix, dtype=torch.int64, device=device)
    scratch = torch.empty((n_samples, n_pix, 3), dtype=torch.float32, device=device)
    segs = torch.zeros((), dtype=torch.int64, device=device)
    for s in range(n_samples):
        scratch[s], sg = _trace_sample_plain(cfg, pid, int(start_sample) + s, nearest)
        segs = segs + sg.sum(dtype=torch.int64)
    return scratch, segs


def sample_sum_plain(scratch: torch.Tensor, interleave: int = 1) -> torch.Tensor:
    """csrc/split.cuh sample_sum: stream i adds the samples s = i mod k in ascending
    order from 0, then the streams are added in ascending order from 0."""
    zeros = torch.zeros_like(scratch[0])
    total = zeros
    for i in range(min(interleave, scratch.shape[0])):
        acc = zeros
        for s in range(i, scratch.shape[0], interleave):
            acc = acc + scratch[s]
        total = total + acc
    return total


def _render_samples_stats_plain(table: torch.Tensor, cfg: RenderConfig, start_sample: int,
                                n_samples: int, pid_base: int = 0,
                                n_rays: int | None = None, scan: str = "parity",
                                classes: tuple = (), tp0: bool = True,
                                tp0_table: torch.Tensor | None = None,
                                emi_const: tuple = NO_EMI):
    """The kernel's plain PyTorch version: (img (n_rays, 3) f32, segments int64)."""
    n_pix = n_rays if n_rays is not None else cfg.n_pixels
    tp0_on = tp0_enabled(scan, tp0, table.shape[0], cfg.bounces)
    if tp0_on:
        table = _peel_table(table, cfg, tp0_table)
    ps = _PlainScene(table, classes, scan, emi_const)
    return render_frames_plain(cfg, start_sample, n_samples, pid_base, n_pix, table.device,
                               linear_nearest(ps, tp0_on))


# ---- the kernel's entry point ----------------------------------------------------

@profiling.spanned("kernel.megakernel")
def render_samples_pallas_stats(table: torch.Tensor, cfg: RenderConfig, start_sample: int,
                                n_samples: int, pid_base: int = 0,
                                n_rays: int | None = None, scan: str = "parity",
                                classes: tuple = (), tp0: bool = True,
                                tp0_table: torch.Tensor | None = None,
                                emi_const: tuple = NO_EMI, run: int | None = None):
    """SUM of `n_samples` progressive 1-spp frames + traced-segment count.

    Returns (img (n_rays, 3) f32, segments () int64). `table` is pack_scene's
    (parity, fast with its `emi_const`) or pack_scene_tp's (tp, with its
    `classes`): prepare_scan returns all three. A device rendering pixels
    [pid_base, pid_base + n_rays) passes its offset so RNG and camera stay keyed on
    absolute ids. `tp0` (tp only): peel bounce 0 onto the collapsed scan, under
    the gate of `tp0_enabled`; `tp0_table` is `tp0_table_for`'s result, made once
    per render (without it each launch augments the table itself). `run`: samples
    of one pixel a lane takes at a time (default `default_run`), which moves no bit.

    A CUDA table launches `csrc/megakernel.cu` (table in shared memory where
    `table_in_shared`, else in global memory); a CPU table runs the plain version.
    """
    n_pix = n_rays if n_rays is not None else cfg.n_pixels
    check_call(table, cfg, n_samples, scan, classes, n_pix)
    run = check_run(run, n_samples, n_pix)
    if table.device.type == "cpu":
        return _render_samples_stats_plain(table, cfg, start_sample, n_samples, pid_base,
                                           n_pix, scan, classes, tp0, tp0_table, emi_const)
    from oclpathtracer_tpu_torch.kernels import cuda_build

    tp0_on = tp0_enabled(scan, tp0, table.shape[0], cfg.bounces)
    if tp0_on:
        table = _peel_table(table, cfg, tp0_table)
    check_rows4(table)
    floats, ints = host_params(cfg, scan, classes, tp0_on, table.shape[0], start_sample,
                               n_samples, pid_base, n_pix, emi_const=emi_const,
                               smem=table_in_shared(table))
    out, scratch, counters = split_buffers(n_samples, n_pix, run, table.device)
    cuda_build.launch("opt_megakernel_launch", (table,), floats,
                      ints + [run], out, scratch, counters)
    profiling.count("launch.megakernel")
    return out, counters[0]


def check_run(run: int | None, n_samples: int, n_pix: int) -> int:
    """The launch's run: `default_run(n_samples, n_pix)` where `run` is None, else
    `run` capped at n_samples; raise unless run >= 1."""
    run = default_run(n_samples, n_pix) if run is None else run
    if run < 1:
        raise ValueError(f"run must be >= 1, got {run}")
    return min(run, n_samples)


def check_rows4(table: torch.Tensor) -> None:
    """Raise unless the (T, 24) table's base is 16-byte aligned: the kernels read its
    96-byte rows as float4s."""
    if table.data_ptr() % 16:
        raise ValueError("the table must start on a 16-byte boundary (the kernels read "
                         "float4s): pass a fresh contiguous tensor")


def split_buffers(n_samples: int, n_pix: int, run: int, device):
    """The linear kernels' outputs: (out (n_pix, 3), the (n_samples, n_pix, 3) scratch
    buffer where run < n_samples else None, the two int64 counters: segments and the
    queue's head, zero)."""
    out = torch.empty((n_pix, 3), dtype=torch.float32, device=device)
    scratch = None
    if run < n_samples:
        scratch = torch.empty((n_samples, n_pix, 3), dtype=torch.float32, device=device)
    return out, scratch, torch.zeros((2,), dtype=torch.int64, device=device)


def render_samples_pallas(table: torch.Tensor, cfg: RenderConfig, start_sample: int,
                          n_samples: int, scan: str = "parity", classes: tuple = (),
                          tp0_table: torch.Tensor | None = None,
                          emi_const: tuple = NO_EMI) -> torch.Tensor:
    """SUM of `n_samples` progressive 1-spp frames: (n_pixels, 3) f32."""
    img, _ = render_samples_pallas_stats(table, cfg, start_sample, n_samples, scan=scan,
                                         classes=classes, tp0_table=tp0_table,
                                         emi_const=emi_const)
    return img


def render_pallas(scene: Scene, cfg: RenderConfig, total_spp: int,
                  samples_per_call: int = 0, scan: str = "auto") -> torch.Tensor:
    """Progressive mean image via the megakernel (host loop over sample chunks), on
    the scene's device."""
    scan, table, emi, classes = prepare_scan(scene, scan)
    tp0_table = tp0_table_for(table, cfg, scan)
    chunk = samples_per_call or total_spp
    acc = torch.zeros((cfg.n_pixels, 3), dtype=torch.float32, device=table.device)
    s = 0
    while s < total_spp:
        n = min(chunk, total_spp - s)
        acc = acc + render_samples_pallas(table, cfg, s, n, scan=scan, classes=classes,
                                          tp0_table=tp0_table, emi_const=emi)
        s += n
    return acc / total_spp


# ---- arbitrary rays: the boundary estimators' probes ------------------------------

def _ray_samples_plain(table: torch.Tensor, o: torch.Tensor, d: torch.Tensor,
                       cfg: RenderConfig, n_samples: int, row_base: int, start_sample: int,
                       scan: str, classes: tuple, emi_const: tuple):
    """Each sample's (max(rad, 0) (N, 3), segments (N,) int32) of the rows, in order."""
    ps = _PlainScene(table, classes, scan, emi_const)
    k = _Consts.of(cfg)
    nearest = linear_nearest(ps)
    rows = torch.arange(row_base, row_base + o.shape[0], dtype=torch.int64, device=o.device)
    for s in range(n_samples):
        yield _trace_path_plain(k, cfg, _ray_path(o, d, rows, int(start_sample) + s), nearest)


def _trace_rays_stats_plain(table: torch.Tensor, o: torch.Tensor, d: torch.Tensor,
                            cfg: RenderConfig, n_samples: int, row_base: int = 0,
                            start_sample: int = 0, scan: str = "parity", classes: tuple = (),
                            emi_const: tuple = NO_EMI):
    """trace_rays' plain PyTorch version: (radiance sum (N, 3) f32, segments int64)."""
    acc = torch.zeros((o.shape[0], 3), dtype=torch.float32, device=o.device)
    segs = torch.zeros((o.shape[0],), dtype=torch.int32, device=o.device)
    for rad, sg in _ray_samples_plain(table, o, d, cfg, n_samples, row_base, start_sample,
                                      scan, classes, emi_const):
        acc = acc + rad
        segs = segs + sg
    return acc, segs.sum(dtype=torch.int64)


def trace_rays_split_plain(table: torch.Tensor, o: torch.Tensor, d: torch.Tensor,
                           cfg: RenderConfig, n_samples: int, row_base: int = 0,
                           start_sample: int = 0, scan: str = "parity", classes: tuple = (),
                           emi_const: tuple = NO_EMI):
    """trace_rays' split first pass (csrc/split.cuh): each sample's max(rad, 0) in a
    (n_samples, N, 3) scratch buffer + the segment count (int64); sample_sum_plain
    with k = 1 then gives `_trace_rays_stats_plain`'s sum."""
    scratch = torch.empty((n_samples, o.shape[0], 3), dtype=torch.float32, device=o.device)
    segs = torch.zeros((), dtype=torch.int64, device=o.device)
    for s, (rad, sg) in enumerate(_ray_samples_plain(table, o, d, cfg, n_samples, row_base,
                                                     start_sample, scan, classes, emi_const)):
        scratch[s] = rad
        segs = segs + sg.sum(dtype=torch.int64)
    return scratch, segs


@profiling.spanned("kernel.trace_rays")
def trace_rays_pallas_stats(table: torch.Tensor, o: torch.Tensor, d: torch.Tensor,
                            cfg: RenderConfig, n_samples: int, row_base: int = 0,
                            start_sample: int = 0, scan: str = "parity", classes: tuple = (),
                            emi_const: tuple = NO_EMI, run: int | None = None):
    """SUM of `n_samples` path traces along ARBITRARY rays (o, d) (N, 3) f32.

    Returns (radiance_sum (N, 3) f32, segments () int64). Sample s of row i keys the
    reference RNG on (row_base + i, start_sample + s), with no camera draws: two calls
    with equal row counts and the same row_base share their streams row for row (the
    CRN pairing of the ± edge probes). `cfg.width`/`height` are not read; bounces,
    background, boost and offset are. No tp0 peel. `run`: samples of one row a lane
    takes at a time (default `default_run`), which moves no bit. The JAX knobs
    `interleave`, `scan_chunks` and `tri_unroll` schedule the TPU and are not taken.

    A CUDA table launches `csrc/trace_rays.cu`; a CPU table runs the plain version,
    which equals the twin `trace_paths` on `ref_uniforms(rows, s, 2 * bounces)`.
    """
    n = o.shape[0]
    check_call(table, cfg, n_samples, scan, classes, n)
    check_table("o", o, 3)
    check_table("d", d, 3)
    if o.shape != d.shape or o.device != table.device or d.device != table.device:
        raise ValueError("o and d must be (N, 3) on the table's device")
    run = check_run(run, n_samples, n)
    if table.device.type == "cpu":
        return _trace_rays_stats_plain(table, o, d, cfg, n_samples, row_base, start_sample,
                                       scan, classes, emi_const)
    from oclpathtracer_tpu_torch.kernels import cuda_build

    check_rows4(table)
    # The launch's pid_base carries row_base.
    floats, ints = host_params(cfg, scan, classes, False, table.shape[0], start_sample,
                               n_samples, row_base, n, emi_const=emi_const,
                               smem=table_in_shared(table))
    out, scratch, counters = split_buffers(n_samples, n, run, table.device)
    cuda_build.launch("opt_trace_rays_launch", (table, o, d), floats, ints + [run], out,
                      scratch, counters)
    profiling.count("launch.trace_rays")
    return out, counters[0]
