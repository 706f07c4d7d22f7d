"""A frozen copy of the port's operation counts (oclpathtracer_tpu_torch/kernels/bounds.py),
the yardstick of the roofline metrics: a later change to the program does not move
it. Its own docstring follows.

The least time an H100 could take for a kernel's work: the bound that
`chip_smoke.py` prints beside each kernel's time.

    bound = max(FP32 operations / 67 TFLOP/s, bytes / 3.35 TB/s)

(NVIDIA's H100 SXM data sheet: FP32 outside the tensor cores, HBM3.) Bytes count
each input read once and each output written once. Operations are counted from the
device code, csrc/trace.cuh and csrc/bvh.cuh, on the work this run's data needs:
every FP32 add, subtract, multiply, divide, square root, sine, cosine, min, max and
comparison is one operation. The data sheet's 67 TFLOP/s counts a fused multiply-add
as two, and the kernels are built with -fmad=false, so the bound is optimistic by up
to 2×: a lower bound either way. The shading count is that of a hit (a miss does
less), which overstates at most about 10 % of a segment's operations at the Cornell
box's 36 triangles, where the scan dominates.

The AO and direct kernels (csrc/fast_integrators.cu) are counted as they cast rays:
every camera ray with its scan, and the second ray (AO's cosine ray, direct's
shadow ray) only where the kernel casts it, its any-hit scan up to and including
the first blocker; the plain versions count these at the timed shape. Both
kernels' camera scans test only the rows a ray from the eye can hit, each in its
collapsed form (EYE_TRI_OPS), and the plain versions report how many rows they keep
(`counts["eye_rows"]`; the terms computed once a block, 18 operations a row, are
left out: under 0.1 % at the Cornell box). The sorted wavefront's bounce kernel is
counted as the skip-link walk (`bvh_ops`, parity), the camera of each ray on the
first launch, and RAY_STATE_BYTES written per live ray per launch and read per live
ray per launch after the first.
"""

from __future__ import annotations

H100_FP32_OPS = 67e12   # FP32 operations per second
H100_HBM_BYTES = 3.35e12  # device-memory bytes per second

# One triangle test (trace.cuh test_parity / test_fast / test_tp, and scan_tp0's
# collapsed bounce-0 form): products, differences, the inside test and the ordering.
TRI_OPS = {"parity": 53, "fast": 51, "tp": 43}
TP0_TRI_OPS = 25
# The AO and direct kernels' camera-ray row (fast_integrators.cu scan_eye_rows4):
# the parity test without tvec, qvec and tnum, which depend on the eye alone (17 operations).
EYE_TRI_OPS = 36
TP_RAY_OPS = 9  # m = cross(o, d), once per tp scan
# decode_parity / decode_fast / decode_tp (+ 3 per material class for tp's select).
DECODE_OPS = {"parity": 0, "fast": 6, "tp": 12}
TP_CLASS_DECODE_OPS = 3
# shade_emit 10 + sample_lobe 174 + advance 28 + two RNG draws' conversions 4.
SHADE_OPS = 216
# bvh.cuh: the slab test of one box (12 products and differences, 10 min/max, the
# t_far >= max(t_near, 0) test) plus the nearer-than-best test; 1/d once a segment.
BOX_OPS = 25
INV_DIR_OPS = 9
# trace.cuh camera_path: two draws' conversions, the jitter, the screen coordinates,
# the direction and its normalize.
CAMERA_OPS = 42
# fast_integrators.cu. AO at a hit: the flipped normal, two draws, cosine_dir, the
# hit point and the offset origin. Direct at a hit: the flipped normal, hit point,
# emission, three draws, the point on the light, the direction, distance and
# cosines (plus one compare a light); a shadow ray cast: its origin and t_max; an
# unblocked one: the diffuse lobe's BRDF (the specular lobe adds about 40), the
# geometry term and the radiance update.
AO_RAY_OPS = 88
DIRECT_HIT_OPS = 76
SHADOW_RAY_OPS = 8
DIRECT_LIT_OPS = 22
# sorted_wavefront.cu: o, d, mask, rad (12 bytes each), live and rng (4 each) of a
# live ray (in a 64-byte row, 8 bytes of it unused), written by each launch and read
# by each but the first (which starts the rays from the camera).
RAY_STATE_BYTES = 56
# grad_megakernel.cu, per segment with gradients: 7, plus 21 per material class.
ADJOINT_SEG_OPS = 7
ADJOINT_CLASS_OPS = 21


def bound_ms(ops: float, nbytes: float) -> tuple[float, str]:
    """(the least time in ms, "operations" or "bytes": which of the two binds)."""
    t_ops = ops / H100_FP32_OPS * 1e3
    t_bytes = nbytes / H100_HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _segment_tail(scan: str, n_classes: int) -> int:
    return DECODE_OPS[scan] + (TP_CLASS_DECODE_OPS * n_classes if scan == "tp" else 0) + SHADE_OPS


def linear_ops(scan: str, n_tris: int, segments: int, paths: int = 0, tp0: bool = False,
               n_classes: int = 0) -> float:
    """FP32 operations of `segments` linear-scan segments (megakernel, wavefront,
    trace_rays); with the tp0 peel the first segment of each of the `paths` paths
    runs the collapsed scan."""
    scan_ops = TRI_OPS[scan] * n_tris + (TP_RAY_OPS if scan == "tp" else 0)
    first = paths if tp0 else 0
    return (first * TP0_TRI_OPS * n_tris + (segments - first) * scan_ops
            + segments * _segment_tail(scan, n_classes))


def bvh_ops(scan: str, boxes: float, tris: float, segments: int, n_classes: int = 0) -> float:
    """FP32 operations of `segments` BVH-walk segments that test `boxes` boxes and
    `tris` leaf triangles in all."""
    per_seg = INV_DIR_OPS + (TP_RAY_OPS if scan == "tp" else 0) + _segment_tail(scan, n_classes)
    return boxes * BOX_OPS + tris * TRI_OPS[scan] + segments * per_seg


def adjoint_ops(n_classes: int, segments: int) -> float:
    """The adjoint kernel's FP32 operations beyond its forward."""
    return segments * (ADJOINT_SEG_OPS + ADJOINT_CLASS_OPS * n_classes)


def fast_ops(kind: str, counts: dict, n_lights: int = 0) -> float:
    """FP32 operations of the AO ("ao") or direct ("direct") kernel for the work the
    plain version counted (fast_integrators._new_counts): every camera ray scans the
    `eye_rows` rows kept, collapsed, and the second rays test `tris` triangles in
    all."""
    per_camera = CAMERA_OPS + 1 + EYE_TRI_OPS * counts["eye_rows"] + (1 if kind == "ao" else 3)
    ops = counts["camera"] * per_camera + counts["tris"] * TRI_OPS["parity"]
    if kind == "ao":
        return ops + counts["rays"] * AO_RAY_OPS
    return (ops + counts["hits"] * (DIRECT_HIT_OPS + n_lights)
            + counts["rays"] * SHADOW_RAY_OPS + counts["lit"] * DIRECT_LIT_OPS)
