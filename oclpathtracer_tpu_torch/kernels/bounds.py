"""The least time an H100 could take for a kernel's work: the bound that
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
"""

from __future__ import annotations

H100_FP32_OPS = 67e12   # FP32 operations per second
H100_HBM_BYTES = 3.35e12  # device-memory bytes per second

# One triangle test (trace.cuh test_parity / test_fast / test_tp, and scan_tp0's
# collapsed bounce-0 form): products, differences, the inside test and the ordering.
TRI_OPS = {"parity": 53, "fast": 51, "tp": 43}
TP0_TRI_OPS = 25
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
