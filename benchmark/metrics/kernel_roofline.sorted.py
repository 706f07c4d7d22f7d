"""kernel_roofline.sorted: the sorted wavefront's bounce kernel's share of its roofline
over the traced window of the sorted jobs, counted as `counts/bounds.py` counts the
bounce kernel: the skip-link walk of every traced segment (the boxes and leaf
triangles a segment tests, frozen in `counts/spheres_5k.py`, and each segment's own
work, `bounds.bvh_ops`, parity), the camera of each path on the first launch, and
`RAY_STATE_BYTES` written for every segment and read for every segment but a path's
first; the least time of operations and bytes (`bounds.bound_ms`) over the device
time of the port's kernels (the bounce kernel; the image's assembly is torch's)."""

from benchmark.counts import bounds, spheres_5k
from benchmark.metrics._roofline import kernels_s


def read(run):
    seg, paths = run.counts.get("segments"), run.counts.get("paths")
    t = kernels_s(run)
    if not seg or not paths or t <= 0:
        return None
    ops = (bounds.bvh_ops(spheres_5k.SCAN, spheres_5k.BOXES_PER_SEGMENT * seg,
                          spheres_5k.TRIS_PER_SEGMENT * seg, seg)
           + paths * bounds.CAMERA_OPS)
    least_ms, _ = bounds.bound_ms(ops, bounds.RAY_STATE_BYTES * (2 * seg - paths))
    return 100.0 * least_ms * 1e-3 / t
