"""kernel_roofline.direct: the direct-NEE kernel's share of its FP32 roofline over the
traced window of the direct-illumination jobs: the operations of a job's work
(`bounds.fast_ops("direct", ...)` of the camera rays, the eye rows their scan tests,
their hits, the shadow rays, the triangles their any-hit scans test and the unblocked
ones, frozen in `counts/cornell_fast.py`) times the window's jobs, over the device time
of the port's kernels (the direct kernel; the image's sum and mean are torch's)."""

from benchmark.counts import bounds, cornell_fast
from benchmark.metrics._roofline import share


def read(run):
    if not run.window.units:
        return None
    return share(run, run.window.units * bounds.fast_ops("direct", cornell_fast.DIRECT,
                                                         cornell_fast.N_LIGHTS))
