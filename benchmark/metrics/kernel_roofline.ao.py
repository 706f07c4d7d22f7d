"""kernel_roofline.ao: the AO kernel's share of its FP32 roofline over the traced
window of the AO jobs: the operations of a job's work (`bounds.fast_ops("ao", ...)` of
the camera rays, the eye rows their scan tests, the AO rays and the triangles their
any-hit scans test, frozen in `counts/cornell_fast.py`) times the window's jobs, over
the device time of the port's kernels (the AO kernel; the image's sum and mean are
torch's)."""

from benchmark.counts import bounds, cornell_fast
from benchmark.metrics._roofline import share


def read(run):
    if not run.window.units:
        return None
    return share(run, run.window.units * bounds.fast_ops("ao", cornell_fast.AO))
