"""kernel_roofline.adjoint: the kernel train step's launches' share of their FP32
roofline over the traced window: each step's two forwards and two adjoint launches
trace the same segments, so the work is twice their linear-scan operations plus the
adjoint's own (`bounds.adjoint_ops`), over the device time of the port's kernels
(the adjoint kernel, its gradient and sample sums)."""

from benchmark.counts import bounds
from benchmark.metrics._roofline import SCAN, share


def read(run):
    seg = run.counts.get("segments")
    if not seg:
        return None
    ops = (2 * bounds.linear_ops(SCAN, run.n_tris, seg, n_classes=run.n_classes)
           + bounds.adjoint_ops(run.n_classes, seg))
    return share(run, ops)
