"""kernel_roofline.vertex: the vertex step's kernel launches' share of their FP32
roofline over the traced window: each step's two parity megakernel renders and four
arbitrary-ray probe launches scan every triangle for every segment they trace, so the
work is the parity linear scan's operations (`bounds.linear_ops`) of the segments
their stats calls return (`counts["segments"]`, counted in set-up), over the device
time of the port's kernels (those two: the step's materials take no gradient, so the
material gathers' backward kernel does not run)."""

from benchmark.counts import bounds
from benchmark.metrics._roofline import share


def read(run):
    seg = run.counts.get("segments")
    if not seg:
        return None
    return share(run, bounds.linear_ops("parity", run.n_tris, seg))
