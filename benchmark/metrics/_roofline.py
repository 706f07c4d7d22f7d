"""A kernel's share of its roofline: the least time the H100 could take for the work
(the frozen operation counts of `counts/bounds.py` for the segments traced, at the
scene's triangle and material-class counts, tp scan form), over the device time of
the port's hand-written kernels (names in the `opt::` namespace) in the trace, in %.
The work is counted in operations; its bytes (the scene table in, an image out) are
under a thousandth of the time the operations bound."""

from benchmark.counts import bounds

SCAN = "tp"


def kernels_s(run) -> float:
    return run.trace.device_s(lambda name: "opt::" in name) if run.trace else 0.0


def share(run, ops: float):
    t = kernels_s(run)
    if t <= 0 or not ops:
        return None
    least_ms, _ = bounds.bound_ms(ops, 0.0)
    return 100.0 * least_ms * 1e-3 / t


def render_share(run):
    """The render kernels' share: linear-scan operations of the traced segments (no
    first-bounce peel) over their device time."""
    seg = run.counts.get("segments")
    if not seg:
        return None
    return share(run, bounds.linear_ops(SCAN, run.n_tris, seg, n_classes=run.n_classes))
