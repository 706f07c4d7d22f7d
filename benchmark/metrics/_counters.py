"""The program's counters (`oclpathtracer_tpu_torch.runtime.profiling.counts()`): its
host counters and the counters its kernels keep on the card, read once after the
traced window (the device counters with one copy from the card).

The 8-wide BVH kernel counts what its walk did (`wide_bvh.<count>`) only while a
profiler runs, and a process runs one profiler session, the traced window: set-up's
job and the check's launches run without one. So the counts read after the window are
the window's own."""


def counts() -> dict:
    """{name: count} of the program's counters; {} where the program keeps none."""
    try:
        from oclpathtracer_tpu_torch.runtime import profiling
    except ImportError:
        return {}
    read = getattr(profiling, "counts", None)
    return read() if read is not None else {}


def ratio(run, numerator: str, denominator: str, scale: float = 1.0):
    """scale × the counter `numerator` over the counter `denominator`; None where
    either counter is missing, the denominator is 0 or the window holds no unit."""
    now = counts()
    num, den = now.get(numerator), now.get(denominator)
    if num is None or not den or not run.window.units:
        return None
    return scale * num / den
