"""driver_host_ms.frames: the mean host time per frame from its issue to the return of
the driver's step call, before its synchronize (a span in the benchmark's loop)."""


def read(run):
    host = run.window.host_s
    return sum(host) / len(host) * 1e3 if host else None
