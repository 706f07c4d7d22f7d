"""frame_p95_ms: the 95th percentile over every frame of the window of the host time
from the frame's issue to the end of its synchronize."""

import statistics


def read(run):
    lat = run.window.latency_s
    return statistics.quantiles(lat, n=20)[-1] * 1e3 if len(lat) >= 20 else None
