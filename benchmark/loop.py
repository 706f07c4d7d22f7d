"""The one load generator: a closed loop of units (a render job, a frame, a train
step) for a fixed number of seconds.

A unit is issued only after the previous one returned, and with `wait_each`
after the device finished it (a client waiting for its image); otherwise the loop
never waits itself and the unit decides when the host reads a result (a training
loop reading its loss every tenth step). The window opens after a synchronize and
closes after the last unit and a synchronize, so every unit issued in it is done.
Per unit it records the host time from issue to the unit's return (the host's share)
and, where it synchronizes each unit, to the unit's end on the device (its latency).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch


@dataclass
class Window:
    units: int = 0
    seconds: float = 0.0
    host_s: list = field(default_factory=list)     # issue to return, per unit
    latency_s: list = field(default_factory=list)  # issue to device end, per unit


def closed_loop(unit, seconds: float, wait_each: bool, device: torch.device,
                first: int = 0) -> Window:
    """Run unit(first), unit(first + 1), ... until `seconds` have passed."""

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    w = Window()
    sync()
    t0 = time.perf_counter()
    deadline = t0 + seconds
    i = first
    while True:
        a = time.perf_counter()
        unit(i)
        b = time.perf_counter()
        w.host_s.append(b - a)
        if wait_each:
            sync()
            b = time.perf_counter()
            w.latency_s.append(b - a)
        i += 1
        if b >= deadline:
            break
    sync()
    w.seconds = time.perf_counter() - t0
    w.units = i - first
    return w
