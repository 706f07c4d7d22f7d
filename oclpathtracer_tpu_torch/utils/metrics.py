"""Observability counters — samples/s, rays/s, per-phase timings.

Counterpart of `oclpathtracer_tpu.utils.metrics` (≡ SURVEY.md §5.5: the
reference's observability is debug printf + memory getters + compile callbacks):
throughput counters around the render and train steps, the first call's extra
latency logged as its compile (here the kernels' build at first use).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

from oclpathtracer_tpu_torch.utils.errors import logger


@dataclasses.dataclass
class RenderMetrics:
    """Running throughput accounting for a progressive render / train loop."""

    n_pixels: int
    samples_done: int = 0
    segments_done: float = 0.0
    elapsed_s: float = 0.0
    compile_s: float = 0.0
    _t0: Optional[float] = None

    def start(self) -> "RenderMetrics":
        self._t0 = time.perf_counter()
        return self

    def step(self, samples: int, segments: float = 0.0,
             first_call: bool = False) -> None:
        dt = time.perf_counter() - self._t0
        self._t0 = time.perf_counter()
        if first_call:
            # ≡ the reference's CompileCallback bracket (Adl.h:23-30): the first
            # call's extra latency IS the compile.
            self.compile_s += dt
            logger.info("compile/first-call: %.2fs", dt)
        else:
            self.elapsed_s += dt
        self.samples_done += samples
        self.segments_done += segments

    @property
    def samples_per_s(self) -> float:
        return self.samples_done / self.elapsed_s if self.elapsed_s else 0.0

    @property
    def mrays_per_s(self) -> float:
        return self.segments_done / self.elapsed_s / 1e6 if self.elapsed_s else 0.0

    def summary(self) -> Dict[str, float]:
        return {
            "samples": self.samples_done,
            "samples_per_s": round(self.samples_per_s, 2),
            "mrays_per_s": round(self.mrays_per_s, 2),
            "elapsed_s": round(self.elapsed_s, 3),
            "compile_s": round(self.compile_s, 3),
        }
