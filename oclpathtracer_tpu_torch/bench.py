"""Benchmark: Mrays/s of the Cornell-box path trace — the port's counterpart of the
root `bench.py`.

    python -m oclpathtracer_tpu_torch bench        (or python -m oclpathtracer_tpu_torch.bench)

Prints ONE JSON line {"metric", "value", "unit", "anchor_value", "ratio_vs_anchor",
"value_16b", "anchor_16b", "ratio_vs_anchor_16b"}; the rates are Mrays/s, unrounded.

Workload: the reference's canonical scene and resolution (512x512, cornellbox.bin, 36
tris — RaytraceTest.cpp:219), frames SPP_WARM .. SPP_WARM + SPP_BENCH - 1 of the
reference's RNG streams summed in one kernel launch, at 4 bounces (64 frames) and at
the reference's 16-bounce cap (32 frames).

Two configurations of each depth are timed in one process, paired and alternating
(A B A B ...), so that the ratio of each pair cancels the card's drift:

  A (anchor): the parity-scan megakernel (`kernels/csrc/megakernel.cu`), the
     reference-exact arithmetic, frozen; at 16 bounces the same kernel.
  B (value):  what `prepare_scan(scene, "auto")` picks — the tp scan with the tp0
     peel in the megakernel at 4 bounces; at 16 bounces the tp path-regeneration
     kernel (`kernels/csrc/wavefront.cu`), the auto driver's pick past 8 bounces.

What a timed call includes: the launch, its output buffers and the synchronizing
read of its segment count. The tp0 table (`tp0_table_for`) and the wavefront's scan
table (`scan_table`) are made once before any timing, as a render makes them once
(the root bench makes both inside its jitted call). Every configuration is called
once before the timing (the first call builds the kernels).

Timing is the root bench's rule: the host clock around one call, ending with
`int(segs)`, which waits for the launch. "value" and "anchor_value" are each
configuration's best rate; "ratio_vs_anchor" is the MEDIAN of the per-pair B/A
ratios. Rays are TRACED segments, from the kernel's own tally: dead lanes do not
count. The root bench's "vs_baseline" is left out: its divisor is a TPU figure.
"""

from __future__ import annotations

import json
import statistics
import time

import torch

from oclpathtracer_tpu_torch.config import RenderConfig
from oclpathtracer_tpu_torch.kernels import megakernel as mk
from oclpathtracer_tpu_torch.kernels import wavefront as wf
from oclpathtracer_tpu_torch.scene import load_cornell_box

WIDTH = HEIGHT = 512
BOUNCES = 4
BOUNCES_DEEP = 16   # the reference's BOUNCES cap (GenerateColors.cl:5)
SPP_WARM = 4
SPP_BENCH = 64
SPP_BENCH_DEEP = 32
PAIRS = 6


def make_runs(scene, width: int = WIDTH, height: int = HEIGHT, bounces: int = BOUNCES,
              bounces_deep: int = BOUNCES_DEEP, spp_warm: int = SPP_WARM,
              spp_bench: int = SPP_BENCH, spp_bench_deep: int = SPP_BENCH_DEEP) -> dict:
    """The four timed calls on `scene`'s device: {"anchor", "auto", "anchor16",
    "auto16"} → fn() returning (image SUM (n_pixels, 3), traced segments)."""
    cfg = RenderConfig(width=width, height=height, bounces=bounces)
    cfg16 = RenderConfig(width=width, height=height, bounces=bounces_deep)
    scan_b, table_b, emi_b, classes_b = mk.prepare_scan(scene, "auto")
    _, table_a, emi_a, classes_a = mk.prepare_scan(scene, "parity")
    tp0_b = mk.tp0_table_for(table_b, cfg, scan_b)
    scan_tbl_b = wf.scan_table(table_b, scan_b)

    def anchor(c, spp):
        return lambda: mk.render_samples_pallas_stats(table_a, c, spp_warm, spp, scan="parity",
                                                      classes=classes_a, emi_const=emi_a)

    return {
        "anchor": anchor(cfg, spp_bench),
        "auto": lambda: mk.render_samples_pallas_stats(table_b, cfg, spp_warm, spp_bench,
                                                       scan=scan_b, classes=classes_b,
                                                       tp0_table=tp0_b, emi_const=emi_b),
        "anchor16": anchor(cfg16, spp_bench_deep),
        "auto16": lambda: wf.render_samples_wavefront_stats(table_b, cfg16, spp_warm,
                                                            spp_bench_deep, scan=scan_b,
                                                            classes=classes_b,
                                                            emi_const=emi_b,
                                                            scan_tbl=scan_tbl_b),
    }


def _rate(fn) -> float:
    """Traced segments per second of one call, on the host clock."""
    t0 = time.perf_counter()
    _, segs = fn()
    n = int(segs)  # waits for the launch
    return n / (time.perf_counter() - t0)


def run(width: int = WIDTH, height: int = HEIGHT, bounces: int = BOUNCES,
        bounces_deep: int = BOUNCES_DEEP, spp_warm: int = SPP_WARM, spp_bench: int = SPP_BENCH,
        spp_bench_deep: int = SPP_BENCH_DEEP, pairs: int = PAIRS, device="cuda") -> dict:
    """Time the four calls of `make_runs` on the Cornell box on `device` (the card by
    default; "cpu" times the kernels' plain versions) and print the JSON line;
    returns it as a dict."""
    runs = make_runs(load_cornell_box(device=device), width, height, bounces, bounces_deep,
                     spp_warm, spp_bench, spp_bench_deep)
    for name, fn in runs.items():
        img, _ = fn()
        if not bool(torch.isfinite(img).all()):
            raise RuntimeError(f"non-finite image ({name})")

    rates = {name: [] for name in runs}
    ratios, ratios16 = [], []
    for _ in range(pairs):
        for a, b, into in (("anchor", "auto", ratios), ("anchor16", "auto16", ratios16)):
            ra, rb = _rate(runs[a]), _rate(runs[b])
            rates[a].append(ra)
            rates[b].append(rb)
            into.append(rb / ra)

    line = {
        "metric": "cornell_4bounce_path_trace",
        "value": max(rates["auto"]) / 1e6,
        "unit": "Mrays/s",
        "anchor_value": max(rates["anchor"]) / 1e6,
        "ratio_vs_anchor": statistics.median(ratios),
        "value_16b": max(rates["auto16"]) / 1e6,
        "anchor_16b": max(rates["anchor16"]) / 1e6,
        "ratio_vs_anchor_16b": statistics.median(ratios16),
    }
    print(json.dumps(line), flush=True)
    return line


def main() -> None:
    run()


if __name__ == "__main__":
    main()
