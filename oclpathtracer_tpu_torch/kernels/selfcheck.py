"""Hold the CUDA kernels against their plain PyTorch versions on the card.

Both run on the same CUDA table: the kernel through its wrapper, the plain version
called directly. They differ only where an ulp flips a hit decision, and one flip
changes the rest of that path, so a case is judged by the share of pixels that
agree and by the segment counts, not by the worst pixel:

  * |segments(kernel) − segments(plain)| ≤ max(2, 1e-5 · segments);
  * at least 99.9% of pixels allclose at rtol = atol = 1e-4.

Used by `chip_smoke.py` and `tests/test_torch_cuda.py`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from oclpathtracer_tpu_torch.config import RenderConfig
from oclpathtracer_tpu_torch.kernels import megakernel as mk
from oclpathtracer_tpu_torch.kernels import wavefront as wf

RTOL = ATOL = 1e-4
MIN_PIXEL_FRACTION = 0.999
START_SAMPLE = 3
N_SAMPLES = 8  # k = 4 wavefront streams then trace two samples each


@dataclasses.dataclass(frozen=True)
class Case:
    kernel: str        # "megakernel" | "wavefront"
    scan: str          # "parity" | "tp"
    width: int
    height: int
    bounces: int
    tp0: bool = True   # megakernel only
    interleave: int = 1  # wavefront only

    @property
    def name(self) -> str:
        extra = (f"tp0={int(self.tp0)}" if self.kernel == "megakernel"
                 else f"k={self.interleave}")
        return (f"{self.kernel} {self.scan} {extra} "
                f"{self.width}x{self.height} b{self.bounces}")


def cases(width: int, height: int, ragged=(100, 77)) -> list:
    """The kernel-vs-plain cases: megakernel parity, tp with tp0 on and off at 4
    and 16 bounces; wavefront parity and tp at 16 bounces with k = 1 and 4; and a
    ragged image size that is no multiple of the block."""
    out = []
    for b in (4, 16):
        out += [Case("megakernel", "parity", width, height, b),
                Case("megakernel", "tp", width, height, b, tp0=True),
                Case("megakernel", "tp", width, height, b, tp0=False)]
    for scan in ("parity", "tp"):
        for k in (1, 4):
            out.append(Case("wavefront", scan, width, height, 16, interleave=k))
    if ragged:
        rw, rh = ragged
        out += [Case("megakernel", "parity", rw, rh, 4),
                Case("megakernel", "tp", rw, rh, 4, tp0=True),
                Case("wavefront", "tp", rw, rh, 16, interleave=4)]
    return out


def tables(scene, device):
    """{"parity": (table, ()), "tp": (table, classes)} on `device`."""
    _, tp_table, classes = mk.prepare_scan(scene, "tp")
    return {"parity": (mk.pack_scene(scene).to(device), ()),
            "tp": (tp_table.to(device), classes)}


def run_kernel(case: Case, table, classes, start=START_SAMPLE, n=N_SAMPLES):
    cfg = RenderConfig(width=case.width, height=case.height, bounces=case.bounces)
    if case.kernel == "megakernel":
        return mk.render_samples_pallas_stats(table, cfg, start, n, scan=case.scan,
                                              classes=classes, tp0=case.tp0)
    return wf.render_samples_wavefront_stats(table, cfg, start, n,
                                             interleave=case.interleave, scan=case.scan,
                                             classes=classes)


def run_plain(case: Case, table, classes, start=START_SAMPLE, n=N_SAMPLES):
    cfg = RenderConfig(width=case.width, height=case.height, bounces=case.bounces)
    if case.kernel == "megakernel":
        return mk._render_samples_stats_plain(table, cfg, start, n, 0, cfg.n_pixels,
                                              case.scan, classes, case.tp0)
    return wf._render_samples_wavefront_plain(table, cfg, start, n, case.interleave,
                                              case.scan, classes, 0, cfg.n_pixels)


def compare(img_k, segs_k, img_p, segs_p) -> dict:
    """The pass rule above, as a dict of what it measured and `ok`."""
    a = img_k.detach().cpu().numpy()
    b = img_p.detach().cpu().numpy()
    sk, sp = int(segs_k), int(segs_p)
    close = np.isclose(a, b, rtol=RTOL, atol=ATOL).all(axis=1)
    frac = float(close.mean())
    seg_ok = abs(sk - sp) <= max(2, 1e-5 * sp)
    return {"pixel_fraction": frac, "max_abs_err": float(np.abs(a - b).max()),
            "segments_kernel": sk, "segments_plain": sp,
            "bitwise": bool(np.array_equal(a, b) and sk == sp),
            "finite": bool(np.isfinite(a).all()),
            "ok": bool(seg_ok and frac >= MIN_PIXEL_FRACTION and np.isfinite(a).all())}


def check_case(case: Case, tbls) -> dict:
    table, classes = tbls[case.scan]
    img_k, segs_k = run_kernel(case, table, classes)
    torch.cuda.synchronize()
    img_p, segs_p = run_plain(case, table, classes)
    return compare(img_k, segs_k, img_p, segs_p)


def wavefront_k1_equals_megakernel(tbls, width, height, bounces=16) -> dict:
    """Wavefront k = 1 vs the megakernel (tp0 off), both kernels: bit for bit."""
    out = {}
    for scan in ("parity", "tp"):
        table, classes = tbls[scan]
        m = run_kernel(Case("megakernel", scan, width, height, bounces, tp0=False),
                       table, classes)
        w = run_kernel(Case("wavefront", scan, width, height, bounces, interleave=1),
                       table, classes)
        out[scan] = bool(torch.equal(m[0], w[0]) and int(m[1]) == int(w[1]))
    return out


def tp_matches_parity(tbls) -> dict:
    """The JAX package's tp-vs-parity contract (tests/test_kernels.py,
    test_tp_scan_matches_parity_megakernel) on the kernels: 64×32, 6 bounces,
    2 frames from 0; |Δsegments| ≤ 2 and allclose at rtol = atol = 1e-4."""
    cfg = RenderConfig(width=64, height=32, bounces=6)
    p_table, _ = tbls["parity"]
    t_table, classes = tbls["tp"]
    img_p, segs_p = mk.render_samples_pallas_stats(p_table, cfg, 0, 2, scan="parity")
    img_t, segs_t = mk.render_samples_pallas_stats(t_table, cfg, 0, 2, scan="tp",
                                                   classes=classes)
    a, b = img_t.cpu().numpy(), img_p.cpu().numpy()
    return {"segments_parity": int(segs_p), "segments_tp": int(segs_t),
            "max_abs_err": float(np.abs(a - b).max()),
            "ok": bool(abs(int(segs_p) - int(segs_t)) <= 2
                       and np.allclose(a, b, rtol=RTOL, atol=ATOL))}
