"""The work of one job of the AO and direct passes at cornell-512-fast, frozen: the
counts `bounds.fast_ops` multiplies, so that `kernel_roofline.ao` and
`kernel_roofline.direct` read the same work whatever the program does later.

Measured once on the card with the benchmark's reference (`reference/fast.py`, which
counts what the program's kernels do: camera rays, their hits, second rays cast, the
triangles the second rays' any-hit scans test up to and including the first blocker,
the unblocked shadow rays) over a whole job, every pixel of the configuration's 512 x
512 and every sample 0 .. JOB_SPP - 1, and the rows of the scene's table that a ray
from the eye can hit in front of it (`eye_rows`, the rows the kernels' camera scan
tests). `python3 -m benchmark.counts.cornell_fast` measures them again and prints
them (on the card; about half a minute).
"""

from __future__ import annotations

import numpy as np

JOB_SPP = 1024
N_LIGHTS = 2  # the Cornell box's light: one quad, two triangles
# Measured on an NVIDIA H100 80GB HBM3 (torch 2.11.0+cu128).
AO = {"camera": 268_435_456, "hits": 268_435_454, "rays": 268_435_454,
      "tris": 8_348_205_107, "lit": 0, "eye_rows": 20}
DIRECT = {"camera": 268_435_456, "hits": 268_435_454, "rays": 232_904_720,
          "tris": 8_234_745_825, "lit": 214_461_050, "eye_rows": 20}


def eye_rows(scene, eye) -> int:
    """The triangles a ray from `eye` can hit in front of it: those whose
    dot(e2, cross(eye - p1, e1)) is positive, in float32 as the kernels take it."""
    p1 = scene.p1.astype(np.float32)
    e1, e2 = scene.p2 - p1, scene.p3 - p1
    tnum = (e2 * np.cross(np.asarray(eye, np.float32) - p1, e1)).sum(axis=1)
    return int((tnum > 0).sum())


def measure(device="cuda") -> dict:
    """Both passes' counts of one job on `device`, as AO and DIRECT hold them."""
    import torch

    from benchmark import common, spec
    from benchmark.reference import fast as rf
    from benchmark.reference import scene as rs

    cell = spec.load_cell("cornell-ao")
    sd, r = rs.scene_data(cell), common.reference_render(cell)
    pixels = torch.arange(r.width * r.height, dtype=torch.int64, device=device)
    out = {}
    for kind in rf.KINDS:
        _, counts = rf.pixel_sums(kind, sd, r, pixels, 0, JOB_SPP,
                                  radius=cell.config["ao_radius"])
        out[kind.upper()] = {**counts, "eye_rows": eye_rows(sd, r.eye)}
    return out


if __name__ == "__main__":
    import json

    print(json.dumps(measure()))
