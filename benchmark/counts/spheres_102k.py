"""The work of a traced segment of the 8-wide BVH walk at spheres-102k-b16, frozen: the
boxes and leaf triangles one segment tests on average, so that
`kernel_roofline.widebvh` reads the same work whatever builds the tree later.

Measured once on the card with the port's plain 8-wide walk (`wide_bvh`'s plain
version, which counts into `bvh_megakernel.WALK_COUNTS` each box a walking ray tests,
in its group's expansion and when popped, and each leaf triangle it tests): the
configuration's scene (`sphere_field(80, 3)`, seed 0), the driver's auto choice (leaf
64, the fast scan), 512 x 512 at 16 bounces, the configuration's camera (eye
(0, 3, 9)), samples FIRST .. FIRST + SAMPLES - 1 of every pixel. `python3 -m benchmark.counts.spheres_102k`
measures them again and prints them (on the card; about a minute).
"""

from __future__ import annotations

SCAN = "fast"
LEAF = 64
FIRST, SAMPLES = 0, 4
# Measured on an NVIDIA H100 80GB HBM3 (torch 2.11.0+cu128): 1,470,351 segments,
# 90,975,573 boxes and 141,209,257 leaf triangles.
BOXES_PER_SEGMENT = 61.87337105221815
TRIS_PER_SEGMENT = 96.03778757589174


def measure(device="cuda") -> dict:
    """Walk the configuration's frames FIRST .. FIRST + SAMPLES - 1 with the plain
    walk on `device` and return the counts a segment."""
    from benchmark import spec
    from benchmark.common import program_scene
    from oclpathtracer_tpu_torch.kernels import bvh_megakernel as bk
    from oclpathtracer_tpu_torch.kernels import wide_bvh as wb
    from oclpathtracer_tpu_torch.kernels.megakernel import scene_emissive_const

    cell = spec.load_cell("spheres-102k-converge")
    scene, cfg = program_scene(cell, device)
    table, wn_f, wn_i, depth, classes = wb.pack_wide_bvh_scene(scene, LEAF, SCAN)
    bk.WALK_COUNTS.update(boxes=0, tris=0)
    segments = 0
    for s in range(FIRST, FIRST + SAMPLES):
        _, seg = wb._render_samples_wide_bvh_stats_plain(
            table, wn_f, wn_i, cfg, s, 1, SCAN, scene_emissive_const(scene), classes, depth)
        segments += int(seg)
    return {"segments": segments, "boxes": bk.WALK_COUNTS["boxes"] / segments,
            "tris": bk.WALK_COUNTS["tris"] / segments}


if __name__ == "__main__":
    import json

    print(json.dumps(measure()))
