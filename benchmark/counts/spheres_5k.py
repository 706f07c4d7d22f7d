"""The work of a traced segment of the sorted wavefront's skip-link walk at
spheres-5k-b16, frozen: the boxes and leaf triangles one segment tests on average, so
that `kernel_roofline.sorted` reads the same work whatever builds the tree later.

Measured once on the card with the bounce kernel's plain version
(`sorted_wavefront._render_samples_sorted_stats_plain`, whose skip-link walk
`bvh_megakernel._skip_walk_nearest` counts into `bvh_megakernel.WALK_COUNTS` each box
a walking ray tests and each leaf triangle it tests): the configuration's scene
(`sphere_field()`, seed 0), `render_sorted`'s tree (leaf 32, parity), 512 x 512 at 16
bounces, the configuration's camera (eye (0, 3, 9)), samples FIRST .. FIRST + SAMPLES
- 1 of every pixel. `python3 -m benchmark.counts.spheres_5k` measures them again and
prints them (on the card).
"""

from __future__ import annotations

SCAN = "parity"
LEAF = 32
FIRST, SAMPLES = 0, 4
# Measured on an NVIDIA H100 80GB HBM3 (torch 2.11.0+cu128): 1,141,236 segments,
# 25,111,706 boxes and 14,046,420 leaf triangles.
BOXES_PER_SEGMENT = 22.00395536067912
TRIS_PER_SEGMENT = 12.308076506524506


def measure(device="cuda", cell=None) -> dict:
    """Walk `cell`'s frames FIRST .. FIRST + SAMPLES - 1 (spheres-5k-sorted's by
    default) with the plain walk on `device` and return the counts a segment."""
    from benchmark import spec
    from benchmark.common import program_scene
    from oclpathtracer_tpu_torch.kernels import bvh_megakernel as bk
    from oclpathtracer_tpu_torch.kernels import sorted_wavefront as sw

    scene, cfg = program_scene(cell or spec.load_cell("spheres-5k-sorted"), device)
    table, nodes_f, nodes_i = bk.pack_bvh_scene(scene, leaf_size=LEAF)
    bk.WALK_COUNTS.update(boxes=0, tris=0)
    segments = 0
    for s in range(FIRST, FIRST + SAMPLES):
        _, seg = sw._render_samples_sorted_stats_plain(table, nodes_f, nodes_i, cfg, s, 1,
                                                       max_leaf=LEAF)
        segments += int(seg)
    return {"segments": segments, "boxes": bk.WALK_COUNTS["boxes"] / segments,
            "tris": bk.WALK_COUNTS["tris"] / segments}


if __name__ == "__main__":
    import json

    print(json.dumps(measure()))
