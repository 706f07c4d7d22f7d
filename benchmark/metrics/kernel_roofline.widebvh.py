"""kernel_roofline.widebvh: the 8-wide BVH kernel's share of its FP32 roofline over
the traced window of the sphere-field jobs: the operations of the traced segments'
walks (the boxes and leaf triangles a segment tests, frozen in
`counts/spheres_102k.py`, and each segment's own work, `bounds.bvh_ops`) over the
device time of the port's kernels (the 8-wide kernel and its sample sum)."""

from benchmark.counts import bounds, spheres_102k
from benchmark.metrics._roofline import share


def read(run):
    seg = run.counts.get("segments")
    if not seg:
        return None
    return share(run, bounds.bvh_ops(spheres_102k.SCAN, spheres_102k.BOXES_PER_SEGMENT * seg,
                                     spheres_102k.TRIS_PER_SEGMENT * seg, seg))
