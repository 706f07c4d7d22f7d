"""render_mrays_s.bvh: render_mrays_s in the BVH job cells, where the host's build of
the tree on every call is most of a job: traced segments of the units the window
completed, over the window's seconds, in millions."""

from benchmark.metrics.render_mrays_s import read  # noqa: F401
