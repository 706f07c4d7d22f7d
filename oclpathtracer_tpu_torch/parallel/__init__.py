"""Distribution layer — device mesh, tile sharding, gradient reduction.

Counterpart of `oclpathtracer_tpu.parallel`. The reference has NO multi-device code
(SURVEY.md §2.3). Mapping here:

  * mesh: a 1-D 'tiles' axis over an ordered tuple of torch devices (`mesh.py`); an
    entry may repeat a device, so one card runs any mesh as n × `cuda:0`;
  * framebuffer pixels and ray batches shard over 'tiles' (entry i takes the i-th
    block of absolute pixel ids); scene geometry and material parameters replicate;
  * sample streams stay bit for bit the same under any layout because every uniform
    is keyed by ABSOLUTE pixel id (core/rng.py), never a shard-local index;
  * parameter gradients are added in mesh order on the first entry's device (the
    psum), and across processes by one torch.distributed all_reduce
    (`multihost.py`).
"""

from oclpathtracer_tpu_torch.parallel.mesh import default_mesh, tile_sharding
from oclpathtracer_tpu_torch.parallel.sharded import (
    make_sharded_render_step,
    render_progressive_sharded,
    shard_pixels,
)

__all__ = [
    "default_mesh",
    "tile_sharding",
    "shard_pixels",
    "make_sharded_render_step",
    "render_progressive_sharded",
]
