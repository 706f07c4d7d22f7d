from oclpathtracer_tpu_torch.integrators.path import render_sample, trace_paths
from oclpathtracer_tpu_torch.integrators.parity import (
    count_segments_ref, ref_uniforms, render_sample_ref)
from oclpathtracer_tpu_torch.integrators.primary import render_primary
from oclpathtracer_tpu_torch.integrators.ao import render_ao
from oclpathtracer_tpu_torch.integrators.direct import render_direct

__all__ = ["trace_paths", "render_sample", "ref_uniforms", "render_sample_ref",
           "count_segments_ref", "render_primary", "render_ao", "render_direct"]
