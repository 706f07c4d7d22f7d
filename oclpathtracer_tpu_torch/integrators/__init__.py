from oclpathtracer_tpu_torch.integrators.path import trace_paths
from oclpathtracer_tpu_torch.integrators.parity import (
    count_segments_ref, ref_uniforms, render_sample_ref)

__all__ = ["trace_paths", "ref_uniforms", "render_sample_ref", "count_segments_ref"]
