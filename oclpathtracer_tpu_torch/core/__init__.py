from oclpathtracer_tpu_torch.core import brdf, camera, intersect, rng

__all__ = ["brdf", "camera", "intersect", "rng"]
