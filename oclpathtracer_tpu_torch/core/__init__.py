from oclpathtracer_tpu_torch.core import brdf, bvh, camera, intersect, rng

__all__ = ["brdf", "bvh", "camera", "intersect", "rng"]
