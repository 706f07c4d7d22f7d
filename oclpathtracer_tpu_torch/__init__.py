"""oclpathtracer_tpu_torch — the path tracer ported to PyTorch and CUDA (Hopper).

The second package beside `oclpathtracer_tpu` (JAX/Pallas, kept as the reference).
It imports torch and numpy, never jax. Module paths mirror the JAX package's:

  scene/        scene binary I/O + SoA geometry (NamedTuples of torch tensors)
  core/         RNG, camera, intersection, BRDF math (batched torch)
  integrators/  the path-trace twin and the reference-parity twin
  kernels/      hand-written CUDA kernels (csrc/) with their plain versions
  render/       progressive driver, accumulation, checkpoints, image I/O
  convert.py    a JAX Scene's leaves (numpy) → this package's Scene
"""

__version__ = "0.1.0"

from oclpathtracer_tpu_torch.config import CameraConfig, RenderConfig

__all__ = ["RenderConfig", "CameraConfig", "__version__"]
