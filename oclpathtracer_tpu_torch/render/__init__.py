from oclpathtracer_tpu_torch.render.accumulate import Accumulator, linear_to_srgb_gamma22
from oclpathtracer_tpu_torch.render.driver import (
    make_kernel_render_step,
    make_render_step,
    render_progressive,
)
from oclpathtracer_tpu_torch.render.image import to_u8, write_png, write_ppm

__all__ = [
    "Accumulator",
    "linear_to_srgb_gamma22",
    "render_progressive",
    "make_render_step",
    "make_kernel_render_step",
    "write_ppm",
    "write_png",
    "to_u8",
]
