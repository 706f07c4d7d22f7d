"""kernel_roofline.frames: the render kernels' share of their FP32 roofline over the
traced window of the preview frames, as `kernel_roofline.render` reads it."""

from benchmark.metrics._roofline import render_share


def read(run):
    return render_share(run)
