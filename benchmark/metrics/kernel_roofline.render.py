"""kernel_roofline.render: the render kernels' share of their FP32 roofline over the
traced window of the render jobs: linear-scan operations of the traced segments over
the device time of the port's kernels (the path-regeneration kernel and its sample
sum)."""

from benchmark.metrics._roofline import render_share


def read(run):
    return render_share(run)
