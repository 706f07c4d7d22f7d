"""autograd_backward_ms.twin: device time per step of the kernels launched under
torch's autograd::engine::evaluate_function ranges (the backward), from the trace."""


def read(run):
    tr = run.trace
    if tr is None or tr.autograd_device_s <= 0 or not run.window.units:
        return None
    return tr.autograd_device_s / run.window.units * 1e3
