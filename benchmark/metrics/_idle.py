"""The device's idle share of a traced window, in %."""


def idle(run):
    tr = run.trace
    if tr is None or tr.busy_s <= 0:
        return None
    return 100.0 * max(0.0, 1.0 - tr.busy_s / tr.window_s)
