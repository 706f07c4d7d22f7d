"""train_step_ms: the window's seconds over the steps it completed (the window ends
with a synchronize, so every step issued in it is done)."""


def read(run):
    return run.window.seconds / run.window.units * 1e3 if run.window.units else None
