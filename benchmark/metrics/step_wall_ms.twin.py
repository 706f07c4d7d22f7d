"""step_wall_ms.twin: the window's seconds over the twin steps it completed (the window
ends with a synchronize, so every step issued in it is done). Per layer: it is read in
the traced run, under the profiler; the host sets its pace, and the host's speed moves
it by more than any bound could hold."""


def read(run):
    return run.window.seconds / run.window.units * 1e3 if run.window.units else None
