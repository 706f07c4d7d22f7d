"""setup_s: seconds from the process's start to the window's first unit (loading,
building and loading the kernels, the benchmark's inputs, the warm-up)."""


def read(run):
    return run.setup_s
