"""memory_peak_mb.twin: the most device memory the caching allocator held for the twin's
training, in MB (1e6 bytes): the program's scene, its first steps and every step of
the window, read before the reference's check runs. None without a card."""


def read(run):
    return run.memory_peak_bytes / 1e6 if run.memory_peak_bytes > 0 else None
