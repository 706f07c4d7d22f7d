"""The program's own spans (`oclpathtracer_tpu_torch.runtime.profiling`): the table of
the traced window, which is the profiler session the program saw last, per unit."""


def stats() -> dict:
    """{name: (calls, total_s, self_s)} of the window's spans; {} where the program
    keeps no such table."""
    try:
        from oclpathtracer_tpu_torch.runtime import profiling
    except ImportError:
        return {}
    read = getattr(profiling, "span_stats", None)
    return read() if read is not None else {}


def per_unit_ms(run, match, column: str = "total"):
    """The seconds (`total` or `self`) of the spans whose name `match(name)` accepts,
    added, in ms per unit of the window; None where none ran."""
    rows = [v for k, v in stats().items() if match(k)]
    if not rows or not run.window.units:
        return None
    i = 1 if column == "total" else 2
    return sum(r[i] for r in rows) / run.window.units * 1e3
