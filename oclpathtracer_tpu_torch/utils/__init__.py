"""Error/log subsystem (`errors.py`). The program's spans and counters are in
`runtime/profiling.py`.

Counterpart of `oclpathtracer_tpu.utils`, which exports nothing at package level
either: import the modules.
"""
