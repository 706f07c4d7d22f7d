"""Error/log subsystem (`errors.py`) and throughput counters (`metrics.py`).

Counterpart of `oclpathtracer_tpu.utils`, which exports nothing at package level
either: import the modules.
"""
