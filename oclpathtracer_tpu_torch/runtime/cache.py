"""The build cache of the port's compiled libraries, and its compile events.

Counterpart of `oclpathtracer_tpu.runtime.cache`, which enables XLA's persistent
compilation cache. The port compiles two libraries itself, each at first use: the
CUDA kernels (`kernels/cuda_build.load_library`, nvcc) and the native host runtime
(`runtime/native.load_library`, g++). Each is cached on disk in one directory, named
by a hash of its sources and flags, so a changed source rebuilds and an unchanged one
loads at once (≡ the reference's on-disk kernel binary cache keyed by source and
options, AdlKernelUtilsCL.cpp:130-237). Nothing here imports torch.
"""

from __future__ import annotations

import os
from typing import Callable, List

from oclpathtracer_tpu_torch.utils.errors import logger

DEFAULT_CACHE_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "kernels",
                                 "build")

_cache_dir = DEFAULT_CACHE_DIR
_listeners: List[Callable[[str, float], None]] = []
_log = False


def enable_compilation_cache(cache_dir: str | None = None) -> str:
    """Set the directory both builds cache their libraries in, and return it:
    `kernels/build/` of the package by default (None), else `cache_dir`, created if
    needed. A library already loaded in this process stays loaded; the next build
    or load of either library uses the new directory."""
    global _cache_dir
    _cache_dir = os.path.abspath(cache_dir) if cache_dir else DEFAULT_CACHE_DIR
    os.makedirs(_cache_dir, exist_ok=True)
    return _cache_dir


def cache_dir() -> str:
    """The directory the builds cache their libraries in now."""
    return _cache_dir


def log_compiles(enable: bool = True) -> None:
    """Log every build (nvcc or g++) through `utils.errors.logger`, at WARNING as
    jax_log_compiles does — the observability half of the reference's compile
    bracket (compile start/end logged at AdlKernelUtilsCL.cpp:254-264)."""
    global _log
    _log = enable


def register_compile_listener(callback) -> None:
    """≡ the reference's pluggable CompileCallback (Adl.h:23-30, fired around
    clBuildProgram at AdlKernelUtilsCL.cpp:254-264,353-354): `callback(event,
    seconds)` is called after each build of a library, with "compile/nvcc" or
    "compile/g++" and the build's wall seconds. A library loaded from the cache
    fires nothing. Registration is process-wide and permanent, as in the JAX
    package."""
    _listeners.append(callback)


def notify(event: str, seconds: float) -> None:
    """Report one finished build to the listeners (and the log, where on), and count
    it: "compile/nvcc" adds one to runtime.profiling's counter "build.nvcc"."""
    from oclpathtracer_tpu_torch.runtime import profiling

    profiling.count("build." + event.rsplit("/", 1)[-1])
    if _log:
        logger.warning("built %s in %.2f s", event, seconds)
    for cb in list(_listeners):
        cb(event, seconds)
