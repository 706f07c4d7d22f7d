"""Build and load the hand-written CUDA kernels (`kernels/csrc/`).

nvcc compiles every `.cu` file into one shared library with a plain C interface,
loaded with ctypes. The library is built at first use into `kernels/build/`, named
by a hash of the sources and flags, so a changed source rebuilds and an unchanged
one loads at once. Nothing here runs at import: the CPU tests import every module,
and the machine they run on has no nvcc.

Flags: `-fmad=false` keeps nvcc from contracting a*b+c into one FMA, so the kernels
round like their plain PyTorch versions, whose elementwise operations never fuse;
no fast-math, so divisions and square roots are IEEE-rounded.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from typing import NamedTuple

CSRC = os.path.join(os.path.dirname(__file__), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(__file__), "build")
SOURCES = ("megakernel.cu", "wavefront.cu")
HEADERS = ("trace.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_PTR = ctypes.c_void_p
_LAUNCH_ARGTYPES = [_PTR, _PTR, _PTR, _PTR, _PTR, _PTR]


class BuildInfo(NamedTuple):
    """What `load_library` did: the library path, whether it was compiled in this
    process, the seconds it took, and nvcc's output."""

    path: str
    built: bool
    seconds: float
    log: str


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else shutil.which("nvcc")
    if not nvcc or not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return nvcc


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in HEADERS + SOURCES:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


@functools.lru_cache(maxsize=None)
def load_library():
    """(ctypes library, BuildInfo): build the kernels if needed, then load them."""
    path = os.path.join(BUILD_DIR, f"libopt_kernels_{_source_hash()}.so")
    t0 = time.perf_counter()
    built, log = False, ""
    if not os.path.exists(path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *(os.path.join(CSRC, s) for s in SOURCES)]
        proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
        os.replace(tmp, path)  # atomic: another process never loads half a file
        built = True
    lib = ctypes.CDLL(path)
    for name in ("opt_megakernel_launch", "opt_wavefront_launch"):
        fn = getattr(lib, name)
        fn.argtypes = _LAUNCH_ARGTYPES
        fn.restype = ctypes.c_int
    lib.opt_error_string.argtypes = [ctypes.c_int]
    lib.opt_error_string.restype = ctypes.c_char_p
    return lib, BuildInfo(path, built, time.perf_counter() - t0, log)


def launch(fn_name: str, table, host_f, host_i, out, segs) -> None:
    """Launch one kernel on the current stream of `table`'s device; raise if the
    launch is refused (cudaGetLastError is not 0)."""
    import torch

    lib, _ = load_library()
    f_arr = (ctypes.c_float * len(host_f))(*host_f)
    i_arr = (ctypes.c_int * len(host_i))(*host_i)
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        err = getattr(lib, fn_name)(table.data_ptr(), ctypes.addressof(f_arr),
                                    ctypes.addressof(i_arr), out.data_ptr(),
                                    segs.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"{fn_name}: CUDA error {err}: "
                           f"{lib.opt_error_string(err).decode()}")
