"""Build and load the hand-written CUDA kernels (`kernels/csrc/`).

nvcc compiles every `.cu` file, one process per source, all started together, and
links the objects into one shared library with a plain C interface, loaded with
ctypes. The library is built at first use into the build cache's directory
(`runtime/cache.py`: `kernels/build/` unless `enable_compilation_cache` redirects
it), named by a hash of the sources and flags, so a changed source rebuilds and an
unchanged one loads at once; each build fires the cache's compile listeners.
Nothing here runs at import: the CPU tests import every module, and the machine
they run on has no nvcc.

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
import tempfile
import time
from typing import NamedTuple

from oclpathtracer_tpu_torch.runtime import cache

CSRC = os.path.join(os.path.dirname(__file__), "csrc")
SOURCES = ("megakernel.cu", "wavefront.cu", "bvh_megakernel.cu", "wide_bvh.cu",
           "grad_megakernel.cu", "trace_rays.cu", "fast_integrators.cu",
           "sorted_wavefront.cu", "gather_grad.cu")
HEADERS = ("trace.cuh", "bvh.cuh", "split.cuh", "regen.cuh", "fixed_sum.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Each entry point: (input tensors, output tensors). Its arguments are the inputs,
# the host float and int arrays, the outputs and the stream, each a c_void_p.
LAUNCHERS = {
    "opt_megakernel_launch": (1, 3),       # table -> out, scratch, segs
    "opt_wavefront_launch": (2, 3),        # table, scan table -> out, scratch, segs
    "opt_bvh_megakernel_launch": (4, 3),   # table, nodes_f, nodes_i, init -> out, scratch, segs
    "opt_wide_bvh_launch": (4, 3),         # table, boxes, meta, init -> out, scratch, segs
    # table, classes, weight -> out, scratch, segs, partials, grads
    "opt_grad_megakernel_launch": (3, 5),
    "opt_trace_rays_launch": (3, 3),       # table, o, d -> out, scratch, segs
    "opt_ao_launch": (1, 1),               # table -> out
    "opt_direct_launch": (2, 1),           # table, light table -> out
    # table, nodes_f, nodes_i -> the ray state rows in place, segs, the live lists, their
    # counts, the sort keys (or None)
    "opt_sorted_bounce_launch": (3, 5),
    "opt_gather_grad_launch": (2, 2),      # idx, grad -> partials, grad_table
}


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


def _run_all(cmds: list) -> str:
    """Run the commands in parallel; their joint output, or RuntimeError."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs, failed = [], []
    for cmd, proc in zip(cmds, procs):
        out, _ = proc.communicate()
        logs.append(out)
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)} -> {proc.returncode}")
    log = "".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed: {failed}\n{log}")
    return log


def load_library():
    """(ctypes library, BuildInfo): build the kernels into the build cache's directory
    (`runtime.cache.cache_dir()`) if they are not there, then load them."""
    return _load_library(cache.cache_dir())


@functools.lru_cache(maxsize=None)
def _load_library(build_dir: str):
    path = os.path.join(build_dir, f"libopt_kernels_{_source_hash()}.so")
    t0 = time.perf_counter()
    built, log = False, ""
    if not os.path.exists(path):
        from oclpathtracer_tpu_torch.runtime import profiling

        os.makedirs(build_dir, exist_ok=True)
        nvcc = _nvcc()
        with profiling.span("build.nvcc"), tempfile.TemporaryDirectory(dir=build_dir) as tmpdir:
            objs = [os.path.join(tmpdir, s + ".o") for s in SOURCES]
            log = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", o, os.path.join(CSRC, s)]
                            for s, o in zip(SOURCES, objs)])
            tmp = os.path.join(tmpdir, "lib.so")
            log += _run_all([[nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
                              "-o", tmp, *objs]])
            os.replace(tmp, path)  # atomic: another process never loads half a file
        built = True
        cache.notify("compile/nvcc", time.perf_counter() - t0)
    lib = ctypes.CDLL(path)
    for name, (n_inputs, n_outputs) in LAUNCHERS.items():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * (n_inputs + n_outputs + 3)
        fn.restype = ctypes.c_int
    lib.opt_error_string.argtypes = [ctypes.c_int]
    lib.opt_error_string.restype = ctypes.c_char_p
    return lib, BuildInfo(path, built, time.perf_counter() - t0, log)


class Launch:
    """One kernel's launch with its inputs and host arrays checked and packed once:
    a caller that launches the same kernel many times (the sorted wavefront's
    bounce launches) builds it once and calls it with the outputs, changing only
    host ints in place (`ints[k] = v`) between launches. The C function reads the
    host arrays when it is called, so a change reaches the next launch only."""

    def __init__(self, fn_name: str, inputs: tuple, host_f, host_i):
        self.fn_name = fn_name
        self._arity(len(inputs), 0)
        self.device = inputs[0].device
        self._check(inputs)
        self.lib, _ = load_library()
        self.fn = getattr(self.lib, fn_name)
        self.floats = (ctypes.c_float * len(host_f))(*host_f)
        self.ints = (ctypes.c_int * len(host_i))(*host_i)
        self.head = [None if t is None else t.data_ptr() for t in inputs]
        self.head += [ctypes.addressof(self.floats), ctypes.addressof(self.ints)]

    def _arity(self, n, side: int) -> None:
        want = LAUNCHERS[self.fn_name]
        if n != want[side]:
            raise ValueError(f"{self.fn_name} takes (inputs, outputs) = {want} tensors")

    def _check(self, tensors) -> None:
        for t in tensors:
            if t is not None and (t.device != self.device or not t.is_contiguous()):
                raise ValueError(f"{self.fn_name}: every tensor must be contiguous on "
                                 f"{self.device}")

    def __call__(self, *outputs) -> None:
        """Launch on the current stream of the inputs' device; raise if the launch is
        refused (cudaGetLastError is not 0)."""
        import torch

        self._arity(len(outputs), 1)
        self._check(outputs)
        args = (*self.head, *(None if t is None else t.data_ptr() for t in outputs),
                torch.cuda.current_stream(self.device).cuda_stream)
        if self.device.index == torch.cuda.current_device():
            err = self.fn(*args)
        else:  # a kernel launches on the calling thread's current device
            with torch.cuda.device(self.device):
                err = self.fn(*args)
        if err != 0:
            raise RuntimeError(f"{self.fn_name}: CUDA error {err}: "
                               f"{self.lib.opt_error_string(err).decode()}")


def launch(fn_name: str, inputs: tuple, host_f, host_i, *outputs) -> None:
    """Launch one kernel on the current stream of the inputs' device; raise if the
    launch is refused (cudaGetLastError is not 0). An input or output given as None
    passes a null pointer (an optional buffer the kernel then does not touch)."""
    Launch(fn_name, inputs, host_f, host_i)(*outputs)
