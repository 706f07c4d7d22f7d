"""ctypes bindings to the native C++ runtime components (scene I/O, image I/O, stopwatch,
BVH build).

Counterpart of `oclpathtracer_tpu.runtime.native`. The reference implements its
runtime in C++ (scene parse RaytraceTest.cpp:87-198, PPM writer :277-287,
StopwatchHost); this module binds the port's copy of the native equivalents
(`oclpathtracer_tpu_torch/native/*.cpp`) and the BVH build (`bvh_build.cpp`: the
binned-SAH build and the 8-wide regrouping of `core/bvh.py`, operation for
operation). The library is built by one g++ call at first use, not at import, into
the build cache's directory (`runtime/cache.py`, `kernels/build/` by default), named
by a hash of the sources and flags; it builds in a temporary directory and moves into
place, so processes building at once never load half a file. The callers
(`scene/loader.py`, `render/image.py`, `core/bvh.py`) try this route first and fall
back to their Python code, which gives the same bytes. The BVH build also falls back
where it meets what only numpy reproduces: a group whose centroids are degenerate, or
no split with a finite cost, where the numpy build takes `np.argpartition`'s order.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
import time
from typing import List

import numpy as np

from oclpathtracer_tpu_torch.kernels.cuda_build import BuildInfo
from oclpathtracer_tpu_torch.runtime import cache

NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "native")
SOURCES = ("scene_loader.cpp", "image_io.cpp", "stopwatch.cpp", "bvh_build.cpp")
# -ffp-contract=off: no FMA may round the BVH build's areas and costs otherwise than
# numpy does (GCC contracts a*b + c wherever the target has an FMA). -pthread: the BVH
# build's tasks run on threads.
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17", "-ffp-contract=off", "-pthread")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for name in SOURCES:
        with open(os.path.join(NATIVE_DIR, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def load_library():
    """(ctypes library, BuildInfo): build the native library into the build cache's
    directory if it is not there, then load it and declare its signatures."""
    return _load_library(cache.cache_dir())


@functools.lru_cache(maxsize=None)
def _load_library(build_dir: str):
    path = os.path.join(build_dir, f"liboclpt_native_{_source_hash()}.so")
    t0 = time.perf_counter()
    built, log = False, ""
    if not os.path.exists(path):
        from oclpathtracer_tpu_torch.runtime import profiling

        os.makedirs(build_dir, exist_ok=True)
        with profiling.span("build.g++"), tempfile.TemporaryDirectory(dir=build_dir) as tmpdir:
            tmp = os.path.join(tmpdir, "lib.so")
            proc = subprocess.run(["g++", *CXX_FLAGS, "-o", tmp,
                                   *(os.path.join(NATIVE_DIR, s) for s in SOURCES)],
                                  capture_output=True, text=True)
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed ({proc.returncode}):\n{log}")
            os.replace(tmp, path)  # atomic: another process never loads half a file
        built = True
        cache.notify("compile/g++", time.perf_counter() - t0)
    lib = ctypes.CDLL(path)

    lib.oclpt_scene_load.restype = ctypes.c_void_p
    lib.oclpt_scene_load.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int]
    lib.oclpt_scene_n_meshes.restype = ctypes.c_int
    lib.oclpt_scene_n_meshes.argtypes = [ctypes.c_void_p]
    lib.oclpt_mesh_albedo.restype = ctypes.c_float
    lib.oclpt_mesh_albedo.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.oclpt_mesh_n_quads.restype = ctypes.c_int
    lib.oclpt_mesh_n_quads.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.oclpt_mesh_n_verts.restype = ctypes.c_int
    lib.oclpt_mesh_n_verts.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.oclpt_mesh_quads.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                     ctypes.POINTER(ctypes.c_int32)]
    lib.oclpt_mesh_verts.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                     ctypes.POINTER(ctypes.c_float)]
    lib.oclpt_scene_free.argtypes = [ctypes.c_void_p]

    lib.oclpt_write_ppm.restype = ctypes.c_int
    lib.oclpt_write_ppm.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                    ctypes.c_int, ctypes.c_int]
    lib.oclpt_write_ppm6.restype = ctypes.c_int
    lib.oclpt_write_ppm6.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                     ctypes.c_int, ctypes.c_int]

    # restype MUST be c_void_p (the default c_int truncates 64-bit pointers).
    lib.oclpt_stopwatch_new.restype = ctypes.c_void_p
    lib.oclpt_stopwatch_free.argtypes = [ctypes.c_void_p]
    lib.oclpt_stopwatch_start.argtypes = [ctypes.c_void_p]
    lib.oclpt_stopwatch_split.restype = ctypes.c_uint64
    lib.oclpt_stopwatch_split.argtypes = [ctypes.c_void_p]
    lib.oclpt_stopwatch_elapsed_ns.restype = ctypes.c_uint64
    lib.oclpt_stopwatch_elapsed_ns.argtypes = [ctypes.c_void_p]
    lib.oclpt_stopwatch_n_splits.restype = ctypes.c_int
    lib.oclpt_stopwatch_n_splits.argtypes = [ctypes.c_void_p]
    lib.oclpt_stopwatch_get_split.restype = ctypes.c_uint64
    lib.oclpt_stopwatch_get_split.argtypes = [ctypes.c_void_p, ctypes.c_int]

    f32p, i32p, i64 = (ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
                       ctypes.c_int64)
    lib.oclpt_bvh_build.restype = i64
    lib.oclpt_bvh_build.argtypes = [f32p, f32p, f32p, i64, i64, i64,
                                    f32p, f32p, i32p, i32p, i32p, i32p,
                                    ctypes.POINTER(i64)]
    lib.oclpt_bvh_widen.restype = i64
    lib.oclpt_bvh_widen.argtypes = [f32p, f32p, i32p, i32p, i32p, i64, i64, i64,
                                    f32p, f32p, i32p, i32p, i32p]
    return lib, BuildInfo(path, built, time.perf_counter() - t0, log)


def _lib():
    return load_library()[0]


def parse_mesh_file(path: str) -> List:
    """Native parse → the same MeshRecord list as scene/loader.parse_mesh_file."""
    from oclpathtracer_tpu_torch.scene.loader import MeshRecord

    lib = _lib()
    err = ctypes.create_string_buffer(256)
    h = lib.oclpt_scene_load(path.encode(), err, 256)
    if not h:
        msg = err.value.decode() or "native scene parse failed"
        if "cannot open" in msg:
            raise FileNotFoundError(f"{msg}: {path}")
        raise ValueError(f"{msg}: {path}")
    try:
        meshes = []
        for i in range(lib.oclpt_scene_n_meshes(h)):
            nq = lib.oclpt_mesh_n_quads(h, i)
            nv = lib.oclpt_mesh_n_verts(h, i)
            quads = np.empty((nq, 4), np.int32)
            verts = np.empty((nv, 4), np.float32)
            if nq:
                lib.oclpt_mesh_quads(h, i, quads.ctypes.data_as(
                    ctypes.POINTER(ctypes.c_int32)))
            if nv:
                lib.oclpt_mesh_verts(h, i, verts.ctypes.data_as(
                    ctypes.POINTER(ctypes.c_float)))
            meshes.append(MeshRecord(float(lib.oclpt_mesh_albedo(h, i)),
                                     quads, verts[:, :3].copy()))
        return meshes
    finally:
        lib.oclpt_scene_free(h)


def write_ppm(path: str, rgb_u8: np.ndarray, width: int, height: int) -> None:
    """ASCII P3 writer (reference token format, RaytraceTest.cpp:277-287): one pixel
    row a line, each value followed by a space."""
    buf = np.ascontiguousarray(rgb_u8.reshape(height, width, 3), np.uint8)
    rc = _lib().oclpt_write_ppm(path.encode(), buf.ctypes.data_as(ctypes.c_char_p),
                                width, height)
    if rc != 0:
        raise IOError(f"native PPM write failed: {path}")


def write_ppm6(path: str, rgb_u8: np.ndarray, width: int, height: int) -> None:
    buf = np.ascontiguousarray(rgb_u8.reshape(height, width, 3), np.uint8)
    rc = _lib().oclpt_write_ppm6(path.encode(), buf.ctypes.data_as(ctypes.c_char_p),
                                 width, height)
    if rc != 0:
        raise IOError(f"native PPM6 write failed: {path}")


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(np.ctypeslib.as_ctypes_type(a.dtype)))


def _arrays_are(arrays, dtype, shapes) -> bool:
    return all(x.dtype == dtype and x.shape == shape for x, shape in zip(arrays, shapes))


def build_bvh(p1: np.ndarray, p2: np.ndarray, p3: np.ndarray, leaf_size: int,
              branching: int):
    """Native `core/bvh.build_bvh` on (n, 3) f32 vertex arrays: ((nodes_min, nodes_max,
    skip, tri_start, tri_count, order), tasks), the numpy build's arrays bit for bit
    and the number of subtrees built as tasks on the build's threads, or (None, tasks)
    where only the numpy build reproduces its result (degenerate centroids, no split
    with a finite cost, a vertex that is not finite or not f32, arguments it
    rejects)."""
    n = p1.shape[0] if p1.ndim == 2 else 0
    if not _arrays_are((p1, p2, p3), np.float32, [(n, 3)] * 3):
        return None, 0
    lib = _lib()
    p1, p2, p3 = (np.ascontiguousarray(p) for p in (p1, p2, p3))
    room = max(2 * n - 1, 1)
    nodes_min, nodes_max = np.empty((room, 3), np.float32), np.empty((room, 3), np.float32)
    skip, start, count = (np.empty(room, np.int32) for _ in range(3))
    order = np.empty(max(n, 1), np.int32)
    tasks = ctypes.c_int64(0)
    m = lib.oclpt_bvh_build(_ptr(p1), _ptr(p2), _ptr(p3), n, int(leaf_size),
                            int(branching), _ptr(nodes_min), _ptr(nodes_max), _ptr(skip),
                            _ptr(start), _ptr(count), _ptr(order), ctypes.byref(tasks))
    if m < 0:
        return None, tasks.value
    return (nodes_min[:m].copy(), nodes_max[:m].copy(), skip[:m].copy(),
            start[:m].copy(), count[:m].copy(), order), tasks.value


def widen_bvh(nodes_min: np.ndarray, nodes_max: np.ndarray, skip: np.ndarray,
              tri_start: np.ndarray, tri_count: np.ndarray, max_children: int):
    """Native `core/bvh.widen_bvh` on a FlatBVH's arrays: (child_min, child_max,
    child_kind, child_a, child_b, depth), the numpy regrouping's bit for bit, or None
    where the numpy code decides (arrays of other dtypes or shapes, a skip link that
    leaves the tree). Raises the numpy code's ValueError on a node with more than
    `max_children` children."""
    n = skip.shape[0] if skip.ndim == 1 else 0
    if n == 0 or max_children < 1 \
            or not _arrays_are((nodes_min, nodes_max), np.float32, [(n, 3)] * 2) \
            or not _arrays_are((skip, tri_start, tri_count), np.int32, [(n,)] * 3):
        return None
    lib = _lib()
    nmin, nmax, skip, start, count = (np.ascontiguousarray(x) for x in
                                      (nodes_min, nodes_max, skip, tri_start, tri_count))
    g = 1 if n == 1 or count[0] != 0 else int(np.count_nonzero(count == 0))
    cmin = np.full((g, max_children, 3), 1e30, np.float32)
    cmax = np.full((g, max_children, 3), -1e30, np.float32)
    kind, a, b = (np.zeros((g, max_children), np.int32) for _ in range(3))
    depth = lib.oclpt_bvh_widen(_ptr(nmin), _ptr(nmax), _ptr(skip), _ptr(start),
                                _ptr(count), n, int(max_children), g, _ptr(cmin),
                                _ptr(cmax), _ptr(kind), _ptr(a), _ptr(b))
    if depth < 0:
        raise ValueError(f"node {-depth - 1} has more than {max_children} children: "
                         f"build with branching <= {max_children}")
    if depth == 0:
        return None
    return cmin, cmax, kind, a, b, int(depth)


class NativeStopwatch:
    """C++ stopwatch (≡ reference StopwatchHost, AdlStopwatchHost.inl:26-107)."""

    def __init__(self):
        self._lib = _lib()
        self._h = self._lib.oclpt_stopwatch_new()

    def start(self):
        self._lib.oclpt_stopwatch_start(self._h)
        return self

    def split_ns(self) -> int:
        return self._lib.oclpt_stopwatch_split(self._h)

    def elapsed_ns(self) -> int:
        return self._lib.oclpt_stopwatch_elapsed_ns(self._h)

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h:
            self._lib.oclpt_stopwatch_free(h)
