"""Runtime layer — device queries, build cache, profiling, replay, native bindings.

Counterpart of `oclpathtracer_tpu.runtime`, the answer to the reference's Adl layers
0-3 (clew loader, DeviceCL, Buffer<T>, KernelManager/KernelBuilder, Launcher —
SURVEY.md §1). CUDA's runtime under torch provides device bring-up, typed device
memory and launch; this layer exposes the same *capabilities* the reference does:

  devices.py   device enumeration / memory stats, meshes (≡ DeviceUtils, Adl.cpp:83-232)
  cache.py     the on-disk build cache of the port's libraries and its compile
               events (≡ KernelBuilder's binary cache, AdlKernelUtilsCL.cpp:130-237)
  profiling.py launch timing + device traces           (≡ Device::toggleProfiling +
               getExecutionTimeNanoseconds, AdlCL.cpp:508-517)
  replay.py    launch snapshots                        (≡ Launcher::serializeToFile)
  buffers.py   the Buffer<T> surface on tensors
  native.py    ctypes bindings to the C++ runtime components (scene I/O, image I/O),
               built with g++ at first use
"""

from oclpathtracer_tpu_torch.runtime.cache import enable_compilation_cache
from oclpathtracer_tpu_torch.runtime.devices import (
    DeviceInfo,
    device_info,
    get_devices,
    make_mesh,
    memory_stats,
)
from oclpathtracer_tpu_torch.runtime.profiling import Stopwatch, timed

__all__ = [
    "enable_compilation_cache",
    "DeviceInfo",
    "device_info",
    "get_devices",
    "make_mesh",
    "memory_stats",
    "Stopwatch",
    "timed",
]
