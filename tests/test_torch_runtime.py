"""The port's runtime and utils layers (`oclpathtracer_tpu_torch/runtime/`, `utils/`)
against the JAX package's (tests/test_runtime.py's cases), on the same numpy inputs:
buffers, launch replay, errors, metrics, device queries, the stopwatch and timed
calls, profiler traces, and the build cache with its compile listener."""

import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oclpathtracer_tpu.runtime import buffers as jbuffers
from oclpathtracer_tpu.runtime import devices as jdevices
from oclpathtracer_tpu.runtime import replay as jreplay
from oclpathtracer_tpu.utils import errors as jerrors
from oclpathtracer_tpu.utils import metrics as jmetrics
from oclpathtracer_tpu_torch.diff import extract_params
from oclpathtracer_tpu_torch.runtime import buffers, cache, native, replay
from oclpathtracer_tpu_torch.runtime.devices import (
    device_info,
    get_devices,
    memory_stats,
)
from oclpathtracer_tpu_torch.runtime.profiling import Stopwatch, timed, trace
from oclpathtracer_tpu_torch.scene import load_cornell_box
from oclpathtracer_tpu_torch.utils import errors
from oclpathtracer_tpu_torch.utils.errors import ErrorCode, PathTracerError, require
from oclpathtracer_tpu_torch.utils.metrics import RenderMetrics

torch.set_num_threads(1)

HOST = np.arange(48, dtype=np.float32).reshape(16, 3)


def test_buffer_roundtrip_matches_jax():
    b = buffers.write(buffers.allocate((16, 3), device="cpu"), HOST)
    jb = jbuffers.write(jbuffers.allocate((16, 3)), HOST)
    assert b.device.type == "cpu" and b.dtype == torch.float32
    np.testing.assert_array_equal(buffers.read(b), jbuffers.read(jb))
    np.testing.assert_array_equal(buffers.read(buffers.clear(b)), jbuffers.read(jbuffers.clear(jb)))
    np.testing.assert_array_equal(buffers.read(buffers.fill(b, 7.0)),
                                  jbuffers.read(jbuffers.fill(jb, 7.0)))
    np.testing.assert_array_equal(buffers.read(b), HOST)  # the helpers are functional


@pytest.mark.parametrize("new_len", [8, 2, 4])
def test_buffer_grow_matches_jax(new_len):
    host = np.array([[1, 2], [3, 4], [5, 6], [7, 8]], np.int32)
    b = buffers.write(buffers.allocate((4, 2), torch.int32, device="cpu"), host)
    jb = jbuffers.write(jbuffers.allocate((4, 2), jnp.int32), host)
    np.testing.assert_array_equal(buffers.read(buffers.grow(b, new_len)),
                                  jbuffers.read(jbuffers.grow(jb, new_len)))


def test_allocate_defaults_to_the_card():
    if torch.cuda.is_available():
        assert buffers.allocate((2,)).is_cuda
    else:
        with pytest.raises(RuntimeError):
            buffers.allocate((2,))


def test_launch_replay_matches_jax(tmp_path):
    """≡ Launcher::serializeToFile/deserializeFromFile round trip, beside JAX's."""
    a, b = np.arange(8, dtype=np.float32), np.ones((8,), np.float32)
    args = (torch.from_numpy(a), torch.from_numpy(b))
    fn = lambda x, y: x * 2.0 + y  # noqa: E731
    p = str(tmp_path / "launch")
    replay.save_launch(p, args, meta={"what": "test"})
    got = replay.replay(fn, p, args)
    jfn = jax.jit(lambda x, y: x * 2.0 + y)
    jargs = (jnp.asarray(a), jnp.asarray(b))
    jreplay.save_launch(str(tmp_path / "jax"), jargs)
    want = jreplay.replay(jfn, str(tmp_path / "jax"), jargs)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # The snapshots hold the same arrays under the same keys.
    ours, theirs = np.load(p + ".npz"), np.load(str(tmp_path / "jax.npz"))
    assert sorted(ours.files) == sorted(theirs.files)
    for k in ours.files:
        np.testing.assert_array_equal(ours[k], theirs[k])


def test_launch_replay_named_tuples_none_leaves_and_dtypes(tmp_path):
    """A SceneParams (None leaves stay None), an int tensor and a Python scalar come
    back with their example's structure, dtypes and device."""
    params = extract_params(load_cornell_box(device="cpu"), albedo=True, emissive=True)
    args = (params, torch.arange(5, dtype=torch.int32), 3)
    p = str(tmp_path / "snap")
    replay.save_launch(p, args)
    got = replay.load_launch(p, args)
    assert type(got[0]) is type(params) and got[0].vertices is None
    for x, y in zip(got[0], params):
        assert (x is None and y is None) or (torch.equal(x, y) and x.dtype == y.dtype)
    assert got[1].dtype == torch.int32 and torch.equal(got[1], args[1])
    assert got[2] == 3


def test_errors_match_jax():
    require(True)
    with pytest.raises(PathTracerError) as e:
        require(False, ErrorCode.ERROR_INVALID_VALUE, "bad arg")
    assert e.value.code == ErrorCode.ERROR_INVALID_VALUE
    assert [(c.name, c.value) for c in ErrorCode] == [(c.name, c.value)
                                                      for c in jerrors.ErrorCode]
    with pytest.raises(jerrors.PathTracerError) as je:
        jerrors.require(False, jerrors.ErrorCode.ERROR_INVALID_VALUE, "bad arg")
    assert str(e.value) == str(je.value)


def test_set_log_callback_routes_the_logger():
    got = []
    errors.set_log_callback(got.append)
    try:
        assert errors.logger.name == "oclpathtracer_tpu_torch"
        errors.logger.warning("hello %d", 3)
        assert got == ["hello 3"]
    finally:
        errors.set_log_callback(None)
    errors.logger.warning("dropped")
    assert got == ["hello 3"]


def test_check_finite():
    x = torch.tensor([1.0, 2.0])
    assert errors.check_finite(x) is x
    for bad in (float("nan"), float("inf")):
        with pytest.raises(PathTracerError) as e:
            errors.check_finite(torch.tensor([1.0, bad]), "radiance")
        assert e.value.code == ErrorCode.ERROR_INVALID_VALUE
        assert "non-finite radiance" in str(e.value)


def test_metrics_accounting_matches_jax():
    m = RenderMetrics(n_pixels=100).start()
    jm = jmetrics.RenderMetrics(n_pixels=100).start()
    for r in (m, jm):
        r.step(samples=0, first_call=True)
        r.step(samples=4, segments=1e6)
    s, js = m.summary(), jm.summary()
    assert s.keys() == js.keys()
    assert s["samples"] == js["samples"] == 4
    assert s["mrays_per_s"] >= 0.0 and m.compile_s >= 0.0
    assert m.segments_done == jm.segments_done == 1e6


def test_device_queries():
    assert get_devices("cpu") == [torch.device("cpu")]
    info = device_info("cpu")
    jinfo = jdevices.device_info(jax.devices("cpu")[0])
    assert (info.platform, info.kind) == (jinfo.platform, jinfo.kind) == ("cpu", "cpu")
    assert memory_stats("cpu") == {}
    with pytest.raises(ValueError):
        get_devices("tpu")
    if not torch.cuda.is_available():
        assert get_devices() == [] and get_devices("cuda") == []
        with pytest.raises(RuntimeError):
            device_info()


def test_stopwatch_and_timed():
    sw = Stopwatch().start()
    s1 = sw.split()
    s2 = sw.split()
    assert 0 <= s1 <= s2 and sw.splits == [s1, s2]
    assert sw.elapsed_ms() >= s2 * 1e3
    out, secs = timed(lambda x: (x + 1, {"n": x * 2}), torch.zeros((4,)))
    assert secs >= 0 and out[0].shape == (4,) and torch.equal(out[1]["n"], torch.zeros(4))


def test_trace_writes_trace_and_summary(tmp_path):
    d = str(tmp_path / "prof")
    with trace(d, cuda=False) as prof:
        torch.ones(64).sum()
    assert prof is not None
    assert os.path.getsize(os.path.join(d, "trace.json")) > 0
    with open(os.path.join(d, "summary.txt")) as f:
        assert "Self CPU" in f.read()


def test_compile_listener_fires_once_per_native_build(tmp_path):
    """An explicit cache directory redirects the native build; its g++ build fires
    each listener once, and the next load from that directory fires nothing."""
    events = []
    cache.register_compile_listener(lambda ev, s: events.append((ev, s)))
    try:
        d = cache.enable_compilation_cache(str(tmp_path / "build"))
        assert d == str(tmp_path / "build") == cache.cache_dir() and os.path.isdir(d)
        _, info = native.load_library()
        assert info.built and os.path.dirname(info.path) == d
        assert len(events) == 1 and events[0][0] == "compile/g++" and events[0][1] >= 0
        _, again = native.load_library()
        assert again.path == info.path and len(events) == 1
    finally:
        assert cache.enable_compilation_cache() == cache.DEFAULT_CACHE_DIR
    assert cache.DEFAULT_CACHE_DIR.endswith(os.path.join("oclpathtracer_tpu_torch", "kernels",
                                                         "build"))


def test_log_compiles_logs_each_build(tmp_path):
    got = []
    errors.set_log_callback(got.append)
    cache.log_compiles(True)
    try:
        cache.enable_compilation_cache(str(tmp_path / "logged"))
        native.load_library()
    finally:
        cache.log_compiles(False)
        errors.set_log_callback(None)
        cache.enable_compilation_cache()
    assert len(got) == 1 and got[0].startswith("built compile/g++ in ")
    assert errors.logger.getEffectiveLevel() <= logging.WARNING
