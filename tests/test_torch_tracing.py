"""The program's spans and counters (`runtime/profiling.py`) on the CPU: off without a
profiler (the shared no-op, no clock, no range), under one a range on the profiler's
timeline nested as the calls nest, with calls, total and self seconds in a table that
holds the latest profiler session; the launch and build counters. Each session here
follows an untraced warm-up of what it traces, as a benchmark's traced window does."""

import pytest
import torch

from oclpathtracer_tpu_torch.config import RenderConfig
from oclpathtracer_tpu_torch.core import rng
from oclpathtracer_tpu_torch.diff import fast, inverse
from oclpathtracer_tpu_torch.render import driver
from oclpathtracer_tpu_torch.render.accumulate import Accumulator
from oclpathtracer_tpu_torch.runtime import cache, profiling
from oclpathtracer_tpu_torch.scene import load_cornell_box

torch.set_num_threads(1)

CPU = torch.device("cpu")
RENDER = RenderConfig(8, 8, bounces=10)  # past the megakernel's cap: the wavefront
TRAIN = RenderConfig(4, 4, bounces=2)
TRAIN_SPANS = ("train.step", "train.forward", "train.backward", "train.update")


@pytest.fixture(scope="module")
def scene():
    return load_cornell_box(device="cpu")


@pytest.fixture(scope="module")
def steps(scene):
    """(render step, its accumulator, kernel train step, its params, its target)."""
    render = driver.make_kernel_render_step(scene, RENDER, 1)
    train = fast.make_kernel_train_step(scene, TRAIN, 1, lr=1e-3)
    return (render, Accumulator.zeros(RENDER.n_pixels, CPU), train,
            fast.extract_class_params(scene), torch.zeros((TRAIN.n_pixels, 3)))


def _run(steps, n):
    render, acc, train, params, target = steps
    for i in range(n):
        acc = render(acc, i)
        params, _ = train(params, target, i)


def _profiled(fn):
    """fn() untraced, then fn() under torch.profiler (CPU): the profiler."""
    fn()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return prof


def _parents(prof) -> dict:
    """{span name: the set of its events' parent names} of the program's spans."""
    out = {}
    for e in prof.events():
        if e.name.split(".")[0] in ("driver", "kernel", "train"):
            out.setdefault(e.name, set()).add(e.cpu_parent.name if e.cpu_parent else None)
    return out


class _NoClock:
    def perf_counter(self):
        raise AssertionError("a span read the clock without a profiler")


def test_without_a_profiler_a_span_is_the_shared_no_op(steps, monkeypatch):
    assert not torch._C._autograd._profiler_enabled()
    assert profiling.span("driver.step") is profiling.span("kernel.grad") is profiling._OFF
    before = profiling.span_stats()

    def no_range(name):
        raise AssertionError("a span entered a range without a profiler")

    monkeypatch.setattr(profiling, "time", _NoClock())
    monkeypatch.setattr(profiling, "_Range", no_range)
    _run(steps, 1)
    assert profiling.span_stats() == before
    assert profiling._open == []


def test_under_a_profiler_the_steps_record_their_spans_nested(steps):
    prof = _profiled(lambda: _run(steps, 2))
    parents = _parents(prof)
    assert parents["driver.step"] == {None}
    assert parents["kernel.wavefront"] == {"driver.step"}
    assert parents["train.step"] == {None}
    for name in TRAIN_SPANS[1:]:
        assert parents[name] == {"train.step"}, name
    assert parents["kernel.grad"] == {"train.forward", "train.backward"}
    stats = profiling.span_stats()
    assert set(stats) == {"driver.step", "kernel.wavefront", "kernel.grad", *TRAIN_SPANS}
    for name, (calls, total, self_s) in stats.items():
        assert 0.0 <= self_s <= total, name
        assert calls == (8 if name == "kernel.grad" else 2), name
    # The step's self time is its total less its children's totals.
    children = sum(stats[n][1] for n in TRAIN_SPANS[1:])
    assert stats["train.step"][2] == pytest.approx(stats["train.step"][1] - children,
                                                   abs=1e-9)
    assert stats["driver.step"][2] == pytest.approx(
        stats["driver.step"][1] - stats["kernel.wavefront"][1], abs=1e-9)


def test_the_build_of_a_render_step_is_its_prepare_span(scene):
    prof = _profiled(lambda: driver.make_kernel_render_step(scene, RENDER, 1))
    assert _parents(prof) == {"driver.prepare": {None}}
    assert profiling.span_stats()["driver.prepare"][0] == 1


def test_the_table_starts_afresh_with_a_new_profiler_session(steps, tmp_path):
    _profiled(lambda: _run(steps, 2))
    assert profiling.span_stats()["train.step"][0] == 2
    _run(steps, 1)  # no profiler: nothing recorded, the table kept
    assert profiling.span_stats()["train.step"][0] == 2
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        _run(steps, 1)
    assert profiling.span_stats()["train.step"][0] == 1
    # trace() starts its own table even straight after another session, and appends
    # it with the counters to its summary.
    for n in (2, 1):
        with profiling.trace(str(tmp_path), cuda=False):
            _run(steps, n)
        assert profiling.span_stats()["driver.step"][0] == n
    summary = (tmp_path / "summary.txt").read_text()
    rows = {line.split()[0]: line.split()[1:] for line in summary.splitlines() if line}
    assert rows["driver.step"][0] == "1" and rows["kernel.grad"][0] == "4"
    assert "counter" in rows and "total" in summary and "self" in summary


def test_counters_add_up_and_the_plain_path_counts_no_launch(steps):
    before = profiling.counts()
    profiling.count("test.things")
    profiling.count("test.things", 4)
    assert profiling.counts()["test.things"] == before.get("test.things", 0) + 5
    _run(steps, 1)
    after = profiling.counts()
    assert {k: v for k, v in after.items() if k.startswith("launch.")} == \
        {k: v for k, v in before.items() if k.startswith("launch.")}
    assert all(v == 0 for k, v in after.items() if k.startswith("launch."))


def test_a_build_event_counts_its_compiler():
    before = profiling.counts().get("build.nvcc", 0)
    cache.notify("compile/nvcc", 0.5)
    assert profiling.counts()["build.nvcc"] == before + 1


def test_the_twin_step_records_forward_and_backward_once_a_step(scene):
    step = inverse.make_train_step(scene, TRAIN, 1, lr=1e-3)
    params = inverse.extract_params(scene, albedo=True, emissive=True)
    target, key = torch.zeros((TRAIN.n_pixels, 3)), rng.make_key(3, CPU)

    def run():
        p = params
        for i in range(3):
            p, _ = step(p, target, i, key)

    prof = _profiled(run)
    parents = _parents(prof)
    assert parents["train.step"] == {None}
    assert all(parents[n] == {"train.step"} for n in TRAIN_SPANS[1:])
    stats = profiling.span_stats()
    assert set(stats) == set(TRAIN_SPANS)
    assert all(stats[n][0] == 3 for n in TRAIN_SPANS)


def test_a_span_closes_on_an_exception_and_keeps_the_function():
    @profiling.spanned("test.fails")
    def fails(x):
        """Doc."""
        raise ValueError(x)

    def run():
        with pytest.raises(ValueError):
            with profiling.span("test.outer"):
                fails(1)

    assert fails.__name__ == "fails" and fails.__doc__ == "Doc."
    _profiled(run)
    assert profiling._open == []
    stats = profiling.span_stats()
    assert stats["test.fails"][0] == stats["test.outer"][0] == 1
    assert stats["test.outer"][2] <= stats["test.outer"][1]
