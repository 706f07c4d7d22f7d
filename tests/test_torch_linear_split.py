"""The redesigned linear kernels' work split and table reads, on CPU tensors.

The megakernel and trace_rays (csrc/regen.cuh) give a pixel's (or a row's) samples
to lanes in runs; with runs shorter than n_samples each sample's max(rad, 0) goes to
a (n_samples, n, 3) scratch buffer and csrc/split.cuh's sum adds them in sample
order. They read the (T, 24) table in place as aligned float4s, the tp0 peel its
float4s 0, 4 and 5 of a row. So:

  * the split plain (render_frames_split_plain + sample_sum_plain, k = 1) equals
    _render_samples_stats_plain bit for bit for parity, fast, tp with the tp0 peel
    and tp without;
  * trace_rays_split_plain + sample_sum_plain equals _trace_rays_stats_plain bit for
    bit in each scan form;
  * those float4s of an augment_table_tp0 row hold the columns the plain tp0 scan
    reads, and a table off a 16-byte boundary is refused;
  * both wrappers reject run < 1 and size their split as default_run says.
"""

import pytest
import torch

from oclpathtracer_tpu_torch.config import RenderConfig
from oclpathtracer_tpu_torch.kernels import megakernel as mk
from oclpathtracer_tpu_torch.kernels import selfcheck
from oclpathtracer_tpu_torch.scene import load_cornell_box

torch.set_num_threads(1)

CFG = RenderConfig(width=16, height=16, bounces=2)
START, N_SAMPLES = 5, 3


@pytest.fixture(scope="module")
def cornell():
    return load_cornell_box(device="cpu")


@pytest.fixture(scope="module")
def rays(cornell):
    return selfcheck.probe_rays(cornell, 64, CFG, seed=0)


@pytest.mark.parametrize("scan,tp0", [("parity", True), ("fast", True), ("tp", True),
                                      ("tp", False)])
def test_split_render_is_the_megakernel_plain_version_bitwise(cornell, scan, tp0):
    _, table, emi, classes = mk.prepare_scan(cornell, scan)
    tp0_on = mk.tp0_enabled(scan, tp0, table.shape[0], CFG.bounces)
    assert tp0_on == (scan == "tp" and tp0)
    peeled = mk.tp0_table_for(table, CFG, scan, tp0) if tp0_on else table
    nearest = mk.linear_nearest(mk._PlainScene(peeled, classes, scan, emi), tp0_on)
    scratch, segs = mk.render_frames_split_plain(CFG, START, N_SAMPLES, 0, CFG.n_pixels, "cpu",
                                                 nearest)
    assert scratch.shape == (N_SAMPLES, CFG.n_pixels, 3)
    want, want_segs = mk._render_samples_stats_plain(table, CFG, START, N_SAMPLES, scan=scan,
                                                     classes=classes, tp0=tp0, emi_const=emi)
    assert torch.equal(mk.sample_sum_plain(scratch, 1), want)
    assert segs.dtype == torch.int64 and int(segs) == int(want_segs)


@pytest.mark.parametrize("scan", ["parity", "fast", "tp"])
def test_split_trace_rays_is_its_plain_version_bitwise(cornell, rays, scan):
    _, table, emi, classes = mk.prepare_scan(cornell, scan)
    o, d = rays
    kw = dict(row_base=7, start_sample=(1 << 20) + 3, scan=scan, classes=classes, emi_const=emi)
    scratch, segs = mk.trace_rays_split_plain(table, o, d, CFG, N_SAMPLES, **kw)
    assert scratch.shape == (N_SAMPLES, o.shape[0], 3)
    want, want_segs = mk._trace_rays_stats_plain(table, o, d, CFG, N_SAMPLES, **kw)
    assert torch.equal(mk.sample_sum_plain(scratch, 1), want)
    assert segs.dtype == torch.int64 and int(segs) == int(want_segs)


def test_tp0_float4_reads_hold_the_columns_of_the_plain_tp0_scan(cornell):
    _, table, _, _ = mk.prepare_scan(cornell, "tp")
    peeled = mk.tp0_table_for(table, CFG, "tp")
    rows4 = peeled.view(-1, mk.TABLE_COLS // 4, 4)
    n, u, v = rows4[:, 0], rows4[:, 4], rows4[:, 5]
    assert torch.equal(n[:, :3], peeled[:, 0:3])    # N
    assert torch.equal(u[:, 1:], peeled[:, 17:20])  # U
    assert torch.equal(v[:, :3], peeled[:, 20:23])  # V
    assert torch.equal(v[:, 3], peeled[:, 23])      # t0
    assert torch.equal(peeled[:, :17], table[:, :17])
    mk.check_rows4(peeled)
    off = torch.zeros(table.numel() + 1)[1:].view(table.shape)
    with pytest.raises(ValueError):
        mk.check_rows4(off)


def test_linear_wrappers_check_run_and_size_their_split(cornell, rays):
    table = mk.pack_scene(cornell)
    o, d = rays
    with pytest.raises(ValueError):
        mk.render_samples_pallas_stats(table, CFG, 0, 1, run=0)
    with pytest.raises(ValueError):
        mk.trace_rays_pallas_stats(table, o, d, CFG, 1, run=0)
    assert mk.default_run(64, 512 * 512) == mk.DEFAULT_RUN  # 201 MB of scratch
    assert mk.default_run(1024, 512 * 512) == 1024  # 3.2 GB: a pixel a lane
    assert mk.default_run(2, 1_572_864) == mk.DEFAULT_RUN  # the rim probes: 38 MB
    assert mk.check_run(None, 8, 64 * 64) == min(mk.DEFAULT_RUN, 8)
    assert mk.check_run(100, 8, 64 * 64) == 8
    out, scratch, counters = mk.split_buffers(8, 10, 2, "cpu")
    assert out.shape == (10, 3) and scratch.shape == (8, 10, 3)
    assert counters.dtype == torch.int64 and counters.tolist() == [0, 0]
    assert mk.split_buffers(8, 10, 8, "cpu")[1] is None
