"""The layouts the redesigned kernels read, and their work split, on CPU tensors.

  * the 8-wide group record holds exactly wn_f's and wn_i's values, slot index last,
    for the port's pack and for the JAX package's;
  * the wavefront's scan-only table holds exactly the table columns its scan form
    reads (padded with zeros to whole float4s);
  * the split render (each sample's max(rad, 0) into a (n_samples, n_pix, 3)
    scratch buffer, then the in-order sum of csrc/split.cuh) equals the unsplit
    plain versions bit for bit: the wavefront's at k = 1 and k = 3 and the 8-wide
    and skip-link walks', on the inputs the JAX-matched tests use (the Cornell box through
    convert.scene_from_numpy, sphere_field(3, 1, seed=2)).
"""

import numpy as np
import pytest
import torch

from oclpathtracer_tpu.kernels import wide_bvh as jwb
from oclpathtracer_tpu.scene import procgen as jprocgen
from oclpathtracer_tpu_torch.config import CameraConfig, RenderConfig
from oclpathtracer_tpu_torch.convert import scene_from_numpy
from oclpathtracer_tpu_torch.kernels import bvh_megakernel as bk
from oclpathtracer_tpu_torch.kernels import megakernel as mk
from oclpathtracer_tpu_torch.kernels import wavefront as wf
from oclpathtracer_tpu_torch.kernels import wide_bvh as wb

torch.set_num_threads(1)

SCANS = ["parity", "fast", "tp"]
CFG = RenderConfig(width=24, height=20, bounces=2)
SPHERES_CFG = RenderConfig(width=24, height=20, bounces=2,
                           camera=CameraConfig(eye=(0.0, 3.0, 9.0)))


def _port(jscene):
    return scene_from_numpy(*[[np.asarray(x) for x in part] for part in jscene], device="cpu")


@pytest.fixture(scope="module")
def cornell(scene):
    return _port(scene)


@pytest.fixture(scope="module")
def spheres():
    jsf = jprocgen.sphere_field(3, 1, seed=2)
    return jsf, _port(jsf)


@pytest.mark.parametrize("scan", SCANS)
def test_group_record_holds_the_wide_tables_values(spheres, scan):
    jsf, tsf = spheres
    _, wn_f, wn_i, _, _ = wb.pack_wide_bvh_scene(tsf, 4, scan)
    boxes, meta = wb.group_record(wn_f, wn_i)
    g = wn_f.shape[0]
    assert boxes.shape == (g, 6, 8) and meta.shape == (g, 3, 8)
    assert boxes.dtype == torch.float32 and meta.dtype == torch.int32
    assert boxes.is_contiguous() and meta.is_contiguous()
    for slot in range(8):
        for k in range(6):
            assert torch.equal(boxes[:, k, slot], wn_f[:, slot, k])
        for k in range(3):
            assert torch.equal(meta[:, k, slot], wn_i[:, slot, k])
    _, jf, ji, _, _ = jwb.pack_wide_bvh_scene(jsf, 4, scan)
    jboxes, jmeta = wb.group_record(torch.from_numpy(np.array(jf)),
                                    torch.from_numpy(np.array(ji)))
    assert torch.equal(boxes, jboxes) and torch.equal(meta, jmeta)


@pytest.mark.parametrize("scan", SCANS)
def test_scan_table_holds_the_table_columns(cornell, scan):
    _, table, _, _ = mk.prepare_scan(cornell, scan)
    st = wf.scan_table(table, scan)
    cols = 16 if scan == "tp" else 9
    assert st.shape == (table.shape[0], 16 if scan == "tp" else 12)
    assert st.dtype == torch.float32 and st.is_contiguous()
    assert torch.equal(st[:, :cols], table[:, :cols])
    assert not bool(st[:, cols:].any())
    assert (st.shape[1] * 4) % 16 == 0  # whole 16-byte rows


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("scan", ["parity", "tp"])
def test_split_render_is_the_wavefront_plain_version_bitwise(cornell, scan, k):
    _, table, emi, classes = mk.prepare_scan(cornell, scan)
    nearest = mk.linear_nearest(mk._PlainScene(table, classes, scan, emi))
    scratch, segs = mk.render_frames_split_plain(CFG, 2, 5, 0, CFG.n_pixels, "cpu", nearest)
    assert scratch.shape == (5, CFG.n_pixels, 3)
    img = mk.sample_sum_plain(scratch, k)
    want, want_segs = wf._render_samples_wavefront_plain(table, CFG, 2, 5, k, scan, classes,
                                                         emi_const=emi)
    assert torch.equal(img, want) and int(segs) == int(want_segs)


def test_split_render_is_the_wide_walks_unsplit_sum_bitwise(spheres):
    """The 8-wide walk's and the skip-link walk's plain versions (each sample into
    the scratch buffer, then the in-order sum) against the unsplit sum of the same
    walk, in each leaf form."""
    _, tsf = spheres
    for scan in SCANS:
        emi = mk.scene_emissive_const(tsf) if scan == "fast" else mk.NO_EMI
        table, wn_f, wn_i, depth, classes = wb.pack_wide_bvh_scene(tsf, 8, scan)
        got = wb._render_samples_wide_bvh_stats_plain(table, wn_f, wn_i, SPHERES_CFG, 3, 3,
                                                      scan, emi, classes, depth)
        nearest = wb._wide_walk_nearest(mk._PlainScene(table, classes, scan, emi), wn_f, wn_i,
                                        depth)
        want = mk.render_frames_plain(SPHERES_CFG, 3, 3, 0, SPHERES_CFG.n_pixels, "cpu",
                                      nearest)
        assert torch.equal(got[0], want[0]) and int(got[1]) == int(want[1])
        _, table, nodes_f, nodes_i, emi, classes = bk.prepare_bvh_scan(tsf, scan, leaf_size=8)
        got = bk._render_samples_bvh_stats_plain(table, nodes_f, nodes_i, SPHERES_CFG, 3, 3,
                                                 8, scan, emi, classes)
        nearest = bk._skip_walk_nearest(mk._PlainScene(table, classes, scan, emi), nodes_f,
                                        nodes_i)
        skip = mk.render_frames_plain(SPHERES_CFG, 3, 3, 0, SPHERES_CFG.n_pixels, "cpu", nearest)
        assert torch.equal(got[0], skip[0]) and int(got[1]) == int(skip[1])
        assert torch.equal(got[0], want[0])  # the two walks' bits


def test_sample_sum_adds_streams_in_the_plain_versions_order():
    """Values whose f32 sum depends on the order: stream i = samples i, i+k, … from 0,
    then the streams in ascending order."""
    vals = [1e8, 1.0, -1e8, 3.0, 0.5, 7.0, 1e-3]
    scratch = torch.tensor(vals, dtype=torch.float32)[:, None, None].expand(-1, 1, 3)
    f32 = np.float32
    for k in (1, 2, 3, 9):
        total = f32(0.0)
        for i in range(min(k, len(vals))):
            acc = f32(0.0)
            for s in range(i, len(vals), k):
                acc = f32(acc + f32(vals[s]))
            total = f32(total + acc)
        assert mk.sample_sum_plain(scratch.contiguous(), k)[0, 0].item() == float(total)


def test_wavefront_wrapper_checks_run_and_sizes_its_split(cornell):
    table = mk.pack_scene(cornell)
    with pytest.raises(ValueError):
        wf.render_samples_wavefront_stats(table, CFG, 0, 1, run=0)
    assert wf.scan_in_shared(wf.scan_table(table, "parity"))  # 36 rows of 48 bytes
    huge = torch.zeros((mk.SMEM_TABLE_MAX_BYTES // 48 + 1, 12))
    assert not wf.scan_in_shared(huge)
    assert mk.default_run(64, 512 * 512) == mk.DEFAULT_RUN  # 201 MB of scratch
    assert mk.default_run(1024, 512 * 512) == 1024  # 3.2 GB: a pixel a thread
