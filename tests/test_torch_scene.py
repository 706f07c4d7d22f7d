"""The port's scene loading and packing against the JAX package's, bit for bit."""

import numpy as np
import pytest
import torch

from oclpathtracer_tpu.kernels import megakernel as jmk
from oclpathtracer_tpu.scene import loader as jloader
from oclpathtracer_tpu_torch.convert import scene_from_numpy
from oclpathtracer_tpu_torch.kernels import megakernel as mk
from oclpathtracer_tpu_torch.scene import loader
from oclpathtracer_tpu_torch.scene import load_cornell_box

torch.set_num_threads(1)


def _numpy_leaves(scene):
    return [[np.asarray(x) for x in part] for part in scene]


@pytest.fixture(scope="module")
def port_scene():
    return load_cornell_box()


def test_scene_data_bytes_equal():
    with open(jloader.DEFAULT_SCENE_PATH, "rb") as a, open(loader.DEFAULT_SCENE_PATH, "rb") as b:
        data = b.read()
        assert a.read() == data
    assert len(data) == 1516


@pytest.mark.parametrize("part", ["geometry", "materials", "lights"])
def test_loader_arrays_bitwise(scene, port_scene, part):
    for j, t in zip(getattr(scene, part), getattr(port_scene, part)):
        j = np.asarray(j)
        assert t.numpy().dtype == j.dtype
        np.testing.assert_array_equal(t.numpy(), j)


def test_pack_scene_bitwise(scene, port_scene):
    np.testing.assert_array_equal(mk.pack_scene(port_scene).numpy(),
                                  np.asarray(jmk.pack_scene(scene)))


def test_pack_scene_tp_and_classes_bitwise(scene, port_scene):
    jt, jcls = jmk.pack_scene_tp(scene)
    tt, tcls = mk.pack_scene_tp(port_scene)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert tcls == jcls and len(tcls) == 5
    jc, jidx = jmk.material_classes(scene)
    tc, tidx = mk.material_classes(port_scene)
    assert tc == jc
    np.testing.assert_array_equal(tidx, jidx)


def test_augment_table_tp0_allclose(scene, port_scene):
    from oclpathtracer_tpu import RenderConfig as JCfg

    eye = jmk._camera_constants(JCfg())[4]
    jt, _ = jmk.pack_scene_tp(scene)
    tt, _ = mk.pack_scene_tp(port_scene)
    np.testing.assert_allclose(mk.augment_table_tp0(tt, eye).numpy(),
                               np.asarray(jmk.augment_table_tp0(jt, eye)),
                               rtol=1e-6, atol=1e-6)


def test_scan_support_predicates_match(scene, port_scene):
    assert mk.tp_scan_supported(port_scene) == jmk.tp_scan_supported(scene) is True
    assert mk.fast_scan_supported(port_scene) == jmk.fast_scan_supported(scene)
    assert mk.scene_emissive_const(port_scene) == jmk.scene_emissive_const(scene)
    assert mk.resolve_scan(port_scene) == jmk.resolve_scan(scene) == "tp"


def test_prepare_scan(port_scene):
    """(scan, table, emi_const, classes), the JAX package's tuple; an explicit fast
    scan packs pack_scene's table with the shared emitter RGB."""
    scan, table, emi, classes = mk.prepare_scan(port_scene, "auto")
    assert scan == "tp" and table.shape == (36, 24) and len(classes) == 5
    assert emi == (0.0, 0.0, 0.0)
    scan, table, emi, classes = mk.prepare_scan(port_scene, "parity")
    assert scan == "parity" and classes == () and emi == (0.0, 0.0, 0.0)
    scan, table, emi, classes = mk.prepare_scan(port_scene, "fast")
    assert scan == "fast" and classes == () and emi == (30.0, 30.0, 30.0)
    assert torch.equal(table, mk.pack_scene(port_scene))
    with pytest.raises(ValueError):
        mk.prepare_scan(port_scene, "bogus")


def test_scene_from_numpy_round_trips(scene, port_scene):
    converted = scene_from_numpy(*_numpy_leaves(scene))
    for part_c, part_p, part_j in zip(converted, port_scene, scene):
        for c, p, j in zip(part_c, part_p, part_j):
            assert torch.equal(c, p)
            np.testing.assert_array_equal(c.numpy(), np.asarray(j))
    moved = converted.to("cpu")
    assert torch.equal(moved.geometry.p1, converted.geometry.p1)
    with pytest.raises(ValueError):
        scene_from_numpy(*_numpy_leaves(scene)[:2], [np.zeros(1)])
