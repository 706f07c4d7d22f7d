"""The port's scene loading and packing against the JAX package's, bit for bit."""

import numpy as np
import pytest
import torch

from oclpathtracer_tpu.kernels import megakernel as jmk
from oclpathtracer_tpu.scene import loader as jloader
from oclpathtracer_tpu_torch.convert import (
    class_params_from_numpy,
    scene_from_numpy,
    scene_params_from_numpy,
)
from oclpathtracer_tpu_torch.core import rng
from oclpathtracer_tpu_torch.kernels import megakernel as mk
from oclpathtracer_tpu_torch.scene import loader, procgen
from oclpathtracer_tpu_torch.scene import load_cornell_box

torch.set_num_threads(1)


def _numpy_leaves(scene):
    return [[np.asarray(x) for x in part] for part in scene]


@pytest.fixture(scope="module")
def port_scene():
    return load_cornell_box(device="cpu")


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
    converted = scene_from_numpy(*_numpy_leaves(scene), device="cpu")
    for part_c, part_p, part_j in zip(converted, port_scene, scene):
        for c, p, j in zip(part_c, part_p, part_j):
            assert torch.equal(c, p)
            np.testing.assert_array_equal(c.numpy(), np.asarray(j))
    moved = converted.to("cpu")
    assert torch.equal(moved.geometry.p1, converted.geometry.p1)
    with pytest.raises(ValueError):
        scene_from_numpy(*_numpy_leaves(scene)[:2], [np.zeros(1)], device="cpu")


_DEFAULT_DEVICE_CONSTRUCTORS = {
    "load_cornell_box": lambda: load_cornell_box(),
    "sphere_field": lambda: procgen.sphere_field(1, 0),
    "random_triangles": lambda: procgen.random_triangles(4),
    "scene_from_numpy": lambda: scene_from_numpy(*_numpy_leaves(jloader.load_cornell_box())),
    "scene_params_from_numpy": lambda: scene_params_from_numpy(albedo=np.ones((2, 3))),
    "class_params_from_numpy": lambda: class_params_from_numpy(np.ones((2, 3)),
                                                               np.zeros((2, 3))),
    "make_key": lambda: rng.make_key(0),
}


@pytest.mark.parametrize("name", sorted(_DEFAULT_DEVICE_CONSTRUCTORS))
def test_constructors_default_to_the_card_and_raise_without_one(name):
    """Every constructor a caller starts from defaults to device="cuda"; without a
    card that default raises instead of quietly running the plain versions (with a
    card, tests/test_torch_cuda.py checks that the tensors land on it)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default lands on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _DEFAULT_DEVICE_CONSTRUCTORS[name]()
