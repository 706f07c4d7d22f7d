"""The port's native C++ runtime (`oclpathtracer_tpu_torch/native/*.cpp` through
`runtime/native.py`): the scene parse bit for bit against the JAX package's Python
parser and the port's own, its errors, the PPM writers byte for byte against the JAX
package's `write_ppm` and the port's Python route, the stopwatch, and
`load_cornell_box` through the native route against JAX's scene."""

import time

import numpy as np
import pytest
import torch

from oclpathtracer_tpu.render import image as jimage
from oclpathtracer_tpu.scene import loader as jloader
from oclpathtracer_tpu_torch.render import image
from oclpathtracer_tpu_torch.runtime import native
from oclpathtracer_tpu_torch.scene import loader

torch.set_num_threads(1)


def _same_records(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert np.float32(x.file_albedo).tobytes() == np.float32(y.file_albedo).tobytes()
        assert x.quad_idx.dtype == y.quad_idx.dtype and x.verts.dtype == y.verts.dtype
        assert x.quad_idx.tobytes() == y.quad_idx.tobytes()
        assert x.verts.shape == y.verts.shape and x.verts.tobytes() == y.verts.tobytes()


def test_native_parse_matches_both_python_parsers():
    nt = native.parse_mesh_file(loader.DEFAULT_SCENE_PATH)
    assert len(nt) == 6
    _same_records(nt, jloader.parse_mesh_file(jloader.DEFAULT_SCENE_PATH))
    _same_records(nt, loader.parse_mesh_file(loader.DEFAULT_SCENE_PATH))


def test_native_parse_errors(tmp_path):
    with pytest.raises(FileNotFoundError):
        native.parse_mesh_file(str(tmp_path / "missing.bin"))
    data = open(loader.DEFAULT_SCENE_PATH, "rb").read()
    for name, blob in (("trunc", data[:50]), ("trailing", data + b"\0")):
        bad = tmp_path / f"{name}.bin"
        bad.write_bytes(blob)
        with pytest.raises(ValueError):
            native.parse_mesh_file(str(bad))


def test_native_ppm_token_format(tmp_path):
    img = (np.arange(2 * 3 * 3) % 256).astype(np.uint8)
    p = tmp_path / "t.ppm"
    native.write_ppm(str(p), img, 3, 2)
    toks = p.read_text().split()
    assert toks[:4] == ["P3", "3", "2", "255"]
    assert [int(t) for t in toks[4:]] == list(range(18))


def test_native_ppm6_roundtrip(tmp_path):
    img = (np.arange(4 * 4 * 3) % 256).astype(np.uint8)
    p = tmp_path / "t6.ppm"
    native.write_ppm6(str(p), img, 4, 4)
    header, pixels = p.read_bytes().split(b"255\n", 1)
    assert header.startswith(b"P6")
    assert np.array_equal(np.frombuffer(pixels, np.uint8), img)


@pytest.mark.parametrize("quirk", [False, True])
def test_ppm_bytes_equal_jax_and_the_python_route(tmp_path, monkeypatch, quirk):
    """write_ppm's native route, the JAX package's write_ppm and the port's Python
    route (native writer made to fail) write the same bytes."""
    w, h = 7, 5
    img = np.random.default_rng(3).random((w * h, 3)).astype(np.float32) * 1.5
    ours, jax_out, python = (str(tmp_path / f"{n}.ppm") for n in ("ours", "jax", "py"))
    image.write_ppm(ours, img, w, h, reference_quirk=quirk)
    jimage.write_ppm(jax_out, img, w, h, reference_quirk=quirk)

    def refuse(*a, **k):
        raise OSError("no native writer")

    monkeypatch.setattr(native, "write_ppm", refuse)
    image.write_ppm(python, img, w, h, reference_quirk=quirk)
    data = open(ours, "rb").read()
    assert data == open(jax_out, "rb").read() == open(python, "rb").read()
    assert image.read_ppm(ours).shape == (h, w, 3)


def test_native_stopwatch():
    sw = native.NativeStopwatch().start()
    time.sleep(0.005)
    s1 = sw.split_ns()
    time.sleep(0.005)
    s2 = sw.split_ns()
    assert 0 < s1 < s2
    assert sw.elapsed_ns() >= s2


def test_load_cornell_box_goes_native_and_matches_jax(scene, monkeypatch):
    """load_cornell_box parses through the native route; its tables equal the JAX
    package's scene and the Python route's (native parser made to fail), bit for bit."""
    calls = []
    parse = native.parse_mesh_file

    def counted(path):
        calls.append(path)
        return parse(path)

    monkeypatch.setattr(native, "parse_mesh_file", counted)
    ours = loader.load_cornell_box(device="cpu")
    assert calls == [loader.DEFAULT_SCENE_PATH]

    def refuse(path):
        raise OSError("no native parser")

    monkeypatch.setattr(native, "parse_mesh_file", refuse)
    python = loader.load_cornell_box(device="cpu")
    for part, jpart, ppart in zip(ours, scene, python):
        for x, jx, px in zip(part, jpart, ppart):
            jx = np.asarray(jx)
            assert x.numpy().dtype == jx.dtype and x.numpy().tobytes() == jx.tobytes()
            assert torch.equal(x, px) and x.dtype == px.dtype
