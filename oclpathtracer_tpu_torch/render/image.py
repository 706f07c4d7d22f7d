"""Image export — PPM (reference-compatible) and PNG.

Counterpart of `oclpathtracer_tpu.render.image`, numpy only. As in the JAX package,
`write_ppm` writes through the native C++ writer (`runtime/native.py`) and falls back
to Python where that fails; both write the same bytes.

The reference writes ASCII P3 PPM applying sqrt per channel ON TOP of the kernel's
stored gamma (RaytraceTest.cpp:277-287 + f2c :78-83), i.e. the exported file is
value^(1/2.2)^(1/2). `write_ppm(..., reference_quirk=True)` reproduces that double
transform for golden-file parity; the default export applies a single 2.2 gamma.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from oclpathtracer_tpu_torch.utils.errors import logger


def to_u8(img01: np.ndarray) -> np.ndarray:
    """f2c — scale by 255 and clamp to [0, 255] (RaytraceTest.cpp:78-83)."""
    v = np.asarray(img01, np.float32) * 255.0
    return np.minimum(v.astype(np.int32), 255).clip(0, 255).astype(np.uint8)


def _prep(img: np.ndarray, width: int, height: int, gamma: float,
          reference_quirk: bool) -> np.ndarray:
    arr = np.asarray(img, np.float32).reshape(height, width, 3)
    arr = np.maximum(arr, 0.0)
    if reference_quirk:
        # Kernel stored gamma-space values; exporter adds sqrt (RaytraceTest.cpp:283).
        arr = np.power(arr, 1.0 / 2.2)
        arr = np.sqrt(arr)
    elif gamma and gamma != 1.0:
        arr = np.power(arr, 1.0 / gamma)
    return to_u8(arr)


def write_ppm(path: str, img: np.ndarray, width: int, height: int,
              gamma: float = 2.2, reference_quirk: bool = False) -> None:
    """ASCII P3 PPM, token-compatible with the reference writer
    (`P3\\n<w> <h>\\n255\\n` then space-separated triplets, RaytraceTest.cpp:278-284):
    one pixel row a line, each value followed by a space, as the native writer
    (`native/image_io.cpp`) writes it."""
    u8 = _prep(img, width, height, gamma, reference_quirk)
    try:
        from oclpathtracer_tpu_torch.runtime import native

        native.write_ppm(path, u8, width, height)
        return
    except Exception as e:  # no compiler or a failed build: write in Python
        logger.debug("native PPM write failed (%s); writing in Python", e)
    with open(path, "w") as f:
        f.write(f"P3\n{width} {height}\n255\n")
        for row in u8:
            f.write("".join(f"{r} {g} {b} " for r, g, b in row) + "\n")


def read_ppm(path: str) -> np.ndarray:
    """Read ASCII P3 PPM → (h, w, 3) uint8."""
    with open(path) as f:
        tokens = f.read().split()
    if tokens[0] != "P3":
        raise ValueError("only ASCII PPM supported")
    w, h, maxval = int(tokens[1]), int(tokens[2]), int(tokens[3])
    if maxval != 255:
        raise ValueError(f"only maxval 255 supported, got {maxval}")
    vals = np.array(tokens[4 : 4 + w * h * 3], dtype=np.int64)
    return vals.reshape(h, w, 3).astype(np.uint8)


def write_png(path: str, img: np.ndarray, width: int, height: int,
              gamma: float = 2.2) -> None:
    """Minimal dependency-free PNG (8-bit RGB, zlib-deflate) — the reference has no
    PNG path; provided because PPM viewers are rare."""
    u8 = _prep(img, width, height, gamma, reference_quirk=False)
    raw = b"".join(b"\x00" + u8[y].tobytes() for y in range(height))

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (
            struct.pack(">I", len(payload))
            + tag
            + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", width, height, 8, 2, 0, 0, 0)
    png = (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )
    with open(path, "wb") as f:
        f.write(png)
