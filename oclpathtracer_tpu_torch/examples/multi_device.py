"""Multi-device rendering demo: a tile-sharded progressive render over a mesh,
checked bit for bit against the single-device render.

    python -m oclpathtracer_tpu_torch.examples.multi_device [--entries 8] [--device cuda]

The mesh has `--entries` entries over the visible devices of `--device`'s type, in
turn (one card: n × `cuda:0`; `--device cpu`: n × `cpu`). Exits 1 if the two images
differ in any bit.
"""

from __future__ import annotations

import argparse
import sys

import torch

from oclpathtracer_tpu_torch.config import RenderConfig
from oclpathtracer_tpu_torch.convert import resolve_device
from oclpathtracer_tpu_torch.parallel import default_mesh, render_progressive_sharded
from oclpathtracer_tpu_torch.render.driver import render_progressive
from oclpathtracer_tpu_torch.render.image import write_png
from oclpathtracer_tpu_torch.runtime.devices import get_devices
from oclpathtracer_tpu_torch.scene import load_cornell_box


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--bounces", type=int, default=6)
    ap.add_argument("--spp", type=int, default=16)
    ap.add_argument("--samples-per-step", type=int, default=8)
    ap.add_argument("--entries", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("-o", "--output", default="multi_device_render.png")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    devs = get_devices() if device.type == "cuda" else [device]
    mesh = default_mesh([devs[i % len(devs)] for i in range(args.entries)])
    print(f"mesh: {mesh.size} entries over {sorted({str(d) for d in mesh.devices})}")

    scene = load_cornell_box(device=mesh.devices[0])
    cfg = RenderConfig(width=args.size, height=args.size, bounces=args.bounces)
    img_sharded = render_progressive_sharded(scene, cfg, mesh, total_spp=args.spp,
                                             samples_per_step=args.samples_per_step)
    img_single = render_progressive(scene, cfg, total_spp=args.spp,
                                    samples_per_step=args.samples_per_step)
    same = torch.equal(img_sharded, img_single)
    print(f"sharded == single-device bitwise: {same}")
    write_png(args.output, img_sharded.cpu().numpy(), args.size, args.size)
    print(f"wrote {args.output}")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
