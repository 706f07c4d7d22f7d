"""Command-line harness — `python -m oclpathtracer_tpu_torch <command>`.

Counterpart of `oclpathtracer_tpu.cli`, with the same commands and flags:

  info                 device enumeration + queries (runtime/devices.py)
  render               progressive render → PPM/PNG
  bench                one-line JSON throughput (bench.py: Mrays/s against the anchor)

`render --integrator` takes every choice of the JAX CLI, on the Cornell box, with
the JAX CLI's calls: `pallas`, `wavefront`, `bvh`, `widebvh` and `sorted` (8 spp a
call) run the path-trace kernels; `ao-pallas` and `direct-pallas` the AO and
direct-NEE kernels, all `--spp` samples in one launch; `path`, `ao` and `direct`
the batched torch integrators on threefry streams keyed by `--seed`; `primary` the
centred primary cast. A non-zero `--scan-chunks` (a scheduling knob of the JAX
package's kernels) exits 2.

`render --device` and `bench --device` say where the work runs, a deployment
setting: the JAX CLI takes it from JAX's platform setting (`JAX_PLATFORMS`), and
torch has no such global. The default, cuda, launches the kernels and exits 2
without a GPU; `--device cpu` runs their plain PyTorch versions, on purpose only.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

INTEGRATORS = ["pallas", "wavefront", "bvh", "widebvh", "sorted", "path", "primary",
               "ao", "ao-pallas", "direct", "direct-pallas"]


def _cmd_info(args) -> int:
    import torch

    from oclpathtracer_tpu_torch.runtime import device_info, get_devices

    devs = get_devices()
    print(f"backend: {'gpu' if devs else 'cpu'}  cuda: {torch.version.cuda}  "
          f"devices: {len(devs)}")
    for d in devs:
        info = device_info(d)
        print(f"  [{info.index}] {info.platform} {info.kind}"
              + (f"  mem={info.memory_total}" if info.memory_total else ""))
    return 0


def _no_card(command: str, device) -> bool:
    """True (and a message) where `device` is a CUDA device and there is none."""
    import torch

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        print(f"{command}: no CUDA device (pass --device cpu for the plain versions)",
              file=sys.stderr)
        return True
    return False


def _cmd_render(args) -> int:
    import torch

    from oclpathtracer_tpu_torch.config import RenderConfig
    from oclpathtracer_tpu_torch.render.image import write_png, write_ppm
    from oclpathtracer_tpu_torch.scene import load_cornell_box

    if args.scan_chunks:
        print("--scan-chunks: not yet ported (the kernels here have no such knob; "
              "pass 0)", file=sys.stderr)
        return 2
    if _no_card("render", args.device):
        return 2
    device = torch.device(args.device)
    scene = load_cornell_box(args.scene, device=device)
    cfg = RenderConfig(width=args.width, height=args.height, bounces=args.bounces,
                       seed=args.seed)

    profile_ctx = None
    if args.profile:
        from oclpathtracer_tpu_torch.runtime.profiling import trace

        profile_ctx = trace(args.profile, cuda=device.type == "cuda")
        profile_ctx.__enter__()

    t0 = time.perf_counter()
    if args.integrator == "pallas":
        from oclpathtracer_tpu_torch.kernels.megakernel import render_pallas

        img = render_pallas(scene, cfg, args.spp, samples_per_call=min(args.spp, 64),
                            scan=args.scan)
    elif args.integrator == "wavefront":
        from oclpathtracer_tpu_torch.kernels.wavefront import render_wavefront

        img = render_wavefront(scene, cfg, args.spp, samples_per_call=min(args.spp, 64),
                               scan=args.scan, interleave=args.interleave or 1)
    elif args.integrator == "bvh":
        from oclpathtracer_tpu_torch.kernels.bvh_megakernel import render_bvh

        img = render_bvh(scene, cfg, args.spp, samples_per_call=min(args.spp, 64),
                         scan=args.scan)
    elif args.integrator == "path":
        from oclpathtracer_tpu_torch.render.driver import render_progressive

        img = render_progressive(scene, cfg, args.spp, samples_per_step=min(args.spp, 16),
                                 checkpoint_path=args.checkpoint,
                                 checkpoint_every=args.checkpoint_every)
    elif args.integrator == "widebvh":
        from oclpathtracer_tpu_torch.render.driver import render_progressive

        img = render_progressive(scene, cfg, args.spp, samples_per_step=min(args.spp, 64),
                                 backend="widebvh", scan=args.scan)
    elif args.integrator == "sorted":
        from oclpathtracer_tpu_torch.kernels.sorted_wavefront import render_sorted

        img = render_sorted(scene, cfg, args.spp, samples_per_call=min(args.spp, 8))
    elif args.integrator == "ao":
        from oclpathtracer_tpu_torch.core import rng
        from oclpathtracer_tpu_torch.integrators.ao import render_ao

        img = render_ao(scene, cfg, rng.make_key(cfg.seed, device), spp=args.spp)
    elif args.integrator == "ao-pallas":
        from oclpathtracer_tpu_torch.kernels import fast_integrators

        img = fast_integrators.render_ao(scene, cfg, args.spp)
    elif args.integrator == "direct-pallas":
        from oclpathtracer_tpu_torch.kernels import fast_integrators

        img = fast_integrators.render_direct(scene, cfg, args.spp)
    elif args.integrator == "direct":
        from oclpathtracer_tpu_torch.core import rng
        from oclpathtracer_tpu_torch.integrators.direct import render_direct

        img = render_direct(scene, cfg, rng.make_key(cfg.seed, device), spp=args.spp)
    else:
        from oclpathtracer_tpu_torch.integrators.primary import render_primary

        img = render_primary(scene, cfg)
    img = img.cpu().numpy()
    dt = time.perf_counter() - t0
    if profile_ctx is not None:
        profile_ctx.__exit__(None, None, None)
        with open(os.path.join(args.profile, "summary.txt")) as f:
            print(f.read())
        print(f"profile trace written to {args.profile}")
    print(f"rendered {cfg.width}x{cfg.height} spp={args.spp} "
          f"integrator={args.integrator} in {dt:.2f}s mean={img.mean():.4f}")

    out = args.output
    if out.endswith(".ppm"):
        write_ppm(out, img, cfg.width, cfg.height, reference_quirk=args.reference_quirk)
    else:
        write_png(out, img, cfg.width, cfg.height)
    print(f"wrote {out}")
    return 0


def _cmd_bench(args) -> int:
    if _no_card("bench", args.device):
        return 2
    from oclpathtracer_tpu_torch import bench

    bench.run(device=args.device)
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="oclpathtracer_tpu_torch")
    sub = p.add_subparsers(dest="command", required=True)

    sub.add_parser("info", help="CUDA device enumeration and queries")

    r = sub.add_parser("render", help="progressive render to PPM/PNG")
    r.add_argument("--scene", default=None, help="scene .bin (default: cornellbox)")
    r.add_argument("--width", type=int, default=512)
    r.add_argument("--height", type=int, default=512)
    r.add_argument("--spp", type=int, default=64)
    r.add_argument("--bounces", type=int, default=16)
    r.add_argument("--seed", type=int, default=0)
    r.add_argument("--integrator", default="pallas", choices=INTEGRATORS)
    r.add_argument("--output", "-o", default="render.png")
    r.add_argument("--checkpoint", default=None)
    r.add_argument("--checkpoint-every", type=int, default=0)
    r.add_argument("--scan", default="auto", choices=["auto", "parity", "fast", "tp"],
                   help="triangle-scan arithmetic: reference-exact 'parity', "
                        "division-free 'fast' or triple-product 'tp' (auto = the "
                        "fastest the scene's materials allow)")
    r.add_argument("--interleave", type=int, default=0,
                   help="path streams per pixel for wavefront (0 = the default, 1); "
                        "the megakernel has no such knob here")
    r.add_argument("--scan-chunks", type=int, default=0,
                   help="the JAX package's scheduling knob; only 0 is accepted here")
    r.add_argument("--reference-quirk", action="store_true",
                   help="reproduce the reference's double-gamma PPM export")
    r.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler chrome trace to DIR/trace.json (with "
                        "the program's spans) and to DIR/summary.txt its per-op table, "
                        "then the spans' calls, total and self ms by self time and the "
                        "launch and build counters")
    r.add_argument("--device", default="cuda",
                   help="torch device to render on (cuda launches the kernels, "
                        "cpu runs their plain versions)")

    b = sub.add_parser("bench", help="run the headline benchmark (one JSON line)")
    b.add_argument("--device", default="cuda",
                   help="torch device to run on (cuda launches the kernels, cpu times "
                        "their plain versions)")

    args = p.parse_args(argv)
    return {"info": _cmd_info, "render": _cmd_render, "bench": _cmd_bench}[
        args.command](args)


if __name__ == "__main__":
    sys.exit(main())
