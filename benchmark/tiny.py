"""A cell shrunk to a size the CPU runs in seconds, for the harness's tests and for
rehearsing a run without a card (the port's kernels then run their plain versions).
The sizes change; the entry, the metrics, the check and the limits do not."""

from __future__ import annotations

from benchmark import spec


def tiny_cell(name: str, bench_path: str | None = None) -> spec.Cell:
    cell = spec.load_cell(name, bench_path)
    c, t = cell.config, cell.traffic
    c.update(width=16, height=16)
    if isinstance(c["scene"], dict):  # still past the linear kernels' size: the same backend
        c["scene"] = {**c["scene"], "n_spheres": 8, "subdivisions": 2}
    if c["bounces"] > 4:
        c["bounces"] = 10  # still past the driver's megakernel cap: the same backend
    if "spp" in c:
        c.update(spp=2, target_spp=2)
    if "job_spp" in t:
        t.update(job_spp=8, samples_per_step=4)
    if "frames_per_image" in t:
        t["frames_per_image"] = 3
    if "block_pixels" in t:
        t.update(block_pixels=16, check_blocks=2)
    return cell
