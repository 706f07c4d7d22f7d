"""Inverse rendering of geometry through edge sampling: each unit is one step of the
public `diff.make_vertex_train_step` on every corner of every triangle, plain SGD at
the configuration's learning rate, with the configuration's quadrature (the sizes
`reference.vertex.Quadrature` names): two parity megakernel forwards, the twin's
interior term, the silhouettes' and the light rim's boundary terms with their probes
on the arbitrary-ray kernel. The step index advances from 0 and the threefry key comes
from the seed; the loss is read to the host every `read_loss_every` steps.

The target is the reference's render of the file's scene over `target_spp` LCG
frames from `TARGET_FIRST`; the start is the file's corners with the light's
triangles moved in x by U(`LIGHT_SHIFT`) world units drawn from the seed. Set-up takes
the first `first_steps` steps through the same call; those are checked against
`reference/vertex.py` following them from the same start: each step's loss, the
first step's gradient as the optimizer got it (its parameters' `.grad`), each term of
that gradient apart (the interior, the silhouettes' and the rim's, as the step's own
calls return them), and the corners' change after the last. The program's segments
are those that its stats calls return in set-up's steps, and its probe rows those
that its counter `vertex.probe_rows` adds there (recorded through wrappers and read
from the counter there, nothing read in the window), their mean a step for every step
of the window.

`train_twin.TrainEntry` does not fit: its constructor draws material targets and
starts, and its check reads two material leaves from the parameters.
"""

from __future__ import annotations

import contextlib
import functools

import torch

from benchmark import common, compare
from benchmark.entries.train_twin import TARGET_FIRST
from benchmark.reference import pathtrace as pt
from benchmark.reference import scene as rs
from benchmark.reference import vertex as rv

LIGHT_SHIFT = (0.2, 0.4)
# The gradient's terms (`reference.vertex.Terms`) and their numbers, each compared
# apart: leaf norms and the whole gradient's rel-L2 hardly see the interior, some 1e-4
# of the silhouettes'.
TERMS = {"interior": "interior_rel_l2", "edges": "edge_rel_l2", "rim": "rim_rel_l2"}


def _flat(leaves) -> torch.Tensor:
    return torch.cat([x.double().cpu().flatten() for x in leaves])


def _term_gap(program, reference) -> float:
    """rel-L2 of one term over its 324 coordinates; a term the program's step did not
    return reads 1, and a term nought in the reference reads the program's norm."""
    if program is None:
        return 1.0
    p, r = _flat(program), _flat(reference)
    return float((p - r).norm() / r.norm()) if r.norm() > 0 else float(p.norm())


def _probe_rows():
    """The program's counter of probe rows, None where it keeps none."""
    try:
        from oclpathtracer_tpu_torch.runtime import profiling
    except ImportError:
        return None
    counts = getattr(profiling, "counts", None)
    return None if counts is None else counts().get("vertex.probe_rows")


class Entry:
    wait_each = False

    def __init__(self, cell, seed: int, device: torch.device):
        c, t = cell.config, cell.traffic
        self.cell, self.seed, self.device = cell, seed, device
        self.lr, self.quad = c["lr"], rv.Quadrature.of(c)
        self.read_every, self.first_steps = t["read_loss_every"], t["first_steps"]
        self.sd = rs.scene_data(cell)
        self.render = common.reference_render(cell)
        gen = torch.Generator(device=device).manual_seed(seed)
        shift = common.draw(gen, *LIGHT_SHIFT, (), device)
        self.p0 = [torch.as_tensor(x, device=device).clone()
                   for x in (self.sd.p1, self.sd.p2, self.sd.p3)]
        lights = list(rv.light_triangles(self.sd))
        for x in self.p0:
            x[lights, 0] += shift
        g = pt.geometry(self.sd, device)
        self.target = pt.mean_image(g, self.render, TARGET_FIRST, c["target_spp"],
                                    torch.as_tensor(self.sd.albedo, device=device),
                                    torch.as_tensor(self.sd.emissive, device=device))
        del g
        common.fresh_peak(device)

        self.scene, self.cfg = common.program_scene(cell, device)
        rows = _probe_rows()
        with _recording() as rec:
            self.step, params = self.build()
            losses = []
            for k in range(self.first_steps):
                params, loss = self.step(params, self.target, k)
                if k == 0:
                    g0 = [x.grad.detach().clone() for group in self.opt.param_groups
                          for x in group["params"]]
                losses.append(loss)
        self.params = params
        self.first = (losses, g0, params.vertices, rec.terms)
        self.segments_per_step = int(sum(int(s) for s in rec.segments)) / self.first_steps
        after = _probe_rows()
        self.probe_rows_per_step = (None if after is None else
                                    (after - (rows or 0)) / self.first_steps)
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def build(self):
        from oclpathtracer_tpu_torch import diff
        from oclpathtracer_tpu_torch.core import rng

        key = rng.make_key(self.seed, self.device)
        kw = self.quad._asdict()
        spp = kw.pop("spp")
        step, init = diff.make_vertex_train_step(
            self.scene, self.cfg, spp, functools.partial(torch.optim.SGD, lr=self.lr), **kw)
        start = diff.SceneParams(vertices=tuple(x.clone() for x in self.p0))
        self.opt = init(start)

        def vertex_step(params, target, k):
            params, self.opt, loss = step(params, self.opt, target, k, key)
            return params, loss

        return vertex_step, start

    def unit(self, i: int) -> None:
        self.params, loss = self.step(self.params, self.target, i)
        if (i + 1) % self.read_every == 0:
            float(loss)

    def counts(self, units: int) -> dict:
        out = {"segments": int(round(self.segments_per_step * units))}
        if self.probe_rows_per_step is not None:
            out["probe_rows"] = int(round(self.probe_rows_per_step * units))
        return out

    def outputs(self, units: int) -> dict:
        losses, g0, pn, terms = self.first
        out = {"losses": [float(x) for x in losses],
               "g0": [x.double().cpu() for x in g0],
               "pn": [x.detach().double().cpu() for x in pn],
               "terms": {k: [x.double().cpu() for x in v] for k, v in terms.items()}}
        self.params = self.first = self.step = self.scene = self.opt = None
        common.free(self.device)
        return out

    def reference(self, dtype=torch.float32) -> dict:
        """The reference's first steps from p0, the corners kept in float32 as the
        program's are: losses, first gradient and its terms, corners after the last
        step."""
        p = [x.clone() for x in self.p0]
        losses = []
        for k in range(self.first_steps):
            loss, terms = rv.step(self.sd, self.render, self.quad, p, self.target, k, dtype)
            grads = terms.total()
            losses.append(float(loss))
            if k == 0:
                g0 = [x.double().cpu() for x in grads]
                t0 = {n: [x.double().cpu() for x in getattr(terms, n)] for n in TERMS}
            p = [x - self.lr * d.float() for x, d in zip(p, grads)]
            del terms, grads
            common.free(self.device)
        return {"losses": losses, "g0": g0, "terms": t0,
                "pn": [x.double().cpu() for x in p]}

    def numbers(self, outputs: dict) -> dict:
        ref = self.reference()
        p0 = [x.double().cpu() for x in self.p0]
        keep = compare.counted_leaves(ref["g0"])

        def change(pn):
            return [b - a for a, b in zip(p0, pn)]

        out = {"loss_gap": compare.loss_gap(outputs["losses"], ref["losses"]),
               "grad_gap": compare.leaf_gap(outputs["g0"], ref["g0"], keep),
               "change_gap": compare.leaf_gap(change(outputs["pn"]), change(ref["pn"]), keep),
               "grad_rel_l2": compare.rel_l2(_flat(outputs["g0"]), _flat(ref["g0"]))}
        for term, number in TERMS.items():
            out[number] = _term_gap(outputs["terms"].get(term), ref["terms"][term])
        return out

    def control_outputs(self, outputs: dict) -> dict:
        """The reference in bfloat16 in the program's place."""
        return self.reference(torch.bfloat16)


class _Record:
    def __init__(self):
        self.segments = []  # every stats call's segments, as it returns them
        self.terms = {}     # the first step's terms: {name: [dp1, dp2, dp3]}


@contextlib.contextmanager
def _recording():
    """Within the block, what the vertex step's calls return: the segments of its stats
    calls (its megakernel renders and its probes), and from the first call of each, the
    interior term (`grads_or_zeros`), the silhouettes' (`boundary_vertex_grads`) and
    the rim's (`secondary_boundary_vertex_grads`)."""
    from oclpathtracer_tpu_torch.diff import vertex

    rec = _Record()
    notes = {"render_samples_pallas_stats": lambda out: rec.segments.append(out[1]),
             "trace_rays_pallas_stats": lambda out: rec.segments.append(out[1])}

    def first(term, out):
        if term not in rec.terms:
            rec.terms[term] = [x.detach().clone() for x in out]

    for term, fn in (("interior", "grads_or_zeros"), ("edges", "boundary_vertex_grads"),
                     ("rim", "secondary_boundary_vertex_grads")):
        notes[fn] = functools.partial(first, term)
    saved = {n: getattr(vertex, n) for n in notes}

    def recorded(fn, note):
        def call(*args, **kwargs):
            out = fn(*args, **kwargs)
            note(out)
            return out
        return call

    try:
        for name, fn in saved.items():
            setattr(vertex, name, recorded(fn, notes[name]))
        yield rec
    finally:
        for name, fn in saved.items():
            setattr(vertex, name, fn)


def fault_patches(fault: str) -> list:
    """The port's functions a planted fault replaces (`faults.py`)."""
    from oclpathtracer_tpu_torch import diff
    from oclpathtracer_tpu_torch.diff import vertex

    if fault == "unchanged":
        orig = diff.make_vertex_train_step

        def make(*a, **kw):
            step, init = orig(*a, **kw)

            def same(params, opt_state, target, k, key):
                _, opt_state, loss = step(params, opt_state, target, k, key)
                return params, opt_state, loss

            return same, init

        return [(diff, "make_vertex_train_step", make)]
    make_lg = vertex.make_vertex_loss_and_grads
    if fault == "altered":
        def late(*a, **kw):
            lg = make_lg(*a, **kw)
            return lambda params, target, k, key: lg(params, target, k + 1, key)

        return [(vertex, "make_vertex_loss_and_grads", late)]

    # "half": the second half of the pixels is never traced; every render reads the
    # target there, so those pixels add nothing to the loss or to any term of its
    # gradient.
    seen = {}
    render, twin = vertex.render_samples_pallas_stats, vertex.render_sample_ref

    def keep_first_half(img, scale):
        n = img.shape[0] // 2
        return torch.cat([img[:n], seen["target"][n:] * scale])

    def render_half(table, cfg, start, n, *a, **kw):
        img, segs = render(table, cfg, start, n, *a, **kw)
        return keep_first_half(img, n), segs

    def twin_half(*a, **kw):
        return keep_first_half(twin(*a, **kw), 1.0)

    def make_half(*a, **kw):
        lg = make_lg(*a, **kw)

        def half(params, target, k, key):
            seen["target"] = target
            return lg(params, target, k, key)

        return half

    return [(vertex, "make_vertex_loss_and_grads", make_half),
            (vertex, "render_samples_pallas_stats", render_half),
            (vertex, "render_sample_ref", twin_half)]
