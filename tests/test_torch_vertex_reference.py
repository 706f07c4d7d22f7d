"""The port's vertex step (diff/vertex.py) against the benchmark's plain reference of
it (benchmark/reference/vertex.py, Li et al. 2018's boundary terms written from the
estimators' definitions, nothing of the port) on the CPU, the kernels as their plain
versions: at 24² and 3 bounces, 2 spp a render, the twin's interior at 1 frame, 8
points an edge, the rim from every second pixel, on three light shifts drawn as the
benchmark's cell draws its start. Compared: the loss; each term of the gradient
apart (the interior, through the step with its boundary terms set to nought; the
silhouettes and the rim, through the port's public `boundary_vertex_grads` and
`secondary_boundary_vertex_grads` with the step's kernel probes); the whole step's.

Tolerances. Both sides trace the same paths on the same LCG streams in float32 and
differ in rounding alone: the reference bakes its camera basis in float64, takes the
projection's Jacobian in closed form where the port takes autograd's, builds its
normals with its own operations and adds its radiance in another order. Measured
here: the loss equal bit for bit, the boundary terms and the whole step within
2.9e-7 (rel-L2), the interior, about 6e4 times smaller than the silhouettes' term,
within 5.7e-6. A path that takes another branch for an ulp (a hit on a shared edge)
moves a probe's radiance by a whole light's worth, so the limits keep a wide margin
above rounding yet stay far below what a fault moves: the loss to 1e-5, every term
and the whole step to 1e-4. Flipping the probes' offset across an edge (`delta` →
−delta) moves the silhouettes' term by a rel-L2 of 2.
"""

import functools
import os
import subprocess
import sys

import pytest
import torch

from benchmark import common, control, tiny
from benchmark.reference import pathtrace as pt
from benchmark.reference import scene as rs
from benchmark.reference import vertex as rv
from oclpathtracer_tpu_torch.config import RenderConfig
from oclpathtracer_tpu_torch.core import rng
from oclpathtracer_tpu_torch.diff import edge, inverse, secondary, vertex
from oclpathtracer_tpu_torch.kernels import megakernel as mk
from oclpathtracer_tpu_torch.scene import load_cornell_box

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE = os.path.join(ROOT, "benchmark", "data", "cornellbox.bin")
CPU = torch.device("cpu")
SIZE, BOUNCES, STEP = 24, 3, 1
Q = rv.Quadrature(spp=2, interior_spp=1, samples_per_edge=8, edge_spp=2, delta=0.05,
                  secondary_samples_per_edge=8, secondary_spp=2, secondary_delta=0.01,
                  secondary_depth=1, secondary_pixel_stride=2)
SHIFT_SEEDS = (11, 12, 13)
TERMS = ("loss", "interior", "edges", "rim", "total")
LIMITS = {"loss": 1e-5, "interior": 1e-4, "edges": 1e-4, "rim": 1e-4, "total": 1e-4}


def rel_l2(program, reference) -> float:
    p = torch.cat([x.double().flatten() for x in program])
    r = torch.cat([x.double().flatten() for x in reference])
    return float((p - r).norm() / r.norm())


class Case:
    """One light shift's step on both sides."""

    def __init__(self, seed: int):
        self.sd = rs.read_scene(SCENE)
        self.scene = load_cornell_box(SCENE, device="cpu")
        self.cfg = RenderConfig(width=SIZE, height=SIZE, bounces=BOUNCES)
        self.render = pt.Render(SIZE, SIZE, BOUNCES)
        albedo, emissive = (torch.as_tensor(x) for x in (self.sd.albedo, self.sd.emissive))
        self.target = pt.mean_image(pt.geometry(self.sd, CPU), self.render, 1_000_000, 4,
                                    albedo, emissive)
        shift = common.draw(torch.Generator().manual_seed(seed), 0.2, 0.4, (), CPU)
        self.corners = [torch.as_tensor(x).clone() for x in (self.sd.p1, self.sd.p2, self.sd.p3)]
        for x in self.corners:
            x[list(rv.light_triangles(self.sd)), 0] += shift
        self.params = inverse.SceneParams(vertices=tuple(x.clone() for x in self.corners))
        self.key = rng.make_key(seed, CPU)
        self.ref_loss, self.ref = rv.step(self.sd, self.render, Q, self.corners, self.target,
                                          STEP)

    @functools.cached_property
    def step(self):
        return self.loss_and_grads()

    def loss_and_grads(self):
        kw = Q._asdict()
        spp = kw.pop("spp")
        lg = vertex.make_vertex_loss_and_grads(self.scene, self.cfg, spp, **kw)
        loss, g = lg(self.params, self.target, STEP, self.key)
        return loss, g.vertices

    def weight_and_probes(self):
        sc = inverse.apply_params(self.scene, self.params)
        table = mk.pack_scene(sc)
        a, b = (mk.render_samples_pallas_stats(table, self.cfg, f * Q.spp, Q.spp,
                                               scan="parity")[0] / Q.spp
                for f in (2 * STEP, 2 * STEP + 1))
        weight = (a + b - 2.0 * self.target) / (self.cfg.n_pixels * 3)
        probes = vertex.make_kernel_probe_fns(table, self.cfg, Q.edge_spp, Q.secondary_spp,
                                              STEP)
        return sc, weight, probes, rng.fold_in(self.key, STEP)

    def edges(self, delta=Q.delta):
        sc, weight, (edge_probe, _), skey = self.weight_and_probes()
        return edge.boundary_vertex_grads(sc, self.cfg, weight, skey,
                                          samples_per_edge=Q.samples_per_edge,
                                          spp=Q.edge_spp, delta=delta, probe_fn=edge_probe)

    def rim(self):
        sc, weight, (_, rim_probe), skey = self.weight_and_probes()
        return secondary.secondary_boundary_vertex_grads(
            sc, self.cfg, weight, skey, tri_idx=secondary.emissive_tris(self.scene),
            samples_per_edge=Q.secondary_samples_per_edge, spp=Q.secondary_spp,
            delta=Q.secondary_delta, max_prefix_depth=Q.secondary_depth,
            pixel_stride=Q.secondary_pixel_stride, probe_fn=rim_probe)

    def interior(self):
        def nought(sc, *a, **kw):
            return tuple(torch.zeros_like(x) for x in (sc.geometry.p1,) * 3)

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(vertex, "boundary_vertex_grads", nought)
            mp.setattr(vertex, "secondary_boundary_vertex_grads", nought)
            return self.loss_and_grads()[1]

    def gap(self, term: str) -> float:
        if term == "loss":
            loss = float(self.step[0])
            return abs(loss - float(self.ref_loss)) / abs(float(self.ref_loss))
        if term == "total":
            return rel_l2(self.step[1], self.ref.total())
        return rel_l2(getattr(self, term)(), getattr(self.ref, term))


_CASES: dict = {}


def case(seed: int) -> Case:
    if seed not in _CASES:
        _CASES[seed] = Case(seed)
    return _CASES[seed]


@pytest.mark.parametrize("term", TERMS)
@pytest.mark.parametrize("seed", SHIFT_SEEDS)
def test_the_step_matches_the_plain_reference(seed, term):
    gap = case(seed).gap(term)
    assert gap <= LIMITS[term], (term, gap)


def test_every_term_does_work():
    """None of the compared terms is nought, so each comparison can fail."""
    c = case(SHIFT_SEEDS[0])
    norms = {t: float(torch.cat([x.flatten() for x in getattr(c.ref, t)]).norm())
             for t in ("interior", "edges", "rim")}
    assert all(v > 0 for v in norms.values()), norms


@pytest.mark.parametrize("seed", SHIFT_SEEDS)
def test_a_flipped_probe_offset_fails_the_comparison(seed):
    c = case(seed)
    assert rel_l2(c.edges(-Q.delta), c.ref.edges) > 100 * LIMITS["edges"]


@pytest.mark.parametrize("scale", (1.0, 0.5, 0.0))
def test_the_cells_check_sees_the_interior_scaled_where_the_step_makes_it(scale):
    """The benchmark cell's check at its small size (`benchmark.tiny`), with the twin's
    interior term scaled where the step computes it (`grads_or_zeros` in
    diff/vertex.py): the interior is some 1e-4 of the silhouettes' term, so the leaf
    norms and the whole gradient's rel-L2 hardly see it; the interior's own number
    fails its limit. Unscaled, every number is within its limit."""
    cell = tiny.tiny_cell("inverse-vertex-kernel")
    plain = vertex.grads_or_zeros

    def scaled(loss, leaves):
        return [scale * g for g in plain(loss, leaves)]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(vertex, "grads_or_zeros", scaled)
        r = control.readings(cell, 2**31 + 977, 0.0, CPU, "program", units=1)
    over = {k for k in cell.limits if not r[k] <= cell.limits[k]}
    if scale == 1.0:
        assert not over, r
    else:
        assert "interior_rel_l2" in over, r
        assert r["interior_rel_l2"] == pytest.approx(1.0 - scale, abs=1e-3)


def test_the_reference_loads_nothing_of_the_port_or_of_jax():
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_"))}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys\n"
         "import benchmark.reference.vertex\n"
         "print(sorted({m.split('.')[0] for m in sys.modules} & {'oclpathtracer_tpu_torch',\n"
         "      'oclpathtracer_tpu', 'jax', 'jaxlib', 'flax'}))\n"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == "[]"
