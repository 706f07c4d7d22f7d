"""The numbers that decide `correct`, each a gap between the program and the reference.

* image_rel_l2: ||program − reference|| / ||reference|| over the compared pixels
  and channels, the worst over the compared images.
* segments_gap: |program's segment count − reference's| / reference's, over the
  compared pixels.
* loss_gap: the worst over the compared training steps of |loss − reference's| /
  |reference's|.
* grad_gap, change_gap: by the worst parameter leaf, the gap between the norms of
  the program's and the reference's first gradient (as the optimizer got it:
  (p0 − p1) / lr) or change of the parameters after the compared steps (p_n − p0),
  over the larger of that leaf's reference norm and the median leaf's. Leaves whose
  reference gradient is under a thousandth of the median leaf's are left out (they
  move by rounding alone).
"""

from __future__ import annotations

import statistics

import torch


def rel_l2(program: torch.Tensor, reference: torch.Tensor) -> float:
    p, r = program.double().cpu(), reference.double().cpu()
    return float((p - r).norm() / r.norm())


def count_gap(program: int, reference: int) -> float:
    return abs(program - reference) / max(reference, 1)


def loss_gap(program: list, reference: list) -> float:
    return max(abs(p - r) / abs(r) for p, r in zip(program, reference))


def _norms(leaves):
    return [float(x.double().norm()) for x in leaves]


def counted_leaves(ref_grad: list) -> list:
    """Indices of the leaves whose reference gradient is not nought to rounding."""
    n = _norms(ref_grad)
    med = statistics.median(n)
    return [i for i, v in enumerate(n) if v >= 1e-3 * med]


def leaf_gap(program: list, reference: list, keep: list) -> float:
    """The worst leaf's |‖program‖ − ‖reference‖| / max(‖reference‖, median ‖reference‖)."""
    p, r = _norms(program), _norms(reference)
    med = statistics.median(r[i] for i in keep)
    return max(abs(p[i] - r[i]) / max(r[i], med) for i in keep)
