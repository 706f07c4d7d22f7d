"""Render checkpoint/resume (counterpart of `oclpathtracer_tpu.render.checkpoint`).

The checkpoint is the exact progressive state (sum, count, next_sample) in the same
`.npz` format as the JAX package's, so a checkpoint written by one package resumes
in the other. Written to a temporary file and renamed, so a reader never sees half
of one.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from oclpathtracer_tpu_torch.render.accumulate import Accumulator

_FORMAT_VERSION = 1


def save(path: str, acc: Accumulator, next_sample: int) -> None:
    tmp = path + ".tmp"
    np.savez(
        tmp,
        version=_FORMAT_VERSION,
        sum=acc.sum.detach().cpu().numpy(),
        count=acc.count.detach().cpu().numpy(),
        next_sample=next_sample,
    )
    os.replace(tmp + ".npz" if not tmp.endswith(".npz") else tmp, path)


def load(path: str, device=None) -> Optional[Tuple[Accumulator, int]]:
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        if int(z["version"]) != _FORMAT_VERSION:
            raise ValueError(f"unsupported checkpoint version {z['version']} in {path}")
        acc = Accumulator(sum=torch.from_numpy(np.array(z["sum"], np.float32)).to(device),
                          count=torch.from_numpy(np.array(z["count"], np.int32)).to(device))
        return acc, int(z["next_sample"])
