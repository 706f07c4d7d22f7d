"""Launch replay — snapshot a render/train invocation and re-execute it later.

Counterpart of `oclpathtracer_tpu.runtime.replay` (≡ the reference's
Launcher::serializeToFile / deserializeFromFile, AdlKernel.h:186-188;
AdlKernelUtilsCL.cpp:509-620, which dumps every kernel argument so a launch can be
re-bound and re-run for debugging). Here the "launch" is a function call and the
"args" are a pytree of tuples, lists, dicts and NamedTuples (`torch.utils._pytree`):
the leaves are saved as npz (tensors through `.cpu().numpy()`) and the structure and
metadata as JSON; a replay rebuilds the tree from an example of the arguments, each
tensor on that example leaf's device and in its dtype, and calls the function again.
"""

from __future__ import annotations

import json
from typing import Any, Callable

import numpy as np
import torch
from torch.utils import _pytree


def _key(i: int) -> str:
    return f"leaf_{i:04d}"


def save_launch(path: str, args: Any, meta: dict | None = None) -> None:
    """Snapshot an argument pytree (device contents included) to `path`.npz/.json.
    None leaves are kept as None and saved as nothing."""
    leaves, spec = _pytree.tree_flatten(args)
    arrays = {}
    leaf_specs = []
    for i, leaf in enumerate(leaves):
        if leaf is None:
            leaf_specs.append(None)
            continue
        a = leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf)
        arrays[_key(i)] = a
        leaf_specs.append({"dtype": str(a.dtype), "shape": list(a.shape)})
    np.savez_compressed(path + ".npz", **arrays)
    with open(path + ".json", "w") as f:
        json.dump({"treedef": str(spec), "leaves": leaf_specs, "meta": meta or {}}, f,
                  indent=2)


def load_launch(path: str, example_args: Any) -> Any:
    """Rebuild the argument pytree (structure, devices and dtypes taken from
    `example_args`): a tensor leaf comes back on its example's device in its dtype,
    any other leaf as a Python scalar (0-d) or numpy array."""
    data = np.load(path + ".npz")
    leaves, spec = _pytree.tree_flatten(example_args)
    loaded = []
    for i, ex in enumerate(leaves):
        if ex is None:
            loaded.append(None)
            continue
        a = data[_key(i)]
        if isinstance(ex, torch.Tensor):
            loaded.append(torch.from_numpy(a).to(device=ex.device, dtype=ex.dtype))
        else:
            loaded.append(a.item() if a.ndim == 0 else a)
    return _pytree.tree_unflatten(loaded, spec)


def replay(fn: Callable, path: str, example_args: Any):
    """Re-execute `fn` on a snapshot (≡ deserializeFromFile + launch)."""
    args = load_launch(path, example_args)
    return fn(*args) if isinstance(args, tuple) else fn(args)
