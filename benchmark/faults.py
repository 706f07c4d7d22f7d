"""Faults planted in the program, to show that a run's check catches them.

`planted(entry, fault)` patches the port's functions that the entry's timed path
calls, for the duration of a `with` block; each entry's file gives its patches
(`fault_patches(fault)`: (module, name, replacement) triples):

* "unchanged": the step returns its state unchanged (the accumulator, the params);
* "half": half of the batch is left out, the mean taken over the rest (a render's
  second half of pixels is never traced; a loss and its gradient cover the first
  half of the pixels only);
* "altered": an answer altered where it is produced (a render launch traces a
  sample range 2^20 samples off its own; a train step's render starts one sample,
  or one step's frames, late).

No cell runs on more than one chip, so the exchange between chips has no fault here.
"""

from __future__ import annotations

import contextlib

from benchmark import spec

FAULTS = ("unchanged", "half", "altered")
FAR = 1 << 20


@contextlib.contextmanager
def planted(entry: str, fault: str, here: str = spec.HERE):
    if fault not in FAULTS:
        raise ValueError(f"fault must be one of {FAULTS}, got {fault!r}")
    patches = spec.load_module("entries", entry, here).fault_patches(fault)
    saved = [(m, name, getattr(m, name)) for m, name, _ in patches]
    try:
        for m, name, new in patches:
            setattr(m, name, new)
        yield
    finally:
        for m, name, old in saved:
            setattr(m, name, old)
