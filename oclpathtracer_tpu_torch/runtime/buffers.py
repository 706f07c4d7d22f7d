"""Buffer capabilities — the Adl Buffer<T>/BufferUtils surface on torch tensors.

Counterpart of `oclpathtracer_tpu.runtime.buffers`. The reference's typed device
buffer (Buffer<T>, Adl.h:200-265 / Adl.inl:130-491) exposes: allocate, write/read
(H2D/D2H/D2D), clear/fill, map/unmap (getHostPtr), grow (setSize), and cross-backend
migration (BufferUtils::map, Adl.inl:304-469). A torch tensor with an explicit device
subsumes all of it; allocate, write, read, clear, fill and grow are kept as API, each
the one-line torch equivalent, so that the capability row is testable (`.to(device)`
migrates, `.numpy()` maps). The helpers are functional, as the JAX package's are:
each returns a new tensor and leaves its argument as it was.
"""

from __future__ import annotations

import numpy as np
import torch

from oclpathtracer_tpu_torch.convert import resolve_device


def allocate(shape, dtype=torch.float32, device="cuda") -> torch.Tensor:
    """≡ Buffer<T>::allocate (Adl.inl:142-165): zero-initialized memory on `device`
    (the card by default; "cpu" for the host).

    (The reference's alloc leaves memory uninitialized; zeros is the closest
    defined equivalent.)"""
    return torch.zeros(shape, dtype=dtype, device=resolve_device(device))


def write(buf: torch.Tensor, host: np.ndarray) -> torch.Tensor:
    """≡ Buffer<T>::write H2D (Adl.inl:204-218) — functional: returns the new buffer,
    `host` in the buffer's dtype, shape and device."""
    return torch.as_tensor(np.asarray(host)).to(device=buf.device,
                                                 dtype=buf.dtype).reshape(buf.shape)


def read(buf: torch.Tensor) -> np.ndarray:
    """≡ Buffer<T>::read D2H + waitForCompletion (Adl.inl:220-233)."""
    return buf.detach().cpu().numpy()


def clear(buf: torch.Tensor) -> torch.Tensor:
    """≡ Buffer<T>::clear (the reference compiles a tiny _memclear kernel on the fly,
    AdlCL.inl:341-384)."""
    return torch.zeros_like(buf)


def fill(buf: torch.Tensor, value) -> torch.Tensor:
    """≡ Buffer<T>::fill via embedded _memfill kernels (AdlCL.inl:386-431)."""
    return torch.full_like(buf, value)


def grow(buf: torch.Tensor, new_len: int) -> torch.Tensor:
    """≡ Buffer<T>::setSize grow-realloc preserving contents (Adl.inl:261-287):
    the first `new_len` rows, zero rows appended where it grows."""
    if new_len <= buf.shape[0]:
        return buf[:new_len]
    pad = buf.new_zeros((new_len - buf.shape[0], *buf.shape[1:]))
    return torch.cat([buf, pad])
