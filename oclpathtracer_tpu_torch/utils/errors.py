"""Error/log subsystem — ≡ AdlError.h (TahoeErrorCodes, ADLASSERT, ADL_LOG).

Counterpart of `oclpathtracer_tpu.utils.errors`. The reference defines an error-code
enum (AdlError.h:24-41), a debug-only assert that compiles out in release
(AdlError.h:43-53), debug printf (AdlError.h:61-92), and a pluggable log callback
(s_logCallback, AdlError.h:98-104; default printf Adl.cpp:235-238). Python
equivalents: a typed exception hierarchy + `logging` with a swappable handler.
"""

from __future__ import annotations

import enum
import logging
from typing import Callable, Optional

import torch

logger = logging.getLogger("oclpathtracer_tpu_torch")


class ErrorCode(enum.Enum):
    """≡ TahoeErrorCodes (AdlError.h:24-41) — kept for diagnostics parity."""

    SUCCESS = 0
    ERROR_INTERNAL = 1
    ERROR_OUT_OF_MEMORY = 2
    ERROR_INVALID_VALUE = 3
    ERROR_IO = 4
    ERROR_UNSUPPORTED = 5


class PathTracerError(Exception):
    def __init__(self, code: ErrorCode, message: str = ""):
        self.code = code
        super().__init__(f"[{code.name}] {message}")


def require(condition: bool, code: ErrorCode = ErrorCode.ERROR_INTERNAL,
            message: str = "") -> None:
    """Host-side assert that RAISES in all build modes — deliberately stronger
    than the reference's ADLASSERT, which compiles to a no-op in release
    (AdlError.h:43-53) and so silently ignores broken invariants."""
    if not condition:
        raise PathTracerError(code, message)


def set_log_callback(fn: Optional[Callable[[str], None]]) -> None:
    """≡ setLogCallback (AdlError.h:100-104): route framework logs elsewhere."""
    for h in list(logger.handlers):
        logger.removeHandler(h)
    if fn is not None:
        class _Cb(logging.Handler):
            def emit(self, record):
                fn(self.format(record))

        logger.addHandler(_Cb())
    else:
        logger.addHandler(logging.NullHandler())


def check_finite(x: torch.Tensor, name: str = "value") -> torch.Tensor:
    """Raise PathTracerError (ERROR_INVALID_VALUE) unless every entry of `x` is
    finite; return `x`.

    The JAX package checks on the device with checkify. Here the check reads one
    bool back to the host, so on a CUDA tensor it synchronizes the device: keep it
    out of timed paths."""
    if not bool(torch.isfinite(x).all()):
        raise PathTracerError(ErrorCode.ERROR_INVALID_VALUE, f"non-finite {name}")
    return x
