"""Typed failure boundary for the hand-written CUDA kernels
(``raft_tpu.ops.pallas._guard`` counterpart).

A kernel fails in the toolchain's own terms: ``nvcc`` is missing or
rejects a source, ``ctypes`` cannot load the library, or a launch or an
occupancy query returns a non-zero ``cudaError_t``. The port turns each
of these into one type, :class:`~raft_tpu_torch.core.errors.KernelFailure`
(chaining the original), and raises it. Nothing catches it to fall back:
the caller sees the failure. ``KernelFailure`` is a ``RaftError``, so an
``except RaftError`` still catches it.
"""
from __future__ import annotations

import contextlib
import ctypes
import subprocess

from raft_tpu_torch.core.errors import KernelFailure, RaftError

#: toolchain-originated exception types the guard translates
TOOLCHAIN_ERRORS = (OSError, subprocess.SubprocessError, ctypes.ArgumentError)


@contextlib.contextmanager
def kernel_guard(name: str):
    """Translate a toolchain failure in the block (a failed compiler
    start, a library that does not load, a ctypes call whose arguments do
    not convert) into :class:`KernelFailure` (``__cause__`` keeps the
    original). Library errors and other exceptions pass through."""
    try:
        yield
    except RaftError:
        raise
    except TOOLCHAIN_ERRORS as e:
        raise KernelFailure(f"{name}: {type(e).__name__}: {e}") from e


def check_cuda(err: int, what: str) -> None:
    """Raise :class:`KernelFailure` ``"<what> failed (cudaError <err>)"``
    when a C entry point returned a non-zero ``cudaError_t``."""
    if err != 0:
        raise KernelFailure(f"{what} failed (cudaError {err})")
