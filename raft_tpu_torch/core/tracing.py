"""Profiler ranges (``raft_tpu.core.tracing`` counterpart): the reference's
NVTX RAII ranges (``core/nvtx.hpp:26-93``) that mark every nontrivial entry
point.

A range is a ``torch.profiler.record_function`` (it shows on the host
timeline of a ``torch.profiler`` trace) and, where CUDA is available, an
NVTX range as well (``torch.cuda.nvtx.range_push``/``range_pop``).
``RAFT_TPU_TRACING=0`` turns tracing off, as in the JAX package; off, a
range costs one flag check.
"""
from __future__ import annotations

import contextlib
import functools
import os

import torch

_enabled = os.environ.get("RAFT_TPU_TRACING", "1") != "0"


def enable(flag: bool = True) -> None:
    global _enabled
    _enabled = flag


def is_enabled() -> bool:
    return _enabled


@contextlib.contextmanager
def _range(name: str):
    nvtx = torch.cuda.is_available()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


@contextlib.contextmanager
def push_range(name: str):
    """Host timeline range (``nvtx::push_range``/``pop_range``)."""
    if not _enabled:
        yield
        return
    with _range(name):
        yield


# The RAII alias used throughout the reference: raft::common::nvtx::range.
range = push_range


def annotate(name: str | None = None):
    """Decorator tracing a function (the reference's per-function NVTX
    ranges, e.g. ``cluster/detail/kmeans.cuh:371``)."""

    def deco(fn):
        label = name or f"raft_tpu_torch::{fn.__qualname__}"

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not _enabled:
                return fn(*args, **kwargs)
            with _range(label):
                return fn(*args, **kwargs)

        return wrapper

    return deco


def named_scope(name: str):
    """A named range around a region (JAX's in-graph scope; eager PyTorch
    has no graph, so it is a :func:`push_range`)."""
    if not _enabled:
        return contextlib.nullcontext()
    return _range(name)
