"""Array ingestion and validation (``raft_tpu.core.array`` counterpart).

Any ``torch.Tensor``, numpy array, DLPack-capable object or nested
sequence becomes a tensor, with the pylibraft wrappers' dtype and shape
checks (``neighbors/ivf_pq/ivf_pq.pyx:359-375``). A tensor stays on its
device unless ``device`` is given; anything else goes to ``device``
(default ``cuda``).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from raft_tpu_torch.core import serialize as ser
from raft_tpu_torch.core.errors import expects
from raft_tpu_torch.core.resources import resolve_device


def _torch_dtype(d) -> torch.dtype:
    if isinstance(d, torch.dtype):
        return d
    return torch.from_numpy(np.zeros(0, np.dtype(d))).dtype


def as_array(x, dtype=None, ndim: Optional[int] = None, name: str = "array",
             device=None) -> torch.Tensor:
    """``x`` as a tensor (see the module docstring), cast to ``dtype``
    (a torch or numpy dtype) and checked to be ``ndim``-dimensional."""
    if isinstance(x, torch.Tensor):
        arr = x if device is None else x.to(resolve_device(device))
    elif hasattr(x, "__dlpack__") and not isinstance(x, np.ndarray):
        try:
            arr = torch.from_dlpack(x).to(resolve_device(device))
        except Exception:
            arr = ser.from_numpy(np.asarray(x), resolve_device(device))
    else:
        arr = ser.from_numpy(np.asarray(x), resolve_device(device))
    if dtype is not None:
        arr = arr.to(_torch_dtype(dtype))
    if ndim is not None:
        expects(arr.ndim == ndim, "%s must be %d-dimensional, got %d", name, ndim, arr.ndim)
    return arr


def check_matching_dims(a, b, axis_a: int, axis_b: int, what: str) -> None:
    expects(
        a.shape[axis_a] == b.shape[axis_b],
        "%s: dimension mismatch (%d vs %d)",
        what,
        a.shape[axis_a],
        b.shape[axis_b],
    )


def check_dtype_one_of(arr, dtypes: Sequence, name: str = "array") -> None:
    allowed = [_torch_dtype(d) for d in dtypes]
    expects(
        arr.dtype in allowed,
        "%s: unsupported dtype %s (expected one of %s)",
        name,
        arr.dtype,
        [str(d).replace("torch.", "") for d in allowed],
    )
