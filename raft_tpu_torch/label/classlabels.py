"""Label utilities (``raft_tpu.label.classlabels`` counterpart; reference
``label/classlabels.cuh`` and ``label/merge_labels.cuh``)."""
from __future__ import annotations

from typing import Tuple

import torch

from raft_tpu_torch.core.errors import expects


def get_classes(labels) -> torch.Tensor:
    """Sorted unique labels (``getUniquelabels``)."""
    return torch.unique(torch.as_tensor(labels), sorted=True)


def make_monotonic(labels, zero_based: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Relabel to consecutive integers in the labels' order
    (``make_monotonic``): ``(new_labels int32, classes)`` with
    ``classes[new] = old``."""
    classes, inv = torch.unique(torch.as_tensor(labels), sorted=True, return_inverse=True)
    out = inv.to(torch.int32)
    return (out if zero_based else out + 1), classes


def merge_labels(labels_a, labels_b, mask=None, n_iters: int = 0) -> torch.Tensor:
    """Merge two labellings into their finest common coarsening
    (``merge_labels.cuh``): points sharing a label in either input end in
    one group, which takes its smallest ``labels_a`` value. Min-propagation
    through both label spaces until nothing changes (chains of alternating
    equivalences need up to O(n) passes); ``mask`` limits which points join
    their ``labels_b`` group; ``n_iters > 0`` caps the passes instead."""
    a = torch.as_tensor(labels_a).to(torch.int64)
    b = torch.as_tensor(labels_b).to(device=a.device, dtype=torch.int64)
    expects(a.shape == b.shape and a.ndim == 1, "labels must be matching 1-D")
    n = a.shape[0]
    m = (torch.ones((n,), dtype=torch.bool, device=a.device) if mask is None
         else torch.as_tensor(mask).to(device=a.device, dtype=torch.bool))
    na = int(torch.max(a)) + 1
    nb = int(torch.max(b)) + 1
    big = torch.iinfo(torch.int32).max

    def seg_min(vals, seg, k):
        out = torch.full((k,), big, dtype=torch.int64, device=a.device)
        return out.scatter_reduce_(0, seg, vals, "amin")

    def one_pass(out):
        out = seg_min(out, a, na)[a]  # each a-group's minimum (every point)
        masked = torch.where(m, out, torch.full_like(out, big))
        prop = torch.minimum(out, seg_min(masked, b, nb)[b])  # b-groups, masked points
        return torch.where(m, prop, out)

    out = a
    if n_iters:
        for _ in range(n_iters):
            out = one_pass(out)
        return out.to(torch.int32)
    while True:
        nxt = one_pass(out)
        if torch.equal(nxt, out):
            return nxt.to(torch.int32)
        out = nxt
