"""Random ball cover (``raft_tpu.neighbors.ball_cover`` counterpart;
reference ``neighbors/ball_cover-inl.cuh:112,259,314``): the 2-3D
geospatial index for Haversine and Euclidean metrics.

The layout and the search are the JAX package's: about ``sqrt(n)``
landmarks drawn with ``np.random.default_rng(seed)`` (the same draw, so
both packages pick the same landmarks), members grouped per landmark in a
padded ``[L, max_group]`` table (``-1`` pads) with each group's radius.
``knn_query(n_probes=0)`` is the dense tiled scan with a running top-k;
``n_probes=p`` scans waves of each query's ``p`` landmark-nearest groups and
stops once the triangle-inequality bound of every unscanned group exceeds
every query's current k-th distance (the reference's post-filter), so it is
exact too. The pruned path bounds its gathered candidates by running the
queries in blocks, each block with its own stopping test; the answer is
the exact one either way.

Tensors stay on the device they are given on; numpy inputs go to
``res``/``device`` (default ``cuda``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.core import serialize as ser
from raft_tpu_torch.core.errors import expects
from raft_tpu_torch.core.resources import Resources, ensure_resources
from raft_tpu_torch.ops.distance import (DistanceType, haversine_core, pairwise_distance,
                                         resolve_metric)
from raft_tpu_torch.ops.select_k import running_merge, select_k, worst_value

_SUPPORTED = (
    DistanceType.Haversine,
    DistanceType.L2Expanded,
    DistanceType.L2SqrtExpanded,
    DistanceType.L2SqrtUnexpanded,
)

#: rows of the dataset a build assigns to landmarks at once
_ASSIGN_BLOCK = 65536
#: gathered candidate slots (queries x probes x group width) of one wave
_WAVE_SLOTS = 1 << 25


@dataclasses.dataclass
class BallCoverIndex:
    """``BallCoverIndex`` analog (``neighbors/ball_cover_types.hpp``)."""

    dataset: torch.Tensor  # [n, d] f32 (d in {2, 3})
    landmarks: torch.Tensor  # [n_landmarks, d]
    assignments: torch.Tensor  # [n] i32 landmark of each row
    landmark_dists: torch.Tensor  # [n] distance to its landmark
    radii: torch.Tensor  # [n_landmarks] largest member distance
    group_rows: torch.Tensor  # [n_landmarks, max_group] i32 members, -1 pad
    metric: DistanceType

    @property
    def size(self) -> int:
        return self.dataset.shape[0]

    @property
    def n_landmarks(self) -> int:
        return self.landmarks.shape[0]


def _place(x, res: Optional[Resources], device) -> torch.Tensor:
    if isinstance(x, torch.Tensor) and res is None and device is None:
        return x
    return ser.as_tensor(x, ensure_resources(res, device).device)


def _group_rows(assignments: np.ndarray, k: int) -> np.ndarray:
    """Padded per-landmark member lists: one stable sort on the host."""
    n = assignments.shape[0]
    counts = np.bincount(assignments, minlength=k)
    order = np.argsort(assignments, kind="stable")
    starts = np.concatenate([[0], np.cumsum(counts)])
    within = np.arange(n) - starts[assignments[order]]
    rows = np.full((k, max(1, int(counts.max()))), -1, np.int32)
    rows[assignments[order], within] = order.astype(np.int32)
    return rows


def build(dataset, metric=DistanceType.Haversine, n_landmarks: Optional[int] = None,
          seed: int = 0, res: Optional[Resources] = None, device=None) -> BallCoverIndex:
    """Sample ``n_landmarks`` (default ``sqrt(n)``) landmarks and group the
    points by their nearest one (``rbc_build``, ``ball_cover-inl.cuh:112``)."""
    metric = resolve_metric(metric)
    expects(metric in _SUPPORTED, "ball_cover supports haversine/euclidean, got %s", metric)
    dataset = _place(dataset, res, device).to(torch.float32)
    expects(dataset.ndim == 2 and dataset.shape[1] in (2, 3), "ball cover expects 2-3D points")
    if metric == DistanceType.Haversine:
        expects(dataset.shape[1] == 2, "haversine needs (lat, lon) pairs")
    n = dataset.shape[0]
    k = n_landmarks or max(1, int(math.sqrt(n)))
    pick = np.random.default_rng(seed).permutation(n)[:k]
    landmarks = dataset[torch.as_tensor(pick, device=dataset.device)]
    assignments = torch.empty((n,), dtype=torch.int32, device=dataset.device)
    dists = torch.empty((n,), dtype=torch.float32, device=dataset.device)
    for s in range(0, n, _ASSIGN_BLOCK):
        d_lm = pairwise_distance(dataset[s : s + _ASSIGN_BLOCK], landmarks, metric)
        a = torch.argmin(d_lm, dim=1)
        assignments[s : s + _ASSIGN_BLOCK] = a.to(torch.int32)
        dists[s : s + _ASSIGN_BLOCK] = torch.gather(d_lm, 1, a[:, None])[:, 0]
    radii = torch.full((k,), float("-inf"), dtype=torch.float32, device=dataset.device)
    radii.scatter_reduce_(0, assignments.to(torch.int64), dists, "amax")
    group_rows = _group_rows(assignments.cpu().numpy(), k)
    return BallCoverIndex(dataset=dataset, landmarks=landmarks, assignments=assignments,
                          landmark_dists=dists, radii=radii,
                          group_rows=torch.from_numpy(group_rows).to(dataset.device),
                          metric=metric)


def _gathered_distance(q, pts, metric) -> torch.Tensor:
    """Distances of each query ``q [nq, d]`` to its gathered candidates
    ``pts [nq, c, d]``: ``[nq, c]``."""
    if metric == DistanceType.Haversine:
        return haversine_core(q[:, 0:1], q[:, 1:2], pts[..., 0], pts[..., 1])
    diff = q[:, None, :] - pts
    d2 = torch.sum(diff * diff, dim=-1)
    if metric == DistanceType.L2Expanded:
        return d2
    return torch.sqrt(torch.clamp(d2, min=0.0))


def _triangle_lb(d_lm, radii, metric) -> torch.Tensor:
    """Per (query, group) lower bound on the distance to any member:
    ``max(d(q, lm) - radius, 0)``; squared L2 breaks the triangle
    inequality, so its bound is formed in sqrt space and squared back."""
    if metric == DistanceType.L2Expanded:
        s = torch.sqrt(torch.clamp(d_lm, min=0.0)) - torch.sqrt(torch.clamp(radii, min=0.0))[None, :]
        s = torch.clamp(s, min=0.0)
        return s * s
    return torch.clamp(d_lm - radii[None, :], min=0.0)


def _scan_wave(index: BallCoverIndex, queries, probe_ids, acc_v, acc_i):
    """One wave: gather the probed groups' members, score them, fold the
    best k into the running top-k."""
    nq = queries.shape[0]
    rows = index.group_rows[probe_ids.to(torch.int64)].reshape(nq, -1)
    valid = rows >= 0
    pts = index.dataset[torch.clamp(rows, min=0).to(torch.int64)]
    d = torch.where(valid, _gathered_distance(queries, pts, index.metric),
                    torch.full((), worst_value(torch.float32, True), device=queries.device))
    ids = torch.where(valid, rows, torch.full_like(rows, -1))
    k = acc_v.shape[1]
    if d.shape[1] > k:
        d, ids = select_k(d, k, select_min=True, indices=ids)
    return running_merge(acc_v, acc_i, d, ids, select_min=True)


def _pruned(index: BallCoverIndex, queries, k: int, p: int):
    nq = queries.shape[0]
    L = index.n_landmarks
    d_lm = pairwise_distance(queries, index.landmarks, index.metric)  # [nq, L]
    lb = _triangle_lb(d_lm, index.radii, index.metric)
    order = torch.argsort(d_lm, dim=1, stable=True).to(torch.int32)  # nearest landmarks first
    lb_ord = torch.gather(lb, 1, order.to(torch.int64))
    acc_v = torch.full((nq, k), worst_value(torch.float32, True), dtype=torch.float32,
                       device=queries.device)
    acc_i = torch.full((nq, k), -1, dtype=torch.int32, device=queries.device)
    scanned = 0
    while scanned < L:
        acc_v, acc_i = _scan_wave(index, queries, order[:, scanned : scanned + p], acc_v, acc_i)
        scanned += min(p, L - scanned)
        if scanned >= L:
            break
        # post-filter certificate: can an unscanned group beat any query's k-th?
        if not bool(torch.any(lb_ord[:, scanned:] <= acc_v[:, k - 1 :])):
            break
    return acc_v, acc_i


def knn_query(index: BallCoverIndex, queries, k: int, block: int = 8192,
              n_probes: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN (``rbc_knn_query``, ``ball_cover-inl.cuh:259``):
    ``(distances [nq, k] f32, ids [nq, k] i32)`` best first on the index's
    device. ``n_probes=0``: the dense tiled scan with a running top-k;
    ``n_probes=p``: landmark-pruned waves of ``p`` groups (see the module
    docstring)."""
    queries = ser.as_tensor(queries, index.dataset.device).to(torch.float32)
    expects(queries.ndim == 2 and queries.shape[1] == index.dataset.shape[1], "bad query shape")
    n = index.size
    expects(0 < k <= n, "k out of range")
    nq = queries.shape[0]
    if n_probes > 0:
        p = min(n_probes, index.n_landmarks)
        qb = max(1, _WAVE_SLOTS // (p * index.group_rows.shape[1]))
        outs = [_pruned(index, queries[s : s + qb], k, p) for s in range(0, nq, qb)]
        return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])
    acc_v = torch.full((nq, k), worst_value(torch.float32, True), dtype=torch.float32,
                       device=queries.device)
    acc_i = torch.full((nq, k), -1, dtype=torch.int32, device=queries.device)
    for s in range(0, n, block):
        cnt = min(block, n - s)
        d = pairwise_distance(queries, index.dataset[s : s + cnt], index.metric)
        ids = (s + torch.arange(cnt, dtype=torch.int32, device=queries.device))[None, :].expand(nq, cnt)
        if cnt >= k:
            d, ids = select_k(d, k, select_min=True, indices=ids)
        acc_v, acc_i = running_merge(acc_v, acc_i, d, ids, select_min=True)
    return acc_v, acc_i


def eps_query(index: BallCoverIndex, queries, eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact eps-ball adjacency (``rbc_eps_nn_query``,
    ``ball_cover-inl.cuh:314``): ``(adj [nq, n] bool, vd [nq] i32)``, whole
    groups whose triangle bound exceeds ``eps`` masked out before the
    point test (for ``L2Expanded`` the bound is taken in sqrt space)."""
    queries = ser.as_tensor(queries, index.dataset.device).to(torch.float32)
    d_lm = pairwise_distance(queries, index.landmarks, index.metric)  # [nq, L]
    group_ok = _triangle_lb(d_lm, index.radii, index.metric) <= eps
    d = pairwise_distance(queries, index.dataset, index.metric)  # [nq, n]
    adj = (d < eps) & group_ok[:, index.assignments.to(torch.int64)]
    return adj, torch.sum(adj, dim=1, dtype=torch.int32)


def from_numpy(arrays: dict, metric, device=None) -> BallCoverIndex:
    """An index from numpy arrays (e.g. a JAX index's fields through
    ``np.asarray``): ``dataset``, ``landmarks``, ``assignments``,
    ``landmark_dists``, ``radii`` and ``group_rows``. ``device=None``
    means ``cuda``."""
    dev = ensure_resources(device=device if device is not None else "cuda").device

    def get(name, dtype):
        return ser.from_numpy(np.asarray(arrays[name]), dev).to(dtype)

    return BallCoverIndex(dataset=get("dataset", torch.float32),
                          landmarks=get("landmarks", torch.float32),
                          assignments=get("assignments", torch.int32),
                          landmark_dists=get("landmark_dists", torch.float32),
                          radii=get("radii", torch.float32),
                          group_rows=get("group_rows", torch.int32),
                          metric=resolve_metric(metric))
