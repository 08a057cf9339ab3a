"""NN-descent kNN-graph construction (``raft_tpu.neighbors.nn_descent``
counterpart; reference ``neighbors/detail/nn_descent.cuh:342`` GNND).

Each iteration samples a pool of ``max_samples / 2`` "new" (never sampled)
and as many "old" forward neighbours per node by Gumbel top-k, adds up to
``max_samples`` reverse neighbours of the pool (a stable sort by
destination), takes every node's two-hop candidates over that symmetric
sample graph plus the one-hop ones, scores them with one batched f32
product per node chunk and merges them into the running top-k with id
dedup (:func:`raft_tpu_torch.ops.select_k.running_merge_unique`, the
"sampled" flag riding along). The build stops when the share of graph
entries that are new drops below ``termination_threshold``.

The random initial graph and the Gumbel draws come from a
``torch.Generator`` seeded with ``params.seed``; they cannot match
``jax.random``'s, so the two packages build different graphs of the same
quality from one seed.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from raft_tpu_torch import obs
from raft_tpu_torch.cluster.kmeans import make_generator
from raft_tpu_torch.core import serialize as ser
from raft_tpu_torch.core.errors import expects
from raft_tpu_torch.core.resources import Resources, ensure_resources
from raft_tpu_torch.ops.distance import DistanceType, resolve_metric
from raft_tpu_torch.ops.fused_1nn import normalize_rows
from raft_tpu_torch.ops.select_k import running_merge_unique, select_k, worst_value
from raft_tpu_torch.utils.graph import reverse_edges

_SUPPORTED = (
    DistanceType.L2Expanded,
    DistanceType.L2SqrtExpanded,
    DistanceType.InnerProduct,
    DistanceType.CosineExpanded,
)


@dataclasses.dataclass
class NNDescentParams:
    """``nn_descent::index_params`` analog; every field and default of the
    JAX package."""

    graph_degree: int = 64
    intermediate_graph_degree: int = 128
    max_iterations: int = 20
    termination_threshold: float = 0.0001
    max_samples: int = 16  # pool size per direction per iteration
    metric: DistanceType = DistanceType.L2Expanded
    seed: int = 0
    node_chunk: int = 4096  # rows scored per step (memory knob)


@dataclasses.dataclass
class NNDescentOutput:
    """The built kNN graph: best-first neighbour ids and distances per row."""

    graph: torch.Tensor  # [n, graph_degree] i32
    distances: torch.Tensor  # [n, graph_degree] f32
    metric: DistanceType


def _score_and_merge(data, sqnorms, cand, acc_v, acc_i, acc_f, row0: int, *, select_min: bool):
    """Score a chunk of rows against their candidate ids (-1 invalid; self
    edges dropped) and merge them, unsampled, into the running top-k."""
    c = cand.shape[0]
    rows = row0 + torch.arange(c, device=cand.device)
    q = data[rows]
    safe = torch.clamp(cand, min=0).to(torch.int64)
    dots = torch.bmm(data[safe], q[:, :, None])[:, :, 0]
    if select_min:
        dist = torch.clamp(sqnorms[rows][:, None] + sqnorms[safe] - 2.0 * dots, min=0.0)
    else:
        dist = dots
    worst = worst_value(torch.float32, select_min)
    invalid = (cand < 0) | (cand == rows[:, None])
    dist = torch.where(invalid, torch.full_like(dist, worst), dist)
    cand = torch.where(invalid, -1, cand).to(torch.int32)
    return running_merge_unique(acc_v, acc_i, dist, cand, select_min=select_min, acc_flags=acc_f)


def _sample_pool(gen: torch.Generator, ids, sampled, *, half: int):
    """``half`` new (never sampled) + ``half`` old neighbours per node by
    Gumbel top-k over the flag-partitioned lists. Returns ``(pool [n,
    2 * half], flags)`` with the drawn new positions marked sampled."""
    n, k = ids.shape
    u = torch.rand((n, k), generator=gen, device=ids.device)
    g = -torch.log(-torch.log(torch.clamp(u, min=1e-20)))
    valid = ids >= 0
    ninf = torch.full_like(g, float("-inf"))
    new_logit = torch.where(valid & ~sampled, g, ninf)
    old_logit = torch.where(valid & sampled, g, ninf)
    new_v, new_pos = select_k(new_logit, half, select_min=False)
    old_v, old_pos = select_k(old_logit, half, select_min=False)
    new_pos = new_pos.to(torch.int64)
    new_sel = torch.where(new_v == float("-inf"), -1, torch.gather(ids, 1, new_pos))
    old_sel = torch.where(old_v == float("-inf"), -1, torch.gather(ids, 1, old_pos.to(torch.int64)))
    sampled = sampled.scatter(1, new_pos, True)
    return torch.cat([new_sel, old_sel], dim=1).to(torch.int32), sampled


def _two_hop(sym, sym_c) -> torch.Tensor:
    """Candidates of a row chunk: its two-hop neighbours over the sample
    graph ``sym`` followed by its one-hop ones."""
    cand = torch.where(sym_c[:, :, None] >= 0, sym[torch.clamp(sym_c, min=0).to(torch.int64)], -1)
    return torch.cat([cand.reshape(sym_c.shape[0], -1), sym_c], dim=1)


def build(
    dataset,
    params: Optional[NNDescentParams] = None,
    res: Optional[Resources] = None,
    **kwargs,
) -> NNDescentOutput:
    """Build an approximate kNN graph (``nn_descent::build``) on
    ``res``'s device (default ``cuda``). With :mod:`raft_tpu_torch.obs`
    enabled: a synced ``nn_descent.build`` span, ``nn_descent.build.calls``
    and ``.rows``, and the ``.iterations`` histogram."""
    if params is None:
        params = NNDescentParams(**kwargs)
    if not obs.is_enabled():
        return _build_impl(dataset, params, res)
    n = len(dataset)
    obs.inc("nn_descent.build.calls")
    obs.inc("nn_descent.build.rows", float(n))
    with obs.span("nn_descent.build", n=n, graph_degree=params.graph_degree,
                  intermediate=params.intermediate_graph_degree) as sp:
        out = _build_impl(dataset, params, res)
        sp.sync((out.graph, out.distances))
        return out


def _build_impl(dataset, params: NNDescentParams, res: Optional[Resources]) -> NNDescentOutput:
    res = ensure_resources(res)
    metric = resolve_metric(params.metric)
    expects(metric in _SUPPORTED, "nn_descent does not support metric %s", metric)
    dataset = ser.as_tensor(dataset, res.device)
    expects(dataset.ndim == 2, "dataset must be [n_rows, dim]")
    n = dataset.shape[0]
    gd = params.graph_degree
    k = max(params.intermediate_graph_degree, gd)
    expects(gd >= 1, "graph_degree must be >= 1")
    expects(k < n, "graph degree %d must be < n_rows %d", k, n)
    dev = res.device

    data = dataset.to(torch.float32)
    if metric == DistanceType.CosineExpanded:
        # cosine ranking == L2 ranking on unit vectors; distances converted
        # at the end (1 - cos = L2^2 / 2 on the unit sphere)
        data = normalize_rows(data)
    select_min = metric != DistanceType.InnerProduct
    sqnorms = torch.sum(data * data, dim=1)
    gen = make_generator(params.seed, dev)

    # random initial graph without self loops
    init_ids = torch.randint(0, n, (n, k), generator=gen, device=dev, dtype=torch.int32)
    rows = torch.arange(n, dtype=torch.int32, device=dev)[:, None]
    init_ids = torch.where(init_ids == rows, (init_ids + 1) % n, init_ids)

    worst = worst_value(torch.float32, select_min)
    chunk = max(256, params.node_chunk)

    def merge_candidates(acc_v, acc_i, acc_f, cand_of_chunk):
        parts = [_score_and_merge(data, sqnorms, cand_of_chunk(s), acc_v[s : s + chunk],
                                  acc_i[s : s + chunk], acc_f[s : s + chunk], s,
                                  select_min=select_min)
                 for s in range(0, n, chunk)]
        return tuple(torch.cat([p[j] for p in parts], dim=0) for j in range(3))

    acc_v = torch.full((n, k), worst, dtype=torch.float32, device=dev)
    acc_i = torch.full((n, k), -1, dtype=torch.int32, device=dev)
    sampled = torch.zeros((n, k), dtype=torch.bool, device=dev)  # everything new
    acc_v, acc_i, sampled = merge_candidates(acc_v, acc_i, sampled,
                                             lambda s: init_ids[s : s + chunk])

    half = max(1, min(params.max_samples // 2, k))
    it = 0
    for it in range(params.max_iterations):
        pool, sampled = _sample_pool(gen, acc_i, sampled, half=half)
        sym = torch.cat([pool, reverse_edges(pool, n, 2 * half)], dim=1)  # [n, 4 * half]
        prev_i = acc_i
        acc_v, acc_i, sampled = merge_candidates(acc_v, acc_i, sampled,
                                                 lambda s: _two_hop(sym, sym[s : s + chunk]))
        # update rate: share of entries not present before (sorted lookup)
        prev_sorted = torch.sort(prev_i, dim=1).values
        pos = torch.clamp(torch.searchsorted(prev_sorted, acc_i.contiguous()), max=k - 1)
        found = torch.gather(prev_sorted, 1, pos) == acc_i
        if float(torch.mean(((~found) & (acc_i >= 0)).to(torch.float32))) < params.termination_threshold:
            break

    if obs.is_enabled() and params.max_iterations > 0:
        obs.observe("nn_descent.build.iterations", float(it + 1))
    graph = acc_i[:, :gd]
    dists = acc_v[:, :gd]
    if metric == DistanceType.L2SqrtExpanded:
        dists = torch.where(graph >= 0, torch.sqrt(torch.clamp(dists, min=0.0)), dists)
    elif metric == DistanceType.CosineExpanded:
        dists = torch.where(graph >= 0, 0.5 * dists, dists)
    return NNDescentOutput(graph=graph, distances=dists, metric=metric)
