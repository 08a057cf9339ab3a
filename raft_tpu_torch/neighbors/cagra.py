"""CAGRA graph index (``raft_tpu.neighbors.cagra`` counterpart).

Build: an intermediate kNN graph, by NN-descent (the default) or by an
IVF-PQ self-search plus exact refine (``build_algo="ivf_pq"``), then
:func:`optimize`: 2-hop detour pruning and the protected-head reverse-edge
merge, integer work that gives the JAX package's graph exactly.

Search (:func:`search`) modes:

* ``"fused"`` — the beam loop of kernel B4
  (:func:`raft_tpu_torch.ops.cagra_search.cagra_fused_search`, the Hopper
  kernel on the card) from the strided seed beam, then the final unique
  merge and the metric epilogue;
* ``"xla"`` — the unfused gather -> score -> select loop (the name is the
  JAX package's, so a caller passes one mode string to both packages): it
  serves every case the kernel does not, prefilters, random seeds,
  ``dedup="sort"``/``"none"`` and VPQ-compressed datasets;
* ``"auto"`` — fused on a CUDA index when :func:`fused_eligible`, else
  xla. Nothing catches a kernel failure: a build or launch error raises.

VPQ (:func:`compress`) replaces the raw rows by coarse VQ centers plus
PQ-coded residuals; the xla search decodes candidate rows with a gather.
Indexes save and load at format version 2, byte for byte with the JAX
package.

Supported metrics: L2Expanded, L2SqrtExpanded, InnerProduct.
"""
from __future__ import annotations

import dataclasses
import io
import time
from typing import BinaryIO, Dict, Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.core import serialize as ser
from raft_tpu_torch.core.bitset import Bitset
from raft_tpu_torch.core.errors import LogicError, expects
from raft_tpu_torch.core.resources import Resources, ensure_resources
from raft_tpu_torch.ops.cagra_search import (
    MAX_TABLE_IDS,
    WORST,
    build_neighbor_table,
    cagra_fused_search,
    pick_positions,
)
from raft_tpu_torch.ops.distance import DistanceType, resolve_metric
from raft_tpu_torch.ops.select_k import running_merge_unique, select_k, worst_value
from raft_tpu_torch.utils.graph import reverse_edges

_SUPPORTED = (
    DistanceType.L2Expanded,
    DistanceType.L2SqrtExpanded,
    DistanceType.InnerProduct,
)

IVF_PQ = "ivf_pq"
NN_DESCENT = "nn_descent"

_TABLE_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass
class CagraIndexParams:
    """``cagra::index_params`` analog; every field and default of the JAX
    package."""

    intermediate_graph_degree: int = 128
    graph_degree: int = 64
    build_algo: str = NN_DESCENT
    metric: DistanceType = DistanceType.L2Expanded
    nn_descent_niter: int = 20
    seed: int = 0


@dataclasses.dataclass
class CagraSearchParams:
    """``cagra::search_params`` analog; every field and default of the JAX
    package.

    ``init_sample``: seed the beam from the best of this many evenly
    strided dataset rows (one ``[nq, S]`` f32 matmul); 0 = random seeds
    drawn from ``seed``. ``dedup``: ``"post"`` (adjacent-id kill after a
    value sort; the fused kernel's semantics), ``"sort"`` (id sort +
    adjacent compare + re-select) or ``"none"``; True/False alias
    ``"sort"``/``"none"``. ``fused_table_dtype``: the neighbour table's
    dtype (bf16 halves its bytes). ``fused_qt`` is kept for parity with
    the JAX package, where it sizes the TPU kernel's query tile; the port
    reads it nowhere (its kernel runs one CTA per query)."""

    itopk_size: int = 64
    search_width: int = 1
    max_iterations: int = 0  # 0 = auto (search_plan.cuh:136 adjust)
    seed: int = 0
    init_sample: int = 4096
    fused_qt: int = 32
    fused_table_dtype: str = "bfloat16"
    dedup: str = "post"


@dataclasses.dataclass
class VpqParams:
    """``vpq_params`` analog: coarse vector quantization + product
    quantization of the residual."""

    vq_n_centers: int = 0  # 0 = auto (~sqrt(n))
    pq_dim: int = 0  # 0 = auto (dim / 4, min 1)
    pq_bits: int = 8
    kmeans_n_iters: int = 15
    seed: int = 0


@dataclasses.dataclass
class VpqDataset:
    """VQ+PQ compressed dataset: each row is a coarse VQ center plus a
    PQ-coded residual, ``pq_dim`` bytes a row."""

    vq_centers: torch.Tensor  # [vq_n, d] f32
    vq_labels: torch.Tensor  # [n] i32
    pq_centers: torch.Tensor  # [pq_dim, ksub, pq_len] f32
    codes: torch.Tensor  # [n, pq_dim] u8
    sqnorms: torch.Tensor  # [n] f32, ||decoded row||^2

    @property
    def pq_dim(self) -> int:
        return self.codes.shape[1]

    @property
    def ksub(self) -> int:
        return self.pq_centers.shape[1]


@dataclasses.dataclass
class CagraIndex:
    """Fixed-degree graph + dataset (raw rows, or :class:`VpqDataset`).
    ``build_seconds`` holds the stages of the build that made it."""

    dataset: Optional[torch.Tensor]  # [n, d], or None when vpq is set
    sqnorms: Optional[torch.Tensor]  # [n] f32
    graph: torch.Tensor  # [n, graph_degree] i32
    metric: DistanceType
    size: int
    vpq: Optional[VpqDataset] = None
    dim_hint: int = 0  # feature dim when the dataset is compressed away
    build_seconds: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def dim(self) -> int:
        if self.dataset is not None:
            return self.dataset.shape[1]
        return self.dim_hint or self.vpq.vq_centers.shape[1]

    @property
    def graph_degree(self) -> int:
        return self.graph.shape[1]

    @property
    def device(self) -> torch.device:
        return self.graph.device


# ---------------------------------------------------------------------------
# graph optimization (prune + reverse merge)
# ---------------------------------------------------------------------------


def _detour_rerank_chunk(graph, chunk_ids, *, kout: int) -> torch.Tensor:
    """Detour counts for a chunk of nodes and the re-rank (``kern_prune``,
    ``graph_core.cuh:130``): for node A with ranked neighbours G[A],
    detour(A, b) = #{a < b : G[A, b] in G[G[A, a]]}; edges are ordered by
    (detour count, rank), -1 pads last, and cut to ``kout``. Membership is
    a binary search in each sorted two-hop row."""
    kin = graph.shape[1]
    dev = graph.device
    rows = graph[chunk_ids.to(torch.int64)]  # [c, kin]
    c = rows.shape[0]
    rows_valid = rows >= 0
    # a -1 pad gathers row 0's adjacency; its contribution is masked below
    two_hop = graph[torch.clamp(rows, min=0).to(torch.int64)]  # [c, kin, kin]
    th_sorted = torch.sort(two_hop, dim=-1).values
    targets = rows[:, None, :].expand(c, kin, kin).contiguous()
    pos = torch.clamp(torch.searchsorted(th_sorted, targets), max=kin - 1)
    hit = (torch.gather(th_sorted, 2, pos) == targets) & rows_valid[:, :, None]  # [c, a, b]
    ar = torch.arange(kin, device=dev)
    a_lt_b = ar[:, None] < ar[None, :]
    counts = torch.sum(hit & a_lt_b[None], dim=1)
    counts = torch.where(rows < 0, kin + 1, counts)
    order = torch.argsort(counts * kin + ar[None, :], dim=1)
    return torch.gather(rows, 1, order[:, :kout])


def _merge_reverse(fwd, rev, *, kout: int) -> torch.Tensor:
    """Protected-head merge (``graph_core.cuh:525-555``): the first
    ``kout/2`` forward edges, then the reverse edges, then the other
    forward edges, keep-first dedup, cut to ``kout``."""
    protected = kout // 2
    cand = torch.cat([fwd[:, :protected], rev, fwd[:, protected:]], dim=1)
    m = cand.shape[1]
    pos = torch.arange(m, device=cand.device).expand(cand.shape[0], m)
    # keep-first dedup: sort by (id, position); invalid ids all tie last
    composite = torch.where(cand < 0, torch.iinfo(torch.int32).max, cand.to(torch.int64) * m + pos)
    order = torch.argsort(composite, dim=1, stable=True)
    ids_s = torch.gather(cand, 1, order)
    pos_s = torch.gather(pos, 1, order)
    prev = torch.cat([torch.full_like(ids_s[:, :1], -2), ids_s[:, :-1]], dim=1)
    dup = (ids_s == prev) | (ids_s < 0)
    # survivors back in their original order, first kout
    order2 = torch.argsort(torch.where(dup, m + pos_s, pos_s), dim=1, stable=True)[:, :kout]
    merged = torch.gather(ids_s, 1, order2)
    return torch.where(torch.gather(dup, 1, order2), -1, merged).to(torch.int32)


def optimize(knn_graph, graph_degree: int, node_chunk: int = 16384) -> torch.Tensor:
    """Prune an intermediate kNN graph to a fixed-degree CAGRA graph
    (``cagra::optimize``). The result does not depend on ``node_chunk``."""
    knn_graph = torch.as_tensor(knn_graph).to(torch.int32)
    n, kin = knn_graph.shape
    kout = min(graph_degree, kin)
    ids = torch.arange(n, dtype=torch.int64, device=knn_graph.device)
    fwd = torch.cat([_detour_rerank_chunk(knn_graph, ids[s : s + node_chunk], kout=kout)
                     for s in range(0, n, node_chunk)], dim=0)
    # reverse lists ordered by forward rank (kern_make_rev_graph's k-major order)
    rev = reverse_edges(fwd, n, kout, order_by_rank=True)
    return _merge_reverse(fwd, rev, kout=kout)


# ---------------------------------------------------------------------------
# build
# ---------------------------------------------------------------------------


def _drop_self_edges(nbrs, kin: int) -> torch.Tensor:
    """Drop each row's self edge and keep ``kin`` neighbours: a stable sort
    moves the (at most one) self edge to the end."""
    rows = torch.arange(nbrs.shape[0], device=nbrs.device)[:, None]
    mask = nbrs != rows
    pos = torch.argsort((~mask).to(torch.int8), dim=1, stable=True)[:, :kin]
    knn = torch.gather(nbrs, 1, pos)
    return torch.where(torch.gather(mask, 1, pos), knn, -1).to(torch.int32)


def build(
    dataset,
    params: Optional[CagraIndexParams] = None,
    res: Optional[Resources] = None,
    pq_index=None,
    **kwargs,
) -> CagraIndex:
    """Build the index (``cagra::build``): the intermediate kNN graph by
    NN-descent or by IVF-PQ self-search + exact refine, then
    :func:`optimize`. ``pq_index``: an IVF-PQ index already built over this
    dataset, reused by the ``build_algo="ivf_pq"`` route. The returned
    index's ``build_seconds`` splits the build into its stages."""
    res = ensure_resources(res)
    if params is None:
        params = CagraIndexParams(**kwargs)
    metric = resolve_metric(params.metric)
    expects(metric in _SUPPORTED, "CAGRA does not support metric %s", metric)
    dataset = ser.as_tensor(dataset, res.device)
    expects(dataset.ndim == 2, "dataset must be [n_rows, dim]")
    n, d = dataset.shape
    kin = min(params.intermediate_graph_degree, n - 1)
    kout = min(params.graph_degree, kin)
    seconds = {}
    t0 = time.perf_counter()

    def stage(name):
        nonlocal t0
        res.sync()
        t1 = time.perf_counter()
        seconds[name] = t1 - t0
        t0 = t1

    if params.build_algo == NN_DESCENT:
        from raft_tpu_torch.neighbors import nn_descent

        out = nn_descent.build(
            dataset,
            nn_descent.NNDescentParams(
                graph_degree=kin,
                intermediate_graph_degree=min(max(kin + kin // 2, kin + 8), n - 1),
                max_iterations=params.nn_descent_niter,
                metric=metric,
                seed=params.seed,
            ),
            res=res,
        )
        knn_graph = out.graph
        stage("nn_descent")
    else:
        expects(params.build_algo == IVF_PQ, "unknown build_algo %s", params.build_algo)
        from raft_tpu_torch.neighbors import ivf_pq
        from raft_tpu_torch.neighbors.refine import refine

        if pq_index is not None:
            expects(pq_index.size == n, "pq_index covers %d rows, dataset has %d", pq_index.size, n)
            pq = pq_index
        else:
            pq = ivf_pq.build(
                dataset,
                ivf_pq.IvfPqIndexParams(
                    n_lists=max(1, min(1024, n // 128)),
                    metric=metric,
                    seed=params.seed,
                    # pq_dim 32 keeps the fused LUT small; the exact refine
                    # below restores the order of the shortlists
                    pq_dim=32 if d >= 64 and d % 32 == 0 else 0,
                    pq_kind="nibble",
                    kmeans_n_iters=10,
                    kmeans_trainset_fraction=min(1.0, max(0.05, 100_000 / max(n, 1))),
                    list_cap_factor=1.1,
                ),
                res=res,
            )
        stage("pq_build")
        top = kin + 1
        _, cand = ivf_pq.search(pq, dataset, min(2 * top, pq.size), n_probes=24, query_batch=4096)
        stage("self_search")
        _, nbrs = refine(dataset, dataset, cand, top, metric=metric)
        knn_graph = _drop_self_edges(nbrs, kin)
        stage("refine")
    graph = optimize(knn_graph, kout)
    stage("optimize")
    data_f32 = dataset.to(torch.float32)
    return CagraIndex(dataset=dataset, sqnorms=torch.sum(data_f32 * data_f32, dim=1), graph=graph,
                      metric=metric, size=n, build_seconds=seconds)


def from_graph(dataset, graph, metric=DistanceType.L2Expanded, res: Optional[Resources] = None,
               device=None) -> CagraIndex:
    """An index from a pre-built graph (``cagra::index`` from existing
    dataset and graph views) on ``res``/``device`` (default ``cuda``)."""
    dev = ensure_resources(res, device).device
    dataset = ser.as_tensor(dataset, dev)
    graph = ser.as_tensor(graph, dev).to(torch.int32)
    expects(dataset.shape[0] == graph.shape[0], "dataset/graph row mismatch")
    data_f32 = dataset.to(torch.float32)
    return CagraIndex(dataset=dataset, sqnorms=torch.sum(data_f32 * data_f32, dim=1), graph=graph,
                      metric=resolve_metric(metric), size=dataset.shape[0])


# ---------------------------------------------------------------------------
# search
# ---------------------------------------------------------------------------


def _filter_bit(filter_bits, ids) -> torch.Tensor:
    safe = torch.clamp(ids, min=0).to(torch.int64)
    return (filter_bits[safe // 32] >> (safe % 32).to(torch.int32)) & 1


def _seed_select(qf, q_sqnorm, vecs, vsq, init_ids, *, itopk: int, select_min: bool, worst: float,
                 filter_bits=None, has_filter: bool = False):
    """Score the shared strided seed rows (one ``[nq, S]`` matmul, full f32)
    and select the initial beam ``(values, ids)``, ``worst``/-1 in unfilled
    slots. Shared by the xla and fused paths, which so start from the same
    beam."""
    if qf.device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise LogicError("the CAGRA seed product needs full f32: "
                         "torch.backends.cuda.matmul.allow_tf32 must be False")
    s = init_ids.shape[0]
    dots = qf @ vecs.T
    if select_min:
        sample_d = torch.clamp(q_sqnorm[:, None] + vsq[None, :] - 2.0 * dots, min=0.0)
    else:
        sample_d = dots
    if has_filter:
        keep = _filter_bit(filter_bits, init_ids) == 1
        sample_d = torch.where(keep[None, :], sample_d, torch.full_like(sample_d, worst))
    kk = min(itopk, s)
    v0, pos = select_k(sample_d, kk, select_min=select_min)
    i0 = torch.where(v0 != worst, init_ids[pos.to(torch.int64)], -1).to(torch.int32)
    if kk < itopk:
        v0 = torch.nn.functional.pad(v0, (0, itopk - kk), value=worst)
        i0 = torch.nn.functional.pad(i0, (0, itopk - kk), value=-1)
    return v0, i0


def _gather_vecs(dataset, vpq_arrays, safe) -> torch.Tensor:
    """Rows ``safe [b, c]`` as f32 ``[b, c, d]``: raw rows, or the VPQ
    decode (coarse center + the PQ residual, gathered per subspace)."""
    if vpq_arrays is None:
        return dataset[safe].to(torch.float32)
    vq_centers, vq_labels, pq_centers, codes = vpq_arrays
    b, c = safe.shape
    base = vq_centers[vq_labels[safe].to(torch.int64)]  # [b, c, d]
    cod = codes[safe].to(torch.int64)  # [b, c, pq_dim]
    sub = torch.arange(cod.shape[2], device=cod.device)
    resid = pq_centers[sub, cod]  # [b, c, pq_dim, pq_len]
    return base + resid.reshape(b, c, -1)


def _cagra_search_impl(dataset, sqnorms, graph, queries, init_ids, filter_bits, vpq_arrays=None, *,
                       k: int, itopk: int, width: int, iters: int, metric: DistanceType,
                       has_filter: bool, use_vpq: bool = False, dedup: str = "post"):
    """The unfused beam loop (the JAX package's ``"xla"`` path): each step
    gathers the parents' adjacency, scores the neighbours and re-selects the
    beam, with the visited flag riding through ``running_merge_unique``
    (``dedup="sort"``) or packed as ``id * 2 + flag`` through one value
    sort (``"post"``/``"none"``)."""
    nq, d = queries.shape
    deg = graph.shape[1]
    qf = queries.to(torch.float32)
    select_min = metric != DistanceType.InnerProduct
    worst = worst_value(torch.float32, select_min)
    q_sqnorm = torch.sum(qf * qf, dim=1)
    vpq = vpq_arrays if use_vpq else None

    def score(cand):  # cand [nq, c] ids, -1 invalid
        safe = torch.clamp(cand, min=0).to(torch.int64)
        vecs = _gather_vecs(dataset, vpq, safe)
        dots = torch.bmm(vecs, qf[:, :, None])[:, :, 0]
        if select_min:
            dist = torch.clamp(q_sqnorm[:, None] + sqnorms[safe] - 2.0 * dots, min=0.0)
        else:
            dist = dots
        invalid = cand < 0
        if has_filter:
            # filtered at insertion: banned ids never occupy beam slots
            invalid = invalid | (_filter_bit(filter_bits, cand) == 0)
        return torch.where(invalid, torch.full_like(dist, worst), dist)

    if init_ids.ndim == 1:
        seed = init_ids.to(torch.int64)
        buf_v, buf_i = _seed_select(
            qf, q_sqnorm, _gather_vecs(dataset, vpq, seed[None, :])[0], sqnorms[seed], init_ids,
            itopk=itopk, select_min=select_min, worst=worst, filter_bits=filter_bits,
            has_filter=has_filter,
        )
        buf_f = torch.zeros((nq, itopk), dtype=torch.bool, device=qf.device)
    else:
        buf_v, buf_i, buf_f = running_merge_unique(
            torch.full((nq, itopk), worst, dtype=torch.float32, device=qf.device),
            torch.full((nq, itopk), -1, dtype=torch.int32, device=qf.device),
            score(init_ids), init_ids.to(torch.int32), select_min=select_min,
            acc_flags=torch.zeros((nq, itopk), dtype=torch.bool, device=qf.device),
        )

    def expand_parents(masked, ids_at):
        """pickup_next_parents -> adjacency -> scores: the best ``width``
        unflagged beam entries parent a fixed-degree expansion."""
        ppos, pvalid = pick_positions(masked if select_min else -masked, width, float("inf"))
        parents = torch.where(pvalid, ids_at(ppos), -1)  # [nq, width]
        nbrs = graph[torch.clamp(parents, min=0).to(torch.int64)]
        nbrs = torch.where(parents[:, :, None] >= 0, nbrs, -1).reshape(nq, width * deg)
        return ppos, nbrs, score(nbrs)

    if dedup == "sort":
        for _ in range(iters):
            masked = torch.where(buf_f | (buf_i < 0), torch.full_like(buf_v, worst), buf_v)
            ppos, nbrs, dist = expand_parents(masked, lambda p: torch.gather(buf_i, 1, p))
            buf_f = buf_f.scatter(1, ppos, True)
            buf_v, buf_i, buf_f = running_merge_unique(buf_v, buf_i, dist, nbrs,
                                                       select_min=select_min, acc_flags=buf_f)
    else:
        buf_idf = torch.where(buf_i < 0, -1, buf_i * 2 + buf_f.to(torch.int32)).to(torch.int32)
        for _ in range(iters):
            masked = torch.where(((buf_idf & 1) == 1) | (buf_idf < 0), torch.full_like(buf_v, worst),
                                 buf_v)
            ppos, nbrs, dist = expand_parents(masked, lambda p: torch.gather(buf_idf >> 1, 1, p))
            buf_idf = buf_idf.scatter(1, ppos, torch.gather(buf_idf, 1, ppos) | 1)
            vals = torch.cat([buf_v, torch.where(nbrs < 0, torch.full_like(dist, worst), dist)], dim=1)
            idfs = torch.cat([buf_idf, nbrs * 2], dim=1)
            buf_v, pos = select_k(vals, itopk, select_min=select_min)
            buf_idf = torch.gather(idfs, 1, pos.to(torch.int64))
            buf_idf = torch.where(buf_v == worst, -1, buf_idf)
            if dedup == "post":
                ids = buf_idf >> 1
                prev = torch.cat([torch.full_like(ids[:, :1], -2), ids[:, :-1]], dim=1)
                dup = (ids == prev) & (ids >= 0)
                buf_v = torch.where(dup, torch.full_like(buf_v, worst), buf_v)
                buf_idf = torch.where(dup, -1, buf_idf)
        buf_i = buf_idf >> 1
        buf_f = (buf_idf & 1) == 1
    if dedup in ("none", "post"):
        # one final sort-dedup: the seed beam's scores come from the [nq, S]
        # product and a seed re-proposed in the loop may round differently,
        # so its two copies need not be value-adjacent
        buf_v, buf_i, buf_f = running_merge_unique(
            buf_v, buf_i,
            torch.full((nq, 1), worst, dtype=torch.float32, device=qf.device),
            torch.full((nq, 1), -1, dtype=torch.int32, device=qf.device),
            select_min=select_min, acc_flags=buf_f,
        )
    return _epilogue(buf_v[:, :k], buf_i[:, :k], metric)


def _epilogue(vals, idx, metric: DistanceType):
    if metric == DistanceType.L2SqrtExpanded:
        vals = torch.where(idx >= 0, torch.sqrt(torch.clamp(vals, min=0.0)), vals)
    return vals, idx


def strided_seed_ids(size: int, sample: int, device=None) -> torch.Tensor:
    """``min(sample, size)`` distinct evenly spaced seed ids
    ``floor(i * size / sample)``, int32 (computed in int64)."""
    s = min(sample, size)
    return torch.from_numpy(((np.arange(s, dtype=np.int64) * size) // s).astype(np.int32)).to(device)


def plan_search_params(nq: int, k: int, size: int,
                       base: Optional[CagraSearchParams] = None) -> CagraSearchParams:
    """The search schedule from the batch shape (``search_plan.cuh:81-164``
    analog): a default width becomes 8, and batches of at most 32 queries
    seed from 4x the default sample. Explicit non-default values are
    kept."""
    base = base or CagraSearchParams()
    width = base.search_width
    init = base.init_sample
    if width == CagraSearchParams.search_width:
        width = 8
    if nq <= 32 and init == CagraSearchParams.init_sample:
        init = min(size, 4 * CagraSearchParams.init_sample)
    return dataclasses.replace(base, itopk_size=max(base.itopk_size, k), search_width=width,
                               init_sample=init)


def derive_search_config(params: CagraSearchParams, k: int, size: int):
    """``(itopk, width, iters, n_init)`` (``search_plan.cuh:136`` adjust):
    ``iters = 1 + min(1.1 * itopk / width, itopk / width + 10)``, at least
    10, unless ``max_iterations`` is set."""
    itopk = max(params.itopk_size, k)
    width = max(1, params.search_width)
    ratio = itopk // max(1, width)
    iters = params.max_iterations or max(10, 1 + min(int(ratio * 1.1), ratio + 10))
    return itopk, width, iters, min(itopk, size)


def fused_eligible(index: CagraIndex, params: CagraSearchParams,
                   prefilter: Optional[Bitset] = None) -> bool:
    """Whether kernel B4 can serve this search: a raw dataset, strided
    seeding, ``"post"`` dedup, no prefilter, a supported metric, and the
    JAX package's limits (``graph_degree <= dim``, at most
    :data:`~raft_tpu_torch.ops.cagra_search.MAX_TABLE_IDS` rows), so that
    ``"auto"`` decides as the JAX package does."""
    return (
        index.dataset is not None
        and prefilter is None
        and params.init_sample > 0
        and params.dedup == "post"
        and index.metric in _SUPPORTED
        and index.graph_degree <= index.dim
        and index.size <= MAX_TABLE_IDS
    )


def _fused_table(index: CagraIndex, dtype) -> torch.Tensor:
    """Build (once) and cache the ``[n, deg, d]`` neighbour table on the
    index (a plain attribute: a rebuilt index starts without one)."""
    dtype = _TABLE_DTYPES.get(dtype, dtype)
    cached = getattr(index, "_fused_table_cache", None)
    if cached is None or cached[0] != dtype:
        cached = (dtype, build_neighbor_table(index.dataset, index.graph, dtype=dtype))
        index._fused_table_cache = cached
    return cached[1]


def _cagra_fused_impl(table, graph, dataset, sqnorms, queries, init_ids, *, k: int, itopk: int,
                      width: int, iters: int, metric: DistanceType):
    """The fused path: the xla path's seed beam (:func:`_seed_select`), the
    beam loop of kernel B4, then the final unique merge and the metric
    epilogue. The merge also collapses the one duplicate class the kernel's
    adjacent kill cannot see: a seed re-scored by the kernel need not round
    as the seed product did."""
    nq = queries.shape[0]
    qf = queries.to(torch.float32)
    select_min = metric != DistanceType.InnerProduct
    worst = worst_value(torch.float32, select_min)
    q_sqnorm = torch.sum(qf * qf, dim=1)
    seed = init_ids.to(torch.int64)
    v0, i0 = _seed_select(qf, q_sqnorm, dataset[seed].to(torch.float32), sqnorms[seed], init_ids,
                          itopk=itopk, select_min=select_min, worst=worst)
    # the kernel's beam is min-ordered with a finite worst: negate IP dots,
    # map empty slots, pack (id, visited = 0)
    kv0 = torch.where(i0 < 0, WORST, v0 if select_min else -v0)
    kidf0 = torch.where(i0 < 0, -1, i0 * 2).to(torch.int32)
    bv, bidf = cagra_fused_search(table, graph, qf, kv0, kidf0, itopk=itopk, width=width,
                                  iters=iters, ip=not select_min)
    buf_i = bidf >> 1
    buf_f = (bidf & 1) == 1
    buf_v = torch.where(buf_i < 0, torch.full_like(bv, worst), bv if select_min else -bv)
    buf_v, buf_i, _ = running_merge_unique(
        buf_v, buf_i,
        torch.full((nq, 1), worst, dtype=torch.float32, device=qf.device),
        torch.full((nq, 1), -1, dtype=torch.int32, device=qf.device),
        select_min=select_min, acc_flags=buf_f,
    )
    return _epilogue(buf_v[:, :k], buf_i[:, :k], metric)


def search(
    index: CagraIndex,
    queries,
    k: int,
    params: Optional[CagraSearchParams] = None,
    prefilter: Optional[Bitset] = None,
    query_batch: int = 1024,
    res: Optional[Resources] = None,
    mode: str = "auto",
    **kwargs,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy beam search over the graph (``cagra::search``). Returns
    best-first ``(distances [nq, k] f32, indices [nq, k] i32)`` on the
    index's device; unfilled slots get id -1. ``mode``: ``"fused"`` (kernel
    B4), ``"xla"`` (the unfused gather -> score -> select loop) or
    ``"auto"`` (fused on a CUDA index when :func:`fused_eligible`, else
    xla); see the module docstring. Queries run in batches of
    ``query_batch``, the tail zero-padded when there is more than one."""
    if params is None:
        params = CagraSearchParams(**kwargs)
    dev = index.device
    queries = ser.as_tensor(queries, dev)
    expects(queries.ndim == 2 and queries.shape[1] == index.dim, "bad query shape")
    expects(k >= 1, "k must be >= 1")
    expects(params.dedup in ("sort", "post", "none", True, False),
            "dedup must be sort|post|none, got %r", params.dedup)
    itopk, width, iters, n_init = derive_search_config(params, k, index.size)
    if prefilter is not None:
        expects(prefilter.size >= index.size, "prefilter smaller than index")
    filter_bits = prefilter.bits.to(dev) if prefilter is not None else None
    if mode == "auto":
        mode = "fused" if dev.type == "cuda" and fused_eligible(index, params, prefilter) else "xla"
    expects(mode in ("xla", "fused"), "mode must be auto|xla|fused, got %r", mode)
    if mode == "fused":
        expects(fused_eligible(index, params, prefilter),
                "fused mode needs a raw dataset, init_sample > 0, dedup='post', no prefilter, "
                "and graph_degree <= dim (use mode='xla')")
        table = _fused_table(index, params.fused_table_dtype)
    use_vpq = index.dataset is None
    vpq_arrays = None
    sqnorms = index.sqnorms
    if use_vpq:
        expects(index.vpq is not None, "index has neither dataset nor vpq data")
        v = index.vpq
        vpq_arrays = (v.vq_centers, v.vq_labels, v.pq_centers, v.codes)
        sqnorms = v.sqnorms
    dedup = {True: "sort", False: "none"}.get(params.dedup, params.dedup)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(params.seed))
    strided = strided_seed_ids(index.size, params.init_sample, dev) if params.init_sample > 0 else None

    nq = queries.shape[0]
    out_v, out_i = [], []
    for start in range(0, nq, query_batch):
        qc = queries[start : start + query_batch]
        bpad = query_batch - qc.shape[0] if nq > query_batch else 0
        if bpad:
            qc = torch.nn.functional.pad(qc, (0, 0, 0, bpad))
        if strided is not None:
            init_ids = strided
        else:
            init_ids = torch.randint(0, index.size, (qc.shape[0], n_init), generator=gen,
                                     device=dev, dtype=torch.int32)
        if mode == "fused":
            v, i = _cagra_fused_impl(
                table, index.graph, index.dataset, index.sqnorms, qc, init_ids, k=k, itopk=itopk,
                width=width, iters=iters, metric=index.metric,
            )
        else:
            v, i = _cagra_search_impl(
                index.dataset, sqnorms, index.graph, qc, init_ids, filter_bits, vpq_arrays, k=k,
                itopk=itopk, width=width, iters=iters, metric=index.metric,
                has_filter=filter_bits is not None, use_vpq=use_vpq, dedup=dedup,
            )
        if bpad:
            v, i = v[:-bpad], i[:-bpad]
        out_v.append(v)
        out_i.append(i)
    if len(out_v) == 1:
        return out_v[0], out_i[0]
    return torch.cat(out_v, dim=0), torch.cat(out_i, dim=0)


# ---------------------------------------------------------------------------
# VPQ compression (neighbors/dataset.hpp:210-259 vpq_dataset)
# ---------------------------------------------------------------------------


def _default_vpq_pq_dim(d: int) -> int:
    for cand in (d // 4, d // 2, d):
        if cand >= 1 and d % cand == 0:
            return cand
    return d


def compress(index: CagraIndex, params: Optional[VpqParams] = None, **kwargs) -> CagraIndex:
    """Replace the raw dataset with a VQ+PQ compressed one (``vpq_build``):
    balanced k-means VQ centers, then per-subspace PQ codebooks trained by
    Lloyd on a subsample of the residuals, and each row encoded to its
    nearest sub-center per subspace. Random draws come from a
    ``torch.Generator`` seeded with ``params.seed``."""
    from raft_tpu_torch.cluster import kmeans_balanced
    from raft_tpu_torch.cluster.kmeans import make_generator
    from raft_tpu_torch.cluster.kmeans_balanced import BalancedKMeansParams
    from raft_tpu_torch.neighbors.ivf_pq import _batched_lloyd
    from raft_tpu_torch.ops.fused_1nn import min_cluster_and_distance

    if params is None:
        params = VpqParams(**kwargs)
    expects(index.dataset is not None, "index already compressed")
    ds = index.dataset.to(torch.float32)
    dev = ds.device
    n, d = ds.shape
    vq_n = params.vq_n_centers or max(8, min(1024, int(round(n ** 0.5))))
    pq_dim = params.pq_dim or _default_vpq_pq_dim(d)
    expects(d % pq_dim == 0, "dim %d must be divisible by pq_dim %d", d, pq_dim)
    pq_len = d // pq_dim
    ksub = 1 << params.pq_bits

    gen = make_generator(params.seed, dev)
    vq_centers = kmeans_balanced.fit(
        ds, BalancedKMeansParams(n_clusters=vq_n, n_iters=params.kmeans_n_iters, seed=params.seed))
    vq_labels, _ = min_cluster_and_distance(ds, vq_centers)
    lab = vq_labels.to(torch.int64)
    resid = (ds - vq_centers[lab]).reshape(n, pq_dim, pq_len)

    # per-subspace codebooks on a subsample of the residuals
    nt = min(n, ksub * 256)
    sub = torch.randperm(n, generator=gen, device=dev)[:nt]
    Xs = resid[sub].permute(1, 0, 2).contiguous()  # [pq_dim, nt, pq_len]
    init = Xs[:, torch.randperm(nt, generator=gen, device=dev)[: min(ksub, nt)], :]
    if init.shape[1] < ksub:
        init = init.repeat(1, -(-ksub // init.shape[1]), 1)[:, :ksub, :]
    pq_centers = _batched_lloyd(Xs, torch.ones((pq_dim, nt), dtype=torch.float32, device=dev), init,
                                k=ksub, n_iters=params.kmeans_n_iters)

    # encode: nearest sub-center per subspace, and the decoded squared norm
    cn = torch.sum(pq_centers * pq_centers, dim=-1)  # [pq_dim, ksub]
    subs = torch.arange(pq_dim, device=dev)
    codes, sqn = [], []
    for s in range(0, n, 131072):
        dots = torch.einsum("cjl,jkl->cjk", resid[s : s + 131072], pq_centers)
        code = torch.argmax(2.0 * dots - cn[None, :, :], dim=-1)
        codes.append(code.to(torch.uint8))
        dec = pq_centers[subs, code].reshape(-1, d) + vq_centers[lab[s : s + 131072]]
        sqn.append(torch.sum(dec * dec, dim=1))
    vpq = VpqDataset(vq_centers=vq_centers, vq_labels=vq_labels.to(torch.int32),
                     pq_centers=pq_centers, codes=torch.cat(codes), sqnorms=torch.cat(sqn))
    return dataclasses.replace(index, dataset=None, sqnorms=None, vpq=vpq, dim_hint=d)


# -- carrying an index across packages -------------------------------------


def from_numpy(arrays: dict, metric, *, dim_hint: int = 0, device=None) -> CagraIndex:
    """An index from numpy arrays (e.g. a JAX index's fields through
    ``np.asarray``): ``graph``, and ``dataset`` or the VPQ arrays
    ``vq_centers``, ``vq_labels``, ``pq_centers``, ``codes``,
    ``vpq_sqnorms`` (or both). ``device=None`` means ``cuda``."""
    dev = ensure_resources(device=device if device is not None else "cuda").device

    def get(name):
        a = arrays.get(name)
        return None if a is None else ser.from_numpy(np.asarray(a), dev)

    vpq = None
    if arrays.get("codes") is not None:
        vpq = VpqDataset(vq_centers=get("vq_centers").to(torch.float32),
                         vq_labels=get("vq_labels").to(torch.int32),
                         pq_centers=get("pq_centers").to(torch.float32),
                         codes=get("codes").to(torch.uint8),
                         sqnorms=get("vpq_sqnorms").to(torch.float32))
    graph = get("graph").to(torch.int32)
    if arrays.get("dataset") is None:
        expects(vpq is not None, "from_numpy needs a dataset or the VPQ arrays")
        return CagraIndex(dataset=None, sqnorms=None, graph=graph, metric=resolve_metric(metric),
                          size=graph.shape[0], vpq=vpq, dim_hint=dim_hint)
    out = from_graph(get("dataset"), graph, metric, device=dev)
    return dataclasses.replace(out, vpq=vpq, dim_hint=dim_hint)


# -- serialization (same bytes as the JAX package) --------------------------

_KIND = "cagra"
_VERSION = 2


def _write_body(index: CagraIndex, stream: BinaryIO, include_dataset: bool = True) -> None:
    ser.serialize_scalar(stream, int(index.metric), "int32")
    ser.serialize_scalar(stream, int(index.size), "int64")
    has_raw = index.dataset is not None and include_dataset
    has_vpq = index.vpq is not None
    ser.serialize_scalar(stream, int(has_raw), "int32")
    ser.serialize_scalar(stream, int(has_vpq), "int32")
    ser.serialize_scalar(stream, int(index.dim), "int32")
    ser.serialize_array(stream, index.graph)
    if has_raw:
        ser.serialize_array(stream, index.dataset)
    if has_vpq:
        v = index.vpq
        for arr in (v.vq_centers, v.vq_labels, v.pq_centers, v.codes, v.sqnorms):
            ser.serialize_array(stream, arr)


def save(index: CagraIndex, stream: BinaryIO, include_dataset: bool = True) -> None:
    body = io.BytesIO()
    _write_body(index, body, include_dataset=include_dataset)
    ser.save_stream(stream, _KIND, _VERSION, body.getvalue())


def load(stream: BinaryIO, dataset=None, res: Optional[Resources] = None, device=None) -> CagraIndex:
    """Load an index saved by either package onto ``res``/``device``
    (default ``cuda``). An index saved without its dataset needs
    ``dataset=`` unless it carries VPQ data."""
    dev = ensure_resources(res, device).device
    version, stream = ser.load_stream(stream, _KIND)
    metric = DistanceType(ser.deserialize_scalar(stream, "int32"))
    size = int(ser.deserialize_scalar(stream, "int64"))
    has_ds = bool(ser.deserialize_scalar(stream, "int32"))
    has_vpq = bool(ser.deserialize_scalar(stream, "int32")) if version >= 2 else False
    dim = int(ser.deserialize_scalar(stream, "int32")) if version >= 2 else 0
    graph = ser.deserialize_array(stream, dev)
    data = ser.deserialize_array(stream, dev) if has_ds else None
    vpq = None
    if has_vpq:
        vpq = VpqDataset(*(ser.deserialize_array(stream, dev) for _ in range(5)))
    if data is None:
        if vpq is not None and dataset is None:
            return CagraIndex(dataset=None, sqnorms=None, graph=graph, metric=metric, size=size,
                              vpq=vpq, dim_hint=dim)
        expects(dataset is not None, "index was saved without dataset; pass one")
        data = ser.as_tensor(dataset, dev)
    expects(data.shape[0] == size, "dataset rows != index size")
    return dataclasses.replace(from_graph(data, graph, metric, device=dev), vpq=vpq, dim_hint=dim)


def save_path(index: CagraIndex, path: str, include_dataset: bool = True) -> str:
    """Atomic (temp-then-rename) checksummed snapshot at ``path``."""
    return ser.atomic_write(path, lambda f: save(index, f, include_dataset=include_dataset))


def load_path(path: str, dataset=None, res: Optional[Resources] = None, device=None) -> CagraIndex:
    with open(path, "rb") as f:
        return load(f, dataset=dataset, res=res, device=device)
