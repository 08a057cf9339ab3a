"""Fused probed-list scan for IVF-Flat search (``raft_tpu.ops.pallas.ivf_scan``
counterpart).

Queries are sorted into probe-coherent tiles of ``qt`` rows (by the
spatial rank of their nearest center), each tile gets a union probe table
of ``group``-list units (:func:`build_tile_probe_tables`), and
:func:`fused_list_topk` scores every slot of a tile's valid units against
the tile's queries and keeps each query's exact top-k.

:func:`fused_list_topk` runs the hand-written Hopper kernel
``raft_tpu_torch/csrc/ivf_scan.cu`` on CUDA tensors (it raises if the
kernel cannot be built or launched) and the plain PyTorch version
:func:`fused_list_topk_reference` on CPU tensors. Both compute the exact
``(score, slot)`` top-k, the JAX kernel's ``merge="exact"`` result; the
JAX ``bank*``/``seg*`` merges approximate that top-k by dropping
cross-step lane collisions, so any ``merge`` maps to the exact one here.
The scores are f32 dot products for every ``precision`` value; int8
and uint8 lists are widened to f32 per element. With bf16 lists the
queries are rounded to bf16 first, as the JAX kernel does for its bf16
matmul (``ivf_scan.py:215-217``); the products of two bf16 values are
exact in f32, so the kernel widens both and accumulates in f32.

The kernel filters before it scores exactly: a TF32 product of the cut
queries and rows on the tensor cores (:func:`tf32_cut`), widened by the
product's error bound (:func:`filter_error`: relative to the cut
operands' norms, :func:`cut_norms`; :func:`dot_upper_bound`), gives a
lower bound of every score (:func:`score_epilogue`); only rows
whose bound is not above the query's current k-th score are re-scored
exactly, with the FP32 kernel's arithmetic, and merged.
:func:`fused_list_topk_filtered_reference` runs that schedule in plain
PyTorch, and its result is the plain version's bit for bit. The chunks it
scans are listed per tile (:func:`chunk_table`, :func:`work_list`), and
:func:`cta_plan` sizes a CTA (queries, shared memory) as the kernel lays
it out; every ``d`` and ``k`` up to ``MAX_K`` has a plan.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch import obs
from raft_tpu_torch.core.errors import RaftError, expects
from raft_tpu_torch.ops.cuda_build import build_library
from raft_tpu_torch.ops.distance import DistanceType
from raft_tpu_torch.ops.fused_1nn import normalize_rows
from raft_tpu_torch.ops.guard import check_cuda
from raft_tpu_torch.ops.select_k import select_k
from raft_tpu_torch.utils.math import cdiv, round_up

#: largest k the kernel keeps per query (its top-k lives in shared memory)
MAX_K = 256
#: most CTAs that share one (tile, query group)'s units in B2 and B3, and
#: partial lists one ``merge_kernel`` folds (``MAX_SPLIT`` in topk.cuh)
MAX_SPLIT = 32
#: most CTAs that share one (tile group, query group)'s chunks in this
#: kernel: their partial lists fold 32 at a time, then once more
#: (``MAX_SHARES`` in the .cu)
MAX_SHARES = 1024

#: the metrics the kernel scores (its own set: the distance module computes
#: every metric, this kernel only the four with a per-slot epilogue)
SUPPORTED = frozenset({DistanceType.L2Expanded, DistanceType.L2SqrtExpanded,
                       DistanceType.InnerProduct, DistanceType.CosineExpanded})

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2, torch.uint8: 3}
_METRIC_CODE = {
    DistanceType.L2Expanded: 0,
    DistanceType.L2SqrtExpanded: 0,
    DistanceType.InnerProduct: 1,
    DistanceType.CosineExpanded: 2,
}


def supported_metric(metric: DistanceType) -> bool:
    return metric in SUPPORTED


# ---------------------------------------------------------------------------
# spatial ordering of the coarse centers (build-time, host)
# ---------------------------------------------------------------------------


def spatial_center_rank(centers: np.ndarray, leaf: int = 8) -> np.ndarray:
    """PCA-bisection rank of the coarse centers: recursively split along
    the local principal direction at the median, so lists with nearby ranks
    are nearby in space. Host numpy, as in the JAX package."""
    centers = np.asarray(centers, np.float64)
    n = centers.shape[0]
    rank = np.empty((n,), np.int32)
    pos = 0

    stack = [np.arange(n)]
    out = []
    while stack:
        idx = stack.pop()
        if len(idx) <= leaf:
            out.append(idx)
            continue
        x = centers[idx]
        x = x - x.mean(axis=0)
        cov = x.T @ x
        v = np.ones((cov.shape[0],)) / np.sqrt(cov.shape[0])
        for _ in range(16):
            v = cov @ v
            v = v / max(np.linalg.norm(v), 1e-30)
        proj = x @ v
        order = np.argsort(proj, kind="stable")
        half = len(idx) // 2
        stack.append(idx[order[half:]])
        stack.append(idx[order[:half]])
    for idx in out:
        rank[idx] = np.arange(pos, pos + len(idx), dtype=np.int32)
        pos += len(idx)
    return rank


# ---------------------------------------------------------------------------
# the kernel: build, layout, filter bound, plain versions, wrapper
# ---------------------------------------------------------------------------

#: the kernel's query counts per CTA (its ``QB`` template), most first
QUERIES_PER_CTA = (128, 64, 32, 16)
#: queries of one n8 tile of the product (``QW`` in the .cu)
_QUERIES_PER_TILE = 8
#: rows a chunk, four m16 tiles (``R``)
ROWS_PER_CHUNK = 64
#: dimensions of a staged depth slice (``DS``)
_DEPTH_SLICE = 128
#: depth slices staged at once (``NS``), or 2 where 3 do not fit
_STAGED = 3
#: from this many queries a CTA runs 16 warps, below it 8 (``WIDE_QB``)
_WIDE_QB = 32
#: bytes after each staged row slice (``ROW_PAD``)
_ROW_PAD = 16
#: the operands' TF32 cut: a float's sign, exponent and top 10 bits (``TF32_MASK``)
_TF32_MASK = 0xFFFFE000
#: shared memory a block may use on an H100, what an SM holds for its CTAs,
#: and what each CTA reserves
SMEM_LIMIT_BYTES = 232448
SM_SMEM_BYTES = 233472
CTA_RESERVED_BYTES = 1024
_SLOT_EMPTY = 2 ** 31 - 1
#: +inf as the kernel's ordered int key of a float (its shared k-th scores)
_INF_KEY = 0x7F800000
#: ``c`` of the filter's error bound: the tensor core's f32 sums lose at
#: most about one unit of 2^-23 of ``sum |q~||y~|`` a dimension; 8 leaves room
_ERROR_C = 8.0

_SIGNATURES = {
    "ivf_scan_fused_list_topk":
        [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 13 + [ctypes.c_int] * 12
        + [ctypes.c_float] * 2 + [ctypes.c_void_p],
    "ivf_scan_layout": [ctypes.c_void_p],
    "ivf_scan_smem_bytes": [ctypes.c_int] * 7,
}
#: the constants above as ``ivf_scan_layout`` reports the kernel's (the mask
#: as a C int); :func:`build_kernel` checks that they agree
_LAYOUT = (QUERIES_PER_CTA[0], _QUERIES_PER_TILE, ROWS_PER_CHUNK, _DEPTH_SLICE, _STAGED,
           _WIDE_QB, _ROW_PAD, _TF32_MASK - 2 ** 32)
#: the stage clock's stages (``csrc/stage_clock.cuh``) in the record of
#: :func:`fused_list_topk_stages`, then the warps' and the CTA's total
#: cycles and the counts of ``COUNTS``
STAGES = ("stage", "dot", "epilogue", "rescore", "topk", "barrier")
COUNTS = ("chunks", "candidates")
#: the checking launch's counts per CTA (:func:`fused_list_topk_check`)
CHECK_COUNTS = ("violations", "survivors", "pairs")


def build_kernel(verbose: bool = False) -> Tuple[ctypes.CDLL, float, str]:
    """Build ``csrc/ivf_scan.cu`` for ``sm_90a`` (once per source version)
    and load it, checking that the kernel's layout is the one this module
    mirrors; see :func:`raft_tpu_torch.ops.cuda_build.build_library`.
    Returns ``(library, build seconds, compiler output)``."""
    lib, seconds, log = build_library("ivf_scan.cu", _SIGNATURES, verbose=verbose)
    got = (ctypes.c_int * len(_LAYOUT))()
    lib.ivf_scan_layout(got)
    if tuple(got) != _LAYOUT:
        raise RaftError(f"ivf_scan.cu's layout {tuple(got)} is not the wrapper's {_LAYOUT}")
    return lib, seconds, log


def cta_warps(qb: int) -> int:
    """Warps of a CTA of ``qb`` queries (``cta_warps`` in the .cu): 4 along
    a chunk's m16 row tiles times 2 or 4 along the queries' n8 tiles."""
    return 16 if qb >= _WIDE_QB else 8


def cta_smem_bytes(qb: int, d: int, k: int, itemsize: int, qglobal: bool = False,
                   cosine: bool = False, staged: int = _STAGED) -> int:
    """Shared memory of one CTA of ``qb`` queries, as the kernel lays it
    out: the queries cut to TF32 (rows of ``round_up(d, 32) + 8`` floats;
    none with ``qglobal``), ``staged`` slices of 64 rows (``128 * itemsize
    + 16`` bytes a row) with their chunks' info and ln spans (and li spans
    for ``cosine``), per query its top-k list (8 B an entry), k-th bound,
    candidate count, cut norm, tile bit and 64 candidate rows (a byte
    each), each n8 tile's tile bits, and each warp's 32-entry merge batch
    (:func:`cta_warps`). The kernel's own count (``ivf_scan_smem_bytes``)
    is held to it at every launch."""
    queries = 0 if qglobal else qb * (round_up(d, 32) + 8) * 4
    rows = staged * (ROWS_PER_CHUNK * (_DEPTH_SLICE * itemsize + _ROW_PAD) + 16
                      + (2 if cosine else 1) * (4 * ROWS_PER_CHUNK + 16))
    return (queries + rows + qb * (8 * k + 16) + qb // _QUERIES_PER_TILE * 4
            + round_up(qb * ROWS_PER_CHUNK, 16) + cta_warps(qb) * 32 * 8)


@dataclasses.dataclass(frozen=True)
class CtaPlan:
    queries: int      # queries a CTA holds
    smem_bytes: int   # its dynamic shared memory
    qglobal: bool     # the queries read through the caches, not kept in shared memory
    ctas_per_sm: int  # CTAs an SM holds at once
    staged: int = _STAGED  # depth slices staged at once


def cta_plan(d: int, k: int, itemsize: int, qt: int = QUERIES_PER_CTA[0],
             cosine: bool = False) -> CtaPlan:
    """How the kernel runs at this shape: the most queries a CTA (128, 64,
    32 or 16, no more than a tile of ``qt`` needs) whose cut queries, lists
    and three staged slices of rows fit the 227 KB a block may use, or
    else two staged slices; else 16 queries read through the caches, whose
    shared memory does not grow with ``d``, so every ``d`` and every ``k``
    up to ``MAX_K`` has a plan."""
    expects(1 <= k <= MAX_K, "fused_list_topk: k=%d outside [1, %d]", k, MAX_K)
    want = min(q for q in QUERIES_PER_CTA if q >= min(qt, QUERIES_PER_CTA[0]))
    options = [(qb, False, ns) for qb in QUERIES_PER_CTA if qb <= want for ns in (_STAGED, 2)]
    for qb, qglobal, ns in options + [(QUERIES_PER_CTA[-1], True, _STAGED)]:
        smem = cta_smem_bytes(qb, d, k, itemsize, qglobal, cosine, ns)
        if smem <= SMEM_LIMIT_BYTES:
            per_sm = min(SM_SMEM_BYTES // (smem + CTA_RESERVED_BYTES), 64 // cta_warps(qb))
            return CtaPlan(qb, smem, qglobal, per_sm, ns)
    raise RaftError(f"fused_list_topk: no CTA plan fits at d={d}, k={k}")


def default_split(ctas: int, n_steps: int, slots: int) -> int:
    """CTAs that share one (tile group, query group)'s chunks: the fewest
    (1 to ``MAX_SHARES``, at most the probe steps) whose waves over
    ``slots`` (CTAs the card holds at once: the plan's CTAs an SM times the
    SMs) are at least nine tenths full."""
    top = max(1, min(MAX_SHARES, n_steps))
    for n in range(1, top + 1):
        waves = ctas * n / slots
        if waves >= 0.9 * math.ceil(waves):
            return n
    return top


def tf32_cut(x: torch.Tensor) -> torch.Tensor:
    """f32 values cut to TF32 as the kernel's product takes them: the low 13
    bits masked off (a truncation toward zero)."""
    return (x.to(torch.float32).contiguous().view(torch.int32)
            & (_TF32_MASK - 2 ** 32)).view(torch.float32)


def _round_up_f32(x64: torch.Tensor) -> torch.Tensor:
    """f64 -> the nearest f32 at or above it."""
    u = x64.to(torch.float32)
    up = torch.nextafter(u, torch.full_like(u, float("inf")))
    return torch.where(u.to(torch.float64) < x64, up, u)


def cut_norms(x: torch.Tensor) -> torch.Tensor:
    """``[n, d]`` -> ``[n]`` f32: each row's norm after :func:`tf32_cut`,
    summed in f64 and rounded up (widened by 2^-40 for f64's own rounding):
    the factors of the filter's bound as the plain mirror takes them (the
    kernel sums and roots them in f32 rounding upward, at least as large)."""
    n = torch.sqrt((tf32_cut(x).to(torch.float64) ** 2).sum(dim=1)) * (1 + 2.0 ** -40)
    return _round_up_f32(n)


@dataclasses.dataclass(frozen=True)
class FilterBound:
    """The filter's error bound at one ``d`` and list dtype (:func:`filter_error`)."""

    kappa: float  # times |q~| |y~|
    eps: float    # what is not relative


@functools.lru_cache(maxsize=None)
def filter_error(d: int, list_dtype: torch.dtype) -> FilterBound:
    """The bound ``|dot_tc - dot| <= kappa |q~| |y~| + eps`` for any query
    ``q`` and row ``y`` of ``d`` dimensions, where ``dot_tc`` is the TF32
    product ``q~ . y~`` of the cut operands (:func:`tf32_cut`) summed in f32
    in any order (the tensor core's), ``dot`` is ``q . y`` summed in f32 in
    any order (the kernel's FMA chain, the plain version's matmul), and
    ``|q~| |y~|`` bounds ``sum |q~_i| |y~_i|`` (Cauchy-Schwarz; the kernel
    sums and roots both norms rounding upward). ``kappa`` counts the
    operands' cut (2^-10 relative for f32 rows and queries; nothing for
    bf16, int8 and uint8 rows, which TF32 holds, nor for the bf16-rounded
    queries of bf16 lists) and both sums' f32 rounding (``2 d 2^-24`` for
    ``dot``, ``8 d8 2^-23`` for the tensor core, ``d8`` = d rounded up to
    the k-step of 8); ``eps`` = ``d8 * 2^-100`` covers what is not
    relative: products that underflow, and subnormal operands (below
    2^-126, cut to a spacing of 2^-136 or flushed to zero) while the other
    operand of their product is below 2^26 in magnitude. Computed in f64,
    ``kappa`` rounded up to f32."""
    u_y = 2.0 ** -10 if list_dtype == torch.float32 else 0.0
    u_q = 0.0 if list_dtype == torch.bfloat16 else 2.0 ** -10
    d8 = round_up(d, 8)
    kappa = ((u_q + u_y) * (1 + 2.0 ** -8) + 2 * d * 2.0 ** -24 * (1 + 2.0 ** -8)
             + _ERROR_C * d8 * 2.0 ** -23)
    k32 = np.float32(kappa)
    if float(k32) < kappa:
        k32 = np.nextafter(k32, np.float32(np.inf))
    return FilterBound(kappa=float(k32), eps=d8 * 2.0 ** -100)


def dot_upper_bound(dot_tc, q_norm, y_norm, bound: FilterBound) -> torch.Tensor:
    """``dot_tc + kappa * q_norm * y_norm + eps`` rounded up to f32 (the
    kernel's ``__fadd_ru(dot, __fmaf_ru(kappa, __fmul_ru(|q~|, |y~|),
    eps))``; here summed in f64, then rounded up): no smaller than the
    exact dot. ``q_norm [nq, 1]`` and ``y_norm [1, rows]``: the cut
    operands' norms or bounds of them."""
    x = (dot_tc.to(torch.float64) + bound.kappa * q_norm.to(torch.float64)
         * y_norm.to(torch.float64) + bound.eps)
    return _round_up_f32(x)


def score_epilogue(ln, dot, metric: DistanceType) -> torch.Tensor:
    """The kernel's epilogue of a dot product, without the cosine validity
    (``ln - 2 dot``, ``ln - dot``, ``-dot * ln``); at an upper bound of the
    dot it is a lower bound of the score."""
    if metric in (DistanceType.L2Expanded, DistanceType.L2SqrtExpanded):
        return ln - 2.0 * dot
    if metric == DistanceType.InnerProduct:
        return ln - dot
    return -dot * ln


def chunk_table(list_indices, rows: int = ROWS_PER_CHUNK) -> torch.Tensor:
    """``[n_units, cdiv(gm, rows)]`` bool: where a ``rows``-row chunk of a
    unit holds a filled slot (``list_indices >= 0``; the prefilter is
    folded in)."""
    n_units = list_indices.shape[0]
    valid = list_indices.reshape(n_units, -1) >= 0
    pad = cdiv(valid.shape[1], rows) * rows - valid.shape[1]
    if pad:
        valid = torch.nn.functional.pad(valid, (0, pad))
    return valid.reshape(n_units, -1, rows).any(dim=2)


def work_list(tile_probes, probe_valid, chunks, n_split: int = 1
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each tile's chunks to score, as the kernels take them: ``(work,
    n_work)``, int32 ``[n_qt, P * n_chunks]`` with each tile's ``n_work``
    chunks that hold a valid slot (``chunks [n_units, n_chunks]``) of its
    valid probe steps first, as entries ``unit * n_chunks + chunk``. The
    ``n_split`` CTAs that share a (tile, query group) take equal runs of
    them, so the steps are dealt out in turn (step ``j`` to run ``j %
    n_split``, in step order within a run): a tile's queries find most of
    their neighbours in a few adjacent units, which one run would otherwise
    hold alone, with most of the candidates. Computed on the tables' device
    without a sync."""
    n_qt, P = tile_probes.shape
    n_chunks = chunks.shape[1]
    tp = tile_probes.to(torch.int64)
    has = ((probe_valid > 0)[:, :, None] & chunks[tp]).reshape(n_qt, -1)
    steps = torch.arange(P, device=tp.device)
    rank = (((steps % n_split) * P + steps)[:, None] * n_chunks
            + torch.arange(n_chunks, device=tp.device))
    key = torch.where(has, rank.reshape(1, -1), n_split * P * n_chunks + rank.reshape(1, -1))
    order = torch.argsort(key, dim=1)
    entry = (tp[:, :, None] * n_chunks
             + torch.arange(n_chunks, device=tp.device)).reshape(n_qt, -1)
    return (torch.gather(entry, 1, order).to(torch.int32), has.sum(dim=1, dtype=torch.int32))


def tiles_per_group(qt: int, n_qt: int, queries_per_cta: int) -> int:
    """Tiles whose queries share one CTA and the union of their chunks, so
    that a chunk that several of them probe is staged once: as many as a
    CTA of ``queries_per_cta`` holds whole (1 to 32, at most ``n_qt``)."""
    return max(1, min(32, n_qt, queries_per_cta // qt))


def launch_plan(d: int, k: int, itemsize: int, qt: int, n_qt: int, cosine: bool = False
                ) -> Tuple[CtaPlan, int]:
    """The CTA plan (:func:`cta_plan`) for up to 128 of the call's queries,
    and the tiles a CTA takes together (:func:`tiles_per_group`)."""
    plan = cta_plan(d, k, itemsize, min(qt * n_qt, QUERIES_PER_CTA[0]), cosine)
    return plan, tiles_per_group(qt, n_qt, plan.queries)


def group_tables(tile_probes, probe_valid, n_units: int, G: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The tables of the groups of ``G`` tiles the kernel scans together:
    ``(probes, valid, unit_mask)``, ``[cdiv(n_qt, G), n_units]`` int32 each:
    every unit as a probe step, valid where a tile of the group lists it
    among its valid steps, and the bits of those tiles (bit ``j`` = tile
    ``group * G + j``). A tile lists a unit at most once among its valid
    steps, and its invalid steps add nothing, so the bits add up. Computed
    on the tables' device without a sync."""
    n_qt, P = tile_probes.shape
    n_groups = cdiv(n_qt, G)
    dev = tile_probes.device
    tile = torch.arange(n_qt, device=dev)[:, None].expand(n_qt, P)
    at = ((tile // G) * n_units + tile_probes.to(torch.int64)).reshape(-1)
    bits = torch.where(probe_valid > 0, torch.ones_like(tile) << (tile % G),
                       torch.zeros_like(tile)).reshape(-1)
    mask = torch.zeros(n_groups * n_units, dtype=torch.int64, device=dev).scatter_add_(0, at, bits)
    mask = mask.reshape(n_groups, n_units).to(torch.int32)
    probes = torch.arange(n_units, dtype=torch.int32, device=dev).expand(n_groups, n_units)
    return probes.contiguous(), (mask != 0).to(torch.int32), mask


def prepare_epilogue(list_norms, list_indices, metric: DistanceType) -> torch.Tensor:
    """The per-slot term the scan adds to the dot product
    (``ivf_scan.py:390-398``): L2 -> squared norm with +inf on invalid
    slots; IP -> 0/+inf penalty; cosine -> rsqrt norm scale (validity is
    read from ``list_indices`` inside)."""
    valid = list_indices >= 0
    if list_norms is None:
        list_norms = torch.zeros(list_indices.shape, dtype=torch.float32, device=list_indices.device)
    inf = torch.full(list_indices.shape, float("inf"), dtype=torch.float32, device=list_indices.device)
    if metric in (DistanceType.L2Expanded, DistanceType.L2SqrtExpanded):
        return torch.where(valid, list_norms.to(torch.float32), inf)
    if metric == DistanceType.InnerProduct:
        return torch.where(valid, torch.zeros_like(inf), inf)
    return torch.rsqrt(torch.clamp(list_norms.to(torch.float32), min=1e-24))


def _check_args(list_data, list_indices, queries_sorted, tile_probes, probe_valid, k, metric, qt):
    expects(metric in SUPPORTED, "fused_list_topk: unsupported metric %s", metric)
    expects(1 <= k <= MAX_K, "fused_list_topk: k=%d outside [1, %d]", k, MAX_K)
    expects(list_data.ndim == 3, "list_data must be [n_units, gm, d]")
    n_units, gm, d = list_data.shape
    expects(tuple(list_indices.shape) == (n_units, gm), "list_indices must be [n_units, gm]")
    n_qt, _ = tile_probes.shape
    expects(queries_sorted.shape == (n_qt * qt, d), "queries_sorted must be [n_qt * qt, d]")
    expects(tile_probes.shape == probe_valid.shape, "tile_probes/probe_valid shape mismatch")


def kernel_queries(queries_sorted, list_data) -> torch.Tensor:
    """The f32 queries the scan multiplies: rounded to bf16 and back when
    the lists are bf16 (``ivf_scan.py:215-217``)."""
    q = queries_sorted.to(torch.float32)
    if list_data.dtype == torch.bfloat16:
        q = q.to(torch.bfloat16).to(torch.float32)
    return q


def _tile_scores(list_data, ln, list_indices, queries, units, i, *, qt: int,
                 metric: DistanceType):
    """The plain version's scores of query tile ``i`` against every slot of
    its sorted valid ``units``: ``(y [slots, d] f32, score [qt, slots])``."""
    d = list_data.shape[2]
    q = queries[i * qt : (i + 1) * qt]
    ud = units.to(queries.device)
    y = list_data[ud].reshape(-1, d).to(torch.float32)
    dot = q @ y.T
    score = score_epilogue(ln[ud].reshape(-1)[None, :], dot, metric)
    if metric == DistanceType.CosineExpanded:
        ok = (list_indices[ud].reshape(-1) >= 0)[None, :]
        score = torch.where(ok, score, torch.full_like(dot, float("inf")))
    return y, score


def fused_list_topk_reference(
    list_data, list_norms, list_indices, queries_sorted, tile_probes, probe_valid,
    *, k: int, metric: DistanceType, qt: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: per query tile, the scores of
    every slot of the valid units in ascending slot order, then a stable
    top-k. Returns ``(scores [nq_pad, k] asc, slots [nq_pad, k] i32)``."""
    _check_args(list_data, list_indices, queries_sorted, tile_probes, probe_valid, k, metric, qt)
    n_units, gm, d = list_data.shape
    ln = prepare_epilogue(list_norms, list_indices, metric)
    queries = kernel_queries(queries_sorted, list_data)
    dev = queries_sorted.device
    nq_pad = queries_sorted.shape[0]
    out_v = torch.full((nq_pad, k), float("inf"), dtype=torch.float32, device=dev)
    out_s = torch.full((nq_pad, k), -1, dtype=torch.int32, device=dev)
    tp = tile_probes.cpu()
    pv = probe_valid.cpu()
    rows = torch.arange(gm, dtype=torch.int64)
    for i in range(tp.shape[0]):
        units = torch.sort(tp[i][pv[i] > 0].to(torch.int64)).values
        if units.numel() == 0:
            continue
        _, score = _tile_scores(list_data, ln, list_indices, queries, units, i, qt=qt,
                                metric=metric)
        slots = (units[:, None] * gm + rows[None, :]).reshape(-1).to(dev)
        kk = min(k, score.shape[1])
        v, pos = select_k(score, kk)
        s = torch.where(torch.isinf(v), torch.full_like(pos, -1), slots[pos.to(torch.int64)].to(torch.int32))
        out_v[i * qt : (i + 1) * qt, :kk] = v
        out_s[i * qt : (i + 1) * qt, :kk] = s
    return out_v, out_s


def _lex_topk(v, s, k: int):
    """The k lexicographically smallest ``(score, slot)`` pairs of ``v, s``
    along the last dimension (a list's entries and candidates)."""
    order = torch.argsort(s, dim=-1, stable=True)
    order = torch.gather(order, -1, torch.argsort(torch.gather(v, -1, order), dim=-1, stable=True))
    return torch.gather(v, -1, order[..., :k]), torch.gather(s, -1, order[..., :k])


def fused_list_topk_filtered_reference(
    list_data, list_norms, list_indices, queries_sorted, tile_probes, probe_valid,
    *, k: int, metric: DistanceType, qt: int, n_split: int = 1,
    plan: Optional[Tuple[CtaPlan, int]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch mirror of the kernel's schedule: per group of ``G``
    tiles (:func:`launch_plan`; ``plan`` = ``(CtaPlan, G)`` overrides it),
    share of ``n_split`` of the group's listed 64-row chunks
    (:func:`group_tables`, :func:`work_list`) and query group of
    ``plan.queries``, the chunks in order; for the queries whose tile lists
    the chunk's unit, the TF32 product of the cut operands (``torch.matmul``,
    in its own order), the lower bound
    (:func:`filter_error`, :func:`cut_norms`, :func:`dot_upper_bound`,
    :func:`score_epilogue`) against each query's current k-th score (the
    smaller of its list's and
    the smallest any share has reached), and each chunk's candidates merged
    (lexicographic ``(score, slot)``) with their exact scores, computed as
    the plain version computes them; then the shares' lists merged. Its
    result is :func:`fused_list_topk_reference`'s bit for bit."""
    _check_args(list_data, list_indices, queries_sorted, tile_probes, probe_valid, k, metric, qt)
    n_units, gm, d = list_data.shape
    n_qt = tile_probes.shape[0]
    cta, G = plan or launch_plan(d, k, list_data.element_size(), qt, n_qt,
                                 metric == DistanceType.CosineExpanded)
    qb = cta.queries
    ln = prepare_epilogue(list_norms, list_indices, metric)
    queries = kernel_queries(queries_sorted, list_data)
    dev = queries.device
    nq_pad = queries.shape[0]
    bound = filter_error(d, list_data.dtype)
    tp, pv = tile_probes.cpu(), probe_valid.cpu()
    if G > 1:
        probes, valid_steps, _ = group_tables(tp, pv, n_units, G)
    else:
        probes, valid_steps = tp, pv
    work, n_work = work_list(probes, valid_steps, chunk_table(list_indices.cpu()), n_split)
    n_chunks = cdiv(gm, ROWS_PER_CHUNK)
    inf = float("inf")
    valid = (list_indices >= 0) if metric == DistanceType.CosineExpanded else torch.isfinite(ln)
    shared_kth = torch.full((nq_pad,), inf, dtype=torch.float32, device=dev)
    part_v = torch.full((n_split, nq_pad, k), inf, dtype=torch.float32, device=dev)
    part_s = torch.full((n_split, nq_pad, k), _SLOT_EMPTY, dtype=torch.int64, device=dev)
    # per tile: its exact scores and lower bounds over its units' slots, and
    # where each of its units' slots start among them
    exact, lower, col = {}, {}, {}
    for t in range(n_qt):
        units = torch.sort(tp[t][pv[t] > 0].to(torch.int64)).values
        y, exact[t] = _tile_scores(list_data, ln, list_indices, queries, units, t, qt=qt,
                                   metric=metric)
        q = queries[t * qt : (t + 1) * qt]
        lower[t] = score_epilogue(ln[units.to(dev)].reshape(1, -1), dot_upper_bound(
            tf32_cut(q) @ tf32_cut(y).T, cut_norms(q)[:, None], cut_norms(y)[None, :], bound),
            metric)
        col[t] = {int(u): j * gm for j, u in enumerate(units)}
    for g in range(work.shape[0]):
        nw = int(n_work[g])
        tiles = range(g * G, min(n_qt, g * G + G))
        for split in range(n_split):
            share = work[g, nw * split // n_split: nw * (split + 1) // n_split].tolist()
            for q0 in range(0, len(tiles) * qt, qb):
                rows_q = torch.arange(g * G * qt + q0, g * G * qt + min(len(tiles) * qt, q0 + qb),
                                      device=dev)
                lv = torch.full((len(rows_q), k), inf, dtype=torch.float32, device=dev)
                ls = torch.full((len(rows_q), k), _SLOT_EMPTY, dtype=torch.int64, device=dev)
                for entry in share:
                    u, c = divmod(entry, n_chunks)
                    r = torch.arange(c * ROWS_PER_CHUNK, min(gm, (c + 1) * ROWS_PER_CHUNK),
                                     device=dev)
                    kth = torch.minimum(lv[:, k - 1], shared_kth[rows_q])
                    cand_v = torch.full((len(rows_q), len(r)), inf, dtype=torch.float32,
                                        device=dev)
                    for t in tiles:
                        if u not in col[t]:
                            continue  # the query's tile does not list the unit
                        at = (rows_q // qt == t).nonzero().flatten()
                        if at.numel() == 0:
                            continue
                        qi = rows_q[at] - t * qt
                        cols = col[t][u] + r
                        passed = valid[u, r][None, :] & ~(lower[t][qi][:, cols] > kth[at, None])
                        cand_v[at] = torch.where(passed, exact[t][qi][:, cols],
                                                 torch.full_like(passed, inf, dtype=torch.float32))
                    cand_s = (u * gm + r)[None, :].expand(len(rows_q), -1)
                    lv, ls = _lex_topk(torch.cat([lv, cand_v], 1), torch.cat([ls, cand_s], 1), k)
                    ls = torch.where(lv < inf, ls, torch.full_like(ls, _SLOT_EMPTY))
                    # a list's k-th score bounds the query's final one: shared with the other shares
                    shared_kth[rows_q] = torch.minimum(shared_kth[rows_q], lv[:, k - 1])
                part_v[split, rows_q] = lv
                part_s[split, rows_q] = ls
    # the shares hold disjoint slots: their lists' lexicographic k smallest
    out_v, out_s = _lex_topk(part_v.permute(1, 0, 2).reshape(nq_pad, -1),
                             part_s.permute(1, 0, 2).reshape(nq_pad, -1), k)
    out_s = torch.where((out_s == _SLOT_EMPTY) | ~(out_v < inf), -1, out_s)
    return out_v, out_s.to(torch.int32)


def fused_list_topk(
    list_data,
    list_norms,
    list_indices,
    queries_sorted,
    tile_probes,
    probe_valid,
    *,
    k: int,
    metric: DistanceType,
    qt: int,
    merge: str = "exact",
    precision: str = "highest",
    n_split: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the fused probed-list scan.

    ``list_data [n_units, gm, d]`` (f32/bf16/int8/uint8), ``list_norms``
    and ``list_indices [n_units, gm]``, ``queries_sorted [nq_pad, d]`` with
    ``nq_pad = n_qt * qt``, ``tile_probes/probe_valid [n_qt, P]`` int32.
    Returns ``(scores [nq_pad, k] asc, slots [nq_pad, k] i32)`` where
    slot = ``unit * gm + row`` (or -1). ``merge`` and ``precision`` are
    accepted for the JAX signature; the result is always the exact f32
    top-k. CUDA tensors launch the kernel (``fused_list_topk.launches``
    counts the launches); CPU tensors take the plain version.

    ``n_split``: CTAs that share one tile's chunks (1-32; None = the fewest
    that fill the card's waves, :func:`default_split`). It changes the
    speed, never the result."""
    if queries_sorted.device.type != "cuda":
        return fused_list_topk_reference(
            list_data, list_norms, list_indices, queries_sorted, tile_probes, probe_valid,
            k=k, metric=metric, qt=qt,
        )
    out_v, out_s, _ = _launch(list_data, list_norms, list_indices, queries_sorted, tile_probes,
                              probe_valid, k=k, metric=metric, qt=qt, n_split=n_split)
    return out_v, out_s


fused_list_topk.launches = 0
fused_list_topk.last_grid = None  # (query groups, tile groups, shares) of the last launch


def fused_list_topk_stages(list_data, list_norms, list_indices, queries_sorted, tile_probes,
                           probe_valid, *, k: int, metric: DistanceType, qt: int,
                           n_split: Optional[int] = None) -> torch.Tensor:
    """One launch of the kernel with its stage clock on (CUDA tensors
    only): int64 ``[CTAs, len(STAGES) + 2 + len(COUNTS)]``, per CTA the
    cycles of each stage summed over its warps, the warps' and the CTA's
    own cycles, the chunks it scanned and the candidates that passed its
    filter."""
    expects(queries_sorted.device.type == "cuda",
            "fused_list_topk_stages: the stage clock runs on the card")
    return _launch(list_data, list_norms, list_indices, queries_sorted, tile_probes, probe_valid,
                   k=k, metric=metric, qt=qt, n_split=n_split, record="stages")[2]


def fused_list_topk_check(list_data, list_norms, list_indices, queries_sorted, tile_probes,
                          probe_valid, *, k: int, metric: DistanceType, qt: int,
                          n_split: Optional[int] = None):
    """One launch of the kernel's checking instantiation (CUDA tensors
    only), whose filter lets every filled row through and which computes
    every exact score beside its lower bound: returns ``(scores, slots,
    counts)``, the result as :func:`fused_list_topk` gives it and the sums
    over the CTAs of ``CHECK_COUNTS``: rows whose exact score is below
    their lower bound (the filter is safe when there are none), rows the
    filter would pass, and (query, filled row) pairs scored."""
    expects(queries_sorted.device.type == "cuda",
            "fused_list_topk_check: the check runs on the card")
    out_v, out_s, rec = _launch(list_data, list_norms, list_indices, queries_sorted, tile_probes,
                                probe_valid, k=k, metric=metric, qt=qt, n_split=n_split,
                                record="check")
    return out_v, out_s, dict(zip(CHECK_COUNTS, rec.sum(dim=0).tolist()))


def _launch(list_data, list_norms, list_indices, queries_sorted, tile_probes, probe_valid, *,
            k: int, metric: DistanceType, qt: int, n_split: Optional[int],
            record: Optional[str] = None):
    """Launch ``csrc/ivf_scan.cu`` on CUDA tensors; raises if it cannot be
    built or launched. Returns ``(scores, slots, record)``: with
    ``record="stages"`` the stage clock's, with ``"check"`` the checking
    instantiation's counts, else None."""
    _check_args(list_data, list_indices, queries_sorted, tile_probes, probe_valid, k, metric, qt)
    expects(list_data.dtype in _DTYPE_CODE, "fused_list_topk: unsupported list dtype %s", list_data.dtype)
    n_units, gm, d = list_data.shape
    n_qt, n_steps = tile_probes.shape
    expects(n_qt <= 65535, "fused_list_topk: %d query tiles exceed the grid limit", n_qt)
    dev = queries_sorted.device
    for name, t in (("list_data", list_data), ("list_indices", list_indices),
                    ("tile_probes", tile_probes), ("probe_valid", probe_valid)):
        expects(t.device == dev, "fused_list_topk: %s is on %s, queries on %s", name, t.device, dev)
    plan, G = launch_plan(d, k, list_data.element_size(), qt, n_qt,
                          metric == DistanceType.CosineExpanded)
    n_groups = cdiv(n_qt, G)
    q_groups = cdiv(G * qt, plan.queries)
    if G > 1:
        probes, valid, unit_mask = group_tables(tile_probes, probe_valid, n_units, G)
    else:
        probes, valid = tile_probes, probe_valid
    if n_split is None:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        n_split = default_split(q_groups * n_groups, probes.shape[1], plan.ctas_per_sm * sms)
    expects(1 <= n_split <= MAX_SHARES, "fused_list_topk: n_split=%d outside [1, %d]", n_split,
            MAX_SHARES)
    # the kernel stages spans of these from 16-byte aligned addresses
    ld, ln, li = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (
        list_data.contiguous(), prepare_epilogue(list_norms, list_indices, metric).contiguous(),
        list_indices.to(torch.int32).contiguous()))
    q = kernel_queries(queries_sorted, list_data).contiguous()
    chunks = chunk_table(li)
    work, n_work = work_list(probes, valid, chunks, n_split)
    work_mask = None
    if G > 1:  # each entry's tile bits, beside it
        work_mask = torch.gather(unit_mask, 1, (work // chunks.shape[1]).to(torch.int64))
    bound = filter_error(d, list_data.dtype)
    kth_key = torch.full((n_qt * qt,), _INF_KEY, dtype=torch.int32, device=dev)
    out_v = torch.empty((n_qt * qt, k), dtype=torch.float32, device=dev)
    out_s = torch.empty((n_qt * qt, k), dtype=torch.int32, device=dev)
    # the shares' partial lists, and past MAX_SPLIT shares the first folds'
    n_part = n_split + (cdiv(n_split, MAX_SPLIT) if n_split > MAX_SPLIT else 0)
    part = (n_part, n_qt * qt, k) if n_split > 1 else (0,)
    part_v = torch.empty(part, dtype=torch.float32, device=dev)
    part_s = torch.empty(part, dtype=torch.int32, device=dev)
    ctas = q_groups * n_groups * n_split
    rec = None
    if record == "stages":
        rec = torch.zeros((ctas, len(STAGES) + 2 + len(COUNTS)), dtype=torch.int64, device=dev)
    elif record == "check":
        rec = torch.zeros((ctas, len(CHECK_COUNTS)), dtype=torch.int64, device=dev)
    lib, _, _ = build_kernel()
    smem = lib.ivf_scan_smem_bytes(plan.queries, d, k, ld.element_size(), int(plan.qglobal),
                                   _METRIC_CODE[metric], plan.staged)
    if smem != plan.smem_bytes:
        raise RaftError(f"ivf_scan.cu asks {smem} B of shared memory for {plan}, the wrapper "
                        f"counted {plan.smem_bytes}")
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.ivf_scan_fused_list_topk(
        ld.data_ptr(), _DTYPE_CODE[ld.dtype], ln.data_ptr(), li.data_ptr(), q.data_ptr(),
        work.data_ptr(), n_work.data_ptr(),
        work_mask.data_ptr() if work_mask is not None else None, kth_key.data_ptr(),
        out_v.data_ptr(), out_s.data_ptr(), part_v.data_ptr(), part_s.data_ptr(),
        rec.data_ptr() if record == "stages" else None,
        rec.data_ptr() if record == "check" else None,
        n_split, n_qt, gm, d, qt, G, work.shape[1], k, _METRIC_CODE[metric],
        plan.queries, int(plan.qglobal), plan.staged, bound.kappa, bound.eps, stream,
    )
    check_cuda(err, "ivf_scan kernel launch")
    fused_list_topk.launches += 1
    fused_list_topk.last_grid = (q_groups, n_groups, n_split)
    return out_v, out_s, rec


# ---------------------------------------------------------------------------
# probe-table construction
# ---------------------------------------------------------------------------


def build_tile_probe_tables(
    coarse, probed, center_rank, *, nq: int, qt: int, n_lists: int,
    group: int, n_probes: int, probe_factor: int
):
    """Tile-coherent query ordering + per-tile union probe tables, equal to
    the JAX package's. Returns ``(order_pad [nq_pad], tile_probes [n_qt, P],
    probe_valid [n_qt, P])`` int32; probe units are ``group`` adjacent
    lists, valid units ascend, and invalid slots re-address the row's last
    valid unit."""
    dev = coarse.device
    top1 = torch.argmin(coarse, dim=1)
    order = torch.argsort(center_rank.to(dev)[top1], stable=True)

    n_qt = cdiv(nq, qt)
    nq_pad = n_qt * qt
    if nq_pad != nq:
        order_pad = torch.cat([order, order[:1].expand(nq_pad - nq)])
    else:
        order_pad = order
    row_real = (torch.arange(nq_pad, device=dev) < nq)[:, None]
    probed_sorted = probed[order_pad] & row_real

    expects(n_lists % group == 0, "n_lists %d not divisible by group %d", n_lists, group)
    n_units = n_lists // group
    probed_u = probed_sorted.reshape(nq_pad, n_units, group).any(dim=2)
    p = min(n_units, max(cdiv(probe_factor * n_probes, group), cdiv(n_probes, group)))
    counts = torch.sum(probed_u.reshape(n_qt, qt, n_units).to(torch.int32), dim=1)
    cvals, tile_probes = select_k(counts, p, select_min=False)
    probe_valid = (cvals > 0).to(torch.int32)
    sort_key = torch.where(probe_valid > 0, tile_probes, torch.full_like(tile_probes, n_units))
    probe_order = torch.argsort(sort_key, dim=1, stable=True)
    tile_probes = torch.gather(tile_probes, 1, probe_order)
    probe_valid = torch.gather(probe_valid, 1, probe_order)
    last_valid = torch.max(
        torch.where(probe_valid > 0, tile_probes, torch.zeros_like(tile_probes)), dim=1, keepdim=True
    ).values
    tile_probes = torch.where(probe_valid > 0, tile_probes, last_valid).to(torch.int32)
    return order_pad.to(torch.int32), tile_probes, probe_valid


# ---------------------------------------------------------------------------
# full search wrapper
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FusedInputs:
    """What one fused search hands the kernel: the ``group``-list unit
    view of the lists (``list_indices`` with the prefilter folded in), the
    tile-sorted queries, the tile probe tables and the query order; and
    each query's own probed lists, which the tables were built from."""

    list_data: torch.Tensor  # [n_units, gm, d]
    list_norms: Optional[torch.Tensor]  # [n_units, gm]
    list_indices: torch.Tensor  # [n_units, gm], -1 = empty or filtered
    queries_sorted: torch.Tensor  # [nq_pad, d] f32
    tile_probes: torch.Tensor  # [n_qt, P] i32
    probe_valid: torch.Tensor  # [n_qt, P] i32
    order_pad: torch.Tensor  # [nq_pad] i32
    probed: torch.Tensor  # [nq, n_lists] bool, in the queries' order


def fused_search_inputs(
    centers, center_rank, list_data, list_indices, list_norms, queries,
    filter_bits: Optional[torch.Tensor], *, n_probes: int, metric: DistanceType,
    qt: int, probe_factor: int, group: int,
) -> FusedInputs:
    """Coarse probe selection, tile tables and the prefilter fold
    (``ivf_scan.py:520-556``). ``filter_bits`` is a prefilter bitset's
    int32 words (None = no filter)."""
    from raft_tpu_torch.neighbors.ivf_common import probe_selection

    nq, d = queries.shape
    n_lists, m, _ = list_data.shape
    qf = queries.to(torch.float32)
    if metric == DistanceType.CosineExpanded:
        qf = normalize_rows(qf)
    coarse, probed = probe_selection(centers, qf, n_probes, metric)
    order_pad, tile_probes, probe_valid = build_tile_probe_tables(
        coarse, probed, center_rank, nq=nq, qt=qt, n_lists=n_lists,
        group=group, n_probes=n_probes, probe_factor=probe_factor,
    )
    li_eff = list_indices
    if filter_bits is not None:
        ids = torch.clamp(list_indices, min=0).to(torch.int64)
        word = filter_bits[ids // 32]
        bit = (word >> (ids % 32).to(torch.int32)) & 1
        li_eff = torch.where((bit == 1) & (list_indices >= 0), list_indices,
                             torch.full_like(list_indices, -1))
    n_units = n_lists // group
    gm = group * m
    return FusedInputs(
        list_data=list_data.reshape(n_units, gm, d),
        list_norms=list_norms.reshape(n_units, gm) if list_norms is not None else None,
        list_indices=li_eff.reshape(n_units, gm),
        queries_sorted=qf[order_pad.to(torch.int64)],
        tile_probes=tile_probes,
        probe_valid=probe_valid,
        order_pad=order_pad,
        probed=probed,
    )


def fused_counts(fi: FusedInputs, list_indices, *, qt: int) -> Dict[str, torch.Tensor]:
    """The work of one fused search, as 0-d int64 tensors on the tables'
    device, computed there without a host read. ``list_indices`` is the
    index's ``[n_lists, max_list]`` (-1 = empty slot).

    * ``pairs_probed``: (query row, filled row) pairs of each query row's
      own ``n_probes`` lists, ``probed`` times the lists' sizes.
    * ``pairs_scanned``: (query slot, row slot) pairs the kernel's product
      covers: for each tile, ``qt`` times ``ROWS_PER_CHUNK`` times its
      valid units' chunks that hold a filled slot (:func:`chunk_table`);
      with one tile a group, ``qt * n_work * ROWS_PER_CHUNK`` summed over
      the tiles (:func:`work_list`).
    * ``probes_dropped``: (query row, probed list) pairs whose unit the
      row's tile did not keep among its ``P`` probe steps: above 0, the
      probe budget (``probe_factor``) cuts probes.

    Every row handed to the search counts, the zero rows that pad the
    tail batch of :func:`raft_tpu_torch.neighbors.ivf_flat.search`
    included: the kernel scans them."""
    probed = fi.probed
    nq, n_lists = probed.shape
    n_qt = fi.tile_probes.shape[0]
    n_units = fi.list_indices.shape[0]
    dev = probed.device
    sizes = (list_indices.reshape(n_lists, -1) >= 0).sum(dim=1)
    pairs_probed = (probed.sum(dim=0, dtype=torch.int64) * sizes).sum()
    # a tile lists a unit at most once among its valid steps
    kept = torch.zeros((n_qt, n_units), dtype=torch.int32, device=dev).scatter_add_(
        1, fi.tile_probes.to(torch.int64), fi.probe_valid) > 0
    filled_chunks = chunk_table(fi.list_indices).sum(dim=1)
    pairs_scanned = (kept * filled_chunks).sum() * (qt * ROWS_PER_CHUNK)
    tile = torch.arange(nq, device=dev) // qt
    by_tile = torch.zeros((n_qt, n_lists), dtype=torch.int32, device=dev).index_add_(
        0, tile, probed[fi.order_pad[:nq].to(torch.int64)].to(torch.int32))
    probes_dropped = (by_tile.reshape(n_qt, n_units, -1).sum(dim=2) * ~kept).sum()
    return {"pairs_probed": pairs_probed, "pairs_scanned": pairs_scanned,
            "probes_dropped": probes_dropped}


def ivf_flat_fused_search(
    centers,
    center_rank,
    list_data,
    list_indices,
    list_norms,
    queries,
    filter_bits: Optional[torch.Tensor],
    *,
    k: int,
    n_probes: int,
    metric: DistanceType,
    qt: int = 64,
    probe_factor: int = 4,
    group: int = 1,
    merge: str = "exact",
    precision: str = "highest",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """IVF-Flat search through the fused scan: :func:`fused_search_inputs`,
    :func:`fused_list_topk` over ``group``-list units, post-processing and
    unsort (``ivf_scan.py:486-593``). Returns ``(distances [nq, k] f32,
    indices [nq, k] i32)``.

    With :mod:`raft_tpu_torch.obs` on, the three steps run in the spans
    ``ivf_flat.search.tables``, ``.scan`` and ``.unsort``, which do not
    wait for the device, and :func:`fused_counts` is observed on the
    device as ``ivf_flat.fused.pairs_probed``, ``.pairs_scanned`` and
    ``.probes_dropped``."""
    nq = queries.shape[0]
    with obs.span("ivf_flat.search.tables"):
        fi = fused_search_inputs(
            centers, center_rank, list_data, list_indices, list_norms, queries, filter_bits,
            n_probes=n_probes, metric=metric, qt=qt, probe_factor=probe_factor, group=group,
        )
    with obs.span("ivf_flat.search.scan"):
        vals, slots = fused_list_topk(
            fi.list_data, fi.list_norms, fi.list_indices, fi.queries_sorted,
            fi.tile_probes, fi.probe_valid, k=k, metric=metric, qt=qt,
            merge=merge, precision=precision,
        )
    if obs.is_enabled():  # after the launch: enqueued while the kernel runs
        for name, value in fused_counts(fi, list_indices, qt=qt).items():
            obs.observe_device(f"ivf_flat.fused.{name}", value)
    with obs.span("ivf_flat.search.unsort"):
        qs = fi.queries_sorted
        flat_ids = list_indices.reshape(-1)
        sl = slots.to(torch.int64)
        idx = torch.where(slots >= 0, flat_ids[torch.clamp(sl, min=0)], torch.full_like(slots, -1))
        inf = torch.full_like(vals, float("inf"))
        if metric == DistanceType.InnerProduct:
            out = -vals
        elif metric == DistanceType.CosineExpanded:
            out = torch.where(idx >= 0, 1.0 + vals, inf)
        else:
            qn = torch.sum(qs * qs, dim=1)
            out = torch.clamp(qn[:, None] + vals, min=0.0)
            if metric == DistanceType.L2SqrtExpanded:
                out = torch.sqrt(out)
            out = torch.where(idx >= 0, out, inf)

        order = fi.order_pad[:nq].to(torch.int64)
        dist = torch.zeros((nq, k), dtype=torch.float32, device=qs.device)
        ind = torch.full((nq, k), -1, dtype=torch.int32, device=qs.device)
        dist[order] = out[:nq]
        ind[order] = idx[:nq].to(torch.int32)
        return dist, ind
