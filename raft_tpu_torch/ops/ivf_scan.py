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
Dot products are f32 without TF32 for every ``precision`` value; int8
and uint8 lists are widened to f32 per element. With bf16 lists the
queries are rounded to bf16 first, as the JAX kernel does for its bf16
matmul (``ivf_scan.py:215-217``); the products of two bf16 values are
exact in f32, so the kernel widens both and accumulates in f32.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.core.errors import RaftError, expects
from raft_tpu_torch.ops.cuda_build import build_library
from raft_tpu_torch.ops.distance import SUPPORTED, DistanceType
from raft_tpu_torch.ops.fused_1nn import normalize_rows
from raft_tpu_torch.ops.select_k import select_k
from raft_tpu_torch.utils.math import cdiv

#: largest k the kernel keeps per query (its top-k lives in shared memory)
MAX_K = 256
#: most CTAs that share one (tile, query group)'s units (``MAX_SPLIT`` in the .cu)
MAX_SPLIT = 32
_QUERIES_PER_CTA = 16  # ``QB`` in the .cu

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
# the kernel: build, plain version, wrapper
# ---------------------------------------------------------------------------

_SIGNATURES = {
    "ivf_scan_fused_list_topk":
        [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [ctypes.c_void_p],
}


def build_kernel(verbose: bool = False) -> Tuple[ctypes.CDLL, float, str]:
    """Build ``csrc/ivf_scan.cu`` for ``sm_90a`` (once per source version)
    and load it; see :func:`raft_tpu_torch.ops.cuda_build.build_library`.
    Returns ``(library, build seconds, compiler output)``."""
    return build_library("ivf_scan.cu", _SIGNATURES, verbose=verbose)


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
        q = queries[i * qt : (i + 1) * qt]
        ud = units.to(dev)
        y = list_data[ud].reshape(-1, d).to(torch.float32)
        dot = q @ y.T
        lt = ln[ud].reshape(-1)[None, :]
        if metric in (DistanceType.L2Expanded, DistanceType.L2SqrtExpanded):
            score = lt - 2.0 * dot
        elif metric == DistanceType.InnerProduct:
            score = lt - dot
        else:
            ok = (list_indices[ud].reshape(-1) >= 0)[None, :]
            score = torch.where(ok, -dot * lt, torch.full_like(dot, float("inf")))
        slots = (units[:, None] * gm + rows[None, :]).reshape(-1).to(dev)
        kk = min(k, score.shape[1])
        v, pos = select_k(score, kk)
        s = torch.where(torch.isinf(v), torch.full_like(pos, -1), slots[pos.to(torch.int64)].to(torch.int32))
        out_v[i * qt : (i + 1) * qt, :kk] = v
        out_s[i * qt : (i + 1) * qt, :kk] = s
    return out_v, out_s


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

    ``n_split``: CTAs that share one tile's units (1-32; None = enough to
    give every SM two CTAs). It changes the speed, never the result."""
    if queries_sorted.device.type != "cuda":
        return fused_list_topk_reference(
            list_data, list_norms, list_indices, queries_sorted, tile_probes, probe_valid,
            k=k, metric=metric, qt=qt,
        )
    _check_args(list_data, list_indices, queries_sorted, tile_probes, probe_valid, k, metric, qt)
    expects(list_data.dtype in _DTYPE_CODE, "fused_list_topk: unsupported list dtype %s", list_data.dtype)
    n_units, gm, d = list_data.shape
    n_qt, n_steps = tile_probes.shape
    expects(n_qt <= 65535, "fused_list_topk: %d query tiles exceed the grid limit", n_qt)
    dev = queries_sorted.device
    for name, t in (("list_data", list_data), ("list_indices", list_indices),
                    ("tile_probes", tile_probes), ("probe_valid", probe_valid)):
        expects(t.device == dev, "fused_list_topk: %s is on %s, queries on %s", name, t.device, dev)
    ln = prepare_epilogue(list_norms, list_indices, metric).contiguous()
    li = list_indices.to(torch.int32).contiguous()
    q = kernel_queries(queries_sorted, list_data).contiguous()
    tp = tile_probes.to(torch.int32).contiguous()
    pv = probe_valid.to(torch.int32).contiguous()
    ld = list_data.contiguous()
    if n_split is None:
        ctas = cdiv(qt, _QUERIES_PER_CTA) * n_qt
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        n_split = min(MAX_SPLIT, n_steps, cdiv(2 * sms, ctas))
    expects(1 <= n_split <= MAX_SPLIT, "fused_list_topk: n_split=%d outside [1, %d]", n_split, MAX_SPLIT)
    out_v = torch.empty((n_qt * qt, k), dtype=torch.float32, device=dev)
    out_s = torch.empty((n_qt * qt, k), dtype=torch.int32, device=dev)
    part = (n_split, n_qt * qt, k) if n_split > 1 else (0,)
    part_v = torch.empty(part, dtype=torch.float32, device=dev)
    part_s = torch.empty(part, dtype=torch.int32, device=dev)
    lib, _, _ = build_kernel()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.ivf_scan_fused_list_topk(
        ld.data_ptr(), _DTYPE_CODE[ld.dtype], ln.data_ptr(), li.data_ptr(), q.data_ptr(),
        tp.data_ptr(), pv.data_ptr(), out_v.data_ptr(), out_s.data_ptr(),
        part_v.data_ptr(), part_s.data_ptr(), n_split,
        n_qt, gm, d, qt, n_steps, k, _METRIC_CODE[metric], stream,
    )
    if err != 0:
        raise RaftError(f"ivf_scan kernel launch failed (cudaError {err})")
    fused_list_topk.launches += 1
    return out_v, out_s


fused_list_topk.launches = 0


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
    tile-sorted queries, the tile probe tables and the query order."""

    list_data: torch.Tensor  # [n_units, gm, d]
    list_norms: Optional[torch.Tensor]  # [n_units, gm]
    list_indices: torch.Tensor  # [n_units, gm], -1 = empty or filtered
    queries_sorted: torch.Tensor  # [nq_pad, d] f32
    tile_probes: torch.Tensor  # [n_qt, P] i32
    probe_valid: torch.Tensor  # [n_qt, P] i32
    order_pad: torch.Tensor  # [nq_pad] i32


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
    )


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
    indices [nq, k] i32)``."""
    nq = queries.shape[0]
    fi = fused_search_inputs(
        centers, center_rank, list_data, list_indices, list_norms, queries, filter_bits,
        n_probes=n_probes, metric=metric, qt=qt, probe_factor=probe_factor, group=group,
    )
    vals, slots = fused_list_topk(
        fi.list_data, fi.list_norms, fi.list_indices, fi.queries_sorted,
        fi.tile_probes, fi.probe_valid, k=k, metric=metric, qt=qt,
        merge=merge, precision=precision,
    )
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
