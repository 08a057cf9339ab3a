"""Fused probed-list ADC scan for IVF-PQ search (``raft_tpu.ops.pallas.pq_scan``
counterpart).

Queries are sorted into probe-coherent tiles and each tile gets a union
table of ``group``-list units, exactly as for IVF-Flat
(:func:`raft_tpu_torch.ops.ivf_scan.build_tile_probe_tables`). Per tile,
:func:`fused_pq_topk` scores every code row of the tile's valid units
against the tile's queries with a per-query lookup table
``W[q, (j, c)] = <q_sub[q, j], books[j, c]>`` (bf16, :func:`pq_lut`) and
keeps each query's exact top-k:

    L2 (L2Expanded, L2SqrtExpanded):  ln[slot] - 2 * (dot + q.c_list)
    IP (InnerProduct):                ln[slot] - dot - q.c_list

where ``dot`` sums the LUT entries of the row's codes in f32 and
``q.c_list = q_rot . c_rot`` is computed per (query, list) from the
rotated queries and centers. ``ln`` is the prepared per-slot term: the
decoded squared norm for L2, 0 for IP, +inf on empty or filtered slots.

Code layouts (``code_mode``): ``"u8"`` one byte per code (column
``j * ksub + code``); ``"nib8"`` additive nibble pairs, byte j = (hi, lo)
read from columns ``j * 32 + hi`` and ``j * 32 + 16 + lo``; ``"p4"``
two 4-bit codes per byte, low nibble = code 2b (column ``b * 32 + lo``),
high nibble = code 2b + 1 (column ``b * 32 + 16 + hi``); ``"b3"``,
``"b5"``, ``"b6"``, ``"b7"`` a little-endian bitstream per row, code j at
bits ``[j * b, (j + 1) * b)`` (column ``j * ksub + code``).

:func:`fused_pq_topk` runs the hand-written Hopper kernel
``raft_tpu_torch/csrc/pq_scan.cu`` on CUDA tensors (it raises if the
kernel cannot be built or launched) and the plain PyTorch version
:func:`fused_pq_topk_reference` on CPU tensors. Both compute the exact
``(score, slot)`` top-k (ties to the lower slot); the JAX ``bank*``
merges approximate it, so any ``merge`` maps to the exact one here. The
TPU kernel's multi-hot matmul decode and its VMEM gates do not apply:
the Hopper kernel reads the LUT from shared memory, so the one limit is
that one query's LUT (``K * 2`` bytes) fits there.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import torch

from raft_tpu_torch.core.errors import RaftError, expects
from raft_tpu_torch.ops.cuda_build import build_library
from raft_tpu_torch.ops.distance import DistanceType
from raft_tpu_torch.ops.ivf_scan import MAX_K, MAX_SPLIT, build_tile_probe_tables
from raft_tpu_torch.ops.select_k import select_k
from raft_tpu_torch.utils.math import cdiv

_SUPPORTED = frozenset({DistanceType.L2Expanded, DistanceType.L2SqrtExpanded, DistanceType.InnerProduct})

#: most queries one CTA holds (``QB_MAX`` in the .cu)
MAX_QUERIES_PER_CTA = 16
#: code rows one CTA scores per step, one per thread (``R`` in the .cu)
_ROWS_PER_CHUNK = 256
#: dynamic shared memory one block may use on an H100 (227 KB)
SMEM_LIMIT_BYTES = 232448
_MODE_CODE = {"u8": 0, "nib8": 1, "p4": 2, "b3": 3, "b5": 5, "b6": 6, "b7": 7}

_SIGNATURES = {
    "pq_scan_fused_pq_topk":
        [ctypes.c_void_p] * 11 + [ctypes.c_int] * 14 + [ctypes.c_void_p],
}


def supported_metric(metric: DistanceType) -> bool:
    return metric in _SUPPORTED


def code_groups(code_mode: str, ksub: int, bpr: int) -> Tuple[int, int]:
    """``(n_groups, gw)``: the LUT's K columns are ``n_groups`` groups of
    ``gw`` — one group per stored byte for u8/nib8/p4, one per code for the
    spanning b3/b5/b6/b7 layouts (``vmem_model.py:55-62``)."""
    if code_mode in ("b3", "b5", "b6", "b7"):
        b = int(code_mode[1:])
        return bpr * 8 // b, ksub
    return bpr, (ksub if code_mode == "u8" else 32)


def build_kernel(verbose: bool = False) -> Tuple[ctypes.CDLL, float, str]:
    """Build ``csrc/pq_scan.cu`` for ``sm_90a`` (once per source version)
    and load it. Returns ``(library, build seconds, compiler output)``."""
    return build_library("pq_scan.cu", _SIGNATURES, verbose=verbose)


def pq_lut(q_rot, books) -> torch.Tensor:
    """Per-query LUT ``W [nq, K]`` bf16, ``W[n, (j, c)] = <q_sub[n, j],
    books[j, c]>``: an f32 product rounded to bf16. ``books [pq_dim_eff,
    ksub_eff, pq_len]`` must already be in the kernel's column order
    (nibble books for nib8)."""
    nq = q_rot.shape[0]
    pq_dim_eff, ksub_eff, pq_len = books.shape
    q_sub = q_rot.to(torch.float32).reshape(nq, pq_dim_eff, pq_len)
    w = torch.einsum("npl,pkl->npk", q_sub, books.to(torch.float32))
    return w.reshape(nq, pq_dim_eff * ksub_eff).to(torch.bfloat16)


def lookup_columns(codes, code_mode: str, ksub: int) -> torch.Tensor:
    """The LUT column of every lookup of each code row, in the order the
    kernel adds them: ``codes [rows, bpr]`` u8 -> ``[rows, n_lookups]``
    int64 (2 lookups per byte for nib8/p4, one per code otherwise)."""
    b = codes.to(torch.int64)
    rows, bpr = b.shape
    dev = b.device
    if code_mode == "u8":
        return torch.arange(bpr, device=dev) * ksub + b
    if code_mode in ("nib8", "p4"):
        hi, lo = b >> 4, b & 15
        first, second = (hi, lo) if code_mode == "nib8" else (lo, hi)
        base = torch.arange(bpr, device=dev) * 32
        return torch.stack([base + first, base + 16 + second], dim=2).reshape(rows, 2 * bpr)
    bits = int(code_mode[1:])
    n_codes = bpr * 8 // bits
    jb = torch.arange(n_codes, device=dev) * bits
    byte, off = jb // 8, jb % 8
    lo = b[:, byte] >> off
    hi = b[:, torch.clamp(byte + 1, max=bpr - 1)] << (8 - off)
    val = torch.where(off + bits > 8, lo | hi, lo) & ((1 << bits) - 1)
    return torch.arange(n_codes, device=dev) * ksub + val


def queries_per_cta(K: int, k: int, g_lists: int) -> int:
    """Queries one CTA holds: up to 16, as many as the 227 KB of shared
    memory allow for their bf16 LUT rows, scores, q.c terms and top-k
    lists. Raises when not even one query's LUT fits."""
    per_query = 2 * K + 4 * _ROWS_PER_CHUNK + 4 * g_lists + 8 * k
    qb = min(MAX_QUERIES_PER_CTA, SMEM_LIMIT_BYTES // per_query)
    expects(qb >= 1, "fused_pq_topk: one query's LUT (%d columns, %d bytes) does not fit the "
            "%d bytes of shared memory", K, 2 * K, SMEM_LIMIT_BYTES)
    return qb


def _check_args(codes, ln, w, q_rot, centers_rot, tile_probes, probe_valid, k, metric, qt,
                code_mode, ksub):
    expects(metric in _SUPPORTED, "fused_pq_topk: unsupported metric %s", metric)
    expects(1 <= k <= MAX_K, "fused_pq_topk: k=%d outside [1, %d]", k, MAX_K)
    expects(code_mode in _MODE_CODE, "fused_pq_topk: unknown code_mode %r", code_mode)
    expects(codes.ndim == 3 and codes.dtype == torch.uint8, "codes must be [n_units, gm, bpr] uint8")
    n_units, gm, bpr = codes.shape
    expects(ln.numel() == n_units * gm, "ln must be [n_units, 1, gm]")
    n_qt, _ = tile_probes.shape
    nq_pad, K = w.shape
    expects(nq_pad == n_qt * qt, "query rows %d != tiles*qt %d", nq_pad, n_qt * qt)
    n_groups, gw = code_groups(code_mode, ksub, bpr)
    expects(K == n_groups * gw, "LUT has %d columns, codes need %d", K, n_groups * gw)
    expects(K % 8 == 0, "fused_pq_topk: LUT width %d is not a multiple of 8", K)
    expects(q_rot.shape[0] == nq_pad, "q_rot must be [nq_pad, rot_dim]")
    expects(centers_rot.ndim == 3 and centers_rot.shape[0] == n_units
            and centers_rot.shape[2] == q_rot.shape[1], "centers_rot must be [n_units, G, rot_dim]")
    expects(gm % centers_rot.shape[1] == 0, "unit rows %d not divisible by G", gm)
    expects(tile_probes.shape == probe_valid.shape, "tile_probes/probe_valid shape mismatch")


def _qc_terms(q, crot) -> torch.Tensor:
    """``q.c`` per (query, unit, list), summed in dimension order as the
    kernels do: ``q [qt, rot_dim]``, ``crot [U, G, rot_dim]`` ->
    ``[qt, U, G]``."""
    acc = torch.zeros((q.shape[0],) + tuple(crot.shape[:2]), dtype=torch.float32, device=q.device)
    for t in range(q.shape[1]):
        acc = acc + q[:, t, None, None] * crot[None, :, :, t]
    return acc


def _tile_units(tile_probes, probe_valid):
    """Per tile, its valid units in ascending order (int64, host)."""
    tp, pv = tile_probes.cpu(), probe_valid.cpu()
    return [torch.sort(tp[i][pv[i] > 0].to(torch.int64)).values for i in range(tp.shape[0])]


def scan_reference(score_block, codes, q_rot, centers_rot, tile_probes, probe_valid, *,
                   k: int, qt: int, rows_per_block: int = 65536):
    """The plain scan shared by the PQ and RaBitQ reference kernels: per
    tile, blocks of its valid units in ascending slot order, scored by
    ``score_block(i, units, qdc_rows)`` ([qt, rows]) and folded into
    an exact top-k. Returns ``(scores [nq_pad, k], slots [nq_pad, k] i32)``."""
    n_units, gm, bpr = codes.shape
    g_lists = centers_rot.shape[1]
    m = gm // g_lists
    dev = q_rot.device
    nq_pad = q_rot.shape[0]
    out_v = torch.full((nq_pad, k), float("inf"), dtype=torch.float32, device=dev)
    out_s = torch.full((nq_pad, k), -1, dtype=torch.int32, device=dev)
    rows_in_unit = torch.arange(gm, dtype=torch.int64, device=dev)
    step = max(1, rows_per_block // gm)
    for i, units in enumerate(_tile_units(tile_probes, probe_valid)):
        if units.numel() == 0:
            continue
        q = q_rot[i * qt : (i + 1) * qt].to(torch.float32)
        acc_v = torch.full((qt, k), float("inf"), dtype=torch.float32, device=dev)
        acc_s = torch.full((qt, k), -1, dtype=torch.int64, device=dev)
        for c0 in range(0, units.numel(), step):
            ud = units[c0 : c0 + step].to(dev)
            qdc = _qc_terms(q, centers_rot[ud].to(torch.float32))  # [qt, U, G]
            qdc_rows = qdc.repeat_interleave(m, dim=2).reshape(qt, -1)
            score = score_block(i, ud, qdc_rows)
            slots = (ud[:, None] * gm + rows_in_unit[None, :]).reshape(-1)
            kk = min(k, score.shape[1])
            v, pos = select_k(score, kk)
            # the block's slots follow every accumulated one: accumulated entries win ties
            acc_v, acc_s = select_k(torch.cat([acc_v, v], dim=1), k,
                                    indices=torch.cat([acc_s, slots[pos.to(torch.int64)]], dim=1))
        out_v[i * qt : (i + 1) * qt] = acc_v
        out_s[i * qt : (i + 1) * qt] = torch.where(torch.isinf(acc_v), -1, acc_s).to(torch.int32)
    return out_v, out_s


def fused_pq_topk_reference(
    codes, ln, w, q_rot, centers_rot, tile_probes, probe_valid,
    *, k: int, metric: DistanceType, qt: int, merge: str = "bank8", code_mode: str = "u8",
    ksub: int = 16, extract_every: int = 0, decode_cols: int = 2048,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel, with its arithmetic order: the
    LUT entries of a row summed in lookup order in f32, ``q.c`` summed in
    dimension order, the epilogue in the kernel's order. Returns
    ``(scores [nq_pad, k] asc, slots [nq_pad, k] i32)``."""
    _check_args(codes, ln, w, q_rot, centers_rot, tile_probes, probe_valid, k, metric, qt,
                code_mode, ksub)
    n_units, gm, bpr = codes.shape
    ln2 = ln.reshape(n_units, gm).to(torch.float32)
    wf = w.to(torch.float32)
    l2 = metric != DistanceType.InnerProduct

    def score_block(i, units, qdc_rows):
        wt = wf[i * qt : (i + 1) * qt]
        cols = lookup_columns(codes[units].reshape(-1, bpr), code_mode, ksub)
        dot = torch.zeros((qt, cols.shape[0]), dtype=torch.float32, device=wt.device)
        for c in range(cols.shape[1]):
            dot = dot + wt[:, cols[:, c]]
        lt = ln2[units].reshape(1, -1)
        return lt - 2.0 * (dot + qdc_rows) if l2 else lt - dot - qdc_rows

    return scan_reference(score_block, codes, q_rot, centers_rot, tile_probes, probe_valid,
                          k=k, qt=qt)


def default_split(ctas: int, n_steps: int, device) -> int:
    """CTAs that share one (tile, query group)'s units: enough to give
    every SM two CTAs, at most ``MAX_SPLIT`` and the probe steps."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return min(MAX_SPLIT, n_steps, cdiv(2 * sms, ctas))


def fused_pq_topk(
    codes,        # [n_units, gm, bpr] u8
    ln,           # [n_units, 1, gm] f32 prepared epilogue (sqn / 0, +inf invalid)
    w,            # [nq_pad, K] bf16 LUT rows (tile-sorted)
    q_rot,        # [nq_pad, rot_dim] f32 rotated queries (tile-sorted)
    centers_rot,  # [n_units, G, rot_dim] f32 rotated coarse centers
    tile_probes,
    probe_valid,
    *,
    k: int,
    metric: DistanceType,
    qt: int,
    merge: str = "bank8",
    code_mode: str = "u8",
    ksub: int = 16,
    extract_every: int = 0,
    decode_cols: int = 2048,
    n_split: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the fused probed-list PQ scan; returns ``(scores [nq_pad, k]
    asc, slots [nq_pad, k] i32)`` with slot = unit * gm + row (or -1).

    ``merge``, ``extract_every`` and ``decode_cols`` are accepted for the
    JAX signature and tune only the TPU kernel; the result is always the
    exact top-k. CUDA tensors launch the kernel (``fused_pq_topk.launches``
    counts the launches); CPU tensors take the plain version. ``n_split``
    (1-32, None = enough CTAs for two per SM) changes the speed, never
    the result."""
    if q_rot.device.type != "cuda":
        return fused_pq_topk_reference(
            codes, ln, w, q_rot, centers_rot, tile_probes, probe_valid, k=k, metric=metric,
            qt=qt, code_mode=code_mode, ksub=ksub,
        )
    _check_args(codes, ln, w, q_rot, centers_rot, tile_probes, probe_valid, k, metric, qt,
                code_mode, ksub)
    expects(w.dtype == torch.bfloat16, "fused_pq_topk: the LUT must be bf16, got %s", w.dtype)
    n_units, gm, bpr = codes.shape
    nq_pad, K = w.shape
    g_lists, rot_dim = centers_rot.shape[1], centers_rot.shape[2]
    n_qt, n_steps = tile_probes.shape
    expects(n_qt <= 65535, "fused_pq_topk: %d query tiles exceed the grid limit", n_qt)
    dev = q_rot.device
    for name, t in (("codes", codes), ("ln", ln), ("w", w), ("centers_rot", centers_rot),
                    ("tile_probes", tile_probes), ("probe_valid", probe_valid)):
        expects(t.device == dev, "fused_pq_topk: %s is on %s, queries on %s", name, t.device, dev)
    qb = queries_per_cta(K, k, g_lists)
    if n_split is None:
        n_split = default_split(cdiv(qt, qb) * n_qt, n_steps, dev)
    expects(1 <= n_split <= MAX_SPLIT, "fused_pq_topk: n_split=%d outside [1, %d]", n_split, MAX_SPLIT)
    cod = codes.contiguous()
    lnc = ln.to(torch.float32).contiguous()
    wc = w.contiguous()
    qr = q_rot.to(torch.float32).contiguous()
    cr = centers_rot.to(torch.float32).contiguous()
    tp = tile_probes.to(torch.int32).contiguous()
    pv = probe_valid.to(torch.int32).contiguous()
    out_v = torch.empty((nq_pad, k), dtype=torch.float32, device=dev)
    out_s = torch.empty((nq_pad, k), dtype=torch.int32, device=dev)
    part = (n_split, nq_pad, k) if n_split > 1 else (0,)
    part_v = torch.empty(part, dtype=torch.float32, device=dev)
    part_s = torch.empty(part, dtype=torch.int32, device=dev)
    lib, _, _ = build_kernel()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.pq_scan_fused_pq_topk(
        cod.data_ptr(), lnc.data_ptr(), wc.data_ptr(), qr.data_ptr(), cr.data_ptr(),
        tp.data_ptr(), pv.data_ptr(), out_v.data_ptr(), out_s.data_ptr(),
        part_v.data_ptr(), part_s.data_ptr(),
        n_split, n_qt, gm, g_lists, bpr, K, rot_dim, qt, n_steps, k,
        0 if metric != DistanceType.InnerProduct else 1, _MODE_CODE[code_mode], ksub, qb,
        stream,
    )
    if err != 0:
        raise RaftError(f"pq_scan kernel launch failed (cudaError {err})")
    fused_pq_topk.launches += 1
    return out_v, out_s


fused_pq_topk.launches = 0


# ---------------------------------------------------------------------------
# search wrapper
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CodeScanInputs:
    """What a fused code scan (PQ or RaBitQ) hands its kernel besides the
    per-slot channels: the ``group``-list unit view of the codes, the slot
    validity (prefilter folded in), the tile-sorted rotated queries, the
    unit view of the rotated centers and the tile tables."""

    codes: torch.Tensor  # [n_units, gm, bpr] u8
    valid: torch.Tensor  # [n_units, 1, gm] bool
    q_rot: torch.Tensor  # [nq_pad, rot_dim] f32
    centers_rot: torch.Tensor  # [n_units, G, rot_dim] f32
    tile_probes: torch.Tensor  # [n_qt, P] i32
    probe_valid: torch.Tensor  # [n_qt, P] i32
    order_pad: torch.Tensor  # [nq_pad] i32


def code_scan_inputs(
    centers, centers_rot, center_rank, rotation, codes, list_indices, queries,
    filter_bits: Optional[torch.Tensor], *, n_probes: int, metric: DistanceType, qt: int,
    probe_factor: int, group: int,
) -> CodeScanInputs:
    """Coarse probe selection, tile tables, rotated tile-sorted queries and
    the prefilter fold (``pq_scan.py:446-478``)."""
    from raft_tpu_torch.neighbors.ivf_common import probe_selection

    nq = queries.shape[0]
    n_lists, m, bpr = codes.shape
    qf = queries.to(torch.float32)
    coarse, probed = probe_selection(centers, qf, n_probes, metric)
    order_pad, tile_probes, probe_valid = build_tile_probe_tables(
        coarse, probed, center_rank, nq=nq, qt=qt, n_lists=n_lists, group=group,
        n_probes=n_probes, probe_factor=probe_factor,
    )
    q_rot = qf[order_pad.to(torch.int64)] @ rotation.T
    valid = list_indices >= 0
    if filter_bits is not None:
        ids = torch.clamp(list_indices, min=0).to(torch.int64)
        bit = (filter_bits[ids // 32] >> (ids % 32).to(torch.int32)) & 1
        valid = valid & (bit == 1)
    n_units = n_lists // group
    return CodeScanInputs(
        codes=codes.reshape(n_units, group * m, bpr),
        valid=valid.reshape(n_units, 1, group * m),
        q_rot=q_rot,
        centers_rot=centers_rot.reshape(n_units, group, -1),
        tile_probes=tile_probes,
        probe_valid=probe_valid,
        order_pad=order_pad,
    )


def pq_epilogue(valid, rot_sqnorms, metric: DistanceType) -> torch.Tensor:
    """The prepared per-slot term: squared decoded norm for L2, 0 for IP,
    +inf on invalid slots (``pq_scan.py:469-478``)."""
    inf = torch.full(valid.shape, float("inf"), dtype=torch.float32, device=valid.device)
    if metric == DistanceType.InnerProduct:
        return torch.where(valid, torch.zeros_like(inf), inf)
    return torch.where(valid, rot_sqnorms.reshape(valid.shape).to(torch.float32), inf)


def fused_postprocess(vals, slots, list_indices, q_rot, order_pad, *, nq: int, k: int,
                      metric: DistanceType) -> Tuple[torch.Tensor, torch.Tensor]:
    """Slots to ids, scores to distances (``||q||^2 + score`` for L2,
    ``-score`` for IP), back to the caller's query order."""
    flat_ids = list_indices.reshape(-1)
    idx = torch.where(slots >= 0, flat_ids[torch.clamp(slots.to(torch.int64), min=0)],
                      torch.full_like(slots, -1))
    if metric == DistanceType.InnerProduct:
        out = -vals
    else:
        qn = torch.sum(q_rot * q_rot, dim=1)
        out = torch.clamp(qn[:, None] + vals, min=0.0)
        if metric == DistanceType.L2SqrtExpanded:
            out = torch.sqrt(out)
        out = torch.where(idx >= 0, out, torch.full_like(out, float("inf")))
    order = order_pad[:nq].to(torch.int64)
    dist = torch.zeros((nq, k), dtype=torch.float32, device=vals.device)
    ind = torch.full((nq, k), -1, dtype=torch.int32, device=vals.device)
    dist[order] = out[:nq]
    ind[order] = idx[:nq].to(torch.int32)
    return dist, ind


def ivf_pq_fused_search(
    centers,
    centers_rot,
    center_rank,
    rotation,
    books,        # [pq_dim_eff, ksub_eff, pq_len] f32 in LUT column order
    codes,        # [n_lists, max_list, bpr] u8
    list_indices,
    rot_sqnorms,
    queries,
    filter_bits: Optional[torch.Tensor],
    *,
    k: int,
    n_probes: int,
    metric: DistanceType,
    qt: int = 128,
    probe_factor: int = 32,
    group: int = 8,
    merge: str = "bank8",
    code_mode: str = "u8",
    ksub: int = 16,
    extract_every: int = 0,
    decode_cols: int = 2048,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """IVF-PQ search through the fused scan (``pq_scan.py:414-518``).
    Returns ``(distances [nq, k] f32, indices [nq, k] i32)``: exact ADC
    scores of the (possibly additive-nibble) codebooks, to be re-ranked
    with :func:`raft_tpu_torch.neighbors.refine.refine`."""
    ci = code_scan_inputs(
        centers, centers_rot, center_rank, rotation, codes, list_indices, queries, filter_bits,
        n_probes=n_probes, metric=metric, qt=qt, probe_factor=probe_factor, group=group,
    )
    vals, slots = fused_pq_topk(
        ci.codes, pq_epilogue(ci.valid, rot_sqnorms, metric), pq_lut(ci.q_rot, books), ci.q_rot,
        ci.centers_rot, ci.tile_probes, ci.probe_valid, k=k, metric=metric, qt=qt, merge=merge,
        code_mode=code_mode, ksub=ksub, extract_every=extract_every, decode_cols=decode_cols,
    )
    return fused_postprocess(vals, slots, list_indices, ci.q_rot, ci.order_pad,
                             nq=queries.shape[0], k=k, metric=metric)
