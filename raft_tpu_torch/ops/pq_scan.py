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
that one query's LUT (``K * 2`` bytes) fits there. The wrapper lists
each unit's 32-row groups that hold a valid slot (:func:`group_tables`),
which the kernel scores 8 at a time, and each tile's chunks that hold
work (:func:`work_lists`), which the CTAs sharing the tile take from a
counter as they go.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import torch

from raft_tpu_torch.core.errors import RaftError, expects
from raft_tpu_torch.ops.cuda_build import build_library
from raft_tpu_torch.ops.distance import DistanceType
from raft_tpu_torch.ops.guard import check_cuda
from raft_tpu_torch.ops.ivf_scan import (
    MAX_K,
    MAX_SPLIT,
    SMEM_LIMIT_BYTES,
    build_tile_probe_tables,
)
from raft_tpu_torch.ops.select_k import select_k
from raft_tpu_torch.utils.math import cdiv

_SUPPORTED = frozenset({DistanceType.L2Expanded, DistanceType.L2SqrtExpanded, DistanceType.InnerProduct})

#: the kernel's query counts per CTA (its ``QB`` template), most first
QUERIES_PER_CTA = (8, 4, 1)
MAX_QUERIES_PER_CTA = QUERIES_PER_CTA[0]
#: LUT columns between query groups at the most queries a CTA (``STRIDE``):
#: the widest LUT such a CTA takes
_STRIDE = 2048
#: CTAs an SM runs at once (``CTAS_PER_SM``, the kernel's launch bound)
_CTAS_PER_SM = 3
#: code rows one CTA scores per step, one per thread (``R`` in the .cu)
ROWS_PER_CHUNK = 256
#: candidates a query's buffer holds: two chunks' (``CAP`` in the .cu)
_CANDIDATES = 2 * ROWS_PER_CHUNK
#: rows of one weight unit of a chunk: a warp's rows
_ROW_GROUP = 32
#: chunks a CTA takes from its (tile, query group)'s work list at a time
#: (``ITEM`` in the .cu)
CHUNKS_PER_ITEM = 8
_MODE_CODE = {"u8": 0, "nib8": 1, "p4": 2, "b3": 3, "b5": 5, "b6": 6, "b7": 7}

_SIGNATURES = {
    "pq_scan_fused_pq_topk":
        [ctypes.c_void_p] * 16 + [ctypes.c_int] * 14 + [ctypes.c_void_p],
    "pq_scan_layout": [ctypes.c_void_p],
    "pq_scan_smem_bytes": [ctypes.c_int] * 4,
}
#: the constants above as ``pq_scan_layout`` reports the kernel's: the most
#: queries a CTA, STRIDE, CTAs an SM, rows a chunk, CAP, ITEM, 32-row groups
#: a chunk, rows a group; :func:`build_kernel` checks they agree
_LAYOUT = (MAX_QUERIES_PER_CTA, _STRIDE, _CTAS_PER_SM, ROWS_PER_CHUNK, _CANDIDATES,
           CHUNKS_PER_ITEM, ROWS_PER_CHUNK // _ROW_GROUP, _ROW_GROUP)
#: the stage clock's stages (``csrc/stage_clock.cuh``); the record of
#: :func:`fused_pq_topk_stages` holds them, the warps' and the CTA's total
#: cycles, then the counts of ``COUNTS``
STAGES = ("lut", "q_dot_c", "codes", "score_write", "topk", "barrier")
COUNTS = ("candidates", "merges")


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
    and load it, checking that the kernel's layout is the one this module
    mirrors. Returns ``(library, build seconds, compiler output)``."""
    lib, seconds, log = build_library("pq_scan.cu", _SIGNATURES, verbose=verbose)
    got = (ctypes.c_int * len(_LAYOUT))()
    lib.pq_scan_layout(got)
    if tuple(got) != _LAYOUT:
        raise RaftError(f"pq_scan.cu's layout {tuple(got)} is not the wrapper's {_LAYOUT}")
    return lib, seconds, log


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


def cta_smem_bytes(qb: int, K: int, k: int, g_lists: int) -> int:
    """Shared memory of one CTA of ``qb`` queries: the bf16 LUT rows (at
    the most queries a CTA laid out 2048 columns apart), and per query a
    candidate buffer of two 256-row chunks (8 B an entry), its top-k list
    (8 B an entry), its q.c terms and its candidate count, and the CTA's
    next work item. The kernel's own count (``pq_scan_smem_bytes``) is
    held to it at every launch."""
    lut_cols = _STRIDE if qb == MAX_QUERIES_PER_CTA else K
    return 2 * qb * lut_cols + qb * (8 * _CANDIDATES + 8 * k + 4 * g_lists + 4) + 4


def queries_per_cta(K: int, k: int, g_lists: int) -> int:
    """Queries one CTA holds: the most of 8 (LUTs of at most 2048
    columns), 4 and 1 whose shared memory (:func:`cta_smem_bytes`) fits
    the 227 KB a block may use. Raises when not even one query's LUT
    fits."""
    fits = [qb for qb in QUERIES_PER_CTA if (qb < MAX_QUERIES_PER_CTA or K <= _STRIDE)
            and cta_smem_bytes(qb, K, k, g_lists) <= SMEM_LIMIT_BYTES]
    expects(bool(fits), "fused_pq_topk: one query's LUT (%d columns, %d bytes) does not fit the "
            "%d bytes of shared memory", K, 2 * K, SMEM_LIMIT_BYTES)
    return fits[0]


def group_tables(valid) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's work in each unit: its 32-row groups (a warp's rows)
    that hold a valid slot, in row order, taken 8 at a time (a 256-row
    chunk). ``valid [n_units, 1, gm]`` bool (the slots of finite ``ln``)
    -> ``(groups, chunk_w)``: int32 ``[n_units, n_groups]``, each unit's
    valid groups first, and int32 ``[n_units, cdiv(n_groups, 8)]``, the
    groups in each chunk (0 past the unit's last). They depend on the
    index and the filter only, so a search without a filter keeps them
    with its index."""
    n_units = valid.shape[0]
    valid = valid.reshape(n_units, -1)
    n_groups = cdiv(valid.shape[1], _ROW_GROUP)
    pad = n_groups * _ROW_GROUP - valid.shape[1]
    if pad:
        valid = torch.nn.functional.pad(valid, (0, pad))
    gvalid = valid.reshape(n_units, n_groups, _ROW_GROUP).any(dim=2)
    groups = torch.argsort((~gvalid).to(torch.int8), dim=1, stable=True).to(torch.int32)
    per_chunk = ROWS_PER_CHUNK // _ROW_GROUP
    starts = per_chunk * torch.arange(cdiv(n_groups, per_chunk), device=valid.device)
    chunk_w = torch.clamp(gvalid.sum(dim=1, keepdim=True) - starts[None, :], 0, per_chunk)
    return groups, chunk_w.to(torch.int32)


def work_lists(tile_probes, probe_valid, chunk_w) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each tile's chunks that hold work, in the kernel's step-major order
    (chunk ``g`` = probe step ``g // n_chunks``, valid groups ``(g %
    n_chunks) * 8 ...`` of its unit, as :func:`group_tables` lists them):
    ``(work, n_work)``, int32 ``[n_qt, P * n_chunks]`` with each tile's
    ``n_work`` chunks of weight > 0 of its valid steps first. The kernel's
    CTAs of a (tile, query group) take them ``CHUNKS_PER_ITEM`` at a time
    from a shared counter. Computed on the tables' device without a sync."""
    n_qt, P = tile_probes.shape
    w = chunk_w[tile_probes.to(torch.int64)]  # [n_qt, P, n_chunks]
    has = ((probe_valid > 0)[:, :, None] & (w > 0)).reshape(n_qt, -1)
    work = torch.argsort((~has).to(torch.int8), dim=1, stable=True).to(torch.int32)
    return work, has.sum(dim=1, dtype=torch.int32)


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


def one_wave_split(ctas: int, device) -> int:
    """CTAs that share one (tile, query group)'s work list (B2): as many as
    fill the SMs in one wave at ``_CTAS_PER_SM`` an SM, 1 to
    ``MAX_SPLIT``."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return min(MAX_SPLIT, max(1, _CTAS_PER_SM * sms // ctas))


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
    tables: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the fused probed-list PQ scan; returns ``(scores [nq_pad, k]
    asc, slots [nq_pad, k] i32)`` with slot = unit * gm + row (or -1).

    ``merge``, ``extract_every`` and ``decode_cols`` are accepted for the
    JAX signature and tune only the TPU kernel; the result is always the
    exact top-k. CUDA tensors launch the kernel (``fused_pq_topk.launches``
    counts the launches); CPU tensors take the plain version. ``n_split``
    (1-32, None = as many CTAs as fill the SMs in one wave,
    :func:`one_wave_split`) changes the speed, never the result.
    ``tables`` is :func:`group_tables` of ``isfinite(ln)`` where the
    caller keeps it (built here when None)."""
    if q_rot.device.type != "cuda":
        return fused_pq_topk_reference(
            codes, ln, w, q_rot, centers_rot, tile_probes, probe_valid, k=k, metric=metric,
            qt=qt, code_mode=code_mode, ksub=ksub,
        )
    out_v, out_s, _ = _launch(codes, ln, w, q_rot, centers_rot, tile_probes, probe_valid, k=k,
                              metric=metric, qt=qt, code_mode=code_mode, ksub=ksub,
                              n_split=n_split, tables=tables)
    return out_v, out_s


def fused_pq_topk_stages(codes, ln, w, q_rot, centers_rot, tile_probes, probe_valid, *, k: int,
                         metric: DistanceType, qt: int, code_mode: str = "u8", ksub: int = 16,
                         n_split: Optional[int] = None) -> torch.Tensor:
    """One launch of the kernel with its stage clock on (CUDA tensors
    only): returns int64 ``[CTAs, len(STAGES) + 2 + len(COUNTS)]``, per
    CTA the cycles of each stage summed over its warps, the warps' total
    cycles, the CTA's own cycles, the candidates that passed its filter
    and the 32-wide batches it merged into its lists."""
    expects(q_rot.device.type == "cuda", "fused_pq_topk_stages: the stage clock runs on the card")
    return _launch(codes, ln, w, q_rot, centers_rot, tile_probes, probe_valid, k=k, metric=metric,
                   qt=qt, code_mode=code_mode, ksub=ksub, n_split=n_split, stages=True)[2]


def _launch(codes, ln, w, q_rot, centers_rot, tile_probes, probe_valid, *, k: int,
            metric: DistanceType, qt: int, code_mode: str, ksub: int, n_split: Optional[int],
            stages: bool = False, tables=None):
    """Launch ``csrc/pq_scan.cu`` on CUDA tensors; raises if it cannot be
    built or launched. Returns ``(scores, slots, record)``, the stage
    clock's record with ``stages`` and None without."""
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
        n_split = one_wave_split(cdiv(qt, qb) * n_qt, dev)
    expects(1 <= n_split <= MAX_SPLIT, "fused_pq_topk: n_split=%d outside [1, %d]", n_split, MAX_SPLIT)
    groups, cw = group_tables(torch.isfinite(ln)) if tables is None else tables
    work, n_work = work_lists(tile_probes, probe_valid, cw)
    counters = torch.zeros(n_qt * cdiv(qt, qb), dtype=torch.int32, device=dev)
    cod = codes.contiguous()
    lnc = ln.to(torch.float32).contiguous()
    wc = w.contiguous()
    qr = q_rot.to(torch.float32).contiguous()
    cr = centers_rot.to(torch.float32).contiguous()
    tp = tile_probes.to(torch.int32).contiguous()
    out_v = torch.empty((nq_pad, k), dtype=torch.float32, device=dev)
    out_s = torch.empty((nq_pad, k), dtype=torch.int32, device=dev)
    part = (n_split, nq_pad, k) if n_split > 1 else (0,)
    part_v = torch.empty(part, dtype=torch.float32, device=dev)
    part_s = torch.empty(part, dtype=torch.int32, device=dev)
    rec = None
    if stages:
        rec = torch.zeros((cdiv(qt, qb) * n_qt * n_split, len(STAGES) + 2 + len(COUNTS)),
                          dtype=torch.int64, device=dev)
    lib, _, _ = build_kernel()
    smem = lib.pq_scan_smem_bytes(qb, K, k, g_lists)
    if smem != cta_smem_bytes(qb, K, k, g_lists):
        raise RaftError(f"pq_scan.cu asks {smem} B of shared memory for {qb} queries a CTA, "
                        f"the wrapper counted {cta_smem_bytes(qb, K, k, g_lists)}")
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.pq_scan_fused_pq_topk(
        cod.data_ptr(), lnc.data_ptr(), wc.data_ptr(), qr.data_ptr(), cr.data_ptr(),
        tp.data_ptr(), groups.data_ptr(), cw.data_ptr(), work.data_ptr(),
        n_work.data_ptr(), counters.data_ptr(), out_v.data_ptr(), out_s.data_ptr(),
        part_v.data_ptr(), part_s.data_ptr(), None if rec is None else rec.data_ptr(),
        n_split, n_qt, gm, g_lists, bpr, K, rot_dim, qt, n_steps, k,
        0 if metric != DistanceType.InnerProduct else 1, _MODE_CODE[code_mode], ksub, qb,
        stream,
    )
    check_cuda(err, "pq_scan kernel launch")
    fused_pq_topk.launches += 1
    return out_v, out_s, rec


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
    tables: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """IVF-PQ search through the fused scan (``pq_scan.py:414-518``).
    Returns ``(distances [nq, k] f32, indices [nq, k] i32)``: exact ADC
    scores of the (possibly additive-nibble) codebooks, to be re-ranked
    with :func:`raft_tpu_torch.neighbors.refine.refine`. ``tables``: the
    kernel's group tables, where the caller keeps them
    (:func:`fused_pq_topk`)."""
    ci = code_scan_inputs(
        centers, centers_rot, center_rank, rotation, codes, list_indices, queries, filter_bits,
        n_probes=n_probes, metric=metric, qt=qt, probe_factor=probe_factor, group=group,
    )
    vals, slots = fused_pq_topk(
        ci.codes, pq_epilogue(ci.valid, rot_sqnorms, metric), pq_lut(ci.q_rot, books), ci.q_rot,
        ci.centers_rot, ci.tile_probes, ci.probe_valid, k=k, metric=metric, qt=qt, merge=merge,
        code_mode=code_mode, ksub=ksub, extract_every=extract_every, decode_cols=decode_cols,
        tables=tables,
    )
    return fused_postprocess(vals, slots, list_indices, ci.q_rot, ci.order_pad,
                             nq=queries.shape[0], k=k, metric=metric)
