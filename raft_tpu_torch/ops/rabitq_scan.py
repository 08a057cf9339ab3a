"""Fused probed-list scan for IVF-RaBitQ search
(``raft_tpu.ops.pallas.rabitq_scan`` counterpart).

Each row carries the D sign bits of its rotated residual (``D / 8`` bytes,
bit t of byte s = dimension ``8 s + t``) and two per-slot channels
prepared by the wrapper: ``ln`` (the estimator constant C1, +inf on empty
or filtered slots) and ``corr`` (the estimator scale g, 0 there). Per
tile, :func:`fused_rabitq_topk` scores every row of the tile's valid units

    score = ln - coef * (q . c_list) - g * (b . q_rot - sum(q_rot) / 2)

(``coef`` = 2 for L2, 1 for IP; ``b . q_rot`` sums the query lanes whose
bit is set) and keeps each query's exact top-k, with the probe tables,
tile order and top-k of :mod:`raft_tpu_torch.ops.pq_scan`.

:func:`fused_rabitq_topk` runs the hand-written Hopper kernel
``raft_tpu_torch/csrc/rabitq_scan.cu`` on CUDA tensors (it raises if the
kernel cannot be built or launched) and the plain PyTorch version
:func:`fused_rabitq_topk_reference` on CPU tensors. Any ``merge`` maps to
the exact top-k; the TPU kernel's VMEM row chunking (``decode_rows``)
does not apply.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from raft_tpu_torch.core.errors import RaftError, expects
from raft_tpu_torch.ops.cuda_build import build_library
from raft_tpu_torch.ops.distance import DistanceType
from raft_tpu_torch.ops.ivf_scan import MAX_K, MAX_SPLIT
from raft_tpu_torch.ops.pq_scan import (
    SMEM_LIMIT_BYTES,
    code_scan_inputs,
    default_split,
    fused_postprocess,
    scan_reference,
    supported_metric,
)
from raft_tpu_torch.utils.math import cdiv

_ROWS_PER_CHUNK = 256  # ``R`` in the .cu
_MAX_QUERIES_PER_CTA = 16  # ``QB_MAX`` in the .cu

_SIGNATURES = {
    "rabitq_scan_fused_rabitq_topk":
        [ctypes.c_void_p] * 11 + [ctypes.c_int] * 10 + [ctypes.c_void_p],
}


def build_kernel(verbose: bool = False) -> Tuple[ctypes.CDLL, float, str]:
    """Build ``csrc/rabitq_scan.cu`` for ``sm_90a`` (once per source
    version) and load it. Returns ``(library, build seconds, compiler
    output)``."""
    return build_library("rabitq_scan.cu", _SIGNATURES, verbose=verbose)


def queries_per_cta(rot_dim: int, k: int, g_lists: int) -> int:
    """Queries one CTA holds: up to 16, within 227 KB of shared memory for
    their f32 rotated queries, scores, q.c terms and top-k lists."""
    per_query = 4 * rot_dim + 4 + 4 * _ROWS_PER_CHUNK + 4 * g_lists + 8 * k
    qb = min(_MAX_QUERIES_PER_CTA, SMEM_LIMIT_BYTES // per_query)
    expects(qb >= 1, "fused_rabitq_topk: one query (rot_dim %d) does not fit shared memory", rot_dim)
    return qb


def _check_args(codes, ln, corr, q_rot, centers_rot, tile_probes, probe_valid, k, metric, qt):
    expects(supported_metric(metric), "fused_rabitq_topk: unsupported metric %s", metric)
    expects(1 <= k <= MAX_K, "fused_rabitq_topk: k=%d outside [1, %d]", k, MAX_K)
    expects(codes.ndim == 3 and codes.dtype == torch.uint8, "codes must be [n_units, gm, bpr] uint8")
    n_units, gm, bpr = codes.shape
    nq_pad, rot_dim = q_rot.shape
    expects(bpr * 8 == rot_dim, "rabitq codes carry %d bits/row but rot_dim=%d", bpr * 8, rot_dim)
    expects(ln.numel() == n_units * gm and corr.numel() == n_units * gm,
            "ln and corr must be [n_units, 1, gm]")
    n_qt, _ = tile_probes.shape
    expects(nq_pad == n_qt * qt, "query rows %d != tiles*qt %d", nq_pad, n_qt * qt)
    expects(centers_rot.ndim == 3 and centers_rot.shape[0] == n_units
            and centers_rot.shape[2] == rot_dim, "centers_rot must be [n_units, G, rot_dim]")
    expects(gm % centers_rot.shape[1] == 0, "unit rows %d not divisible by G", gm)
    expects(tile_probes.shape == probe_valid.shape, "tile_probes/probe_valid shape mismatch")


def sign_bits(codes) -> torch.Tensor:
    """``[rows, bpr]`` u8 -> ``[rows, 8 * bpr]`` bool (little-endian bits)."""
    shifts = torch.arange(8, device=codes.device, dtype=torch.int32)
    bits = (codes.to(torch.int32)[:, :, None] >> shifts) & 1
    return bits.reshape(codes.shape[0], -1) > 0


def fused_rabitq_topk_reference(
    codes, ln, corr, q_rot, centers_rot, tile_probes, probe_valid,
    *, k: int, metric: DistanceType, qt: int, merge: str = "bank8", extract_every: int = 0,
    decode_rows: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel, with its arithmetic order:
    ``b . q_rot`` and ``sum(q_rot)`` summed in dimension order, ``q.c`` too,
    and the estimator in the kernel's order. Returns ``(scores [nq_pad, k]
    asc, slots [nq_pad, k] i32)``."""
    _check_args(codes, ln, corr, q_rot, centers_rot, tile_probes, probe_valid, k, metric, qt)
    n_units, gm, bpr = codes.shape
    rot_dim = q_rot.shape[1]
    ln2 = ln.reshape(n_units, gm).to(torch.float32)
    corr2 = corr.reshape(n_units, gm).to(torch.float32)
    qf = q_rot.to(torch.float32)
    sq = torch.zeros((qf.shape[0],), dtype=torch.float32, device=qf.device)
    for t in range(rot_dim):
        sq = sq + qf[:, t]
    coef = 1.0 if metric == DistanceType.InnerProduct else 2.0

    def score_block(i, units, qdc_rows):
        q = qf[i * qt : (i + 1) * qt]
        bits = sign_bits(codes[units].reshape(-1, bpr))
        dot = torch.zeros((qt, bits.shape[0]), dtype=torch.float32, device=q.device)
        zero = torch.zeros((), dtype=torch.float32, device=q.device)
        for t in range(rot_dim):
            dot = dot + torch.where(bits[None, :, t], q[:, t, None], zero)
        lt = ln2[units].reshape(1, -1)
        gt = corr2[units].reshape(1, -1)
        return lt - coef * qdc_rows - gt * (dot - 0.5 * sq[i * qt : (i + 1) * qt, None])

    return scan_reference(score_block, codes, q_rot, centers_rot, tile_probes, probe_valid,
                          k=k, qt=qt)


def fused_rabitq_topk(
    codes,        # [n_units, gm, bpr] u8 packed sign bits
    ln,           # [n_units, 1, gm] f32 prepared C1 (+inf invalid)
    corr,         # [n_units, 1, gm] f32 prepared g (0 invalid)
    q_rot,        # [nq_pad, rot_dim] f32 rotated queries (tile-sorted)
    centers_rot,  # [n_units, G, rot_dim] f32 rotated coarse centers
    tile_probes,
    probe_valid,
    *,
    k: int,
    metric: DistanceType,
    qt: int,
    merge: str = "bank8",
    extract_every: int = 0,
    decode_rows: int = 0,
    n_split: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the fused probed-list RaBitQ scan; returns ``(scores [nq_pad,
    k] asc, slots [nq_pad, k] i32)`` with slot = unit * gm + row (or -1).
    ``merge``, ``extract_every`` and ``decode_rows`` tune only the TPU
    kernel. CUDA tensors launch the kernel (``fused_rabitq_topk.launches``
    counts the launches); CPU tensors take the plain version."""
    if q_rot.device.type != "cuda":
        return fused_rabitq_topk_reference(
            codes, ln, corr, q_rot, centers_rot, tile_probes, probe_valid, k=k, metric=metric,
            qt=qt,
        )
    _check_args(codes, ln, corr, q_rot, centers_rot, tile_probes, probe_valid, k, metric, qt)
    n_units, gm, bpr = codes.shape
    nq_pad, rot_dim = q_rot.shape
    g_lists = centers_rot.shape[1]
    n_qt, n_steps = tile_probes.shape
    expects(n_qt <= 65535, "fused_rabitq_topk: %d query tiles exceed the grid limit", n_qt)
    dev = q_rot.device
    for name, t in (("codes", codes), ("ln", ln), ("corr", corr), ("centers_rot", centers_rot),
                    ("tile_probes", tile_probes), ("probe_valid", probe_valid)):
        expects(t.device == dev, "fused_rabitq_topk: %s is on %s, queries on %s", name, t.device, dev)
    qb = queries_per_cta(rot_dim, k, g_lists)
    if n_split is None:
        n_split = default_split(cdiv(qt, qb) * n_qt, n_steps, dev)
    expects(1 <= n_split <= MAX_SPLIT, "fused_rabitq_topk: n_split=%d outside [1, %d]",
            n_split, MAX_SPLIT)
    cod = codes.contiguous()
    lnc = ln.to(torch.float32).contiguous()
    gc = corr.to(torch.float32).contiguous()
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
    err = lib.rabitq_scan_fused_rabitq_topk(
        cod.data_ptr(), lnc.data_ptr(), gc.data_ptr(), qr.data_ptr(), cr.data_ptr(),
        tp.data_ptr(), pv.data_ptr(), out_v.data_ptr(), out_s.data_ptr(),
        part_v.data_ptr(), part_s.data_ptr(),
        n_split, n_qt, gm, g_lists, bpr, qt, n_steps, k,
        0 if metric != DistanceType.InnerProduct else 1, qb, stream,
    )
    if err != 0:
        raise RaftError(f"rabitq_scan kernel launch failed (cudaError {err})")
    fused_rabitq_topk.launches += 1
    return out_v, out_s


fused_rabitq_topk.launches = 0


def ivf_rabitq_fused_search(
    centers,
    centers_rot,
    center_rank,
    rotation,
    codes,        # [n_lists, max_list, bpr] u8 packed sign bits
    list_indices,
    rot_sqnorms,  # [n_lists, max_list] f32, the estimator constant C1
    corrections,  # [n_lists, max_list] f32, the estimator scale g
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
    extract_every: int = 0,
    decode_rows: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """IVF-RaBitQ search through the fused scan (``rabitq_scan.py:332-428``).
    Returns ``(distances [nq, k] f32, indices [nq, k] i32)``: the unbiased
    estimates (``||q||^2 + score`` for L2, ``-score`` for IP), to be
    re-ranked with :func:`raft_tpu_torch.neighbors.refine.refine`."""
    ci = code_scan_inputs(
        centers, centers_rot, center_rank, rotation, codes, list_indices, queries, filter_bits,
        n_probes=n_probes, metric=metric, qt=qt, probe_factor=probe_factor, group=group,
    )
    ln, corr = rabitq_channels(ci.valid, rot_sqnorms, corrections)
    vals, slots = fused_rabitq_topk(
        ci.codes, ln, corr, ci.q_rot, ci.centers_rot, ci.tile_probes, ci.probe_valid, k=k,
        metric=metric, qt=qt, merge=merge, extract_every=extract_every, decode_rows=decode_rows,
    )
    return fused_postprocess(vals, slots, list_indices, ci.q_rot, ci.order_pad,
                             nq=queries.shape[0], k=k, metric=metric)


def rabitq_channels(valid, rot_sqnorms, corrections) -> Tuple[torch.Tensor, torch.Tensor]:
    """The prepared per-slot channels: C1 with +inf on invalid slots, and
    g with 0 there (so ``inf - 0 * dot`` stays inf)."""
    c1 = rot_sqnorms.reshape(valid.shape).to(torch.float32)
    g = corrections.reshape(valid.shape).to(torch.float32)
    return (torch.where(valid, c1, torch.full_like(c1, float("inf"))),
            torch.where(valid, g, torch.zeros_like(g)))
