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

The kernel filters before it scores exactly: a bf16 product of the
queries (:func:`bf16_plane`) with the bits on the tensor cores, widened
by each query's error bound (:func:`filter_error`), gives a lower bound of
every score (:func:`estimator_lower_bound`); only rows whose bound does
not exceed the query's current k-th score are re-scored exactly and
merged. :func:`fused_rabitq_topk_filtered_reference` runs that schedule
in plain PyTorch, and its result is the plain version's bit for bit.
:func:`cta_plan` sizes a CTA (queries, rows a chunk, shared memory) as
the kernel lays it out. Where the queries and a chunk do not fit shared
memory whole (``rot_dim`` past a few hundred), the kernel's depth-sliced
instantiation takes the product ``_DEPTH_SLICE`` dimensions at a time and
reads the f32 queries through the caches, and past a few thousand the
code rows too, so every ``rot_dim`` has a plan.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import torch

from raft_tpu_torch.core.errors import RaftError, expects
from raft_tpu_torch.ops.cuda_build import build_library
from raft_tpu_torch.ops.distance import DistanceType
from raft_tpu_torch.ops.ivf_scan import (
    CTA_RESERVED_BYTES,
    MAX_K,
    MAX_SPLIT,
    SM_SMEM_BYTES,
    work_list,
)
from raft_tpu_torch.ops.pq_scan import (
    SMEM_LIMIT_BYTES,
    code_scan_inputs,
    fused_postprocess,
    scan_reference,
    supported_metric,
)
from raft_tpu_torch.utils.math import cdiv, round_up

#: the kernel's query counts per CTA (its ``QB`` template), most first
QUERIES_PER_CTA = (64, 32, 16, 8)
#: queries a warp owns: the product's n8 tile (``QW`` in the .cu)
_QUERIES_PER_WARP = 8
#: rows a warp scores at a time, four m16 tiles (``ROUND``)
_ROUND = 64
#: candidates a query's buffer holds (``CAP``)
_CANDIDATES = 128
#: chunks staged at once (``NS``)
_STAGED = 3
#: bytes after each bf16 row of the query and bit planes (``ROW_PAD``)
_ROW_PAD = 16
#: the byte -> eight bf16 0/1 values table (``LUT_BYTES``)
_LUT_BYTES = 256 * 16
#: dimensions of a depth slice of the sliced instantiation (``DS``)
_DEPTH_SLICE = 256
#: rows a chunk, most first: 128 where it fits, else 64 (64 when sliced)
ROWS_PER_CHUNK = (128, 64)
#: ``c`` of the filter's error bound: the f32 rounding of the tensor
#: core's sums and of the plain version's, per dimension (both are at most
#: about one unit of 2^-23 of sum |q| a dimension; 8 leaves room)
_ERROR_C = 8.0
_SLOT_EMPTY = 2 ** 31 - 1
#: +inf as the kernel's ordered int key of a float (its shared k-th scores)
_INF_KEY = 0x7F800000

_SIGNATURES = {
    "rabitq_scan_fused_rabitq_topk":
        [ctypes.c_void_p] * 16 + [ctypes.c_int] * 12 + [ctypes.c_void_p],
    "rabitq_scan_layout": [ctypes.c_void_p],
    "rabitq_scan_smem_bytes": [ctypes.c_int] * 6,
}
#: the constants above as ``rabitq_scan_layout`` reports the kernel's;
#: :func:`build_kernel` checks that they agree
_LAYOUT = (QUERIES_PER_CTA[0], _QUERIES_PER_WARP, _ROUND, _CANDIDATES, _STAGED, _ROW_PAD,
           _LUT_BYTES, _DEPTH_SLICE)
#: the stage clock's stages (``csrc/stage_clock.cuh``) in the record of
#: :func:`fused_rabitq_topk_stages`, then the warps' and the CTA's total
#: cycles and the counts of ``COUNTS``
STAGES = ("codes", "mma", "filter", "rescore", "merge", "barrier")
COUNTS = ("survivors", "merges")
#: the checking launch's counts per CTA (:func:`fused_rabitq_topk_check`)
CHECK_COUNTS = ("violations", "survivors", "candidates")


def build_kernel(verbose: bool = False) -> Tuple[ctypes.CDLL, float, str]:
    """Build ``csrc/rabitq_scan.cu`` for ``sm_90a`` (once per source
    version) and load it, checking that the kernel's layout is the one
    this module mirrors. Returns ``(library, build seconds, compiler
    output)``."""
    lib, seconds, log = build_library("rabitq_scan.cu", _SIGNATURES, verbose=verbose)
    got = (ctypes.c_int * len(_LAYOUT))()
    lib.rabitq_scan_layout(got)
    if tuple(got) != _LAYOUT:
        raise RaftError(f"rabitq_scan.cu's layout {tuple(got)} is not the wrapper's {_LAYOUT}")
    return lib, seconds, log


def cta_smem_bytes(qb: int, rot_dim: int, k: int, g_lists: int, rows: int,
                   mode: int = 0) -> int:
    """Shared memory of one CTA of ``qb`` queries and ``rows``-row chunks,
    as the kernel lays it out in layout ``mode`` (0 whole, 1 depth-sliced,
    2 depth-sliced without staged code rows): the byte table; the bf16
    query plane and the chunk's bf16 bit plane (rows of ``round_up(rot_dim,
    16)`` values, or ``_DEPTH_SLICE`` when sliced, and 16 bytes of
    padding); in mode 0 the f32 queries (rows of ``rot_dim + 1``); three
    staged chunks (but in mode 2 their code span, and their ln and g
    spans, each with 16 bytes of alignment slack, each row's list, and the
    chunk's unit, first row and rows); per query its half sum, error
    bound, ``coef * q.c`` per list, top-k list (8 B an entry) and
    candidate buffer (8 B an entry). The kernel's own count
    (``rabitq_scan_smem_bytes``) is held to it at every launch."""
    row = 2 * (_DEPTH_SLICE if mode else round_up(rot_dim, 16)) + _ROW_PAD
    span = 0 if mode == 2 else round_up(rows * (rot_dim // 8) + 16, 16)
    queries = 0 if mode else round_up(4 * qb * (rot_dim + 1), 16)
    return (_LUT_BYTES + (qb + rows) * row + queries
            + _STAGED * (span + 2 * (4 * rows + 16) + 4 * rows + 16)
            + qb * (4 + 4 + 4 * g_lists + 8 * k + 8 * _CANDIDATES))


@dataclasses.dataclass(frozen=True)
class CtaPlan:
    queries: int      # queries a CTA holds (8 a warp)
    rows: int         # rows a staged chunk
    smem_bytes: int   # its dynamic shared memory
    ctas_per_sm: int  # CTAs an SM holds at once
    mode: int = 0     # layout: 0 whole, 1 depth-sliced, 2 sliced without staged code rows

    @property
    def sliced(self) -> bool:
        """Whether the depth-sliced instantiation runs."""
        return self.mode != 0


def cta_plan(rot_dim: int, k: int, g_lists: int, qt: int = QUERIES_PER_CTA[0]) -> CtaPlan:
    """How the kernel runs at this shape: the most queries a CTA (64, 32,
    16 or 8, no more than a tile of ``qt`` needs), then the most rows a
    chunk (128 or 64) with the queries and chunks whole in shared memory,
    else 64 rows depth-sliced with the code rows staged, else without,
    within the 227 KB a block may use. The last layout does not grow with
    ``rot_dim``, so only a ``k`` or ``g_lists`` too large for 8 queries a
    CTA raises."""
    expects(1 <= k <= MAX_K, "fused_rabitq_topk: k=%d outside [1, %d]", k, MAX_K)
    want = min(q for q in QUERIES_PER_CTA if q >= min(qt, QUERIES_PER_CTA[0]))
    for qb in QUERIES_PER_CTA:
        if qb > want:
            continue
        for rows, mode in [(r, 0) for r in ROWS_PER_CHUNK] + [(_ROUND, 1), (_ROUND, 2)]:
            smem = cta_smem_bytes(qb, rot_dim, k, g_lists, rows, mode)
            if smem <= SMEM_LIMIT_BYTES:
                per_sm = min(2048 // (32 * qb // _QUERIES_PER_WARP),
                             SM_SMEM_BYTES // (smem + CTA_RESERVED_BYTES))
                return CtaPlan(qb, rows, smem, per_sm, mode)
    least = cta_smem_bytes(QUERIES_PER_CTA[-1], rot_dim, k, g_lists, _ROUND, 2)
    raise RaftError(f"fused_rabitq_topk: k={k} with {g_lists} lists a unit does not fit shared "
                    f"memory ({least} of {SMEM_LIMIT_BYTES} bytes at 8 queries a CTA)")


def default_split(ctas: int, n_steps: int, ctas_per_sm: int, device) -> int:
    """CTAs that share one (tile, query group)'s chunks: as many as fill
    the SMs in one wave at ``ctas_per_sm`` an SM, 1 to ``MAX_SPLIT`` and
    at most the probe steps."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(MAX_SPLIT, n_steps, ctas_per_sm * sms // ctas))


def bf16_plane(q_rot) -> torch.Tensor:
    """The queries the filter multiplies: ``bf16_rn(q_rot)``."""
    return q_rot.to(torch.float32).to(torch.bfloat16)


def filter_error(q_rot, hi: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per query, a bound ``delta`` on ``|hi . b - q_rot . b|`` for any 0/1
    row ``b``, where ``hi . b`` is summed in f32 in any order (the tensor
    core's) and ``q_rot . b`` in dimension order (the plain version's):
    ``sum |q - hi| + 8 D16 2^-23 sum |q|`` (D16 = rot_dim rounded up to
    16, the product's depth), computed in f64 and rounded up to f32.
    ``[nq, rot_dim]`` -> ``[nq]`` f32."""
    q = q_rot.to(torch.float64)
    h = (bf16_plane(q_rot) if hi is None else hi).to(torch.float64)
    d16 = round_up(q.shape[1], 16)
    err = (q - h).abs().sum(dim=1) + _ERROR_C * d16 * 2.0 ** -23 * q.abs().sum(dim=1)
    e32 = err.to(torch.float32)
    return torch.nextafter(e32, torch.full_like(e32, float("inf")))


def estimator_lower_bound(acc, delta, h, t2, g) -> torch.Tensor:
    """A lower bound of the exact score ``t2 - g * (dot - h)`` (f32, each
    operation rounded) from an approximate ``acc`` with ``|acc - dot| <=
    delta``: the same operations at ``acc + delta`` where ``g >= 0`` and at
    ``acc - delta`` where ``g < 0`` (round-to-nearest is monotone).
    ``t2 = ln - coef * q.c``; ``h = sum(q_rot) / 2``."""
    x = acc + torch.copysign(delta, g)
    return t2 - g * (x - h)


def chunk_table(ln, rows: int) -> torch.Tensor:
    """``[n_units, cdiv(gm, rows)]`` bool: where a ``rows``-row chunk of a
    unit holds a finite ``ln`` (a slot to score)."""
    n_units = ln.shape[0]
    valid = torch.isfinite(ln.reshape(n_units, -1))
    pad = cdiv(valid.shape[1], rows) * rows - valid.shape[1]
    if pad:
        valid = torch.nn.functional.pad(valid, (0, pad))
    return valid.reshape(n_units, -1, rows).any(dim=2)


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


def fused_rabitq_topk_filtered_reference(
    codes, ln, corr, q_rot, centers_rot, tile_probes, probe_valid,
    *, k: int, metric: DistanceType, qt: int, n_split: int = 1, plan: Optional[CtaPlan] = None,
    **_,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch mirror of the kernel's schedule: per (tile, share of
    ``n_split`` of its listed chunks of ``plan.rows`` rows (:func:`work_list`),
    query group of ``plan.queries``), the chunks in order, 64 rows at a time;
    the bf16 product (``torch.matmul``, in its own order), the lower bound
    against each query's current k-th score (the smaller of its list's and
    the smallest any share has reached), candidates buffered, and a
    buffer that could not take another 64 rows (and every buffer at the
    end) merged (lexicographic ``(score, slot)``) with its candidates'
    exact scores, summed in dimension order (the kernel computes them at
    the end of each round); then the shares' lists merged. Its result is
    :func:`fused_rabitq_topk_reference`'s bit for bit."""
    _check_args(codes, ln, corr, q_rot, centers_rot, tile_probes, probe_valid, k, metric, qt)
    n_units, gm, bpr = codes.shape
    nq_pad, rot_dim = q_rot.shape
    g_lists = centers_rot.shape[1]
    m = gm // g_lists
    plan = plan or cta_plan(rot_dim, k, g_lists, qt)
    qb, rows = plan.queries, plan.rows
    dev = q_rot.device
    ln2 = ln.reshape(n_units, gm).to(torch.float32)
    corr2 = corr.reshape(n_units, gm).to(torch.float32)
    qf = q_rot.to(torch.float32)
    hi = bf16_plane(qf)
    delta = filter_error(qf, hi)
    hi = hi.to(torch.float32)
    sq = torch.zeros((nq_pad,), dtype=torch.float32, device=dev)
    for t in range(rot_dim):
        sq = sq + qf[:, t]
    h = 0.5 * sq
    coef = 1.0 if metric == DistanceType.InnerProduct else 2.0
    work, n_work = work_list(tile_probes.cpu(), probe_valid.cpu(), chunk_table(ln2, rows).cpu(),
                             n_split)
    n_chunks = cdiv(gm, rows)
    inf = float("inf")
    shared_kth = torch.full((nq_pad,), inf, dtype=torch.float32, device=dev)
    part_v = torch.full((n_split, nq_pad, k), inf, dtype=torch.float32, device=dev)
    part_s = torch.full((n_split, nq_pad, k), _SLOT_EMPTY, dtype=torch.int64, device=dev)

    def merge(tv, ts, cand_v, cand_s):
        """The k lexicographically smallest of a list and candidates."""
        v = torch.cat([tv, cand_v])
        s_ = torch.cat([ts, cand_s])
        order = torch.argsort(s_, stable=True)
        order = order[torch.argsort(v[order], stable=True)]
        return v[order[:k]], s_[order[:k]]

    for i in range(work.shape[0]):
        nw = int(n_work[i])
        for split in range(n_split):
            share = work[i, nw * split // n_split: nw * (split + 1) // n_split].tolist()
            for q0 in range(0, qt, qb):
                qi = torch.arange(i * qt + q0, i * qt + min(qt, q0 + qb), device=dev)
                lv = torch.full((len(qi), k), inf, dtype=torch.float32, device=dev)
                ls = torch.full((len(qi), k), _SLOT_EMPTY, dtype=torch.int64, device=dev)
                buf = [[] for _ in qi]  # per query: (t2, slot) pairs

                def flush(j):
                    if not buf[j]:
                        return
                    t2 = torch.stack([b[0] for b in buf[j]])
                    slot = torch.tensor([b[1] for b in buf[j]], dtype=torch.int64, device=dev)
                    bits = sign_bits(codes.reshape(-1, bpr)[slot])
                    q = qf[qi[j]]
                    dot = torch.zeros((len(slot),), dtype=torch.float32, device=dev)
                    for t in range(rot_dim):
                        dot = dot + torch.where(bits[:, t], q[t], torch.zeros((), device=dev))
                    s_ = t2 - corr2.reshape(-1)[slot] * (dot - h[qi[j]])
                    keep = s_ < inf
                    lv[j], ls[j] = merge(lv[j], ls[j], s_[keep], slot[keep])
                    buf[j].clear()
                    # a list's k-th score bounds the query's final one: shared with the other shares
                    shared_kth[qi[j]] = torch.minimum(shared_kth[qi[j]], lv[j][k - 1])

                unit = -1
                for entry in share:
                    u, c = divmod(entry, n_chunks)
                    if u != unit:
                        unit = u
                        qc = torch.zeros((len(qi), g_lists), dtype=torch.float32, device=dev)
                        for t in range(rot_dim):
                            qc = qc + qf[qi, t, None] * centers_rot[u, :, t].to(torch.float32)[None]
                        cq2 = coef * qc
                    for rb in range(c * rows, min(gm, (c + 1) * rows), _ROUND):
                        for j in range(len(qi)):
                            if len(buf[j]) > _CANDIDATES - _ROUND:
                                flush(j)
                        r = torch.arange(rb, min(gm, rb + _ROUND), device=dev)
                        bits = sign_bits(codes[u, r]).to(torch.float32)
                        acc = hi[qi] @ bits.T  # [queries, rows]
                        l = ln2[u, r]
                        g = corr2[u, r]
                        t2 = l[None, :] - cq2[:, r // m]
                        lb = estimator_lower_bound(acc, delta[qi, None], h[qi, None], t2,
                                                   g[None, :])
                        kth = torch.minimum(lv[:, k - 1], shared_kth[qi])
                        passed = torch.isfinite(l)[None, :] & ~(lb > kth[:, None])
                        for j, rr in passed.nonzero().tolist():
                            buf[j].append((t2[j, rr], u * gm + rb + rr))
                for j in range(len(qi)):
                    flush(j)
                part_v[split, qi] = lv
                part_s[split, qi] = ls
    # the shares hold disjoint slots: their lists' lexicographic k smallest
    v = part_v.permute(1, 0, 2).reshape(nq_pad, -1)
    s_ = part_s.permute(1, 0, 2).reshape(nq_pad, -1)
    order = torch.argsort(s_, dim=1, stable=True)
    order = torch.gather(order, 1, torch.argsort(torch.gather(v, 1, order), dim=1, stable=True))
    out_v = torch.gather(v, 1, order[:, :k])
    out_s = torch.gather(s_, 1, order[:, :k])
    out_s = torch.where((out_s == _SLOT_EMPTY) | ~(out_v < inf), -1, out_s)
    return out_v, out_s.to(torch.int32)


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
    counts the launches); CPU tensors take the plain version. ``n_split``
    (1-32, None = as many CTAs as fill the SMs in one wave,
    :func:`default_split`) changes the speed, never the result."""
    if q_rot.device.type != "cuda":
        return fused_rabitq_topk_reference(
            codes, ln, corr, q_rot, centers_rot, tile_probes, probe_valid, k=k, metric=metric,
            qt=qt,
        )
    out_v, out_s, _ = _launch(codes, ln, corr, q_rot, centers_rot, tile_probes, probe_valid, k=k,
                              metric=metric, qt=qt, n_split=n_split)
    return out_v, out_s


fused_rabitq_topk.launches = 0
fused_rabitq_topk.last_grid = None  # (query groups, tiles, shares) of the last launch


def fused_rabitq_topk_stages(codes, ln, corr, q_rot, centers_rot, tile_probes, probe_valid, *,
                             k: int, metric: DistanceType, qt: int,
                             n_split: Optional[int] = None) -> torch.Tensor:
    """One launch of the kernel with its stage clock on (CUDA tensors
    only): int64 ``[CTAs, len(STAGES) + 2 + len(COUNTS)]``, per CTA the
    cycles of each stage summed over its warps, the warps' and the CTA's
    own cycles, the candidates that passed its filter and the 32-wide
    batches it merged into its lists."""
    expects(q_rot.device.type == "cuda",
            "fused_rabitq_topk_stages: the stage clock runs on the card")
    return _launch(codes, ln, corr, q_rot, centers_rot, tile_probes, probe_valid, k=k,
                   metric=metric, qt=qt, n_split=n_split, record="stages")[2]


def fused_rabitq_topk_check(codes, ln, corr, q_rot, centers_rot, tile_probes, probe_valid, *,
                            k: int, metric: DistanceType, qt: int,
                            n_split: Optional[int] = None):
    """One launch of the kernel's checking instantiation (CUDA tensors
    only), which also re-scores every candidate exactly: returns
    ``(scores, slots, counts)``, the result as :func:`fused_rabitq_topk`
    gives it and the sums over the CTAs of ``CHECK_COUNTS``: candidates
    whose exact score is below their lower bound (the filter is safe when
    there are none), candidates that passed the filter, and candidates
    (valid (query, row) pairs scored)."""
    expects(q_rot.device.type == "cuda", "fused_rabitq_topk_check: the check runs on the card")
    out_v, out_s, rec = _launch(codes, ln, corr, q_rot, centers_rot, tile_probes, probe_valid,
                                k=k, metric=metric, qt=qt, n_split=n_split, record="check")
    total = rec.sum(dim=0).tolist()
    return out_v, out_s, dict(zip(CHECK_COUNTS, total))


def _launch(codes, ln, corr, q_rot, centers_rot, tile_probes, probe_valid, *, k: int,
            metric: DistanceType, qt: int, n_split: Optional[int], record: Optional[str] = None):
    """Launch ``csrc/rabitq_scan.cu`` on CUDA tensors; raises if it cannot
    be built or launched. Returns ``(scores, slots, record)``: with
    ``record="stages"`` the stage clock's, with ``"check"`` the checking
    instantiation's counts, else None."""
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
    plan = cta_plan(rot_dim, k, g_lists, qt)
    groups = cdiv(qt, plan.queries)
    if n_split is None:
        n_split = default_split(groups * n_qt, n_steps, plan.ctas_per_sm, dev)
    expects(1 <= n_split <= MAX_SPLIT, "fused_rabitq_topk: n_split=%d outside [1, %d]",
            n_split, MAX_SPLIT)
    # the kernel stages spans of these from 16-byte aligned addresses
    cod, lnc, gc = (t.contiguous() if t.data_ptr() % 16 == 0 else t.clone()
                    for t in (codes.contiguous(), ln.to(torch.float32).contiguous(),
                              corr.to(torch.float32).contiguous()))
    qr = q_rot.to(torch.float32).contiguous()
    hi = bf16_plane(qr).contiguous()
    delta = filter_error(qr, hi)
    cr = centers_rot.to(torch.float32).contiguous()
    tp = tile_probes.to(torch.int32).contiguous()
    pv = probe_valid.to(torch.int32).contiguous()
    work, n_work = work_list(tp, pv, chunk_table(lnc, plan.rows), n_split)
    kth_key = torch.full((nq_pad,), _INF_KEY, dtype=torch.int32, device=dev)
    out_v = torch.empty((nq_pad, k), dtype=torch.float32, device=dev)
    out_s = torch.empty((nq_pad, k), dtype=torch.int32, device=dev)
    part = (n_split, nq_pad, k) if n_split > 1 else (0,)
    part_v = torch.empty(part, dtype=torch.float32, device=dev)
    part_s = torch.empty(part, dtype=torch.int32, device=dev)
    ctas = groups * n_qt * n_split
    rec = None
    if record == "stages":
        rec = torch.zeros((ctas, len(STAGES) + 2 + len(COUNTS)), dtype=torch.int64, device=dev)
    elif record == "check":
        rec = torch.zeros((ctas, len(CHECK_COUNTS)), dtype=torch.int64, device=dev)
    lib, _, _ = build_kernel()
    smem = lib.rabitq_scan_smem_bytes(plan.queries, rot_dim, k, g_lists, plan.rows, plan.mode)
    if smem != plan.smem_bytes:
        raise RaftError(f"rabitq_scan.cu asks {smem} B of shared memory for {plan}, the wrapper "
                        f"counted {plan.smem_bytes}")
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.rabitq_scan_fused_rabitq_topk(
        cod.data_ptr(), lnc.data_ptr(), gc.data_ptr(), qr.data_ptr(), hi.data_ptr(),
        delta.data_ptr(), cr.data_ptr(), work.data_ptr(), n_work.data_ptr(), kth_key.data_ptr(),
        out_v.data_ptr(), out_s.data_ptr(), part_v.data_ptr(), part_s.data_ptr(),
        rec.data_ptr() if record == "stages" else None,
        rec.data_ptr() if record == "check" else None,
        n_split, n_qt, gm, g_lists, bpr, qt, work.shape[1], k,
        0 if metric != DistanceType.InnerProduct else 1, plan.queries, plan.rows,
        plan.mode, stream,
    )
    if err != 0:
        raise RaftError(f"rabitq_scan kernel launch failed (cudaError {err})")
    fused_rabitq_topk.launches += 1
    fused_rabitq_topk.last_grid = (groups, n_qt, n_split)
    return out_v, out_s, rec


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
