"""Shared-memory model of the port's hand kernels, B1-B7 (in place of
``raft_tpu.ops.pallas.vmem_model``).

Where the JAX package's VMEM model accounts for what one grid step of a
Pallas kernel keeps in a TPU core's VMEM, this module accounts for what one
CTA of each CUDA kernel keeps in an H100 SM's shared memory: one
:class:`KernelResidency` a kernel, made of named :class:`Resident` buffers
laid out as the kernel lays them out. Each is built from the kernel's own
layout, through the constants and launch plans its wrapper mirrors from the
``.cu`` source (``ops/ivf_scan.py``, ``ops/pq_scan.py``,
``ops/rabitq_scan.py``, ``ops/cagra_search.py``, ``ops/ring_topk.py``), so
its total is the wrapper's count (``cta_smem_bytes``, ``smem_bytes``,
``onecard_smem_bytes``; held in ``tests/test_torch_hbm_model.py``) and the
kernel's own export (``*_smem_bytes``, which the wrapper holds to its count
at each launch and ``chip_smoke.py --phases tiered`` holds to this model at
the main path's shapes). The limits are the ones the wrappers state:
:data:`SMEM_LIMIT_BYTES` a block, :data:`SM_SMEM_BYTES` an SM, and
:data:`CTA_RESERVED_BYTES` each CTA reserves.

B5 (the fold, ``ring_fold``) has no export of its own: its union of ``2w``
entries is the per-warp union scratch the one-card ring (B6/B7) keeps, which
``ring_onecard_smem_bytes(0, w, 1)`` counts.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

from raft_tpu_torch.ops import cagra_search as _b4
from raft_tpu_torch.ops import ivf_scan as _b1
from raft_tpu_torch.ops import pq_scan as _b2
from raft_tpu_torch.ops import rabitq_scan as _b3
from raft_tpu_torch.ops import ring_topk as _ring
from raft_tpu_torch.utils.math import next_pow2, round_up

#: shared memory a block may use, what an SM holds and what each CTA
#: reserves of it, on an H100 (``ops/ivf_scan.py``)
SMEM_LIMIT_BYTES = _b1.SMEM_LIMIT_BYTES
SM_SMEM_BYTES = _b1.SM_SMEM_BYTES
CTA_RESERVED_BYTES = _b1.CTA_RESERVED_BYTES

#: bytes of one entry of the ring's union scratch (``UNION_BYTES_PER_ENTRY``
#: in ``csrc/ring_topk.cu``: a 64-bit order key, then key, position, value
#: and id)
UNION_ENTRY_BYTES = 8 + 4 * 4


@dataclasses.dataclass(frozen=True)
class Resident:
    """One shared-memory buffer of a CTA: ``shape`` elements of
    ``itemsize`` bytes, ``buffers`` times (staged rings)."""

    name: str
    shape: Tuple[int, ...]
    itemsize: int
    buffers: int = 1

    @property
    def nbytes(self) -> int:
        return int(math.prod(self.shape)) * self.itemsize * self.buffers


@dataclasses.dataclass(frozen=True)
class KernelResidency:
    """The model's accounting for one CTA of one kernel configuration."""

    kernel: str
    residents: Tuple[Resident, ...]

    @property
    def total_bytes(self) -> int:
        return sum(r.nbytes for r in self.residents)

    @property
    def fits(self) -> bool:
        return self.total_bytes <= SMEM_LIMIT_BYTES

    @property
    def ctas_per_sm(self) -> int:
        """CTAs an SM's shared memory holds (threads and registers may
        allow fewer)."""
        return SM_SMEM_BYTES // (self.total_bytes + CTA_RESERVED_BYTES)

    def table(self) -> str:
        rows = ["%-16s %-18s %9d B" % (r.name, "x".join(map(str, r.shape))
                                        + (f" x{r.buffers}" if r.buffers > 1 else ""), r.nbytes)
                for r in self.residents]
        rows.append("%s: %d B of %d (%d CTAs an SM)" % (self.kernel, self.total_bytes,
                                                        SMEM_LIMIT_BYTES, self.ctas_per_sm))
        return "\n".join(rows)


def _kernel(name: str, *residents: Resident) -> KernelResidency:
    return KernelResidency(name, tuple(r for r in residents if r.nbytes))


def ivf_scan_residency(qb: int, d: int, k: int, itemsize: int, qglobal: bool = False,
                       cosine: bool = False, staged: int = _b1._STAGED) -> KernelResidency:
    """B1 ``fused_list_topk`` (``csrc/ivf_scan.cu``), one CTA of ``qb``
    queries: the queries cut to TF32 (none with ``qglobal``), ``staged``
    slices of 64 rows with their chunk's info and its ln (and, for cosine,
    li) spans, each query's top-k list and its k-th bound, candidate count,
    cut norm and tile bit, the n8 tiles' bits, the candidate rows and each
    warp's merge batch (:func:`raft_tpu_torch.ops.ivf_scan.cta_smem_bytes`)."""
    rows = _b1.ROWS_PER_CHUNK
    return _kernel(
        "fused_list_topk",
        Resident("queries_tf32", (0 if qglobal else qb, round_up(d, 32) + 8), 4),
        Resident("row_slices", (rows, _b1._DEPTH_SLICE * itemsize + _b1._ROW_PAD), 1, staged),
        Resident("chunk_info", (16,), 1, staged),
        Resident("norm_spans", (2 if cosine else 1, 4 * rows + 16), 1, staged),
        Resident("topk", (qb, k), 8),
        Resident("query_state", (qb, 4), 4),
        Resident("tile_bits", (qb // _b1._QUERIES_PER_TILE,), 4),
        Resident("candidate_rows", (round_up(qb * rows, 16),), 1),
        Resident("merge_batches", (_b1.cta_warps(qb), 32), 8),
    )


def pq_scan_residency(qb: int, K: int, k: int, g_lists: int) -> KernelResidency:
    """B2 ``fused_pq_topk`` (``csrc/pq_scan.cu``), one CTA of ``qb``
    queries: the bf16 LUT rows (2,048 columns apart at the most queries a
    CTA), each query's candidate buffer of two chunks, top-k list, q.c
    terms and candidate count, and the CTA's next work item
    (:func:`raft_tpu_torch.ops.pq_scan.cta_smem_bytes`)."""
    lut_cols = _b2._STRIDE if qb == _b2.MAX_QUERIES_PER_CTA else K
    return _kernel(
        "fused_pq_topk",
        Resident("lut", (qb, lut_cols), 2),
        Resident("candidates", (qb, _b2._CANDIDATES), 8),
        Resident("topk", (qb, k), 8),
        Resident("qc", (qb, g_lists), 4),
        Resident("counts", (qb,), 4),
        Resident("next_work", (1,), 4),
    )


def rabitq_scan_residency(qb: int, rot_dim: int, k: int, g_lists: int, rows: int,
                          mode: int = 0) -> KernelResidency:
    """B3 ``fused_rabitq_topk`` (``csrc/rabitq_scan.cu``), one CTA of
    ``qb`` queries and ``rows``-row chunks in layout ``mode`` (0 whole, 1
    depth-sliced, 2 depth-sliced without staged code rows): the byte table,
    the bf16 query and bit planes, the f32 queries (mode 0), three staged
    chunks' code, ln and g spans, row lists and chunk info, and each
    query's half sum, error bound, ``coef * q.c`` a list, top-k list and
    candidate buffer (:func:`raft_tpu_torch.ops.rabitq_scan.cta_smem_bytes`)."""
    row = 2 * (_b3._DEPTH_SLICE if mode else round_up(rot_dim, 16)) + _b3._ROW_PAD
    span = 0 if mode == 2 else round_up(rows * (rot_dim // 8) + 16, 16)
    return _kernel(
        "fused_rabitq_topk",
        Resident("byte_table", (_b3._LUT_BYTES,), 1),
        Resident("query_plane", (qb, row), 1),
        Resident("bit_plane", (rows, row), 1),
        Resident("queries_f32", (0 if mode else round_up(4 * qb * (rot_dim + 1), 16),), 1),
        Resident("code_span", (span,), 1, _b3._STAGED),
        Resident("ln_g_spans", (2, 4 * rows + 16), 1, _b3._STAGED),
        Resident("row_lists", (rows,), 4, _b3._STAGED),
        Resident("chunk_info", (16,), 1, _b3._STAGED),
        Resident("half_sums", (qb,), 4),
        Resident("error_bounds", (qb,), 4),
        Resident("coef_qc", (qb, g_lists), 4),
        Resident("topk", (qb, k), 8),
        Resident("candidates", (qb, _b3._CANDIDATES), 8),
    )


def cagra_search_residency(itopk: int, width: int, deg: int, d: int, esize: int = 4,
                           group_rows: int = 0, buffers: int = 0,
                           bitonic=None) -> KernelResidency:
    """B4 ``cagra_fused_search`` (``csrc/cagra_search.cu``), one CTA a
    query: the bitonic merge's 64-bit keys (or the rank merge's 32-bit
    union and pick keys), ``buffers`` staging buffers of ``group_rows``
    rows padded by ``ROW_PAD`` (none: rows read from global memory), the
    query, the two beams, the candidates and the parents
    (:func:`raft_tpu_torch.ops.cagra_search.smem_bytes`)."""
    w = width * deg
    m = itopk + w
    if bitonic is None:
        bitonic = m > _b4.RANK_MAX
    stage = round_up(buffers * group_rows * (d + _b4.ROW_PAD) * esize, 16)
    return _kernel(
        "cagra_fused_search",
        Resident("sort_keys", (next_pow2(m) if bitonic else 0,), 8),
        Resident("rank_keys", (0 if bitonic else round_up(m, 4) + round_up(itopk, 4),), 4),
        Resident("staged_rows", (stage,), 1),
        Resident("query", (d,), 4),
        Resident("beams", (2, itopk, 2), 4),
        Resident("candidates", (w, 2), 4),
        Resident("parents", (width,), 4),
    )


def hop_merge_residency(w: int) -> KernelResidency:
    """B5 ``hop_merge`` (``ring_fold`` in ``csrc/ring_topk.cu``), one CTA a
    row: the union of the two ``w``-wide blocks."""
    return _kernel("hop_merge", Resident("union", (2 * w,), UNION_ENTRY_BYTES))


def ring_onecard_residency(n: int, w: int, warps: int,
                           kernel: str = "fused_ring_topk") -> KernelResidency:
    """B6 ``fused_ring_topk`` and B7 ``fused_scan_ring_topk`` on one card
    (``ring_onecard``), one CTA of ``warps`` rows: each warp's union scratch
    of ``2w`` entries and its row's state (position, value, id) in all ``n``
    blocks (:func:`raft_tpu_torch.ops.ring_topk.onecard_smem_bytes`)."""
    return _kernel(
        kernel,
        Resident("union", (warps, 2 * w), UNION_ENTRY_BYTES),
        Resident("row_state", (warps, n, w, 3), 4),
    )


#: the served 1M-row path's shapes (``chip_smoke.py`` phases 3-7): d, k, the
#: refine ratio, IVF-Flat's query tile, IVF-PQ's pq_dim and lists a unit,
#: RaBitQ's query tile and lists a unit, CAGRA's (itopk, width, degree) with a
#: bf16 table at the serving batch, the sharded search's shards
_MAIN = dict(d=128, k=10, refine_ratio=8, flat_qt=16, pq_dim=64, pq_group=8, rabitq_qt=128,
             rabitq_group=8, cagra=(128, 8, 16), table_esize=2, nq=128, shards=4)


def main_path_residencies(sms: int = 132) -> Tuple[Tuple[KernelResidency, tuple], ...]:
    """Each kernel's residency at the served 1M-row path's shapes
    (:data:`_MAIN`), beside the arguments of its ``*_smem_bytes`` export,
    for the card check: B1 at k on f32 lists, B2 on nibble codes at ``k *
    refine_ratio``, B3 at ``k * refine_ratio``, B4 with
    :func:`~raft_tpu_torch.ops.cagra_search.launch_plan`'s staging on
    ``sms`` SMs (the occupancy there counted from shared memory alone), B5
    at one hop's width k, B6 and B7 over the shards' blocks of width k. The
    export's arguments are its C signature's (B1's sixth is the metric
    code, 0 for L2)."""
    m = _MAIN
    d, k = m["d"], m["k"]
    kk = k * m["refine_ratio"]
    b1 = _b1.cta_plan(d, k, 4, m["flat_qt"])
    K = 2 * 16 * m["pq_dim"]  # nibble codes: 2 lookups of 16 columns a byte
    qb2 = _b2.queries_per_cta(K, kk, m["pq_group"])
    b3 = _b3.cta_plan(d, kk, m["rabitq_group"], m["rabitq_qt"])
    itopk, width, deg = m["cagra"]
    b4 = _b4.launch_plan(itopk, width, deg, d, m["table_esize"], m["nq"], sms)
    warps = _ring.onecard_warps(m["shards"], k)
    return (
        (ivf_scan_residency(b1.queries, d, k, 4, b1.qglobal, False, b1.staged),
         ("ivf_scan_smem_bytes", b1.queries, d, k, 4, int(b1.qglobal), 0, b1.staged)),
        (pq_scan_residency(qb2, K, kk, m["pq_group"]),
         ("pq_scan_smem_bytes", qb2, K, kk, m["pq_group"])),
        (rabitq_scan_residency(b3.queries, d, kk, m["rabitq_group"], b3.rows, b3.mode),
         ("rabitq_scan_smem_bytes", b3.queries, d, kk, m["rabitq_group"], b3.rows, b3.mode)),
        (cagra_search_residency(itopk, width, deg, d, m["table_esize"], b4.group_rows,
                                b4.buffers, b4.bitonic),
         ("cagra_search_smem_bytes", itopk, width, deg, d, m["table_esize"], b4.group_rows,
          b4.buffers, int(b4.bitonic))),
        (hop_merge_residency(k), ("ring_onecard_smem_bytes", 0, k, 1)),
        (ring_onecard_residency(m["shards"], k, warps),
         ("ring_onecard_smem_bytes", m["shards"], k, warps)),
        (ring_onecard_residency(m["shards"], k, warps, "fused_scan_ring_topk"),
         ("ring_onecard_smem_bytes", m["shards"], k, warps)),
    )
