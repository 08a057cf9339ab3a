"""Roofline counts of the IVF scan kernels, from the inputs of a search
call alone, so that the count reads the same work whatever implements it.

* Bytes: each probed list's filled rows read once over the call (the row
  payload, its id and its norm), the queries, the centres (and the PQ
  codebooks) read once, and the outputs written once.
* Operations: ``2 * dim`` a (query, probed row) pair for IVF-Flat at the
  TF32 dense rate; ``pq_dim`` lookup-adds a pair for IVF-PQ at the bf16
  dense rate (the rate of its bf16 LUT).

The probe sets are worked out here by plain PyTorch from the index's
centres, never read from the program's probe output. The bound is the
larger of bytes over bandwidth and operations over the rate.
"""
from __future__ import annotations

from typing import Dict

import torch

from perfbench.reference import ivf as ref

#: NVIDIA H100 SXM5 80 GB, published dense rates at the 700 W limit
PEAKS = {
    "hbm_bytes_per_s": 3.35e12,
    "tf32_flops_per_s": 494.7e12,
    "bf16_flops_per_s": 989.4e12,
}

#: bytes of an id and of a squared norm kept beside each row
ID_BYTES, NORM_BYTES = 4, 4
#: bytes of one output slot: a float32 distance and an int32 id
OUT_BYTES = 8


def _probed(view: Dict[str, torch.Tensor], queries: torch.Tensor, n_probes: int):
    """``(pairs, union of probed lists)`` of one call."""
    sizes = view["list_sizes"].to(torch.int64)
    p = torch.cat([ref.probes(view["centers"], queries[s : s + 4096], n_probes)
                   for s in range(0, queries.shape[0], 4096)])
    pairs = int(sizes[p].sum())
    union = torch.unique(p)
    return pairs, int(sizes[union].sum())


def ivf_flat_scan(view: Dict[str, torch.Tensor], queries: torch.Tensor, *, n_probes: int,
                  k: int) -> Dict[str, float]:
    """B1's work in one call of ``nq`` queries."""
    nq, dim = queries.shape
    pairs, rows = _probed(view, queries, n_probes)
    n_lists = view["centers"].shape[0]
    flops = 2.0 * dim * pairs
    nbytes = (rows * (dim * 4 + ID_BYTES + NORM_BYTES) + nq * dim * 4 + n_lists * dim * 4
              + nq * k * OUT_BYTES)
    return _bound(flops, PEAKS["tf32_flops_per_s"], nbytes)


def ivf_pq_scan(view: Dict[str, torch.Tensor], queries: torch.Tensor, *, n_probes: int,
                k_scan: int) -> Dict[str, float]:
    """B2's work in one call: ``k_scan`` candidates a query leave it (the
    search's ``k`` times its refine ratio)."""
    nq, dim = queries.shape
    pairs, rows = _probed(view, queries, n_probes)
    codes, books = view["codes"], view["pq_centers"]
    pq_dim, code_bytes = books.shape[0], codes.shape[-1]
    n_lists = view["centers"].shape[0]
    flops = float(pq_dim) * pairs
    nbytes = (rows * (code_bytes + ID_BYTES + NORM_BYTES) + nq * dim * 4
              + n_lists * dim * 4 + books.numel() * 4 + nq * k_scan * OUT_BYTES)
    return _bound(flops, PEAKS["bf16_flops_per_s"], nbytes)


def _bound(flops: float, rate: float, nbytes: float) -> Dict[str, float]:
    t_ops, t_bytes = flops / rate, nbytes / PEAKS["hbm_bytes_per_s"]
    return {"flops": flops, "bytes": float(nbytes), "bound_s": max(t_ops, t_bytes),
            "by": "operations" if t_ops >= t_bytes else "bytes"}
