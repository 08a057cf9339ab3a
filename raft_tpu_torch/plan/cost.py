"""Cost terms for the query planner (``raft_tpu.plan.cost`` counterpart):
one price list over the port's resource models.

Every candidate the planner enumerates is priced as a sum of
:class:`CostTerm` entries in **cost units** (``cu``), a relative
device-time scale. The coefficients are the JAX package's, calibrated so
each decision's crossover lands where its inline rule put it: probe up to
127 queries, then the dense scan or the fused kernel from 128 (the fused
kernel wherever it is eligible); the ring over the gather merge for more
than one shard, from the wire model; the CA exchange over the full one
wherever its row cap undercuts it. Wire terms convert bytes to cu at
:data:`CU_PER_WIRE_BYTE`. So the planner changes no choice of the port's
inline rules. The card's own times per bucket (``chip_smoke.py --phases
tiered``) are what a recalibration would start from; it would change
choices, and is later work.

The sources feeding these terms:

* :mod:`raft_tpu_torch.ops.smem_model`: a hand kernel's shared memory,
  consumed as *eligibility* (the call site passes its kernel verdict in as
  ``fused_ok``);
* :mod:`raft_tpu_torch.ops.hbm_model`: device/host placement (the
  registration plan's tier label);
* :mod:`raft_tpu_torch.parallel.wire_model`: the merge's and the
  distributed builds' bytes;
* live traffic: the engine's per-bucket batch counts and rows/s EWMA (the
  registration plan's re-planning inputs).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

from raft_tpu_torch.parallel.wire_model import (
    AG_ENTRY_BYTES,
    RS_ENTRY_BYTES,
    codebook_wire_bytes_per_iter,
    lloyd_wire_bytes_per_iter,
    wire_bytes_per_query,
)


@dataclasses.dataclass(frozen=True)
class CostTerm:
    """One additive component of a candidate's cost."""

    name: str
    value: float  # cu
    note: str = ""

    def render(self) -> str:
        return f"{self.name} {self.value:.2f}" + (f" ({self.note})" if self.note else "")


#: cu per fabric byte — puts wire terms on the compute axis (one cu
#: ~ one merged candidate entry; an 8-byte (val, id) entry costs 1 cu
#: to ship, matching the merge cost of consuming it).
CU_PER_WIRE_BYTE = 1.0 / 8.0

# -- search-mode engine coefficients (ivf_flat / ivf_pq, incl. rabitq) --
#
# probe = per-query gather dispatch (the latency path: per-probe
# dynamic-slice gathers defeat batching); scan = one dense masked scan
# launch amortized over the batch; fused = the probed-list kernel (B1, B2,
# B3): cheaper per query than scan (only probed lists move), dearer to
# launch. The JAX package's batch-128 crossover: probe wins
# through nq=127, scan/fused from nq=128, fused beats scan whenever the
# kernel is eligible (and loses to probe below the crossover, keeping
# the latency path on small batches).
PROBE_CU_PER_QUERY = 2.0
SCAN_LAUNCH_CU = 127.5
SCAN_CU_PER_QUERY = 1.0
FUSED_LAUNCH_CU = 159.0
FUSED_CU_PER_QUERY = 0.75

# -- cagra engine coefficients --
#
# The beam state stays in the fused kernel's shared memory (B4) and every
# parent's rows come in one asynchronous fetch; the "xla" loop re-gathers
# from device memory each iteration. Fused wins at every batch size whenever
# eligible (the legacy rule), so the coefficients only need ordering.
CAGRA_XLA_LAUNCH_CU = 64.0
CAGRA_XLA_CU_PER_QUERY = 1.0
CAGRA_FUSED_LAUNCH_CU = 32.0
CAGRA_FUSED_CU_PER_QUERY = 0.5

# -- merge-engine coefficients --
#
# gather materialises the full n·k candidate set on every shard and
# k-way merges it there (1 cu per merged entry); the rings fold k-wide
# (1 cu per folded entry per hop window) and ship fewer bytes for
# n > 2. scan-fold fusion saves the [nq, width] candidate tile's HBM
# round-trip when the scan emits wider-than-k tiles; at width == k it
# is the plain ring plus kernel-dispatch overhead.
MERGE_CU_PER_ENTRY = 1.0
RING_FOLD_CU_PER_ENTRY = 1.0
FUSED_RING_SETUP_CU = 0.5
HBM_ROUNDTRIP_CU_PER_ENTRY = 1.0

# -- delta-scan coefficients (mutable delta path) --
#
# exact = a separate plain delta scan + merge against the main segment's
# winners (two launches and a candidate round-trip); fused = the banked
# probed-list kernel folding the delta in one pass. Within the
# eligibility window fused is bit-identical and strictly cheaper.
DELTA_EXACT_CU = 3.0
DELTA_FUSED_CU = 1.0

# -- CA-exchange selection overhead (distributed builds) --
#
# the changed-row top-k select + accumulator patch each iteration;
# breaks the tie toward the reference full exchange when the byte
# models price equal (single shard) and keeps CA from winning on
# noise when the cap cannot undercut the full exchange.
CA_SELECT_CU = 1.0

# -- sparse pairwise coefficients --
#
# densify streams [block, n_cols] dense tiles (cost tracks the feature
# width); native computes the sort-merge gram without densifying —
# a fixed overhead calibrated at the 2^18-column densification-sanity
# bound the legacy dispatch used.
DENSIFY_CU_PER_COL = 1.0
NATIVE_GRAM_CU = float(1 << 18)


def search_mode_terms(mode: str, nq: int) -> Tuple[CostTerm, ...]:
    """Per-batch cost of one IVF search engine at batch size ``nq``."""
    if mode == "probe":
        return (CostTerm("gather", PROBE_CU_PER_QUERY * nq,
                         f"{PROBE_CU_PER_QUERY:g} cu/query per-probe gather"),)
    if mode == "scan":
        return (
            CostTerm("launch", SCAN_LAUNCH_CU, "dense masked scan launch"),
            CostTerm("stream", SCAN_CU_PER_QUERY * nq,
                     f"{SCAN_CU_PER_QUERY:g} cu/query list streaming"),
        )
    # fused
    return (
        CostTerm("launch", FUSED_LAUNCH_CU, "kernel launch"),
        CostTerm("stream", FUSED_CU_PER_QUERY * nq,
                 f"{FUSED_CU_PER_QUERY:g} cu/query probed-list scan"),
    )


def cagra_mode_terms(mode: str, nq: int) -> Tuple[CostTerm, ...]:
    """Per-batch cost of one CAGRA beam engine at batch size ``nq``."""
    if mode == "xla":
        return (
            CostTerm("launch", CAGRA_XLA_LAUNCH_CU, "per-iteration gather loop"),
            CostTerm("beam", CAGRA_XLA_CU_PER_QUERY * nq, "device re-gather per hop"),
        )
    return (
        CostTerm("launch", CAGRA_FUSED_LAUNCH_CU, "kernel launch"),
        CostTerm("beam", CAGRA_FUSED_CU_PER_QUERY * nq, "beam state in shared memory"),
    )


def merge_mode_terms(mode: str, n_shards: int, k: int,
                     tile_width: int) -> Tuple[CostTerm, ...]:
    """Per-query cost of one cross-shard merge engine.

    ``tile_width`` is the per-shard candidate width entering the merge
    (``k`` at the classic call sites; ``k·refine_ratio`` when the scan's
    tile feeds the fused ring directly)."""
    wire = wire_bytes_per_query(n_shards, k, "gather" if mode == "gather" else "ring")
    terms = [CostTerm("wire", wire * CU_PER_WIRE_BYTE,
                      f"{wire:.0f} B/query over {n_shards} shards")]
    if mode == "gather":
        terms.append(CostTerm("merge", MERGE_CU_PER_ENTRY * n_shards * k,
                              f"k-way merge over n·k={n_shards * k} on every shard"))
        if tile_width > k:
            terms.append(CostTerm("prefold", RING_FOLD_CU_PER_ENTRY * tile_width,
                                  "fold scan tile to k before the exchange"))
            terms.append(CostTerm("hbm_roundtrip",
                                  HBM_ROUNDTRIP_CU_PER_ENTRY * (tile_width - k),
                                  "[nq, width] tile through HBM"))
        return tuple(terms)
    if mode == "ring":
        terms.append(CostTerm("fold", RING_FOLD_CU_PER_ENTRY * k, "k-wide hop fold"))
        if tile_width > k:
            terms.append(CostTerm("prefold", RING_FOLD_CU_PER_ENTRY * tile_width,
                                  "fold scan tile to k before the ring"))
            terms.append(CostTerm("hbm_roundtrip",
                                  HBM_ROUNDTRIP_CU_PER_ENTRY * (tile_width - k),
                                  "[nq, width] tile through HBM"))
        return tuple(terms)
    # fused_ring: the scan's tile folds inside the ring engine — the
    # tile never round-trips HBM, the ring's hop fold consumes it raw
    terms.append(CostTerm("fold", RING_FOLD_CU_PER_ENTRY * tile_width,
                          "in-engine scan-tile fold"))
    terms.append(CostTerm("setup", FUSED_RING_SETUP_CU, "scan-to-ring kernel handoff"))
    return tuple(terms)


def comm_mode_terms(mode: str, n_rows: int, d: int, n_shards: int,
                    ca_cap=None) -> Tuple[CostTerm, ...]:
    """Per-iteration cost of one distributed-build accumulator exchange
    over ``[n_rows, d+1]`` f32 accumulator rows."""
    wire = lloyd_wire_bytes_per_iter(n_rows, d, n_shards, comm_mode=mode,
                                     ca_cap=ca_cap)
    terms = [CostTerm("wire", wire * CU_PER_WIRE_BYTE,
                      f"{wire:.0f} B/iter over {n_shards} shards")]
    if mode == "ca":
        terms.append(CostTerm("select", CA_SELECT_CU,
                              "changed-row top-k select + patch"))
    return tuple(terms)


def delta_mode_terms(mode: str) -> Tuple[CostTerm, ...]:
    """Per-batch cost of one mutable delta-scan engine."""
    if mode == "exact":
        return (CostTerm("scan_merge", DELTA_EXACT_CU,
                         "plain delta scan + main-segment merge"),)
    return (CostTerm("banked_scan", DELTA_FUSED_CU,
                     "one banked probed-list kernel pass"),)


def pq_kind_terms(kind: str, pq_dim: int, pq_bits: int) -> Tuple[CostTerm, ...]:
    """Per-row decode/footprint cost of one PQ code family."""
    code_bytes = pq_dim * pq_bits / 8.0
    if kind == "rabitq":
        return (CostTerm("codes", code_bytes, "1 sign bit per rotated dim"),
                CostTerm("decode", 0.25 * pq_dim, "popcount estimator"))
    if kind == "nibble":
        return (CostTerm("codes", code_bytes, "additive nibble books"),
                CostTerm("decode", 0.5 * pq_dim, "one multi-hot decode pass"))
    return (CostTerm("codes", code_bytes, "k-means codebooks"),
            CostTerm("decode", 1.0 * pq_dim, "per-subspace LUT gather"))


def sparse_mode_terms(mode: str, n_cols: int) -> Tuple[CostTerm, ...]:
    """Per-block cost of one sparse pairwise engine at feature width
    ``n_cols``."""
    if mode == "densify":
        return (CostTerm("densify", DENSIFY_CU_PER_COL * n_cols,
                         f"[block, {n_cols}] dense tiles"),)
    return (CostTerm("gram", NATIVE_GRAM_CU, "sort-merge gram, no densify"),)


__all__ = [
    "AG_ENTRY_BYTES",
    "RS_ENTRY_BYTES",
    "CU_PER_WIRE_BYTE",
    "CostTerm",
    "cagra_mode_terms",
    "codebook_wire_bytes_per_iter",
    "comm_mode_terms",
    "delta_mode_terms",
    "lloyd_wire_bytes_per_iter",
    "merge_mode_terms",
    "pq_kind_terms",
    "search_mode_terms",
    "sparse_mode_terms",
    "wire_bytes_per_query",
]
