"""Fused CAGRA beam search (``raft_tpu.ops.pallas.cagra_search`` counterpart).

Each query keeps a beam of ``itopk`` slots: a min-ordered f32 value and an
int32 ``id * 2 + visited`` (-1 = empty). Each of ``iters`` steps

1. picks ``width`` parents: rounds of min-extract over the beam with
   visited and empty slots masked to :data:`WORST` (ties to the lowest
   slot; a pick is valid only if its value is below :data:`WORST`), and
   marks them visited;
2. scores the parents' ``width * deg`` neighbours in f32 from the
   neighbour table, ``sum((q - v)^2)`` for L2 or ``-sum(q * v)`` for inner
   product; an invalid parent or a -1 graph entry gives id -1 and value
   :data:`WORST`;
3. merges: the union of the beam (first) and the candidates (flag 0) is
   sorted stably by value, the first ``itopk`` are kept, slots of value
   ``>= WORST`` become id -1, and an id equal to its left neighbour's is
   killed to ``(WORST, -1)`` (the ``dedup="post"`` semantics).

The sum of each score runs in a fixed order, the one of the kernel's warp:
lane ``l`` adds the terms of dimensions ``l, l + 32, ...`` in turn, then
the 32 lane sums fold as a shuffle tree (offsets 16, 8, 4, 2, 1). So the
same id always scores to the same bits, whichever parent proposes it, and
:func:`cagra_beam_reference` gives the kernel's bits.

Neighbour table: ``[n, deg, d]`` in the table dtype, row ``(v, j)`` =
``dataset[graph[v, j]]`` rounded to the dtype (round to nearest even), the
vectors of the JAX package's ``build_neighbor_table`` without its three id
rows: the ids are read from the int32 graph. At bf16, d = 128 and deg = 16
a parent's neighbours are one contiguous 4 KB read.

:func:`cagra_fused_search` runs the hand-written Hopper kernel
``raft_tpu_torch/csrc/cagra_search.cu`` on CUDA tensors (it raises if the
kernel cannot be built or launched) and :func:`cagra_beam_reference` on
CPU tensors. The kernel picks the parents by rank (:func:`pick_ranks`),
stages the parents' rows in shared memory as :func:`launch_plan` lays
them out, and merges by rank (:func:`rank_merge`);
:func:`cagra_beam_kernel_reference` is that schedule in plain PyTorch.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from raft_tpu_torch.core.errors import LogicError, RaftError, expects
from raft_tpu_torch.ops.cuda_build import build_library
from raft_tpu_torch.ops.pq_scan import SMEM_LIMIT_BYTES
from raft_tpu_torch.utils.math import cdiv, next_pow2, round_up

#: Largest node count the JAX package's packed table supports (three 8-bit
#: id digits); kept so that ``fused_eligible`` decides as the JAX package does.
MAX_TABLE_IDS = (1 << 24) - 2

#: Finite "worst" beam value (the JAX kernel's sentinel), mapped to the
#: metric's worst value outside the kernel.
WORST = 3.0e38

#: threads of a CTA (one CTA a query), ``THREADS`` in the .cu
THREADS = 256
#: candidates a warp scores at once (``BATCH``)
BATCH = 4
#: largest union (``itopk + width * deg``) merged by rank; past it the
#: bitonic sort (``RANK_MAX``)
RANK_MAX = 512
#: the kernel's ``__launch_bounds__`` minimum of CTAs an SM (``MIN_CTAS``)
MIN_CTAS = 5
#: elements after each staged row, so the four rows a warp reads at once
#: sit on other banks (``ROW_PAD``)
ROW_PAD = 8
#: shared memory of one SM, and what each CTA reserves of it
SM_SMEM_BYTES = 233472
CTA_RESERVED_BYTES = 1024
_MASKED = (1 << 32) - 1  # a masked slot's pick key

_SIGNATURES = {
    "cagra_search_beam":
        [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10
        + [ctypes.c_void_p] * 2,
    "cagra_search_layout": [ctypes.c_void_p],
    "cagra_search_smem_bytes": [ctypes.c_int] * 8,
    "cagra_search_ctas_per_sm": [ctypes.c_int] * 3 + [ctypes.c_void_p],
}
#: the constants above as ``cagra_search_layout`` reports the kernel's;
#: :func:`build_kernel` checks that they agree
_LAYOUT = (THREADS, BATCH, RANK_MAX, MIN_CTAS, ROW_PAD)
#: the stage clock's stages (``csrc/stage_clock.cuh``) in the record of
#: :func:`cagra_fused_search_stages`, then the warps' and the CTA's total
#: cycles and the counts of ``COUNTS``
STAGES = ("pick", "fetch", "score", "merge", "dedup", "barrier")
COUNTS = ("parents", "rows")


def build_kernel(verbose: bool = False) -> Tuple[ctypes.CDLL, float, str]:
    """Build ``csrc/cagra_search.cu`` for ``sm_90a`` (once per source
    version) and load it, checking that the kernel's constants are the ones
    this module mirrors. Returns ``(library, build seconds, compiler
    output)``."""
    lib, seconds, log = build_library("cagra_search.cu", _SIGNATURES, verbose=verbose)
    got = (ctypes.c_int * len(_LAYOUT))()
    lib.cagra_search_layout(got)
    if tuple(got) != _LAYOUT:
        raise RaftError(f"cagra_search.cu's constants {tuple(got)} are not the wrapper's {_LAYOUT}")
    return lib, seconds, log


# ---------------------------------------------------------------------------
# the kernel's shared memory and launch plan
# ---------------------------------------------------------------------------


def smem_bytes(itopk: int, width: int, deg: int, d: int, esize: int = 4, group_rows: int = 0,
               buffers: int = 0, bitonic: Optional[bool] = None) -> int:
    """Dynamic shared memory of one CTA, the kernel's ``layout``: with
    ``bitonic`` (by default past :data:`RANK_MAX` union entries) the 64-bit
    sort keys padded to a power of two, the pick's keys among them, else the
    union's and the pick's 32-bit keys padded to 4; ``buffers`` of
    ``group_rows`` staged rows of ``d +`` :data:`ROW_PAD` elements of
    ``esize`` bytes (none: rows read from global memory), 16-byte aligned;
    the query, two beams,
    the candidates and the parents. Unstaged and bitonic it is the
    kernel's first layout's count, ``8 * next_pow2(m) + 4 * (d + 4 * itopk
    + 2 * w + width)``, so every shape that fitted it still fits."""
    w = width * deg
    m = itopk + w
    if bitonic is None:
        bitonic = m > RANK_MAX
    keys = 8 * next_pow2(m) if bitonic else 0
    stage = round_up(buffers * group_rows * (d + ROW_PAD) * esize, 16)
    ranks = 0 if bitonic else 4 * (round_up(m, 4) + round_up(itopk, 4))
    return keys + stage + ranks + 4 * (d + 4 * itopk + 2 * w + width)


@dataclasses.dataclass(frozen=True)
class BeamPlan:
    """How a launch lays out a step's rows: ``group_rows`` rows staged at
    once in ``buffers`` (1: every row of a step at once; 2: a ring, group g
    + 1 copied while group g is scored) or, with ``group_rows`` 0, read
    from global memory; ``bitonic`` for the bitonic merge; the shared
    memory of one CTA and how many CTAs an SM then holds."""

    group_rows: int
    buffers: int
    bitonic: bool
    smem_bytes: int
    ctas_per_sm: int


def smem_ctas_per_sm(smem: int, max_ctas: int = 2048 // THREADS) -> int:
    """CTAs of ``smem`` bytes that fit an SM's shared memory, at most
    ``max_ctas`` (what the threads, or the registers, allow)."""
    return max(0, min(max_ctas, SM_SMEM_BYTES // (smem + CTA_RESERVED_BYTES)))


def launch_plan(itopk: int, width: int, deg: int, d: int, esize: int, nq: int, sms: int,
                ctas_per_sm: Callable[[int, bool], int] = lambda smem, direct: smem_ctas_per_sm(smem)
                ) -> BeamPlan:
    """The staging of a launch of ``nq`` queries (one CTA each) on ``sms``
    SMs. The options, in order: every row of a step at once; groups of a
    quarter, an eighth, ... down to one row of the step's ``width * deg``
    in a ring of two buffers; rows read from global memory, each with the
    rank merge where its keys fit and the union is at most
    :data:`RANK_MAX`, else the bitonic sort. Of the options whose shared
    memory fits a CTA, the first whose CTAs run in as few waves as any
    option's is taken: the fewest groups that do not cost a wave (on the
    card, staging every row of the serving batch's step beat groups of a
    quarter at 128 queries and at 1,024, where both take two waves).
    ``ctas_per_sm(smem, direct)``: CTAs an SM holds at that shared memory
    (on the card the occupancy calculator's answer)."""
    w = width * deg
    merges = (True,) if itopk + w > RANK_MAX else (False, True)
    options = [(w, 1)]
    k = 4
    while cdiv(w, k) > 1:
        options.append((cdiv(w, k), 2))
        k *= 2
    options += [(1, 2), (0, 0)]
    plans = []
    for rows, bufs in dict.fromkeys(options):
        for bitonic in merges:  # the rank merge where its keys fit, else the bitonic sort
            smem = smem_bytes(itopk, width, deg, d, esize, rows, bufs, bitonic)
            if smem <= SMEM_LIMIT_BYTES:
                plans.append(BeamPlan(rows, bufs, bitonic, smem, ctas_per_sm(smem, rows == 0)))
                break
    if not plans:
        raise LogicError(
            f"cagra_fused_search: itopk {itopk} + width*deg {w} at d {d} needs "
            f"{smem_bytes(itopk, width, deg, d, esize, bitonic=True)} bytes of shared memory per "
            f"query, more than one CTA holds ({SMEM_LIMIT_BYTES})")
    waves = [cdiv(nq, max(1, sms * p.ctas_per_sm)) for p in plans]
    return plans[waves.index(min(waves))]


def build_neighbor_table(dataset, graph, *, dtype=torch.bfloat16, row_chunk: int = 65536) -> torch.Tensor:
    """``[n, deg, d]`` neighbour vectors in ``dtype``: row ``(v, j)`` is
    ``dataset[graph[v, j]]`` (row 0 for a -1 entry, whose id masks it)."""
    n, d = dataset.shape
    deg = graph.shape[1]
    out = torch.empty((n, deg, d), dtype=dtype, device=dataset.device)
    for s in range(0, n, row_chunk):
        g = graph[s : s + row_chunk].to(torch.int64)
        out[s : s + row_chunk] = dataset[torch.clamp(g, min=0)].to(dtype)
    return out


def _check_args(table, graph, queries, init_v, init_idf, itopk: int, width: int, iters: int):
    expects(table.ndim == 3 and table.dtype in (torch.float32, torch.bfloat16),
            "table must be [n, deg, d] float32 or bfloat16")
    n, deg, d = table.shape
    expects(tuple(graph.shape) == (n, deg), "graph must be [n, deg] = [%d, %d]", n, deg)
    expects(queries.ndim == 2 and queries.shape[1] == d, "queries must be [nq, %d]", d)
    nq = queries.shape[0]
    expects(tuple(init_v.shape) == (nq, itopk) and tuple(init_idf.shape) == (nq, itopk),
            "init_v and init_idf must be [nq, itopk] = [%d, %d]", nq, itopk)
    expects(1 <= width <= itopk, "search width %d outside [1, itopk=%d]", width, itopk)
    expects(iters >= 0, "iters must be >= 0")


def pick_positions(vals, width: int, worst: float):
    """``width`` rounds of min-extract over ``[nq, itopk]`` (the reference's
    ``pickup_next_parents``): positions ``[nq, width]``, ties to the lowest
    slot, and whether each beat ``worst``, the value of masked slots."""
    cols = torch.arange(vals.shape[1], device=vals.device)[None, :]
    poss, valids = [], []
    for _ in range(width):
        mv = torch.min(vals, dim=1, keepdim=True).values
        sel = torch.min(torch.where(vals == mv, cols, vals.shape[1]), dim=1, keepdim=True).values
        poss.append(sel)
        valids.append(mv != worst)
        vals = torch.where(cols == sel, torch.full_like(vals, worst), vals)
    return torch.cat(poss, dim=1), torch.cat(valids, dim=1)


def lane_tree_score(q, vecs, ip: bool) -> torch.Tensor:
    """``sum((q - v)^2)`` (or ``-sum(q * v)``) over the last axis in the
    kernel's order: per lane ``l`` the terms of dimensions ``l, l + 32,
    ...`` in turn, then a shuffle tree over the 32 lane sums."""
    if ip:
        e = q * vecs
    else:
        diff = q - vecs
        e = diff * diff
    d = e.shape[-1]
    e = torch.nn.functional.pad(e, (0, round_up(d, 32) - d)).reshape(*e.shape[:-1], -1, 32)
    acc = torch.zeros(e.shape[:-2] + (32,), dtype=torch.float32, device=e.device)
    for r in range(e.shape[-2]):
        acc = acc + e[..., r, :]
    for off in (16, 8, 4, 2, 1):
        acc = acc[..., :off] + acc[..., off : 2 * off]
    return -acc[..., 0] if ip else acc[..., 0]


def cagra_beam_reference(table, graph, queries, init_v, init_idf, *, itopk: int, width: int,
                         iters: int, ip: bool = False,
                         work: Optional[dict] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel, step for step and in its
    arithmetic order. Returns the final beam ``(values [nq, itopk] f32,
    id * 2 + visited [nq, itopk] i32)``. ``work``, if given, counts what
    these inputs make the kernel read: ``"ids"`` graph entries of valid
    parents and ``"rows"`` table rows scored."""
    _check_args(table, graph, queries, init_v, init_idf, itopk, width, iters)
    nq, d = queries.shape
    deg = table.shape[1]
    dev = queries.device
    qf = queries.to(torch.float32)[:, None, :]
    beam_v = init_v.to(torch.float32)
    beam_idf = init_idf.to(torch.int32)
    cols = torch.arange(itopk, device=dev)[None, :]
    worst = torch.tensor(WORST, dtype=torch.float32, device=dev)
    for _ in range(iters):
        masked = torch.where(((beam_idf & 1) == 1) | (beam_idf < 0), worst, beam_v)
        ppos, pvalid = pick_positions(masked, width, WORST)
        parents = torch.where(pvalid, torch.gather(beam_idf, 1, ppos) >> 1, -1)
        picked = torch.zeros_like(beam_idf, dtype=torch.bool)
        for w in range(width):
            picked |= (cols == ppos[:, w : w + 1]) & pvalid[:, w : w + 1]
        beam_idf = torch.where(picked, beam_idf | 1, beam_idf)
        safe = torch.clamp(parents, min=0).to(torch.int64)
        cid = torch.where(parents[:, :, None] >= 0, graph[safe], -1).reshape(nq, width * deg)
        if work is not None:
            work["ids"] = work.get("ids", 0) + int((parents >= 0).sum()) * deg
            work["rows"] = work.get("rows", 0) + int((cid >= 0).sum())
        vecs = table[safe].to(torch.float32).reshape(nq, width * deg, d)
        cv = torch.where(cid >= 0, lane_tree_score(qf, vecs, ip), worst)
        uv = torch.cat([beam_v, cv], dim=1)
        uidf = torch.cat([beam_idf, cid * 2], dim=1)
        # sort on +0.0-canonical keys: -0.0 and 0.0 tie, as in the kernel
        _, pos = torch.sort(uv + 0.0, dim=1, stable=True)
        pos = pos[:, :itopk]
        nv = torch.gather(uv, 1, pos)
        nidf = torch.where(nv >= WORST, -1, torch.gather(uidf, 1, pos))
        ids = nidf >> 1
        prev = torch.cat([torch.full_like(ids[:, :1], -2), ids[:, :-1]], dim=1)
        dup = (ids == prev) & (ids >= 0)
        beam_v = torch.where(dup, worst, nv)
        beam_idf = torch.where(dup, -1, nidf).to(torch.int32)
    return beam_v, beam_idf


# ---------------------------------------------------------------------------
# the kernel's schedule in plain PyTorch
# ---------------------------------------------------------------------------


def order_keys(vals) -> torch.Tensor:
    """The kernel's 32-bit order-preserving keys of f32 ``vals`` (as int64):
    ``-0`` folded onto ``+0``, negative floats (NaN too) below positive
    ones, each sign's NaNs beyond its infinity."""
    u = (vals.to(torch.float32) + 0.0).view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return torch.where(u >= 1 << 31, 0xFFFFFFFF - u, u | 1 << 31)


def _ranks(keys) -> torch.Tensor:
    """Each element's position in the (key, index) order of ``keys [nq,
    n]`` (unique: the index breaks ties), the kernel's ``rank_of``."""
    n = keys.shape[1]
    idx = torch.arange(n, device=keys.device)
    below = (keys[:, None, :] < keys[:, :, None]) | (
        (keys[:, None, :] == keys[:, :, None]) & (idx[None, None, :] < idx[None, :, None]))
    return below.sum(dim=2)


def pick_ranks(vals, idf, width: int, sorted_beam: bool = False):
    """The kernel's pick: the unmasked slots (not visited, not empty, value
    below :data:`WORST`) of rank ``< width`` in the (key, slot) order, masked
    slots keyed above every unmasked one; with ``sorted_beam`` (a merged
    beam, sorted by (key, slot) but for masked slots) the rank is the count
    of unmasked slots before it, as the kernel counts after its first step.
    Returns ``(positions [nq, width], valid [nq, width])`` as
    :func:`pick_positions` over the masked values gives them (an invalid
    pick's position is 0)."""
    nq, itopk = vals.shape
    masked = ((idf & 1) == 1) | (idf < 0) | ~(vals < WORST)
    if sorted_beam:
        rank = torch.where(masked, itopk, torch.cumsum(~masked, dim=1) - 1)
    else:
        rank = torch.where(masked, itopk, _ranks(torch.where(masked, _MASKED, order_keys(vals))))
    pos = torch.zeros((nq, width), dtype=torch.int64, device=vals.device)
    valid = torch.zeros((nq, width), dtype=torch.bool, device=vals.device)
    q, s = torch.nonzero(rank < width, as_tuple=True)
    pos[q, rank[q, s]] = s
    valid[q, rank[q, s]] = True
    return pos, valid


def rank_merge(uv, uidf, itopk: int):
    """The kernel's merge of the union ``uv``/``uidf [nq, m]`` (beam slots
    first): element of rank ``r < itopk`` in the (key, position) order to
    slot ``r``, a value ``>= WORST`` to id -1, then the adjacent-id kill.
    Returns the new beam ``(values, id * 2 + visited)``."""
    rank = _ranks(order_keys(uv))
    nq = uv.shape[0]
    tv = torch.empty((nq, itopk), dtype=torch.float32, device=uv.device)
    ti = torch.empty((nq, itopk), dtype=torch.int32, device=uv.device)
    q, e = torch.nonzero(rank < itopk, as_tuple=True)
    tv[q, rank[q, e]] = uv[q, e]
    ti[q, rank[q, e]] = torch.where(uv[q, e] >= WORST, -1, uidf[q, e]).to(torch.int32)
    ids = ti >> 1
    prev = torch.cat([torch.full_like(ids[:, :1], -2), ids[:, :-1]], dim=1)
    dup = (ids == prev) & (ids >= 0)
    return torch.where(dup, torch.tensor(WORST, dtype=torch.float32, device=uv.device), tv), \
        torch.where(dup, -1, ti).to(torch.int32)


def cagra_beam_kernel_reference(table, graph, queries, init_v, init_idf, *, itopk: int,
                                width: int, iters: int, ip: bool = False,
                                plan: Optional[BeamPlan] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's schedule in plain PyTorch, step for step: the pick by
    rank (:func:`pick_ranks`; after the first step by the count of unmasked
    slots before each), the valid parents' rows fetched
    ``plan.group_rows`` at a time (all at once by default; rows past the
    valid parents WORST / -1 unfetched), each group's candidates scored in
    the kernel's batches of :data:`BATCH` a warp, each in its own lane
    order (:func:`lane_tree_score`), and the rank merge
    (:func:`rank_merge`). Returns the final beam, which must equal
    :func:`cagra_beam_reference`'s bit for bit."""
    _check_args(table, graph, queries, init_v, init_idf, itopk, width, iters)
    nq, d = queries.shape
    deg = table.shape[1]
    w_all = width * deg
    warps = THREADS // 32
    gr = w_all if plan is None or plan.group_rows == 0 else plan.group_rows
    qf = queries.to(torch.float32)
    beam_v = init_v.to(torch.float32).clone()
    beam_idf = init_idf.to(torch.int32).clone()
    for step in range(iters):
        ppos, pvalid = pick_ranks(beam_v, beam_idf, width, sorted_beam=step > 0)
        rows_q = tuple(int(x) * deg for x in pvalid.sum(dim=1))  # a prefix: the picks are ranks
        parents = torch.where(pvalid, torch.gather(beam_idf, 1, ppos) >> 1, -1)
        for q in range(nq):
            beam_idf[q, ppos[q, pvalid[q]]] |= 1
        cv = torch.full((nq, w_all), WORST, dtype=torch.float32, device=qf.device)
        ci = torch.full((nq, w_all), -1, dtype=torch.int32, device=qf.device)
        for q in range(nq):
            for g0 in range(0, rows_q[q], gr):  # one group of staged rows
                g1 = min(rows_q[q], g0 + gr)
                for warp in range(warps):
                    for c0 in range(g0 + BATCH * warp, g1, BATCH * warps):
                        cs = torch.arange(c0, min(g1, c0 + BATCH))
                        p = parents[q, cs // deg].to(torch.int64)
                        j = cs % deg
                        ids = graph[p, j].to(torch.int32)
                        score = lane_tree_score(qf[q][None, :], table[p, j].to(torch.float32), ip)
                        cv[q, cs] = torch.where(ids >= 0, score, WORST)
                        ci[q, cs] = ids
        beam_v, beam_idf = rank_merge(torch.cat([beam_v, cv], dim=1),
                                      torch.cat([beam_idf, ci * 2], dim=1), itopk)
    return beam_v, beam_idf


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------


def cagra_fused_search(table, graph, queries, init_v, init_idf, *, itopk: int, width: int,
                       iters: int, ip: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the beam loop (see the module docstring): ``table [n, deg, d]``
    f32 or bf16, ``graph [n, deg]`` i32, ``queries [nq, d]`` f32, the seeded
    beam ``init_v``/``init_idf [nq, itopk]`` (min-ordered values, negated
    for inner product, :data:`WORST` in empty slots; ids packed ``id * 2 +
    flag``, -1 empty). Returns the final beam. CUDA tensors launch the
    kernel, one CTA per query, staged as :func:`launch_plan` says
    (``cagra_fused_search.launches`` counts the launches); CPU tensors take
    the plain version."""
    if queries.device.type != "cuda":
        return cagra_beam_reference(table, graph, queries, init_v, init_idf, itopk=itopk,
                                    width=width, iters=iters, ip=ip)
    out_v, out_idf, _ = _launch(table, graph, queries, init_v, init_idf, itopk=itopk, width=width,
                                iters=iters, ip=ip)
    cagra_fused_search.launches += 1
    return out_v, out_idf


cagra_fused_search.launches = 0
cagra_fused_search.last_plan = None  # the BeamPlan of the last launch


def cagra_fused_search_stages(table, graph, queries, init_v, init_idf, *, itopk: int, width: int,
                              iters: int, ip: bool = False) -> torch.Tensor:
    """One launch of the kernel with its stage clock on (CUDA tensors
    only): int64 ``[nq, len(STAGES) + 2 + len(COUNTS)]``, per CTA (query)
    the cycles of each stage summed over its warps, the warps' and the
    CTA's own cycles, the valid parents it picked and the rows it
    scored."""
    expects(queries.device.type == "cuda", "cagra_fused_search_stages: the stage clock runs on the card")
    return _launch(table, graph, queries, init_v, init_idf, itopk=itopk, width=width, iters=iters,
                   ip=ip, record=True)[2]


_SMS: Dict[Optional[int], int] = {}
_CTAS: Dict[Tuple[bool, bool, int], int] = {}
_PLANS: Dict[tuple, BeamPlan] = {}


def _card_plan(lib, dev, itopk: int, width: int, deg: int, d: int, bf16: bool, nq: int) -> BeamPlan:
    """:func:`launch_plan` on the card (cached per shape): its SM count, and
    the occupancy calculator's CTAs an SM for each shared-memory size."""
    key = (dev.index, itopk, width, deg, d, bf16, nq)
    if key in _PLANS:
        return _PLANS[key]
    if dev.index not in _SMS:
        _SMS[dev.index] = torch.cuda.get_device_properties(dev).multi_processor_count

    def ctas(smem: int, direct: bool) -> int:
        at = (bf16, direct, smem)
        if at not in _CTAS:
            out = ctypes.c_int(0)
            err = lib.cagra_search_ctas_per_sm(int(bf16), int(direct), smem, ctypes.byref(out))
            if err != 0:
                raise RaftError(f"cagra_search occupancy query failed (cudaError {err})")
            _CTAS[at] = out.value
        return _CTAS[at]

    _PLANS[key] = launch_plan(itopk, width, deg, d, 2 if bf16 else 4, nq, _SMS[dev.index], ctas)
    return _PLANS[key]


def _launch(table, graph, queries, init_v, init_idf, *, itopk: int, width: int, iters: int,
            ip: bool, plan: Optional[BeamPlan] = None, record: bool = False):
    """Launch ``csrc/cagra_search.cu`` on CUDA tensors, staged as ``plan``
    says (by default :func:`launch_plan`'s); raises if it cannot be built
    or launched. Returns ``(values, id * 2 + visited, record)``, the stage
    clock's record with ``record=True``, else None."""
    _check_args(table, graph, queries, init_v, init_idf, itopk, width, iters)
    nq, d = queries.shape
    deg = table.shape[1]
    dev = queries.device
    for name, t in (("table", table), ("graph", graph), ("init_v", init_v), ("init_idf", init_idf)):
        expects(t.device == dev, "cagra_fused_search: %s is on %s, queries on %s", name, t.device, dev)
    bf16 = table.dtype == torch.bfloat16
    lib, _, _ = build_kernel()
    if plan is None:
        plan = _card_plan(lib, dev, itopk, width, deg, d, bf16, nq)
    smem = lib.cagra_search_smem_bytes(itopk, width, deg, d, table.element_size(), plan.group_rows,
                                       plan.buffers, int(plan.bitonic))
    if smem != plan.smem_bytes:
        raise RaftError(f"cagra_search.cu asks {smem} B of shared memory for {plan}, the wrapper "
                        f"counted {plan.smem_bytes}")
    tab = table.contiguous()
    if tab.data_ptr() % 16:  # the kernel stages rows from 16-byte aligned addresses
        tab = tab.clone()
    g = graph.to(torch.int32).contiguous()
    qf = queries.to(torch.float32).contiguous()
    iv = init_v.to(torch.float32).contiguous()
    ii = init_idf.to(torch.int32).contiguous()
    out_v = torch.empty((nq, itopk), dtype=torch.float32, device=dev)
    out_idf = torch.empty((nq, itopk), dtype=torch.int32, device=dev)
    rec = (torch.zeros((nq, len(STAGES) + 2 + len(COUNTS)), dtype=torch.int64, device=dev)
           if record else None)
    if nq == 0:
        return out_v, out_idf, rec
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.cagra_search_beam(
        tab.data_ptr(), int(bf16), g.data_ptr(), qf.data_ptr(), iv.data_ptr(), ii.data_ptr(),
        out_v.data_ptr(), out_idf.data_ptr(), nq, d, deg, itopk, width, iters, int(ip),
        plan.group_rows, plan.buffers, int(plan.bitonic), rec.data_ptr() if record else None, stream,
    )
    if err != 0:
        raise RaftError(f"cagra_search kernel launch failed (cudaError {err})")
    cagra_fused_search.last_plan = plan
    return out_v, out_idf, rec
