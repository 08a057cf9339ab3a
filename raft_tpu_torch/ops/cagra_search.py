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
CPU tensors.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from raft_tpu_torch.core.errors import LogicError, RaftError, expects
from raft_tpu_torch.ops.cuda_build import build_library
from raft_tpu_torch.ops.pq_scan import SMEM_LIMIT_BYTES
from raft_tpu_torch.utils.math import next_pow2, round_up

#: Largest node count the JAX package's packed table supports (three 8-bit
#: id digits); kept so that ``fused_eligible`` decides as the JAX package does.
MAX_TABLE_IDS = (1 << 24) - 2

#: Finite "worst" beam value (the JAX kernel's sentinel), mapped to the
#: metric's worst value outside the kernel.
WORST = 3.0e38

_SIGNATURES = {
    "cagra_search_beam":
        [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
        + [ctypes.c_void_p],
}


def build_kernel(verbose: bool = False) -> Tuple[ctypes.CDLL, float, str]:
    """Build ``csrc/cagra_search.cu`` for ``sm_90a`` (once per source
    version) and load it. Returns ``(library, build seconds, compiler
    output)``."""
    return build_library("cagra_search.cu", _SIGNATURES, verbose=verbose)


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


def smem_bytes(itopk: int, width: int, deg: int, d: int) -> int:
    """Shared memory of one CTA: the union's 64-bit sort keys padded to a
    power of two, the query, two beams, the candidates and the parents."""
    w = width * deg
    return 8 * next_pow2(itopk + w) + 4 * (d + 4 * itopk + 2 * w + width)


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


def cagra_fused_search(table, graph, queries, init_v, init_idf, *, itopk: int, width: int,
                       iters: int, ip: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the beam loop (see the module docstring): ``table [n, deg, d]``
    f32 or bf16, ``graph [n, deg]`` i32, ``queries [nq, d]`` f32, the seeded
    beam ``init_v``/``init_idf [nq, itopk]`` (min-ordered values, negated
    for inner product, :data:`WORST` in empty slots; ids packed ``id * 2 +
    flag``, -1 empty). Returns the final beam. CUDA tensors launch the
    kernel, one CTA per query
    (``cagra_fused_search.launches`` counts the launches); CPU tensors take
    the plain version."""
    if queries.device.type != "cuda":
        return cagra_beam_reference(table, graph, queries, init_v, init_idf, itopk=itopk,
                                    width=width, iters=iters, ip=ip)
    _check_args(table, graph, queries, init_v, init_idf, itopk, width, iters)
    nq, d = queries.shape
    deg = table.shape[1]
    smem = smem_bytes(itopk, width, deg, d)
    if smem > SMEM_LIMIT_BYTES:
        raise LogicError(
            f"cagra_fused_search: itopk {itopk} + width*deg {width * deg} needs {smem} bytes of "
            f"shared memory per query, more than one CTA holds ({SMEM_LIMIT_BYTES})")
    dev = queries.device
    for name, t in (("table", table), ("graph", graph), ("init_v", init_v), ("init_idf", init_idf)):
        expects(t.device == dev, "cagra_fused_search: %s is on %s, queries on %s", name, t.device, dev)
    tab = table.contiguous()
    g = graph.to(torch.int32).contiguous()
    qf = queries.to(torch.float32).contiguous()
    iv = init_v.to(torch.float32).contiguous()
    ii = init_idf.to(torch.int32).contiguous()
    out_v = torch.empty((nq, itopk), dtype=torch.float32, device=dev)
    out_idf = torch.empty((nq, itopk), dtype=torch.int32, device=dev)
    if nq == 0:
        return out_v, out_idf
    lib, _, _ = build_kernel()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.cagra_search_beam(
        tab.data_ptr(), int(tab.dtype == torch.bfloat16), g.data_ptr(), qf.data_ptr(),
        iv.data_ptr(), ii.data_ptr(), out_v.data_ptr(), out_idf.data_ptr(),
        nq, d, deg, itopk, width, iters, int(ip), stream,
    )
    if err != 0:
        raise RaftError(f"cagra_search kernel launch failed (cudaError {err})")
    cagra_fused_search.launches += 1
    return out_v, out_idf


cagra_fused_search.launches = 0
