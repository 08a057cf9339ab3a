"""Ring top-k merge of sharded search (``raft_tpu.ops.pallas.ring_topk``
counterpart).

Each shard of a sharded search holds its local ``[nq, kc]`` candidates
(global ids). The gather merge ships every shard's block to every shard and
re-selects over the shard-major concatenation, a stable top-k, i.e. a sort
by ``(value, concat position)``. The ring computes the same merge as a ring
reduce-scatter plus ring all-gather over ``n`` query blocks of ``B =
ceil(nq / n)`` rows:

* every candidate carries its concat position ``pos = rank * kc + col``
  and the sort key ``key = v`` (min-select) or ``-v`` (max-select); padding
  entries are ``(key inf, pos _PAD_POS, v ±inf, id -1)``;
* at reduce-scatter hop ``s`` shard ``r`` sends its partial of block ``(r -
  s) mod n`` to its right neighbour and folds the block arriving from the
  left into its partial of block ``(r - s - 1) mod n``: one ``2w -> w``
  fold under the total order ``(key, pos)``; after ``n - 1`` hops shard
  ``r`` holds the finished block ``(r + 1) mod n``;
* an all-gather ring then replicates the finished blocks as ``(v, id)``.

The order is total (``pos`` is unique), so every fold schedule gives the
gather merge's ids and values bit for bit, demoted shards included (their
``(±inf, -1)`` candidates lose every fold as they lose the gather merge).
The key canonicalises as ``lax.sort`` does: ``-0`` ties ``+0`` and every
NaN is one value after ``+inf``. The TPU engines clip values to ``±WORST``
(their one-hot placement would turn ``inf * 0`` into NaN) and restore
``inf`` only where the id is -1, so a real candidate at ``±inf`` comes back
as ``±WORST`` there; the port carries ``±inf`` throughout, as the JAX
package's XLA engine ``_ring_topk_xla`` and the gather merge do.

Engines, chosen by the mesh's layout (:func:`ring_engine`), never as a
fallback. A ring runs along one axis of the mesh, once in each group of
shards along it (the other coordinates equal):

* ``"kernel"`` — every shard of a single-controller group on one card: B6
  :func:`fused_ring_topk` and B7 :func:`fused_scan_ring_topk` are one
  cooperative launch of ``ring_onecard``
  (``raft_tpu_torch/csrc/ring_topk.cu``, the TPU kernel's
  ``ring_topk.py:505``/``:530``): its CTAs play the ranks and hand each hop
  over through global memory and release/acquire flags, as the TPU kernel
  does through remote DMAs and semaphores; the staging (B7's scan fold too)
  and every fold run inside it, and it writes each shard's ``[nq, k]``
  outputs. :func:`ring_kernel_reference` is its plain mirror;
* ``"schedule"`` — a single-controller group across distinct cards: the
  host schedule of B6/B7 (``_run_ring``): a staging kernel per shard
  (``ring_stage``, B7's scan fold for tiles wider than ``k``), then per hop
  every shard's block moved to its right neighbour by ``mesh._moved`` (a
  peer copy on the sender's stream) and a B5 :func:`hop_merge` fold
  (``ring_topk.py:328``) on the receiver's;
* ``"process"`` — a process mesh (each process holds its own shards): the
  same ``_run_ring`` in every process over its local shards
  (``mesh.local_ranks``) on the card, ``ProcessMesh._moved`` moving the
  blocks (a peer copy between two shards of one process, else
  ``batch_isend_irecv``, through pinned host memory under gloo).
  ``ring_onecard`` never runs across processes: its ranks are CTAs of one
  launch. On CPU shards it is the plain schedule over the process verbs;
* ``"plain"`` — CPU meshes: :func:`ring_topk_reference` (the schedule of
  ``_ring_topk_xla`` over the mesh's verbs, with the plain fold
  :func:`hop_merge_reference` and :func:`_scan_fold`).

No engine falls back to another (the JAX package re-runs a failed ring on
gather): an error at the ``comms.ring_topk`` fault seam, which fires once a
call in every process, or in a kernel, propagates. ``comms.ring.*`` and the
``ring_topk`` span count once per call (the JAX package once per traced
program).
"""
from __future__ import annotations

import ctypes
import time
from typing import List, Sequence, Tuple

import torch

from raft_tpu_torch import obs
from raft_tpu_torch.core.errors import RaftError, expects
from raft_tpu_torch.ops.cuda_build import build_library
from raft_tpu_torch.ops.guard import check_cuda
from raft_tpu_torch.parallel import comms
from raft_tpu_torch.parallel.wire_model import (
    AG_ENTRY_BYTES,
    RS_ENTRY_BYTES,
    wire_bytes_per_query,
)
from raft_tpu_torch.robust import faults

#: The TPU engines' finite "worst" value (``inf * 0`` would poison their
#: one-hot placement). The port's engines carry ``±inf`` and never clip.
WORST = 3.0e38

#: Tie-break position of padding entries: loses every tie against a real
#: candidate (real positions are below ``n_shards * kc``).
_PAD_POS = 2 ** 31 - 1

#: Lanes of the ring state on the card: (pos, val bits, id) as int32; the
#: key is ``v`` or ``-v`` and is recomputed where a fold reads it, so a
#: reduce-scatter hop ships :data:`RS_ENTRY_BYTES` a candidate.
_RS_LANES = 3
_AG_LANES = 2

_SIGNATURES = {
    "ring_fold": [ctypes.c_void_p] * 12 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
    "ring_stage": [ctypes.c_void_p] * 2 + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 2,
    "ring_onecard_smem_bytes": [ctypes.c_int] * 3,
    "ring_onecard_capacity": [ctypes.c_int] * 5 + [ctypes.c_void_p],
    "ring_onecard": ([ctypes.c_void_p] + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 4
                     + [ctypes.c_int] * 7 + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                                             ctypes.c_int]),
}

#: ``ring_onecard``'s limits (``csrc/ring_topk.cu``): ranks a launch, warps
#: (rows of a row group) a CTA
MAX_RANKS = 16
MAX_WARPS = 8
#: The largest epoch; the call after it re-zeroes the flags and starts at 1.
EPOCH_MAX = 2 ** 31 - 1
#: Shared memory a block may take on the H100 (227 KB).
_SMEM_LIMIT = 232448
#: The stage clock's stages of ``ring_onecard`` (``csrc/stage_clock.cuh``,
#: ``prof::RingStage``) in a record of ``STAGE_SLOTS`` stage words, then the
#: warps' and the CTA's cycles, then the counts of ``COUNTS``
STAGES = ("stage", "wait", "fold", "send")
STAGE_SLOTS = 6
COUNTS = ("spins", "waits")


def build_kernel(verbose: bool = False):
    """Build ``csrc/ring_topk.cu`` for ``sm_90a`` (once per source version)
    and load it. Returns ``(library, build seconds, compiler output)``."""
    return build_library("ring_topk.cu", _SIGNATURES, verbose=verbose)


# -- plain versions ---------------------------------------------------------------


def order_key(key: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """The total order ``(key, pos)`` as one int64 per entry: the
    order-preserving bits of the key (``-0`` folded onto ``+0``, every NaN
    onto one NaN after ``+inf``, as ``lax.sort`` compares) in the high word,
    ``pos`` as a signed int in the low word."""
    k = key.to(torch.float32)
    k = torch.where(k == 0, torch.zeros_like(k), k)
    k = torch.where(torch.isnan(k), torch.full_like(k, float("nan")), k)
    u = k.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    u = torch.where(u >= 2 ** 31, u ^ 0xFFFFFFFF, u | 2 ** 31)
    return (u - 2 ** 31) * 2 ** 32 + (pos.to(torch.int64) + 2 ** 31)


def _sort_truncate(lanes, w: int):
    """The ``w`` first entries of each row under ``(key, pos)``, ties to the
    lower column (a stable sort)."""
    key, pos = lanes[0], lanes[1]
    order = torch.sort(order_key(key, pos), dim=1, stable=True).indices[:, :w]
    return tuple(torch.gather(x, 1, order) for x in lanes)


def _fold(a, b, w: int):
    """One ``2w -> w`` merge under the ``(key, pos)`` total order; ``a`` and
    ``b`` are ``(key, pos, val, id)`` tuples of ``[B, w]`` tensors."""
    return _sort_truncate(tuple(torch.cat([x, y], dim=1) for x, y in zip(a, b)), w)


def hop_merge_reference(a, b):
    """Plain version of B5: the top-``w`` of two ``(key f32, pos i32, val
    f32, id i32)`` tiles of ``[rows, w]`` under ``(key, pos)``."""
    _check_tiles(a, b)
    return _fold(a, b, a[0].shape[1])


def _pad_cols(key, pos, v, i, width: int, select_min: bool):
    """Right-pad the lanes to ``width`` columns with losing sentinels."""
    c = width - key.shape[1]
    pad = lambda x, val: torch.nn.functional.pad(x, (0, c), value=val)  # noqa: E731
    return (pad(key, float("inf")), pad(pos, _PAD_POS),
            pad(v, float("inf") if select_min else float("-inf")), pad(i, -1))


def _pad_rows(key, pos, v, i, rows: int, select_min: bool):
    c = rows - key.shape[0]
    pad = lambda x, val: torch.nn.functional.pad(x, (0, 0, 0, c), value=val)  # noqa: E731
    return (pad(key, float("inf")), pad(pos, _PAD_POS),
            pad(v, float("inf") if select_min else float("-inf")), pad(i, -1))


def _scan_fold(key, pos, v, i, k: int, select_min: bool):
    """Streaming local top-k: fold the ``[nq, kc]`` tile into ``[nq, k]``
    one ``k``-wide slice at a time (the last padded), bit-identical to the
    sort-truncate (plain version of B7's staging fold)."""
    kc = key.shape[1]
    acc = (key[:, :k], pos[:, :k], v[:, :k], i[:, :k])
    for c0 in range(k, kc, k):
        c1 = min(c0 + k, kc)
        sl = tuple(x[:, c0:c1] for x in (key, pos, v, i))
        if c1 - c0 < k:
            sl = _pad_cols(*sl, k, select_min)
        acc = _fold(acc, sl, k)
    return acc


def _prep(v, i, k: int, select_min: bool, rank: int, n: int, scan_fold: bool = False):
    """Shard ``rank``'s candidates in the ring's layout: ``(key, pos, v, i)``
    of ``[n * B, k]`` and ``B``. Wider tiles are cut to ``k`` (sort-truncate,
    or ``scan_fold``), narrower ones padded; rows are padded to ``n * B``."""
    nq, kc = v.shape
    v = v.to(torch.float32)
    i = i.to(torch.int32)
    pos = (rank * kc + torch.arange(kc, dtype=torch.int32, device=v.device)).expand(nq, kc)
    key = v if select_min else -v
    if kc > k:
        if scan_fold:
            key, pos, v, i = _scan_fold(key, pos, v, i, k, select_min)
        else:
            key, pos, v, i = _sort_truncate((key, pos, v, i), k)
    elif kc < k:
        key, pos, v, i = _pad_cols(key, pos, v, i, k, select_min)
    B = -(-nq // n)
    if n * B > nq:
        key, pos, v, i = _pad_rows(key, pos, v, i, n * B, select_min)
    return key, pos, v, i, B


def ring_topk_reference(vs, is_, k: int, select_min: bool, mesh, scan_fold: bool = False):
    """Plain version of the ring (``_ring_topk_xla``) on a one-axis mesh of
    either kind: the same reduce-scatter and all-gather hops, as raw
    ``comms._ppermute`` verbs over the mesh (``lax.ppermute`` in the JAX
    package: no verb counters), with the plain fold, each local shard
    (``mesh.local_ranks``) playing its rank. Returns one replicated
    ``(vals [nq, k], ids [nq, k])`` pair per local shard, as two lists."""
    _check_parts(mesh, vs, is_, k)
    n = mesh.size
    nq = vs[0].shape[0]
    ranks = mesh.local_ranks
    mesh.fork()
    states = []
    for j, r in enumerate(ranks):
        with mesh.on(j):
            key, pos, v, i, B = _prep(vs[j], is_[j], k, select_min, r, n, scan_fold)
            states.append([x.reshape(n, B, k).clone() for x in (key, pos, v, i)])
    if n == 1:
        out = ([states[0][2][0][:nq]], [states[0][3][0][:nq]])
        mesh.join(out[0] + out[1])
        return out
    perm = [(j, (j + 1) % n) for j in range(n)]
    for s in range(n - 1):
        recv = [comms._ppermute(mesh, [st[ln][(r - s) % n] for r, st in zip(ranks, states)], perm)
                for ln in range(4)]
        for j, r in enumerate(ranks):
            with mesh.on(j):
                b = (r - s - 1) % n
                folded = _fold(tuple(states[j][ln][b] for ln in range(4)),
                               tuple(recv[ln][j] for ln in range(4)), k)
                for ln in range(4):
                    states[j][ln][b] = folded[ln]
    out_v = [st[2] for st in states]
    out_i = [st[3] for st in states]
    for s in range(n - 1):
        rv = comms._ppermute(mesh, [out_v[j][(r + 1 - s) % n] for j, r in enumerate(ranks)], perm)
        ri = comms._ppermute(mesh, [out_i[j][(r + 1 - s) % n] for j, r in enumerate(ranks)], perm)
        for j, r in enumerate(ranks):
            with mesh.on(j):
                b = (r - s) % n
                out_v[j][b] = rv[j]
                out_i[j][b] = ri[j]
    vals, ids = [], []
    for j in range(len(ranks)):
        with mesh.on(j):
            vals.append(out_v[j].reshape(-1, k)[:nq])
            ids.append(out_i[j].reshape(-1, k)[:nq])
    mesh.join(vals + ids)
    return vals, ids


def gather_merge(mesh, vs, is_, k: int, select_min: bool, axis=None):
    """The gather path's merge (the reference engine): every shard receives
    every block of its group along ``axis`` (the raw ``comms._allgather``:
    no verb counters and no ``comms.all_gather`` seam, as JAX's
    ``lax.all_gather``) and merges the shard-major concatenation with
    ``merge_parts``. One replicated pair per local shard."""
    from raft_tpu_torch.ops.select_k import merge_parts

    _check_parts(mesh, vs, is_, None)
    mesh.fork()
    all_v = comms._allgather(mesh, [v.to(torch.float32) for v in vs], axis=axis)
    all_i = comms._allgather(mesh, [i.to(torch.int32) for i in is_], axis=axis)
    vals, ids = [], []
    for r in range(len(mesh.devices)):
        with mesh.on(r):
            n, nq, kc = all_v[r].shape
            cat_v = all_v[r].permute(1, 0, 2).reshape(nq, n * kc)
            cat_i = all_i[r].permute(1, 0, 2).reshape(nq, n * kc)
            v, i = merge_parts(cat_v, cat_i, k, select_min=select_min)
            vals.append(v)
            ids.append(i)
    mesh.join(vals + ids)
    return vals, ids


# -- the one-launch ring: its host-side plan and its plain mirror -----------------


def ring_engine(devices) -> str:
    """The ring engine a mesh's layout takes (``devices``: a device list or
    a one-axis mesh): ``"process"`` for a process mesh, ``"plain"`` on the
    CPU, ``"kernel"`` (one launch a ring) when every shard sits on one card,
    ``"schedule"`` (the host schedule) across distinct cards."""
    if hasattr(devices, "devices"):
        if getattr(devices, "is_process", False):
            return "process"
        devices = devices.devices
    devices = [d if isinstance(d, torch.device) else torch.device(d) for d in devices]
    if devices[0].type != "cuda":
        return "plain"
    return "kernel" if len(set(devices)) == 1 else "schedule"


def onecard_smem_bytes(n: int, w: int, warps: int) -> int:
    """Shared memory of one ``ring_onecard`` CTA: each warp's union scratch
    (2w entries of 24 B) and its row's state in all ``n`` blocks (12 B an
    entry). The kernel's ``ring_onecard_smem_bytes`` says the same."""
    return warps * w * (12 * n + 48)


def onecard_warps(n: int, w: int) -> int:
    """Rows a CTA (one warp each): the most, up to :data:`MAX_WARPS`, whose
    shared memory fits."""
    for warps in (MAX_WARPS, 4, 2, 1):
        if onecard_smem_bytes(n, w, warps) <= _SMEM_LIMIT:
            return warps
    raise RaftError(f"ring: {n} shards of width {w} do not fit one CTA's shared memory")


def plan_grid(B: int, n: int, warps: int, capacity: int) -> Tuple[int, int]:
    """``(G, grid_x)``: the row groups of ``warps`` rows covering a block of
    ``B`` rows, and the CTAs a rank launches, at most the ``capacity``
    co-resident CTAs of the card over ``n`` ranks (a CTA then loops over
    row groups ``x, x + grid_x, ...``)."""
    G = -(-B // warps)
    grid_x = min(G, capacity // n)
    if grid_x < 1:
        raise RaftError(f"ring: the card holds {capacity} CTAs at once, fewer than the {n} ranks")
    return G, grid_x


def next_epoch(epoch: int) -> Tuple[int, bool]:
    """The epoch of the next call and whether its flags must be re-zeroed
    first (the epoch would pass :data:`EPOCH_MAX`)."""
    return (1, True) if epoch >= EPOCH_MAX else (epoch + 1, False)


class RingWorkspace:
    """The receive slots and flags of the one-launch ring for ``n`` ranks of
    width ``w``, room for blocks of ``Bs`` rows and ``Gs`` row groups, and
    the epoch of the last call. Flags hold the epoch of the call that last
    set them and are never reset between calls."""

    def __init__(self, n: int, w: int, Bs: int, Gs: int, device):
        self.n, self.w, self.Bs, self.Gs = n, w, Bs, Gs
        self.recv = torch.empty((n, max(n - 1, 1), _RS_LANES, Bs, w), dtype=torch.int32,
                                device=device)
        self.flags = torch.zeros((n, Gs, max(2 * n - 3, 1)), dtype=torch.int32, device=device)
        self.epoch = 0

    def fits(self, B: int, G: int) -> bool:
        return B <= self.Bs and G <= self.Gs

    def advance(self, stream=None) -> int:
        """The next call's epoch, re-zeroing the flags on a wrap (on
        ``stream``, the launches' stream, when given)."""
        self.epoch, reset = next_epoch(self.epoch)
        if reset:
            if stream is None:
                self.flags.zero_()
            else:
                with torch.cuda.stream(stream):
                    self.flags.zero_()
        return self.epoch


def _rank_fold(a, b, w: int, key_sign: int):
    """The kernel's fold of two ``(pos, val, id)`` row tiles ``[rows, w]``:
    each union entry's rank is the count of entries before it (a smaller
    ``(key, pos)``, or an equal one at a lower union column), and the
    entries of rank below ``w`` land in slot rank."""
    pos, val, ids = (torch.cat([x, y], dim=1) for x, y in zip(a, b))
    comp = order_key(val if key_sign > 0 else -val, pos)
    m = comp.shape[1]
    col = torch.arange(m, device=comp.device)
    before = (comp[:, None, :] < comp[:, :, None]) | (
        (comp[:, None, :] == comp[:, :, None]) & (col[None, None, :] < col[None, :, None]))
    rank = before.sum(dim=2).clamp(max=w)
    rows = comp.shape[0]
    return tuple(torch.zeros((rows, w + 1), dtype=x.dtype, device=x.device).scatter_(1, rank, x)[:, :w]
                 for x in (pos, val, ids))


def _stage_rows(v, ids, q, r: int, w: int, select_min: bool, key_sign: int):
    """The kernel's staging of rank ``r``'s rows ``q`` (``[rows]``; rows at
    or past ``nq`` are padding): the first ``w`` columns, then each further
    ``w`` columns folded in (padding past ``kc``)."""
    nq, kc = v.shape
    real_row = q < nq
    qc = q.clamp(max=max(nq - 1, 0))
    pad_v = float("inf") if select_min else float("-inf")

    def cols(c0):
        c = c0 + torch.arange(w, device=v.device)
        real = real_row[:, None] & (c < kc)[None, :]
        cc = c.clamp(max=kc - 1)
        return (torch.where(real, (r * kc + cc).to(torch.int32).expand_as(real),
                            torch.full_like(real, _PAD_POS, dtype=torch.int32)),
                torch.where(real, v[qc][:, cc], torch.full_like(real, pad_v, dtype=torch.float32)),
                torch.where(real, ids[qc][:, cc], torch.full_like(real, -1, dtype=torch.int32)))

    state = cols(0)
    for c0 in range(w, kc, w):
        state = _rank_fold(state, cols(c0), w, key_sign)
    return state


def ring_kernel_reference(vs, is_, k: int, select_min: bool = True, *, warps: int = MAX_WARPS,
                          workspace: RingWorkspace = None):
    """Plain mirror of ``ring_onecard``'s schedule on one device: per row
    group of ``warps`` rows and per rank, the staging (B7's scan fold for
    tiles wider than ``k``), the reduce-scatter through the workspace's
    receive slots (one a hop) and flags, each wait checking the flag holds
    this call's epoch, the kernel's rank-count fold, and the all-gather
    straight into each shard's ``[nq, k]`` output. Returns one replicated
    ``(vals, ids)`` pair per shard, as two lists."""
    n = len(vs)
    nq, kc = vs[0].shape
    w, key_sign = k, 1 if select_min else -1
    dev = vs[0].device
    vs = [v.to(torch.float32) for v in vs]
    is_ = [i.to(torch.int32) for i in is_]
    out_v = torch.empty((n, nq, w), dtype=torch.float32, device=dev)
    out_i = torch.empty((n, nq, w), dtype=torch.int32, device=dev)
    if nq == 0:
        return list(out_v), list(out_i)
    B = -(-nq // n)
    G = -(-B // warps)
    ws = workspace if workspace is not None else RingWorkspace(n, w, B, G, dev)
    expects(ws.n == n and ws.w == w and ws.fits(B, G), "ring: the workspace does not fit this call")
    epoch = ws.advance()

    def wait(r, g, f):
        expects(int(ws.flags[r, g, f]) == epoch, "ring: rank %d waited on an unset flag %d", r, f)

    for g in range(G):
        j = torch.arange(g * warps, min((g + 1) * warps, B), device=dev)
        # state[r][ln]: [n blocks, rows, w] of (pos, val, id)
        state = []
        for r in range(n):
            q = (torch.arange(n, device=dev)[:, None] * B + j[None, :]).reshape(-1)
            st = _stage_rows(vs[r], is_[r], q, r, w, select_min, key_sign)
            state.append([x.reshape(n, len(j), w) for x in st])
        for s in range(n - 1):
            for r in range(n):
                right, sb = (r + 1) % n, (r - s) % n
                ws.recv[right, s, 0, j] = state[r][0][sb]
                ws.recv[right, s, 1, j] = state[r][1][sb].view(torch.int32)
                ws.recv[right, s, 2, j] = state[r][2][sb]
                ws.flags[right, g, s] = epoch
            for r in range(n):
                wait(r, g, s)
                fb = (r - s - 1) % n
                got = (ws.recv[r, s, 0, j], ws.recv[r, s, 1, j].view(torch.float32),
                       ws.recv[r, s, 2, j])
                folded = _rank_fold(tuple(x[fb] for x in state[r]), got, w, key_sign)
                for ln in range(3):
                    state[r][ln][fb] = folded[ln]

        def put(rank, blk, val, ids):
            q = blk * B + j
            real = q < nq
            out_v[rank, q[real]] = val[real]
            out_i[rank, q[real]] = ids[real]

        for r in range(n):
            own = (r + 1) % n
            put(r, own, state[r][1][own], state[r][2][own])
        for s in range(n - 1):
            for r in range(n):
                right, blk = (r + 1) % n, (r + 1 - s) % n
                if s > 0:
                    wait(r, g, n - 1 + s - 1)
                if s == 0:
                    val, ids = state[r][1][blk], state[r][2][blk]
                else:
                    q = (blk * B + j).clamp(max=nq - 1)
                    val, ids = out_v[r, q], out_i[r, q]
                put(right, blk, val, ids)
                if s < n - 2:
                    ws.flags[right, g, n - 1 + s] = epoch
    return list(out_v), list(out_i)


# -- checks --------------------------------------------------------------------


def _check_tiles(a, b):
    expects(len(a) == 4 and len(b) == 4, "hop_merge: a and b must be (key, pos, val, id) tuples")
    shape = tuple(a[0].shape)
    expects(len(shape) == 2 and shape[1] >= 1, "hop_merge: tiles must be [rows, w >= 1]")
    for x in tuple(a) + tuple(b):
        expects(tuple(x.shape) == shape, "hop_merge: every lane must be %s", shape)
        expects(x.device == a[0].device, "hop_merge: lanes on different devices")


def _check_parts(mesh, vs, is_, k):
    n_local = len(mesh.devices)
    expects(len(vs) == n_local and len(is_) == n_local,
            "ring: %d/%d per-shard tiles for %d shards", len(vs), len(is_), n_local)
    shape = tuple(vs[0].shape)
    expects(len(shape) == 2 and shape[1] >= 1, "ring: candidates must be [nq, kc >= 1]")
    for r, (v, i) in enumerate(zip(vs, is_)):
        expects(tuple(v.shape) == shape and tuple(i.shape) == shape,
                "ring: shard %d's tiles are %s/%s, shard 0's %s", r, tuple(v.shape),
                tuple(i.shape), shape)
        expects(v.device == mesh.devices[r] and i.device == mesh.devices[r],
                "ring: shard %d's tiles are not on %s", r, mesh.devices[r])
    if k is not None:
        expects(k >= 1, "ring: k must be >= 1")


# -- kernels ---------------------------------------------------------------------


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _ptr(t, offset_elems: int = 0):
    return t.data_ptr() + offset_elems * t.element_size()


def _launch_fold(lib, a, b, out, rows: int, w: int, key_sign: int) -> None:
    """One fold kernel launch on the current stream; ``a``/``b``/``out`` are
    four lane pointers each (a null key pointer: key = ``key_sign * val``).
    Counts in ``hop_merge.launches``."""
    err = lib.ring_fold(*a, *b, *out, rows, w, key_sign, _stream())
    check_cuda(err, "ring_fold kernel launch")
    hop_merge.launches += 1


def hop_merge(a, b):
    """B5: the top-``w`` of two ``(key f32, pos i32, val f32, id i32)``
    tiles of ``[rows, w]`` under ``(key, pos)``, sorted. The inputs need not
    be sorted. CUDA tensors launch the kernel (one CTA per row;
    ``hop_merge.launches`` counts launches, the host schedule's folds
    included; the one-launch ring folds inside its own kernel); CPU tensors
    take :func:`hop_merge_reference`."""
    _check_tiles(a, b)
    if a[0].device.type != "cuda":
        return hop_merge_reference(a, b)
    rows, w = a[0].shape
    dts = (torch.float32, torch.int32, torch.float32, torch.int32)
    a = tuple(x.to(dt).contiguous() for x, dt in zip(a, dts))
    b = tuple(x.to(dt).contiguous() for x, dt in zip(b, dts))
    out = tuple(torch.empty_like(x) for x in a)
    if rows == 0:
        return out
    lib, _, _ = build_kernel()
    _launch_fold(lib, [_ptr(x) for x in a], [_ptr(x) for x in b], [_ptr(x) for x in out],
                 rows, w, 1)
    return out


hop_merge.launches = 0


def _stage(lib, v, i, rank: int, n: int, B: int, w: int, select_min: bool) -> torch.Tensor:
    """The staging kernel on the current stream: shard ``rank``'s ``[nq,
    kc]`` tile into a new ring state ``[n, 3, B, w]`` int32 (pos, val bits,
    id per block), padding rows and columns, folding a tile wider than
    ``w`` to its top ``w``. Counts in ``fused_ring_topk.stage_launches``,
    and a launch that folds a wider tile (B7's scan fold) also in
    ``fused_scan_ring_topk.stage_launches``."""
    nq, kc = v.shape
    v = v.to(torch.float32).contiguous()
    i = i.to(torch.int32).contiguous()
    state = torch.empty((n, _RS_LANES, B, w), dtype=torch.int32, device=v.device)
    err = lib.ring_stage(_ptr(v), _ptr(i), nq, kc, rank, n * B, B, w, int(select_min),
                         _ptr(state), _stream())
    check_cuda(err, "ring_stage kernel launch")
    fused_ring_topk.stage_launches += 1
    if kc > w:
        fused_scan_ring_topk.stage_launches += 1
    return state


def _fold_block(lib, dst: torch.Tensor, got: torch.Tensor, key_sign: int) -> None:
    """B5 in place on the current stream: the ring state block ``dst``
    (``[3, B, w]`` int32: pos, val bits, id) folded with the block ``got``
    that arrived (key = ``key_sign * val``)."""
    _, B, w = dst.shape
    bw = B * w
    a = [None, _ptr(dst, 0), _ptr(dst, bw), _ptr(dst, 2 * bw)]
    b = [None, _ptr(got, 0), _ptr(got, bw), _ptr(got, 2 * bw)]
    _launch_fold(lib, a, b, a, B, w, key_sign)


def _ring_stats(n: int, nq: int, B: int, w: int, **extra) -> dict:
    """The bytes one rank sends in a ring of ``n`` shards over blocks of
    ``B`` rows of ``w`` candidates, beside the wire model's."""
    bw = B * w
    per_rank = (n - 1) * bw * (RS_ENTRY_BYTES + AG_ENTRY_BYTES)
    return dict(per_rank=per_rank, per_query=per_rank / max(nq, 1), rs_hop=bw * RS_ENTRY_BYTES,
                ag_hop=bw * AG_ENTRY_BYTES, model_per_query=wire_bytes_per_query(n, w, "ring"),
                **extra)


def _ring_body(lib, mesh, states: List[torch.Tensor], nq: int, B: int, w: int,
               select_min: bool):
    """B6's schedule over the local shards' staged states, each local shard
    (``mesh.local_ranks``) playing its rank; every hop moves one block a
    shard to its right neighbour through ``mesh._moved`` (a peer copy on
    the sender's stream where both shards are local, the process backend's
    send and receive otherwise) into a double-buffered receive slot, and
    B5 folds it on the receiver's stream. Returns the per-shard outputs and
    the bytes one rank sent, with ``hop_s``, the host seconds spent in the
    hops (a staged gloo hop waits there for its sender's stream)."""
    n = mesh.size
    ranks = mesh.local_ranks
    slot_of = {r: j for j, r in enumerate(ranks)}
    key_sign = 1 if select_min else -1
    perm = [(r, (r + 1) % n) for r in range(n)]
    recv, out, ready = [], [], []
    for j in range(len(ranks)):
        with mesh.on(j):
            recv.append(torch.empty((2, _RS_LANES, B, w), dtype=torch.int32, device=mesh.devices[j]))
            out.append(torch.empty((n, _AG_LANES, B, w), dtype=torch.int32, device=mesh.devices[j]))
            ev = torch.cuda.Event()
            ev.record()
            ready.append(ev)
    folded = [[None] * (n - 1) for _ in ranks]
    hop_s = 0.0
    # -- reduce-scatter: after hop s, shard r's block (r - s - 1) % n holds
    # every shard <= r's candidates; after n - 1 hops block (r + 1) % n is done
    for s in range(n - 1):
        slot = s % 2
        for j, r in enumerate(ranks):
            right = slot_of.get((r + 1) % n)
            if right is None:  # a remote receiver orders its slot on its own stream
                continue
            with mesh.on(j):
                if s == 0:
                    mesh.streams[j].wait_event(ready[right])
                if s >= 2:  # the slot's last reader, right's fold of hop s - 2, is done
                    mesh.streams[j].wait_event(folded[right][s - 2])
        t0 = time.perf_counter()
        got = mesh._moved([st[(r - s) % n] for r, st in zip(ranks, states)], perm,
                          outs=[rc[slot] for rc in recv])
        hop_s += time.perf_counter() - t0
        for j, r in enumerate(ranks):
            with mesh.on(j):
                _fold_block(lib, states[j][(r - s - 1) % n], got[j], key_sign)
                ev = torch.cuda.Event()
                ev.record()
                folded[j][s] = ev
    # -- all-gather of the finished blocks as (val, id)
    for j, r in enumerate(ranks):
        own = (r + 1) % n
        with mesh.on(j):
            out[j][own].copy_(states[j][own, 1:3])
    for s in range(n - 1):
        t0 = time.perf_counter()
        mesh._moved([out[j][(r + 1 - s) % n] for j, r in enumerate(ranks)], perm,
                    outs=[out[j][(r - s) % n] for j, r in enumerate(ranks)])
        hop_s += time.perf_counter() - t0
    fused_ring_topk.hop_s += hop_s
    return out, _ring_stats(n, nq, B, w, hop_s=hop_s)


def _finish(mesh, blocks, nq: int, w: int, val_lane: int):
    """Per-shard ``(vals [nq, w] f32, ids [nq, w] i32)`` from ``[n, lanes,
    B, w]`` int32 blocks whose lanes ``val_lane``, ``val_lane + 1`` are (val
    bits, id)."""
    vals, ids = [], []
    for r, blk in enumerate(blocks):
        with mesh.on(r):
            vals.append(blk[:, val_lane].reshape(-1, w)[:nq].contiguous().view(torch.float32))
            ids.append(blk[:, val_lane + 1].reshape(-1, w)[:nq].contiguous())
    mesh.join(vals + ids)
    return vals, ids


def _run_ring(mesh, vs, is_, k: int, select_min: bool):
    """The host schedule of B6/B7 (engines ``"schedule"`` and
    ``"process"``): stage every local shard (folding tiles wider than
    ``k``), then :func:`_ring_body`; returns the outputs and the bytes
    copied (None for n == 1)."""
    lib, _, _ = build_kernel()
    n = mesh.size
    nq = vs[0].shape[0]
    B = -(-nq // n)
    mesh.fork()
    if nq == 0:
        out = ([torch.empty((0, k), dtype=torch.float32, device=d) for d in mesh.devices],
               [torch.empty((0, k), dtype=torch.int32, device=d) for d in mesh.devices])
        mesh.join()
        return out, None
    states = []
    for j, r in enumerate(mesh.local_ranks):
        with mesh.on(j):
            states.append(_stage(lib, vs[j], is_[j], r, n, B, k, select_min))
    if n == 1:
        return _finish(mesh, states, nq, k, 1), None
    out, stats = _ring_body(lib, mesh, states, nq, B, k, select_min)
    return _finish(mesh, out, nq, k, 0), stats


#: co-resident CTAs of ``ring_onecard`` by (device, n, w, warps, prof)
_capacity = {}


def _workspace(mesh, n: int, w: int, B: int, G: int) -> RingWorkspace:
    """The mesh's workspace of the one-launch ring (every launch of a mesh
    takes shard 0's stream, so the calls that share it run in order), grown
    when a call needs more rows or row groups; its tensors are marked as
    used on that stream, so a replaced one is not reused before the
    launches that read it."""
    cache = mesh.__dict__.setdefault("_ring_workspaces", {})
    ws = cache.get((n, w))
    if ws is None or not ws.fits(B, G):
        Bs, Gs = (B, G) if ws is None else (max(B, ws.Bs), max(G, ws.Gs))
        ws = cache[(n, w)] = RingWorkspace(n, w, Bs, Gs, mesh.devices[0])
        ws.recv.record_stream(mesh.streams[0])
        ws.flags.record_stream(mesh.streams[0])
    return ws


def _onecard_capacity(lib, device: int, n: int, w: int, warps: int, prof: bool) -> int:
    """Co-resident CTAs of ``ring_onecard`` on card ``device`` at this shape
    (cached)."""
    key = (device, n, w, warps, prof)
    if key not in _capacity:
        expects(lib.ring_onecard_smem_bytes(n, w, warps) == onecard_smem_bytes(n, w, warps),
                "ring: the kernel's shared memory is not the wrapper's count")
        ctas = ctypes.c_int(0)
        err = lib.ring_onecard_capacity(device, n, w, warps, int(prof), ctypes.byref(ctas))
        check_cuda(err, "ring_onecard occupancy query")
        _capacity[key] = ctas.value
    return _capacity[key]


def _on_shard_stream(mesh, r: int, x: torch.Tensor, dtype) -> torch.Tensor:
    """``x`` as a contiguous ``dtype`` tensor; a conversion runs on shard
    ``r``'s stream, where ``x`` is ready."""
    if x.dtype == dtype and x.is_contiguous():
        return x
    with mesh.on(r):
        return x.to(dtype).contiguous()


def _run_onecard(mesh, vs, is_, k: int, select_min: bool, stages: bool = False):
    """One ``ring_onecard`` launch on shard 0's stream, ordered after the
    caller's stream and the other shard streams and before them (the Mesh
    verb contract; the kernel's library records and waits the events).
    Returns the per-shard outputs (views of one ``[n, nq, k]`` tensor a
    lane, made on the caller's stream), the bytes one rank sent, and the
    stage clock's record with ``stages`` (whose launch counts no folds)."""
    lib, _, _ = build_kernel()
    n = mesh.size
    nq, kc = vs[0].shape
    expects(n <= MAX_RANKS, "ring: the one-launch ring takes at most %d shards, got %d",
            MAX_RANKS, n)
    dev = mesh.devices[0]
    vs = [_on_shard_stream(mesh, r, v, torch.float32) for r, v in enumerate(vs)]
    is_ = [_on_shard_stream(mesh, r, i, torch.int32) for r, i in enumerate(is_)]
    out_v = torch.empty((n, nq, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((n, nq, k), dtype=torch.int32, device=dev)
    rec, stats = None, None
    if nq > 0:
        B = -(-nq // n)
        warps = onecard_warps(n, k)
        G, grid_x = plan_grid(B, n, warps, _onecard_capacity(lib, dev.index, n, k, warps, stages))
        ws = _workspace(mesh, n, k, B, G)
        s0 = mesh.streams[0]
        epoch = ws.advance(s0)
        if stages:
            rec = torch.zeros((grid_x * n, STAGE_SLOTS + 2 + len(COUNTS)), dtype=torch.int64,
                              device=dev)
        ptrs = (ctypes.c_longlong * (2 * n))(*[t.data_ptr() for t in vs + is_])
        order = [s0, torch.cuda.current_stream(dev)] + list(mesh.streams[1:])
        streams = (ctypes.c_void_p * len(order))(*[s.cuda_stream for s in order])
        err = lib.ring_onecard(ptrs, n, nq, kc, k, int(select_min), out_v.data_ptr(),
                               out_i.data_ptr(), ws.recv.data_ptr(), ws.flags.data_ptr(), B, ws.Bs,
                               G, ws.Gs, grid_x, warps, epoch, rec.data_ptr() if stages else None,
                               dev.index, streams, len(order))
        check_cuda(err, "ring_onecard kernel launch")
        if n > 1:
            stats = _ring_stats(n, nq, B, k)
        if not stages:
            fused_ring_topk.folds += n * (n - 1)
        fused_ring_topk.last_grid = (grid_x, n, warps)
    return (list(out_v.unbind(0)), list(out_i.unbind(0))), stats, rec


def _run(mesh, vs, is_, k: int, select_min: bool, kernel):
    """The ring on a one-axis CUDA mesh by its layout (:func:`ring_engine`):
    one ``ring_onecard`` launch on one card, counted in ``kernel.launches``
    (B6's or B7's wrapper), else the host schedule (across cards, or over a
    process mesh's local shards), which launches no ``ring_onecard``.
    Returns the outputs and the bytes sent."""
    _check_parts(mesh, vs, is_, k)
    expects(mesh.is_cuda, "the ring kernels need a CUDA mesh (CPU meshes run ring_topk_reference)")
    if ring_engine(mesh) == "kernel":
        out, stats, _ = _run_onecard(mesh, list(vs), list(is_), k, select_min)
        if vs[0].shape[0] > 0:  # no queries: nothing launched
            kernel.launches += 1
        return out, stats
    return _run_ring(mesh, vs, is_, k, select_min)


def fused_ring_topk(mesh, vs, is_, k: int, select_min: bool = True):
    """B6: the ring merge of per-shard ``[nq, kc]`` candidates on a CUDA
    mesh (see the module docstring). Returns one replicated ``(vals [nq,
    k], ids [nq, k])`` pair per shard, equal bit for bit to the gather
    merge. Every shard on one card: one ``ring_onecard`` launch (counted in
    ``fused_ring_topk.launches``; ``fused_ring_topk.folds`` adds its ``n (n
    - 1)`` block folds, ``last_grid`` holds its grid); distinct cards or a
    process mesh: the host schedule, which launches no ``ring_onecard`` (its
    staging launches count in ``fused_ring_topk.stage_launches``, its folds
    in ``hop_merge.launches``, its host seconds in the hops in
    ``fused_ring_topk.hop_s``). ``fused_ring_topk.last_bytes`` holds the
    bytes one rank sent in the last call beside ``wire_bytes_per_query``."""
    out, stats = _run(mesh, vs, is_, k, select_min, fused_ring_topk)
    fused_ring_topk.last_bytes = stats
    return out


fused_ring_topk.launches = 0
fused_ring_topk.folds = 0
fused_ring_topk.stage_launches = 0
fused_ring_topk.hop_s = 0.0
fused_ring_topk.last_bytes = None
fused_ring_topk.last_grid = None


def fused_ring_topk_stages(mesh, vs, is_, k: int, select_min: bool = True) -> torch.Tensor:
    """One ``ring_onecard`` launch with its stage clock on (every shard on
    one card): returns int64 ``[CTAs, STAGE_SLOTS + 2 + len(COUNTS)]``, per
    CTA (rank-major: CTA ``x`` of rank ``r`` is row ``r * grid_x + x``) the
    cycles of each of :data:`STAGES` summed over its warps, the warps' total
    cycles, the CTA's own cycles, its polls of unset flags and its waits.
    Counts in no launch counter."""
    _check_parts(mesh, vs, is_, k)
    expects(ring_engine(mesh) == "kernel", "fused_ring_topk_stages: every shard on one card")
    _, _, rec = _run_onecard(mesh, list(vs), list(is_), k, select_min, stages=True)
    return rec


def fused_scan_ring_topk(mesh, vs, is_, k: int, select_min: bool = True):
    """B7: the scan ring on a CUDA mesh. Takes the scan's full ``[nq, kc]``
    tiles; the staging folds each row ``k`` columns at a time straight into
    the ring state (inside ``ring_onecard`` on one card, in the staging
    kernel of the host schedule across cards), then B6's exchange runs (with
    one shard the fold alone). Tiles no wider than ``k`` have nothing to
    fold and go to :func:`fused_ring_topk`. ``fused_scan_ring_topk.launches``
    counts the ``ring_onecard`` launches that run the scan fold,
    ``fused_scan_ring_topk.stage_launches`` the host schedule's staging
    launches that do."""
    _check_parts(mesh, vs, is_, k)
    expects(mesh.is_cuda, "fused_scan_ring_topk needs a CUDA mesh")
    if vs[0].shape[1] <= k:
        return fused_ring_topk(mesh, vs, is_, k, select_min)
    out, _ = _run(mesh, vs, is_, k, select_min, fused_scan_ring_topk)
    return out


fused_scan_ring_topk.launches = 0
fused_scan_ring_topk.stage_launches = 0


# -- dispatch ---------------------------------------------------------------------


def _dispatch(mesh, vs, is_, k: int, select_min: bool, scan: bool, axis=None):
    """:func:`ring_topk` / :func:`scan_ring_topk`: the ``comms.ring_topk``
    fault seam (``kind="scan"`` for the scan ring), then the engine in each
    group along ``axis``; with obs enabled the ring's counters and span
    (``ring_topk.py:599-612``): ``comms.ring.hops`` (``2 (n - 1)``),
    ``comms.ring.bytes{direction}`` (the wire model's reduce-scatter and
    all-gather lanes of one ``B``-row block a hop) and ``ring_topk{engine}``,
    the engine named as JAX names its own: "fused" for B6 / B7, "xla" for
    the plain schedule, "scan_" before either for the scan ring."""
    axis = comms.resolve_axis(mesh, axis)
    one_axis = len(mesh.axis_names) == 1
    n = mesh.size if one_axis else mesh.shape[axis]
    faults.fire("comms.ring_topk", axis=axis, n_shards=n, **({"kind": "scan"} if scan else {}))

    def one(sub, v, i):
        if sub.is_cuda:
            return (fused_scan_ring_topk if scan else fused_ring_topk)(sub, v, i, k, select_min)
        return ring_topk_reference(v, i, k, select_min, sub, scan_fold=scan)

    def run():
        if one_axis:
            return one(mesh, vs, is_)
        out_v, out_i = [None] * len(vs), [None] * len(vs)
        for sub, slots in mesh.along(axis):
            gv, gi = one(sub, [vs[s] for s in slots], [is_[s] for s in slots])
            for s, a, b in zip(slots, gv, gi):
                out_v[s], out_i[s] = a, b
        return out_v, out_i

    if not obs.is_enabled():
        return run()
    B = -(-vs[0].shape[0] // n)
    nbytes = float((n - 1) * B * k * (RS_ENTRY_BYTES + AG_ENTRY_BYTES))
    obs.inc("comms.ring.hops", 2 * max(0, n - 1), axis=axis)
    obs.inc("comms.ring.bytes", nbytes, axis=axis, direction="send")
    obs.inc("comms.ring.bytes", nbytes, axis=axis, direction="recv")
    engine = ("scan_" if scan else "") + ("fused" if mesh.is_cuda else "xla")
    with obs.span("ring_topk", axis=axis, n_shards=n, k=int(k), engine=engine) as sp:
        return sp.sync(run())


def ring_topk(mesh, vs: Sequence[torch.Tensor], is_: Sequence[torch.Tensor], k: int, *,
              select_min: bool = True, axis=None) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Ring merge of per-shard candidates (``vs``/``is_``: one ``[nq, kc]``
    tile per shard, ids global). Returns one replicated ``(vals [nq, k],
    ids [nq, k])`` pair per shard, as two lists, bit-identical to the
    gather merge. A CUDA mesh runs B6 (:func:`ring_engine` picks its
    engine); a CPU mesh the plain schedule. Fires the ``comms.ring_topk``
    fault seam first; an injected error propagates (no fallback to the
    gather merge, unlike the JAX package). With obs enabled it counts
    ``comms.ring.*`` and records a ``ring_topk`` span. On a mesh of several
    axes the ring runs along ``axis`` in each group of shards."""
    return _dispatch(mesh, vs, is_, k, select_min, scan=False, axis=axis)


def scan_ring_topk(mesh, vs: Sequence[torch.Tensor], is_: Sequence[torch.Tensor], k: int, *,
                   select_min: bool = True,
                   axis=None) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Scan-fused ring merge: like :func:`ring_topk` but the local top-``k``
    fold of the full ``[nq, kc]`` tiles runs inside the ring engine
    (``merge_mode="fused_ring"``). A CUDA mesh runs B7 (B6 for tiles no
    wider than ``k``); a CPU mesh the plain schedule with
    :func:`_scan_fold`. Its seam is ``comms.ring_topk`` with
    ``kind="scan"``; the counters and span are :func:`ring_topk`'s."""
    return _dispatch(mesh, vs, is_, k, select_min, scan=True, axis=axis)
