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

Kernels (``raft_tpu_torch/csrc/ring_topk.cu``, CUDA shards):

* B5 :func:`hop_merge` — the fold (``ring_topk.py:328``); every hop of B6
  and B7 launches it and counts in ``hop_merge.launches``;
* B6 :func:`fused_ring_topk` — the ring (``ring_topk.py:505``): a staging
  kernel writes each shard's ``(pos, v, id)`` blocks, then each hop is a
  peer copy of one block on the sender's stream into the receiver's recv
  slot (two slots, reused only after the fold that read them) and a B5
  fold on the receiver's stream; the all-gather copies ``(v, id)`` blocks
  straight into the right neighbour's output;
* B7 :func:`fused_scan_ring_topk` — the scan ring (``ring_topk.py:530``):
  the staging kernel folds the wide ``[nq, kc]`` tile ``w`` columns at a
  time into the ring state (the semantics of :func:`_scan_fold`), then
  B6's schedule runs.

:func:`hop_merge_reference`, :func:`ring_topk_reference` (the schedule of
``_ring_topk_xla`` over the mesh's verbs) and :func:`_scan_fold` are the
plain versions; CPU meshes run them. A CUDA mesh runs the kernels and
never falls back (the JAX package re-runs a failed ring on gather).
"""
from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from raft_tpu_torch.core.errors import RaftError, expects
from raft_tpu_torch.ops.cuda_build import build_library
from raft_tpu_torch.parallel import comms
from raft_tpu_torch.parallel.wire_model import (
    AG_ENTRY_BYTES,
    RS_ENTRY_BYTES,
    wire_bytes_per_query,
)

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
}


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
    """Plain version of the ring (``_ring_topk_xla``): the same
    reduce-scatter and all-gather hops, as :func:`comms.ppermute` verbs over
    the mesh, with the plain fold. Returns one replicated ``(vals [nq, k],
    ids [nq, k])`` pair per shard, as two lists."""
    _check_parts(mesh, vs, is_, k)
    n = mesh.size
    nq = vs[0].shape[0]
    mesh.fork()
    states = []
    for r in range(n):
        with mesh.on(r):
            key, pos, v, i, B = _prep(vs[r], is_[r], k, select_min, r, n, scan_fold)
            states.append([x.reshape(n, B, k).clone() for x in (key, pos, v, i)])
    if n == 1:
        out = ([states[0][2][0][:nq]], [states[0][3][0][:nq]])
        mesh.join(out[0] + out[1])
        return out
    perm = [(j, (j + 1) % n) for j in range(n)]
    for s in range(n - 1):
        recv = [comms.ppermute(mesh, [st[ln][(r - s) % n] for r, st in enumerate(states)], perm)
                for ln in range(4)]
        for r in range(n):
            with mesh.on(r):
                b = (r - s - 1) % n
                folded = _fold(tuple(states[r][ln][b] for ln in range(4)),
                               tuple(recv[ln][r] for ln in range(4)), k)
                for ln in range(4):
                    states[r][ln][b] = folded[ln]
    out_v = [st[2] for st in states]
    out_i = [st[3] for st in states]
    for s in range(n - 1):
        rv = comms.ppermute(mesh, [out_v[r][(r + 1 - s) % n] for r in range(n)], perm)
        ri = comms.ppermute(mesh, [out_i[r][(r + 1 - s) % n] for r in range(n)], perm)
        for r in range(n):
            with mesh.on(r):
                b = (r - s) % n
                out_v[r][b] = rv[r]
                out_i[r][b] = ri[r]
    vals, ids = [], []
    for r in range(n):
        with mesh.on(r):
            vals.append(out_v[r].reshape(-1, k)[:nq])
            ids.append(out_i[r].reshape(-1, k)[:nq])
    mesh.join(vals + ids)
    return vals, ids


def gather_merge(mesh, vs, is_, k: int, select_min: bool):
    """The gather path's merge (the reference engine): every shard receives
    every block (:func:`comms.allgather`) and merges the shard-major
    concatenation with ``merge_parts``. One replicated pair per shard."""
    from raft_tpu_torch.ops.select_k import merge_parts

    _check_parts(mesh, vs, is_, None)
    mesh.fork()
    all_v = comms.allgather(mesh, [v.to(torch.float32) for v in vs])
    all_i = comms.allgather(mesh, [i.to(torch.int32) for i in is_])
    vals, ids = [], []
    for r in range(mesh.size):
        with mesh.on(r):
            n, nq, kc = all_v[r].shape
            cat_v = all_v[r].permute(1, 0, 2).reshape(nq, n * kc)
            cat_i = all_i[r].permute(1, 0, 2).reshape(nq, n * kc)
            v, i = merge_parts(cat_v, cat_i, k, select_min=select_min)
            vals.append(v)
            ids.append(i)
    mesh.join(vals + ids)
    return vals, ids


# -- checks --------------------------------------------------------------------


def _check_tiles(a, b):
    expects(len(a) == 4 and len(b) == 4, "hop_merge: a and b must be (key, pos, val, id) tuples")
    shape = tuple(a[0].shape)
    expects(len(shape) == 2 and shape[1] >= 1, "hop_merge: tiles must be [rows, w >= 1]")
    for x in tuple(a) + tuple(b):
        expects(tuple(x.shape) == shape, "hop_merge: every lane must be %s", shape)
        expects(x.device == a[0].device, "hop_merge: lanes on different devices")


def _check_parts(mesh, vs, is_, k):
    expects(len(vs) == mesh.size and len(is_) == mesh.size,
            "ring: %d/%d per-shard tiles for %d shards", len(vs), len(is_), mesh.size)
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
    if err != 0:
        raise RaftError(f"ring_fold kernel launch failed (cudaError {err})")
    hop_merge.launches += 1


def hop_merge(a, b):
    """B5: the top-``w`` of two ``(key f32, pos i32, val f32, id i32)``
    tiles of ``[rows, w]`` under ``(key, pos)``, sorted. The inputs need not
    be sorted. CUDA tensors launch the kernel (one CTA per row;
    ``hop_merge.launches`` counts launches, the ring's folds included); CPU
    tensors take :func:`hop_merge_reference`."""
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
    ``w`` to its top ``w``."""
    nq, kc = v.shape
    v = v.to(torch.float32).contiguous()
    i = i.to(torch.int32).contiguous()
    state = torch.empty((n, _RS_LANES, B, w), dtype=torch.int32, device=v.device)
    err = lib.ring_stage(_ptr(v), _ptr(i), nq, kc, rank, n * B, B, w, int(select_min),
                         _ptr(state), _stream())
    if err != 0:
        raise RaftError(f"ring_stage kernel launch failed (cudaError {err})")
    return state


def _ring_body(lib, mesh, states: List[torch.Tensor], nq: int, B: int, w: int,
               select_min: bool):
    """B6's schedule over staged states; returns the per-shard outputs and
    the bytes one rank copied."""
    n = mesh.size
    key_sign = 1 if select_min else -1
    bw = B * w
    recv, out, ready = [], [], []
    for r in range(n):
        with mesh.on(r):
            recv.append(torch.empty((2, _RS_LANES, B, w), dtype=torch.int32, device=mesh.devices[r]))
            out.append(torch.empty((n, _AG_LANES, B, w), dtype=torch.int32, device=mesh.devices[r]))
            ev = torch.cuda.Event()
            ev.record()
            ready.append(ev)
    folded = [[None] * (n - 1) for _ in range(n)]
    # -- reduce-scatter: after hop s, shard r's block (r - s - 1) % n holds
    # every shard <= r's candidates; after n - 1 hops block (r + 1) % n is done
    for s in range(n - 1):
        slot = s % 2
        for r in range(n):
            right = (r + 1) % n
            with mesh.on(r):
                if s == 0:
                    mesh.streams[r].wait_event(ready[right])
                if s >= 2:  # the slot's last reader, right's fold of hop s - 2, is done
                    mesh.streams[r].wait_event(folded[right][s - 2])
            comms.peer_copy(mesh, states[r][(r - s) % n], r, right, out=recv[right][slot])
        for r in range(n):
            with mesh.on(r):
                dst = states[r][(r - s - 1) % n]
                got = recv[r][slot]
                a = [None, _ptr(dst, 0), _ptr(dst, bw), _ptr(dst, 2 * bw)]
                b = [None, _ptr(got, 0), _ptr(got, bw), _ptr(got, 2 * bw)]
                _launch_fold(lib, a, b, a, B, w, key_sign)
                ev = torch.cuda.Event()
                ev.record()
                folded[r][s] = ev
    # -- all-gather of the finished blocks as (val, id)
    for r in range(n):
        own = (r + 1) % n
        with mesh.on(r):
            out[r][own].copy_(states[r][own, 1:3])
    for s in range(n - 1):
        for r in range(n):
            b = (r + 1 - s) % n
            comms.peer_copy(mesh, out[r][b], r, (r + 1) % n, out=out[(r + 1) % n][b])
    per_rank = (n - 1) * bw * (RS_ENTRY_BYTES + AG_ENTRY_BYTES)
    stats = dict(per_rank=per_rank, per_query=per_rank / max(nq, 1),
                 rs_hop=bw * RS_ENTRY_BYTES, ag_hop=bw * AG_ENTRY_BYTES,
                 model_per_query=wire_bytes_per_query(n, w, "ring"))
    return out, stats


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
    """Stage every shard (folding tiles wider than ``k``), then B6's
    schedule; returns the outputs and the bytes copied (None for n == 1)."""
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
    for r in range(n):
        with mesh.on(r):
            states.append(_stage(lib, vs[r], is_[r], r, n, B, k, select_min))
    if n == 1:
        return _finish(mesh, states, nq, k, 1), None
    out, stats = _ring_body(lib, mesh, states, nq, B, k, select_min)
    return _finish(mesh, out, nq, k, 0), stats


def fused_ring_topk(mesh, vs, is_, k: int, select_min: bool = True):
    """B6: the ring merge of per-shard ``[nq, kc]`` candidates on a CUDA
    mesh (see the module docstring). Returns one replicated ``(vals [nq,
    k], ids [nq, k])`` pair per shard, equal bit for bit to the gather
    merge. ``fused_ring_topk.launches`` counts calls (each launches the
    staging kernel and, with more than one shard, the ring's folds);
    ``fused_ring_topk.last_bytes`` holds the bytes one rank copied in the
    last call beside ``wire_bytes_per_query``."""
    _check_parts(mesh, vs, is_, k)
    expects(mesh.is_cuda, "fused_ring_topk needs a CUDA mesh (CPU meshes run ring_topk_reference)")
    out, stats = _run_ring(mesh, vs, is_, k, select_min)
    fused_ring_topk.launches += 1
    fused_ring_topk.last_bytes = stats
    return out


fused_ring_topk.launches = 0
fused_ring_topk.last_bytes = None


def fused_scan_ring_topk(mesh, vs, is_, k: int, select_min: bool = True):
    """B7: the scan ring on a CUDA mesh. Takes the scan's full ``[nq, kc]``
    tiles; the staging kernel folds each block's rows ``k`` columns at a
    time straight into the ring state, then B6's schedule runs (with one
    shard the fold alone). Tiles no wider than ``k`` have nothing to fold
    and go to :func:`fused_ring_topk`. ``fused_scan_ring_topk.launches``
    counts the calls that run the scan fold."""
    _check_parts(mesh, vs, is_, k)
    expects(mesh.is_cuda, "fused_scan_ring_topk needs a CUDA mesh")
    if vs[0].shape[1] <= k:
        return fused_ring_topk(mesh, vs, is_, k, select_min)
    out, _ = _run_ring(mesh, vs, is_, k, select_min)
    fused_scan_ring_topk.launches += 1
    return out


fused_scan_ring_topk.launches = 0


# -- dispatch ---------------------------------------------------------------------


def ring_topk(mesh, vs: Sequence[torch.Tensor], is_: Sequence[torch.Tensor], k: int, *,
              select_min: bool = True) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Ring merge of per-shard candidates (``vs``/``is_``: one ``[nq, kc]``
    tile per shard, ids global). Returns one replicated ``(vals [nq, k],
    ids [nq, k])`` pair per shard, as two lists, bit-identical to the
    gather merge. A CUDA mesh runs B6; a CPU mesh the plain schedule."""
    if mesh.is_cuda:
        return fused_ring_topk(mesh, vs, is_, k, select_min)
    return ring_topk_reference(vs, is_, k, select_min, mesh)


def scan_ring_topk(mesh, vs: Sequence[torch.Tensor], is_: Sequence[torch.Tensor], k: int, *,
                   select_min: bool = True) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Scan-fused ring merge: like :func:`ring_topk` but the local top-``k``
    fold of the full ``[nq, kc]`` tiles runs inside the ring engine
    (``merge_mode="fused_ring"``). A CUDA mesh runs B7 (B6 for tiles no
    wider than ``k``); a CPU mesh the plain schedule with
    :func:`_scan_fold`."""
    if mesh.is_cuda:
        return fused_scan_ring_topk(mesh, vs, is_, k, select_min)
    return ring_topk_reference(vs, is_, k, select_min, mesh, scan_fold=True)
