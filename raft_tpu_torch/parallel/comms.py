"""Mesh and comms verb set (``raft_tpu.parallel.comms`` counterpart).

The JAX package runs a sharded program as one ``shard_map`` body over a
``jax.sharding.Mesh``: each collective is a ``lax`` op inside the body.
The port runs it over one of two kinds of mesh, with the same verbs:

* a **single-controller** :class:`Mesh` of torch devices: one process
  holds every shard. A ``shard_map`` body becomes phases, a per-shard loop
  (shard ``r``'s work runs inside ``mesh.on(r)``) and then a verb over the
  per-shard tensor lists. On a card every shard owns a CUDA stream; shards
  may repeat a device (``["cuda:0"] * 4``: four virtual shards on one card,
  as the JAX tests force eight CPU devices) but are never folded onto one
  quietly: :func:`make_mesh` takes every visible card, or exactly the list
  it is given. A peer copy is ``copy_(..., non_blocking=True)`` on the
  sender's stream, followed by an event that the receiver's stream waits
  on;
* a **process mesh** (:class:`raft_tpu_torch.parallel.process_comms.ProcessMesh`,
  from :func:`raft_tpu_torch.parallel.bootstrap.global_mesh`) spans the
  processes of a ``torch.distributed`` group. Each process holds its local
  shards (``mesh.local_ranks`` are their global ranks) and every verb goes
  over ``torch.distributed``: see that module for the wire.

Both kinds take a ``shape`` of several named axes, the devices in
row-major order over it (``mesh.shape`` is an ordered ``{axis: size}``, as
``jax.sharding.Mesh.shape``; ``mesh.size`` is the number of shards). Every
verb takes ``axis=``: its default is the mesh's only axis, and a mesh of
several axes needs one named. A verb along ``axis`` acts within each group
of shards that share their other coordinates; ranks, roots and pairs are
coordinates along ``axis`` (:func:`comm_rank`).

Verbs take one tensor per local shard (``len(mesh.devices)``, in the order
of ``mesh.local_ranks``; on a single-controller mesh every shard), each
ready on its shard's stream, and return one per local shard, each ready on
its shard's stream. :meth:`Mesh.fork` makes the shard streams wait for the
caller's stream and :meth:`Mesh.join` the caller's stream for the shard
streams; the public sharded entry points call both. Every verb is written
once over three transports of the mesh (:meth:`Mesh._gathered`,
:meth:`Mesh._bcast`, :meth:`Mesh._moved`), so the two kinds give the same
bits. CPU meshes (``["cpu"] * n``) run the same code with plain copies; the
tests use them. :func:`init_comms` installs a mesh on
:class:`~raft_tpu_torch.core.resources.Resources`; :func:`comm_split` names
a sub-communicator (an axis and its size).

With :mod:`raft_tpu_torch.obs` enabled every public verb counts
``comms.{verb}.calls{axis}`` and ``comms.{verb}.bytes{axis}`` (one shard's
payload scaled by :data:`~raft_tpu_torch.parallel.wire_model.WIRE_FACTORS`
at the size of the axis it ran on) and records a ``comms.{verb}`` span;
:func:`allgather` fires the ``comms.all_gather`` fault seam. The JAX
package counts while it traces a ``shard_map`` body, once per compiled
program; the port counts once per call, in the process that calls. The
ring and gather merges of sharded search call the raw verbs
(``_allgather``, ``_ppermute``), as the JAX package's call ``lax``
collectives directly: they neither count nor fire.
"""
from __future__ import annotations

import contextlib
import functools
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from raft_tpu_torch import obs
from raft_tpu_torch.core.errors import expects
from raft_tpu_torch.parallel.wire_model import WIRE_FACTORS
from raft_tpu_torch.robust import faults

DEFAULT_AXIS = "data"

_REDUCE_OPS = ("sum", "max", "min", "prod")


def axis_groups(dims: Sequence[int], axis_index: int) -> List[Tuple[int, ...]]:
    """The global ranks of each group of shards along axis ``axis_index``
    of a row-major mesh of ``dims``: groups in row-major order of the other
    coordinates, each group in order along the axis."""
    ranks = np.arange(int(np.prod(dims))).reshape(tuple(dims))
    rows = np.moveaxis(ranks, axis_index, -1).reshape(-1, dims[axis_index])
    return [tuple(int(r) for r in row) for row in rows]


class Mesh:
    """A single-controller mesh of torch devices in row-major order over
    ``dims`` (one axis when not given), one CUDA stream per shard on a card
    (``None`` on the CPU). Every shard is local: ``local_ranks`` is
    ``range(size)``."""

    is_process = False

    def __init__(self, devices: Sequence[torch.device], axis_names: Tuple[str, ...],
                 dims: Optional[Sequence[int]] = None, streams=None):
        self.devices = tuple(devices)
        self.axis_names = tuple(axis_names)
        self.dims = tuple(int(x) for x in dims) if dims is not None else (len(self.devices),)
        self.streams = (tuple(streams) if streams is not None else
                        tuple(torch.cuda.Stream(device=d) if d.type == "cuda" else None
                              for d in self.devices))
        self.local_ranks = tuple(range(len(self.devices)))

    @property
    def size(self) -> int:
        """Number of shards (over every axis and every process)."""
        return int(np.prod(self.dims))

    @property
    def shape(self) -> dict:
        """``{axis: size}`` in axis order, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.dims))

    @property
    def is_cuda(self) -> bool:
        return self.devices[0].type == "cuda"

    @property
    def virtual(self) -> bool:
        """Whether two local shards share a device."""
        return len(set(self.devices)) < len(self.devices)

    def key(self) -> tuple:
        """The mesh's layout as a hashable key (for per-mesh caches)."""
        return (tuple(str(d) for d in self.devices), self.axis_names, self.dims)

    def coord(self, rank: int, axis: str) -> int:
        """Global shard ``rank``'s coordinate along ``axis``."""
        return int(np.unravel_index(rank, self.dims)[self.axis_names.index(axis)])

    @contextlib.contextmanager
    def on(self, r: int):
        """Run local shard ``r``'s work: its device and stream become current."""
        s = self.streams[r]
        if s is None:
            yield
            return
        with torch.cuda.device(self.devices[r]), torch.cuda.stream(s):
            yield

    def fork(self) -> None:
        """Every shard stream waits for the work its device's current stream
        has queued (the inputs the caller made)."""
        for d, s in zip(self.devices, self.streams):
            if s is not None:
                s.wait_stream(torch.cuda.current_stream(d))

    def join(self, tensors: Sequence[torch.Tensor] = ()) -> None:
        """Every device's current stream waits for the shard streams on it;
        ``tensors`` (results handed back to the caller) are marked as used
        on those streams, so the allocator does not reuse them early."""
        if not self.is_cuda:
            return
        for d in set(self.devices):
            cur = torch.cuda.current_stream(d)
            for dd, s in zip(self.devices, self.streams):
                if dd == d:
                    cur.wait_stream(s)
        for t in tensors:
            t.record_stream(torch.cuda.current_stream(t.device))

    # -- agreement between the processes of a mesh ------------------------------

    def agreed(self, flags: Sequence[bool]) -> Tuple[bool, ...]:
        """Each flag ANDed over every process of the mesh: on one controller
        the flags as they are (a process mesh gathers them)."""
        return tuple(bool(f) for f in flags)

    def from_first(self, x: torch.Tensor) -> torch.Tensor:
        """The process of global rank 0's ``x`` (this process's on one
        controller), on ``x``'s device."""
        return x

    # -- the groups along an axis ----------------------------------------------

    def along(self, axis: Optional[str] = None) -> List[Tuple["Mesh", Tuple[int, ...]]]:
        """The groups of shards along ``axis`` that hold a local shard: one
        ``(sub-mesh, local slots)`` pair a group, the sub-mesh a one-axis
        view of the group (sharing the shards' streams) whose rank ``a`` is
        coordinate ``a`` along ``axis``, the slots the group's local shards
        in this mesh's per-shard lists. A one-axis mesh is its own only
        group. Cached on the mesh."""
        axis = resolve_axis(self, axis)
        if len(self.axis_names) == 1:
            return [(self, tuple(range(len(self.devices))))]
        cache = self.__dict__.setdefault("_along", {})
        if axis not in cache:
            cache[axis] = self._make_groups(axis)
        return cache[axis]

    def _make_groups(self, axis: str):
        out = []
        for g in axis_groups(self.dims, self.axis_names.index(axis)):
            sub = Mesh([self.devices[r] for r in g], (axis,), streams=[self.streams[r] for r in g])
            out.append((sub, g))
        return out

    # -- transports (one-axis meshes; ranks are positions along the axis) --------

    def _gathered(self, xs: Sequence[torch.Tensor]) -> List[List[torch.Tensor]]:
        """For each local shard, every shard's block in rank order, on its
        device and ready on its stream (its own without a copy)."""
        return [[xs[s] if s == r else peer_copy(self, xs[s], s, r) for s in range(self.size)]
                for r in range(self.size)]

    def _bcast(self, xs: Sequence[torch.Tensor], root: int) -> List[torch.Tensor]:
        """For each local shard, ``root``'s block."""
        return [xs[root] if r == root else peer_copy(self, xs[root], root, r)
                for r in range(self.size)]

    def _moved(self, xs: Sequence[torch.Tensor], pairs: Sequence[Tuple[int, int]],
               outs: Optional[Sequence[torch.Tensor]] = None) -> List[Optional[torch.Tensor]]:
        """For each local shard, the block the ``(src, dst)`` pair naming it
        as ``dst`` sends (written into ``outs[dst]`` when given), or None.
        Each shard is a ``dst`` at most once."""
        got: List[Optional[torch.Tensor]] = [None] * self.size
        for s, d in pairs:
            if s == d and outs is None:
                got[d] = xs[s]
            else:
                got[d] = peer_copy(self, xs[s], s, d, out=None if outs is None else outs[d])
        return got

    def __repr__(self) -> str:
        kind = "virtual shards" if self.virtual else "shards"
        return (f"Mesh({self.size} {kind} along {_axes_repr(self)}: "
                f"{', '.join(str(d) for d in self.devices)})")


def _axes_repr(mesh) -> str:
    """``'data'`` for one axis, ``'x' 2 x 'y' 4`` for several."""
    if len(mesh.axis_names) == 1:
        return repr(mesh.axis_names[0])
    return " x ".join(f"{a!r} {n}" for a, n in zip(mesh.axis_names, mesh.dims))


def resolve_axis(mesh, axis: Optional[str]) -> str:
    """``axis``, checked against the mesh's axes; None names the mesh's only
    axis (a mesh of several axes needs one named)."""
    if axis is None:
        expects(len(mesh.axis_names) == 1, "the mesh has several axes %s: name one with axis=",
                mesh.axis_names)
        return mesh.axis_names[0]
    expects(axis in mesh.axis_names, "axis %r not in mesh axes %s", axis, mesh.axis_names)
    return axis


def check_devices(devices: Sequence) -> List[torch.device]:
    """``devices`` as torch devices: all CPU or all CUDA, each CUDA device
    visible (an index-less ``cuda`` is card 0)."""
    n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    devs = []
    for d in devices:
        d = torch.device(d)
        if d.type == "cuda":
            if d.index is None:
                d = torch.device("cuda", 0)
            expects(d.index < n_cards, "make_mesh: %s asked for, but %d CUDA device(s) are "
                    "visible; list a device more than once for virtual shards", d, n_cards)
        else:
            expects(d.type == "cpu", "make_mesh: unsupported device %s", d)
        devs.append(d)
    expects(len(devs) >= 1, "make_mesh: no devices")
    expects(len({d.type for d in devs}) == 1, "make_mesh: devices mix CPU and CUDA: %s", devs)
    return devs


def mesh_dims(n_shards: int, shape: Optional[Sequence[int]], axis_names: Tuple[str, ...]):
    """The mesh's dims: ``shape``, or one axis over every shard; checked
    against the shard count and the axis names."""
    if shape is None:
        expects(len(axis_names) == 1, "make_mesh: axes %s need shape=; with no shape the mesh is "
                "one-axis over its %d shards", axis_names, n_shards)
        return (n_shards,)
    dims = tuple(int(x) for x in shape)
    expects(int(np.prod(dims)) == n_shards, "mesh shape %s does not cover %d devices", dims,
            n_shards)
    expects(len(dims) == len(axis_names), "mesh shape %s has %d axes, axis names %s", dims,
            len(dims), axis_names)
    expects(len(set(axis_names)) == len(axis_names), "mesh axis names repeat: %s", axis_names)
    return dims


def make_mesh(devices: Optional[Sequence] = None, shape: Optional[Sequence[int]] = None,
              axis_names: Sequence[str] = (DEFAULT_AXIS,)) -> Mesh:
    """A single-controller mesh. ``devices=None`` takes every visible CUDA
    device (raises without one); otherwise exactly the given list, in order:
    a device may repeat (virtual shards, e.g. ``["cuda:0"] * 4`` or
    ``["cpu"] * 4``), and a CUDA device that is not there raises.
    ``shape`` lays the devices out row-major over ``axis_names`` (one axis
    over every device when not given), as the JAX package's ``make_mesh``."""
    axis_names = tuple(axis_names)
    if devices is None:
        n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        expects(n_cards > 0, "make_mesh: no CUDA device is visible; pass devices= "
                "(e.g. ['cpu'] * 4 for a CPU mesh)")
        devices = [torch.device("cuda", i) for i in range(n_cards)]
    devs = check_devices(devices)
    return Mesh(devs, axis_names, mesh_dims(len(devs), shape, axis_names))


def init_comms(res=None, devices: Optional[Sequence] = None, shape: Optional[Sequence[int]] = None,
               axis_names: Sequence[str] = (DEFAULT_AXIS,)) -> Mesh:
    """Make a mesh (:func:`make_mesh`) and install it on the resources
    handle (``inject_comms_on_handle``); returns the mesh."""
    from raft_tpu_torch.core.resources import ensure_resources

    res = ensure_resources(res)
    mesh = make_mesh(devices, shape, axis_names)
    res.mesh = mesh
    return mesh


def comm_size(mesh: Mesh, axis: Optional[str] = None) -> int:
    """Number of shards along ``axis`` (``comms_t::get_size``)."""
    return mesh.shape[resolve_axis(mesh, axis)]


def comm_rank(mesh: Mesh, axis: Optional[str] = None) -> List[torch.Tensor]:
    """Each local shard's rank along ``axis`` (``comms_t::get_rank``): its
    coordinate there, an int32 scalar a shard, on its device."""
    axis = resolve_axis(mesh, axis)
    return [torch.tensor(mesh.coord(r, axis), dtype=torch.int32, device=d)
            for r, d in zip(mesh.local_ranks, mesh.devices)]


def comm_split(mesh: Mesh, axis: str) -> dict:
    """The sub-communicator along ``axis`` (``comms_t::comm_split``): its
    name and size, which the verbs take."""
    expects(axis in mesh.axis_names, "axis %s not in mesh axes %s", axis, mesh.axis_names)
    return {"axis": axis, "size": mesh.shape[axis]}


# -- placement ------------------------------------------------------------------


def replicated(mesh: Mesh, x: torch.Tensor) -> List[torch.Tensor]:
    """One copy of ``x`` per local shard (the same tensor for shards on its
    device: read-only)."""
    return [x if x.device == d else x.to(d) for d in mesh.devices]


def row_sharded(mesh: Mesh, x: torch.Tensor, axis: Optional[str] = None) -> List[torch.Tensor]:
    """``x`` split into equal row blocks, one per coordinate along ``axis``
    (replicated over the other axes): each local shard keeps the block of
    its coordinate (a view for a shard on ``x``'s device)."""
    axis = resolve_axis(mesh, axis)
    n = mesh.shape[axis]
    expects(x.shape[0] % n == 0, "rows %d not divisible by %d shards", x.shape[0], n)
    per = x.shape[0] // n
    out = []
    for r, d in zip(mesh.local_ranks, mesh.devices):
        a = mesh.coord(r, axis)
        blk = x[a * per:(a + 1) * per]
        out.append(blk if x.device == d else blk.to(d))
    return out


# -- peer copies ----------------------------------------------------------------


def peer_copy(mesh: Mesh, x: torch.Tensor, src: int, dst: int,
              out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Copy local shard ``src``'s ``x`` (ready on its stream) to local
    shard ``dst``: ``copy_(..., non_blocking=True)`` on the sender's stream,
    then ``dst``'s stream waits on an event recorded after it. Writes into
    ``out`` (a buffer of ``dst``'s) when given, else into a new tensor. The
    result is ready on ``dst``'s stream."""
    if not mesh.is_cuda:
        if out is None:
            return x.to(mesh.devices[dst], copy=True)
        return out.copy_(x)
    ss, ds = mesh.streams[src], mesh.streams[dst]
    with mesh.on(src):
        if out is None:
            out = torch.empty(x.shape, dtype=x.dtype, device=mesh.devices[dst])
        out.copy_(x, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(ss)
    out.record_stream(ss)
    out.record_stream(ds)
    x.record_stream(ss)
    ds.wait_event(ev)
    return out


def _check_parts(mesh: Mesh, xs: Sequence[torch.Tensor]) -> None:
    expects(len(xs) == len(mesh.devices), "%d per-shard tensors for %d shards", len(xs),
            len(mesh.devices))
    for r, (x, d) in enumerate(zip(xs, mesh.devices)):
        expects(x.device == d, "shard %d's tensor is on %s, the shard on %s", r, x.device, d)


def _per_group(mesh: Mesh, xs: Sequence[torch.Tensor], axis: Optional[str], body) -> list:
    """Run ``body(sub, parts)`` on every group along ``axis`` (the group's
    one-axis sub-mesh and its local shards' tensors; it returns one result
    per local shard of the group) between a fork and a join, and place the
    results in the mesh's per-shard order."""
    _check_parts(mesh, xs)
    mesh.fork()
    out: list = [None] * len(xs)
    for sub, slots in mesh.along(axis):
        for slot, y in zip(slots, body(sub, [xs[s] for s in slots])):
            out[slot] = y
    mesh.join()
    return out


def _reduce(parts: Sequence[torch.Tensor], op: str) -> torch.Tensor:
    """Reduce over the rank axis in rank order (a fixed summation order)."""
    acc = parts[0].clone()
    for p in parts[1:]:
        if op == "sum":
            acc = acc + p
        elif op == "max":
            acc = torch.maximum(acc, p)
        elif op == "min":
            acc = torch.minimum(acc, p)
        else:
            acc = acc * p
    return acc


def _on_each(sub: Mesh, fn, *per_shard) -> list:
    """``fn(rank, *args)`` on each local shard of a one-axis ``sub``,
    inside ``sub.on``; ``rank`` is the shard's rank along the axis."""
    out = []
    for j, r in enumerate(sub.local_ranks):
        with sub.on(j):
            out.append(fn(r, *(a[j] for a in per_shard)))
    return out


# -- verbs (one tensor per local shard in, one per local shard out) ----------------


def _instrumented(verb: str):
    """Wrap a verb with the ``comms.{verb}.calls`` / ``.bytes`` counters and
    a ``comms.{verb}`` span (``raft_tpu/parallel/comms.py:73-112``): the
    bytes are one shard's payload (4 for :func:`barrier`, which has none)
    scaled by the verb's wire model at the size of the axis it runs on,
    which labels both. Obs disabled: one flag check. A composite verb
    (``reduce`` over ``allreduce``) counts its inner verb too, as the JAX
    package does."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(mesh, *a, **kw):
            if not obs.is_enabled():
                return fn(mesh, *a, **kw)
            axis = resolve_axis(mesh, kw.get("axis"))
            xs = a[0] if a else kw.get("xs")
            nbytes = float(xs[0].numel() * xs[0].element_size()) if xs else 4.0
            nbytes = WIRE_FACTORS.get(verb, lambda p, _: p)(nbytes, mesh.shape[axis])
            obs.inc(f"comms.{verb}.calls", axis=axis)
            obs.inc(f"comms.{verb}.bytes", nbytes, axis=axis)
            with obs.span(f"comms.{verb}", bytes=nbytes, axis=axis) as sp:
                return sp.sync(fn(mesh, *a, **kw))

        return wrapper

    return deco


def _allgather(mesh: Mesh, xs: Sequence[torch.Tensor], tiled: bool = False, *,
               axis: Optional[str] = None) -> List[torch.Tensor]:
    """:func:`allgather` without its counters and fault seam (the gather
    merge's collective)."""

    def body(sub, parts):
        join = torch.cat if tiled else torch.stack
        return _on_each(sub, lambda r, bl: join(bl, dim=0), sub._gathered(parts))

    return _per_group(mesh, xs, axis, body)


@_instrumented("allgather")
def allgather(mesh: Mesh, xs: Sequence[torch.Tensor], tiled: bool = False, *,
              axis: Optional[str] = None) -> List[torch.Tensor]:
    """``comms_t::allgather``: each shard receives every block of its group
    along ``axis``, stacked on a new leading rank axis (``tiled=True``:
    concatenated along axis 0). Fires the ``comms.all_gather`` fault seam
    first, the collective analog of a lost participant."""
    faults.fire("comms.all_gather", axis=resolve_axis(mesh, axis))
    return _allgather(mesh, xs, tiled, axis=axis)


def _allreduce(mesh: Mesh, xs: Sequence[torch.Tensor], op: str = "sum", *,
               axis: Optional[str] = None) -> List[torch.Tensor]:
    """:func:`allreduce` without its counters (:func:`barrier`'s)."""
    expects(op in _REDUCE_OPS, "unknown reduce op %s", op)

    def body(sub, parts):
        return _on_each(sub, lambda r, bl: _reduce(bl, op), sub._gathered(parts))

    return _per_group(mesh, xs, axis, body)


@_instrumented("allreduce")
def allreduce(mesh: Mesh, xs: Sequence[torch.Tensor], op: str = "sum", *,
              axis: Optional[str] = None) -> List[torch.Tensor]:
    """``comms_t::allreduce``: every shard receives the elementwise
    reduction over its group along ``axis`` (added in rank order)."""
    return _allreduce(mesh, xs, op, axis=axis)


@_instrumented("reducescatter")
def reducescatter(mesh: Mesh, xs: Sequence[torch.Tensor], op: str = "sum", *,
                  axis: Optional[str] = None) -> List[torch.Tensor]:
    """``comms_t::reducescatter``: elementwise reduce across the group along
    ``axis``, shard ``r`` keeps the ``r``-th equal chunk of axis 0."""
    expects(op == "sum", "reducescatter supports sum")
    n = comm_size(mesh, axis)
    expects(xs[0].shape[0] % n == 0, "axis 0 (%d) not divisible by %d shards", xs[0].shape[0], n)
    c = xs[0].shape[0] // n

    def body(sub, parts):
        if not sub.is_process:  # each shard receives only its chunk
            return _sc_reducescatter(sub, parts, c, op)
        return _on_each(sub, lambda r, bl: _reduce([b[r * c:(r + 1) * c] for b in bl], op),
                        sub._gathered(parts))

    return _per_group(mesh, xs, axis, body)


def _sc_reducescatter(sub: Mesh, parts, c: int, op: str) -> List[torch.Tensor]:
    """Single-controller reduce-scatter: shard ``r`` receives only chunk
    ``r`` of every block."""
    out = []
    for r in range(sub.size):
        got = [parts[s][r * c:(r + 1) * c] if s == r else
               peer_copy(sub, parts[s][r * c:(r + 1) * c], s, r) for s in range(sub.size)]
        with sub.on(r):
            out.append(_reduce(got, op))
    return out


@_instrumented("bcast")
def bcast(mesh: Mesh, xs: Sequence[torch.Tensor], root: int = 0, *,
          axis: Optional[str] = None) -> List[torch.Tensor]:
    """``comms_t::bcast``: every shard receives the block of rank ``root``
    of its group along ``axis``."""
    return _per_group(mesh, xs, axis, lambda sub, parts: sub._bcast(parts, root))


@_instrumented("reduce")
def reduce(mesh: Mesh, xs: Sequence[torch.Tensor], root: int = 0, op: str = "sum", *,
           axis: Optional[str] = None) -> List[torch.Tensor]:
    """``comms_t::reduce``: the reduction on rank ``root`` along ``axis``,
    zeros elsewhere."""
    axis = resolve_axis(mesh, axis)
    full = allreduce(mesh, xs, op=op, axis=axis)
    return [f if mesh.coord(r, axis) == root else torch.zeros_like(f)
            for r, f in zip(mesh.local_ranks, full)]


def _zeros_where_none(sub: Mesh, got, parts) -> List[torch.Tensor]:
    """Each local shard's received block, zeros where it received none."""
    return _on_each(sub, lambda r, g, x: torch.zeros_like(x) if g is None else g, got, parts)


def _ppermute(mesh: Mesh, xs: Sequence[torch.Tensor], perm: Sequence[Tuple[int, int]], *,
              axis: Optional[str] = None) -> List[torch.Tensor]:
    """:func:`ppermute` without its counters (the ring merge's hops and
    :func:`send_recv`)."""
    dsts = [d for _, d in perm]
    expects(len(set(dsts)) == len(dsts), "ppermute: a shard receives twice in %s", perm)

    def body(sub, parts):
        return _zeros_where_none(sub, sub._moved(parts, perm), parts)

    return _per_group(mesh, xs, axis, body)


@_instrumented("ppermute")
def ppermute(mesh: Mesh, xs: Sequence[torch.Tensor], perm: Sequence[Tuple[int, int]], *,
             axis: Optional[str] = None) -> List[torch.Tensor]:
    """Point-to-point permutation (``lax.ppermute``) within each group along
    ``axis``: for each ``(src, dst)`` pair rank ``dst`` receives ``src``'s
    block; a shard named by no pair receives zeros."""
    return _ppermute(mesh, xs, perm, axis=axis)


@_instrumented("send_recv")
def send_recv(mesh: Mesh, xs: Sequence[torch.Tensor], src: int, dst: int, *,
              axis: Optional[str] = None) -> List[torch.Tensor]:
    """One device p2p transfer (``comms_t::device_send``/``device_recv``):
    ``dst`` receives ``src``'s block, every other shard zeros."""
    return _ppermute(mesh, xs, [(src, dst)], axis=axis)


@_instrumented("barrier")
def barrier(mesh: Mesh, *, axis: Optional[str] = None) -> List[torch.Tensor]:
    """``comms_t::barrier``: an allreduce of ones along ``axis``, so every
    shard waits for every other of its group; returns the group's shard
    count on each shard."""
    ones = []
    for r in range(len(mesh.devices)):
        with mesh.on(r):
            ones.append(torch.ones((), dtype=torch.int32, device=mesh.devices[r]))
    return _allreduce(mesh, ones, axis=axis)


def _gather(mesh: Mesh, xs: Sequence[torch.Tensor], root: int,
            axis: Optional[str]) -> List[torch.Tensor]:
    """:func:`gather` without its counters (:func:`gatherv`'s two halves)."""

    def body(sub, parts):
        if sub.is_process:
            got = sub._gathered(parts)
        else:  # only the root receives
            got = [None] * sub.size
            got[root] = [parts[s] if s == root else peer_copy(sub, parts[s], s, root)
                         for s in range(sub.size)]
        return _on_each(sub, lambda r, bl, x: torch.stack(bl, dim=0) if r == root else
                        torch.zeros((sub.size,) + tuple(x.shape), dtype=x.dtype, device=x.device),
                        got, parts)

    return _per_group(mesh, xs, axis, body)


@_instrumented("gather")
def gather(mesh: Mesh, xs: Sequence[torch.Tensor], root: int = 0, *,
           axis: Optional[str] = None) -> List[torch.Tensor]:
    """``comms_t::gather``: rank ``root`` receives every block of its group
    along ``axis`` stacked on a new leading rank axis, every other shard
    zeros of that shape."""
    return _gather(mesh, xs, root, axis)


@_instrumented("gatherv")
def gatherv(mesh: Mesh, xs: Sequence[torch.Tensor], valid_n: Sequence[int], root: int = 0, *,
            axis: Optional[str] = None) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """``comms_t::gatherv``: each shard passes a padded block ``[cap, ...]``
    and its true row count (``valid_n``, one a local shard); ``root``
    receives ``(blocks [n, cap, ...], sizes [n] i32)``, every other shard
    zeros of those shapes."""
    expects(len(valid_n) == len(mesh.devices), "%d row counts for %d shards", len(valid_n),
            len(mesh.devices))
    sizes = [torch.as_tensor(v, dtype=torch.int32).to(d) for v, d in zip(valid_n, mesh.devices)]
    return list(zip(_gather(mesh, xs, root, axis), _gather(mesh, sizes, root, axis)))


@_instrumented("scatter")
def scatter(mesh: Mesh, xs: Sequence[torch.Tensor], root: int = 0, *,
            axis: Optional[str] = None) -> List[torch.Tensor]:
    """The inverse of :func:`gather`: every shard passes a ``[n, ...]``
    buffer and rank ``r`` receives block ``r`` of ``root``'s. It is a
    :func:`bcast` of ``root``'s buffer (counted too, as in the JAX
    package), each shard keeping its own block."""
    axis = resolve_axis(mesh, axis)
    full = bcast(mesh, xs, root=root, axis=axis)
    out = []
    for j, r in enumerate(mesh.local_ranks):
        with mesh.on(j):
            out.append(full[j][mesh.coord(r, axis)])
    return out


@_instrumented("device_sendrecv")
def device_sendrecv(mesh: Mesh, xs: Sequence[torch.Tensor],
                    partner_of: Sequence[Tuple[int, int]], *,
                    axis: Optional[str] = None) -> List[torch.Tensor]:
    """``comms_t::device_sendrecv``: each ``(a, b)`` pair exchanges blocks,
    ``a -> b`` and ``b -> a`` at once; a shard in no pair receives zeros."""
    perm = []
    for a, b in partner_of:
        perm += [(a, b), (b, a)]
    return _ppermute(mesh, xs, perm, axis=axis)


@_instrumented("multicast_sendrecv")
def multicast_sendrecv(mesh: Mesh, xs: Sequence[torch.Tensor],
                       pairs: Sequence[Tuple[int, int]], *,
                       axis: Optional[str] = None) -> List[torch.Tensor]:
    """``comms_t::device_multicast_sendrecv``: for each ``(src, dst)`` pair
    ``dst`` receives ``src``'s block; one source may feed several
    destinations (the last pair naming a destination wins), and a shard
    named by no pair receives zeros."""
    n = comm_size(mesh, axis)
    src_of = [-1] * n
    for s, d in pairs:
        src_of[d] = s
    moves = [(s, d) for d, s in enumerate(src_of) if s >= 0]

    def body(sub, parts):
        return _zeros_where_none(sub, sub._moved(parts, moves), parts)

    return _per_group(mesh, xs, axis, body)
