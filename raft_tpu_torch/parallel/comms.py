"""Mesh and comms verb set (``raft_tpu.parallel.comms`` counterpart).

The JAX package runs a sharded program as one ``shard_map`` body over a
``jax.sharding.Mesh``: each collective is a ``lax`` op inside the body.
The port keeps that single-controller model with a :class:`Mesh` of torch
devices: a ``shard_map`` body becomes phases, a per-shard loop (the rank
is the loop index, shard ``r``'s work runs inside ``mesh.on(r)``) and then
a verb over the per-shard tensor lists.

* A mesh is a list of devices along one named axis. On a card every shard
  owns a CUDA stream; shards may repeat a device (``["cuda:0"] * 4``:
  four virtual shards on one card, as the JAX tests force eight CPU
  devices) but are never folded onto one quietly: :func:`make_mesh` takes
  every visible card, or exactly the list it is given.
* A peer copy is ``copy_(..., non_blocking=True)`` on the sender's stream,
  followed by an event that the receiver's stream waits on. Between
  virtual shards of one card it is a copy inside device memory.
* Verbs take one tensor per shard, each ready on its shard's stream, and
  return one per shard, each ready on its shard's stream. :meth:`Mesh.fork`
  makes the shard streams wait for the caller's stream and
  :meth:`Mesh.join` the caller's stream for the shard streams; the public
  sharded entry points call both.

CPU meshes (``["cpu"] * n``) run the same code with plain copies; the
tests use them. Multi-host bootstrap (``parallel/bootstrap.py`` over
``torch.distributed``) is not ported.
"""
from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence, Tuple

import torch

from raft_tpu_torch.core.errors import expects

DEFAULT_AXIS = "data"

_REDUCE_OPS = ("sum", "max", "min", "prod")


class Mesh:
    """A one-axis mesh of torch devices with one CUDA stream per shard on a
    card (``None`` on the CPU)."""

    def __init__(self, devices: Sequence[torch.device], axis_names: Tuple[str, ...]):
        self.devices = tuple(devices)
        self.axis_names = tuple(axis_names)
        self.streams = tuple(torch.cuda.Stream(device=d) if d.type == "cuda" else None
                             for d in self.devices)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> dict:
        """``{axis: n_shards}``, as ``jax.sharding.Mesh.shape``."""
        return {self.axis_names[0]: self.size}

    @property
    def is_cuda(self) -> bool:
        return self.devices[0].type == "cuda"

    @property
    def virtual(self) -> bool:
        """Whether two shards share a device."""
        return len(set(self.devices)) < self.size

    def key(self) -> tuple:
        """The mesh's layout as a hashable key (for per-mesh caches)."""
        return (tuple(str(d) for d in self.devices), self.axis_names)

    @contextlib.contextmanager
    def on(self, r: int):
        """Run shard ``r``'s work: its device and stream become current."""
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

    def __repr__(self) -> str:
        kind = "virtual shards" if self.virtual else "shards"
        return (f"Mesh({self.size} {kind} along {self.axis_names[0]!r}: "
                f"{', '.join(str(d) for d in self.devices)})")


def make_mesh(devices: Optional[Sequence] = None,
              axis_names: Sequence[str] = (DEFAULT_AXIS,)) -> Mesh:
    """A one-axis mesh. ``devices=None`` takes every visible CUDA device
    (raises without one); otherwise exactly the given list, in order: a
    device may repeat (virtual shards, e.g. ``["cuda:0"] * 4`` or
    ``["cpu"] * 4``), and a CUDA device that is not there raises."""
    axis_names = tuple(axis_names)
    expects(len(axis_names) == 1, "make_mesh: only one-axis meshes are ported, got axes %s",
            axis_names)
    n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if devices is None:
        expects(n_cards > 0, "make_mesh: no CUDA device is visible; pass devices= "
                "(e.g. ['cpu'] * 4 for a CPU mesh)")
        devices = [torch.device("cuda", i) for i in range(n_cards)]
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
    return Mesh(devs, axis_names)


def comm_size(mesh: Mesh, axis: str = DEFAULT_AXIS) -> int:
    """Number of shards along ``axis`` (``comms_t::get_size``)."""
    expects(axis in mesh.axis_names, "axis %r not in mesh axes %s", axis, mesh.axis_names)
    return mesh.size


# -- placement ------------------------------------------------------------------


def replicated(mesh: Mesh, x: torch.Tensor) -> List[torch.Tensor]:
    """One copy of ``x`` per shard (the same tensor for shards on its
    device: read-only)."""
    return [x if x.device == d else x.to(d) for d in mesh.devices]


def row_sharded(mesh: Mesh, x: torch.Tensor) -> List[torch.Tensor]:
    """``x`` split into ``n`` equal row blocks, block ``r`` on shard ``r``
    (a view for a shard on ``x``'s device)."""
    n = mesh.size
    expects(x.shape[0] % n == 0, "rows %d not divisible by %d shards", x.shape[0], n)
    per = x.shape[0] // n
    return [x[r * per:(r + 1) * per] if x.device == d else x[r * per:(r + 1) * per].to(d)
            for r, d in enumerate(mesh.devices)]


# -- peer copies ----------------------------------------------------------------


def peer_copy(mesh: Mesh, x: torch.Tensor, src: int, dst: int,
              out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Copy shard ``src``'s ``x`` (ready on its stream) to shard ``dst``:
    ``copy_(..., non_blocking=True)`` on the sender's stream, then ``dst``'s
    stream waits on an event recorded after it. Writes into ``out`` (a
    buffer of ``dst``'s) when given, else into a new tensor. The result is
    ready on ``dst``'s stream."""
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
    expects(len(xs) == mesh.size, "%d per-shard tensors for %d shards", len(xs), mesh.size)
    for r, (x, d) in enumerate(zip(xs, mesh.devices)):
        expects(x.device == d, "shard %d's tensor is on %s, the shard on %s", r, x.device, d)


def _gathered(mesh: Mesh, xs: Sequence[torch.Tensor], r: int) -> List[torch.Tensor]:
    """Every shard's block as seen on shard ``r`` (its own without a copy)."""
    return [xs[s] if s == r else peer_copy(mesh, xs[s], s, r) for s in range(mesh.size)]


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


# -- verbs (one tensor per shard in, one per shard out) ---------------------------


def allgather(mesh: Mesh, xs: Sequence[torch.Tensor], tiled: bool = False) -> List[torch.Tensor]:
    """``comms_t::allgather``: shard ``r`` receives every shard's block,
    stacked on a new leading rank axis (``tiled=True``: concatenated along
    axis 0)."""
    _check_parts(mesh, xs)
    mesh.fork()
    out = []
    for r in range(mesh.size):
        parts = _gathered(mesh, xs, r)
        with mesh.on(r):
            out.append(torch.cat(parts, dim=0) if tiled else torch.stack(parts, dim=0))
    mesh.join()
    return out


def allreduce(mesh: Mesh, xs: Sequence[torch.Tensor], op: str = "sum") -> List[torch.Tensor]:
    """``comms_t::allreduce``: every shard receives the elementwise
    reduction (added in rank order)."""
    expects(op in _REDUCE_OPS, "unknown reduce op %s", op)
    _check_parts(mesh, xs)
    mesh.fork()
    out = []
    for r in range(mesh.size):
        parts = _gathered(mesh, xs, r)
        with mesh.on(r):
            out.append(_reduce(parts, op))
    mesh.join()
    return out


def reducescatter(mesh: Mesh, xs: Sequence[torch.Tensor], op: str = "sum") -> List[torch.Tensor]:
    """``comms_t::reducescatter``: elementwise reduce across shards, shard
    ``r`` keeps the ``r``-th equal chunk of axis 0."""
    expects(op == "sum", "reducescatter supports sum")
    _check_parts(mesh, xs)
    n = mesh.size
    expects(xs[0].shape[0] % n == 0, "axis 0 (%d) not divisible by %d shards", xs[0].shape[0], n)
    c = xs[0].shape[0] // n
    mesh.fork()
    out = []
    for r in range(n):
        parts = [xs[s][r * c:(r + 1) * c] if s == r else
                 peer_copy(mesh, xs[s][r * c:(r + 1) * c], s, r) for s in range(n)]
        with mesh.on(r):
            out.append(_reduce(parts, op))
    mesh.join()
    return out


def bcast(mesh: Mesh, xs: Sequence[torch.Tensor], root: int = 0) -> List[torch.Tensor]:
    """``comms_t::bcast``: every shard receives ``root``'s block."""
    _check_parts(mesh, xs)
    mesh.fork()
    out = [xs[root] if r == root else peer_copy(mesh, xs[root], root, r)
           for r in range(mesh.size)]
    mesh.join()
    return out


def reduce(mesh: Mesh, xs: Sequence[torch.Tensor], root: int = 0,
           op: str = "sum") -> List[torch.Tensor]:
    """``comms_t::reduce``: the reduction on ``root``, zeros elsewhere."""
    full = allreduce(mesh, xs, op=op)
    return [f if r == root else torch.zeros_like(f) for r, f in enumerate(full)]


def ppermute(mesh: Mesh, xs: Sequence[torch.Tensor],
             perm: Sequence[Tuple[int, int]]) -> List[torch.Tensor]:
    """Point-to-point permutation (``lax.ppermute``): for each ``(src,
    dst)`` pair shard ``dst`` receives ``src``'s block; a shard named by no
    pair receives zeros."""
    _check_parts(mesh, xs)
    dsts = [d for _, d in perm]
    expects(len(set(dsts)) == len(dsts), "ppermute: a shard receives twice in %s", perm)
    mesh.fork()
    out: List[Optional[torch.Tensor]] = [None] * mesh.size
    for s, d in perm:
        out[d] = xs[s] if s == d else peer_copy(mesh, xs[s], s, d)
    for r in range(mesh.size):
        if out[r] is None:
            with mesh.on(r):
                out[r] = torch.zeros_like(xs[r])
    mesh.join()
    return out


def send_recv(mesh: Mesh, xs: Sequence[torch.Tensor], src: int, dst: int) -> List[torch.Tensor]:
    """One device p2p transfer (``comms_t::device_send``/``device_recv``):
    ``dst`` receives ``src``'s block, every other shard zeros."""
    return ppermute(mesh, xs, [(src, dst)])


def barrier(mesh: Mesh) -> List[torch.Tensor]:
    """``comms_t::barrier``: an allreduce of ones, so every shard stream
    waits for every other; returns the shard count on each shard."""
    ones = []
    for r in range(mesh.size):
        with mesh.on(r):
            ones.append(torch.ones((), dtype=torch.int32, device=mesh.devices[r]))
    return allreduce(mesh, ones)
