"""The process backend of the comms verbs: a mesh that spans the processes
of a ``torch.distributed`` group (the JAX package's global mesh over every
host's devices after ``jax.distributed.initialize``).

:func:`process_mesh` (called by every process together, as
:func:`raft_tpu_torch.parallel.bootstrap.global_mesh` does) lays
``world * m`` shards row-major over the mesh's shape, process ``p`` holding
the ``m`` shards of global ranks ``p m .. p m + m - 1`` on its own devices:
its card under NCCL (``m = 1``), or one or more CPU or card shards under
gloo. Each group of shards along each axis gets a process subgroup, made
once per mesh by ``dist.new_group`` in the same order in every process (one
a distinct set of processes). The verbs of :mod:`raft_tpu_torch.parallel.comms`
run unchanged over it, through the three transports this mesh overrides:

* ``_gathered`` (allgather, allreduce, reducescatter, gather, gatherv,
  barrier) is one ``dist.all_gather`` of every process's local blocks,
  padded to the most any process holds in the group; each shard then
  reduces in rank order as the single-controller verbs do, so a float
  allreduce gives their bits (never NCCL's unordered sum). That costs wire
  bytes: a reduce-scatter or a reduction moves every whole block;
* ``_bcast`` (bcast, scatter) is one ``dist.broadcast`` from the root's
  process;
* ``_moved`` (ppermute, send_recv, device_sendrecv, multicast_sendrecv and
  the ring's hops) is one ``dist.batch_isend_irecv`` of point-to-point
  sends and receives, tagged by ``(src, dst)``; a pair inside one process
  is a peer copy.

Blocks travel as their bytes (``uint8`` views), so every dtype moves and
every bit arrives. The group's backend picks the placement, never a
failure: a gloo group moves CPU tensors, and card tensors through an
explicit pinned host copy on the shard's stream (the stream is synchronised
before the send; the copy back to the card runs on the shard's stream); an
NCCL group moves card tensors directly and raises on CPU ones.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from raft_tpu_torch.core.errors import expects
from raft_tpu_torch.parallel import comms

_CPU = torch.device("cpu")


def _bytes_of(x: torch.Tensor) -> torch.Tensor:
    """``x``'s bytes as a flat ``uint8`` tensor (a view when contiguous)."""
    return x.contiguous().reshape(-1).view(torch.uint8)


class ProcessMesh(comms.Mesh):
    """A mesh over the processes of a ``torch.distributed`` group (see the
    module docstring). ``devices``, ``streams`` and the verbs' per-shard
    lists cover this process's shards only, whose global ranks are
    ``local_ranks``; ``owners[r]`` is the process that holds shard ``r``.
    A one-axis view (:meth:`along`) carries the process subgroup ``pg`` of
    its shards."""

    is_process = True

    def __init__(self, devices, axis_names, dims, *, local_ranks, owners, groups, backend,
                 streams=None, pg=None):
        super().__init__(devices, axis_names, dims, streams=streams)
        self.local_ranks = tuple(local_ranks)
        self.owners = tuple(owners)
        self.groups = groups
        self.backend = backend
        self.process = dist.get_rank()
        self.pg = pg if pg is not None else (
            groups[tuple(sorted(set(self.owners)))] if len(self.axis_names) == 1 else None)

    def key(self) -> tuple:
        return ("process", self.process, tuple(str(d) for d in self.devices), self.axis_names,
                self.dims, self.local_ranks)

    def __repr__(self) -> str:
        return (f"ProcessMesh({self.size} shards along {comms._axes_repr(self)} over "
                f"{len(set(self.owners))} {self.backend} processes; process {self.process} "
                f"holds ranks {list(self.local_ranks)} on "
                f"{', '.join(str(d) for d in self.devices)})")

    def _make_groups(self, axis: str):
        out = []
        slot_of = {r: j for j, r in enumerate(self.local_ranks)}
        for g in comms.axis_groups(self.dims, self.axis_names.index(axis)):
            mine = [(pos, slot_of[r]) for pos, r in enumerate(g) if r in slot_of]
            if not mine:
                continue
            owners = tuple(self.owners[r] for r in g)
            sub = ProcessMesh([self.devices[j] for _, j in mine], (axis,), (len(g),),
                              local_ranks=[pos for pos, _ in mine], owners=owners,
                              groups=self.groups, backend=self.backend,
                              streams=[self.streams[j] for _, j in mine])
            out.append((sub, tuple(j for _, j in mine)))
        return out

    # -- the wire ---------------------------------------------------------------------

    def _all_local(self) -> bool:
        return all(o == self.process for o in self.owners)

    def _wire_device(self, x: torch.Tensor) -> torch.device:
        if self.backend == "nccl":
            expects(x.device.type == "cuda", "an NCCL group moves card tensors; a shard's "
                    "tensor is on %s", x.device)
            return x.device
        return _CPU

    def _staged(self, x: torch.Tensor) -> bool:
        """Whether ``x`` crosses a pinned host buffer (gloo, card tensor)."""
        return self.backend != "nccl" and x.device.type == "cuda"

    def _empty_wire(self, shape, like: torch.Tensor) -> torch.Tensor:
        dev = self._wire_device(like)
        return torch.empty(shape, dtype=torch.uint8, device=dev,
                           pin_memory=self._staged(like))

    def _pack(self, items: Sequence[Tuple[int, torch.Tensor]], rows: int) -> torch.Tensor:
        """Local shards' blocks (``(slot, tensor)``) as the rows of one
        ``[rows, nbytes]`` wire buffer, ready to send."""
        like = items[0][1]
        nb = like.numel() * like.element_size()
        buf = self._empty_wire((rows, nb), like)
        for i, (j, x) in enumerate(items):
            expects(x.shape == like.shape and x.dtype == like.dtype,
                    "process verbs: local blocks differ: %s %s vs %s %s", tuple(x.shape), x.dtype,
                    tuple(like.shape), like.dtype)
            with self.on(j):
                buf[i].copy_(_bytes_of(x), non_blocking=True)
        if self._staged(like):
            for j, _ in items:
                self.streams[j].synchronize()
        return buf

    def _unpack(self, j: int, wire: torch.Tensor, like: torch.Tensor,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """A wire buffer's bytes as a ``like``-shaped tensor on local shard
        ``j``'s device, ready on its stream (written into ``out`` when given)."""
        with self.on(j):
            if wire.device != self.devices[j]:
                wire = wire.to(self.devices[j], non_blocking=True)
            v = wire.view(like.dtype).reshape(like.shape)
            return v if out is None else out.copy_(v)

    def _collective(self, fn):
        """Run a collective (on shard 0's stream under NCCL, where the
        process holds one shard)."""
        if self.backend == "nccl":
            with self.on(0):
                return fn()
        return fn()

    # -- agreement between the processes -------------------------------------------

    def agreed(self, flags: Sequence[bool]) -> Tuple[bool, ...]:
        """Each flag ANDed over every process: one ``dist.all_gather`` of
        every process's flags over the default group."""
        t = torch.tensor([bool(f) for f in flags], dtype=torch.uint8,
                         device=self.devices[0] if self.backend == "nccl" else _CPU)
        out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
        self._collective(lambda: dist.all_gather(out, t))
        return tuple(bool(v) for v in torch.stack(out).min(dim=0).values.tolist())

    def from_first(self, x: torch.Tensor) -> torch.Tensor:
        """The process of global rank 0's ``x``: one ``dist.broadcast`` of
        its bytes over the default group (every process passes a tensor of
        the same shape and dtype), on ``x``'s device."""
        owner = self.owners[0]
        self.fork()
        buf = (self._pack([(0, x)], 1) if owner == self.process else
               self._empty_wire((1, x.numel() * x.element_size()), x))
        self._collective(lambda: dist.broadcast(buf, src=owner))
        got = self._unpack(0, buf[0], x)
        self.join([got])
        return got

    # -- the three transports ----------------------------------------------------------

    def _gathered(self, xs: Sequence[torch.Tensor]) -> List[List[torch.Tensor]]:
        if self._all_local():
            return super()._gathered(xs)
        procs = sorted(set(self.owners))
        rows = max(self.owners.count(p) for p in procs)
        send = self._pack(list(enumerate(xs)), rows)
        recv = self._empty_wire((len(procs), rows) + tuple(send.shape[1:]), xs[0])
        self._collective(lambda: dist.all_gather(list(recv.unbind(0)), send, group=self.pg))
        where, seen = [], {p: 0 for p in procs}
        for o in self.owners:  # rank b's row: its process, then its order there
            where.append((procs.index(o), seen[o]))
            seen[o] += 1
        out = []
        for j, x in enumerate(xs):
            with self.on(j):
                full = recv if recv.device == self.devices[j] else recv.to(self.devices[j],
                                                                            non_blocking=True)
                out.append([full[p, i].view(x.dtype).reshape(x.shape) for p, i in where])
        return out

    def _bcast(self, xs: Sequence[torch.Tensor], root: int) -> List[torch.Tensor]:
        if self._all_local():
            return super()._bcast(xs, root)
        owner = self.owners[root]
        if owner == self.process:
            j = self.local_ranks.index(root)
            buf = self._pack([(j, xs[j])], 1)
        else:
            buf = self._empty_wire((1, xs[0].numel() * xs[0].element_size()), xs[0])
        self._collective(lambda: dist.broadcast(buf, src=owner, group=self.pg))
        return [self._unpack(j, buf[0], x) for j, x in enumerate(xs)]

    def _moved(self, xs: Sequence[torch.Tensor], pairs: Sequence[Tuple[int, int]],
               outs: Optional[Sequence[torch.Tensor]] = None) -> List[Optional[torch.Tensor]]:
        slot_of = {r: j for j, r in enumerate(self.local_ranks)}
        got: List[Optional[torch.Tensor]] = [None] * len(xs)
        ops, pending = [], []
        for s, d in pairs:
            tag = s * self.size + d
            if s in slot_of and d in slot_of:
                js, jd = slot_of[s], slot_of[d]
                out = None if outs is None else outs[jd]
                got[jd] = (xs[js] if js == jd and out is None else
                           comms.peer_copy(self, xs[js], js, jd, out=out))
            elif s in slot_of:
                js = slot_of[s]
                buf = self._pack([(js, xs[js])], 1)[0]
                ops.append(dist.P2POp(dist.isend, buf, self.owners[d], group=self.pg, tag=tag))
            elif d in slot_of:
                jd = slot_of[d]
                like = xs[jd] if outs is None else outs[jd]
                buf = self._empty_wire((like.numel() * like.element_size(),), like)
                ops.append(dist.P2POp(dist.irecv, buf, self.owners[s], group=self.pg, tag=tag))
                pending.append((jd, buf, like))
        if ops:
            def run():
                for w in dist.batch_isend_irecv(ops):
                    w.wait()

            self._collective(run)
        for jd, buf, like in pending:
            got[jd] = self._unpack(jd, buf, like, None if outs is None else outs[jd])
        return got


def _all_gather_ints(value: int, device: torch.device) -> List[int]:
    """``value`` from every process of the default group, in rank order."""
    t = torch.tensor([value], dtype=torch.int64, device=device)
    out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(out, t)
    return [int(o.item()) for o in out]


def process_mesh(devices: Sequence, shape: Optional[Sequence[int]] = None,
                 axis_names: Sequence[str] = (comms.DEFAULT_AXIS,)) -> ProcessMesh:
    """A mesh over every process of the initialised default group, this
    process holding ``devices`` (every process as many). Every process
    calls it together, with the same ``shape`` and ``axis_names``: it makes
    the axes' subgroups (a collective) and checks the shard counts. Under
    NCCL a process holds one card, which becomes its current device."""
    expects(dist.is_available() and dist.is_initialized(),
            "process_mesh: no process group; call bootstrap.init_distributed first")
    axis_names = tuple(axis_names)
    backend = dist.get_backend()
    devs = comms.check_devices(devices)
    if backend == "nccl":
        expects(len(devs) == 1 and devs[0].type == "cuda",
                "process_mesh: an NCCL process holds one card, got %s", devs)
        torch.cuda.set_device(devs[0])
    m = len(devs)
    counts = _all_gather_ints(m, devs[0] if backend == "nccl" else _CPU)
    expects(all(c == m for c in counts), "process_mesh: the processes hold %s shards; each must "
            "hold as many", counts)
    size = len(counts) * m
    dims = comms.mesh_dims(size, shape, axis_names)
    owners = tuple(r // m for r in range(size))
    groups: Dict[Tuple[int, ...], object] = {}
    for ai in range(len(axis_names)):
        for g in comms.axis_groups(dims, ai):
            procs = tuple(sorted({owners[r] for r in g}))
            if procs not in groups:
                groups[procs] = dist.new_group(list(procs))
    me = dist.get_rank()
    if backend == "nccl":
        # NCCL makes a subgroup's communicator at its first collective, and a
        # first point-to-point call needs every member: one all-reduce each
        # (every process in the groups' order, so none waits on another)
        for procs, group in groups.items():
            if me in procs:
                dist.all_reduce(torch.zeros(1, device=devs[0]), group=group)
    return ProcessMesh(devs, axis_names, dims, local_ranks=range(me * m, (me + 1) * m),
                       owners=owners, groups=groups, backend=backend)
