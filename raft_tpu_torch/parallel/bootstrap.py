"""Multi-process bootstrap (``raft_tpu.parallel.bootstrap`` counterpart), the
raft-dask ``Comms`` analog over ``torch.distributed``.

Reference: ``python/raft-dask/raft_dask/common/comms.py:39`` (``Comms``),
``:172`` (``init``): a Dask cluster broadcasts an NCCL uniqueId from the
root worker and every worker calls ``ncclCommInitRank``. Here the
coordinator address plays the uniqueId's role:
``torch.distributed.init_process_group`` rendezvous there (a TCP or file
store), and a process mesh over every process's devices
(:func:`global_mesh`) is the communicator. The lifecycle nouns are the JAX
package's: :func:`init_distributed`, :func:`shutdown`, :func:`global_mesh`,
:func:`local_mesh` and the comms self test (``comms/comms_test.hpp:117-155``)
runnable in every process.

Single-process degenerate path: :func:`init_distributed` with no address
and no launcher environment is a no-op returning False, and
:func:`global_mesh` is then this process's single-controller mesh, so all
downstream code is the same in one process and in many.

Usage (one process a card, or CPU processes under gloo)::

    from raft_tpu_torch.parallel import bootstrap
    bootstrap.init_distributed(coordinator_address="host0:1234",
                               num_processes=4, process_id=rank)
    mesh = bootstrap.global_mesh()          # every process's shards
    ok = bootstrap.run_comms_self_test(mesh)
"""
from __future__ import annotations

import dataclasses
import datetime
import os
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from raft_tpu_torch.core.errors import expects
from raft_tpu_torch.core.logging import info, warn
from raft_tpu_torch.parallel import comms as comms_mod
from raft_tpu_torch.parallel.process_comms import process_mesh
from raft_tpu_torch.robust import faults
from raft_tpu_torch.robust.retry import RetryPolicy, retry_call

_initialized = False

#: coordinator bootstrap races its peers: transient connection errors are
#: the norm, so retry them (raft-dask's Comms.init polls the same way)
DEFAULT_INIT_RETRY = RetryPolicy(
    max_attempts=4, base_delay_s=0.2, multiplier=2.0, max_delay_s=5.0,
    retryable=(ConnectionError, TimeoutError, OSError, RuntimeError),
)

#: how long a process waits for its peers at the rendezvous, retries included
DEFAULT_TIMEOUT_S = 300.0

_BACKENDS = ("nccl", "gloo")


def _init_method(coordinator_address: Optional[str]) -> Optional[str]:
    """The rendezvous URL: an address with a scheme (``tcp://``,
    ``file://``) as given, ``host:port`` over TCP, no address with the
    launcher's ``MASTER_ADDR`` and ``WORLD_SIZE`` set ``env://``, else None
    (one process: nothing to bootstrap)."""
    if coordinator_address is None:
        if os.environ.get("MASTER_ADDR") and os.environ.get("WORLD_SIZE"):
            return "env://"
        return None
    if "://" in coordinator_address:
        return coordinator_address
    return "tcp://" + coordinator_address


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    retry_policy: Optional[RetryPolicy] = DEFAULT_INIT_RETRY,
    backend: str = "nccl",
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> bool:
    """Initialise the process group (``Comms.init`` analog,
    ``raft_dask/common/comms.py:172``) through
    ``torch.distributed.init_process_group``.

    With no address and no launcher environment this is a no-op returning
    False (one process: its devices are already visible); otherwise every
    process passes the shared coordinator address (``"host:port"``, or a
    ``tcp://``/``file://`` URL), the world size and its rank, and returns
    True. Returns True when called again, and when the launcher already
    initialised the group. ``backend`` is ``"nccl"`` (one card a process;
    raises when no card is visible, never falls back to gloo) or
    ``"gloo"`` (CPU processes, or card tensors through host memory). Each
    attempt fires the ``bootstrap.init`` fault point; transient failures
    are retried per ``retry_policy`` (``None``: fail fast) within
    ``timeout_s`` in all, so a peer that never arrives raises instead of
    hanging."""
    global _initialized
    if _initialized:
        return True
    expects(backend in _BACKENDS, "init_distributed: backend %r (want one of %s)", backend,
            _BACKENDS)
    init_method = _init_method(coordinator_address)
    if init_method is not None and backend == "nccl":
        expects(torch.cuda.is_available() and dist.is_nccl_available(),
                "init_distributed: backend='nccl' needs a visible CUDA device and NCCL; "
                "CPU processes pass backend='gloo'")

    def _attempt() -> bool:
        global _initialized
        faults.fire("bootstrap.init", coordinator=coordinator_address)
        if dist.is_available() and dist.is_initialized():  # the launcher's group
            _initialized = True
            return True
        if init_method is None:
            # single-process degenerate path: nothing to bootstrap
            return False
        dist.init_process_group(
            backend, init_method=init_method,
            world_size=-1 if num_processes is None else int(num_processes),
            rank=-1 if process_id is None else int(process_id),
            timeout=datetime.timedelta(seconds=timeout_s))
        _initialized = True
        info("raft_tpu_torch.parallel.bootstrap: process %d/%d over %s", dist.get_rank(),
             dist.get_world_size(), backend)
        return True

    if retry_policy is None:
        return _attempt()
    deadline = timeout_s if retry_policy.deadline_s is None else min(retry_policy.deadline_s,
                                                                     timeout_s)
    policy = dataclasses.replace(retry_policy, deadline_s=deadline)
    return retry_call(_attempt, policy=policy, op="bootstrap.init")


def shutdown() -> None:
    """``Comms.destroy`` analog: ``destroy_process_group``."""
    global _initialized
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _initialized = False


def local_devices() -> List[torch.device]:
    """This process's devices: in a group, its card (``LOCAL_RANK``, else
    the rank, modulo the visible cards) under either backend, the CPU only
    under gloo with no card visible; with no group every visible card, or
    the CPU when there is none."""
    n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if dist.is_available() and dist.is_initialized():
        if n_cards:
            idx = int(os.environ.get("LOCAL_RANK", dist.get_rank())) % n_cards
            return [torch.device("cuda", idx)]
        expects(dist.get_backend() != "nccl", "an NCCL process needs a visible card")
        return [torch.device("cpu")]
    if n_cards:
        return [torch.device("cuda", i) for i in range(n_cards)]
    return [torch.device("cpu")]


def global_mesh(axis_names: Sequence[str] = (comms_mod.DEFAULT_AXIS,),
                shape: Optional[Sequence[int]] = None, devices: Optional[Sequence] = None):
    """Mesh over every process's shards, this process holding ``devices``
    (default :func:`local_devices`): a process mesh
    (:func:`raft_tpu_torch.parallel.process_comms.process_mesh`; every
    process calls this together) once the group is initialised, else this
    process's single-controller mesh. With a 2-D ``shape`` like
    ``(n_processes, shards_per_process)`` the first axis crosses processes
    and the second stays inside each, the sub-communicator split of
    ``core/comms.hpp:274``."""
    devices = list(devices) if devices is not None else local_devices()
    if dist.is_available() and dist.is_initialized():
        return process_mesh(devices, shape, axis_names)
    return comms_mod.make_mesh(devices, shape, axis_names)


def local_mesh(axis_names: Sequence[str] = (comms_mod.DEFAULT_AXIS,)):
    """Single-controller mesh over this process's devices only
    (:func:`local_devices`)."""
    return comms_mod.make_mesh(local_devices(), axis_names=axis_names)


def run_comms_self_test(mesh=None, axis: Optional[str] = None) -> bool:
    """Collective self test (``comms/comms_test.hpp:117-155``
    ``test_collective_allreduce`` analog), runnable in every process after
    bootstrap: each shard holds its rank along ``axis`` and runs allreduce,
    allgather, bcast, a ring ppermute and barrier over the mesh, with the
    JAX package's checks (``raft_tpu/parallel/bootstrap.py:132-169``).
    Returns True when every verb round-trips on every local shard; warns
    on failure."""
    if mesh is None:
        mesh = global_mesh()
    axis = comms_mod.resolve_axis(mesh, axis)
    n = mesh.shape[axis]
    ranks = comms_mod.comm_rank(mesh, axis=axis)
    xs = [r.to(torch.float32).reshape(1) for r in ranks]
    total = comms_mod.allreduce(mesh, [x.sum() for x in xs], op="sum", axis=axis)
    gathered = comms_mod.allgather(mesh, xs, axis=axis)
    rooted = comms_mod.bcast(mesh, xs, root=0, axis=axis)
    shifted = comms_mod.ppermute(mesh, xs, [(i, (i + 1) % n) for i in range(n)], axis=axis)
    counts = comms_mod.barrier(mesh, axis=axis)
    expect_all = torch.arange(n, dtype=torch.float32)
    ok = True
    for j, rank in enumerate(ranks):
        r = int(rank)
        ok = ok and float(total[j]) == n * (n - 1) // 2
        ok = ok and torch.equal(gathered[j].reshape(-1).cpu(), expect_all)
        ok = ok and float(rooted[j][0]) == 0.0
        ok = ok and float(shifted[j][0]) == float((r - 1) % n)
        ok = ok and int(counts[j]) == n
    if not ok:
        warn("comms self-test FAILED on process %d",
             dist.get_rank() if dist.is_available() and dist.is_initialized() else 0)
    return bool(ok)
