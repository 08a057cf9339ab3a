"""Distributed layer (``raft_tpu.parallel`` counterpart): meshes of one or
more named axes, single-controller (one process holds every shard) or
spanning the processes of a ``torch.distributed`` group
(:mod:`~raft_tpu_torch.parallel.bootstrap`,
:mod:`~raft_tpu_torch.parallel.process_comms`), with the comms verb set over
per-shard tensor lists;
sharded search, lists-sharded (IVF-Flat and IVF-PQ, whose per-shard
candidates merge through the ring top-k of
:mod:`raft_tpu_torch.ops.ring_topk` or the gather merge), query-sharded
(IVF-PQ and CAGRA over a replicated index) and row-sharded exact kNN; and
the distributed IVF-PQ build (full or communication-avoiding accumulator
exchange)."""
from raft_tpu_torch.parallel import bootstrap, process_comms, wire_model
from raft_tpu_torch.parallel.comms import (
    DEFAULT_AXIS,
    Mesh,
    allgather,
    allreduce,
    barrier,
    bcast,
    comm_rank,
    comm_size,
    comm_split,
    device_sendrecv,
    gather,
    gatherv,
    init_comms,
    make_mesh,
    multicast_sendrecv,
    peer_copy,
    ppermute,
    reduce,
    reducescatter,
    replicated,
    row_sharded,
    scatter,
    send_recv,
)
from raft_tpu_torch.parallel.sharded_ann import (
    sharded_cagra_search,
    sharded_ivf_flat_search,
    sharded_ivf_pq_build,
    sharded_ivf_pq_lists_search,
    sharded_ivf_pq_search,
)
from raft_tpu_torch.parallel.sharded_knn import sharded_knn

__all__ = [
    "bootstrap",
    "process_comms",
    "DEFAULT_AXIS",
    "Mesh",
    "allgather",
    "allreduce",
    "barrier",
    "bcast",
    "comm_rank",
    "comm_size",
    "comm_split",
    "device_sendrecv",
    "gather",
    "gatherv",
    "init_comms",
    "make_mesh",
    "multicast_sendrecv",
    "peer_copy",
    "ppermute",
    "reduce",
    "reducescatter",
    "replicated",
    "row_sharded",
    "scatter",
    "send_recv",
    "sharded_cagra_search",
    "sharded_ivf_flat_search",
    "sharded_ivf_pq_build",
    "sharded_ivf_pq_lists_search",
    "sharded_ivf_pq_search",
    "sharded_knn",
    "wire_model",
]
