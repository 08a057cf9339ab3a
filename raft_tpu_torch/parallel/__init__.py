"""Distributed layer (``raft_tpu.parallel`` counterpart): a single-controller
mesh of torch devices with the comms verb set over per-shard tensor lists,
and sharded search (lists-sharded IVF-Flat and IVF-PQ, row-sharded exact
kNN) whose per-shard candidates merge through the ring top-k
(:mod:`raft_tpu_torch.ops.ring_topk`) or the gather merge."""
from raft_tpu_torch.parallel import wire_model
from raft_tpu_torch.parallel.comms import (
    DEFAULT_AXIS,
    Mesh,
    allgather,
    allreduce,
    barrier,
    bcast,
    comm_size,
    make_mesh,
    peer_copy,
    ppermute,
    reduce,
    reducescatter,
    replicated,
    row_sharded,
    send_recv,
)
from raft_tpu_torch.parallel.sharded_ann import sharded_ivf_flat_search, sharded_ivf_pq_lists_search
from raft_tpu_torch.parallel.sharded_knn import sharded_knn

__all__ = [
    "DEFAULT_AXIS",
    "Mesh",
    "allgather",
    "allreduce",
    "barrier",
    "bcast",
    "comm_size",
    "make_mesh",
    "peer_copy",
    "ppermute",
    "reduce",
    "reducescatter",
    "replicated",
    "row_sharded",
    "send_recv",
    "sharded_ivf_flat_search",
    "sharded_ivf_pq_lists_search",
    "sharded_knn",
    "wire_model",
]
