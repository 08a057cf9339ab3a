"""The fabric-byte model of the sharded paths (``raft_tpu.parallel.wire_model``
counterpart, pure Python).

Every value is the JAX package's: the per-verb factors of the collectives
(:data:`WIRE_FACTORS`), the search merge's per-query model
(:func:`wire_bytes_per_query`: 12 B a candidate on a reduce-scatter hop,
8 B on an all-gather hop) and the distributed builds' per-iteration
models. The ring top-k (:mod:`raft_tpu_torch.ops.ring_topk`) ships exactly
those lanes, so the bytes it counts per hop can be read beside this model.
"""
from __future__ import annotations

from raft_tpu_torch.core.errors import expects

#: Per-verb wire models: bytes a rank moves for an input payload of ``p``
#: bytes on an ``n``-rank axis under ring schedules. The allgather family
#: receives every other rank's block ((n-1)·p); ring allreduce is
#: reduce-scatter + all-gather (2p(n-1)/n); reducescatter keeps only the
#: scatter half. Permutation verbs ship one block per rank whatever n is.
WIRE_FACTORS = {
    "allreduce": lambda p, n: 2.0 * p * (n - 1) / n,
    "reduce": lambda p, n: 2.0 * p * (n - 1) / n,
    "barrier": lambda p, n: 2.0 * p * (n - 1) / n,
    "reducescatter": lambda p, n: p * (n - 1) / n,
    "allgather": lambda p, n: p * (n - 1),
    "bcast": lambda p, n: p * (n - 1),
    "gather": lambda p, n: p * (n - 1),
    "gatherv": lambda p, n: p * (n - 1),
    "scatter": lambda p, n: p * (n - 1),
    "multicast_sendrecv": lambda p, n: p * (n - 1),
    "ppermute": lambda p, n: p,
    "send_recv": lambda p, n: p,
    "device_sendrecv": lambda p, n: p,
}


def wire_bytes(verb: str, payload_bytes: float, n: int) -> float:
    """Bytes one rank moves for a ``payload_bytes`` input to ``verb`` on an
    ``n``-rank axis (0 for a single rank; an unknown verb moves its
    payload once)."""
    if n <= 1:
        return 0.0
    return float(WIRE_FACTORS.get(verb, lambda p, _: p)(float(payload_bytes), int(n)))


# -- search-merge per-query model (ring top-k) --------------------------------

#: Bytes per candidate: reduce-scatter hops carry (f32 val, i32 id, i32 pos);
#: all-gather hops carry (val, id) only.
RS_ENTRY_BYTES = 12
AG_ENTRY_BYTES = 8


def wire_bytes_per_query(n_shards: int, k: int, mode: str = "ring") -> float:
    """Per-rank bytes received per query for one merge. ``"gather"``:
    ``n-1`` foreign ``[k]`` blocks of (f32, i32). ``"ring"`` and
    ``"fused_ring"``: ``n-1`` reduce-scatter hops of one ``nq/n``-query
    block at :data:`RS_ENTRY_BYTES` a candidate plus ``n-1`` all-gather
    hops at :data:`AG_ENTRY_BYTES`, over all ``nq`` queries (only
    ``k``-wide winners enter either ring)."""
    n = int(n_shards)
    if n <= 1:
        return 0.0
    if mode == "gather":
        return float((n - 1) * k * AG_ENTRY_BYTES)
    return float((n - 1) * k * (RS_ENTRY_BYTES + AG_ENTRY_BYTES)) / n


# -- distributed-build per-iteration models ------------------------------------


def ca_exchange_cap(n_rows: int, ca_cap=None) -> int:
    """Exchanged-row budget of the communication-avoiding accumulator
    exchange: a quarter of the rows (at least 8) by default."""
    if ca_cap is None:
        ca_cap = min(n_rows, max(8, n_rows // 4))
    cap = int(ca_cap)
    expects(1 <= cap <= n_rows, "ca_cap %d outside [1, %d]", cap, n_rows)
    return cap


def lloyd_wire_bytes_per_iter(n_lists: int, d: int, n_shards: int,
                              comm_mode: str = "full", ca_cap=None) -> float:
    """Wire bytes one rank moves per distributed Lloyd iteration: ``full``
    is the ``[n_lists, d+1]`` f32 allreduce; ``ca`` a ``[n_lists]``
    changed-count allreduce plus a ``[cap, d+1]`` selected-rows allreduce."""
    if comm_mode == "full":
        return wire_bytes("allreduce", 4.0 * n_lists * (d + 1), n_shards)
    cap = ca_exchange_cap(n_lists, ca_cap)
    return (wire_bytes("allreduce", 4.0 * n_lists, n_shards)
            + wire_bytes("allreduce", 4.0 * cap * (d + 1), n_shards))


def codebook_wire_bytes_per_iter(pq_dim: int, ksub: int, pq_len: int, n_shards: int,
                                 comm_mode: str = "full", ca_cap=None) -> float:
    """:func:`lloyd_wire_bytes_per_iter` over the flattened
    ``[pq_dim·ksub, pq_len+1]`` codebook accumulator rows."""
    return lloyd_wire_bytes_per_iter(pq_dim * ksub, pq_len, n_shards,
                                     comm_mode=comm_mode, ca_cap=ca_cap)
