"""Segmented mutable index: main segment + delta segment + tombstones
(``raft_tpu.mutable.segments`` counterpart).

Every index type of the port is built once and never changed in place.
This module recasts the Faiss add-with-ids/remove story for that
constraint the LSM way — an index becomes a generation-numbered
**segment list**:

* the **main segment** is one ordinary index (brute-force / IVF-Flat /
  IVF-PQ / CAGRA) over the rows that existed at the last compaction,
  plus a positional tombstone bitset
  (:class:`raft_tpu_torch.core.bitset.Bitset`) passed *in-scan* as the
  index's ``prefilter`` — deletes mask candidates inside the scan,
  before the k-way merge, so a dead row can never shadow a live one;
* the **delta segment** is a small append-only brute-force segment
  holding rows inserted since that compaction (served exactly), with its
  own live-mask; its row count is padded to a power of two, and its
  device copy is made once per mutation version;
* a **global id space** (int64, user-supplied or auto-assigned) maps
  onto (segment, position) so results from both segments merge into one
  best-first list.

Durability: every mutation is appended to the generation's write-ahead
log (:mod:`raft_tpu_torch.mutable.wal`) — durable *then* visible — and
:func:`raft_tpu_torch.mutable.compact.compact` folds delta + tombstones
into a rebuilt main segment published via an atomic manifest swap
(:mod:`raft_tpu_torch.mutable.manifest`). :meth:`MutableIndex.snapshot`
returns an immutable, internally consistent :class:`Snapshot` that the
serving engine dispatches against, so queries in flight never observe a
half-applied mutation. A directory written by the JAX package opens here
and the reverse: the manifest, rows sidecar, main-index snapshot and WAL
are the same bytes.

The delta scan's fast path is kernel B1 (``ops.ivf_scan.fused_list_topk``,
the probed-list scan): the padded delta is cut into banks of 1,024 rows,
each bank one list that every query tile probes, and one launch scans
them all. ``delta_mode="auto"`` takes it only on a CUDA index; a kernel
that fails raises :class:`~raft_tpu_torch.core.errors.KernelFailure`
(the JAX package falls back to the exact scan there; the port does not).
"""
from __future__ import annotations

import dataclasses
import io
import os
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch import obs
from raft_tpu_torch.core import serialize as ser
from raft_tpu_torch.core.bitset import Bitset
from raft_tpu_torch.core.errors import expects
from raft_tpu_torch.core.resources import Resources, ensure_resources
from raft_tpu_torch.mutable import manifest as man
from raft_tpu_torch.mutable.wal import WalRecord, WriteAheadLog
from raft_tpu_torch.ops.distance import DistanceType, is_min_close, resolve_metric
from raft_tpu_torch.utils import lockcheck

ALGOS = ("brute_force", "ivf_flat", "ivf_pq", "cagra")

#: delta-scan routing knobs accepted by ``delta_mode``
DELTA_MODES = ("auto", "exact", "fused")

#: Rows of one bank of the padded delta: one list of the B1 scan. The
#: window (banks of 1,024 rows, at most 32 banks, k <= 128, query tiles of
#: 128) is the JAX package's, so ``auto`` decides the same way in both; the
#: port's B1 is exact at any width, so one launch scans every bank.
_DELTA_FUSED_MAX_ROWS = 1024
_DELTA_FUSED_QT = 128
#: fused-route ceiling in banks: past 32 banks (32k padded rows) the delta
#: is overdue for compaction — CompactionPolicy's delta-row trigger should
#: have fired long before.
_DELTA_FUSED_MAX_BANKS = 32

#: metrics whose kernel epilogue matches brute-force exact distances
#: term-for-term (cosine is not routed to the kernel)
_DELTA_FUSED_METRICS = frozenset(
    {
        DistanceType.L2Expanded,
        DistanceType.L2SqrtExpanded,
        DistanceType.InnerProduct,
    }
)

#: initial delta-buffer capacity (rows); grows by doubling
_DELTA_MIN_CAP = 64

#: serialized sidecar holding the main segment's raw rows + global ids
_ROWS_KIND = "mutable_rows"
_ROWS_VERSION = 1


def _po2(n: int) -> int:
    b = 1
    while b < n:
        b <<= 1
    return b


def _build_main(algo: str, data: np.ndarray, index_params, metric, res: Optional[Resources] = None):
    """Build one main-segment index over ``data`` rows whose positional
    ids are 0..n-1 (each builder assigns ``arange(n)``), on ``res``'s
    device."""
    from raft_tpu_torch.neighbors import brute_force, cagra, ivf_flat, ivf_pq

    if algo == "brute_force":
        return brute_force.build(data, metric=metric, res=res)
    if algo == "ivf_flat":
        params = index_params or ivf_flat.IvfFlatIndexParams(metric=metric)
        return ivf_flat.build(data, params=params, res=res)
    if algo == "ivf_pq":
        params = index_params or ivf_pq.IvfPqIndexParams(metric=metric)
        return ivf_pq.build(data, params=params, res=res)
    if algo == "cagra":
        params = index_params or cagra.CagraIndexParams(metric=metric)
        return cagra.build(data, params=params, res=res)
    raise ValueError(f"unknown mutable algo {algo!r}")


def _search_main(algo: str, index, queries, k: int, params, prefilter, dataset, **kw):
    """Dispatch one main-segment search with the tombstone prefilter
    applied in-scan (every index type consumes a keep-``Bitset``)."""
    from raft_tpu_torch.neighbors import brute_force, cagra, ivf_flat, ivf_pq

    if algo == "brute_force":
        return brute_force.search(index, queries, k, prefilter=prefilter, **kw)
    if algo == "ivf_flat":
        return ivf_flat.search(index, queries, k, params, prefilter=prefilter, **kw)
    if algo == "ivf_pq":
        return ivf_pq.search(
            index, queries, k, params, prefilter=prefilter, dataset=dataset, **kw
        )
    if algo == "cagra":
        return cagra.search(index, queries, k, params, prefilter=prefilter, **kw)
    raise ValueError(f"unknown mutable algo {algo!r}")


def _delta_fused_eligible(metric, cap: int, k: int) -> bool:
    """True inside the JAX package's banked window: a supported metric,
    the padded delta within 32 banks of 1,024 rows, and k <= 128."""
    return (
        metric in _DELTA_FUSED_METRICS
        and cap <= _DELTA_FUSED_MAX_ROWS * _DELTA_FUSED_MAX_BANKS
        and k <= 128
    )


def _delta_route(mode: str, metric, cap: int, k: int, device=None) -> str:
    """Resolve ``delta_mode`` to the scan that actually runs. ``auto``
    takes the kernel when eligible and the delta lies on a CUDA
    ``device`` (the JAX package takes it only on a TPU)."""
    expects(mode in DELTA_MODES, "delta_mode must be %s, got %r",
            "|".join(DELTA_MODES), mode)
    if mode == "exact":
        return "exact"
    eligible = _delta_fused_eligible(metric, cap, k)
    if mode == "fused":
        expects(
            eligible,
            "delta_mode='fused' needs an L2/IP metric, a delta of <= %d "
            "(padded) rows and k <= 128",
            _DELTA_FUSED_MAX_ROWS * _DELTA_FUSED_MAX_BANKS,
        )
        return "fused"
    on_cuda = device is not None and torch.device(device).type == "cuda"
    return "fused" if eligible and on_cuda else "exact"


@dataclasses.dataclass(frozen=True)
class DeltaScanInputs:
    """B1's arguments for one delta scan (:func:`delta_scan_inputs`)."""

    list_data: torch.Tensor  # [n_banks, bank_rows, d] f32
    list_norms: Optional[torch.Tensor]  # [n_banks, bank_rows] f32 or None
    list_indices: torch.Tensor  # [n_banks, bank_rows] i32, -1 dead or padding
    queries: torch.Tensor  # [n_qt * qt, d] f32, the tail padded with row 0
    tile_probes: torch.Tensor  # [n_qt, n_banks] i32: every tile probes every bank
    probe_valid: torch.Tensor  # [n_qt, n_banks] i32, all 1
    qt: int
    nq: int


def delta_scan_inputs(delta_bf, delta_live: Optional[Bitset], queries) -> DeltaScanInputs:
    """The padded delta as B1 scans it: banks of up to 1,024 rows (one
    bank of the whole delta below that), dead and padding rows at id -1,
    the queries padded to whole tiles of 128 with copies of row 0."""
    dev = delta_bf.dataset.device
    cap = int(delta_bf.size)
    qf = ser.as_tensor(queries, dev).to(torch.float32)
    nq = qf.shape[0]
    qt = _DELTA_FUSED_QT
    n_qt = max(1, (nq + qt - 1) // qt)
    if n_qt * qt != nq:
        qf = torch.cat([qf, qf[:1].expand(n_qt * qt - nq, qf.shape[1])])
    bank = min(cap, _DELTA_FUSED_MAX_ROWS)
    n_banks = cap // bank
    mask = delta_live.to_mask().to(dev) if delta_live is not None else torch.ones(
        cap, dtype=torch.bool, device=dev)
    positions = torch.arange(cap, dtype=torch.int32, device=dev)
    list_indices = torch.where(mask, positions, torch.full_like(positions, -1))
    norms = delta_bf.norms
    return DeltaScanInputs(
        list_data=delta_bf.dataset.to(torch.float32).reshape(n_banks, bank, -1),
        list_norms=None if norms is None else norms.reshape(n_banks, bank),
        list_indices=list_indices.reshape(n_banks, bank),
        queries=qf.contiguous(),
        tile_probes=torch.arange(n_banks, dtype=torch.int32, device=dev).repeat(n_qt, 1),
        probe_valid=torch.ones((n_qt, n_banks), dtype=torch.int32, device=dev),
        qt=qt,
        nq=nq,
    )


def _delta_fused_search(metric, delta_bf, delta_live, queries, k: int):
    """Delta scan through kernel B1, treating each 1,024-row bank of the
    padded delta buffer as one list that every query tile probes.

    One launch scans every bank: B1 keeps the exact top-k, so it returns
    the k lexicographically smallest ``(score, slot)`` pairs, and a slot
    is the bank times 1,024 plus the row, the delta position. The JAX
    package's loop (one kernel call a bank, then a stable argsort of the
    banks' lists side by side) gives the same list. The epilogue is the
    JAX package's: ``-score`` for IP; ``max(|q|^2 + score, 0)``, then the
    square root for L2Sqrt, and ``inf`` at id -1 for L2. The bank count
    is published as the ``mutable.delta.banks`` gauge."""
    from raft_tpu_torch.ops.ivf_scan import fused_list_topk

    a = delta_scan_inputs(delta_bf, delta_live, queries)
    vals, slots = fused_list_topk(
        a.list_data, a.list_norms, a.list_indices, a.queries, a.tile_probes, a.probe_valid,
        k=k, metric=metric, qt=a.qt,
    )
    if obs.is_enabled():
        obs.set_gauge("mutable.delta.banks", float(a.list_data.shape[0]))
    idx = torch.where(slots >= 0, slots, torch.full_like(slots, -1))
    if metric == DistanceType.InnerProduct:
        out = -vals
    else:
        qn = torch.sum(a.queries * a.queries, dim=1)
        out = torch.clamp(qn[:, None] + vals, min=0.0)
        if metric == DistanceType.L2SqrtExpanded:
            out = torch.sqrt(out)
        out = torch.where(idx >= 0, out, torch.full_like(out, float("inf")))
    return out[: a.nq], idx[: a.nq]


def _to_host(d, p) -> Tuple[np.ndarray, np.ndarray]:
    return ser.to_numpy(d).astype(np.float32, copy=False), ser.to_numpy(p)


def _save_rows(path: str, ids: np.ndarray, data: np.ndarray) -> str:
    """Atomic checksummed sidecar with the main segment's source rows
    (the rebuild input future compactions need — PQ codes are lossy)."""
    body = io.BytesIO()
    ser.serialize_array(body, np.asarray(ids, np.int64))
    ser.serialize_array(body, np.asarray(data, np.float32))
    payload = body.getvalue()
    return ser.atomic_write(
        path, lambda f: ser.save_stream(f, _ROWS_KIND, _ROWS_VERSION, payload)
    )


def _load_rows(path: str) -> Tuple[np.ndarray, np.ndarray]:
    with open(path, "rb") as f:
        _version, body = ser.load_stream(f, _ROWS_KIND)
        ids = ser.to_numpy(ser.deserialize_array(body))
        data = ser.to_numpy(ser.deserialize_array(body))
    return ids, data


@dataclasses.dataclass(frozen=True)
class Snapshot:
    """An immutable, search-consistent view of a :class:`MutableIndex`.

    Everything a query needs is pinned here: the main segment and its
    tombstone bitset, the (padded) delta brute-force segment and its
    live bitset, and the position→global-id maps. Mutations after
    :meth:`MutableIndex.snapshot` returned never alter this object, so
    a serving batch dispatched against it is atomic with respect to
    writers.
    """

    generation: int
    version: int
    algo: str
    metric: DistanceType
    dim: int
    main_index: object  # built index or None when the main segment is empty
    main_ids: np.ndarray  # int64[n_main] position -> global id
    main_live: Optional[Bitset]  # None = no tombstones (fast path)
    n_main_live: int
    refine_dataset: object  # ivf_pq exact re-rank rows (device) or None
    delta_bf: object  # BruteForceIndex over the padded delta, or None
    delta_ids: np.ndarray  # int64[delta_cap] position -> global id (-1 pad)
    delta_live: Optional[Bitset]  # live bits over the padded delta rows
    n_delta_live: int
    search_params: object = None
    search_kwargs: Dict[str, object] = dataclasses.field(default_factory=dict)
    delta_mode: str = "auto"  # auto | exact | fused (see _delta_route)

    @property
    def size(self) -> int:
        """Live (visible) row count."""
        return self.n_main_live + self.n_delta_live

    @property
    def select_min(self) -> bool:
        return is_min_close(self.metric)

    def search(self, queries, k: int, params=None, **kw) -> Tuple[np.ndarray, np.ndarray]:
        """Best-first search over both segments with tombstones masked
        in-scan. ``queries`` is a host array or a tensor. Returns host
        ``(distances f32 [m, k], ids int64 [m, k])``; unfilled slots get
        id -1 and the worst-sentinel distance.

        The main segment runs its native search (its ``mode``) with the
        tombstone bitset as ``prefilter``; the delta segment runs B1 or
        the exact brute-force scan over its padded buffer with dead and
        padding rows masked (:func:`_delta_route`); candidates merge
        k-way by distance on the host. With an empty delta and no
        tombstones the result is the main index's own output (ids mapped
        to the global space). A kernel failure raises; nothing falls
        back.
        """
        if not isinstance(queries, torch.Tensor):
            queries = np.asarray(queries, np.float32)
        expects(queries.ndim == 2 and queries.shape[1] == self.dim, "bad query shape")
        expects(k >= 1, "k must be >= 1")
        m = queries.shape[0]
        params = params if params is not None else self.search_params
        kw = {**self.search_kwargs, **kw}
        worst = np.float32(np.inf if self.select_min else -np.inf)
        parts: List[Tuple[np.ndarray, np.ndarray]] = []

        if self.main_index is not None and len(self.main_ids):
            k_main = min(k, len(self.main_ids))
            d, p = _to_host(*_search_main(
                self.algo, self.main_index, queries, k_main, params,
                prefilter=self.main_live, dataset=self.refine_dataset, **kw
            ))
            ids = np.where(p >= 0, self.main_ids[np.clip(p, 0, None)], np.int64(-1))
            d = np.where(ids >= 0, d, worst)
            parts.append((d, ids))
            if self.delta_bf is None and k_main == k:
                return d, ids  # pure-main fast path: native ordering intact

        if self.delta_bf is not None:
            from raft_tpu_torch.neighbors import brute_force

            k_delta = min(k, int(self.delta_bf.size))
            route = _delta_route(
                self.delta_mode, self.metric, int(self.delta_bf.size), k_delta,
                self.delta_bf.dataset.device,
            )
            if route == "fused":
                d, p = _delta_fused_search(
                    self.metric, self.delta_bf, self.delta_live, queries, k_delta
                )
            else:
                d, p = brute_force.search(
                    self.delta_bf, queries, k_delta, prefilter=self.delta_live,
                )
            if obs.is_enabled():
                obs.inc("mutable.delta.scans", mode=route)
            d, p = _to_host(d, p)
            ids = np.where(p >= 0, self.delta_ids[np.clip(p, 0, None)], np.int64(-1))
            d = np.where(ids >= 0, d, worst)
            parts.append((d, ids))

        if not parts:
            return (
                np.full((m, k), worst, np.float32),
                np.full((m, k), -1, np.int64),
            )
        all_d = np.concatenate([d for d, _ in parts], axis=1)
        all_i = np.concatenate([i for _, i in parts], axis=1)
        # dead/unfilled slots already carry the worst sentinel, so one
        # stable argsort is the k-way merge (ties keep main-first order)
        key = all_d if self.select_min else -all_d
        order = np.argsort(key, axis=1, kind="stable")[:, :k]
        out_d = np.take_along_axis(all_d, order, axis=1)
        out_i = np.take_along_axis(all_i, order, axis=1)
        if out_d.shape[1] < k:
            pad = k - out_d.shape[1]
            out_d = np.pad(out_d, ((0, 0), (0, pad)), constant_values=worst)
            out_i = np.pad(out_i, ((0, 0), (0, pad)), constant_values=-1)
        return out_d, out_i


@lockcheck.guarded_fields
class MutableIndex:
    """A mutable, crash-consistent index over one index type.

    >>> mut = MutableIndex.open("/data/wiki", "ivf_flat", dim=128)
    >>> ids = mut.insert(rows)               # durable-then-visible
    >>> mut.delete(ids[:10])                 # tombstoned in-scan
    >>> dist, gids = mut.search(queries, 10)
    >>> mut.compact()                        # fold delta+tombstones, new generation

    ``directory=None`` runs fully in memory (no WAL, no manifest) — the
    same visibility semantics without durability, for tests and
    benchmarks. Rows and ids live on the host; the segments' indexes live
    on ``res``'s device (``device=``, default ``cuda``).
    """

    def __init__(
        self,
        algo: str,
        dim: int,
        *,
        directory: Optional[str] = None,
        index_params=None,
        search_params=None,
        metric=None,
        name: Optional[str] = None,
        max_wal_bytes: Optional[int] = None,
        delta_mode: str = "auto",
        res: Optional[Resources] = None,
        device=None,
    ):
        expects(algo in ALGOS, "unknown mutable algo %r (want one of %s)",
                algo, ", ".join(ALGOS))
        expects(dim >= 1, "dim must be >= 1")
        expects(delta_mode in DELTA_MODES, "delta_mode must be %s, got %r",
                "|".join(DELTA_MODES), delta_mode)
        expects(max_wal_bytes is None or max_wal_bytes > 0,
                "max_wal_bytes must be positive when set")
        self.algo = algo
        self.dim = int(dim)
        self.directory = directory
        self.index_params = index_params
        self.search_params = search_params
        self.max_wal_bytes = max_wal_bytes
        self.delta_mode = delta_mode
        self.res = ensure_resources(res, device)
        if metric is None:
            metric = getattr(index_params, "metric", DistanceType.L2Expanded)
        self.metric = resolve_metric(metric)
        self.name = name or (os.path.basename(directory) if directory else "mutable")
        self._lock = lockcheck.tracked(threading.RLock(), "mutable.lock")
        # lock ordering: _compact_mutex (if taken) strictly before _lock.
        # It serializes whole compactions (foreground or background) so
        # two rebuilds can never race a generation number, while writers
        # and searchers keep taking _lock alone. utils/lock_order.toml
        # declares it and the RAFT_TPU_LOCKCHECK witness asserts it.
        self._compact_mutex = lockcheck.tracked(
            threading.Lock(), "mutable.compact_mutex"
        )
        #: when a background compaction is between pin and flip, every
        #: applied mutation is also recorded here so the in-memory
        #: (directory=None) catch-up replay has a source of truth; the
        #: directory-backed path reads the WAL instead
        self._capture: Optional[List[WalRecord]] = None
        # main segment state
        self.main_index = None
        self.main_data = np.zeros((0, dim), np.float32)
        self.main_ids = np.zeros((0,), np.int64)
        self._main_live_mask = np.zeros((0,), bool)
        self._n_main_dead = 0
        self._refine_dataset = None
        # delta segment state (append-only buffer, doubling capacity)
        self._delta_data = np.zeros((_DELTA_MIN_CAP, dim), np.float32)
        self._delta_ids = np.full((_DELTA_MIN_CAP,), -1, np.int64)
        self._delta_live = np.zeros((_DELTA_MIN_CAP,), bool)
        self._n_delta = 0
        self._n_delta_dead = 0
        # id space + versions
        self._id_loc: Dict[int, Tuple[str, int]] = {}
        self.next_id = 0
        self.generation = 0
        self.version = 0  # mutation counter (any visible change bumps it)
        self.wal: Optional[WriteAheadLog] = None
        self._snap: Optional[Snapshot] = None
        self._delta_bf_cache: Tuple[object, object] = (-1, None)

    # -- construction ------------------------------------------------------

    @classmethod
    def open(
        cls,
        directory: str,
        algo: str,
        dim: int,
        *,
        index_params=None,
        search_params=None,
        metric=None,
        name: Optional[str] = None,
        max_wal_bytes: Optional[int] = None,
        delta_mode: str = "auto",
        res: Optional[Resources] = None,
        device=None,
    ) -> "MutableIndex":
        """Open (or create) the mutable index at ``directory``.

        Recovery is manifest-then-WAL: the manifest names the live
        generation, its main-segment snapshot loads through the
        checksummed v4 path, and the generation's WAL replays on top —
        any valid prefix of a torn log recovers cleanly, so a crash at
        any point yields either the pre- or post-mutation state.
        ``max_wal_bytes`` arms size-triggered WAL segment rotation;
        ``delta_mode`` routes delta-segment scans (see
        :func:`_delta_route`).
        """
        self = cls(
            algo, dim, directory=directory, index_params=index_params,
            search_params=search_params, metric=metric, name=name,
            max_wal_bytes=max_wal_bytes, delta_mode=delta_mode, res=res, device=device,
        )
        m = man.read(directory)
        if m is None:
            m = man.Manifest(
                generation=0, algo=algo, dim=self.dim, main=None, rows=None,
                wal=_wal_name(0), next_id=0,
            )
            man.swap(directory, m)
        expects(m.algo == algo, "directory holds a %r index, not %r", m.algo, algo)
        expects(m.dim == self.dim, "directory holds dim=%d, not %d", m.dim, self.dim)
        self.generation = m.generation
        self.next_id = m.next_id
        if m.rows is not None:
            ids, data = _load_rows(os.path.join(directory, m.rows))
            self._install_main(ids, data, index=None)
            if m.main is not None:
                self.main_index = _load_main(
                    algo, os.path.join(directory, m.main), data, res=self.res
                )
        self.wal, records = WriteAheadLog.open(
            os.path.join(directory, m.wal), max_bytes=self.max_wal_bytes
        )
        for rec in records:
            self._apply(rec)
        self._note_obs()
        return self

    def _install_main(self, ids: np.ndarray, data: np.ndarray, index, res=None) -> None:
        """Replace the main segment (compaction/open): fresh tombstones,
        fresh id map for the main rows."""
        self.main_ids = np.asarray(ids, np.int64)
        self.main_data = np.asarray(data, np.float32)
        self.main_index = index
        self._main_live_mask = np.ones((len(ids),), bool)
        self._n_main_dead = 0
        self._refine_dataset = None
        if self.algo == "ivf_pq" and len(ids):
            # exact re-rank rows for the integrated refine path, pushed
            # to the device once per generation
            dev = (res if res is not None else self.res).device
            self._refine_dataset = ser.as_tensor(self.main_data, dev)
        self._id_loc.update(zip(self.main_ids.tolist(),
                                (("m", pos) for pos in range(len(self.main_ids)))))
        if len(ids):
            self.next_id = max(self.next_id, int(self.main_ids.max()) + 1)

    # -- introspection -----------------------------------------------------

    @property
    def size(self) -> int:
        """Visible (live) row count across both segments."""
        with self._lock:
            return (len(self.main_ids) - self._n_main_dead) + (
                self._n_delta - self._n_delta_dead
            )

    @property
    def delta_rows(self) -> int:
        with self._lock:
            return self._n_delta - self._n_delta_dead

    @property
    def tombstone_fraction(self) -> float:
        with self._lock:
            total = len(self.main_ids) + self._n_delta
            dead = self._n_main_dead + self._n_delta_dead
            return dead / total if total else 0.0

    def live_rows(self) -> Tuple[np.ndarray, np.ndarray]:
        """All live ``(ids, vectors)`` in stable segment order (main
        position order, then delta insertion order) — the exact input a
        from-scratch rebuild (or compaction) consumes."""
        with self._lock:
            mm = self._main_live_mask
            dm = self._delta_live[: self._n_delta]
            ids = np.concatenate([self.main_ids[mm], self._delta_ids[: self._n_delta][dm]])
            vecs = np.concatenate(
                [self.main_data[mm], self._delta_data[: self._n_delta][dm]], axis=0
            )
        return ids, vecs

    # -- mutations (durable then visible) ----------------------------------

    def insert(self, vectors, ids=None) -> np.ndarray:
        """Insert rows; returns their global ids (auto-assigned when
        ``ids`` is None). Fails on a live duplicate id — use
        :meth:`upsert` to replace."""
        vectors = np.ascontiguousarray(np.asarray(vectors, np.float32))
        if vectors.ndim == 1:
            vectors = vectors[None, :]
        expects(vectors.ndim == 2 and vectors.shape[1] == self.dim, "bad insert shape")
        with self._lock:
            if ids is None:
                ids = np.arange(self.next_id, self.next_id + len(vectors), dtype=np.int64)
            else:
                ids = np.asarray(ids, np.int64).reshape(-1)
                expects(len(ids) == len(vectors), "ids/vectors length mismatch")
                for gid in ids.tolist():
                    expects(gid not in self._id_loc,
                            "id %d already live — use upsert()", gid)
            rec = WalRecord(op="insert", ids=ids, vectors=vectors)
            if self.wal is not None:
                self.wal.append(rec)
            self._apply(rec)
            self._note_obs()
        return ids

    def delete(self, ids) -> int:
        """Tombstone rows by global id; unknown ids are ignored. Returns
        the number of rows actually deleted."""
        ids = np.asarray(ids, np.int64).reshape(-1)
        with self._lock:
            rec = WalRecord(op="delete", ids=ids)
            if self.wal is not None:
                self.wal.append(rec)
            n = self._apply(rec)
            self._note_obs()
        return n

    def upsert(self, ids, vectors) -> np.ndarray:
        """Replace-or-insert rows at explicit global ids (Faiss
        ``add_with_ids`` over existing ids): any live row with a given
        id is tombstoned and the new row becomes visible atomically."""
        vectors = np.ascontiguousarray(np.asarray(vectors, np.float32))
        if vectors.ndim == 1:
            vectors = vectors[None, :]
        ids = np.asarray(ids, np.int64).reshape(-1)
        expects(len(ids) == len(vectors), "ids/vectors length mismatch")
        expects(vectors.shape[1] == self.dim, "bad upsert shape")
        with self._lock:
            rec = WalRecord(op="upsert", ids=ids, vectors=vectors)
            if self.wal is not None:
                self.wal.append(rec)
            self._apply(rec)
            self._note_obs()
        return ids

    # -- application (shared by live mutation and WAL replay) --------------

    def _apply(self, rec: WalRecord) -> int:
        if self._capture is not None:
            # a background compaction pinned before this mutation: queue
            # it for the catch-up replay into the new generation
            self._capture.append(rec)
        if rec.op == "insert":
            self._apply_rows(rec.ids, rec.vectors, replace=False)
            if obs.is_enabled():
                obs.inc("mutable.inserts", float(len(rec.ids)), index=self.name)
            return len(rec.ids)
        if rec.op == "upsert":
            self._apply_rows(rec.ids, rec.vectors, replace=True)
            if obs.is_enabled():
                obs.inc("mutable.upserts", float(len(rec.ids)), index=self.name)
            return len(rec.ids)
        if rec.op == "delete":
            n = 0
            for gid in rec.ids.tolist():
                n += self._tombstone(gid)
            self.version += 1
            if obs.is_enabled():
                obs.inc("mutable.deletes", float(n), index=self.name)
            return n
        raise ValueError(f"unknown WAL op {rec.op!r}")

    def _tombstone(self, gid: int) -> int:
        loc = self._id_loc.pop(gid, None)
        if loc is None:
            return 0
        seg, pos = loc
        if seg == "m":
            self._main_live_mask[pos] = False
            self._n_main_dead += 1
        else:
            self._delta_live[pos] = False
            self._n_delta_dead += 1
        return 1

    def _grow_delta(self, need: int) -> None:
        """Double the delta buffers until they hold ``need`` rows."""
        cap = len(self._delta_data)
        new_cap = cap
        while new_cap < need:
            new_cap = max(_DELTA_MIN_CAP, 2 * new_cap)
        if new_cap == cap:
            return
        self._delta_data = np.concatenate(
            [self._delta_data, np.zeros((new_cap - cap, self.dim), np.float32)]
        )
        self._delta_ids = np.concatenate(
            [self._delta_ids, np.full((new_cap - cap,), -1, np.int64)]
        )
        self._delta_live = np.concatenate(
            [self._delta_live, np.zeros((new_cap - cap,), bool)]
        )

    def _apply_rows(self, ids: np.ndarray, vectors: np.ndarray, replace: bool) -> None:
        """Append rows to the delta in order. An upsert tombstones each
        id's live row first, row by row (a later row of the same batch
        replaces an earlier one); an insert writes the rows at once, a
        repeated id of one batch mapping to its last row, as row-by-row
        application would."""
        ids = np.asarray(ids, np.int64)
        n = len(ids)
        pos0 = self._n_delta
        self._grow_delta(pos0 + n)
        if replace:
            for i, gid in enumerate(ids.tolist()):
                self._tombstone(gid)
                pos = pos0 + i
                self._delta_data[pos] = vectors[i]
                self._delta_ids[pos] = gid
                self._delta_live[pos] = True
                self._id_loc[gid] = ("d", pos)
        else:
            self._delta_data[pos0 : pos0 + n] = vectors
            self._delta_ids[pos0 : pos0 + n] = ids
            self._delta_live[pos0 : pos0 + n] = True
            self._id_loc.update(zip(ids.tolist(), (("d", p) for p in range(pos0, pos0 + n))))
        self._n_delta = pos0 + n
        if n:
            self.next_id = max(self.next_id, int(ids.max()) + 1)
        self.version += 1

    # -- snapshots ---------------------------------------------------------

    def snapshot(self) -> Snapshot:
        """An immutable search-consistent view at this instant (cached
        until the next mutation or compaction)."""
        with self._lock:
            snap = self._snap
            if snap is not None and snap.generation == self.generation and snap.version == self.version:
                return snap
            main_live = None
            if self._n_main_dead and len(self.main_ids):
                main_live = Bitset.from_mask(
                    torch.from_numpy(self._main_live_mask).to(self.res.device))
            delta_bf, delta_live, delta_ids = None, None, self._delta_ids
            if self._n_delta - self._n_delta_dead > 0:
                delta_bf, delta_live, delta_ids = self._delta_segment()
            snap = Snapshot(
                generation=self.generation,
                version=self.version,
                algo=self.algo,
                metric=self.metric,
                dim=self.dim,
                main_index=self.main_index,
                main_ids=self.main_ids,
                main_live=main_live,
                n_main_live=len(self.main_ids) - self._n_main_dead,
                refine_dataset=self._refine_dataset,
                delta_bf=delta_bf,
                delta_ids=delta_ids,
                delta_live=delta_live,
                n_delta_live=self._n_delta - self._n_delta_dead,
                search_params=self.search_params,
                delta_mode=self.delta_mode,
            )
            self._snap = snap
            return snap

    def _delta_segment(self):
        """Brute-force view of the delta rows on the device, padded to a
        power of two; padding and dead rows are masked by the live
        bitset. Made once per mutation version: a query batch never
        copies the delta again."""
        from raft_tpu_torch.neighbors import brute_force

        cap = _po2(max(self._n_delta, 1))
        key = (self.version, cap)
        cached_key, cached = self._delta_bf_cache
        if cached_key == key:
            return cached
        data = self._delta_data[:cap]
        ids = self._delta_ids[:cap]
        mask = np.zeros((cap,), bool)
        mask[: self._n_delta] = self._delta_live[: self._n_delta]
        bf = brute_force.build(data, metric=self.metric, res=self.res)
        out = (bf, Bitset.from_mask(torch.from_numpy(mask).to(self.res.device)), ids.copy())
        self._delta_bf_cache = (key, out)
        return out

    def search(self, queries, k: int, params=None, **kw):
        """Convenience: :meth:`snapshot` then :meth:`Snapshot.search`."""
        return self.snapshot().search(queries, k, params=params, **kw)

    def compact(self, res=None) -> int:
        """Fold delta + tombstones into a rebuilt main segment and
        publish it as the next generation (see
        :func:`raft_tpu_torch.mutable.compact.compact`)."""
        from raft_tpu_torch.mutable.compact import compact

        return compact(self, res=res)

    def compact_background(self, res=None, _mid_rebuild=None) -> int:
        """One off-lock compaction on the calling thread: pin, rebuild
        without the lock, catch-up + flip under a brief lock (see
        :func:`raft_tpu_torch.mutable.maintenance.compact_background`).
        Production callers want a :class:`~raft_tpu_torch.mutable.
        maintenance.Compactor` worker instead."""
        from raft_tpu_torch.mutable.maintenance import compact_background

        return compact_background(self, res=res, _mid_rebuild=_mid_rebuild)

    def close(self) -> None:
        with self._lock:
            if self.wal is not None:
                self.wal.close()
                self.wal = None

    # -- obs ---------------------------------------------------------------

    def _note_obs(self) -> None:
        if not obs.is_enabled():
            return
        obs.set_gauge("mutable.generation", float(self.generation), index=self.name)
        obs.set_gauge("mutable.delta_rows", float(self.delta_rows), index=self.name)
        obs.set_gauge("mutable.size", float(self.size), index=self.name)
        obs.set_gauge(
            "mutable.tombstone_fraction", float(self.tombstone_fraction), index=self.name
        )


def _wal_name(generation: int) -> str:
    return f"wal-{generation:08d}.log"


def _gen_dirname(generation: int) -> str:
    return f"gen-{generation:08d}"


def _load_main(algo: str, path: str, data: np.ndarray, res=None):
    """Load one main-segment snapshot through the per-algo checksummed
    loader (CAGRA snapshots may externalize the dataset — re-attach the
    sidecar rows)."""
    from raft_tpu_torch.neighbors import brute_force, cagra, ivf_flat, ivf_pq

    if algo == "brute_force":
        return brute_force.load_path(path, res=res)
    if algo == "ivf_flat":
        return ivf_flat.load_path(path, res=res)
    if algo == "ivf_pq":
        return ivf_pq.load_path(path, res=res)
    if algo == "cagra":
        return cagra.load_path(path, dataset=data, res=res)
    raise ValueError(f"unknown mutable algo {algo!r}")
