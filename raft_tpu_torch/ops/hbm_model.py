"""Device-memory residency model and device/host placement planner
(``raft_tpu.ops.pallas.hbm_model`` counterpart).

Where :mod:`raft_tpu_torch.ops.smem_model` accounts for what one CTA of a
hand kernel keeps in shared memory, this module accounts for what a whole
*index* keeps in the card's memory: codes, coarse centers, id maps, mutable
delta banks, the raw f32 vectors the refine re-rank reads, and the caches
the port's kernels keep on an index.

The accounting drives :func:`plan_placement`: given every registered index
and a budget, decide per component whether it lives on the device or in
host RAM. Components the *scan* reads every query (``required=True``:
codes, centers, ids, norms, graph, and the port's kernel caches) must stay
on the device or the registration is infeasible; the raw-vector slab the
*refine* reads only for ``k * refine_ratio`` winners a query
(``required=False``) stays on the device while the budget lasts and spills
to the host tier otherwise, where :mod:`raft_tpu_torch.tiered` serves it.

The port's indexes hold device buffers the JAX ones do not, and
:func:`residency_for_index` counts them: B4's neighbour table
(``cagra._fused_table``, ``[n, graph_degree, d]``, eight times the raw rows
at degree 16 in bf16) and its strided seeds, B2's group tables
(``ivf_pq._fused_group_tables``), ``list_sizes`` and ``center_rank``, the
per-shard copies a sharded search keeps, and a CAGRA index's squared
norms. Estimates are exact for the buffers an index holds (the same
``shape x itemsize`` that allocated them; tests hold the model to the sum
of ``nbytes`` over every tensor reachable from a built index) and leave out
transient workspaces, which the headroom fraction absorbs.

The arithmetic (:class:`HbmComponent`, :func:`staging_footprint`,
:func:`plan_placement`, :func:`plan_placement_sharded` and the parametric
models) is the JAX package's, so identical residency lists get identical
verdicts in both packages.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, Optional, Sequence, Tuple

import torch

#: Device memory of the card the port targets: NVIDIA H100 80GB HBM3 (700 W,
#: as ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
#: names it), 80 GB on its data sheet. A *budget*, not a limit: callers pass
#: the share of the card the index tier may plan for; the rest belongs to
#: the kernels' workspaces and PyTorch's caching allocator.
HBM_DEFAULT_BUDGET_BYTES = 80 * 10**9

#: Fraction of the stated budget the planner fills. The rest absorbs what
#: the model cannot see: the allocator's fragmentation, transient
#: temporaries and the kernels' scratch buffers.
HBM_HEADROOM = 0.9

#: Staging-slab model defaults. A spilled index gathers its refine rows
#: through the host tier's double-buffered staging
#: (``HostVectorStore._staging``): two pinned host buffers of
#: ``[micro_batch, n_cand, dim]`` plus the one in-flight transfer slab on
#: the device. ``k * refine_ratio`` is not known at planning time, so the
#: planner charges this nominal candidate width (the serving defaults:
#: micro_batch 256, k 10 x refine_ratio ~6 rounded up).
STAGING_MICRO_BATCH = 256
STAGING_N_CAND = 64


@dataclasses.dataclass(frozen=True)
class HbmComponent:
    """One HBM-resident buffer of an index.

    ``required=True`` marks buffers the per-query *scan* reads (codes,
    centroids, ids): these cannot leave the device without losing the
    fused kernels. ``required=False`` marks the refine raw-vector slab,
    which :func:`plan_placement` may move to the host tier.

    ``replicated=True`` marks buffers every shard of a lists-sharded
    search keeps whole (coarse centroids, rotation, PQ codebook —
    everything ``sharded_ann`` copies whole to each shard);
    :func:`plan_placement_sharded` charges them at full size per shard
    instead of ``1/n_shards``."""

    name: str
    shape: Tuple[int, ...]
    itemsize: int
    required: bool = True
    replicated: bool = False

    @property
    def nbytes(self) -> int:
        return int(math.prod(self.shape)) * self.itemsize

    def per_shard_bytes(self, n_shards: int) -> int:
        """Bytes this component costs on EACH shard of an
        ``n_shards``-way lists-sharded placement."""
        if self.replicated or n_shards <= 1:
            return self.nbytes
        return -(-self.nbytes // n_shards)  # ceil


def staging_footprint(
    dim: int,
    itemsize: int = 4,
    *,
    micro_batch: int = STAGING_MICRO_BATCH,
    n_cand: int = STAGING_N_CAND,
) -> Tuple[int, int]:
    """``(host_bytes, device_bytes)`` staging cost of ONE index whose
    raw slab lives on the host tier: two host buffers (double buffering
    — slab *i* stays valid for the in-flight refine while *i+1* fills)
    plus the one in-flight ``[micro_batch, n_cand, dim]`` transfer slab
    the re-rank holds in device memory."""
    slab = int(micro_batch) * int(n_cand) * int(dim) * int(itemsize)
    return 2 * slab, slab


@dataclasses.dataclass(frozen=True)
class IndexResidency:
    """The model's full HBM accounting for one registered index."""

    index_id: str
    algo: str
    components: Tuple[HbmComponent, ...]

    @property
    def total_bytes(self) -> int:
        return sum(c.nbytes for c in self.components)

    @property
    def required_bytes(self) -> int:
        """Bytes that must stay device-resident for the scan to run."""
        return sum(c.nbytes for c in self.components if c.required)

    @property
    def optional_bytes(self) -> int:
        """Bytes eligible for the host tier (refine raw vectors)."""
        return sum(c.nbytes for c in self.components if not c.required)

    def by_name(self, name: str) -> HbmComponent:
        for c in self.components:
            if c.name == name:
                return c
        raise KeyError(name)

    def table(self) -> str:
        rows = [
            "%-14s %-18s %12d B  [%s]"
            % (c.name, "x".join(map(str, c.shape)), c.nbytes,
               "scan" if c.required else "refine")
            for c in self.components
        ]
        rows.append("total: %d B (%.2f GiB)" % (self.total_bytes, self.total_bytes / 2**30))
        return "\n".join(rows)


def _dataset_component(n_rows: int, dim: int, itemsize: int = 4) -> HbmComponent:
    return HbmComponent("raw_vectors", (n_rows, dim), itemsize, required=False)


def ivf_pq_residency(
    index_id: str,
    *,
    n_rows: int,
    dim: int,
    n_lists: int,
    pq_dim: int,
    pq_bits: int,
    ksub: int = 256,
    rot_dim: Optional[int] = None,
    max_list: Optional[int] = None,
    rabitq: bool = False,
    refine_rows: int = 0,
    refine_itemsize: int = 4,
) -> IndexResidency:
    """HBM residency of an IVF-PQ (or IVF-RaBitQ) index.

    ``refine_rows > 0`` adds the optional raw-vector slab the integrated
    refine path gathers from (``refine_rows`` is usually ``n_rows``)."""
    max_list = max_list or math.ceil(n_rows / max(n_lists, 1))
    rot = rot_dim or dim
    bpr = max(1, (pq_dim * pq_bits + 7) // 8)  # bytes per packed row
    comps = [
        HbmComponent("codes", (n_lists, max_list, bpr), 1),
        HbmComponent("centers", (n_lists, dim), 4, replicated=True),
        HbmComponent("ids", (n_lists, max_list), 4),
    ]
    if rabitq:
        # RaBitQ: 1 bit/dim codes already counted via bpr; per-row f32
        # correction factors replace the PQ codebook.
        comps.append(HbmComponent("corrections", (n_lists, max_list, 2), 4))
    else:
        comps.append(HbmComponent("codebook", (pq_dim, ksub, rot // max(pq_dim, 1)), 4,
                                  replicated=True))
        comps.append(HbmComponent("rotation", (rot, dim), 4, replicated=True))
    if refine_rows > 0:
        comps.append(_dataset_component(refine_rows, dim, refine_itemsize))
    return IndexResidency(index_id, "ivf_rabitq" if rabitq else "ivf_pq", tuple(comps))


def ivf_flat_residency(
    index_id: str,
    *,
    n_rows: int,
    dim: int,
    n_lists: int,
    itemsize: int = 4,
    max_list: Optional[int] = None,
    refine_rows: int = 0,
    refine_itemsize: int = 4,
) -> IndexResidency:
    """HBM residency of an IVF-Flat index (list-major padded storage)."""
    max_list = max_list or math.ceil(n_rows / max(n_lists, 1))
    comps = [
        HbmComponent("list_data", (n_lists, max_list, dim), itemsize),
        HbmComponent("centers", (n_lists, dim), 4, replicated=True),
        HbmComponent("ids", (n_lists, max_list), 4),
        HbmComponent("norms", (n_lists, max_list), 4),
    ]
    if refine_rows > 0:
        comps.append(_dataset_component(refine_rows, dim, refine_itemsize))
    return IndexResidency(index_id, "ivf_flat", tuple(comps))


def brute_force_residency(
    index_id: str,
    *,
    n_rows: int,
    dim: int,
    itemsize: int = 4,
    has_norms: bool = True,
    refine_rows: int = 0,
    refine_itemsize: int = 4,
) -> IndexResidency:
    """HBM residency of a brute-force index. With ``refine_rows`` the
    scan copy may be a narrow dtype (bf16) while the refine slab holds
    the f32 originals."""
    comps = [HbmComponent("dataset", (n_rows, dim), itemsize)]
    if has_norms:
        comps.append(HbmComponent("norms", (n_rows,), 4))
    if refine_rows > 0:
        comps.append(_dataset_component(refine_rows, dim, refine_itemsize))
    return IndexResidency(index_id, "brute_force", tuple(comps))


def cagra_residency(
    index_id: str,
    *,
    n_rows: int,
    dim: int,
    graph_degree: int,
    itemsize: int = 4,
    table_itemsize: int = 2,
    init_sample: int = 0,
) -> IndexResidency:
    """Device residency of a CAGRA graph index: the dataset and the
    fixed-degree graph (as the JAX model counts them), the squared norms,
    and B4's ``[n_rows, graph_degree, dim]`` neighbour table at
    ``table_itemsize`` bytes an element (0: not built) and, with
    ``init_sample``, its strided seeds (ids, f32 rows and norms); all are
    read every query."""
    # sharded CAGRA shards queries, not the graph: every buffer is
    # replicated on every shard
    comps = [
        HbmComponent("dataset", (n_rows, dim), itemsize, replicated=True),
        HbmComponent("graph", (n_rows, graph_degree), 4, replicated=True),
        HbmComponent("sqnorms", (n_rows,), 4, replicated=True),
    ]
    if table_itemsize:
        comps.append(HbmComponent("neighbor_table", (n_rows, graph_degree, dim), table_itemsize,
                                  replicated=True))
    if init_sample:
        s = min(int(init_sample), n_rows)
        comps += [
            HbmComponent(f"seed_ids[{init_sample}]", (s,), 4, replicated=True),
            HbmComponent(f"seed_rows[{init_sample}]", (s, dim), 4, replicated=True),
            HbmComponent(f"seed_norms[{init_sample}]", (s,), 4, replicated=True),
        ]
    return IndexResidency(index_id, "cagra", tuple(comps))


def delta_bank_residency(
    index_id: str,
    *,
    cap: int,
    dim: int,
    bank_rows: int = 1024,
) -> IndexResidency:
    """HBM residency of a mutable index's delta segment: the po2-padded
    f32 brute-force rows plus per-bank norms (see
    :mod:`raft_tpu_torch.mutable.segments` — past ``bank_rows`` the fused scan
    tiles the delta into ``ceil(cap / bank_rows)`` banks)."""
    banks = max(1, math.ceil(cap / bank_rows))
    return IndexResidency(index_id, "mutable_delta", (
        HbmComponent("delta_rows", (cap, dim), 4),
        HbmComponent("delta_norms", (cap,), 4),
        HbmComponent("delta_ids", (banks, min(cap, bank_rows)), 4),
    ))


def _comp(name: str, t: torch.Tensor, *, replicated: bool = False) -> HbmComponent:
    return HbmComponent(name, tuple(t.shape), t.element_size(), replicated=replicated)


def _cached_components(index, counted) -> list:
    """The kernels' caches a port index keeps as plain attributes: B2's
    group tables, B4's neighbour table and seeds, and a sharded search's
    per-shard tensors that hold memory of their own (``shard_copies``, each
    allocation counted whole; views of the index's tensors, whose
    allocations are ``counted``, add nothing)."""
    comps = []
    for g, (groups, chunks) in sorted(getattr(index, "__dict__", {})
                                      .get("_fused_group_tables", {}).items()):
        comps += [_comp(f"group_tables[{g}]", groups), _comp(f"group_chunks[{g}]", chunks)]
    table = getattr(index, "_fused_table_cache", None)
    if table is not None:
        comps.append(_comp("neighbor_table", table[1], replicated=True))
    for sample, (ids, rows, norms) in sorted((getattr(index, "_fused_seed_cache", None)
                                              or {}).items()):
        comps += [_comp(f"seed_ids[{sample}]", ids, replicated=True),
                  _comp(f"seed_rows[{sample}]", rows, replicated=True),
                  _comp(f"seed_norms[{sample}]", norms, replicated=True)]
    copies, seen = 0, set(counted)
    for parts in getattr(index, "__dict__", {}).get("_shard_cache", {}).values():
        for tensors in parts.values():
            for t in tensors:
                if _storage(t) not in seen:  # a new allocation: count all of it
                    seen.add(_storage(t))
                    copies += t.untyped_storage().nbytes()
    if copies:
        comps.append(HbmComponent("shard_copies", (copies,), 1))
    return comps


def _storage(t: torch.Tensor):
    """What identifies ``t``'s allocation: a view shares its base's."""
    return t.device, t.untyped_storage().data_ptr()


def residency_for_index(index_id: str, algo: str, index, *,
                        refine_rows: int = 0) -> IndexResidency:
    """Model a *built* port index by reading its tensors' shapes, so the
    estimate matches allocation exactly: the components the JAX model has
    (same names and ``replicated`` flags), then the port's own tensors and
    the kernels' caches (:func:`_cached_components`). ``refine_rows > 0``
    adds the optional f32 ``raw_vectors`` slab the refine gathers from."""
    if algo in ("ivf_pq", "ivf_rabitq"):
        comps = [
            _comp("codes", index.codes),
            _comp("centers", index.centers, replicated=True),
            _comp("centers_rot", index.centers_rot, replicated=True),
            _comp("rotation", index.rotation, replicated=True),
            _comp("codebook", index.pq_centers, replicated=True),
            _comp("ids", index.list_indices),
            _comp("sqnorms", index.rot_sqnorms),
        ]
        if index.corrections is not None:
            comps.append(_comp("corrections", index.corrections))
        own = [index.codes, index.centers, index.centers_rot, index.rotation,
               index.pq_centers, index.list_indices, index.rot_sqnorms, index.corrections,
               index.list_sizes, index.center_rank]
        dim = index.dim
    elif algo == "ivf_flat":
        comps = [
            _comp("list_data", index.list_data),
            _comp("centers", index.centers, replicated=True),
            _comp("ids", index.list_indices),
        ]
        if index.list_norms is not None:
            comps.append(_comp("norms", index.list_norms))
        own = [index.list_data, index.centers, index.list_indices, index.list_norms,
               index.list_sizes, index.center_rank]
        dim = index.dim
    elif algo == "brute_force":
        comps = [_comp("dataset", index.dataset)]
        if index.norms is not None:
            comps.append(_comp("norms", index.norms))
        own = [index.dataset, index.norms]
        dim = index.dataset.shape[1]
    elif algo == "cagra":
        comps, own = [], [index.dataset, index.graph, index.sqnorms]
        if index.dataset is not None:
            comps.append(_comp("dataset", index.dataset, replicated=True))
        comps.append(_comp("graph", index.graph, replicated=True))
        if index.sqnorms is not None:
            comps.append(_comp("sqnorms", index.sqnorms, replicated=True))
        if index.vpq is not None:
            v = index.vpq
            for name in ("vq_centers", "vq_labels", "pq_centers", "codes", "sqnorms"):
                comps.append(_comp(f"vpq_{name}", getattr(v, name), replicated=True))
                own.append(getattr(v, name))
        dim = index.dim
    else:
        raise KeyError(f"no device residency model for algo {algo!r}")
    if algo in ("ivf_pq", "ivf_rabitq", "ivf_flat"):
        comps.append(_comp("list_sizes", index.list_sizes))
        if index.center_rank is not None:
            comps.append(_comp("center_rank", index.center_rank, replicated=True))
    own = [t for t in own if t is not None]
    comps += _cached_components(index, {_storage(t) for t in own})
    if refine_rows > 0:
        comps.append(_dataset_component(refine_rows, dim))
    return IndexResidency(index_id, algo, tuple(comps))


@dataclasses.dataclass(frozen=True)
class Placement:
    """The planner's verdict for a set of indexes under one budget.

    ``tiers`` maps ``index_id -> {component_name -> "device" | "host"}``.
    ``feasible`` is False when even the required (scan) components
    overflow the budget — the caller must shard or shrink, there is no
    host tier for codes."""

    hbm_budget: int
    tiers: Dict[str, Dict[str, str]]
    device_bytes: int
    host_bytes: int
    feasible: bool
    #: double-buffered host staging slabs of spilled indexes (2x each)
    staging_host_bytes: int = 0
    #: in-flight gather transfer slabs of spilled indexes (1x each),
    #: included in ``device_bytes``
    staging_device_bytes: int = 0

    def tier(self, index_id: str, component: str) -> str:
        return self.tiers[index_id][component]

    def spilled(self, index_id: str) -> bool:
        """Does any component of ``index_id`` live off the device?"""
        return any(t != "device" for t in self.tiers[index_id].values())

    def table(self) -> str:
        rows = []
        for iid, comps in sorted(self.tiers.items()):
            for name, tier in comps.items():
                rows.append("%-20s %-14s -> %s" % (iid, name, tier))
        if self.staging_host_bytes or self.staging_device_bytes:
            rows.append(
                "staging: host %.2f MiB (2x double-buffer)  device %.2f MiB (transfer)"
                % (self.staging_host_bytes / 2**20, self.staging_device_bytes / 2**20)
            )
        rows.append(
            "device: %.2f GiB  host: %.2f GiB  budget: %.2f GiB%s"
            % (self.device_bytes / 2**30, self.host_bytes / 2**30,
               self.hbm_budget / 2**30, "" if self.feasible else "  INFEASIBLE")
        )
        return "\n".join(rows)


def plan_placement(
    indexes: Sequence[IndexResidency] | Iterable[IndexResidency],
    hbm_budget: int = HBM_DEFAULT_BUDGET_BYTES,
    *,
    headroom: float = HBM_HEADROOM,
) -> Placement:
    """Decide device- vs host-tier per component.

    Required components always plan to the device (the scan cannot run
    otherwise); if their sum exceeds ``hbm_budget * headroom`` the plan
    is marked infeasible. Optional components (refine raw vectors) are
    then admitted largest-first into the remaining budget — spilling the
    *biggest* slab first buys the most headroom per spilled index, so a
    mixed fleet keeps its small indexes fully resident.

    Every spilled index additionally charges its staging footprint
    (:func:`staging_footprint`): 2x host buffers into
    ``staging_host_bytes`` and the in-flight transfer slab into
    ``device_bytes`` / ``staging_device_bytes``. Admission is
    smallest-first, so spills form a suffix of the admission order and
    staging charges (which accrue only on spill) never retroactively
    evict an already-admitted slab; ``feasible`` stays a required-bytes
    criterion — staging is accounting the operator reads, not a reason
    to refuse a scan that fits.
    """
    indexes = list(indexes)
    cap = int(hbm_budget * headroom)
    tiers: Dict[str, Dict[str, str]] = {}
    device = 0
    for res in indexes:
        tiers[res.index_id] = {c.name: "device" for c in res.components if c.required}
        device += res.required_bytes
    feasible = device <= cap

    optional = sorted(
        ((c, res) for res in indexes for c in res.components if not c.required),
        key=lambda pair: pair[0].nbytes,
    )
    host = 0
    stage_host = stage_dev = 0
    staged = set()
    # smallest-first admission == largest-first spill
    for comp, res in optional:
        if feasible and device + comp.nbytes <= cap:
            tiers[res.index_id][comp.name] = "device"
            device += comp.nbytes
        else:
            tiers[res.index_id][comp.name] = "host"
            host += comp.nbytes
            if res.index_id not in staged:
                staged.add(res.index_id)
                sh, sd = staging_footprint(int(comp.shape[-1]), comp.itemsize)
                stage_host += sh
                stage_dev += sd
    return Placement(
        hbm_budget=int(hbm_budget), tiers=tiers,
        device_bytes=device + stage_dev, host_bytes=host, feasible=feasible,
        staging_host_bytes=stage_host, staging_device_bytes=stage_dev,
    )


@dataclasses.dataclass(frozen=True)
class ShardedPlacement:
    """Per-shard verdict of :func:`plan_placement_sharded`.

    All byte totals are PER SHARD. ``tiers`` maps ``index_id ->
    {component_name -> "device" | "host" | "disk"}``: device HBM, the
    shard host's RAM (an in-memory :class:`~raft_tpu_torch.tiered.store.
    HostVectorStore`), or the shard host's disk (the mmap/SSD-backed
    store variant — read-ahead hints + the fetch-depth budget keep its
    p99 bounded on cold pages)."""

    n_shards: int
    hbm_budget_per_shard: int
    host_budget_per_shard: Optional[int]
    tiers: Dict[str, Dict[str, str]]
    device_bytes_per_shard: int
    host_bytes_per_shard: int
    disk_bytes_per_shard: int
    feasible: bool
    #: double-buffered host staging slabs of spilled indexes (2x each),
    #: charged against the host budget alongside RAM-tier slabs
    staging_host_bytes: int = 0
    #: in-flight gather transfer slabs (1x each), included in
    #: ``device_bytes_per_shard``
    staging_device_bytes: int = 0

    def tier(self, index_id: str, component: str) -> str:
        return self.tiers[index_id][component]

    def spilled(self, index_id: str) -> bool:
        """Does any component of ``index_id`` live off the device?"""
        return any(t != "device" for t in self.tiers[index_id].values())

    def table(self) -> str:
        rows = ["per-shard placement over %d shards:" % self.n_shards]
        for iid, comps in sorted(self.tiers.items()):
            for name, tier in comps.items():
                rows.append("%-20s %-14s -> %s" % (iid, name, tier))
        if self.staging_host_bytes or self.staging_device_bytes:
            rows.append(
                "staging/shard: host %.2f MiB (2x double-buffer)  device %.2f MiB (transfer)"
                % (self.staging_host_bytes / 2**20, self.staging_device_bytes / 2**20)
            )
        rows.append(
            "per shard — device: %.2f GiB  host: %.2f GiB  disk: %.2f GiB  hbm budget: %.2f GiB%s"
            % (self.device_bytes_per_shard / 2**30, self.host_bytes_per_shard / 2**30,
               self.disk_bytes_per_shard / 2**30, self.hbm_budget_per_shard / 2**30,
               "" if self.feasible else "  INFEASIBLE")
        )
        return "\n".join(rows)


def plan_placement_sharded(
    indexes: Sequence[IndexResidency] | Iterable[IndexResidency],
    n_shards: int,
    hbm_budget_per_shard: int = HBM_DEFAULT_BUDGET_BYTES,
    *,
    host_budget_per_shard: Optional[int] = None,
    headroom: float = HBM_HEADROOM,
    staging_micro_batch: int = STAGING_MICRO_BATCH,
    staging_n_cand: int = STAGING_N_CAND,
) -> ShardedPlacement:
    """Per-shard placement over the three-level hierarchy the tiered sharded
    index (:class:`raft_tpu_torch.tiered.TieredShardedIndex`) serves from:
    device HBM, the shard host's RAM, and the shard host's disk.

    Replicated components (coarse centroids, rotation, PQ codebook —
    see :attr:`HbmComponent.replicated`) cost their FULL size on every
    shard; everything else costs ``ceil(nbytes / n_shards)``. Required
    components must fit the per-shard device cap or the plan is
    infeasible (codes cannot leave HBM). Optional slabs admit
    smallest-first to the device; a spilled slab lands in host RAM
    while the per-shard host budget — charged with the 2x
    double-buffered staging slabs the spill brings — still holds, and
    on disk past it (the mmap/SSD-backed store; same gather, the OS
    pages rows in under read-ahead hints). ``host_budget_per_shard=None``
    means unconstrained host RAM: nothing plans to disk.
    """
    indexes = list(indexes)
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    cap = int(hbm_budget_per_shard * headroom)
    tiers: Dict[str, Dict[str, str]] = {}
    device = 0
    for res in indexes:
        tiers[res.index_id] = {c.name: "device" for c in res.components if c.required}
        device += sum(
            c.per_shard_bytes(n_shards) for c in res.components if c.required
        )
    feasible = device <= cap

    optional = sorted(
        ((c, res) for res in indexes for c in res.components if not c.required),
        key=lambda pair: pair[0].per_shard_bytes(n_shards),
    )
    host = disk = stage_host = stage_dev = 0
    staged = set()
    for comp, res in optional:
        b = comp.per_shard_bytes(n_shards)
        if feasible and device + b <= cap:
            tiers[res.index_id][comp.name] = "device"
            device += b
            continue
        # spilling: the index starts staging through the host no matter
        # which off-device tier the slab itself lands in
        sh, sd = staging_footprint(
            int(comp.shape[-1]), comp.itemsize,
            micro_batch=staging_micro_batch, n_cand=staging_n_cand,
        )
        charge_h = sh if res.index_id not in staged else 0
        if host_budget_per_shard is None or (
            host + b + stage_host + charge_h <= int(host_budget_per_shard)
        ):
            tiers[res.index_id][comp.name] = "host"
            host += b
        else:
            tiers[res.index_id][comp.name] = "disk"
            disk += b
        if res.index_id not in staged:
            staged.add(res.index_id)
            stage_host += sh
            stage_dev += sd
    return ShardedPlacement(
        n_shards=int(n_shards),
        hbm_budget_per_shard=int(hbm_budget_per_shard),
        host_budget_per_shard=(
            None if host_budget_per_shard is None else int(host_budget_per_shard)
        ),
        tiers=tiers,
        device_bytes_per_shard=device + stage_dev,
        host_bytes_per_shard=host,
        disk_bytes_per_shard=disk,
        feasible=feasible,
        staging_host_bytes=stage_host,
        staging_device_bytes=stage_dev,
    )
