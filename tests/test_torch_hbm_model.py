"""The port's device-memory model (``raft_tpu_torch.ops.hbm_model``) and
shared-memory model (``raft_tpu_torch.ops.smem_model``).

* ``plan_placement`` and ``plan_placement_sharded`` fed the same residency
  lists give the JAX package's verdicts, and the parametric models its
  components;
* ``residency_for_index`` equals the sum of ``nbytes`` over every tensor
  reachable from a built port index (walked from the object, views of one
  allocation counted once), the kernels' caches included: B2's group
  tables, B4's neighbour table and seeds; a sharded search's per-shard
  tensors are counted by allocation (``shard_copies``);
* the components the JAX model also has carry its bytes for the same saved
  index;
* each kernel's shared-memory residency equals its wrapper's count over a
  sweep of shapes.
"""
import dataclasses
import io

import numpy as np
import pytest
import torch

from raft_tpu.neighbors import ivf_flat as jflat
from raft_tpu.neighbors import ivf_pq as jpq
from raft_tpu.ops.pallas import hbm_model as jhbm
from raft_tpu_torch.core.resources import Resources
from raft_tpu_torch.neighbors import brute_force, cagra, ivf_flat, ivf_pq
from raft_tpu_torch.ops import cagra_search, hbm_model, ivf_scan, pq_scan, rabitq_scan
from raft_tpu_torch.ops import ring_topk, smem_model
from raft_tpu_torch.parallel import (make_mesh, sharded_ivf_flat_search,
                                     sharded_ivf_pq_lists_search)

CPU = Resources(device="cpu")
N, D = 2000, 24


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(41)
    return (rng.standard_normal((N, D)).astype(np.float32),
            rng.standard_normal((160, D)).astype(np.float32))


def walked_nbytes(index, skip=()) -> int:
    """Sum of ``nbytes`` over the tensors reachable from ``index``'s
    attributes (dicts, lists, tuples and objects followed; not the
    attributes named in ``skip``), each allocation counted once: a view of
    an allocation already seen adds nothing."""
    seen, total = set(), 0

    def walk(obj):
        nonlocal total
        if isinstance(obj, torch.Tensor):
            key = (obj.device, obj.untyped_storage().data_ptr())
            if key not in seen:
                seen.add(key)
                total += obj.nbytes
            return
        if id(obj) in seen or isinstance(obj, (str, bytes, int, float, bool, type(None))):
            return
        seen.add(id(obj))
        if isinstance(obj, dict):
            for v in obj.values():
                walk(v)
        elif isinstance(obj, (list, tuple)):
            for v in obj:
                walk(v)
        elif dataclasses.is_dataclass(obj) or hasattr(obj, "__dict__"):
            for name, v in vars(obj).items():
                if name not in skip:
                    walk(v)

    walk(index)
    return total


# -- the planners: identical lists, identical verdicts ----------------------------------------


def _pair(name, parts, required=True):
    """One residency as (port, JAX) objects from ``parts``: (component,
    shape, itemsize, replicated) tuples, the last one optional when
    ``required`` is False."""
    def build(mod):
        comps = [mod.HbmComponent(c, s, i, required=required or j < len(parts) - 1,
                                  replicated=r) for j, (c, s, i, r) in enumerate(parts)]
        return mod.IndexResidency(name, "ivf_pq", tuple(comps))
    return build(hbm_model), build(jhbm)


FLEETS = {
    "one_small": [("a", [("codes", (8, 100, 16), 1, False), ("centers", (8, 64), 4, True),
                         ("raw_vectors", (800, 64), 4, False)], False)],
    "mixed": [("small", [("dataset", (100, 32), 4, False), ("raw_vectors", (100, 32), 4, False)],
               False),
              ("big", [("dataset", (10000, 32), 4, False),
                       ("raw_vectors", (10000, 32), 4, False)], False),
              ("scan_only", [("codes", (64, 1000, 8), 1, False),
                             ("rotation", (64, 64), 4, True)], True)],
    "wide": [("w", [("codes", (16, 4000, 16), 1, False), ("codebook", (16, 256, 8), 4, True),
                    ("raw_vectors", (64000, 128), 4, False)], False)],
}


@pytest.mark.parametrize("fleet", sorted(FLEETS))
def test_plan_placement_verdicts_match_jax(fleet):
    pairs = [_pair(n, parts, req) for n, parts, req in FLEETS[fleet]]
    ports, jaxs = [p for p, _ in pairs], [j for _, j in pairs]
    total = sum(r.total_bytes for r in ports)
    required = sum(r.required_bytes for r in ports)
    for budget in (1024, int(required / 0.9) + 64, int((required + total) / 1.8),
                   int(total / 0.9) + 4096, hbm_model.HBM_DEFAULT_BUDGET_BYTES):
        t, j = hbm_model.plan_placement(ports, budget), jhbm.plan_placement(jaxs, budget)
        assert (t.tiers, t.device_bytes, t.host_bytes, t.feasible, t.staging_host_bytes,
                t.staging_device_bytes) == (j.tiers, j.device_bytes, j.host_bytes, j.feasible,
                                            j.staging_host_bytes, j.staging_device_bytes)
        assert t.table() == j.table()
        for n_shards in (1, 2, 8):
            for host in (None, 1024, 1 << 30):
                ts = hbm_model.plan_placement_sharded(ports, n_shards, budget,
                                                      host_budget_per_shard=host)
                js = jhbm.plan_placement_sharded(jaxs, n_shards, budget,
                                                 host_budget_per_shard=host)
                assert dataclasses.asdict(ts) == dataclasses.asdict(js)


def test_constants_and_parametric_models_match_jax():
    assert (hbm_model.HBM_HEADROOM, hbm_model.STAGING_MICRO_BATCH, hbm_model.STAGING_N_CAND) == (
        jhbm.HBM_HEADROOM, jhbm.STAGING_MICRO_BATCH, jhbm.STAGING_N_CAND)
    assert hbm_model.HBM_DEFAULT_BUDGET_BYTES == 80 * 10**9
    for dim in (32, 128):
        assert hbm_model.staging_footprint(dim) == jhbm.staging_footprint(dim)
    cases = [
        ("ivf_pq_residency", dict(n_rows=1000, dim=64, n_lists=10, pq_dim=16, pq_bits=8,
                                  refine_rows=1000)),
        ("ivf_pq_residency", dict(n_rows=1000, dim=64, n_lists=10, pq_dim=64, pq_bits=1,
                                  rabitq=True)),
        ("ivf_flat_residency", dict(n_rows=5000, dim=48, n_lists=16, refine_rows=5000)),
        ("brute_force_residency", dict(n_rows=1000, dim=64, itemsize=2, refine_rows=1000)),
        ("delta_bank_residency", dict(cap=4096, dim=32)),
    ]
    for fn, kw in cases:
        t, j = getattr(hbm_model, fn)("x", **kw), getattr(jhbm, fn)("x", **kw)
        assert t == hbm_model.IndexResidency(j.index_id, j.algo, tuple(
            hbm_model.HbmComponent(**dataclasses.asdict(c)) for c in j.components))
    # CAGRA: the JAX model's dataset and graph, then what the port keeps
    t = hbm_model.cagra_residency("c", n_rows=1000, dim=128, graph_degree=16, init_sample=4096)
    j = jhbm.cagra_residency("c", n_rows=1000, dim=128, graph_degree=16)
    assert [c.name for c in t.components[:2]] == [c.name for c in j.components]
    assert t.by_name("neighbor_table").nbytes == 1000 * 16 * 128 * 2 == 8 * t.by_name(
        "dataset").nbytes
    assert t.by_name("seed_rows[4096]").nbytes == 1000 * 128 * 4


# -- the model of a built port index: every reachable tensor ----------------------------------


@pytest.mark.parametrize("kind", ["nibble", "kmeans_packed", "rabitq"])
def test_ivf_pq_residency_is_every_tensor(data, kind):
    X, Q = data
    kw = {"nibble": dict(pq_dim=8), "kmeans_packed": dict(pq_dim=8, pq_bits=5),
          "rabitq": dict(pq_bits=1)}[kind]
    idx = ivf_pq.build(X, ivf_pq.IvfPqIndexParams(n_lists=8, **kw), res=CPU)
    assert hbm_model.residency_for_index("a", "ivf_pq", idx).total_bytes == walked_nbytes(idx)
    ivf_pq.search(idx, Q, 10, ivf_pq.IvfPqSearchParams(n_probes=4, fused_group=4), mode="fused")
    ivf_pq.search(idx, Q, 10, ivf_pq.IvfPqSearchParams(n_probes=4, fused_group=2), mode="fused")
    res = hbm_model.residency_for_index("a", "ivf_pq", idx, refine_rows=N)
    assert res.required_bytes == walked_nbytes(idx)
    assert res.optional_bytes == X.nbytes
    if kind != "rabitq":  # B2 keeps its group tables a group size
        for g in (2, 4):
            assert res.by_name(f"group_tables[{g}]").required


def test_ivf_flat_and_brute_force_residency_is_every_tensor(data):
    X, Q = data
    idx = ivf_flat.build(X, ivf_flat.IvfFlatIndexParams(n_lists=8), res=CPU)
    assert hbm_model.residency_for_index("f", "ivf_flat", idx).total_bytes == walked_nbytes(idx)
    bf = brute_force.build(X, res=CPU)
    assert hbm_model.residency_for_index("b", "brute_force", bf).total_bytes == walked_nbytes(bf)


def test_sharded_search_copies_are_counted(data):
    """A sharded search's per-shard tensors on the index's own device are
    views (no memory, nothing added); packed codes unpacked for the shards
    are a copy, counted as ``shard_copies``."""
    X, Q = data
    mesh = make_mesh(["cpu"] * 4)
    idx = ivf_flat.build(X, ivf_flat.IvfFlatIndexParams(n_lists=8), res=CPU)
    own = hbm_model.residency_for_index("f", "ivf_flat", idx).total_bytes
    sharded_ivf_flat_search(mesh, idx, Q[:16], 10, ivf_flat.IvfFlatSearchParams(n_probes=4))
    assert hbm_model.residency_for_index("f", "ivf_flat", idx).total_bytes == own == \
        walked_nbytes(idx)
    pq = ivf_pq.build(X, ivf_pq.IvfPqIndexParams(n_lists=8, pq_dim=8, pq_bits=5), res=CPU)
    own = hbm_model.residency_for_index("p", "ivf_pq", pq).total_bytes
    sharded_ivf_pq_lists_search(mesh, pq, Q[:16], 10, ivf_pq.IvfPqSearchParams(n_probes=4))
    res = hbm_model.residency_for_index("p", "ivf_pq", pq)
    copies = res.by_name("shard_copies").nbytes
    assert copies == pq.codes_unpacked().nbytes  # the four shards' views of one allocation
    assert res.total_bytes - copies == own == walked_nbytes(pq, skip=("_shard_cache",))


def test_cagra_residency_counts_the_neighbour_table_and_seeds(data):
    X, Q = data
    cg = cagra.build(X, cagra.CagraIndexParams(intermediate_graph_degree=16, graph_degree=8),
                     res=CPU)
    before = hbm_model.residency_for_index("c", "cagra", cg)
    assert before.total_bytes == walked_nbytes(cg)
    cagra.search(cg, Q, 10, cagra.CagraSearchParams(itopk_size=32, init_sample=512), mode="fused")
    res = hbm_model.residency_for_index("c", "cagra", cg)
    assert res.total_bytes == walked_nbytes(cg)
    table = res.by_name("neighbor_table")
    assert table.required and table.shape == (N, 8, D) and table.itemsize == 2
    assert res.by_name("seed_rows[512]").nbytes == 512 * D * 4
    want = hbm_model.cagra_residency("c", n_rows=N, dim=D, graph_degree=8, init_sample=512)
    assert res.total_bytes == want.total_bytes


@pytest.mark.parametrize("algo", ["ivf_pq", "ivf_flat"])
def test_shared_components_have_the_jax_bytes(data, algo):
    X, _ = data
    if algo == "ivf_pq":
        ji = jpq.build(X, jpq.IvfPqIndexParams(n_lists=8, pq_dim=8, kmeans_n_iters=3))
        buf = io.BytesIO()
        jpq.save(ji, buf)
        ti = ivf_pq.load(io.BytesIO(buf.getvalue()), device="cpu")
    else:
        ji = jflat.build(X, jflat.IvfFlatIndexParams(n_lists=8, kmeans_n_iters=3))
        buf = io.BytesIO()
        jflat.save(ji, buf)
        ti = ivf_flat.load(io.BytesIO(buf.getvalue()), device="cpu")
    j = jhbm.residency_for_index("x", algo, ji, refine_rows=N)
    t = hbm_model.residency_for_index("x", algo, ti, refine_rows=N)
    for c in j.components:
        tc = t.by_name(c.name)
        assert (tc.shape, tc.itemsize, tc.nbytes, tc.required, tc.replicated) == (
            c.shape, c.itemsize, c.nbytes, c.required, c.replicated), c.name
    extra = {c.name for c in t.components} - {c.name for c in j.components}
    assert extra == {"list_sizes", "center_rank"}


# -- the shared-memory model against each wrapper's count ------------------------------------


def test_smem_b1_b2_match_the_wrappers():
    for d in (24, 100, 128, 960, 3072):
        for k in (1, 10, 100, 256):
            for itemsize in (1, 2, 4):
                for cosine in (False, True):
                    plan = ivf_scan.cta_plan(d, k, itemsize, cosine=cosine)
                    for qb in ivf_scan.QUERIES_PER_CTA:
                        for staged in (2, 3):
                            r = smem_model.ivf_scan_residency(qb, d, k, itemsize, plan.qglobal,
                                                              cosine, staged)
                            assert r.total_bytes == ivf_scan.cta_smem_bytes(
                                qb, d, k, itemsize, plan.qglobal, cosine, staged)
                    assert smem_model.ivf_scan_residency(
                        plan.queries, d, k, itemsize, plan.qglobal, cosine,
                        plan.staged).total_bytes == plan.smem_bytes
    for K in (256, 1024, 2048, 4096, 8192):
        for k in (10, 80, 256):
            for g in (1, 4, 8, 32):
                for qb in pq_scan.QUERIES_PER_CTA:
                    r = smem_model.pq_scan_residency(qb, K, k, g)
                    assert r.total_bytes == pq_scan.cta_smem_bytes(qb, K, k, g)


def test_smem_b3_b4_ring_match_the_wrappers():
    for rot_dim in (128, 136, 1544, 3072):
        for k in (10, 80, 256):
            for g in (1, 8):
                plan = rabitq_scan.cta_plan(rot_dim, k, g)
                r = smem_model.rabitq_scan_residency(plan.queries, rot_dim, k, g, plan.rows,
                                                     plan.mode)
                assert r.total_bytes == plan.smem_bytes and r.fits
                for mode, rows in ((0, 128), (1, 64), (2, 64)):
                    assert smem_model.rabitq_scan_residency(16, rot_dim, k, g, rows,
                                                            mode).total_bytes == \
                        rabitq_scan.cta_smem_bytes(16, rot_dim, k, g, rows, mode)
    for itopk, width, deg, d in ((64, 1, 16, 128), (128, 8, 16, 128), (256, 16, 32, 100),
                                 (64, 4, 32, 960)):
        for esize in (2, 4):
            for nq in (1, 128, 1024):
                p = cagra_search.launch_plan(itopk, width, deg, d, esize, nq, 132)
                r = smem_model.cagra_search_residency(itopk, width, deg, d, esize, p.group_rows,
                                                      p.buffers, p.bitonic)
                assert r.total_bytes == p.smem_bytes
            for bitonic in (False, True):
                assert smem_model.cagra_search_residency(
                    itopk, width, deg, d, esize, 8, 2, bitonic).total_bytes == \
                    cagra_search.smem_bytes(itopk, width, deg, d, esize, 8, 2, bitonic)
    for n in (1, 2, 4, 8):
        for w in (10, 80, 256):
            warps = ring_topk.onecard_warps(n, w)
            assert smem_model.ring_onecard_residency(n, w, warps).total_bytes == \
                ring_topk.onecard_smem_bytes(n, w, warps)
            assert smem_model.hop_merge_residency(w).total_bytes == \
                ring_topk.onecard_smem_bytes(0, w, 1)


def test_main_path_residencies_fit_and_name_their_exports():
    rows = smem_model.main_path_residencies()
    assert [r.kernel for r, _ in rows] == [
        "fused_list_topk", "fused_pq_topk", "fused_rabitq_topk", "cagra_fused_search",
        "hop_merge", "fused_ring_topk", "fused_scan_ring_topk"]
    for r, export in rows:
        assert r.fits and r.ctas_per_sm >= 1 and export[0].endswith("smem_bytes")
        assert r.table().splitlines()[-1].startswith(r.kernel)


# -- staging and three-level placement accounting (tests/test_tiered.py:872-955) -------------


def test_replicated_components_cost_full_per_shard():
    rep = hbm_model.HbmComponent("centers", (128, 64), 4, replicated=True)
    shd = hbm_model.HbmComponent("codes", (128, 64), 4)
    assert rep.per_shard_bytes(8) == rep.nbytes
    assert shd.per_shard_bytes(8) == -(-shd.nbytes // 8)
    assert shd.per_shard_bytes(1) == shd.nbytes


@pytest.mark.parametrize("spill", [False, True])
def test_flat_plan_charges_staging_only_on_spill(spill):
    res = hbm_model.brute_force_residency("r", n_rows=4000, dim=32, refine_rows=4000)
    budget = int(res.required_bytes / 0.9) + 1024 if spill else 1 << 30
    p = hbm_model.plan_placement([res], hbm_budget=budget)
    assert p.spilled("r") == spill
    sh, sd = hbm_model.staging_footprint(32, 4) if spill else (0, 0)
    assert (p.staging_host_bytes, p.staging_device_bytes) == (sh, sd)
    if spill:
        assert p.device_bytes == res.required_bytes + sd
        assert p.host_bytes == res.optional_bytes and "staging" in p.table()


def test_sharded_plan_spills_to_host_then_disk():
    pq = hbm_model.ivf_pq_residency("p", n_rows=100_000, dim=64, n_lists=64, pq_dim=16,
                                    pq_bits=8, refine_rows=100_000)
    resident = hbm_model.plan_placement_sharded([pq], 8, hbm_budget_per_shard=1 << 30)
    assert resident.feasible and not resident.spilled("p")
    assert resident.device_bytes_per_shard == sum(c.per_shard_bytes(8) for c in pq.components)
    req_ps = sum(c.per_shard_bytes(8) for c in pq.components if c.required)
    budget = int(req_ps / 0.9) + (16 << 10)
    p = hbm_model.plan_placement_sharded([pq], 8, hbm_budget_per_shard=budget)
    assert p.feasible and p.tier("p", "raw_vectors") == "host" and p.disk_bytes_per_shard == 0
    raw_ps = pq.by_name("raw_vectors").per_shard_bytes(8)
    sh, _ = hbm_model.staging_footprint(64, 4)
    for host, tier in ((raw_ps + sh, "host"), (raw_ps + sh - 1, "disk"), (1024, "disk")):
        q = hbm_model.plan_placement_sharded([pq], 8, hbm_budget_per_shard=budget,
                                             host_budget_per_shard=host)
        assert q.feasible and q.tier("p", "raw_vectors") == tier
    bad = hbm_model.plan_placement_sharded([pq], 8, hbm_budget_per_shard=1024)
    assert not bad.feasible and "INFEASIBLE" in bad.table()


def test_plan_spills_the_largest_raw_slab_first():
    small = hbm_model.brute_force_residency("small", n_rows=100, dim=32, refine_rows=100)
    big = hbm_model.brute_force_residency("big", n_rows=10_000, dim=32, refine_rows=10_000)
    budget = int((small.required_bytes + big.required_bytes + small.optional_bytes + 1024)
                 / 0.9)
    p = hbm_model.plan_placement([big, small], hbm_budget=budget)
    assert p.feasible and p.tier("small", "raw_vectors") == "device"
    assert p.tier("big", "raw_vectors") == "host" and p.host_bytes == big.optional_bytes
