"""The port's tiered sharded index (``raft_tpu_torch.tiered.sharded``) and the
engine's sharded fall-back to ``tiered_sharded`` against raft_tpu's.

IVF-Flat and IVF-PQ indexes (32 lists, 8 a shard) are built by raft_tpu,
saved and loaded into the port; JAX runs on 4 of the 8 virtual CPU devices,
the port on ``make_mesh(["cpu"] * 4)``. Held here:

* ``ShardedHostTier.from_lists``: the same row ownership and per-shard rows
  as JAX's; ``gather_masked`` with a dead shard masks exactly its
  candidates;
* ``TieredShardedIndex.search`` agrees with JAX's (ids equal up to ties,
  distances ``allclose(rtol=1e-5, atol=1e-4)``: ``assert_search_equal``) and
  equals the port's resident sharded search for ``k * refine_ratio``
  candidates plus the device refine by ``torch.equal``, micro-batch by
  micro-batch: both families, overlapped or not, a partial last
  micro-batch, a health mask, the ``min_coverage`` errors, the
  ``host.fetch`` seam with ``shard=s``; a failed ring or kernel propagates;
* the engine: a sharded registration over budget converts as JAX's does and
  serves the tiered bits, a pre-built ``tiered_sharded`` registration
  serves, a dead host tier degrades coverage, and ``plan_explain`` carries
  the tier label.
"""
import io

import jax
import numpy as np
import pytest
import torch

from raft_tpu.neighbors import ivf_flat as jflat
from raft_tpu.neighbors import ivf_pq as jpq
from raft_tpu.parallel import make_mesh as jmake_mesh
from raft_tpu.serve.engine import ServingEngine as JEngine
from raft_tpu.tiered import ShardedHostTier as JTier
from raft_tpu.tiered import TieredShardedIndex as JTieredSharded
from raft_tpu_torch import obs
from raft_tpu_torch.core.errors import KernelFailure, ShardFailure
from raft_tpu_torch.core.resources import Resources
from raft_tpu_torch.neighbors import ivf_flat as tflat
from raft_tpu_torch.neighbors import ivf_pq as tpq
from raft_tpu_torch.neighbors.refine import refine
from raft_tpu_torch.ops.hbm_model import residency_for_index
from raft_tpu_torch.parallel import make_mesh, sharded_ann
from raft_tpu_torch.robust import faults
from raft_tpu_torch.serve import ServingEngine
from raft_tpu_torch.tiered import ShardedHostTier, TieredShardedIndex
from test_torch_ivf_pq import assert_search_equal

N, D, N_LISTS, SHARDS, K, RATIO, MB = 2048, 16, 32, 4, 10, 4, 64
CPU = Resources(device="cpu")


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(81)
    centers = rng.normal(size=(32, D)).astype(np.float32) * 2
    x = (centers[rng.integers(0, 32, N)] + rng.normal(size=(N, D))).astype(np.float32)
    # 150 queries: two full micro-batches of 64 and a partial one of 22
    q = (centers[rng.integers(0, 32, 150)] + rng.normal(size=(150, D))).astype(np.float32)
    return x, q


def _load(jmod, tmod, index):
    buf = io.BytesIO()
    jmod.save(index, buf)
    buf.seek(0)
    return tmod.load(buf, device="cpu")


@pytest.fixture(scope="module")
def family(data):
    """algo -> (JAX index, port index, JAX params, port params)."""
    x, _ = data
    jf = jflat.build(x, jflat.IvfFlatIndexParams(n_lists=N_LISTS, kmeans_n_iters=4, seed=3))
    jp = jpq.build(x, jpq.IvfPqIndexParams(n_lists=N_LISTS, pq_dim=8, pq_kind="kmeans",
                                           kmeans_n_iters=4, seed=1))
    return {"ivf_flat": (jf, _load(jflat, tflat, jf), jflat.IvfFlatSearchParams(n_probes=6),
                         tflat.IvfFlatSearchParams(n_probes=6)),
            "ivf_pq_lists": (jp, _load(jpq, tpq, jp), jpq.IvfPqSearchParams(n_probes=6),
                             tpq.IvfPqSearchParams(n_probes=6))}


@pytest.fixture(scope="module")
def meshes():
    return jmake_mesh(jax.devices()[:SHARDS]), make_mesh(["cpu"] * SHARDS)


def tiered_pair(family, data, meshes, algo, **kw):
    ji, ti, jp, tp = family[algo]
    jmesh, mesh = meshes
    x, _ = data
    jt = JTieredSharded(jmesh, algo, ji, JTier.from_lists(ji, x, SHARDS), refine_ratio=RATIO,
                        micro_batch=MB, search_params=jp, **kw)
    tt = TieredShardedIndex(mesh, algo, ti, ShardedHostTier.from_lists(ti, x, SHARDS),
                            refine_ratio=RATIO, micro_batch=MB, search_params=tp, **kw)
    return jt, tt


def resident(family, data, meshes, algo, q, health=None, merge_mode="auto", mb=MB):
    """The resident sharded path a micro-batch at a time: the sharded search
    for ``k * RATIO`` candidates, then the device refine."""
    _, ti, _, tp = family[algo]
    search = (sharded_ann.sharded_ivf_flat_search if algo == "ivf_flat"
              else sharded_ann.sharded_ivf_pq_lists_search)
    x = torch.from_numpy(data[0])
    outs = []
    for s in range(0, len(q), mb):
        qb = torch.from_numpy(q[s:s + mb])
        _, cand = search(meshes[1], ti, qb, K * RATIO, tp, health=health, merge_mode=merge_mode)
        outs.append(refine(x, qb, cand, K, metric=ti.metric))
    return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])


def assert_equal(got, want):
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0], want[0])


# -- the sharded host tier ------------------------------------------------------------


def test_from_lists_row_ownership_matches_jax(family, data):
    x, _ = data
    for ji, ti, _, _ in family.values():
        jt, tt = JTier.from_lists(ji, x, SHARDS), ShardedHostTier.from_lists(ti, x, SHARDS)
        np.testing.assert_array_equal(tt.owner, jt.owner)
        np.testing.assert_array_equal(tt.local, jt.local)
        assert tt.n_shards == SHARDS and tt.n_rows == N and tt.dim == D
        assert tt.nbytes == jt.nbytes
        for s in range(SHARDS):
            np.testing.assert_array_equal(tt.stores[s]._data, jt.stores[s]._data)
        # torch data splits the same way
        tt2 = ShardedHostTier.from_lists(ti, torch.from_numpy(x), SHARDS)
        np.testing.assert_array_equal(tt2.owner, jt.owner)


def test_gather_masked_with_a_dead_shard(family, data):
    x, _ = data
    _, ti, _, _ = family["ivf_flat"]
    tier = ShardedHostTier.from_lists(ti, x, SHARDS)
    cand = np.random.default_rng(5).integers(-1, N, (12, 20)).astype(np.int32)
    slab, got, failed = tier.gather_masked(cand)
    assert failed == ()
    np.testing.assert_array_equal(got, cand)
    np.testing.assert_array_equal(slab[cand >= 0], x[cand[cand >= 0]])
    with faults.injected("host.fetch", error=OSError("host down"), match={"shard": 2}):
        slab, got, failed = tier.gather_masked(cand)
    dead = (cand >= 0) & (tier.owner[np.where(cand >= 0, cand, 0)] == 2)
    assert failed == (2,) and dead.any()
    assert (got[dead] == -1).all()
    np.testing.assert_array_equal(got[~dead], cand[~dead])
    live = (got >= 0)
    np.testing.assert_array_equal(slab[live], x[got[live]])


# -- TieredShardedIndex ---------------------------------------------------------------


@pytest.mark.parametrize("algo", ["ivf_flat", "ivf_pq_lists"])
@pytest.mark.parametrize("overlap", [True, False])
def test_search_matches_jax_and_the_resident_path(family, data, meshes, algo, overlap):
    _, q = data
    jt, tt = tiered_pair(family, data, meshes, algo)
    jr = jt.search(q, K, overlap=overlap)
    tr = tt.search(q, K, overlap=overlap)
    assert (tr.coverage, tr.degraded, tr.failed_shards) == (jr.coverage, jr.degraded,
                                                             jr.failed_shards) == (1.0, False, ())
    assert_search_equal(tr.distances, tr.indices, jr.distances, jr.indices)
    assert_equal(tuple(tr), resident(family, data, meshes, algo, q))


def test_the_re_rank_reads_the_tier_s_metric_arg(family, data, meshes, monkeypatch):
    """``metric_arg`` reaches every micro-batch's re-rank, as JAX's
    ``_refine_gathered_impl`` call passes it."""
    from raft_tpu_torch.tiered import sharded as tsharded

    seen, rerank = [], tsharded._exact_rerank
    monkeypatch.setattr(tsharded, "_exact_rerank",
                        lambda *a, **kw: seen.append(kw["metric_arg"]) or rerank(*a, **kw))
    _, tt = tiered_pair(family, data, meshes, "ivf_flat", metric_arg=3.0)
    tt.search(data[1], K, overlap=False)
    assert seen == [3.0] * 3  # 150 queries: micro-batches of 64, 64 and 22


@pytest.mark.parametrize("merge_mode", ["ring", "fused_ring", "gather"])
def test_health_mask_matches_jax_and_the_masked_resident_path(family, data, meshes, merge_mode):
    _, q = data
    health = (True, True, False, True)
    jt, tt = tiered_pair(family, data, meshes, "ivf_pq_lists", merge_mode=merge_mode)
    jr = jt.search(q, K, health=health)
    tr = tt.search(q, K, health=health)
    assert (tr.coverage, tr.degraded, tr.failed_shards) == (jr.coverage, jr.degraded,
                                                             jr.failed_shards) == (0.75, True, (2,))
    assert_search_equal(tr.distances, tr.indices, jr.distances, jr.indices)
    assert_equal(tuple(tr), resident(family, data, meshes, "ivf_pq_lists", q, health=health,
                                     merge_mode=merge_mode))


def test_min_coverage_errors(family, data, meshes):
    _, q = data
    jt, tt = tiered_pair(family, data, meshes, "ivf_flat")
    for idx in (jt, tt):
        with pytest.raises(Exception, match="all 4 shards unhealthy"):
            idx.search(q, K, health=(False,) * 4)
        with pytest.raises(Exception, match="below required 0.90"):
            idx.search(q, K, health=(True, True, True, False), min_coverage=0.9)
    with pytest.raises(ShardFailure):
        tt.search(q, K, health=(True, True, True, False), min_coverage=0.9)
    # a dead host tier counts against the floor after the gather
    with faults.injected("host.fetch", error=OSError("host down"), match={"shard": 1}):
        with pytest.raises(ShardFailure, match=r"failed shards: \(1,\)"):
            tt.search(q, K, min_coverage=0.8)


def test_dead_host_tier_degrades_as_jax(family, data, meshes):
    """``host.fetch`` killed on shard 1 only (``match={"shard": 1}``): the
    batch keeps the other shards' candidates, as JAX's; no id of shard 1's
    lists comes back."""
    _, q = data
    jt, tt = tiered_pair(family, data, meshes, "ivf_flat")
    from raft_tpu.robust import faults as jfaults

    for f in (faults, jfaults):
        f.enable()
        f.install("host.fetch", OSError("host down"), match={"shard": 1})
    try:
        jr = jt.search(q, K)
        tr = tt.search(q, K)
    finally:
        for f in (faults, jfaults):
            f.clear()
            f.disable()
    assert (tr.coverage, tr.degraded, tr.failed_shards) == (jr.coverage, jr.degraded,
                                                             jr.failed_shards) == (0.75, True, (1,))
    assert_search_equal(tr.distances, tr.indices, jr.distances, jr.indices)
    ids = tr.indices.numpy()
    assert not (tt.tier.owner[ids[ids >= 0]] == 1).any()


def test_obs_counters_and_spans(family, data, meshes):
    _, q = data
    _, tt = tiered_pair(family, data, meshes, "ivf_flat")
    reg = obs.registry()
    reg.reset()
    obs.enable()
    try:
        tt.search(q, K, health=(True, False, True, True))
        snap = reg.as_dict()
        names = {s["name"] for s in reg.spans()}
    finally:
        obs.disable()
        reg.reset()
    c = snap["counters"]
    assert c['tiered.search.calls{algo="sharded_ivf_flat"}'] == 1.0
    assert c["tiered.search.queries"] == 150.0
    assert c['robust.degraded_queries{algo="tiered_ivf_flat"}'] == 1.0
    assert snap["gauges"]['robust.shards_healthy{algo="tiered_ivf_flat"}'] == 3.0
    assert "tiered.overlap_efficiency" in snap["gauges"]
    assert {"tiered.sharded.search", "tiered.refine", "host.fetch"} <= names


@pytest.mark.parametrize("merge_mode", ["ring", "fused_ring"])
def test_a_failed_ring_propagates(family, data, meshes, merge_mode):
    """No fallback: an error injected at ``comms.ring_topk`` comes out of
    the tiered sharded search as the ``KernelFailure`` it is."""
    _, q = data
    _, tt = tiered_pair(family, data, meshes, "ivf_flat", merge_mode=merge_mode)
    with faults.injected("comms.ring_topk", error=KernelFailure("chaos")):
        with pytest.raises(KernelFailure):
            tt.search(q, K)


def test_checks(family, data, meshes):
    x, _ = data
    _, ti, _, tp = family["ivf_flat"]
    tier = ShardedHostTier.from_lists(ti, x, SHARDS)
    with pytest.raises(Exception, match="tier has 4 shards for a 2-shard mesh"):
        TieredShardedIndex(make_mesh(["cpu"] * 2), "ivf_flat", ti, tier)
    with pytest.raises(Exception, match="tiered sharded algo"):
        TieredShardedIndex(meshes[1], "cagra", ti, tier)
    with pytest.raises(Exception, match="not divisible"):
        ShardedHostTier.from_lists(ti, x, 3)


# -- the engine -----------------------------------------------------------------------


def _served(eng, index_id, q, rows):
    futs = eng.submit_many(index_id, q, K, request_rows=rows)
    eng.run_until_idle()
    return [f.result() for f in futs]


def spill_budget(index):
    res = residency_for_index("s", "ivf_pq", index, refine_rows=N)
    return int(sum(c.per_shard_bytes(SHARDS) for c in res.components if c.required) / 0.9) + 1024


def test_engine_converts_over_budget_and_serves_the_tiered_bits(family, data, meshes):
    x, q = data
    ji, ti, jp, tp = family["ivf_pq_lists"]
    budget = spill_budget(ti)
    jeng = JEngine(max_batch=32, max_wait_ms=0.0, hbm_budget_bytes=budget)
    jeng.register("s", "sharded_ivf_pq_lists", ji, params=jp, mesh=meshes[0], dataset=x,
                  refine_ratio=RATIO)
    eng = ServingEngine(max_batch=32, max_wait_ms=0.0, res=CPU, hbm_budget_bytes=budget)
    reg = obs.registry()
    reg.reset()
    obs.enable()
    try:
        eng.register("s", "sharded_ivf_pq_lists", ti, params=tp, mesh=meshes[1],
                     dataset=torch.from_numpy(x), refine_ratio=RATIO, merge_mode="ring")
        degrades = reg.as_dict()["counters"]
    finally:
        obs.disable()
        reg.reset()
    assert degrades['serve.tiered_degrades{algo="sharded_ivf_pq_lists",index_id="s"}'] == 1.0
    r = eng._indexes["s"]
    assert r.algo == jeng._indexes["s"].algo == "tiered_sharded"
    assert isinstance(r.index, TieredShardedIndex) and r.index.refine_ratio == RATIO
    assert "refine_ratio" not in r.search_kwargs and r.index.merge_mode == "ring"
    eng.warmup("s", K)
    got = _served(eng, "s", q[:64], rows=32)
    jgot = _served(jeng, "s", q[:64], rows=32)
    for b, (res, jres) in enumerate(zip(got, jgot)):
        want = r.index.search(q[b * 32:(b + 1) * 32], K)
        np.testing.assert_array_equal(res.indices, want.indices.numpy())
        np.testing.assert_array_equal(res.distances, want.distances.numpy())
        assert res.coverage == jres.coverage == 1.0
        assert_search_equal(torch.from_numpy(res.distances), torch.from_numpy(res.indices),
                            jres.distances, jres.indices)
    text = eng.plan_explain("s")
    assert eng._tier_label(r) == "tiered_sharded" and "tiered_sharded" in text


def test_engine_serves_a_prebuilt_tiered_sharded_index(family, data, meshes):
    """Mesh and axis come from the index; shard 2's probe fails through
    ``sharded_ann.shard_scan`` and shard 0's host tier through
    ``host.fetch``: coverage 0.5, both reported; a ``min_coverage`` floor
    fails the futures typed."""
    _, q = data
    _, tt = tiered_pair(family, data, meshes, "ivf_flat")
    eng = ServingEngine(max_batch=32, max_wait_ms=0.0, res=CPU)
    eng.register("t", "tiered_sharded", tt)
    assert eng._indexes["t"].mesh is meshes[1] and eng._indexes["t"].mode == "sharded"
    out = _served(eng, "t", q[:32], rows=32)[0]
    want = tt.search(q[:32], K)
    np.testing.assert_array_equal(out.indices, want.indices.numpy())
    np.testing.assert_array_equal(out.distances, want.distances.numpy())
    faults.enable()
    faults.install("sharded_ann.shard_scan", ShardFailure("down", shard=2), match={"shard": 2})
    faults.install("host.fetch", OSError("host down"), match={"shard": 0})
    try:
        out = _served(eng, "t", q[:32], rows=32)[0]
        assert (out.coverage, out.degraded, out.failed_shards) == (0.5, True, (0, 2))
        ids = out.indices[out.indices >= 0]
        assert not np.isin(tt.tier.owner[ids], (0, 2)).any()
        eng.register("f", "tiered_sharded", tt, min_coverage=0.9)
        futs = eng.submit_many("f", q[:4], K, request_rows=2)
        eng.run_until_idle()
        for f in futs:
            with pytest.raises(ShardFailure):
                f.result()
    finally:
        faults.clear()
        faults.disable()
    assert eng._tier_label(eng._indexes["t"]) == "tiered_sharded"
