"""Degraded sharded search and the engine's degraded serving against
raft_tpu (``tests/test_robust.py::TestDegradedSearch`` and
``tests/test_serve.py``'s degraded-serving cases, run in both packages).

JAX runs on a 4-device mesh of the 8 virtual CPU devices, the port on
``make_mesh(["cpu"] * 4)``, over an IVF-Flat and an IVF-PQ index built by
raft_tpu and loaded into the port (16 lists, ``n_probes=5``, k = 8: no
cache entry of another file's JAX sharded programs).

Bars: inside the port, an all-healthy degraded search is bit for bit the
undegraded sharded search, and a masked one the search with the same
``health``, whatever ``merge_mode``. Across packages: coverage, the
``degraded`` flag, the failed shards, the typed errors and the counters
are equal; ids equal on >= 0.99 of the slots, the top-1 id and every
``-1`` slot equal, distances allclose(rtol=1e-5, atol=1e-4) where the ids
agree (the two packages add each score in another order).
"""
import io

import numpy as np
import pytest
import torch

from raft_tpu import obs as jobs
from raft_tpu.core import errors as jerrors
from raft_tpu.neighbors import ivf_flat as jflat
from raft_tpu.neighbors import ivf_pq as jpq
from raft_tpu.parallel import make_mesh as jmake_mesh
from raft_tpu.robust import degrade as jdegrade
from raft_tpu.robust import faults as jfaults
from raft_tpu.serve import ServingEngine as JEngine
from raft_tpu_torch import obs as tobs
from raft_tpu_torch.core import errors as terrors
from raft_tpu_torch.core.resources import Resources
from raft_tpu_torch.neighbors import ivf_flat as tflat
from raft_tpu_torch.neighbors import ivf_pq as tpq
from raft_tpu_torch.parallel import make_mesh, sharded_ivf_flat_search, sharded_ivf_pq_lists_search
from raft_tpu_torch.robust import degrade as tdegrade
from raft_tpu_torch.robust import faults as tfaults
from raft_tpu_torch.serve import ServingEngine as TEngine

N, D, N_LISTS, NQ, K, N_PROBES = 2400, 16, 16, 30, 8, 5
CPU = Resources(device="cpu")
MODES = ("ring", "fused_ring", "gather")


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(71)
    centers = rng.normal(size=(24, D)).astype(np.float32) * 3
    x = (centers[rng.integers(0, 24, N)] + rng.normal(size=(N, D))).astype(np.float32)
    q = (centers[rng.integers(0, 24, NQ)] + rng.normal(size=(NQ, D))).astype(np.float32)
    return x, q


def _load(jmod, tmod, index):
    buf = io.BytesIO()
    jmod.save(index, buf)
    buf.seek(0)
    return tmod.load(buf, device="cpu")


@pytest.fixture(scope="module")
def pairs(corpus):
    jf = jflat.build(corpus[0], jflat.IvfFlatIndexParams(n_lists=N_LISTS))
    jp = jpq.build(corpus[0], jpq.IvfPqIndexParams(n_lists=N_LISTS, pq_dim=8, kmeans_n_iters=4))
    return {"ivf_flat": (jf, _load(jflat, tflat, jf)),
            "ivf_pq_lists": (jp, _load(jpq, tpq, jp))}


@pytest.fixture(scope="module")
def meshes(eight_devices):
    return jmake_mesh(eight_devices[:4]), make_mesh(["cpu"] * 4)


@pytest.fixture
def both():
    """Both obs registries empty and enabled, both fault registries empty;
    restored after."""
    for o in (jobs, tobs):
        o.registry().reset()
        o.enable()
    yield
    for o, f in ((jobs, jfaults), (tobs, tfaults)):
        o.disable()
        o.registry().reset()
        f.clear()
        f.disable()


class inject:
    """The same spec in both packages (errors made per package)."""

    def __init__(self, point, error=None, **kw):
        self.specs = [(f, point, error(e) if error else None, kw)
                      for f, e in ((jfaults, jerrors), (tfaults, terrors))]

    def __enter__(self):
        for f, point, err, kw in self.specs:
            f.enable()
            f.install(point, err, **kw)
        return self

    def __exit__(self, *exc):
        for f, *_ in self.specs:
            f.clear()
            f.disable()
        return False


def shard_down(s):
    return dict(error=lambda e: e.ShardFailure("chaos", shard=s), match={"shard": s})


def counters(o, prefix=("robust.", "serve.coverage", "serve.slow_shards", "faults.")) -> dict:
    d = o.registry().as_dict()
    return {k: v for part in ("counters", "gauges") for k, v in d[part].items()
            if k.startswith(prefix)}


def assert_close_to_jax(t, j):
    (td, ti), (jd, ji) = (tuple(np.asarray(x) for x in r) for r in (t, j))
    assert ti.shape == ji.shape
    same = ti == ji
    assert same.mean() >= 0.99, same.mean()
    assert (ti[:, 0] == ji[:, 0]).all()
    np.testing.assert_array_equal(ti < 0, ji < 0)
    np.testing.assert_allclose(td[same], jd[same], rtol=1e-5, atol=1e-4)


def assert_bit_equal(a, b):
    assert torch.equal(a[1], b[1])
    assert torch.equal(a[0].view(torch.int32), b[0].view(torch.int32))


_SEARCH = {"ivf_flat": sharded_ivf_flat_search, "ivf_pq_lists": sharded_ivf_pq_lists_search}


# -- sharded_search_degraded -------------------------------------------------------------------


@pytest.mark.parametrize("algo", ["ivf_flat", "ivf_pq_lists"])
def test_all_healthy_is_the_undegraded_search(both, corpus, pairs, meshes, algo):
    (ji, ti), (jm, tm), q = pairs[algo], meshes, corpus[1]
    j = jdegrade.sharded_search_degraded(jm, ji, q, K, algo=algo, n_probes=N_PROBES,
                                         merge_mode="ring")
    t = tdegrade.sharded_search_degraded(tm, ti, q, K, algo=algo, n_probes=N_PROBES,
                                         merge_mode="ring")
    assert (t.coverage, t.degraded, t.failed_shards) == (j.coverage, j.degraded,
                                                         j.failed_shards) == (1.0, False, ())
    d, i = t  # unpacks like (distances, indices)
    assert_bit_equal((d, i), _SEARCH[algo](tm, ti, q, K, n_probes=N_PROBES, merge_mode="ring"))
    assert_close_to_jax(t, j)
    assert counters(jobs) == counters(tobs)


@pytest.mark.parametrize("merge_mode", MODES)
@pytest.mark.parametrize("algo", ["ivf_flat", "ivf_pq_lists"])
def test_one_shard_lost(both, corpus, pairs, meshes, algo, merge_mode):
    """Shard 1 fails its probe: coverage 0.75 from the other three, JAX's
    ids, and the port's answer bit for bit the masked search's."""
    (ji, ti), (jm, tm), q = pairs[algo], meshes, corpus[1]
    with inject("sharded_ann.shard_scan", **shard_down(1)):
        j = jdegrade.sharded_search_degraded(jm, ji, q, K, algo=algo, n_probes=N_PROBES,
                                             merge_mode=merge_mode)
        t = tdegrade.sharded_search_degraded(tm, ti, q, K, algo=algo, n_probes=N_PROBES,
                                             merge_mode=merge_mode)
    assert (t.coverage, t.degraded, t.failed_shards) == (j.coverage, j.degraded,
                                                         j.failed_shards) == (0.75, True, (1,))
    want = _SEARCH[algo](tm, ti, q, K, n_probes=N_PROBES, merge_mode=merge_mode,
                         health=(True, False, True, True))
    assert_bit_equal(tuple(t), want)
    assert_close_to_jax(t, j)
    assert counters(jobs) == counters(tobs)
    assert counters(tobs)[f'robust.degraded_queries{{algo="{algo}"}}'] == 1.0


@pytest.mark.parametrize("merge_mode", MODES)
def test_one_healthy_shard_with_short_lists_gives_jax_s_empty_slots(both, corpus, pairs, meshes,
                                                                    merge_mode):
    """Three shards down and one probed list a query: many rows have fewer
    than k candidates, and both packages return ``-1`` (distance ``inf``)
    in the same slots for every exchange."""
    (ji, ti), (jm, tm), q = pairs["ivf_flat"], meshes, corpus[1]
    health = (False, False, True, False)
    j = jdegrade.sharded_search_degraded(jm, ji, q, K, n_probes=1, health=health,
                                         merge_mode=merge_mode)
    t = tdegrade.sharded_search_degraded(tm, ti, q, K, n_probes=1, health=health,
                                         merge_mode=merge_mode)
    assert t.coverage == j.coverage == 0.25
    ids = t.indices.numpy()
    assert (ids < 0).any() and (ids >= 0).any()
    np.testing.assert_array_equal(ids, np.asarray(j.indices))
    assert np.isinf(t.distances.numpy()[ids < 0]).all()
    assert np.isinf(np.asarray(j.distances)[ids < 0]).all()


def test_all_shards_down_raises(both, corpus, pairs, meshes):
    (ji, ti), (jm, tm), q = pairs["ivf_flat"], meshes, corpus[1]
    with pytest.raises(jerrors.ShardFailure):
        jdegrade.sharded_search_degraded(jm, ji, q, K, health=(False,) * 4, n_probes=N_PROBES)
    with pytest.raises(terrors.ShardFailure):
        tdegrade.sharded_search_degraded(tm, ti, q, K, health=(False,) * 4, n_probes=N_PROBES)
    assert counters(jobs) == counters(tobs) == {'robust.queries_failed{algo="ivf_flat"}': 1.0}


@pytest.mark.parametrize("merge_mode", ["ring", "gather"])
def test_min_coverage_enforced(both, corpus, pairs, meshes, merge_mode):
    (ji, ti), (jm, tm), q = pairs["ivf_flat"], meshes, corpus[1]
    kw = dict(health=(True, False, True, True), min_coverage=0.9, n_probes=N_PROBES,
              merge_mode=merge_mode)
    with pytest.raises(jerrors.ShardFailure):
        jdegrade.sharded_search_degraded(jm, ji, q, K, **kw)
    with pytest.raises(terrors.ShardFailure) as e:
        tdegrade.sharded_search_degraded(tm, ti, q, K, **kw)
    assert e.value.shard == 1
    assert counters(jobs) == counters(tobs)


def test_explicit_health_mask_skips_the_probe(both, corpus, pairs, meshes):
    """A spec that would fail shard 0 is never evaluated when ``health`` is
    given: no firing in either package, full coverage."""
    (ji, ti), (jm, tm), q = pairs["ivf_flat"], meshes, corpus[1]
    with inject("sharded_ann.shard_scan", **shard_down(0)):
        j = jdegrade.sharded_search_degraded(jm, ji, q, K, health=(True,) * 4,
                                             n_probes=N_PROBES)
        t = tdegrade.sharded_search_degraded(tm, ti, q, K, health=(True,) * 4,
                                             n_probes=N_PROBES)
    assert t.coverage == j.coverage == 1.0
    assert counters(jobs) == counters(tobs) == {'robust.shards_healthy{algo="ivf_flat"}': 4.0}


# -- the engine ----------------------------------------------------------------------------


def engines(pairs, meshes, merge_mode, **reg):
    """A JAX and a port engine, each with the sharded IVF-Flat index as
    ``shards`` and the single-device one as ``flat``."""
    (ji, ti), (jm, tm) = pairs["ivf_flat"], meshes
    j = JEngine(max_batch=16, max_wait_ms=0.0, queue_capacity=256, slow_shard_s=0.02)
    t = TEngine(max_batch=16, max_wait_ms=0.0, queue_capacity=256, slow_shard_s=0.02, res=CPU)
    for eng, idx, mesh in ((j, ji, jm), (t, ti, tm)):
        eng.register("shards", "sharded_ivf_flat", idx, mesh=mesh, n_probes=N_PROBES,
                     merge_mode=merge_mode, **reg)
        eng.register("flat", "ivf_flat", idx, n_probes=N_PROBES)
    return j, t


def serve(eng, index_id, q):
    fut = eng.submit(index_id, q, k=K)
    eng.run_until_idle()
    return fut


@pytest.mark.parametrize("merge_mode", ["ring", "gather"])
def test_engine_failed_and_slow_shards(both, corpus, pairs, meshes, merge_mode):
    """Healthy, one failed shard, one slow shard (a probe of 50 ms against
    ``slow_shard_s`` of 20 ms): the same coverage, flag, failed shards and
    counters (``serve.slow_shards``, ``serve.coverage``) in both engines."""
    q = corpus[1][:5]
    j, t = engines(pairs, meshes, merge_mode)
    cases = [({}, (1.0, False, ())),
             (shard_down(1), (0.75, True, (1,))),
             (dict(latency_s=0.05, match={"shard": 2}), (0.75, True, (2,)))]
    for spec, want in cases:
        with inject("sharded_ann.shard_scan", **spec):
            jr, tr = serve(j, "shards", q).result(), serve(t, "shards", q).result()
        assert (tr.coverage, tr.degraded, tr.failed_shards) == want
        assert (jr.coverage, jr.degraded, jr.failed_shards) == want
        assert_close_to_jax(tr, jr)
        assert counters(jobs) == counters(tobs)
    assert counters(tobs)['serve.slow_shards{index_id="shards",shard="2"}'] == 1.0


@pytest.mark.parametrize("merge_mode", ["ring", "gather"])
def test_engine_min_coverage_fails_typed_and_keeps_serving(both, corpus, pairs, meshes,
                                                           merge_mode):
    q = corpus[1][:4]
    j, t = engines(pairs, meshes, merge_mode, min_coverage=0.9)
    with inject("sharded_ann.shard_scan", **shard_down(0)):
        jf, tf = serve(j, "shards", q), serve(t, "shards", q)
        assert isinstance(jf.exception(), jerrors.ShardFailure)
        assert isinstance(tf.exception(), terrors.ShardFailure)
        jr, tr = serve(j, "flat", q).result(), serve(t, "flat", q).result()
    assert tr.coverage == jr.coverage == 1.0
    assert_close_to_jax(tr, jr)
    key = 'serve.dispatch_errors{index_id="shards",kind="ShardFailure"}'
    jc, tc = jobs.registry().as_dict()["counters"], tobs.registry().as_dict()["counters"]
    assert jc[key] == tc[key] == 1.0


def test_engine_health_has_jax_s_keys(both, corpus, pairs, meshes):
    j, t = engines(pairs, meshes, "ring")
    for eng in (j, t):
        serve(eng, "shards", corpus[1][:3])
        serve(eng, "flat", corpus[1][:3])
    jh, th = j.health(), t.health()

    def keys(d):
        return {k: keys(v) if isinstance(v, dict) else None for k, v in d.items()}

    assert keys(th) == keys(jh)
    assert th["queue"] == jh["queue"]
    assert th["obs"] == jh["obs"]
    for index_id, entry in th["indexes"].items():
        assert entry == jh["indexes"][index_id]
        assert entry["slo"] is None


def test_every_request_carries_a_distinct_trace_id(both, corpus, pairs, meshes):
    """With obs on, each completed request has its own trace ID, its
    ``serve.queue`` span and the batch's dispatch span carry it; with obs
    off the ID is ``""``."""
    _, t = engines(pairs, meshes, "ring")
    futs = t.submit_many("shards", corpus[1][:12], K, request_rows=2)
    t.run_until_idle()
    ids = [f.result().trace_id for f in futs]
    assert all(ids) and len(set(ids)) == len(ids)
    spans = tobs.registry().spans()
    queued = {s["trace"][0] for s in spans if s["name"] == "serve.queue"}
    assert queued == set(ids)
    dispatched = {tid for s in spans if s["name"] == "serve.dispatch" for tid in s["trace"]}
    assert dispatched == set(ids)
    degraded = [s for s in spans if s["name"] == "robust.degraded_search"]
    assert degraded and all(s["trace"] for s in degraded)
    tobs.disable()
    assert serve(t, "shards", corpus[1][:2]).result().trace_id == ""
