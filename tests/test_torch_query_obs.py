"""The port's query- and build-path instrumentation against raft_tpu's.

With obs enabled in both packages, the same seeded call runs once in each
(indexes built by raft_tpu and loaded into the port, or the same injected
inputs), and the two registries must hold:

* the same counter, gauge and histogram names with the same labels;
* the same values of the deterministic ones: every counter (calls,
  queries, samples, comms bytes and hops), the gauges, and each
  histogram's count, plus the sum of ``n_probes``,
  ``candidates_per_query``, ``n_iter`` and ``iterations``;
* the same set of span names, each at the same nesting depth.

Left out: the port's own spans and histograms of IVF-Flat's search
(``PORT_SPANS``, ``PORT_HISTOGRAMS``: README, Observability), which the
JAX package does not record; each case that reaches them names them in
its expected spans. Span timings and args (several are trace-time only in JAX:
``traced=True``, tracer shapes), the sums of ``beam_occupancy`` (the two
packages' CAGRA beams drift apart at near ties), and JAX's planner
counters ``plan.*`` (an ``auto`` search counts its decision there; the
planners' counters are compared in ``tests/test_torch_plan.py``).

Brute force's approximate mode and its span ``brute_force.search.approx``
are held in ``tests/test_torch_prims.py``; RaBitQ's dense-scan span
``ivf_pq.search.rabitq_xla`` is held in ``tests/test_torch_rabitq_dense_scan.py``. Several JAX spans and every
``comms.*`` counter are recorded while a program is traced, once per
compiled program; the port records them on every call. Each case here
uses shapes no other test file compiles, so JAX traces afresh and both
record once.
"""
import functools
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from raft_tpu import obs as jobs
from raft_tpu.cluster import kmeans as jkmeans
from raft_tpu.neighbors import brute_force as jbf
from raft_tpu.neighbors import cagra as jcagra
from raft_tpu.neighbors import ivf_flat as jflat
from raft_tpu.neighbors import ivf_pq as jpq
from raft_tpu.neighbors.refine import refine as jrefine
from raft_tpu.ops.pallas import ring_topk as jrt
from raft_tpu.parallel import comms as jcomms
from raft_tpu.parallel import make_mesh as jmake_mesh
from raft_tpu.parallel._compat import shard_map
from raft_tpu_torch import obs as tobs
from raft_tpu_torch.cluster import kmeans as tkmeans
from raft_tpu_torch.core.resources import Resources
from raft_tpu_torch.neighbors import brute_force as tbf
from raft_tpu_torch.neighbors import cagra as tcagra
from raft_tpu_torch.neighbors import ivf_flat as tflat
from raft_tpu_torch.neighbors import ivf_pq as tpq
from raft_tpu_torch.neighbors.refine import refine as trefine
from raft_tpu_torch.ops import ring_topk as trt
from raft_tpu_torch.parallel import comms as tcomms
from raft_tpu_torch.parallel import make_mesh

N, D, NQ = 1300, 24, 19
CPU = Resources(device="cpu")
#: histograms whose sums are deterministic in both packages
EXACT_SUMS = ("n_probes", "candidates_per_query", "n_iter", "iterations")
#: the port's instrumentation of IVF-Flat's search, which JAX lacks
PORT_SPANS = frozenset({"ivf_flat.search", "ivf_flat.search.plan", "ivf_flat.search.host_read",
                        "ivf_flat.search.tables", "ivf_flat.search.scan",
                        "ivf_flat.search.unsort"})
PORT_HISTOGRAMS = ("ivf_flat.search.host_reads", "ivf_flat.fused.")


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(31)
    centers = rng.normal(size=(16, D)).astype(np.float32) * 4
    x = (centers[rng.integers(0, 16, N)] + rng.normal(size=(N, D))).astype(np.float32)
    q = (centers[rng.integers(0, 16, NQ)] + rng.normal(size=(NQ, D))).astype(np.float32)
    return x, q


def _load(jmod, tmod, index):
    buf = io.BytesIO()
    jmod.save(index, buf)
    buf.seek(0)
    return tmod.load(buf, device="cpu")


@pytest.fixture(scope="module")
def pq_pair(data):
    ji = jpq.build(data[0], jpq.IvfPqIndexParams(n_lists=12, pq_dim=6, kmeans_n_iters=3))
    return ji, _load(jpq, tpq, ji)


@pytest.fixture(scope="module")
def flat_pair(data):
    ji = jflat.build(data[0], jflat.IvfFlatIndexParams(n_lists=12))
    return ji, _load(jflat, tflat, ji)


def record(fn, o):
    """Run ``fn`` with ``o``'s registry empty and enabled; return the dump
    (without ``plan.*``) and the (name, depth) set of its spans."""
    reg = o.registry()
    reg.reset()
    o.enable()
    try:
        fn()
        snap = reg.as_dict()
        snap["counters"] = {k: v for k, v in snap["counters"].items()
                            if not k.startswith("plan.")}
        spans = {(s["name"], s["depth"]) for s in reg.spans()}
    finally:
        o.disable()
        reg.reset()
    return snap, spans


def assert_same_obs(jfn, tfn, expect_spans=None):
    """The module docstring's comparison of one call in each package."""
    (j, jspans), (t, tspans) = record(jfn, jobs), record(tfn, tobs)
    assert j["counters"] == t["counters"]
    assert j["gauges"] == t["gauges"]
    shared = {k for k in t["histograms"] if not k.startswith(PORT_HISTOGRAMS)}
    assert j["histograms"].keys() == shared
    for key, jh in j["histograms"].items():
        th = t["histograms"][key]
        assert jh["count"] == th["count"], key
        if key.split("{")[0].rsplit(".", 1)[-1] in EXACT_SUMS:
            assert jh["sum"] == th["sum"], key
    assert jspans == {s for s in tspans if s[0] not in PORT_SPANS}
    if expect_spans is not None:
        assert tspans == expect_spans
    return t


# -- IVF-PQ ---------------------------------------------------------------------------------


def test_ivf_pq_scan_with_refine(data, pq_pair):
    """The scan mode's probe and scan children under the refine's inner
    search, then the refine and its ``refine.refine``."""
    (ji, ti), (x, q) = pq_pair, data
    t = assert_same_obs(
        lambda: jpq.search(ji, q, 5, jpq.IvfPqSearchParams(n_probes=4, refine_ratio=3),
                           mode="scan", dataset=x),
        lambda: tpq.search(ti, q, 5, tpq.IvfPqSearchParams(n_probes=4, refine_ratio=3),
                           mode="scan", dataset=x),
        {("ivf_pq.search", 0), ("ivf_pq.search", 1), ("ivf_pq.search.coarse_probe", 2),
         ("ivf_pq.search.pq_scan", 2), ("ivf_pq.search.refine", 1), ("refine.refine", 2)})
    assert t["counters"]['ivf_pq.search.calls{lut="default",mode="scan"}'] == 1.0
    assert t["histograms"]["ivf_pq.search.refine_candidates_per_query"]["sum"] == 15.0


@pytest.mark.parametrize("lut", [None, "bfloat16"])
def test_ivf_pq_probe(data, pq_pair, lut):
    """The probe mode's ``probe_scan`` a batch (two batches here), and the
    ``lut`` label of the calls counter."""
    (ji, ti), (_, q) = pq_pair, data
    jl = None if lut is None else jnp.bfloat16
    tl = None if lut is None else torch.bfloat16
    t = assert_same_obs(
        lambda: jpq.search(ji, q, 3, jpq.IvfPqSearchParams(n_probes=5, lut_dtype=jl),
                           mode="probe", query_batch=10),
        lambda: tpq.search(ti, q, 3, tpq.IvfPqSearchParams(n_probes=5, lut_dtype=tl),
                           mode="probe", query_batch=10),
        {("ivf_pq.search", 0), ("ivf_pq.search.probe_scan", 1)})
    key = f'ivf_pq.search.calls{{lut="{lut or "default"}",mode="probe"}}'
    assert t["counters"][key] == 1.0


# -- CAGRA ----------------------------------------------------------------------------------


def test_cagra_xla_search(data):
    """``cagra.search`` and a ``xla_batch`` a batch, with the calls,
    queries, iterations, itopk, width and beam occupancy of the call."""
    x, q = data
    graph = np.random.default_rng(4).integers(0, N, (N, 12)).astype(np.int32)
    jc, tc = jcagra.from_graph(x, graph), tcagra.from_graph(x, graph, device="cpu")
    t = assert_same_obs(
        lambda: jcagra.search(jc, q, 4, jcagra.CagraSearchParams(itopk_size=40), mode="xla",
                              query_batch=8),
        lambda: tcagra.search(tc, q, 4, tcagra.CagraSearchParams(itopk_size=40), mode="xla",
                              query_batch=8),
        {("cagra.search", 0), ("cagra.search.xla_batch", 1)})
    assert t["counters"]['cagra.search.calls{mode="xla"}'] == 1.0
    assert t["histograms"]['cagra.search.beam_occupancy{mode="xla"}']["count"] == 3


def test_cagra_build_through_ivf_pq(data):
    """The ``ivf_pq`` build route's three stages: the IVF-PQ build, the
    self-search (an ``ivf_pq.search`` in its scan mode) and the exact
    refine."""
    x = data[0][:700]
    t = assert_same_obs(
        lambda: jcagra.build(x, jcagra.CagraIndexParams(intermediate_graph_degree=14,
                                                        graph_degree=10, build_algo="ivf_pq")),
        lambda: tcagra.build(x, tcagra.CagraIndexParams(intermediate_graph_degree=14,
                                                        graph_degree=10, build_algo="ivf_pq"),
                             res=CPU),
        {("cagra.build.pq_build", 0), ("cagra.build.self_search", 0),
         ("cagra.build.refine", 0), ("ivf_pq.search", 1), ("ivf_pq.search.coarse_probe", 2),
         ("ivf_pq.search.pq_scan", 2), ("refine.refine", 1)})
    assert t["counters"]["refine.refine.queries"] == 700.0


# -- brute force, refine, IVF-Flat refine -----------------------------------------------------


@pytest.mark.parametrize("refine_ratio", [1, 4])
def test_brute_force(data, refine_ratio):
    """The exact search's span and a ``exact_batch`` a query batch; with a
    refine, the inner search, then ``brute_force.search.refine``."""
    x, q = data
    ji, ti = jbf.build(x), tbf.build(x, res=CPU)
    spans = {("brute_force.search", 0), ("brute_force.search.exact_batch", 1)}
    if refine_ratio > 1:
        spans |= {("brute_force.search.refine", 0), ("refine.refine", 1)}
    assert_same_obs(
        lambda: jbf.search(ji, q, 6, query_batch=7, dataset=x, refine_ratio=refine_ratio),
        lambda: tbf.search(ti, q, 6, query_batch=7, dataset=x, refine_ratio=refine_ratio),
        spans)


def test_refine(data):
    x, q = data
    cand = np.random.default_rng(8).integers(-1, N, (NQ, 21)).astype(np.int32)
    t = assert_same_obs(lambda: jrefine(x, q, cand, 5, metric="sqeuclidean"),
                        lambda: trefine(x, q, cand, 5, metric="sqeuclidean"),
                        {("refine.refine", 0)})
    assert t["histograms"]["refine.refine.candidates_per_query"]["sum"] == 21.0


def test_ivf_flat_refine(data, flat_pair):
    (ji, ti), (x, q) = flat_pair, data
    t = assert_same_obs(
        lambda: jflat.search(ji, q, 4, jflat.IvfFlatSearchParams(n_probes=3, refine_ratio=5),
                             dataset=x),
        lambda: tflat.search(ti, q, 4, tflat.IvfFlatSearchParams(n_probes=3, refine_ratio=5),
                             dataset=x),
        {("ivf_flat.search", 0), ("ivf_flat.search.plan", 1), ("ivf_flat.search.refine", 0),
         ("refine.refine", 1)})
    assert t["histograms"]["ivf_flat.search.refine_candidates_per_query"]["sum"] == 20.0


# -- k-means ---------------------------------------------------------------------------------


@pytest.mark.parametrize("init", ["array", "random"])
def test_kmeans_fit(data, init):
    """``kmeans.fit``'s counters and its init and Lloyd spans a trial. From
    given centers both packages walk the same Lloyd steps (``n_iter``
    equal); random draws differ, so two random trials are compared by
    names and counts."""
    x = data[0]
    kw = dict(n_clusters=9, max_iter=6, n_init=1 if init == "array" else 2, seed=3)
    cent = x[:9] if init == "array" else None
    (j, jspans), (t, tspans) = (
        record(lambda: jkmeans.fit(x, jkmeans.KMeansParams(init=init, **kw), centroids=cent),
               jobs),
        record(lambda: tkmeans.fit(x, tkmeans.KMeansParams(init=init, **kw), centroids=cent),
               tobs))
    assert j["counters"] == t["counters"]
    assert j["counters"][f'kmeans.fit.calls{{init="{init}"}}'] == 1.0
    jh, th = j["histograms"]["kmeans.fit.n_iter"], t["histograms"]["kmeans.fit.n_iter"]
    assert jh["count"] == th["count"] == kw["n_init"]
    if init == "array":
        assert jh["sum"] == th["sum"]
    assert jspans == tspans == {("kmeans.fit.init", 0), ("kmeans.fit.lloyd", 0)}


# -- comms --------------------------------------------------------------------------------------


def test_one_all_gather():
    """``comms.allgather.calls`` and ``.bytes`` (one shard's 40 bytes,
    times ``n - 1``) and the ``comms.allgather`` span."""
    n = 3
    x = np.arange(n * 10, dtype=np.float32).reshape(n, 10)
    mesh = jmake_mesh(jax.devices()[:n])
    prog = shard_map(lambda xs: jcomms.allgather(xs), mesh=mesh, in_specs=(P("data"),),
                     out_specs=P(None, "data"), check_vma=False)
    t = assert_same_obs(
        lambda: jax.jit(prog)(jnp.asarray(x)),
        lambda: tcomms.allgather(make_mesh(["cpu"] * n),
                                 [torch.from_numpy(x[r : r + 1]) for r in range(n)]),
        {("comms.allgather", 0)})
    assert t["counters"]['comms.allgather.bytes{axis="data"}'] == 80.0


@pytest.mark.parametrize("scan", [False, True])
def test_one_ring(scan):
    """``comms.ring.hops`` (``2 (n - 1)``), ``comms.ring.bytes`` both ways
    and the ``ring_topk`` span; the ring's hops count no comms verb."""
    n, nq, k = 3, 11, 5
    kc = 9 if scan else k
    rng = np.random.default_rng(6)
    vs = rng.random((n, nq, kc), dtype=np.float32)
    ins = rng.permutation(n * nq * kc).reshape(n, nq, kc).astype(np.int32)
    mesh = jmake_mesh(jax.devices()[:n])
    fn = jrt.scan_ring_topk if scan else jrt.ring_topk

    @functools.partial(shard_map, mesh=mesh, in_specs=(P("data"), P("data")),
                       out_specs=(P(), P()))
    def prog(vb, ib):
        return fn(vb[0], ib[0], k, select_min=True, axis="data", use_fused=False)

    tmesh = make_mesh(["cpu"] * n)
    tfn = trt.scan_ring_topk if scan else trt.ring_topk
    t = assert_same_obs(
        lambda: jax.jit(prog)(jnp.asarray(vs), jnp.asarray(ins)),
        lambda: tfn(tmesh, [torch.from_numpy(v) for v in vs],
                    [torch.from_numpy(i) for i in ins], k),
        {("ring_topk", 0)})
    assert t["counters"]['comms.ring.hops{axis="data"}'] == 4.0


def test_nn_descent_build(data):
    """``nn_descent.build`` and its counters; the iterations to convergence
    depend on each package's own draws, so only their count is compared."""
    from raft_tpu.neighbors import nn_descent as jnn
    from raft_tpu_torch.neighbors import nn_descent as tnn

    x = data[0][:200]
    kw = dict(graph_degree=6, intermediate_graph_degree=8, max_iterations=2)
    (j, jspans), (t, tspans) = (record(lambda: jnn.build(x, jnn.NNDescentParams(**kw)), jobs),
                                record(lambda: tnn.build(x, tnn.NNDescentParams(**kw), res=CPU),
                                       tobs))
    assert j["counters"] == t["counters"] == {"nn_descent.build.calls": 1.0,
                                              "nn_descent.build.rows": 200.0}
    assert j["histograms"].keys() == t["histograms"].keys() == {"nn_descent.build.iterations"}
    assert jspans == tspans == {("nn_descent.build", 0)}
