"""The epsilon neighbourhood, random ball cover and hnsw interop of
raft_tpu_torch against raft_tpu on the same numpy inputs.

- ``eps_neighbors``: ``adj`` and ``vd`` equal, with ``eps`` at least
  1e-4 * eps away from every pairwise distance.
- ``ball_cover``: ``build``'s landmarks, assignments and ``group_rows``
  equal to JAX's (the same numpy draw), ``radii`` and ``landmark_dists``
  allclose at 1e-6 (the expanded L2 metrics: atol 4 f32 epsilons of the
  largest squared norm, its square root for ``L2SqrtExpanded``); ``knn_query`` at ``n_probes=0`` and probed, under
  Haversine and the L2 family: ids equal to JAX's and to an exact tiled
  ``pairwise_distance`` + ``select_k``, distances allclose (rtol 1e-5,
  atol 1e-6); ``eps_query`` equal; a JAX-built index carried over by
  ``from_numpy`` searches to the same ids.
- ``hnsw``: a CAGRA index built by JAX, loaded through the v4 envelope,
  writes the same hnswlib bytes; the port's ``load_hnswlib`` of JAX's file
  gives JAX's dataset, graph and entry point; ``search`` ids agree with
  JAX's at ``tests/test_torch_cagra.py``'s CAGRA tolerance (>= 0.99 of the
  slots, top-1 equal, distances allclose where ids agree); with obs on,
  the span and counter names are JAX's.
"""
import io

import numpy as np
import pytest
import torch

from raft_tpu import obs as jobs
from raft_tpu.neighbors import ball_cover as jbc
from raft_tpu.neighbors import cagra as jcagra
from raft_tpu.neighbors import eps_neighbors as jeps
from raft_tpu.neighbors import hnsw as jhnsw
from raft_tpu_torch import obs as tobs
from raft_tpu_torch.core.resources import Resources
from raft_tpu_torch.neighbors import ball_cover as tbc
from raft_tpu_torch.neighbors import cagra as tcagra
from raft_tpu_torch.neighbors import eps_neighbors as teps
from raft_tpu_torch.neighbors import hnsw as thnsw
from raft_tpu_torch.ops.distance import DistanceType, pairwise_distance
from raft_tpu_torch.ops.select_k import running_merge, select_k

CPU = Resources(device="cpu")
BC_METRICS = [DistanceType.Haversine, DistanceType.L2Expanded, DistanceType.L2SqrtExpanded,
              DistanceType.L2SqrtUnexpanded]


def _geo(seed, n, groups=24):
    """Clustered (lat, lon) radians, or 3-D points for the L2 family."""
    rng = np.random.default_rng(seed)
    c = np.stack([rng.uniform(-1.2, 1.2, groups), rng.uniform(-3.0, 3.0, groups)], 1)
    return (c[rng.integers(0, groups, n)] + 0.05 * rng.standard_normal((n, 2))).astype(np.float32)


def _points(metric, seed, n):
    if metric == DistanceType.Haversine:
        return _geo(seed, n)
    rng = np.random.default_rng(seed)
    c = 5.0 * rng.standard_normal((20, 3))
    return (c[rng.integers(0, 20, n)] + 0.3 * rng.standard_normal((n, 3))).astype(np.float32)


# -- eps_neighbors -----------------------------------------------------------------------------


def _eps_away(d, rel=1e-4):
    """An eps near the median of ``d`` with no entry within ``rel * eps``."""
    flat = np.sort(d.ravel())
    i = flat.shape[0] // 2
    while True:
        eps = 0.5 * (flat[i] + flat[i + 1])
        if np.abs(flat - eps).min() > rel * eps:
            return float(eps)
        i += 1


@pytest.mark.parametrize("metric", ["sqeuclidean", "euclidean", "cosine"])
@pytest.mark.parametrize("block", [4096, 7])
def test_eps_neighbors_matches_jax(metric, block):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((60, 6)).astype(np.float32)
    y = rng.standard_normal((90, 6)).astype(np.float32)
    eps = _eps_away(pairwise_distance(torch.from_numpy(x).double(), torch.from_numpy(y).double(),
                                      metric).numpy())
    jadj, jvd = jeps(x, y, eps, metric=metric, block=block)
    tadj, tvd = teps(x, torch.from_numpy(y), eps, metric=metric, block=block)
    assert tadj.dtype == torch.bool and tvd.dtype == torch.int32
    np.testing.assert_array_equal(tadj.numpy(), np.asarray(jadj))
    np.testing.assert_array_equal(tvd.numpy(), np.asarray(jvd))
    assert 0 < int(tvd.sum()) < x.shape[0] * y.shape[0]


# -- ball cover --------------------------------------------------------------------------------


def _exact(points, queries, k, metric, block=97):
    """Tiled ``pairwise_distance`` + ``select_k`` with a running merge."""
    qt = torch.from_numpy(queries)
    acc_v = torch.full((qt.shape[0], k), float("inf"))
    acc_i = torch.full((qt.shape[0], k), -1, dtype=torch.int32)
    for s in range(0, points.shape[0], block):
        d = pairwise_distance(qt, torch.from_numpy(points[s : s + block]), metric)
        ids = (s + torch.arange(d.shape[1], dtype=torch.int32))[None, :].expand_as(d)
        v, i = select_k(d, min(k, d.shape[1]), indices=ids)
        acc_v, acc_i = running_merge(acc_v, acc_i, v, i)
    return acc_v, acc_i


@pytest.fixture(scope="module")
def bc_pairs():
    out = {}
    for metric in BC_METRICS:
        X = _points(metric, 5, 1500)
        out[metric] = (X, jbc.build(X, metric=metric, seed=3),
                       tbc.build(X, metric=metric, seed=3, device="cpu"))
    return out


@pytest.mark.parametrize("metric", BC_METRICS, ids=lambda m: m.name)
def test_ball_cover_build_is_jax_s(bc_pairs, metric):
    X, ji, ti = bc_pairs[metric]
    assert ti.n_landmarks == ji.n_landmarks == int(np.sqrt(X.shape[0])) and ti.size == ji.size
    np.testing.assert_array_equal(ti.landmarks.numpy(), np.asarray(ji.landmarks))
    np.testing.assert_array_equal(ti.assignments.numpy(), np.asarray(ji.assignments))
    np.testing.assert_array_equal(ti.group_rows.numpy(), np.asarray(ji.group_rows))
    atol = 1e-6
    if metric in (DistanceType.L2Expanded, DistanceType.L2SqrtExpanded):
        # |x|^2 + |l|^2 - 2 x.l in f32: an absolute error of a few epsilons
        # of the squared norms, which the square root of a near-zero value
        # (a landmark's own row) raises to its square root
        atol = 4 * np.finfo(np.float32).eps * float((X * X).sum(1).max())
        if metric == DistanceType.L2SqrtExpanded:
            atol = float(np.sqrt(atol))
    np.testing.assert_allclose(ti.landmark_dists.numpy(), np.asarray(ji.landmark_dists),
                               rtol=1e-6, atol=atol)
    np.testing.assert_allclose(ti.radii.numpy(), np.asarray(ji.radii), rtol=1e-6, atol=atol)


@pytest.mark.parametrize("n_probes", [0, 3])
@pytest.mark.parametrize("metric", BC_METRICS, ids=lambda m: m.name)
def test_ball_cover_knn_matches_jax_and_exact(bc_pairs, metric, n_probes):
    X, ji, ti = bc_pairs[metric]
    Q = _points(metric, 6, 70)
    k = 7
    jv, jid = jbc.knn_query(ji, Q, k, block=512, n_probes=n_probes)
    tv, tid = tbc.knn_query(ti, Q, k, block=512, n_probes=n_probes)
    ev, eid = _exact(X, Q, k, metric)
    np.testing.assert_array_equal(tid.numpy(), np.asarray(jid))
    np.testing.assert_array_equal(tid.numpy(), eid.numpy())
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tv.numpy(), ev.numpy(), rtol=1e-5, atol=1e-6)


def test_ball_cover_pruned_stops_early_on_clustered_data(bc_pairs, monkeypatch):
    X, _, ti = bc_pairs[DistanceType.Haversine]
    Q = X[:40] + 1e-3
    waves = []
    real = tbc._scan_wave
    monkeypatch.setattr(tbc, "_scan_wave", lambda *a: waves.append(1) or real(*a))
    _, ids = tbc.knn_query(ti, Q, 5, n_probes=2)
    assert len(waves) * 2 < ti.n_landmarks
    np.testing.assert_array_equal(ids.numpy(), _exact(X, Q, 5, DistanceType.Haversine)[1].numpy())


@pytest.mark.parametrize("metric", BC_METRICS, ids=lambda m: m.name)
def test_ball_cover_eps_query_matches_jax(bc_pairs, metric):
    X, ji, ti = bc_pairs[metric]
    Q = _points(metric, 8, 50)
    d = pairwise_distance(torch.from_numpy(Q).double(), torch.from_numpy(X).double(), metric)
    eps = _eps_away(np.sort(d.numpy(), axis=1)[:, :60])
    jadj, jvd = jbc.eps_query(ji, Q, eps)
    tadj, tvd = tbc.eps_query(ti, Q, eps)
    np.testing.assert_array_equal(tadj.numpy(), np.asarray(jadj))
    np.testing.assert_array_equal(tvd.numpy(), np.asarray(jvd))
    np.testing.assert_array_equal(tadj.numpy(), (d < eps).numpy())


def test_ball_cover_from_numpy_carries_a_jax_index(bc_pairs):
    X, ji, _ = bc_pairs[DistanceType.Haversine]
    fields = ("dataset", "landmarks", "assignments", "landmark_dists", "radii", "group_rows")
    ti = tbc.from_numpy({f: np.asarray(getattr(ji, f)) for f in fields}, ji.metric, device="cpu")
    Q = _geo(9, 40)
    for n_probes in (0, 4):
        np.testing.assert_array_equal(tbc.knn_query(ti, Q, 6, n_probes=n_probes)[1].numpy(),
                                      np.asarray(jbc.knn_query(ji, Q, 6, n_probes=n_probes)[1]))


# -- hnsw --------------------------------------------------------------------------------------

N, D, NQ, K = 1200, 16, 40, 10


@pytest.fixture(scope="module")
def cagra_pair():
    """A JAX CAGRA index (JAX's ``optimize`` of the exact 32-NN graph, two
    rows with unfilled slots) and the port's load of its saved bytes."""
    rng = np.random.default_rng(4)
    c = rng.standard_normal((12, D)).astype(np.float32)
    x = (c[rng.integers(0, 12, N)] + 0.3 * rng.standard_normal((N, D))).astype(np.float32)
    q = (c[rng.integers(0, 12, NQ)] + 0.3 * rng.standard_normal((NQ, D))).astype(np.float32)
    sq = (x * x).sum(1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * x @ x.T
    np.fill_diagonal(d2, np.inf)
    knn = np.argsort(d2, axis=1, kind="stable")[:, :32].astype(np.int32)
    graph = np.array(jcagra.optimize(knn, 16))
    graph[3, -2:] = -1
    graph[7, -1] = -1
    ji = jcagra.from_graph(x, graph)
    buf = io.BytesIO()
    jcagra.save(ji, buf)
    return x, q, ji, tcagra.load(io.BytesIO(buf.getvalue()), device="cpu")


def _hnsw_bytes(mod, index) -> bytes:
    buf = io.BytesIO()
    mod.serialize_to_hnswlib(index, buf)
    return buf.getvalue()


def test_serialize_to_hnswlib_bytes_are_jax_s(cagra_pair):
    x, _, ji, ti = cagra_pair
    raw = _hnsw_bytes(thnsw, ti)
    assert raw == _hnsw_bytes(jhnsw, ji)
    assert len(raw) == 8 * 6 + 8 + 24 + 16 + N * (4 + 16 * 4 + D * 4 + 8) + N * 4


def test_load_hnswlib_of_jax_s_file(cagra_pair):
    x, _, ji, _ = cagra_pair
    raw = _hnsw_bytes(jhnsw, ji)
    jl = jhnsw.load_hnswlib(io.BytesIO(raw))
    tl = thnsw.load_hnswlib(io.BytesIO(raw), device="cpu")
    np.testing.assert_array_equal(tl.dataset.numpy(), jl.dataset)
    np.testing.assert_array_equal(tl.graph.numpy(), jl.graph)
    assert tl.graph.dtype == torch.int32 and tl.entrypoint == jl.entrypoint == N // 2
    assert tl.dim == D and tl.metric == DistanceType.L2Expanded
    g = np.asarray(ji.graph)
    np.testing.assert_array_equal(tl.graph.numpy(), np.where(g < 0, np.arange(N)[:, None], g))


def test_hnsw_search_matches_jax(cagra_pair):
    x, q, ji, ti = cagra_pair
    raw = _hnsw_bytes(jhnsw, ji)
    jl = jhnsw.load_hnswlib(io.BytesIO(raw))
    tl = thnsw.load_hnswlib(io.BytesIO(raw), device="cpu")
    for ef in (16, 64):
        jv, jid = jhnsw.search(jl, q, K, ef=ef)
        tv, tid = thnsw.search(tl, q, K, ef=ef)
        tid, jid = tid.numpy(), np.asarray(jid)
        assert (tid == jid).mean() >= 0.99
        np.testing.assert_array_equal(tid[:, 0], jid[:, 0])
        same = tid == jid
        np.testing.assert_allclose(tv.numpy()[same], np.asarray(jv)[same], rtol=1e-5, atol=1e-5)


def test_hnsw_index_keeps_one_cagra_index(cagra_pair):
    x, q, ji, ti = cagra_pair
    h = thnsw.from_cagra(ti)
    assert h.to_cagra() is ti and h.entrypoint == N // 2
    tl = thnsw.load_hnswlib(io.BytesIO(_hnsw_bytes(thnsw, ti)), device="cpu")
    first = tl.to_cagra()
    a = thnsw.search(tl, q, K, ef=32)
    b = thnsw.search(tl, q, K, ef=32)
    assert tl.to_cagra() is first
    assert torch.equal(a[1], b[1]) and torch.equal(a[0], b[0])
    fresh = tcagra.search(tcagra.from_graph(tl.dataset, tl.graph, device="cpu"), q, K,
                          tcagra.CagraSearchParams(itopk_size=32))
    assert torch.equal(a[1], fresh[1]) and torch.equal(a[0], fresh[0])


def _record(fn, o):
    reg = o.registry()
    reg.reset()
    o.enable()
    try:
        fn()
        snap = reg.as_dict()
        counters = {k for k in snap["counters"] if not k.startswith("plan.")}
        spans = {(s["name"], s["depth"]) for s in reg.spans()}
    finally:
        o.disable()
        reg.reset()
    return counters, spans, snap["counters"]


def test_hnsw_search_obs_names_are_jax_s(cagra_pair):
    x, q, ji, ti = cagra_pair
    jh, th = jhnsw.from_cagra(ji), thnsw.from_cagra(ti)
    jc, js, _ = _record(lambda: jhnsw.search(jh, q, 5, ef=24), jobs)
    tc, ts, tvals = _record(lambda: thnsw.search(th, q, 5, ef=24), tobs)
    assert tc == jc and ts == js
    assert ("hnsw.search", 0) in ts and ("cagra.search", 1) in ts
    assert tvals['hnsw.search.calls{ef="24"}'] == 1.0
    assert tvals["hnsw.search.queries"] == float(NQ)
