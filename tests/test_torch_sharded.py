"""Sharded search and the dense scan modes of the port against raft_tpu.

A few thousand rows of 16 dimensions (numpy seed), indexes built and saved
by raft_tpu and loaded into the port. JAX's sharded searches run on a
4-device mesh of the 8 virtual CPU devices, the port's on a CPU mesh of 4
virtual shards (``make_mesh(["cpu"] * 4)``).

Tolerance across packages: ids equal on >= 0.99 of the slots and the
top-1 id equal in every row; distances allclose(rtol=1e-5, atol=1e-4)
where the ids agree. The two packages add each score in another order
(numpy-seeded data has no exact ties, but near ties can swap). Inside the
port the bar is bit for bit: ``ring == fused_ring == gather``.
"""
import io

import jax
import numpy as np
import pytest
import torch

from raft_tpu.neighbors import ivf_flat as jflat
from raft_tpu.neighbors import ivf_pq as jpq
from raft_tpu.parallel import make_mesh as jmake_mesh
from raft_tpu.parallel.sharded_ann import sharded_ivf_flat_search as j_sharded_flat
from raft_tpu.parallel.sharded_ann import sharded_ivf_pq_lists_search as j_sharded_pq
from raft_tpu.parallel.sharded_knn import sharded_knn as j_sharded_knn
from raft_tpu_torch.core.errors import LogicError
from raft_tpu_torch.core.resources import Resources
from raft_tpu_torch.neighbors import brute_force as tbf
from raft_tpu_torch.neighbors import ivf_flat as tflat
from raft_tpu_torch.neighbors import ivf_pq as tpq
from raft_tpu_torch.parallel import (
    make_mesh,
    sharded_ivf_flat_search,
    sharded_ivf_pq_lists_search,
    sharded_knn,
)
from raft_tpu_torch.serve import ServingEngine

N, D, N_LISTS, NQ, K, N_PROBES = 3000, 16, 16, 40, 10, 5
CPU = Resources(device="cpu")
MODES = ("ring", "fused_ring", "gather")


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(44)
    centers = rng.normal(size=(30, D)).astype(np.float32) * 3
    x = (centers[rng.integers(0, 30, N)] + rng.normal(size=(N, D))).astype(np.float32)
    q = (centers[rng.integers(0, 30, NQ)] + rng.normal(size=(NQ, D))).astype(np.float32)
    return x, q


@pytest.fixture(scope="module")
def jmesh(eight_devices):
    return jmake_mesh(eight_devices[:4])


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(["cpu"] * 4)


def _load(jmod, tmod, index):
    buf = io.BytesIO()
    jmod.save(index, buf)
    buf.seek(0)
    return tmod.load(buf, device="cpu")


@pytest.fixture(scope="module")
def flat_pair(corpus):
    built = {}

    def get(metric="sqeuclidean"):
        if metric not in built:
            ji = jflat.build(corpus[0], jflat.IvfFlatIndexParams(n_lists=N_LISTS, metric=metric))
            built[metric] = (ji, _load(jflat, tflat, ji))
        return built[metric]

    return get


PQ_KINDS = {
    "nibble": dict(),
    "kmeans": dict(pq_kind="kmeans"),
    "per_cluster": dict(pq_kind="kmeans", codebook_kind="per_cluster"),
    "p4": dict(pq_kind="kmeans", pq_bits=4),
}


@pytest.fixture(scope="module")
def pq_pair(corpus):
    built = {}

    def get(kind="nibble", metric="sqeuclidean"):
        if (kind, metric) not in built:
            ji = jpq.build(corpus[0], jpq.IvfPqIndexParams(n_lists=N_LISTS, pq_dim=8, metric=metric,
                                                           kmeans_n_iters=5, **PQ_KINDS[kind]))
            built[kind, metric] = (ji, _load(jpq, tpq, ji))
        return built[kind, metric]

    return get


def assert_close_to_jax(td, ti, jd, ji):
    """The cross-package bar of the module docstring."""
    td, ti = td.numpy(), ti.numpy()
    jd, ji = np.asarray(jd), np.asarray(ji)
    assert ti.shape == ji.shape and ti.dtype == np.int32
    same = ti == ji
    assert same.mean() >= 0.99, same.mean()
    assert (ti[:, 0] == ji[:, 0]).all()
    np.testing.assert_allclose(td[same], jd[same], rtol=1e-5, atol=1e-4)


def assert_bit_equal(a, b):
    assert torch.equal(a[1], b[1])
    assert torch.equal(a[0].view(torch.int32), b[0].view(torch.int32))


# -- the dense scan modes -----------------------------------------------------------


@pytest.mark.parametrize("metric", ["sqeuclidean", "inner_product", "cosine"])
def test_flat_scan_mode_matches_jax(corpus, flat_pair, metric):
    _, q = corpus
    ji, ti = flat_pair(metric)
    jd, jidx = jflat.search(ji, q, K, jflat.IvfFlatSearchParams(n_probes=N_PROBES), mode="scan")
    td, tidx = tflat.search(ti, torch.from_numpy(q), K, tflat.IvfFlatSearchParams(n_probes=N_PROBES),
                            mode="scan")
    assert_close_to_jax(td, tidx, jd, jidx)


@pytest.mark.parametrize("kind", list(PQ_KINDS))
def test_pq_scan_mode_matches_jax(corpus, pq_pair, kind):
    _, q = corpus
    ji, ti = pq_pair(kind)
    jd, jidx = jpq.search(ji, q, K, jpq.IvfPqSearchParams(n_probes=N_PROBES), mode="scan")
    td, tidx = tpq.search(ti, torch.from_numpy(q), K, tpq.IvfPqSearchParams(n_probes=N_PROBES),
                          mode="scan")
    assert_close_to_jax(td, tidx, jd, jidx)


def test_scan_mode_batches_with_a_padded_tail(corpus, pq_pair, flat_pair):
    """Query batches of 16 (a zero-padded tail) give the one-batch answer."""
    _, q = corpus
    qt = torch.from_numpy(q)
    for mod, index, p in ((tflat, flat_pair()[1], tflat.IvfFlatSearchParams(n_probes=N_PROBES)),
                          (tpq, pq_pair()[1], tpq.IvfPqSearchParams(n_probes=N_PROBES))):
        one = mod.search(index, qt, K, p, mode="scan")
        many = mod.search(index, qt, K, p, mode="scan", query_batch=16)
        assert torch.equal(one[1], many[1])
        torch.testing.assert_close(one[0], many[0], rtol=1e-6, atol=1e-6)


# -- sharded search against raft_tpu ------------------------------------------------------


@pytest.mark.parametrize("health", [None, (True, False, True, True)])
def test_sharded_ivf_flat_matches_jax(corpus, flat_pair, jmesh, mesh, health):
    _, q = corpus
    ji, ti = flat_pair()
    jd, jidx = j_sharded_flat(jmesh, ji, q, K, jflat.IvfFlatSearchParams(n_probes=N_PROBES),
                              health=health)
    td, tidx = sharded_ivf_flat_search(mesh, ti, q, K, tflat.IvfFlatSearchParams(n_probes=N_PROBES),
                                       health=health)
    assert_close_to_jax(td, tidx, jd, jidx)


def test_sharded_ivf_pq_lists_matches_jax(corpus, pq_pair, jmesh, mesh):
    _, q = corpus
    ji, ti = pq_pair()
    jd, jidx = j_sharded_pq(jmesh, ji, q, K, jpq.IvfPqSearchParams(n_probes=N_PROBES))
    td, tidx = sharded_ivf_pq_lists_search(mesh, ti, q, K, tpq.IvfPqSearchParams(n_probes=N_PROBES))
    assert_close_to_jax(td, tidx, jd, jidx)


@pytest.mark.parametrize("metric", ["sqeuclidean", "inner_product"])
def test_sharded_knn_matches_jax(corpus, jmesh, mesh, metric):
    x, q = corpus
    jd, jidx = j_sharded_knn(jmesh, x, q, K, metric=metric)
    td, tidx = sharded_knn(mesh, x, q, K, metric=metric)
    assert_close_to_jax(td, tidx, jd, jidx)
    bd, bidx = tbf.knn(x, q, K, metric=metric, res=CPU)
    assert torch.equal(tidx, bidx)


# -- inside the port: the three exchanges and the health mask ----------------------------------


def test_exchanges_agree_bit_for_bit(corpus, flat_pair, pq_pair, mesh):
    x, q = corpus
    _, ti = flat_pair()
    _, tp = pq_pair()
    p = tflat.IvfFlatSearchParams(n_probes=N_PROBES)
    pp = tpq.IvfPqSearchParams(n_probes=N_PROBES)
    for search in (lambda m: sharded_ivf_flat_search(mesh, ti, q, K, p, merge_mode=m),
                   lambda m: sharded_ivf_pq_lists_search(mesh, tp, q, K, pp, merge_mode=m),
                   lambda m: sharded_knn(mesh, x, q, K, merge_mode=m)):
        out = {m: search(m) for m in MODES + ("auto",)}
        for m in MODES[1:] + ("auto",):
            assert_bit_equal(out[m], out["ring"])
    # the sharded scan draws from the single-device scan's candidate set
    sd, si = tflat.search(ti, torch.from_numpy(q), K, p, mode="scan")
    assert torch.equal(si, sharded_ivf_flat_search(mesh, ti, q, K, p)[1])


def test_health_mask_drops_a_shards_lists(corpus, flat_pair, mesh):
    _, q = corpus
    _, ti = flat_pair()
    p = tflat.IvfFlatSearchParams(n_probes=N_PROBES)
    health = [True, True, False, True]
    out = {m: sharded_ivf_flat_search(mesh, ti, q, K, p, health=health, merge_mode=m)
           for m in MODES}
    for m in MODES[1:]:
        assert_bit_equal(out[m], out["ring"])
    lost = set(ti.list_indices[2 * N_LISTS // 4:3 * N_LISTS // 4].flatten().tolist()) - {-1}
    assert not lost & set(out["ring"][1].flatten().tolist())
    full = sharded_ivf_flat_search(mesh, ti, q, K, p)[1]
    assert bool((full != out["ring"][1]).any())  # the shard answered before
    with pytest.raises(LogicError):
        sharded_ivf_flat_search(mesh, ti, q, K, p, health=[True, False])


def test_lists_split_once_per_index_and_mesh(corpus, flat_pair, mesh):
    _, q = corpus
    _, ti = flat_pair()
    sharded_ivf_flat_search(mesh, ti, q[:4], K, n_probes=2)
    cache = ti._shard_cache
    parts = cache[(mesh.key(), "data")]
    sharded_ivf_flat_search(mesh, ti, q[:4], K, n_probes=2, merge_mode="gather")
    assert cache[(mesh.key(), "data")] is parts
    # a shard on the index's device gets a view of the lists
    assert parts["data"][1].data_ptr() == ti.list_data[N_LISTS // 4].data_ptr()


def test_merge_mode_and_shape_checks(corpus, flat_pair, mesh):
    _, q = corpus
    _, ti = flat_pair()
    with pytest.raises(LogicError, match="merge_mode"):
        sharded_ivf_flat_search(mesh, ti, q, K, merge_mode="tree")
    with pytest.raises(LogicError, match="not divisible"):
        sharded_ivf_flat_search(make_mesh(["cpu"] * 3), ti, q, K)
    one = make_mesh(["cpu"])
    assert torch.equal(sharded_ivf_flat_search(one, ti, q, K, n_probes=N_PROBES,
                                               merge_mode="fused_ring")[1],
                       tflat.search(ti, torch.from_numpy(q), K, n_probes=N_PROBES, mode="scan")[1])


# -- serving ----------------------------------------------------------------------------


@pytest.mark.parametrize("algo", ["sharded_ivf_flat", "sharded_ivf_pq_lists"])
def test_engine_serves_what_a_direct_call_returns(corpus, flat_pair, pq_pair, mesh, algo):
    _, q = corpus
    if algo == "sharded_ivf_flat":
        index, params, search = flat_pair()[1], tflat.IvfFlatSearchParams(n_probes=N_PROBES), \
            sharded_ivf_flat_search
    else:
        index, params, search = pq_pair()[1], tpq.IvfPqSearchParams(n_probes=N_PROBES), \
            sharded_ivf_pq_lists_search
    eng = ServingEngine(max_batch=16, max_wait_ms=0.0, queue_capacity=64, res=CPU)
    with pytest.raises(LogicError, match="mesh"):
        eng.register("s", algo, index, params=params)
    eng.register("s", algo, index, params=params, mesh=mesh, merge_mode="ring")
    cuts = [(0, 1), (1, 9), (9, 25), (25, 40)]
    futs = [eng.submit("s", q[a:b], K) for a, b in cuts]
    eng.run_until_idle()
    dv, di = search(mesh, index, q, K, params, merge_mode="ring")
    for (a, b), fut in zip(cuts, futs):
        res = fut.result()
        assert res.coverage == 1.0
        np.testing.assert_array_equal(res.indices, di[a:b].numpy())
        np.testing.assert_allclose(res.distances, dv[a:b].numpy(), rtol=1e-6, atol=1e-6)
