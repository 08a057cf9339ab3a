"""Query-sharded search of the port against raft_tpu's: the index
replicated, the queries split over the shards.

2,000 rows of 16 dimensions and 48 queries (numpy seed); IVF-PQ and CAGRA
indexes built and saved by raft_tpu and loaded into the port. JAX runs on 4
of the 8 virtual CPU devices, the port on ``make_mesh(["cpu"] * n)``.

Tolerances: ids equal, distances allclose(rtol=1e-5, atol=1e-5). Inside the
port each shard's block is ``torch.equal`` to the single-device search of
the same rows (the dense scan for IVF-PQ, ``mode="xla"`` for CAGRA). With
random CAGRA seeds (``init_sample == 0``) the two packages draw differently
(JAX folds the rank into its key, the port seeds a ``torch.Generator`` from
``(seed, rank)``), so recall@10 is held within 0.1 of JAX's and of the
single-device search's, JAX's own margin.
"""
import io

import numpy as np
import pytest
import torch

from raft_tpu.neighbors import cagra as jcagra
from raft_tpu.neighbors import ivf_pq as jpq
from raft_tpu.parallel import make_mesh as jmake_mesh
from raft_tpu.parallel import sharded_ann as jsa
from raft_tpu_torch.core.errors import LogicError
from raft_tpu_torch.neighbors import cagra as tcagra
from raft_tpu_torch.neighbors import ivf_pq as tpq
from raft_tpu_torch.parallel import make_mesh, sharded_cagra_search, sharded_ivf_pq_search
from raft_tpu_torch.parallel.sharded_ann import sharded_ivf_pq_lists_search
from raft_tpu_torch.stats.recall import neighborhood_recall

N, D, NQ, K, N_LISTS, N_PROBES = 2000, 16, 48, 10, 16, 5
PQ_KINDS = {"nibble": dict(), "kmeans": dict(pq_kind="kmeans"),
            "per_cluster": dict(pq_kind="kmeans", codebook_kind="per_cluster")}


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(31)
    centers = rng.standard_normal((16, D)).astype(np.float32)
    x = (centers[rng.integers(0, 16, N)] + 0.25 * rng.standard_normal((N, D))).astype(np.float32)
    q = (centers[rng.integers(0, 16, NQ)] + 0.25 * rng.standard_normal((NQ, D))).astype(np.float32)
    d2 = (q * q).sum(1)[:, None] + (x * x).sum(1)[None, :] - 2.0 * q @ x.T
    return x, q, torch.from_numpy(np.argsort(d2, axis=1, kind="stable")[:, :K].astype(np.int32))


def _load(jmod, tmod, index):
    buf = io.BytesIO()
    jmod.save(index, buf)
    buf.seek(0)
    return tmod.load(buf, device="cpu")


@pytest.fixture(scope="module")
def pq_pair(corpus):
    built = {}

    def get(kind):
        if kind not in built:
            ji = jpq.build(corpus[0], jpq.IvfPqIndexParams(n_lists=N_LISTS, pq_dim=8,
                                                           kmeans_n_iters=5, **PQ_KINDS[kind]))
            built[kind] = (ji, _load(jpq, tpq, ji))
        return built[kind]

    return get


@pytest.fixture(scope="module")
def cagra_pair(corpus):
    x = corpus[0]
    selfd = (x * x).sum(1)[:, None] + (x * x).sum(1)[None, :] - 2.0 * x @ x.T
    np.fill_diagonal(selfd, np.inf)
    knn = np.argsort(selfd, axis=1, kind="stable")[:, :32].astype(np.int32)
    ji = jcagra.from_graph(x, np.asarray(jcagra.optimize(knn, 16)), "sqeuclidean")
    jc = jcagra.compress(ji, jcagra.VpqParams(pq_dim=4, pq_bits=5, kmeans_n_iters=4, seed=1))
    return {"dataset": (ji, _load(jcagra, tcagra, ji)), "vpq": (jc, _load(jcagra, tcagra, jc))}


def jmesh_of(n):
    import jax

    return jmake_mesh(jax.devices()[:n])


def assert_equal_to_jax(td, ti, jd, ji):
    jd, ji = np.asarray(jd), np.asarray(ji)
    assert ti.dtype == torch.int32 and tuple(ti.shape) == ji.shape
    np.testing.assert_array_equal(ti.numpy(), ji)
    np.testing.assert_allclose(td.numpy(), jd, rtol=1e-5, atol=1e-5)


def assert_blocks_are_single_device(out, single, n):
    """Each shard's block ``torch.equal`` to ``single(rows)`` of its rows."""
    per = NQ // n
    for r in range(n):
        want = single(slice(r * per, (r + 1) * per))
        assert torch.equal(out[1][r * per:(r + 1) * per], want[1])
        assert torch.equal(out[0][r * per:(r + 1) * per], want[0])


@pytest.mark.parametrize("kind,n", [("nibble", 4), ("kmeans", 2), ("per_cluster", 4),
                                    ("nibble", 3)])
def test_sharded_ivf_pq_search_matches_jax(corpus, pq_pair, kind, n):
    _, q, _ = corpus
    ji, ti = pq_pair(kind)
    p_j, p_t = jpq.IvfPqSearchParams(n_probes=N_PROBES), tpq.IvfPqSearchParams(n_probes=N_PROBES)
    jd, jidx = jsa.sharded_ivf_pq_search(jmesh_of(n), ji, q, K, p_j)
    out = sharded_ivf_pq_search(make_mesh(["cpu"] * n), ti, q, K, p_t)
    assert_equal_to_jax(out[0], out[1], jd, jidx)
    qt = torch.from_numpy(q)
    assert_blocks_are_single_device(
        out, lambda sl: tpq.search(ti, qt[sl], K, p_t, mode="scan"), n)


@pytest.mark.parametrize("data,n", [("dataset", 4), ("dataset", 2), ("vpq", 4)])
def test_sharded_cagra_search_matches_jax(corpus, cagra_pair, data, n):
    _, q, _ = corpus
    ji, ti = cagra_pair[data]
    sp = dict(itopk_size=64, search_width=4, init_sample=512)
    jd, jidx = jsa.sharded_cagra_search(jmesh_of(n), ji, q, K, jcagra.CagraSearchParams(**sp))
    out = sharded_cagra_search(make_mesh(["cpu"] * n), ti, q, K, tcagra.CagraSearchParams(**sp))
    assert_equal_to_jax(out[0], out[1], jd, jidx)
    qt = torch.from_numpy(q)
    assert_blocks_are_single_device(
        out, lambda sl: tcagra.search(ti, qt[sl], K, tcagra.CagraSearchParams(**sp), mode="xla"),
        n)


def test_sharded_cagra_random_seeds_within_margin(corpus, cagra_pair):
    """``init_sample == 0``: per-rank random seeds, recall within 0.1 of
    JAX's sharded search and of the port's single-device search; the draws
    repeat from one seed and differ between ranks."""
    _, q, gt = corpus
    ji, ti = cagra_pair["dataset"]
    sp = dict(itopk_size=64, search_width=4, init_sample=0, seed=3)
    mesh = make_mesh(["cpu"] * 4)
    _, jidx = jsa.sharded_cagra_search(jmesh_of(4), ji, q, K, jcagra.CagraSearchParams(**sp))
    _, tidx = sharded_cagra_search(mesh, ti, q, K, tcagra.CagraSearchParams(**sp))
    _, sidx = tcagra.search(ti, q, K, tcagra.CagraSearchParams(**sp), mode="xla")
    rec = neighborhood_recall(tidx, gt)
    assert rec >= neighborhood_recall(torch.from_numpy(np.asarray(jidx)), gt) - 0.1
    assert rec >= neighborhood_recall(sidx, gt) - 0.1
    _, again = sharded_cagra_search(mesh, ti, q, K, tcagra.CagraSearchParams(**sp))
    assert torch.equal(tidx, again)
    from raft_tpu_torch.parallel.sharded_ann import _rank_generator

    draws = [torch.randint(0, N, (8,), generator=_rank_generator(3, r, "cpu")) for r in range(2)]
    assert not torch.equal(draws[0], draws[1])


def test_divisibility_errors(corpus, pq_pair, cagra_pair):
    _, q, _ = corpus
    mesh = make_mesh(["cpu"] * 5)
    with pytest.raises(LogicError, match="n_queries 48 not divisible by 5 shards"):
        sharded_ivf_pq_search(mesh, pq_pair("nibble")[1], q, K)
    with pytest.raises(LogicError, match="n_queries 48 not divisible by 5 shards"):
        sharded_cagra_search(mesh, cagra_pair["dataset"][1], q, K)


def test_rabitq_is_rejected_where_jax_scores_bits_as_pq_codes(corpus):
    """JAX's sharded PQ searches take a RaBitQ index and score its unpacked
    sign bits as PQ codes against the placeholder codebook: not RaBitQ's
    estimator, so its answer differs from the RaBitQ scan's. The port
    rejects the index typed in both sharded PQ searches."""
    x, q, _ = corpus
    ji = jpq.build(x, jpq.IvfPqIndexParams(n_lists=N_LISTS, pq_bits=1, kmeans_n_iters=5))
    ti = _load(jpq, tpq, ji)
    _, lists_ids = jsa.sharded_ivf_pq_lists_search(jmesh_of(4), ji, q, K, n_probes=N_PROBES)
    _, scan_ids = tpq.search(ti, torch.from_numpy(q), K, n_probes=N_PROBES, refine_ratio=1,
                             mode="scan")
    _, jscan_ids = jpq.search(ji, q, K, jpq.IvfPqSearchParams(n_probes=N_PROBES, refine_ratio=1),
                              mode="scan")
    assert (scan_ids.numpy() == np.asarray(jscan_ids)).mean() >= 0.99
    assert (np.asarray(lists_ids) == scan_ids.numpy()).mean() < 0.5
    mesh = make_mesh(["cpu"] * 4)
    for search in (sharded_ivf_pq_lists_search, sharded_ivf_pq_search):
        with pytest.raises(LogicError, match="RaBitQ"):
            search(mesh, ti, q, K, n_probes=N_PROBES)
