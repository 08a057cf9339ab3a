"""The CAGRA slice end to end against raft_tpu: the graph utilities and the
prune exactly (``reverse_edges``, ``running_merge_unique``, ``optimize``, the
IVF-PQ build route from the same candidate lists), the xla search on
JAX-saved indexes (every dedup mode, three metrics, prefilter, injected
random seeds, VPQ, padded batches) and the fused search against the JAX
package's interpret-mode kernel, save/load byte for byte both ways,
``from_numpy``, the search plan, NN-descent and VPQ recall at a tolerance
(their random draws differ), the serving engine, and the deterministic
k-means sums.

Search results are held to the JAX package's own fused-vs-xla bar
(``tests/test_cagra.py``): ids agree on >= 0.99 of the result slots, top-1
equal, distances allclose(rtol=1e-5, atol=1e-5) where the ids agree. The
two packages' f32 products add in different orders, so a near tie may
order two slots differently."""
import dataclasses
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.core.bitset import Bitset as JBitset
from raft_tpu.neighbors import cagra as jcagra
from raft_tpu.neighbors import nn_descent as jnnd
from raft_tpu.neighbors.refine import refine as jrefine
from raft_tpu.ops.select_k import merge_parts as jmerge_parts
from raft_tpu.ops.select_k import running_merge_unique as jrmu
from raft_tpu.utils.graph import reverse_edges as jreverse_edges
from raft_tpu_torch.cluster import kmeans_balanced
from raft_tpu_torch.cluster.kmeans import segment_sum
from raft_tpu_torch.core.bitset import Bitset as TBitset
from raft_tpu_torch.core.errors import LogicError
from raft_tpu_torch.core.resources import Resources
from raft_tpu_torch.neighbors import cagra as tcagra
from raft_tpu_torch.neighbors import ivf_pq as tivf
from raft_tpu_torch.neighbors import nn_descent as tnnd
from raft_tpu_torch.neighbors import refine as trefine_mod
from raft_tpu_torch.ops import select_k as tsk
from raft_tpu_torch.serve import ServingEngine
from raft_tpu_torch.stats.recall import neighborhood_recall
from raft_tpu_torch.utils.graph import reverse_edges as treverse_edges

N, D, NQ, K = 2000, 16, 45, 10
CPU = Resources(device="cpu")
METRICS = ["sqeuclidean", "euclidean", "inner_product"]


def _data(rng, n, d, n_centers=16, scale=0.25):
    centers = rng.standard_normal((n_centers, d)).astype(np.float32)
    labels = rng.integers(0, n_centers, n)
    return (centers[labels] + scale * rng.standard_normal((n, d))).astype(np.float32)


def _exact_knn(x, q, k, ip=False):
    if ip:
        d2 = -(q @ x.T)
    else:
        d2 = (q * q).sum(1)[:, None] + (x * x).sum(1)[None, :] - 2.0 * q @ x.T
    return np.argsort(d2, axis=1, kind="stable")[:, :k]


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(7)
    x = _data(rng, N, D)
    q = _data(rng, NQ, D)
    selfd = (x * x).sum(1)[:, None] + (x * x).sum(1)[None, :] - 2.0 * x @ x.T
    np.fill_diagonal(selfd, np.inf)
    knn = np.argsort(selfd, axis=1, kind="stable")[:, :32].astype(np.int32)
    graph = np.asarray(jcagra.optimize(knn, 16))
    return x, q, knn, graph, _exact_knn(x, q, K)


@pytest.fixture(scope="module")
def pair(corpus):
    """metric -> (JAX index on the shared graph, its saved bytes, the port's
    load of them)."""
    x, _, _, graph, _ = corpus
    built = {}

    def get(metric):
        if metric not in built:
            ji = jcagra.from_graph(x, graph, metric)
            raw = _bytes(jcagra.save, ji)
            built[metric] = (ji, raw, tcagra.load(io.BytesIO(raw), device="cpu"))
        return built[metric]

    return get


def _bytes(save, index, **kw) -> bytes:
    buf = io.BytesIO()
    save(index, buf, **kw)
    return buf.getvalue()


def assert_results_agree(tv, ti, jv, ji, min_agree=0.99):
    tv, ti = np.asarray(tv), np.asarray(ti)
    jv, ji = np.asarray(jv), np.asarray(ji)
    assert tv.shape == jv.shape and ti.dtype == np.int32
    same = ti == ji
    assert same.mean() >= min_agree, same.mean()
    np.testing.assert_array_equal(ti[:, 0], ji[:, 0])
    np.testing.assert_allclose(tv[same], jv[same], rtol=1e-5, atol=1e-5)


# -- graph utilities and the prune: exact -------------------------------------


@pytest.mark.parametrize("order_by_rank", [False, True])
def test_reverse_edges_exact(order_by_rank):
    rng = np.random.default_rng(1)
    n, deg = 300, 8
    g = rng.integers(0, n, (n, deg)).astype(np.int32)
    g[rng.random((n, deg)) < 0.2] = -1
    want = np.asarray(jreverse_edges(jnp.asarray(g), n, 5, order_by_rank=order_by_rank))
    got = treverse_edges(torch.from_numpy(g), n, 5, order_by_rank=order_by_rank)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("flags", [False, True])
@pytest.mark.parametrize("select_min", [True, False])
def test_running_merge_unique_exact(flags, select_min):
    """Duplicate ids (equal ids carry equal values), value ties between
    different ids, -1 pads, and the flag lane."""
    rng = np.random.default_rng(2)
    b, k, t = 12, 16, 40
    value_of = rng.integers(0, 8, 64).astype(np.float32)  # few distinct values: many ties
    acc_i = rng.integers(-1, 64, (b, k)).astype(np.int32)
    new_i = rng.integers(-1, 64, (b, t)).astype(np.int32)
    acc_v = np.where(acc_i >= 0, value_of[acc_i], np.inf if select_min else -np.inf).astype(np.float32)
    new_v = np.where(new_i >= 0, value_of[new_i], 0.0).astype(np.float32)
    kw_j, kw_t = {}, {}
    if flags:
        acc_f = rng.random((b, k)) < 0.5
        new_f = rng.random((b, t)) < 0.5
        kw_j = dict(acc_flags=jnp.asarray(acc_f), new_flags=jnp.asarray(new_f))
        kw_t = dict(acc_flags=torch.from_numpy(acc_f), new_flags=torch.from_numpy(new_f))
    want = jrmu(jnp.asarray(acc_v), jnp.asarray(acc_i), jnp.asarray(new_v), jnp.asarray(new_i),
                select_min=select_min, **kw_j)
    got = tsk.running_merge_unique(torch.from_numpy(acc_v), torch.from_numpy(acc_i),
                                   torch.from_numpy(new_v), torch.from_numpy(new_i),
                                   select_min=select_min, **kw_t)
    assert len(got) == (3 if flags else 2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_merge_parts_exact():
    rng = np.random.default_rng(3)
    v = rng.integers(0, 5, (6, 40)).astype(np.float32)
    i = rng.integers(0, 1000, (6, 40)).astype(np.int32)
    want = jmerge_parts(jnp.asarray(v), jnp.asarray(i), 7)
    got = tsk.merge_parts(torch.from_numpy(v), torch.from_numpy(i), 7)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# the three hand-made graphs of tests/test_cagra.py: a detour edge, -1 pads
# that must not pick up phantom detours, and duplicate-free rows whose
# protected head the reverse merge keeps
HAND_GRAPHS = {
    "detour": (np.array([[1, 2], [2, 3], [3, 0], [0, 1]], np.int32), 1),
    "padding": (np.array([[-1, 1, 2, 3], [-1, -1, -1, -1], [-1, -1, -1, -1], [-1, -1, -1, -1],
                          [1, -1, -1, -1]], np.int32), 2),
}


@pytest.mark.parametrize("name", list(HAND_GRAPHS))
def test_detour_rerank_hand_graphs_exact(name):
    g, kout = HAND_GRAPHS[name]
    ids = np.arange(g.shape[0], dtype=np.int32)
    want = np.asarray(jcagra._detour_rerank_chunk(jnp.asarray(g), jnp.asarray(ids), kout=kout))
    got = tcagra._detour_rerank_chunk(torch.from_numpy(g), torch.from_numpy(ids), kout=kout)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tcagra.optimize(g, kout).numpy(),
                                  np.asarray(jcagra.optimize(g, kout)))


def test_optimize_protected_head_graph_exact():
    rng = np.random.default_rng(4)
    n, kout = 200, 8
    g = np.empty((n, kout), np.int32)
    for i in range(n):
        choices = rng.permutation(n - 1)[:kout]
        g[i] = choices + (choices >= i)
    got = tcagra.optimize(g, kout).numpy()
    np.testing.assert_array_equal(got, np.asarray(jcagra.optimize(g, kout)))
    fwd = tcagra._detour_rerank_chunk(torch.from_numpy(g), torch.arange(n), kout=kout).numpy()
    np.testing.assert_array_equal(got[:, : kout // 2], fwd[:, : kout // 2])


@pytest.mark.parametrize("case", ["random_pads", "knn"])
def test_optimize_exact(corpus, case):
    if case == "knn":
        g, kout = corpus[2], 16
    else:
        rng = np.random.default_rng(5)
        n, kin = 500, 16
        g = rng.integers(0, n - 1, (n, kin)).astype(np.int32)
        g = g + (g >= np.arange(n)[:, None])
        g[rng.random((n, kin)) < 0.1] = -1
        kout = 8
    want = np.asarray(jcagra.optimize(g, kout, node_chunk=128))
    got = tcagra.optimize(torch.from_numpy(g), kout, node_chunk=100)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_ivf_pq_route_exact_given_candidates(corpus, monkeypatch):
    """The same self-search candidates and refined lists in, the same graph
    out: the port's IVF-PQ route (its search call, the self-edge drop,
    optimize) reproduces the JAX build exactly. The candidates stand in for
    an IVF-PQ self-search (the exact 40-NN with self edges and random ids
    mixed in); the refine is held on its own, because its f32 distances add
    in another order and near ties may swap."""
    import raft_tpu.neighbors.ivf_pq as jivf_mod

    x = corpus[0]
    rng = np.random.default_rng(12)
    sd = (x * x).sum(1)[:, None] + (x * x).sum(1)[None, :] - 2.0 * x @ x.T
    cand = np.argsort(sd, axis=1, kind="stable")[:, :66].astype(np.int32)
    cand[:, 40:] = rng.integers(-1, N, (N, 26))
    cand = rng.permuted(cand, axis=1)
    params = dict(intermediate_graph_degree=32, graph_degree=16, build_algo="ivf_pq", seed=1)
    calls = []

    def search(index, queries, k, **kw):
        calls.append((k, kw))
        return None, (torch.from_numpy(cand) if isinstance(queries, torch.Tensor)
                      else jnp.asarray(cand))

    class Pq:  # a built IVF-PQ index over the N rows, as far as the route reads one
        size = N
        codes = jnp.zeros(1)

    monkeypatch.setattr(jivf_mod, "search", search)
    want = np.asarray(jcagra.build(x, jcagra.CagraIndexParams(**params), pq_index=Pq()).graph)
    jd, ji = jrefine(x, x, cand, 33, metric="sqeuclidean")

    def refine(dataset, queries, candidates, k, metric):
        np.testing.assert_array_equal(candidates.numpy(), cand)
        assert k == 33
        return torch.from_numpy(np.array(jd)), torch.from_numpy(np.array(ji))

    monkeypatch.setattr(tivf, "search", search)
    monkeypatch.setattr(trefine_mod, "refine", refine)
    got = tcagra.build(x, tcagra.CagraIndexParams(**params), res=CPU, pq_index=Pq())
    assert calls == [(66, dict(n_probes=24, query_batch=4096))] * 2
    np.testing.assert_array_equal(got.graph.numpy(), want)
    assert set(got.build_seconds) == {"pq_build", "self_search", "refine", "optimize"}
    monkeypatch.undo()
    td, ti = trefine_mod.refine(torch.from_numpy(x), torch.from_numpy(x), torch.from_numpy(cand),
                                33, metric="sqeuclidean")
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-4)
    assert (ti.numpy() != np.asarray(ji)).mean() <= 1e-3


def test_ivf_pq_route_recall(corpus):
    x, q, _, _, gt = corpus
    index = tcagra.build(x, tcagra.CagraIndexParams(intermediate_graph_degree=32, graph_degree=16,
                                                    build_algo="ivf_pq", seed=1), res=CPU)
    assert index.graph.shape == (N, 16) and index.graph.dtype == torch.int32
    _, ids = tcagra.search(index, q, K, tcagra.CagraSearchParams(itopk_size=64, search_width=2))
    assert float(neighborhood_recall(ids, torch.from_numpy(gt))) >= 0.85


# -- search on JAX-saved indexes ----------------------------------------------


@pytest.mark.parametrize("dedup", ["post", "sort", "none"])
@pytest.mark.parametrize("metric", METRICS)
def test_xla_search_matches_jax(corpus, pair, metric, dedup):
    q = corpus[1]
    ji, _, ti = pair(metric)
    sp = dict(itopk_size=64, search_width=2, dedup=dedup)
    jv, jidx = jcagra.search(ji, q, K, jcagra.CagraSearchParams(**sp), mode="xla")
    tv, tidx = tcagra.search(ti, q, K, tcagra.CagraSearchParams(**sp), mode="xla")
    assert_results_agree(tv, tidx, jv, jidx)


def test_xla_search_prefilter_matches_jax(corpus, pair):
    x, q = corpus[:2]
    ji, _, ti = pair("sqeuclidean")
    mask = np.random.default_rng(6).random(N) < 0.3
    jbs = JBitset.create(N, default=False).set(np.flatnonzero(mask).astype(np.int32))
    tbs = TBitset.from_mask(torch.from_numpy(mask))
    np.testing.assert_array_equal(tbs.words(), np.asarray(jbs.bits))
    sp = dict(itopk_size=64, search_width=4)
    jv, jidx = jcagra.search(ji, q, K, jcagra.CagraSearchParams(**sp), prefilter=jbs)
    tv, tidx = tcagra.search(ti, q, K, tcagra.CagraSearchParams(**sp), prefilter=tbs)
    assert_results_agree(tv, tidx, jv, jidx)
    got = tidx.numpy()
    assert mask[got[got >= 0]].all()


@pytest.mark.parametrize("dedup", ["post", "sort"])
def test_injected_random_init_matches_jax(corpus, pair, dedup):
    """Random seeds (``init_sample=0``) come from each package's RNG; with
    the same injected ids the searches agree."""
    q = corpus[1]
    ji, _, ti = pair("sqeuclidean")
    init = np.random.default_rng(8).integers(0, N, (NQ, 64)).astype(np.int32)
    kw = dict(k=K, itopk=64, width=2, iters=30, has_filter=False, dedup=dedup)
    jv, jidx = jcagra._cagra_search_impl(ji.dataset, ji.sqnorms, ji.graph, jnp.asarray(q),
                                         jnp.asarray(init), None, metric=ji.metric, **kw)
    tv, tidx = tcagra._cagra_search_impl(ti.dataset, ti.sqnorms, ti.graph, torch.from_numpy(q),
                                         torch.from_numpy(init), None, metric=ti.metric, **kw)
    assert_results_agree(tv, tidx, jv, jidx)
    # and through search(): init_sample=0 draws random seeds
    _, ids = tcagra.search(ti, q, K, tcagra.CagraSearchParams(itopk_size=64, init_sample=0,
                                                              search_width=2, max_iterations=30))
    assert float(neighborhood_recall(ids, torch.from_numpy(corpus[4]))) >= 0.85


@pytest.fixture(scope="module")
def vpq_pair(corpus, pair):
    ji = pair("sqeuclidean")[0]
    jc = jcagra.compress(ji, jcagra.VpqParams(pq_dim=4, pq_bits=5, kmeans_n_iters=4, seed=1))
    raw = _bytes(jcagra.save, jc)
    return jc, raw, tcagra.load(io.BytesIO(raw), device="cpu")


def test_vpq_search_matches_jax(corpus, vpq_pair):
    q = corpus[1]
    jc, _, tc = vpq_pair
    assert tc.dataset is None and tc.vpq.codes.dtype == torch.uint8 and tc.dim == D
    sp = dict(itopk_size=64, search_width=2)
    jv, jidx = jcagra.search(jc, q, K, jcagra.CagraSearchParams(**sp))
    tv, tidx = tcagra.search(tc, q, K, tcagra.CagraSearchParams(**sp))
    assert_results_agree(tv, tidx, jv, jidx)


def test_padded_batches_match_jax(corpus, pair):
    q = corpus[1]
    ji, _, ti = pair("sqeuclidean")
    sp = dict(itopk_size=32, search_width=4)
    jv, jidx = jcagra.search(ji, q, K, jcagra.CagraSearchParams(**sp), query_batch=16, mode="xla")
    tv, tidx = tcagra.search(ti, q, K, tcagra.CagraSearchParams(**sp), query_batch=16, mode="xla")
    assert tidx.shape == (NQ, K)
    assert_results_agree(tv, tidx, jv, jidx)


@pytest.mark.parametrize("metric", ["sqeuclidean", "inner_product"])
def test_fused_search_matches_jax_interpret(corpus, pair, metric):
    """mode="fused" on both: the JAX package's Pallas kernel in interpret
    mode, the port's plain version of B4 on the CPU; f32 table."""
    q = corpus[1]
    ji, _, ti = pair(metric)
    sp = dict(itopk_size=64, search_width=4, fused_table_dtype="float32")
    jv, jidx = jcagra.search(ji, q, K, jcagra.CagraSearchParams(**sp), mode="fused")
    tv, tidx = tcagra.search(ti, q, K, tcagra.CagraSearchParams(**sp), mode="fused")
    assert_results_agree(tv, tidx, jv, jidx)
    # and the port's fused path against its own xla path
    _, xidx = tcagra.search(ti, q, K, tcagra.CagraSearchParams(**sp), mode="xla")
    assert float(neighborhood_recall(tidx, xidx)) >= 0.99


def test_fused_bf16_table_matches_jax(corpus, pair):
    q = corpus[1]
    ji, _, ti = pair("sqeuclidean")
    sp = dict(itopk_size=64, search_width=4)
    _, jidx = jcagra.search(ji, q, K, jcagra.CagraSearchParams(**sp), mode="fused")
    _, tidx = tcagra.search(ti, q, K, tcagra.CagraSearchParams(**sp), mode="fused")
    assert float(neighborhood_recall(tidx, torch.from_numpy(np.array(jidx)))) >= 0.95
    assert ti._fused_table_cache[0] == torch.bfloat16  # cached on the index


def test_modes(corpus, pair):
    q = corpus[1]
    ti = pair("sqeuclidean")[2]
    # auto on a CPU index takes xla, as the JAX package off the TPU
    v1, i1 = tcagra.search(ti, q, K, tcagra.CagraSearchParams(itopk_size=32))
    v2, i2 = tcagra.search(ti, q, K, tcagra.CagraSearchParams(itopk_size=32), mode="xla")
    np.testing.assert_array_equal(i1.numpy(), i2.numpy())
    with pytest.raises(LogicError, match="fused mode needs"):
        tcagra.search(ti, q, K, tcagra.CagraSearchParams(dedup="sort"), mode="fused")
    with pytest.raises(LogicError, match="mode must be"):
        tcagra.search(ti, q, K, mode="scan")
    with pytest.raises(LogicError, match="dedup must be"):
        tcagra.search(ti, q, K, tcagra.CagraSearchParams(dedup="bogus"))


# -- serialization, from_numpy -------------------------------------------------


@pytest.mark.parametrize("include_dataset", [True, False])
def test_save_load_bytes_both_ways(corpus, pair, include_dataset):
    x = corpus[0]
    ji, _, ti = pair("euclidean")
    jraw = _bytes(jcagra.save, ji, include_dataset=include_dataset)
    dataset = None if include_dataset else x
    loaded = tcagra.load(io.BytesIO(jraw), dataset=dataset, device="cpu")
    assert _bytes(tcagra.save, loaded, include_dataset=include_dataset) == jraw
    traw = _bytes(tcagra.save, ti, include_dataset=include_dataset)
    assert traw == jraw
    back = jcagra.load(io.BytesIO(traw), dataset=dataset)
    assert _bytes(jcagra.save, back, include_dataset=include_dataset) == traw
    np.testing.assert_array_equal(loaded.graph.numpy(), np.asarray(ji.graph))
    if not include_dataset:
        with pytest.raises(LogicError, match="without dataset"):
            tcagra.load(io.BytesIO(jraw), device="cpu")


def test_save_load_vpq_bytes_both_ways(vpq_pair, tmp_path):
    jc, jraw, tc = vpq_pair
    assert _bytes(tcagra.save, tc) == jraw
    path = tcagra.save_path(tc, str(tmp_path / "vpq.cagra"))
    back = jcagra.load_path(path)
    assert back.vpq is not None and back.dataset is None
    assert _bytes(jcagra.save, back) == jraw
    np.testing.assert_array_equal(tcagra.load_path(path, device="cpu").vpq.codes.numpy(),
                                  np.asarray(jc.vpq.codes))


def test_from_numpy(corpus, pair, vpq_pair):
    q = corpus[1]
    ji, _, ti = pair("sqeuclidean")
    fi = tcagra.from_numpy({"dataset": np.asarray(ji.dataset), "graph": np.asarray(ji.graph)},
                           ji.metric, device="cpu")
    assert fi.size == N and fi.dim == D
    torch.testing.assert_close(fi.sqnorms, ti.sqnorms, rtol=0, atol=0)
    sp = tcagra.CagraSearchParams(itopk_size=32, search_width=2)
    for a, b in zip(tcagra.search(fi, q, K, sp), tcagra.search(ti, q, K, sp)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    jc, _, tc = vpq_pair
    v = jc.vpq
    fc = tcagra.from_numpy({"graph": np.asarray(jc.graph), "vq_centers": np.asarray(v.vq_centers),
                            "vq_labels": np.asarray(v.vq_labels),
                            "pq_centers": np.asarray(v.pq_centers), "codes": np.asarray(v.codes),
                            "vpq_sqnorms": np.asarray(v.sqnorms)},
                           jc.metric, dim_hint=D, device="cpu")
    assert _bytes(tcagra.save, fc) == _bytes(tcagra.save, tc)


# -- plan and eligibility -------------------------------------------------------


def test_plan_and_config_match_jax():
    for nq in (1, 10, 32, 33, 1024):
        for k in (1, 10, 100):
            for size in (100, 1_000_000):
                for base in (None, dict(search_width=2), dict(search_width=16, init_sample=64),
                             dict(itopk_size=128, dedup="post"), dict(max_iterations=7)):
                    jp = jcagra.plan_search_params(
                        nq, k, size, None if base is None else jcagra.CagraSearchParams(**base))
                    tp = tcagra.plan_search_params(
                        nq, k, size, None if base is None else tcagra.CagraSearchParams(**base))
                    assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
                    assert (tcagra.derive_search_config(tp, k, size)
                            == tuple(jcagra.derive_search_config(jp, k, size)))
    ids = tcagra.strided_seed_ids(1_000_000, 4096)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jcagra.strided_seed_ids(1_000_000, 4096)))


def test_fused_eligible_grid(corpus, pair, vpq_pair):
    x = corpus[0]
    wide = np.random.default_rng(9).integers(0, N, (N, 20)).astype(np.int32)  # degree > dim
    indexes = [
        (pair("sqeuclidean")[0], pair("sqeuclidean")[2]),
        (pair("inner_product")[0], pair("inner_product")[2]),
        (vpq_pair[0], vpq_pair[2]),
        (jcagra.from_graph(x, wide), tcagra.from_graph(x, wide, device="cpu")),
    ]
    jbs, tbs = JBitset.create(N), TBitset.create(N)
    for jidx, tidx in indexes:
        for init_sample in (0, 4096):
            for dedup in ("post", "sort", "none"):
                for filt in (False, True):
                    kw = dict(init_sample=init_sample, dedup=dedup)
                    assert tcagra.fused_eligible(
                        tidx, tcagra.CagraSearchParams(**kw), tbs if filt else None
                    ) == jcagra.fused_eligible(jidx, jcagra.CagraSearchParams(**kw),
                                               jbs if filt else None)


# -- builds with random draws: recall within 0.02 of JAX's -------------------------


def test_nn_descent_recall_near_jax(corpus):
    x, _, knn = corpus[:3]
    params = dict(graph_degree=16, intermediate_graph_degree=32, max_iterations=4, seed=3)
    jg = np.asarray(jnnd.build(x, jnnd.NNDescentParams(**params)).graph)
    tout = tnnd.build(x, tnnd.NNDescentParams(**params), res=CPU)
    assert tout.graph.shape == (N, 16) and tout.graph.dtype == torch.int32
    assert (np.diff(tout.distances.numpy(), axis=1) >= 0).all()
    exact = torch.from_numpy(knn[:, :16].copy())
    jrec = float(neighborhood_recall(torch.from_numpy(jg), exact))
    trec = float(neighborhood_recall(tout.graph, exact))
    assert trec >= jrec - 0.02, (trec, jrec)


def test_nn_descent_cosine_and_ip():
    rng = np.random.default_rng(10)
    x = _data(rng, 600, 8)
    for metric in ("cosine", "inner_product"):
        out = tnnd.build(x, tnnd.NNDescentParams(graph_degree=8, intermediate_graph_degree=16,
                                                 max_iterations=6, metric=metric), res=CPU)
        if metric == "cosine":
            xn = x / np.linalg.norm(x, axis=1, keepdims=True)
            exact = _exact_knn(xn, xn, 9)[:, 1:]
            assert (out.distances.numpy() >= -1e-6).all() and (out.distances.numpy() <= 1.0 + 1e-5).all()
        else:
            exact = _exact_knn(x, x, 9, ip=True)
            exact = np.array([[j for j in row if j != i][:8] for i, row in enumerate(exact)])
        assert float(neighborhood_recall(out.graph, torch.from_numpy(exact))) >= 0.8


def test_nn_descent_cagra_build_recall(corpus):
    x, q, _, _, gt = corpus
    index = tcagra.build(x, tcagra.CagraIndexParams(intermediate_graph_degree=32, graph_degree=16,
                                                    nn_descent_niter=8, seed=3), res=CPU)
    assert set(index.build_seconds) == {"nn_descent", "optimize"}
    _, ids = tcagra.search(index, q, K, tcagra.CagraSearchParams(itopk_size=64, search_width=2))
    assert float(neighborhood_recall(ids, torch.from_numpy(gt))) >= 0.9


def test_compress_recall_near_jax(corpus, pair, vpq_pair):
    q, gt = corpus[1], torch.from_numpy(corpus[4])
    jc, tl = vpq_pair[0], pair("sqeuclidean")[2]
    tc = tcagra.compress(tl, tcagra.VpqParams(pq_dim=4, pq_bits=5, kmeans_n_iters=4, seed=1))
    assert tc.vpq.codes.shape == (N, 4) and tc.vpq.vq_labels.dtype == torch.int32
    sp = dict(itopk_size=64, search_width=2)
    _, jidx = jcagra.search(jc, q, K, jcagra.CagraSearchParams(**sp))
    _, tidx = tcagra.search(tc, q, K, tcagra.CagraSearchParams(**sp))
    jrec = float(neighborhood_recall(torch.from_numpy(np.array(jidx)), gt))
    trec = float(neighborhood_recall(tidx, gt))
    assert trec >= jrec - 0.02, (trec, jrec)


# -- serving, deterministic sums ----------------------------------------------------


def test_engine_serves_cagra_like_direct_search(corpus, pair):
    q = corpus[1]
    ti = pair("sqeuclidean")[2]
    sp = tcagra.CagraSearchParams(itopk_size=32, search_width=4)
    eng = ServingEngine(max_batch=16, max_wait_ms=1.0, res=CPU)
    eng.register("c", "cagra", ti, params=sp)
    assert eng._reg("c").mode == "auto"
    futs = eng.submit_many("c", q[:32], K, request_rows=16)
    eng.run_until_idle()
    got = np.concatenate([f.result().indices for f in futs])
    _, want = tcagra.search(ti, q[:32], K, sp, query_batch=16)
    np.testing.assert_array_equal(got, want.numpy())


def test_segment_sum_matches_index_add():
    """The k-means update's exact fixed-point sum against ``index_add_``
    within f32 rounding, the same bits for the rows in another order, and
    exact sums of integers and of zeros."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn((50_000, 8), generator=g)
    lab = torch.randint(0, 37, (50_000,), generator=g)
    want = torch.zeros((37, 8)).index_add_(0, lab, x)
    got = segment_sum(x, lab, 37)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    perm = torch.randperm(50_000, generator=g)
    assert torch.equal(segment_sum(x[perm], lab[perm], 37), got)
    exact = torch.zeros((37, 8), dtype=torch.float64).index_add_(0, lab, x.double()).float()
    assert (got - exact).abs().max() <= (exact - want).abs().max() + 1e-6
    ints = torch.randint(-1000, 1000, (50_000, 3), generator=g).float()
    assert torch.equal(segment_sum(ints, lab, 37),
                       torch.zeros((37, 3), dtype=torch.int64).index_add_(0, lab, ints.long()).float())
    assert torch.equal(segment_sum(torch.zeros((5, 2)), torch.zeros(5, dtype=torch.int64), 3),
                       torch.zeros((3, 2)))
    w = torch.rand((50_000,), generator=g)
    torch.testing.assert_close(segment_sum(w, lab, 37), torch.zeros(37).index_add_(0, lab, w),
                               rtol=1e-5, atol=1e-4)
    # batched (IVF-PQ's per-subspace Lloyd) against scatter_add_
    xb = torch.randn((4, 5000, 2), generator=g)
    lb = torch.randint(0, 16, (4, 5000), generator=g)
    want = torch.zeros((4, 16, 2)).scatter_add_(1, lb[:, :, None].expand(-1, -1, 2), xb)
    torch.testing.assert_close(segment_sum(xb, lb, 16, batched=True), want, rtol=1e-5, atol=1e-4)


def test_draw_proportional_frequencies():
    """The balancing step's draws: the same indices for one seed, never an
    index of weight 0, and frequencies in proportion to the weights."""
    p = torch.tensor([0.0, 1.0, 3.0, 0.0, 6.0])
    draws = kmeans_balanced.draw_proportional(torch.Generator().manual_seed(3), p, 20_000)
    again = kmeans_balanced.draw_proportional(torch.Generator().manual_seed(3), p, 20_000)
    assert torch.equal(draws, again)
    freq = torch.bincount(draws, minlength=5).double() / 20_000
    assert freq[0] == 0 and freq[3] == 0
    torch.testing.assert_close(freq, p.double() / 10, rtol=0, atol=0.02)
