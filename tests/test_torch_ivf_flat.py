"""The slice end to end against raft_tpu: a JAX-built index searched by
both packages (fused with the exact merge, probe, prefilter, refine), the
default bank8 params at a recall tolerance, list packing from injected
centers, the port's own build at a recall tolerance, extend, and the
serving engine against direct search."""
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.core.bitset import Bitset as JBitset
from raft_tpu.neighbors import brute_force as jbf
from raft_tpu.neighbors import ivf_flat as jivf
from raft_tpu_torch.core.bitset import Bitset as TBitset
from raft_tpu_torch.core.resources import Resources
from raft_tpu_torch.neighbors import brute_force as tbf
from raft_tpu_torch.neighbors import ivf_common
from raft_tpu_torch.neighbors import ivf_flat as tivf
from raft_tpu_torch.serve import ServingEngine, bucket_for
from raft_tpu_torch.stats.recall import neighborhood_recall

METRICS = ["sqeuclidean", "euclidean", "inner_product", "cosine"]
N, D, N_LISTS, NQ, K = 4000, 32, 32, 48, 10
CPU = Resources(device="cpu")


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(11)
    centers = rng.normal(size=(40, D)).astype(np.float32) * 3
    x = (centers[rng.integers(0, 40, N)] + rng.normal(size=(N, D))).astype(np.float32)
    q = (centers[rng.integers(0, 40, NQ)] + rng.normal(size=(NQ, D))).astype(np.float32)
    return x, q


@pytest.fixture(scope="module")
def pair(corpus):
    """metric -> (JAX index, the port's load of its saved bytes), built
    once per metric."""
    built = {}

    def get(metric):
        if metric not in built:
            ji = jivf.build(corpus[0], jivf.IvfFlatIndexParams(n_lists=N_LISTS, metric=metric))
            buf = io.BytesIO()
            jivf.save(ji, buf)
            buf.seek(0)
            built[metric] = (ji, tivf.load(buf, device="cpu"))
        return built[metric]

    return get


def assert_search_equal(td, ti, jd, ji, tol=1e-5):
    """ids equal wherever the distance is not tied within ``tol`` with
    another entry of the row; distances allclose(rtol=1e-5, atol=1e-4)."""
    td, ti = td.numpy(), ti.numpy()
    jd, ji = np.asarray(jd), np.asarray(ji)
    fin = np.isfinite(jd)
    assert np.array_equal(np.isfinite(td), fin)
    np.testing.assert_allclose(td[fin], jd[fin], rtol=1e-5, atol=1e-4)
    for i, j in np.argwhere(ti != ji):
        near = np.abs(jd[i] - jd[i, j]) <= tol * max(1.0, abs(jd[i, j]))
        assert near.sum() >= 2, (i, j, ti[i], ji[i], jd[i])


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("mode", ["fused", "probe"])
def test_search_matches_jax_on_jax_saved_index(corpus, metric, mode, pair):
    _, q = corpus
    ji, ti = pair(metric)
    jp = jivf.IvfFlatSearchParams(n_probes=4, fused_qt=8, fused_merge="exact")
    tp = tivf.IvfFlatSearchParams(n_probes=4, fused_qt=8)
    jd, jidx = jivf.search(ji, q, K, jp, mode=mode)
    td, tidx = tivf.search(ti, torch.from_numpy(q), K, tp, mode=mode)
    assert tidx.dtype == torch.int32 and td.dtype == torch.float32
    assert_search_equal(td, tidx, jd, jidx)


@pytest.mark.parametrize("mode", ["fused", "probe"])
def test_prefilter_matches_jax(corpus, mode, pair):
    x, q = corpus
    ji, ti = pair("sqeuclidean")
    keep = np.random.default_rng(5).random(N) < 0.5
    jb = JBitset.from_mask(jnp.asarray(keep))
    tb = TBitset.from_mask(torch.from_numpy(keep))
    jp = jivf.IvfFlatSearchParams(n_probes=4, fused_qt=8, fused_merge="exact")
    tp = tivf.IvfFlatSearchParams(n_probes=4, fused_qt=8)
    jd, jidx = jivf.search(ji, q, K, jp, prefilter=jb, mode=mode)
    td, tidx = tivf.search(ti, torch.from_numpy(q), K, tp, prefilter=tb, mode=mode)
    assert_search_equal(td, tidx, jd, jidx)
    got = tidx.numpy()
    assert keep[got[got >= 0]].all()


def test_multi_batch_padding_matches_jax(corpus, pair):
    """Several query batches with a zero-padded tail, as in raft_tpu."""
    _, q = corpus
    ji, ti = pair("sqeuclidean")
    jp = jivf.IvfFlatSearchParams(n_probes=4, fused_qt=8, fused_merge="exact")
    tp = tivf.IvfFlatSearchParams(n_probes=4, fused_qt=8)
    jd, jidx = jivf.search(ji, q, K, jp, mode="fused", query_batch=20)
    td, tidx = tivf.search(ti, torch.from_numpy(q), K, tp, mode="fused", query_batch=20)
    assert_search_equal(td, tidx, jd, jidx)


def test_default_bank8_params_recall(corpus, pair):
    """Default params (fused_merge="bank8"): the port's exact merge holds
    at least the JAX lossy merge's recall@10, less 0.005."""
    x, q = corpus
    ji, ti = pair("sqeuclidean")
    _, gt = jbf.search(jbf.build(x, metric="sqeuclidean"), q, K)
    jp = jivf.IvfFlatSearchParams(n_probes=4, fused_qt=8)
    tp = tivf.IvfFlatSearchParams(n_probes=4, fused_qt=8)
    assert tp.fused_merge == jp.fused_merge == "bank8"
    _, jidx = jivf.search(ji, q, K, jp, mode="fused")
    _, tidx = tivf.search(ti, torch.from_numpy(q), K, tp, mode="fused")
    j_rec = neighborhood_recall(torch.from_numpy(np.array(jidx)), torch.from_numpy(np.array(gt)))
    t_rec = neighborhood_recall(tidx, torch.from_numpy(np.array(gt)))
    assert t_rec >= j_rec - 0.005


@pytest.mark.parametrize("metric", ["sqeuclidean", "cosine"])
def test_build_with_injected_centers_packs_identically(corpus, metric, pair):
    x, _ = corpus
    ji, _ = pair(metric)
    ti = tivf.build_with_centers(x, np.asarray(ji.centers),
                                 tivf.IvfFlatIndexParams(n_lists=N_LISTS, metric=metric), res=CPU)
    for f in ("list_indices", "list_sizes", "list_data", "center_rank"):
        assert np.array_equal(getattr(ti, f).numpy(), np.asarray(getattr(ji, f))), f
    np.testing.assert_allclose(ti.list_norms.numpy(), np.asarray(ji.list_norms), rtol=1e-6)


def test_end_to_end_build_recall(corpus, pair):
    """The port trains with its own random draws; its recall@10 stays
    within 0.02 of JAX's."""
    x, q = corpus
    ji, _ = pair("sqeuclidean")
    ti = tivf.build(x, tivf.IvfFlatIndexParams(n_lists=N_LISTS), res=CPU)
    assert ti.n_lists == N_LISTS and ti.size == N
    _, gt = jbf.search(jbf.build(x, metric="sqeuclidean"), q, K)
    gt = torch.from_numpy(np.array(gt))
    _, jidx = jivf.search(ji, q, K, jivf.IvfFlatSearchParams(n_probes=4), mode="probe")
    _, tidx = tivf.search(ti, torch.from_numpy(q), K, tivf.IvfFlatSearchParams(n_probes=4))
    j_rec = neighborhood_recall(torch.from_numpy(np.array(jidx)), gt)
    assert neighborhood_recall(tidx, gt) >= j_rec - 0.02


def test_integrated_refine_matches_jax(corpus, pair):
    x, q = corpus
    ji, ti = pair("sqeuclidean")
    jp = jivf.IvfFlatSearchParams(n_probes=4, fused_qt=8, fused_merge="exact", refine_ratio=4)
    tp = tivf.IvfFlatSearchParams(n_probes=4, fused_qt=8, refine_ratio=4)
    for mode in ("fused", "probe"):
        jd, jidx = jivf.search(ji, q, K, jp, mode=mode, dataset=x)
        td, tidx = tivf.search(ti, torch.from_numpy(q), K, tp, mode=mode, dataset=torch.from_numpy(x))
        assert_search_equal(td, tidx, jd, jidx)


def test_extend_matches_jax(corpus, pair):
    x, _ = corpus
    ji, ti = pair("sqeuclidean")
    new = np.random.default_rng(3).normal(size=(300, D)).astype(np.float32)
    je = jivf.extend(ji, new)
    te = tivf.extend(ti, torch.from_numpy(new))
    assert te.size == je.size
    for f in ("list_indices", "list_sizes", "list_data"):
        assert np.array_equal(getattr(te, f).numpy(), np.asarray(getattr(je, f))), f


def test_brute_force_knn_matches_jax(corpus):
    x, q = corpus
    jd, jidx = jbf.knn(x, q, K, metric="sqeuclidean")
    td, tidx = tbf.knn(x, q, K, metric="sqeuclidean", res=CPU)
    assert_search_equal(td, tidx, jd, jidx)
    # tiled: several dataset tiles through the running merge
    idx = tbf.build(x, metric="sqeuclidean", res=CPU)
    td2, tidx2 = tbf.search(idx, torch.from_numpy(q), K, dataset_tile=512)
    assert_search_equal(td2, tidx2, jd, jidx)


def _engine(ti, params):
    eng = ServingEngine(max_batch=16, max_wait_ms=0.0, queue_capacity=256, res=CPU)
    eng.register("ivf", "ivf_flat", ti, params=params)
    return eng


def test_serving_bucket_aligned_equals_direct_search(corpus, pair):
    _, q = corpus
    _, ti = pair("sqeuclidean")
    params = tivf.IvfFlatSearchParams(n_probes=4, fused_qt=8)
    eng = _engine(ti, params)
    assert len(eng.warmup("ivf", K)) == 5
    off = 0
    for rows in (1, 2, 4, 8, 16):
        fut = eng.submit("ivf", q[off : off + rows], K)
        eng.step(force=True)
        res = fut.result()
        dv, di = tivf.search(ti, torch.from_numpy(q[off : off + rows]), K, params, query_batch=rows)
        assert np.array_equal(res.indices, di.numpy())
        assert np.array_equal(res.distances, dv.numpy())
        assert res.bucket == rows
        off += rows


def test_serving_padded_batches_preserve_results(corpus, pair):
    _, q = corpus
    _, ti = pair("sqeuclidean")
    params = tivf.IvfFlatSearchParams(n_probes=4, fused_qt=8)
    eng = _engine(ti, params)
    cuts = [(0, 1), (1, 6), (6, 22), (22, 35)]
    futs = [eng.submit("ivf", q[a:b], K) for a, b in cuts]
    assert eng.run_until_idle() == len(cuts)
    for (a, b), fut in zip(cuts, futs):
        res = fut.result()
        dv, di = tivf.search(ti, torch.from_numpy(q[a:b]), K, params, mode="probe",
                             query_batch=bucket_for(b - a, 16))
        assert np.array_equal(res.indices, di.numpy())
        np.testing.assert_allclose(res.distances, dv.numpy(), rtol=1e-5, atol=1e-5)


def test_auto_mode_picks_fused_from_128_queries(corpus, monkeypatch, pair):
    """``auto`` takes the fused kernel from 128 queries on a CUDA index
    only; this CPU index takes the dense scan from 128 queries, as the JAX
    package does off a TPU, and the probe path below."""
    cuda = torch.device("cuda")
    assert ivf_common.auto_search_mode(cuda, 128, True) == "fused"
    assert ivf_common.auto_search_mode(cuda, 127, True) == "probe"
    assert ivf_common.auto_search_mode(cuda, 128, False) == "probe"
    _, q = corpus
    _, ti = pair("sqeuclidean")
    calls = []
    for name in ("ivf_flat_fused_search", "_ivf_flat_scan_impl", "_probe_search"):
        real = getattr(tivf, name)
        monkeypatch.setattr(tivf, name, lambda *a, _n=name, _f=real, **kw: calls.append(_n) or _f(*a, **kw))
    qq = torch.from_numpy(np.concatenate([q, q, q]))  # 144 rows
    tivf.search(ti, qq[:127], K)
    assert set(calls) == {"_probe_search"}
    calls.clear()
    tivf.search(ti, qq[:128], K)
    assert set(calls) == {"_ivf_flat_scan_impl"}
