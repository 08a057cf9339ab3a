"""raft_tpu_torch ops and clustering against raft_tpu on the same numpy
inputs: distances, select_k tie order, the 1-NN E step, Lloyd with
injected centers and balanced k-means EM with injected centers."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.cluster import kmeans as jkm
from raft_tpu.cluster import kmeans_balanced as jkb
from raft_tpu.ops import distance as jdist
from raft_tpu.ops import fused_1nn as j1nn
from raft_tpu_torch.cluster import kmeans as tkm
from raft_tpu_torch.cluster import kmeans_balanced as tkb
from raft_tpu_torch.core.errors import LogicError
from raft_tpu_torch.ops import distance as tdist
from raft_tpu_torch.ops import fused_1nn as t1nn

# both packages' ops re-export the select_k function under the module's name
jsel = importlib.import_module("raft_tpu.ops.select_k")
tsel = importlib.import_module("raft_tpu_torch.ops.select_k")

METRICS = ["sqeuclidean", "euclidean", "inner_product", "cosine"]


def _blobs(seed, n, d, k, spread=3.0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, d)).astype(np.float32) * spread
    return (centers[rng.integers(0, k, n)] + rng.normal(size=(n, d))).astype(np.float32)


@pytest.mark.parametrize("metric", METRICS)
def test_pairwise_distance_matches(metric):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(37, 19)).astype(np.float32)
    y = rng.normal(size=(53, 19)).astype(np.float32)
    ref = np.asarray(jdist.pairwise_distance(x, y, metric=metric))
    out = tdist.pairwise_distance(torch.from_numpy(x), torch.from_numpy(y), metric=metric).numpy()
    # f32 sums in another order: rtol 1e-5 plus an atol for values near 0
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_row_norms_and_enum_match():
    x = np.random.default_rng(2).normal(size=(40, 33)).astype(np.float32)
    np.testing.assert_allclose(tdist.row_norms(torch.from_numpy(x)).numpy(),
                               np.asarray(jdist.row_norms(x)), rtol=1e-5)
    assert {m.name: int(m) for m in tdist.DistanceType} == {m.name: int(m) for m in jdist.DistanceType}
    for alias in ("euclidean", "cosine", "dot", "l1", "hamming"):
        assert int(tdist.resolve_metric(alias)) == int(jdist.resolve_metric(alias))


def test_unported_metric_raises():
    # every metric is computed now; Precomputed is the one that raises, in
    # both packages, and Haversine refuses points that are not 2-D
    x = torch.zeros((2, 3))
    with pytest.raises(LogicError):
        tdist.pairwise_distance(x, x, metric=tdist.DistanceType.Precomputed)
    with pytest.raises(LogicError):
        tdist.pairwise_distance(x, x, metric="haversine")
    assert tdist.pairwise_distance(x, x, metric="l1").shape == (2, 2)


@pytest.mark.parametrize("n,k", [(50, 7), (9000, 10)])  # full sort path and top-k path
@pytest.mark.parametrize("select_min", [True, False])
def test_select_k_tie_order_identical(n, k, select_min):
    rng = np.random.default_rng(n + k)
    # few distinct values: every row is full of ties
    vals = rng.integers(0, 6, size=(12, n)).astype(np.float32)
    vals[3, :] = 2.0  # one row all equal
    jv, ji = jsel.select_k(jnp.asarray(vals), k, select_min=select_min)
    tv, ti = tsel.select_k(torch.from_numpy(vals), k, select_min=select_min)
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    assert np.array_equal(tv.numpy(), np.asarray(jv))
    assert ti.dtype == torch.int32


@pytest.mark.parametrize("select_min", [True, False])
def test_select_k_rows_with_few_finite_values(select_min):
    """The top-k path on rows masked as the dense scans mask them: most
    entries ``∓inf``, some rows with fewer than k finite entries, ties at
    the k-th value."""
    rng = np.random.default_rng(3)
    vals = rng.integers(0, 4, size=(9, 6000)).astype(np.float32)
    worst = np.inf if select_min else -np.inf
    vals[rng.random(vals.shape) < 0.999] = worst
    vals[0] = worst
    vals[1, :5] = 1.0
    jv, ji = jsel.select_k(jnp.asarray(vals), 20, select_min=select_min)
    tv, ti = tsel.select_k(torch.from_numpy(vals), 20, select_min=select_min)
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    assert np.array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("n,k", [(50, 10), (5000, 10), (9000, 40)])  # sort path, top-k path
@pytest.mark.parametrize("select_min", [True, False])
@pytest.mark.parametrize("with_indices", [False, True])
def test_select_k_orders_nan_as_lax_top_k(n, k, select_min, with_indices):
    """NaN of either sign, as ``lax.top_k`` orders it: rows with fewer than
    k non-NaN entries, a row of NaN only, ties; every column < n."""
    rng = np.random.default_rng(n + k)
    vals = rng.integers(0, 5, size=(8, n)).astype(np.float32)
    vals[rng.random(vals.shape) < 0.3] = np.nan
    vals[rng.random(vals.shape) < 0.1] = -np.float32(np.nan)
    vals[0] = np.nan
    vals[0, :3] = [1.0, 2.0, 3.0]  # three finite entries, k > 3
    vals[1] = -np.float32(np.nan)
    vals[2, : n // 2] = np.inf
    ids = rng.permutation(8 * n).reshape(8, n).astype(np.int32)
    jv, ji = jsel.select_k(jnp.asarray(vals), k, select_min=select_min,
                           indices=jnp.asarray(ids) if with_indices else None)
    tv, ti = tsel.select_k(torch.from_numpy(vals), k, select_min=select_min,
                           indices=torch.from_numpy(ids) if with_indices else None)
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    assert np.array_equal(tv.numpy().view(np.uint32), np.asarray(jv).view(np.uint32))
    if not with_indices:
        assert int(ti.max()) < n and int(ti.min()) >= 0


def test_running_merge_matches():
    rng = np.random.default_rng(3)
    acc_v = np.sort(rng.integers(0, 5, (6, 4)).astype(np.float32), axis=1)
    acc_i = rng.integers(0, 100, (6, 4)).astype(np.int32)
    new_v = rng.integers(0, 5, (6, 9)).astype(np.float32)
    new_i = rng.integers(100, 200, (6, 9)).astype(np.int32)
    jv, ji = jsel.running_merge(*map(jnp.asarray, (acc_v, acc_i, new_v, new_i)))
    tv, ti = tsel.running_merge(*map(torch.from_numpy, (acc_v, acc_i, new_v, new_i)))
    assert np.array_equal(ti.numpy(), np.asarray(ji)) and np.array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("n,k", [(300, 7), (9000, 25)])  # sort path, top-k path
@pytest.mark.parametrize("select_min", [True, False])
def test_select_k_integer_values_match(n, k, select_min):
    """Integer values are their own keys: ties by column on both paths."""
    rng = np.random.default_rng(n)
    vals = rng.integers(-4, 4, size=(5, n)).astype(np.int32)
    jv, ji = jsel.select_k(jnp.asarray(vals), k, select_min=select_min)
    tv, ti = tsel.select_k(torch.from_numpy(vals), k, select_min=select_min)
    assert np.array_equal(ti.numpy(), np.asarray(ji)) and np.array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("elems", [1, 3 * 6 * 50, 1 << 23])  # a probe, three, all of them
@pytest.mark.parametrize("select_min", [True, False])
def test_merge_probes_equals_a_merge_a_probe(monkeypatch, elems, select_min):
    """The probe paths merge several probes' tiles at once: the same ids
    and value bits as the reference's merge a probe, ties and masked slots
    included."""
    from raft_tpu_torch.neighbors import ivf_common

    rng = np.random.default_rng(4)
    nq, cols, n_probes, k = 6, 50, 7, 12
    worst = np.float32(np.inf if select_min else -np.inf)
    tiles = []
    for p in range(n_probes):
        d = rng.integers(0, 6, size=(nq, cols)).astype(np.float32)
        ids = (p * cols + np.arange(cols, dtype=np.int32))[None, :].repeat(nq, 0)
        masked = rng.random((nq, cols)) < 0.3
        tiles.append((torch.from_numpy(np.where(masked, worst, d)),
                      torch.from_numpy(np.where(masked, -1, ids).astype(np.int32))))
    acc_v = torch.full((nq, k), float(worst))
    acc_i = torch.full((nq, k), -1, dtype=torch.int32)
    for d, i in tiles:
        acc_v, acc_i = tsel.running_merge(acc_v, acc_i, d, i, select_min=select_min)
    monkeypatch.setattr(ivf_common, "PROBE_MERGE_ELEMS", elems)
    got_v, got_i = ivf_common.merge_probes(iter(tiles), nq=nq, k=k, n_probes=n_probes, cols=cols,
                                           select_min=select_min, device="cpu")
    assert torch.equal(got_i, acc_i) and torch.equal(got_v, acc_v)


@pytest.mark.parametrize("metric", METRICS)
def test_min_cluster_and_distance_labels_equal(metric):
    x = _blobs(4, 700, 16, 12)
    c = _blobs(5, 12, 16, 12)
    jl, jd = j1nn.min_cluster_and_distance(x, c, metric=metric)
    tl, td = t1nn.min_cluster_and_distance(torch.from_numpy(x), torch.from_numpy(c), metric=metric)
    assert np.array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-4, atol=1e-4)
    fl, fd = tkm.flash_min_cluster_and_distance(torch.from_numpy(x), torch.from_numpy(c), metric=metric)
    assert np.array_equal(fl.numpy(), tl.numpy())


@pytest.mark.parametrize("algorithm", ["lloyd", "flash"])
def test_kmeans_fit_injected_centers_same_trajectory(algorithm):
    x = _blobs(6, 1200, 8, 6)
    init = x[:6].copy()
    jp = jkm.KMeansParams(n_clusters=6, init="array", max_iter=50, algorithm=algorithm)
    tp = tkm.KMeansParams(n_clusters=6, init="array", max_iter=50, algorithm=algorithm)
    jo = jkm.fit(x, jp, centroids=init)
    to = tkm.fit(torch.from_numpy(x), tp, centroids=torch.from_numpy(init))
    assert np.array_equal(to.labels.numpy(), np.asarray(jo.labels))
    assert to.n_iter == int(jo.n_iter)
    np.testing.assert_allclose(to.inertia, float(jo.inertia), rtol=1e-5)
    np.testing.assert_allclose(to.centroids.numpy(), np.asarray(jo.centroids), rtol=1e-5, atol=1e-5)


def test_kmeans_predict_matches():
    x = _blobs(8, 300, 8, 5)
    c = x[:5]
    tl, _ = tkm.predict(torch.from_numpy(x), torch.from_numpy(c))
    jl, _ = jkm.predict(x, c)
    assert np.array_equal(tl.numpy(), np.asarray(jl))


def test_balanced_em_injected_centers_labels_equal():
    """threshold 0 switches the random re-seeding off, so the EM is the
    same deterministic map in both packages."""
    x = _blobs(9, 2000, 12, 24, spread=2.0)
    init = x[::83][:24].copy()
    metric = jdist.DistanceType.L2Expanded
    jc = jkb._em_iters(jax.random.key(0), jnp.asarray(x), jnp.asarray(init), 24, metric, 6, 0.0)
    gen = tkm.make_generator(0, "cpu")
    tc = tkb._em_iters(gen, torch.from_numpy(x), torch.from_numpy(init), 24,
                       tdist.DistanceType.L2Expanded, 6, 0.0)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5, atol=1e-5)
    jl, _ = jkb.predict(x, jc)
    tl, _ = tkb.predict(torch.from_numpy(x), tc)
    assert np.array_equal(tl.numpy(), np.asarray(jl))


def test_balanced_fit_is_balanced():
    """The port's own draws differ from jax.random's: hold the property
    the trainer exists for (no empty or giant list) and its shape."""
    x = _blobs(10, 3000, 8, 20)
    c = tkb.fit(torch.from_numpy(x), tkb.BalancedKMeansParams(n_clusters=32, seed=3))
    assert c.shape == (32, 8) and torch.isfinite(c).all()
    lab, _ = tkb.predict(torch.from_numpy(x), c)
    counts = torch.bincount(lab.to(torch.int64), minlength=32)
    assert int(counts.min()) > 0 and int(counts.max()) < 3000 // 32 * 6
