"""k-means' remaining entry points in raft_tpu_torch against raft_tpu on
the same numpy inputs: ``transform``, ``inertia``, ``cluster_dispersion``
and ``predict`` on one set of centroids (allclose, rtol 1e-5),
``fit_predict`` from injected centers (labels equal, centroids rtol 1e-5),
``find_k`` on blobs with a planted k over a range of 24 or less
(exhaustive) and a wider one (ternary): JAX's ``best_k`` and its inertia
within rtol 1e-3. ``fit_minibatch`` draws from a ``torch.Generator``, so
its inertia is held within 5 % of JAX's and its labels at an adjusted Rand
index of 0.9 or more against JAX's. Expanded distances also get atol
1e-4 (f32 rounding at the size of the squared norms). Balanced k-means' ``fit_predict``
labels are ``predict(centers)``, held against JAX's with the centers
injected in both packages."""
import numpy as np
import pytest
import torch

from raft_tpu.cluster import kmeans as jkm
from raft_tpu.cluster import kmeans_balanced as jkb
from raft_tpu.stats import adjusted_rand_index as jari
from raft_tpu_torch.cluster import kmeans as tkm
from raft_tpu_torch.cluster import kmeans_balanced as tkb
from raft_tpu_torch.core.resources import Resources

CPU = Resources(device="cpu")
RTOL = 1e-5
#: expanded distances (|x|^2 + |c|^2 - 2 x.c, norms about 200 here) carry
#: an absolute error of f32's epsilon times the norms
ATOL = 1e-4


def _blobs(seed, n, d, k, spread, std):
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((k, d)) * spread
    lab = rng.integers(0, k, n)
    return (c[lab] + std * rng.standard_normal((n, d))).astype(np.float32), lab


@pytest.fixture(scope="module")
def blobs():
    return _blobs(7, 1500, 12, 6, 4.0, 1.0)[0]


@pytest.mark.parametrize("metric", ["sqeuclidean", "euclidean", "cosine"])
def test_transform_inertia_dispersion_predict_match_jax(blobs, metric):
    rng = np.random.default_rng(3)
    cents = blobs[rng.choice(blobs.shape[0], 6, replace=False)] + 0.1
    jt = np.asarray(jkm.transform(blobs, cents, metric=metric))
    tt = tkm.transform(blobs, torch.from_numpy(cents), metric=metric).numpy()
    np.testing.assert_allclose(tt, jt, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(tkm.inertia(blobs, torch.from_numpy(cents), metric)),
                               float(jkm.inertia(blobs, cents, metric)), rtol=RTOL)
    jl, jd = jkm.predict(blobs, cents, metric)
    tl, td = tkm.predict(blobs, torch.from_numpy(cents), metric)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=RTOL, atol=ATOL)
    sizes = np.bincount(np.asarray(jl), minlength=6)
    np.testing.assert_allclose(float(tkm.cluster_dispersion(torch.from_numpy(cents), sizes)),
                               float(jkm.cluster_dispersion(cents, sizes)), rtol=RTOL)


def test_fit_predict_from_injected_centers_matches_jax(blobs):
    init = blobs[:6].copy()
    p = dict(n_clusters=6, init="array", max_iter=50)
    jout, jlab = jkm.fit_predict(blobs, jkm.KMeansParams(**p), centroids=init)
    tout, tlab = tkm.fit_predict(blobs, tkm.KMeansParams(**p), centroids=torch.from_numpy(init),
                                 res=CPU)
    np.testing.assert_array_equal(tlab.numpy(), np.asarray(jlab))
    assert tlab is tout.labels
    np.testing.assert_allclose(tout.centroids.numpy(), np.asarray(jout.centroids), rtol=RTOL,
                               atol=1e-5)
    assert tout.n_iter == int(jout.n_iter)
    np.testing.assert_allclose(tout.inertia, float(jout.inertia), rtol=RTOL)


@pytest.mark.parametrize("case", ["exhaustive", "ternary"])
def test_find_k_returns_jax_s_best_k(case):
    if case == "exhaustive":
        X, _ = _blobs(11, 160, 8, 4, 6.0, 0.05)
        kmin, kmax, planted = 2, 7, 4
    else:
        X, _ = _blobs(12, 240, 8, 5, 6.0, 0.05)
        kmin, kmax, planted = 2, 30, 5
    assert (kmax - max(2, kmin) <= 24) == (case == "exhaustive")
    jk, jin, _ = jkm.find_k(X, kmax=kmax, kmin=kmin, max_iter=15)
    tk, tin, tit = tkm.find_k(torch.from_numpy(X), kmax=kmax, kmin=kmin, max_iter=15)
    assert tk == jk == planted
    np.testing.assert_allclose(tin, float(jin), rtol=1e-3)
    assert 1 <= tit <= 15


def test_fit_minibatch_near_jax():
    X, _ = _blobs(5, 4000, 16, 6, 10.0, 0.3)
    p = dict(n_clusters=6, seed=0, batch_samples=512)
    jout = jkm.fit_minibatch(X, jkm.KMeansParams(**p), n_epochs=8)
    tout = tkm.fit_minibatch(X, tkm.KMeansParams(**p), n_epochs=8, res=CPU)
    assert tout.n_iter == int(jout.n_iter) == 8 * (4000 // 512)
    assert abs(tout.inertia - float(jout.inertia)) <= 0.05 * float(jout.inertia)
    assert float(jari(np.asarray(jout.labels), tout.labels.numpy())) >= 0.9
    labels, dists = tkm.predict(X, tout.centroids)
    np.testing.assert_array_equal(tout.labels.numpy(), labels.numpy())
    np.testing.assert_allclose(tout.inertia, float(dists.sum()), rtol=RTOL)


def test_balanced_fit_predict_is_predict_of_the_centers(blobs, monkeypatch):
    cents = blobs[::250][:6].copy()
    monkeypatch.setattr(jkb, "fit", lambda X, params=None, **kw: cents)
    monkeypatch.setattr(tkb, "fit", lambda X, params=None, **kw: torch.from_numpy(cents))
    params = dict(n_clusters=6)
    jc, jl = jkb.fit_predict(blobs, jkb.BalancedKMeansParams(**params))
    tc, tl = tkb.fit_predict(blobs, tkb.BalancedKMeansParams(**params))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tl.numpy(), tkb.predict(blobs, tc)[0].numpy())


def test_balanced_fit_predict_trains_and_labels():
    X, _ = _blobs(9, 2000, 8, 16, 5.0, 0.5)
    centers, labels = tkb.fit_predict(X, tkb.BalancedKMeansParams(n_clusters=16, seed=0), res=CPU)
    assert tuple(centers.shape) == (16, 8) and tuple(labels.shape) == (2000,)
    np.testing.assert_array_equal(labels.numpy(), tkb.predict(X, centers)[0].numpy())
