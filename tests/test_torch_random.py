"""``raft_tpu_torch.random`` against ``raft_tpu.random``. The port draws
from a ``torch.Generator`` and JAX from Threefry, so the bits differ by
design and each distribution is compared by its draws: 100,000 from each
package, seeds fixed in both (so the test is deterministic), means and
variances within 5 standard errors, and ``scipy.stats.ks_2samp`` with
p > 1e-4. ``make_blobs`` with given centers and ``shuffle=False`` gives
JAX's labels, with noise of the stated std; ``sample_without_replacement``
draws are unique and its weighted inclusion frequencies agree with JAX's
(5 binomial standard errors); ``rmat``'s out- and in-degree histograms
agree by KS; ``make_regression`` without noise fits its own
coefficients."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats as sps

from raft_tpu import random as jr
from raft_tpu_torch import random as tr
from raft_tpu_torch.core.errors import LogicError
from raft_tpu_torch.core.resources import Resources

N = 100_000
CPU = Resources(device="cpu", seed=5)

#: name -> (JAX call, port call) of N draws
DISTS = {
    "uniform": (lambda k: jr.uniform(k, (N,), -2.0, 3.0),
                lambda g: tr.uniform(g, (N,), -2.0, 3.0)),
    "uniform_int": (lambda k: jr.uniform(k, (N,), 3, 17, dtype=jnp.int32),
                    lambda g: tr.uniform(g, (N,), 3, 17, dtype=torch.int32)),
    "normal": (lambda k: jr.normal(k, (N,), 1.5, 2.0), lambda g: tr.normal(g, (N,), 1.5, 2.0)),
    "lognormal": (lambda k: jr.lognormal(k, (N,), 0.2, 0.5),
                  lambda g: tr.lognormal(g, (N,), 0.2, 0.5)),
    "gumbel": (lambda k: jr.gumbel(k, (N,), -1.0, 2.0), lambda g: tr.gumbel(g, (N,), -1.0, 2.0)),
    "exponential": (lambda k: jr.exponential(k, (N,), 2.5),
                    lambda g: tr.exponential(g, (N,), 2.5)),
    "laplace": (lambda k: jr.laplace(k, (N,), 0.5, 1.5), lambda g: tr.laplace(g, (N,), 0.5, 1.5)),
    "rayleigh": (lambda k: jr.rayleigh(k, (N,), 1.7), lambda g: tr.rayleigh(g, (N,), 1.7)),
    "bernoulli": (lambda k: jr.bernoulli(k, (N,), 0.3), lambda g: tr.bernoulli(g, (N,), 0.3)),
}


def _moments_agree(a, b, what):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    n, m = a.size, b.size
    se_mean = np.sqrt(a.var() / n + b.var() / m)
    assert abs(a.mean() - b.mean()) <= 5 * se_mean, what

    def se_var(x):
        c = x - x.mean()
        return (np.mean(c ** 4) - x.var() ** 2) / x.size

    assert abs(a.var() - b.var()) <= 5 * np.sqrt(se_var(a) + se_var(b)), what


@pytest.mark.parametrize("name", sorted(DISTS))
def test_distribution_matches_jax(name):
    jfn, tfn = DISTS[name]
    j = np.asarray(jfn(11))
    t = tfn(tr.as_key(11, device="cpu"))
    assert tuple(t.shape) == (N,) and t.device.type == "cpu"
    if name == "uniform_int":
        assert t.dtype == torch.int32 and int(t.min()) >= 3 and int(t.max()) < 17
    if name == "bernoulli":
        assert t.dtype == torch.bool
    _moments_agree(j, t.numpy(), name)
    assert sps.ks_2samp(j.astype(np.float64), t.numpy().astype(np.float64)).pvalue > 1e-4, name


def test_as_key_forms():
    g = tr.as_key(3, device="cpu")
    assert isinstance(g, torch.Generator) and g.device.type == "cpu"
    assert tr.as_key(g) is g
    assert tr.as_key(None, res=CPU) is CPU.generator
    # one generator advances: two draws differ, a re-seeded one repeats
    a, b = tr.normal(g, (4,)), tr.normal(g, (4,))
    assert not torch.equal(a, b)
    assert torch.equal(tr.normal(3, (4,), device="cpu"), a)
    with pytest.raises(LogicError):
        tr.uniform(tr.as_key(0, device="cpu"), (3,), dtype=torch.int32)
    with pytest.raises(LogicError):
        tr.as_key("seed")


def test_make_blobs_labels_and_noise_match_jax():
    rng = np.random.default_rng(0)
    centers = rng.uniform(-10, 10, (7, 5)).astype(np.float32)
    jx, jl, jc = jr.make_blobs(1, 20_000, 5, 7, cluster_std=0.7, centers=centers, shuffle=False)
    tx, tl, tc = tr.make_blobs(1, 20_000, 5, 7, cluster_std=0.7, centers=centers, shuffle=False,
                               device="cpu")
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    noise = (tx - tc[tl.long()]).numpy().ravel()
    jnoise = (np.asarray(jx) - centers[np.asarray(jl)]).ravel()
    _moments_agree(jnoise, noise, "blob noise")
    assert abs(noise.std() - 0.7) <= 5 * 0.7 / np.sqrt(2 * noise.size)
    # drawn centers in the box; a shuffle keeps each row with its label
    sx, sl, sc = tr.make_blobs(2, 3000, 4, 5, center_box=(-1.0, 1.0), cluster_std=0.01,
                               device="cpu")
    assert float(sc.abs().max()) <= 1.0
    assert not torch.equal(sl, torch.arange(3000, dtype=torch.int32) % 5)
    assert torch.bincount(sl.long()).tolist() == [600] * 5
    assert float((sx - sc[sl.long()]).abs().max()) < 0.1


def test_sample_without_replacement_matches_jax():
    idx = tr.sample_without_replacement(tr.as_key(0, device="cpu"), 1000, 300)
    assert idx.dtype == torch.int32 and len(set(idx.tolist())) == 300
    assert 0 <= int(idx.min()) and int(idx.max()) < 1000
    assert sorted(tr.excess_subsample(1, 50, 50, device="cpu").tolist()) == list(range(50))
    w = np.arange(1, 11, dtype=np.float32)
    draws, m = 2000, 3
    jcount, tcount = np.zeros(10), np.zeros(10)
    g = tr.as_key(7, device="cpu")
    for i in range(draws):
        j = np.asarray(jr.sample_without_replacement(i, 10, m, weights=jnp.asarray(w)))
        t = tr.sample_without_replacement(g, 10, m, weights=torch.from_numpy(w)).numpy()
        assert len(set(t.tolist())) == m
        jcount[j] += 1
        tcount[t] += 1
    pj, pt = jcount / draws, tcount / draws
    se = np.sqrt(pj * (1 - pj) / draws + pt * (1 - pt) / draws)
    assert np.all(np.abs(pj - pt) <= 5 * np.maximum(se, 1e-3))
    assert pt[9] > pt[0]


def test_permute():
    p = tr.permute(tr.as_key(4, device="cpu"), 100)
    assert sorted(p.tolist()) == list(range(100))
    x = torch.arange(24.0).reshape(4, 6)
    for axis in (0, 1):
        y = tr.permute(5, x, axis=axis)
        assert torch.equal(torch.sort(y, dim=axis).values, x)


def test_rmat_degrees_match_jax():
    n_edges, r, c = 200_000, 10, 8
    js, jd = (np.asarray(a) for a in jr.rmat(3, n_edges, r, c, a=0.55, b=0.2, c=0.15))
    ts, td = tr.rmat(tr.as_key(3, device="cpu"), n_edges, r, c, a=0.55, b=0.2, c=0.15)
    assert ts.dtype == td.dtype == torch.int32
    ts, td = ts.numpy(), td.numpy()
    assert 0 <= ts.min() and ts.max() < 2 ** r and 0 <= td.min() and td.max() < 2 ** c
    for (a, b, size) in ((js, ts, 2 ** r), (jd, td, 2 ** c)):
        dj, dt = np.bincount(a, minlength=size), np.bincount(b, minlength=size)
        assert sps.ks_2samp(dj, dt).pvalue > 1e-4
        assert sps.ks_2samp(a, b).pvalue > 1e-4
    # the quadrant split: rows in the top half with probability a + b
    top = (ts < 2 ** (r - 1)).mean()
    assert abs(top - 0.75) <= 5 * np.sqrt(0.75 * 0.25 / n_edges)


@pytest.mark.parametrize("kw", [{}, {"n_informative": 3, "bias": 2.5, "n_targets": 2},
                                {"effective_rank": 4, "tail_strength": 0.3}])
def test_make_regression_without_noise_fits_its_coefficients(kw):
    X, y, coef = tr.make_regression(tr.as_key(2, device="cpu"), 300, 8, **kw)
    assert tuple(X.shape) == (300, 8) and tuple(coef.shape) == (8, kw.get("n_targets", 1))
    np.testing.assert_allclose(y.numpy(), (X @ coef).numpy() + kw.get("bias", 0.0), rtol=1e-5,
                               atol=1e-3)
    assert int((coef.abs().sum(1) > 0).sum()) == kw.get("n_informative", 8)
    jx, jy, jc = jr.make_regression(2, 300, 8, **kw)
    np.testing.assert_allclose(np.asarray(jy), np.asarray(jx) @ np.asarray(jc) + kw.get("bias", 0.0),
                               rtol=1e-5, atol=1e-3)
    if "effective_rank" in kw:
        s = torch.linalg.svdvals(X)
        js = np.linalg.svd(np.asarray(jx), compute_uv=False)
        np.testing.assert_allclose(s.numpy(), js, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("method", ["cholesky", "jacobi"])
def test_multi_variable_gaussian_moments_match_jax(method):
    mean = np.array([1.0, -2.0, 0.5], np.float32)
    cov = np.array([[2.0, 0.6, 0.2], [0.6, 1.0, -0.3], [0.2, -0.3, 0.5]], np.float32)
    j = np.asarray(jr.multi_variable_gaussian(1, N, mean, cov, method=method))
    t = tr.multi_variable_gaussian(tr.as_key(1, device="cpu"), N, mean, cov, method=method).numpy()
    for col in range(3):
        _moments_agree(j[:, col], t[:, col], f"{method} column {col}")
    np.testing.assert_allclose(np.cov(t.T), cov, atol=0.05)
    np.testing.assert_allclose(np.cov(t.T), np.cov(j.T), atol=0.05)
