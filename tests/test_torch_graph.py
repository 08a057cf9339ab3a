"""``single_linkage``, ``spectral`` and ``lap_solve`` of raft_tpu_torch against
raft_tpu on the same numpy inputs (seeded), on the CPU, and the port's
native build.

Tolerances: single linkage's children, sizes and labels are equal and its
deltas allclose at rtol 1e-5; ``fit_embedding`` with JAX's Lanczos draws
injected is within atol 1e-3 up to sign; ``partition`` and
``modularity_maximization`` reach an adjusted Rand index of at least 0.99
against JAX's labels (their k-means draws differ by design);
``analyze_partition`` and ``modularity`` on the same labels are allclose at
rtol 1e-5; ``lap_solve``'s assignments are equal to JAX's native and numpy
solves and its total within rtol 1e-12. A build without a compiler, or
whose compile fails, raises ``KernelFailure``."""
import os
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.metrics import adjusted_rand_score

from raft_tpu import sparse as jsp
from raft_tpu import spectral as jspec
from raft_tpu.cluster.single_linkage import single_linkage as j_single_linkage
from raft_tpu.ops.distance import DistanceType as JD
from raft_tpu.random.rng import as_key as jax_key
from raft_tpu.solver import lap as jlap
from raft_tpu_torch import cluster as tcluster
from raft_tpu_torch import solver as tsolver_pkg
from raft_tpu_torch import sparse as tsp
from raft_tpu_torch import spectral as tspec
from raft_tpu_torch.core.errors import KernelFailure
from raft_tpu_torch.native import build as tbuild
from raft_tpu_torch.ops.distance import DistanceType as TD
from raft_tpu_torch.solver import lap as tlap
from raft_tpu_torch.sparse import solver as tsolver

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def arr(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def blobs(rng, sizes, d, spread):
    """Integer points around blob centres ``spread`` apart: every distance
    of the kNN graph is exact in f32 in both packages, so the tree and the
    dendrogram are compared exactly, ties included."""
    return np.concatenate([rng.integers(-4, 5, (s, d)) + spread * i
                           for i, s in enumerate(sizes)]).astype(np.float32)


# -- single linkage ------------------------------------------------------------------------------


def same_linkage(t, j):
    np.testing.assert_array_equal(t.children, j.children)
    np.testing.assert_array_equal(t.sizes, j.sizes)
    np.testing.assert_array_equal(t.labels, j.labels)
    np.testing.assert_allclose(t.deltas, j.deltas, rtol=1e-5)
    assert t.n_clusters == j.n_clusters
    assert t.labels.dtype == np.int32 and t.children.shape == (len(t.labels) - 1, 2)


@pytest.mark.parametrize("case", ["three_blobs", "disconnected_knn", "one_cluster", "l1"])
def test_single_linkage_matches_jax(case):
    rng = np.random.default_rng(3)
    if case == "three_blobs":
        X, kw = blobs(rng, (30, 25, 20), 4, 20), dict(n_clusters=3)
    elif case == "disconnected_knn":
        # c = 2 leaves the kNN graph in many pieces: the cross-component fix-up runs
        X, kw = blobs(rng, (20, 20, 20), 2, 40), dict(n_clusters=3, c=2)
    elif case == "one_cluster":
        X, kw = blobs(rng, (40,), 3, 0), dict(n_clusters=1, c=7)
    else:
        X, kw = blobs(rng, (25, 25), 3, 12), dict(n_clusters=2, c=4)
        kw_t, kw_j = dict(metric=TD.L1), dict(metric=JD.L1)
    if case != "l1":
        kw_t = kw_j = {}
    t = tcluster.single_linkage(X, **kw, **kw_t, device="cpu")
    j = j_single_linkage(X, **kw, **kw_j)
    same_linkage(t, j)
    assert t.sizes[-1] == len(X)


def test_single_linkage_tensor_input_stays_on_its_device():
    X = blobs(np.random.default_rng(4), (15, 15), 2, 15)
    out = tcluster.single_linkage(torch.from_numpy(X), n_clusters=2)
    same_linkage(out, j_single_linkage(X, n_clusters=2))


# -- spectral ------------------------------------------------------------------------------------


def two_community_graph(seed=0, n_per=24, p_in=0.5, p_out=0.03):
    r = np.random.default_rng(seed)
    n = 2 * n_per
    block = np.arange(n) // n_per
    p = np.where(block[:, None] == block[None, :], p_in, p_out)
    a = np.triu((r.random((n, n)) < p).astype(np.float32) * (1.0 + r.random((n, n))), 1)
    a = (a + a.T).astype(np.float32)
    return a, block


def both_adj(a):
    return tsp.coo_from_dense(a, device="cpu"), jsp.coo_from_dense(a)


def jax_draws(monkeypatch):
    base = jax_key(0)
    restart = jax.random.fold_in(base, 1)

    def draw(gen, n, step):
        key = base if step is None else jax.random.fold_in(restart, step)
        return torch.from_numpy(np.array(jax.random.normal(key, (n,), jnp.float32)))

    monkeypatch.setattr(tsolver, "_draw", draw)


@pytest.mark.parametrize("which", ["smallest", "largest"])
def test_fit_embedding_with_jax_s_draws_matches_jax(which, monkeypatch):
    a, _ = two_community_graph()
    ta, ja = both_adj(a)
    jax_draws(monkeypatch)
    t = arr(tspec.fit_embedding(ta, 2, which=which))
    j = np.asarray(jspec.fit_embedding(ja, 2, which=which))
    assert t.shape == j.shape == (a.shape[0], 2)
    for c in range(2):
        s = np.sign(np.dot(t[:, c], j[:, c])) or 1.0
        np.testing.assert_allclose(s * t[:, c], j[:, c], atol=1e-3)


def community_graph(k, seed=0, n_per=20):
    """Complete weighted communities joined by a ring of weak edges: the
    Laplacian's and B's leading eigenvectors (B's k-th is the constant
    vector) leave k-means one clear answer, so the two packages' different
    k-means draws find the same labels."""
    r = np.random.default_rng(seed)
    n = k * n_per
    block = np.arange(n) // n_per
    a = np.triu(np.where(block[:, None] == block[None, :], 1.0 + 0.1 * r.random((n, n)), 0.0), 1)
    for c in range(k):
        i = r.integers(0, n_per) + c * n_per
        j = r.integers(0, n_per) + ((c + 1) % k) * n_per
        a[min(i, j), max(i, j)] = 0.05
    return (a + a.T).astype(np.float32), block


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("seed", [0, 1])
def test_partition_and_modularity_maximization_match_jax_by_ari(k, seed):
    a, truth = community_graph(k, seed)
    ta, ja = both_adj(a)
    t_lab, t_emb = tspec.partition(ta, k, seed=seed)
    j_lab, _ = jspec.partition(ja, k, seed=seed)
    assert t_lab.shape == (a.shape[0],) and tuple(t_emb.shape) == (a.shape[0], k - 1)
    assert adjusted_rand_score(j_lab, t_lab) >= 0.99
    assert adjusted_rand_score(truth, t_lab) >= 0.99
    t_mod = tspec.modularity_maximization(ta, k, seed=seed)
    j_mod = jspec.modularity_maximization(ja, k, seed=seed)
    assert adjusted_rand_score(j_mod, t_mod) >= 0.99


def test_analyze_partition_and_modularity_match_jax():
    a, truth = two_community_graph(2)
    ta, ja = both_adj(a)
    tpad = tsp.coo_from_dense(a, nnz=int((a != 0).sum()) + 9, device="cpu")  # padded entries
    labels = np.random.default_rng(5).integers(0, 3, a.shape[0])
    for lab in (truth, labels):
        for tadj in (ta, tpad):
            np.testing.assert_allclose(tspec.analyze_partition(tadj, lab),
                                       jspec.analyze_partition(ja, lab), rtol=1e-5)
            np.testing.assert_allclose(tspec.modularity(tadj, lab), jspec.modularity(ja, lab),
                                       rtol=1e-5)


# -- the linear assignment problem ---------------------------------------------------------------


def lap_cases():
    r = np.random.default_rng(11)
    return {
        "n1": r.random((1, 1)),
        "n2": r.random((2, 2)),
        "random64": r.random((64, 64)),
        "integer_ties": r.integers(0, 4, (40, 40)).astype(np.float64),
        "rectangular_scale": r.random((97, 97)) * 1e3,
    }


@pytest.mark.parametrize("case", sorted(lap_cases()))
def test_lap_solve_matches_jax_native_and_numpy(case, monkeypatch):
    c = lap_cases()[case]
    got = tsolver_pkg.lap_solve(c)
    want_native = jlap.lap_solve(c)
    monkeypatch.setattr(jlap, "_native_solve", lambda _c: None)
    want_numpy = jlap.lap_solve(c)
    plain = tlap.lap_solve_reference(c)
    for want in (want_native, want_numpy, plain):
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_allclose(got[2], want[2], rtol=1e-12)
    assert got[0].dtype == np.int32 and sorted(got[0].tolist()) == list(range(len(c)))
    # a tensor cost is solved the same
    t = tsolver_pkg.lap_solve(torch.from_numpy(c))
    np.testing.assert_array_equal(t[0], got[0])


@pytest.fixture
def fresh_build(monkeypatch, tmp_path):
    monkeypatch.setattr(tbuild, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(tbuild, "_LOADED", {})
    return tmp_path / "_build"


def test_native_build_goes_to_the_build_dir_keyed_by_digest(fresh_build):
    lib = tbuild.load_native("lap")
    assert tbuild.load_native("lap") is lib
    built = [f for f in os.listdir(fresh_build) if f.endswith(".so")]
    assert len(built) == 1 and built[0].startswith("liblap_")
    # the port's own copy of the source, never the JAX package's file
    src = os.path.join(REPO, "raft_tpu_torch", "native", "lap.c")
    import hashlib

    with open(src, "rb") as f:
        assert built[0] == f"liblap_{hashlib.sha256(f.read()).hexdigest()[:16]}.so"


def test_a_missing_compiler_raises_kernel_failure(fresh_build, monkeypatch):
    monkeypatch.setattr(tbuild, "compiler", lambda: None)
    with pytest.raises(KernelFailure, match="no C compiler"):
        tlap.lap_solve(np.eye(3))
    assert not fresh_build.exists() or not os.listdir(fresh_build)


def test_a_failed_compile_is_retried_then_raises_kernel_failure(fresh_build, monkeypatch):
    calls = []

    def fail(cmd, **kw):
        calls.append(cmd)
        raise subprocess.CalledProcessError(1, cmd, stderr=b"cc: error")

    monkeypatch.setattr(tbuild.subprocess, "run", fail)
    monkeypatch.setattr("raft_tpu_torch.robust.retry.time.sleep", lambda s: None)
    with pytest.raises(KernelFailure, match="cc: error"):
        tbuild.load_native("lap")
    assert len(calls) == 2  # JAX's retry: two attempts
    assert calls[0][-1].endswith(os.path.join("raft_tpu_torch", "native", "lap.c"))
