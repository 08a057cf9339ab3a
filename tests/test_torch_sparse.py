"""``raft_tpu_torch.sparse`` (containers, linalg, distances and kNN, the kNN
graph, MST and Lanczos) against ``raft_tpu.sparse`` on the same numpy
inputs (seeded), on the CPU.

Tolerances: floats allclose at rtol/atol 1e-5; the expanded L2 family's
distances carry f32 rounding at the size of the squared norms, so their
atol is 4 f32 epsilons of the largest squared norm (its square root for
``L2SqrtExpanded``). Integers, CSR structure and the padded-COO behaviour
are equal. Sparse kNN ids are equal but where the two packages' values at
a slot lie within 1e-5 (a tie), for gram and union metrics in both modes
and with the planner gate on and off. MST edges are exactly equal, on
tied integer weights and on a forest. Lanczos with JAX's start and restart
vectors injected: eigenvalues rtol 1e-4, eigenvectors atol 1e-3 up to
sign; with its own draws: eigenvalues rtol 1e-3."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu import sparse as jsp
from raft_tpu.ops.distance import DistanceType as JD
from raft_tpu.random.rng import as_key as jax_key
from raft_tpu.sparse import linalg as jla
from raft_tpu_torch import sparse as tsp
from raft_tpu_torch.sparse import distance as tdist
from raft_tpu_torch.sparse import linalg as tla
from raft_tpu_torch.sparse import solver as tsolver
from raft_tpu_torch.ops.distance import DistanceType as TD

RTOL = ATOL = 1e-5
F32_EPS = float(np.finfo(np.float32).eps)


def arr(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def close(t, j, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(arr(t), arr(j), rtol=rtol, atol=atol)


def equal(t, j):
    np.testing.assert_array_equal(arr(t), arr(j))


def same_coo(t, j):
    equal(t.rows, j.rows)
    equal(t.cols, j.cols)
    close(t.vals, j.vals)
    assert tuple(t.shape) == tuple(j.shape)


def same_csr(t, j):
    equal(t.indptr, j.indptr)
    equal(t.indices, j.indices)
    close(t.vals, j.vals)
    assert tuple(t.shape) == tuple(j.shape)


def sparse_rows(rng, m, n, density, signed=False, empty_rows=()):
    x = rng.random((m, n)).astype(np.float32) * (rng.random((m, n)) < density)
    if signed:
        x = np.where(rng.random((m, n)) < 0.5, -x, x).astype(np.float32)
    x[list(empty_rows)] = 0.0
    return x


def both_csr(x):
    return tsp.csr_from_dense(x, device="cpu"), jsp.csr_from_dense(x)


def both_coo(rows, cols, vals, shape):
    t = tsp.COO(torch.as_tensor(rows, dtype=torch.int32), torch.as_tensor(cols, dtype=torch.int32),
                torch.as_tensor(vals, dtype=torch.float32), shape)
    j = jsp.COO(jnp.asarray(rows, jnp.int32), jnp.asarray(cols, jnp.int32),
                jnp.asarray(vals, jnp.float32), shape)
    return t, j


# -- containers ----------------------------------------------------------------------------------


def test_containers_match_jax(rng):
    x = sparse_rows(rng, 12, 9, 0.3, signed=True, empty_rows=(0, 5))
    tc, jc = both_csr(x)
    same_csr(tc, jc)
    equal(tc.row_ids(), jc.row_ids())
    close(tc.to_dense(), jc.to_dense())
    same_coo(tc.to_coo(), jc.to_coo())
    for nnz in (None, 20, 60):
        t = tsp.coo_from_dense(x, nnz=nnz, device="cpu")
        j = jsp.coo_from_dense(x, nnz=nnz)
        same_coo(t, j)
        close(t.to_dense(), j.to_dense())
        same_csr(tsp.coo_to_csr(t), jsp.coo_to_csr(j))
    assert tc.vals.dtype == torch.float32 and tc.indptr.dtype == torch.int32


def test_sorted_by_row_is_lexsort_with_ties(rng):
    rows = rng.integers(0, 5, 40)
    cols = rng.integers(0, 4, 40)  # many repeated (row, col) pairs
    vals = np.arange(40, dtype=np.float32)  # order visible in the values
    t, j = both_coo(rows, cols, vals, (5, 4))
    same_coo(t.sorted_by_row(), j.sorted_by_row())
    same_csr(tsp.coo_to_csr(t), jsp.coo_to_csr(j))


def test_padded_coo_structural_ops():
    dense = np.zeros((4, 4), np.float32)
    dense[1, 2] = 2.0
    dense[2, 0] = 3.0
    t = tsp.coo_from_dense(dense, nnz=8, device="cpu")
    j = jsp.coo_from_dense(dense, nnz=8)
    equal(tla.degree(t), jla.degree(j))
    equal(tla.degree(t), [0, 1, 1, 0])
    tcsr, jcsr = tsp.coo_to_csr(t), jsp.coo_to_csr(j)
    equal(tcsr.indptr, jcsr.indptr)
    equal(tcsr.indptr, [0, 0, 1, 2, 2])
    close(tcsr.to_dense(), dense)
    close(tla.transpose(tcsr).to_dense(), jla.transpose(jcsr).to_dense())
    # the padding's row ids past indptr[-1] are n_rows, and every consumer drops them
    equal(tcsr.row_ids(), jcsr.row_ids())
    close(tla.row_norm_csr(tcsr, "linf"), jla.row_norm_csr(jcsr, "linf"))


def test_symmetrize_with_duplicates():
    t, j = both_coo([0, 0, 1], [1, 1, 0], [1.0, 2.0, 4.0], (2, 2))
    for op, want in (("mean", [[0, 3.5], [3.5, 0]]), ("max", [[0, 4.0], [4.0, 0]])):
        ts, js = tla.symmetrize(t, op), jla.symmetrize(j, op)
        same_coo(ts, js)
        close(ts.to_dense(), want)


# -- linalg --------------------------------------------------------------------------------------


@pytest.fixture
def mats(rng):
    x = sparse_rows(rng, 14, 11, 0.3, signed=True, empty_rows=(3,))
    return x, both_csr(x)


@pytest.mark.parametrize("fn", ["spmv", "spmm", "transpose", "degree", "norm_l1", "norm_l2",
                                "norm_linf", "sddmm", "symmetrize_max", "symmetrize_mean", "add"])
def test_linalg_matches_jax(rng, mats, fn):
    x, (tc, jc) = mats
    if fn == "spmv":
        v = rng.standard_normal(11).astype(np.float32)
        close(tla.spmv(tc, v), jla.spmv(jc, v))
    elif fn == "spmm":
        b = rng.standard_normal((11, 5)).astype(np.float32)
        close(tla.spmm(tc, b), jla.spmm(jc, b))
        close(tla.spmm(tc, torch.from_numpy(b)), x @ b, atol=1e-5)
    elif fn == "transpose":
        same_csr(tla.transpose(tc), jla.transpose(jc))
    elif fn == "degree":
        equal(tla.degree(tc.to_coo()), jla.degree(jc.to_coo()))
    elif fn.startswith("norm_"):
        kind = fn[5:]
        got = tla.row_norm_csr(tc, kind)
        close(got, jla.row_norm_csr(jc, kind))
        if kind == "linf":
            assert float(got[3]) == float("-inf")
    elif fn == "sddmm":
        a = rng.standard_normal((14, 6)).astype(np.float32)
        b = rng.standard_normal((6, 11)).astype(np.float32)
        mask = (rng.random((14, 11)) < 0.3).astype(np.float32)
        tm = tsp.coo_from_dense(mask, nnz=60, device="cpu")
        jm = jsp.coo_from_dense(mask, nnz=60)
        same_coo(tla.sddmm(a, b, tm, alpha=2.0, beta=1.0), jla.sddmm(a, b, jm, alpha=2.0, beta=1.0))
    elif fn.startswith("symmetrize_"):
        sq = sparse_rows(rng, 9, 9, 0.3)
        t = tsp.coo_from_dense(sq, nnz=30, device="cpu")
        j = jsp.coo_from_dense(sq, nnz=30)
        op = fn.split("_")[1]
        ts, js = tla.symmetrize(t, op), jla.symmetrize(j, op)
        same_coo(ts, js)
        close(ts.to_dense(), js.to_dense())
    else:
        y = sparse_rows(rng, 14, 11, 0.3)
        ta, ja = tsp.coo_from_dense(y, device="cpu"), jsp.coo_from_dense(y)
        tb, jb = tc.to_coo(), jc.to_coo()
        same_coo(tla.add(ta, tb), jla.add(ja, jb))
        close(tla.add(ta, tb).to_dense(), x + y)


# -- distances and kNN ---------------------------------------------------------------------------

NATIVE = sorted(m.name for m in tdist._NATIVE)
L2_EXPANDED = ("L2Expanded", "L2SqrtExpanded")


def dist_atol(metric, x, y):
    if metric not in L2_EXPANDED:
        return ATOL
    top = max(float((x * x).sum(1).max()), float((y * y).sum(1).max()))
    atol = 4 * F32_EPS * top
    return max(ATOL, np.sqrt(atol) if metric == "L2SqrtExpanded" else atol)


def signed_ok(metric):
    return metric not in ("KLDivergence", "JensenShannon", "HellingerExpanded")


@pytest.fixture(scope="module")
def xy():
    r = np.random.default_rng(7)
    x = sparse_rows(r, 37, 50, 0.2, empty_rows=(4,))
    y = sparse_rows(r, 29, 50, 0.25, empty_rows=(0,))
    return x, y


@pytest.mark.parametrize("metric", NATIVE)
def test_native_metrics_match_jax(xy, metric):
    x, y = xy
    if signed_ok(metric):
        s = np.random.default_rng(3)
        x = np.where(s.random(x.shape) < 0.5, -x, x).astype(np.float32)
        y = np.where(s.random(y.shape) < 0.5, -y, y).astype(np.float32)
    (tx, jx), (ty, jy) = both_csr(x), both_csr(y)
    kw = dict(metric_arg=3.0) if metric == "LpUnexpanded" else {}
    got = tsp.pairwise_distance_sparse_native(tx, ty, TD[metric], pair_block=16, **kw)
    want = jsp.pairwise_distance_sparse_native(jx, jy, JD[metric], pair_block=16, **kw)
    assert tuple(got.shape) == (37, 29)
    close(got, want, atol=dist_atol(metric, x, y))


@pytest.mark.parametrize("metric", ["L2Expanded", "CosineExpanded", "L1", "Linf", "Canberra",
                                    "BrayCurtis", "CorrelationExpanded", "RusselRaoExpanded",
                                    "JensenShannon", "HammingUnexpanded"])
def test_densify_metrics_match_jax(xy, metric):
    x, y = xy
    (tx, jx), (ty, jy) = both_csr(x), both_csr(y)
    # block 16 < n: the y side is densified in blocks too
    got = tsp.pairwise_distance_sparse(tx, ty, TD[metric], block=16, mode="densify")
    want = jsp.pairwise_distance_sparse(jx, jy, JD[metric], block=16, mode="densify")
    close(got, want, atol=dist_atol(metric, x, y))
    whole = tsp.pairwise_distance_sparse(tx, ty, TD[metric], mode="densify")
    close(whole, want, atol=dist_atol(metric, x, y))


def test_sparse_gram_and_its_transform_match_jax(xy):
    x, y = xy
    (tx, jx), (ty, jy) = both_csr(x), both_csr(y)
    close(tsp.sparse_gram(tx, ty, pair_block=8), jsp.sparse_gram(jx, jy, pair_block=8))
    close(tsp.sparse_gram(tx, ty, transform=torch.sqrt), jsp.sparse_gram(jx, jy, transform=jnp.sqrt))
    close(tsp.sparse_gram(tx, ty), x @ y.T)


@pytest.mark.parametrize("metric", ["CosineExpanded", "L1", "BrayCurtis"])
def test_split_pair_blocks_equal_whole_blocks(xy, metric, monkeypatch):
    x, y = xy
    (tx, _), (ty, _) = both_csr(x), both_csr(y)
    whole = tsp.pairwise_distance_sparse_native(tx, ty, TD[metric])
    monkeypatch.setattr(tdist, "PAIR_ELEMS", 50)  # a few y rows a slice
    split = tsp.pairwise_distance_sparse_native(tx, ty, TD[metric])
    equal(split, whole)


def test_native_at_a_million_columns_matches_jax():
    r = np.random.default_rng(11)
    m, n, width = 23, 31, 1 << 20
    parts = []
    for rows in (m, n):
        counts = r.integers(0, 9, rows)
        indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
        idx = np.concatenate([np.sort(r.choice(width, c, replace=False)) for c in counts])
        vals = r.random(int(indptr[-1])).astype(np.float32) + 0.1
        parts.append((indptr, idx.astype(np.int32), vals))
    tcs = [tsp.CSR(torch.from_numpy(p), torch.from_numpy(i), torch.from_numpy(v), (len(p) - 1, width))
           for p, i, v in parts]
    jcs = [jsp.CSR(jnp.asarray(p), jnp.asarray(i), jnp.asarray(v), (len(p) - 1, width))
           for p, i, v in parts]
    for metric in ("InnerProduct", "CosineExpanded", "L1", "JensenShannon"):
        close(tsp.pairwise_distance_sparse_native(*tcs, TD[metric]),
              jsp.pairwise_distance_sparse_native(*jcs, JD[metric]))


def same_knn(t, j, tol=1e-5):
    tv, ti = arr(t[0]), arr(t[1])
    jv, ji = arr(j[0]), arr(j[1])
    close(tv, jv, atol=tol)
    differ = ti != ji
    # a slot may hold another id only where the two values tie
    assert np.all(np.abs(tv[differ] - jv[differ]) <= tol), (ti[differ], ji[differ])
    assert differ.mean() < 0.05


@pytest.mark.parametrize("gate", ["1", "0"])
@pytest.mark.parametrize("mode", ["auto", "densify", "native"])
@pytest.mark.parametrize("metric", ["L2Expanded", "InnerProduct", "CosineExpanded", "JaccardExpanded",
                                    "L1", "Linf", "BrayCurtis", "KLDivergence"])
def test_knn_sparse_matches_jax(xy, metric, mode, gate, monkeypatch):
    monkeypatch.setenv("RAFT_TPU_PLAN", gate)
    x, y = xy
    (tx, jx), (ty, jy) = both_csr(x), both_csr(y)
    got = tsp.knn_sparse(tx, ty, 5, TD[metric], block=16, mode=mode)
    want = jsp.knn_sparse(jx, jy, 5, JD[metric], block=16, mode=mode)
    assert got[1].dtype == torch.int32
    same_knn(got, want, tol=dist_atol(metric, x, y))


@pytest.mark.parametrize("gate", ["1", "0"])
@pytest.mark.parametrize("n_cols", [4096, (1 << 18) + 1, 1 << 20])
@pytest.mark.parametrize("metric", ["CosineExpanded", "L1", "CorrelationExpanded"])
def test_auto_mode_is_jax_s_choice(metric, n_cols, gate, monkeypatch):
    from raft_tpu.sparse import distance as jdist

    monkeypatch.setenv("RAFT_TPU_PLAN", gate)
    assert tdist._plan_sparse(n_cols, TD[metric]) == jdist._plan_sparse(n_cols, JD[metric])


# -- the kNN graph and the cross-component pairs ------------------------------------------------


def test_knn_graph_matches_jax(rng):
    X = np.concatenate([rng.standard_normal((20, 3)), rng.standard_normal((20, 3)) + 40.0])
    X = X.astype(np.float32)
    for metric in ("L2SqrtExpanded", "L2Expanded", "L1"):
        t = tsp.knn_graph(X, 4, metric=TD[metric], device="cpu")
        j = jsp.knn_graph(X, 4, metric=JD[metric])
        assert t.nnz == 2 * 40 * 4
        equal(t.rows, j.rows)
        equal(t.cols, j.cols)
        close(t.vals, j.vals, atol=dist_atol(metric, X, X))
    # a tensor input stays on its device
    assert tsp.knn_graph(torch.from_numpy(X), 3).rows.device.type == "cpu"


def test_cross_component_nn_matches_jax(rng):
    X = np.concatenate([rng.standard_normal((25, 2)), rng.standard_normal((15, 2)) + 9.0,
                        rng.integers(-2, 3, (20, 2)) + 30.0]).astype(np.float32)
    labels = np.array([0] * 25 + [2] * 15 + [1] * 20)
    for metric in ("L2SqrtExpanded", "L1"):
        t = tsp.cross_component_nn(X, labels, 4, metric=TD[metric], device="cpu")  # 3 is empty
        j = jsp.cross_component_nn(X, labels, 4, metric=JD[metric])
        for a, b in zip(t[:2], j[:2]):
            equal(a, b)
        close(t[2], j[2])
        assert t[0].dtype == np.int32 and t[2].dtype == np.float32


# -- MST -----------------------------------------------------------------------------------------


def same_mst(t, j):
    equal(t.src, j.src)
    equal(t.dst, j.dst)
    equal(t.weights, j.weights)
    assert t.n_edges == j.n_edges


def test_mst_on_tied_integer_weights_matches_jax(rng):
    n = 60
    src = rng.integers(0, n, 400)
    dst = rng.integers(0, n, 400)
    w = rng.integers(1, 4, 400).astype(np.float32)  # many ties
    # both directions, self loops and padding at (n, n)
    rows = np.concatenate([src, dst, [5, n, n]])
    cols = np.concatenate([dst, src, [5, n, n]])
    vals = np.concatenate([w, w, [0.0, 0.0, 0.0]])
    t, j = both_coo(rows, cols, vals, (n, n))
    tm, jm = tsp.mst(t), jsp.mst(j)
    same_mst(tm, jm)
    assert tm.src.dtype == np.int32 and tm.weights.dtype == np.float32


def test_mst_on_a_forest_and_a_complete_graph_matches_jax(rng):
    t, j = both_coo([0, 1, 3, 4], [1, 2, 4, 5], [1.0, 2.0, 1.5, 2.5], (6, 6))
    tm = tsp.mst(t)
    same_mst(tm, jsp.mst(j))
    assert tm.n_edges == 4
    n = 30
    X = rng.standard_normal((n, 3)).astype(np.float32)
    d = ((X[:, None] - X[None, :]) ** 2).sum(-1).astype(np.float32)
    iu, ju = np.triu_indices(n, 1)
    t, j = both_coo(iu, ju, d[iu, ju], (n, n))
    tm = tsp.mst(t)
    same_mst(tm, jsp.mst(j))
    assert tm.n_edges == n - 1
    # a round bound stops early, as JAX's
    same_mst(tsp.mst(t, max_rounds=1), jsp.mst(j, max_rounds=1))


# -- Lanczos -------------------------------------------------------------------------------------


def jax_draws(monkeypatch):
    """Make the port draw JAX's start vector (key 0) and its restarts
    (``fold_in(fold_in(key, 1), step)``)."""
    base = jax_key(0)
    restart = jax.random.fold_in(base, 1)

    def draw(gen, n, step):
        key = base if step is None else jax.random.fold_in(restart, step)
        return torch.from_numpy(np.array(jax.random.normal(key, (n,), jnp.float32)))

    monkeypatch.setattr(tsolver, "_draw", draw)


def same_vectors_up_to_sign(t, j, atol=1e-3):
    t, j = arr(t), arr(j)
    for c in range(t.shape[1]):
        s = np.sign(np.dot(t[:, c], j[:, c])) or 1.0
        np.testing.assert_allclose(s * t[:, c], j[:, c], atol=atol)


def spd(n, seed=5):
    r = np.random.default_rng(seed)
    a = r.standard_normal((n, n)).astype(np.float32)
    return ((a + a.T) / 2 + n * np.eye(n, dtype=np.float32)).astype(np.float32)


CASES = {
    "smallest": (lambda: spd(60), 3, "smallest"),
    "largest": (lambda: spd(60), 2, "largest"),
    # eigenvalues {1, 3}: the Krylov space goes invariant after two steps
    "breakdown_smallest": (lambda: np.diag(np.r_[np.full(5, 3.0), np.ones(45)]).astype(np.float32),
                           3, "smallest"),
    "breakdown_largest": (lambda: np.diag(np.r_[np.full(5, 3.0), np.ones(45)]).astype(np.float32),
                          2, "largest"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_lanczos_with_jax_s_draws_matches_jax(case, monkeypatch):
    make, k, which = CASES[case]
    s = make()
    n = s.shape[0]
    jax_draws(monkeypatch)
    st = torch.from_numpy(s)
    lam_t, vec_t = tsp.lanczos(lambda v: st @ v, n, k, which=which, device="cpu")
    lam_j, vec_j = jsp.lanczos(lambda v: jnp.asarray(s) @ v, n, k, which=which)
    close(lam_t, lam_j, rtol=1e-4, atol=0)
    if not case.startswith("breakdown"):  # a repeated eigenvalue's vectors are not unique
        same_vectors_up_to_sign(vec_t, vec_j)
    ref = np.linalg.eigvalsh(s.astype(np.float64))
    close(lam_t, ref[:k] if which == "smallest" else ref[::-1][:k], rtol=1e-3, atol=0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_lanczos_with_its_own_draws_matches_jax(case):
    make, k, which = CASES[case]
    s = make()
    st = torch.from_numpy(s)
    for key in (None, 3, torch.Generator().manual_seed(9)):
        lam_t, vec_t = tsp.lanczos(lambda v: st @ v, s.shape[0], k, which=which, key=key,
                                   device="cpu")
        lam_j, _ = jsp.lanczos(lambda v: jnp.asarray(s) @ v, s.shape[0], k, which=which)
        close(lam_t, lam_j, rtol=1e-3, atol=0)
        # the vectors are eigenvectors
        res = s @ arr(vec_t) - arr(vec_t) * arr(lam_t)[None, :]
        assert np.abs(res).max() < 1e-2 * max(1.0, float(np.abs(arr(lam_t)).max()))
