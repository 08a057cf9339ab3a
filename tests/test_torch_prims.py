"""The search path's primitives in raft_tpu_torch against raft_tpu on the
same numpy inputs: all 20 computable distance metrics (whole and with the
feature axis chunked), ``approx_select_k``, brute force under the
accumulation metrics, its approximate mode and ``BatchKQuery``, refine
under every metric, ``masked_l2_nn``, the kernel gram matrices, ``Bitmap``
and ``popcount32``, and the IVF-Flat kernel's own metric gate.

Tolerance: distances rtol 1e-5, atol 1e-5 (the two packages add f32 sums
in other orders; as ``tests/test_torch_ops.py``). Ids are equal where the
data has no ties; on tied data the port's ids are checked as a valid
resolution of the ties (off a TPU, ``lax.approx_min_k`` orders ties its own
way)."""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu import obs as jobs
from raft_tpu.core import bitset as jbitset
from raft_tpu.neighbors import brute_force as jbf
from raft_tpu.neighbors.refine import refine as jrefine
from raft_tpu.ops import distance as jdist
from raft_tpu.ops import kernels as jkern
from raft_tpu.ops.masked_nn import masked_l2_nn as jmasked
from raft_tpu.serve import ServingEngine as JEngine
from raft_tpu_torch import obs as tobs
from raft_tpu_torch.core import bitset as tbitset
from raft_tpu_torch.core.errors import LogicError
from raft_tpu_torch.core.resources import Resources
from raft_tpu_torch.neighbors import brute_force as tbf
from raft_tpu_torch.ops import distance as tdist
from raft_tpu_torch.ops import ivf_scan as tivf_scan
from raft_tpu_torch.ops import kernels as tkern
from raft_tpu_torch.ops.masked_nn import masked_l2_nn as tmasked
from raft_tpu_torch.serve import ServingEngine as TEngine

jsel = importlib.import_module("raft_tpu.ops.select_k")
tsel = importlib.import_module("raft_tpu_torch.ops.select_k")
trefine = importlib.import_module("raft_tpu_torch.neighbors.refine").refine

CPU = Resources(device="cpu")
RTOL, ATOL = 1e-5, 1e-5
DT = tdist.DistanceType
COMPUTABLE = [m for m in DT if m != DT.Precomputed]
ACCUM = [m for m in COMPUTABLE if m not in tdist.EXPANDED and m != DT.Haversine]
NONNEG = {DT.HellingerExpanded, DT.KLDivergence, DT.JensenShannon}
BINARY = {DT.JaccardExpanded, DT.DiceExpanded, DT.RusselRaoExpanded, DT.HammingUnexpanded}


def _inputs(metric, m, n, d, seed):
    """Rows fit to the metric: probability-like non-negative rows (some
    exact zeros) for Hellinger, KL and JS; 0/1 rows (one all zero) for the
    binary metrics; radians with d = 2 for Haversine; else normal rows
    with a zero row and zero entries, to reach the zero guards."""
    rng = np.random.default_rng(seed)
    if metric == DT.Haversine:
        def pts(k):
            return np.stack([rng.uniform(-np.pi / 2, np.pi / 2, k),
                             rng.uniform(-np.pi, np.pi, k)], 1).astype(np.float32)
        return pts(m), pts(n)
    if metric in NONNEG:
        def rows(k):
            v = rng.uniform(0.0, 1.0, (k, d)) * (rng.random((k, d)) > 0.2)
            return (v / np.maximum(v.sum(1, keepdims=True), 1e-6)).astype(np.float32)
        return rows(m), rows(n)
    if metric in BINARY:
        x = (rng.random((m, d)) < 0.4).astype(np.float32)
        y = (rng.random((n, d)) < 0.4).astype(np.float32)
        x[0] = 0.0
        y[1] = 0.0
        return x, y
    x = rng.standard_normal((m, d)).astype(np.float32)
    y = rng.standard_normal((n, d)).astype(np.float32)
    x[0] = 0.0
    y[2] = 0.0
    x[1, :3] = 0.0
    y[3, :3] = 0.0
    return x, y


def _arg(metric):
    return 3.0 if metric == DT.LpUnexpanded else 2.0


@pytest.mark.parametrize("metric", COMPUTABLE, ids=lambda m: m.name)
def test_pairwise_distance_every_metric(metric):
    x, y = _inputs(metric, 23, 31, 16, int(metric))
    ref = np.asarray(jdist.pairwise_distance(x, y, metric=int(metric), metric_arg=_arg(metric)))
    out = tdist.pairwise_distance(torch.from_numpy(x), torch.from_numpy(y), metric=metric,
                                  metric_arg=_arg(metric)).numpy()
    assert out.dtype == np.float32 and out.shape == (23, 31)
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("metric", ACCUM, ids=lambda m: m.name)
def test_accumulation_metrics_chunked(metric, monkeypatch):
    """A budget of the step's live blocks of 12 x 13 x 5 f32 cuts d = 37
    into chunks of 5 (the last of 2): the chunked combine equals JAX's
    result."""
    x, y = _inputs(metric, 12, 13, 37, 100 + int(metric))
    monkeypatch.setattr(tdist, "ACCUM_TEMP_BYTES", 12 * 13 * 5 * 4 * tdist.accum_live_blocks(metric))
    calls = []
    step = tdist.accum_step
    monkeypatch.setattr(tdist, "accum_step", lambda *a: calls.append(a[0].shape[-1]) or step(*a))
    out = tdist.pairwise_distance(torch.from_numpy(x), torch.from_numpy(y), metric=metric,
                                  metric_arg=_arg(metric)).numpy()
    assert calls == [5] * 7 + [2]
    ref = np.asarray(jdist.pairwise_distance(x, y, metric=int(metric), metric_arg=_arg(metric)))
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)


def test_metric_helpers_and_guards():
    rng = np.random.default_rng(5)
    a = rng.uniform(0, 1, 50).astype(np.float32)
    b = rng.uniform(0, 1, 50).astype(np.float32)
    a[:5] = 0.0
    b[3:8] = 0.0
    for name in ("kl_term", "js_term"):
        np.testing.assert_allclose(getattr(tdist, name)(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
                                   np.asarray(getattr(jdist, name)(a, b)), rtol=RTOL, atol=ATOL)
    p = rng.uniform(-1.5, 1.5, (4, 8)).astype(np.float32)
    np.testing.assert_allclose(tdist.haversine_core(*map(torch.from_numpy, p)).numpy(),
                               np.asarray(jdist.haversine_core(*p)), rtol=RTOL, atol=ATOL)
    x = torch.zeros((2, 3))
    with pytest.raises(LogicError):
        tdist.pairwise_distance(x, x, metric=DT.Precomputed)
    with pytest.raises(LogicError):
        tdist.pairwise_distance(x, x, metric=DT.Haversine)


def test_ivf_scan_metric_gate_stays_at_four():
    """The distance module computes every metric; the IVF-Flat kernel's
    own gate still takes exactly its four."""
    assert {m for m in DT if tivf_scan.supported_metric(m)} == {
        DT.L2Expanded, DT.L2SqrtExpanded, DT.InnerProduct, DT.CosineExpanded}


# -- approx_select_k ------------------------------------------------------------------------


@pytest.mark.parametrize("select_min", [True, False])
def test_approx_select_k_matches_jax(select_min):
    rng = np.random.default_rng(7)
    vals = rng.standard_normal((9, 3000)).astype(np.float32)
    jv, ji = jsel.approx_select_k(jnp.asarray(vals), 12, select_min=select_min)
    tv, ti = tsel.approx_select_k(torch.from_numpy(vals), 12, select_min=select_min)
    assert np.array_equal(tv.numpy(), np.asarray(jv))
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    payload = rng.integers(0, 1 << 30, vals.shape).astype(np.int32)
    _, tp = tsel.approx_select_k(torch.from_numpy(vals), 12, select_min=select_min,
                                 indices=torch.from_numpy(payload), recall_target=0.5)
    assert np.array_equal(tp.numpy(), np.take_along_axis(payload, ti.numpy().astype(np.int64), 1))


@pytest.mark.parametrize("select_min", [True, False])
def test_approx_select_k_ties_resolve_validly(select_min):
    """Integers 0..3: values equal JAX's; the ids are distinct columns
    holding the returned values (JAX's tie order is its own)."""
    rng = np.random.default_rng(8)
    vals = rng.integers(0, 4, size=(8, 1000)).astype(np.float32)
    jv, _ = jsel.approx_select_k(jnp.asarray(vals), 40, select_min=select_min)
    tv, ti = tsel.approx_select_k(torch.from_numpy(vals), 40, select_min=select_min)
    assert np.array_equal(tv.numpy(), np.asarray(jv))
    ids = ti.numpy().astype(np.int64)
    assert np.array_equal(np.take_along_axis(vals, ids, 1), tv.numpy())
    assert all(len(set(r)) == 40 for r in ids)


def test_approx_select_k_validates_k():
    v = torch.zeros((2, 5))
    for k in (0, 6):
        with pytest.raises(LogicError):
            tsel.approx_select_k(v, k)
    with pytest.raises(LogicError):
        tsel.approx_select_k(v, 2, recall_target=0.0)


# -- brute force ------------------------------------------------------------------------------


def _same_knn(t, j):
    tv, ti = (np.asarray(a) for a in t)
    jv, ji = (np.asarray(a) for a in j)
    np.testing.assert_allclose(tv, jv, rtol=RTOL, atol=ATOL)
    assert np.array_equal(ti, ji)


@pytest.mark.parametrize("metric", ACCUM, ids=lambda m: m.name)
def test_brute_force_exact_accumulation_metric(metric):
    x, q = _inputs(metric, 17, 300, 12, 200 + int(metric))[::-1]  # 300 rows, 17 queries
    ji = jbf.build(x, metric=int(metric), metric_arg=_arg(metric))
    ti = tbf.build(x, metric=metric, metric_arg=_arg(metric), res=CPU)
    ref = jbf.search(ji, q, 7)
    _same_knn(tbf.search(ti, torch.from_numpy(q), 7), ref)
    # several tiles of the running merge keep the whole block's answer
    _same_knn(tbf.search(ti, torch.from_numpy(q), 7, dataset_tile=64, query_batch=5), ref)


def test_brute_force_accumulation_tile_divides_by_dim(monkeypatch):
    x, q = _inputs(DT.L1, 9, 4000, 64, 3)[::-1]
    idx = tbf.build(x, metric="l1", res=CPU)
    tiles = []
    orig = tbf._search_batch
    monkeypatch.setattr(tbf, "_search_batch", lambda *a, **kw: tiles.append(kw["tile"]) or orig(*a, **kw))
    tbf.search(idx, torch.from_numpy(q), 5, res=Resources(device="cpu", workspace_bytes=1 << 20))
    assert tiles == [max(512, (1 << 20) // (8 * 64 * 9))]
    l2 = tbf.build(x, metric="sqeuclidean", res=CPU)
    tbf.search(l2, torch.from_numpy(q), 5, res=Resources(device="cpu", workspace_bytes=1 << 20))
    assert tiles[-1] == min(4000, (1 << 20) // (8 * 9))
    # above the 512-row floor the tile divides by the step's live blocks too
    for metric, blocks in (("l1", 2), ("canberra", 6), ("jensenshannon", 5)):
        tbf.search(tbf.build(np.abs(x), metric=metric, res=CPU), torch.from_numpy(np.abs(q)), 5,
                   res=Resources(device="cpu", workspace_bytes=1 << 24))
        assert tiles[-1] == (1 << 24) // (4 * blocks * 64 * 9)


@pytest.mark.parametrize("metric", ["sqeuclidean", "euclidean", "inner_product", "cosine",
                                    "correlation"])
def test_brute_force_approx_matches_jax(metric):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((700, 16)).astype(np.float32)
    q = rng.standard_normal((21, 16)).astype(np.float32)
    ref = jbf.search(jbf.build(x, metric=metric), q, 9, mode="approx", query_batch=8)
    ti = tbf.build(x, metric=metric, res=CPU)
    got = tbf.search(ti, torch.from_numpy(q), 9, mode="approx", query_batch=8, dataset_tile=100)
    _same_knn(got, ref)
    # exact on the card and here: the same ids as the exact mode
    exact = tbf.search(ti, torch.from_numpy(q), 9, mode="exact")
    assert torch.equal(got[1], exact[1])


@pytest.mark.parametrize("mode", ["exact", "approx"])
def test_brute_force_over_strict_prefilter_returns_minus_one(mode):
    rng = np.random.default_rng(12)
    x = rng.standard_normal((200, 8)).astype(np.float32)
    q = rng.standard_normal((6, 8)).astype(np.float32)
    keep = np.zeros(200, bool)
    keep[[3, 50, 177]] = True
    jf = jbitset.Bitset.from_mask(jnp.asarray(keep))
    tf = tbitset.Bitset.from_mask(torch.from_numpy(keep))
    jv, ji = jbf.search(jbf.build(x, metric="sqeuclidean"), q, 5, prefilter=jf, mode=mode)
    tv, ti = tbf.search(tbf.build(x, metric="sqeuclidean", res=CPU), torch.from_numpy(q), 5,
                        prefilter=tf, mode=mode, dataset_tile=64)
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    assert (ti.numpy()[:, 3:] == -1).all() and np.isinf(tv.numpy()[:, 3:]).all()
    np.testing.assert_allclose(tv.numpy()[:, :3], np.asarray(jv)[:, :3], rtol=RTOL, atol=ATOL)


def test_brute_force_mode_and_metric_errors():
    x = np.random.default_rng(13).standard_normal((50, 2)).astype(np.float32)
    q = torch.from_numpy(x[:3])
    with pytest.raises(LogicError, match="approx mode needs a matmul-shaped"):
        tbf.search(tbf.build(x, metric="l1", res=CPU), q, 4, mode="approx")
    with pytest.raises(LogicError, match="recall_target"):
        tbf.search(tbf.build(x, res=CPU), q, 4, mode="approx", recall_target=0.0)
    with pytest.raises(LogicError):
        tbf.search(tbf.build(x, res=CPU), q, 4, mode="fast")
    # JAX asserts inside its scan; the port raises LogicError up front
    with pytest.raises(AssertionError):
        jbf.search(jbf.build(x, metric="haversine"), x[:3], 4)
    with pytest.raises(LogicError):
        tbf.search(tbf.build(x, metric="haversine", res=CPU), q, 4)


def test_batch_k_query_pages():
    rng = np.random.default_rng(14)
    x = rng.standard_normal((150, 8)).astype(np.float32)
    q = rng.standard_normal((5, 8)).astype(np.float32)
    ti = tbf.build(x, metric="sqeuclidean", res=CPU)
    jq = jbf.BatchKQuery(jbf.build(x, metric="sqeuclidean"), q, batch_size=32)
    tq = tbf.BatchKQuery(ti, torch.from_numpy(q), batch_size=32)
    full_v, full_i = tbf.search(ti, torch.from_numpy(q), 150)
    pages = list(tq)
    assert [p.offset for p in pages] == [0, 32, 64, 96, 128]
    assert [p.indices.shape[1] for p in pages] == [32, 32, 32, 32, 22]
    for p, jp in zip(pages, jq):
        assert p.offset == jp.offset
        assert np.array_equal(p.indices.numpy(), np.asarray(jp.indices))
        np.testing.assert_allclose(p.distances.numpy(), np.asarray(jp.distances), rtol=RTOL, atol=ATOL)
        lo = p.offset
        assert torch.equal(p.indices, full_i[:, lo : lo + p.indices.shape[1]])
    # the lazy k grows 1.5x ahead of the page asked for, never past the size
    tq2 = tbf.BatchKQuery(ti, torch.from_numpy(q), batch_size=32)
    tq2.batch(1)
    assert tq2._k == 96
    with pytest.raises(LogicError):
        tq2.batch(5)


def test_approx_obs_matches_jax():
    rng = np.random.default_rng(15)
    x = rng.standard_normal((310, 8)).astype(np.float32)
    q = rng.standard_normal((13, 8)).astype(np.float32)
    ji = jbf.build(x, metric="sqeuclidean")
    ti = tbf.build(x, metric="sqeuclidean", res=CPU)
    out = {}
    for name, o, run in (("jax", jobs, lambda: jbf.search(ji, q, 3, mode="approx")),
                         ("port", tobs, lambda: tbf.search(ti, torch.from_numpy(q), 3, mode="approx"))):
        reg = o.registry()
        reg.reset()
        o.enable()
        try:
            run()
            out[name] = (reg.as_dict()["counters"], {(sp["name"], sp["depth"]) for sp in reg.spans()})
        finally:
            o.disable()
            reg.reset()
    assert out["port"] == out["jax"]
    assert ("brute_force.search.approx", 1) in out["port"][1]


def test_engine_serves_brute_force_approx_as_jax():
    """A registration's ``mode="approx"`` reaches brute force's search."""
    rng = np.random.default_rng(16)
    x = rng.standard_normal((500, 8)).astype(np.float32)
    q = rng.standard_normal((11, 8)).astype(np.float32)
    got = []
    for eng, idx in ((JEngine(max_batch=8, max_wait_ms=0.0), jbf.build(x, metric="sqeuclidean")),
                     (TEngine(max_batch=8, max_wait_ms=0.0, res=CPU),
                      tbf.build(x, metric="sqeuclidean", res=CPU))):
        eng.register("bf", "brute_force", idx, mode="approx")
        futs = [eng.submit("bf", q[s : s + 3], 4) for s in range(0, 11, 3)]
        eng.run_until_idle()
        got.append([f.result() for f in futs])
    for j, t in zip(*got):
        assert np.array_equal(np.asarray(t.indices), np.asarray(j.indices))
        np.testing.assert_allclose(np.asarray(t.distances), np.asarray(j.distances), rtol=RTOL, atol=ATOL)
    # the mode reaches the search: approx under L1 fails the batch in both
    for eng, idx in ((JEngine(max_batch=8, max_wait_ms=0.0), jbf.build(x, metric="l1")),
                     (TEngine(max_batch=8, max_wait_ms=0.0, res=CPU),
                      tbf.build(x, metric="l1", res=CPU))):
        eng.register("l1", "brute_force", idx, mode="approx")
        fut = eng.submit("l1", q[:2], 4)
        eng.run_until_idle()
        with pytest.raises(Exception, match="approx mode needs a matmul-shaped"):
            fut.result()


# -- refine -----------------------------------------------------------------------------------


@pytest.mark.parametrize("metric", [DT.L1, DT.Linf, DT.BrayCurtis, DT.LpUnexpanded,
                                    DT.CorrelationExpanded, DT.HellingerExpanded,
                                    DT.KLDivergence, DT.L2SqrtExpanded],
                         ids=lambda m: m.name)
def test_refine_under_any_metric(metric):
    x, q = _inputs(metric, 11, 400, 10, 300 + int(metric))[::-1]
    rng = np.random.default_rng(int(metric))
    cand = rng.choice(400, size=(11, 40), replace=True).astype(np.int32)
    cand[:, 0] = -1
    cand[2, :] = rng.permutation(400)[:40]
    jv, ji = jrefine(x, q, cand, 6, metric=int(metric), metric_arg=_arg(metric))
    tv, ti = trefine(torch.from_numpy(x), torch.from_numpy(q), torch.from_numpy(cand), 6,
                     metric=metric, metric_arg=_arg(metric))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=RTOL, atol=ATOL)
    # duplicate candidates tie: check each id holds its value
    d = tdist.pairwise_distance(torch.from_numpy(q), torch.from_numpy(x), metric,
                                metric_arg=_arg(metric)).numpy()
    np.testing.assert_allclose(np.take_along_axis(d, ti.numpy().astype(np.int64), 1), tv.numpy(),
                               rtol=RTOL, atol=ATOL)
    assert np.array_equal(ti.numpy()[2], np.asarray(ji)[2])


# -- masked_l2_nn -----------------------------------------------------------------------------


@pytest.mark.parametrize("sqrt", [False, True])
def test_masked_l2_nn_matches_jax(sqrt):
    rng = np.random.default_rng(16)
    x = rng.standard_normal((40, 6)).astype(np.float32)
    y = rng.standard_normal((70, 6)).astype(np.float32)
    group_idxs = np.array([10, 25, 25, 60, 70], np.int32)  # group 2 empty
    adj = rng.random((40, 5)) < 0.4
    adj[3] = False  # no adjacent group
    adj[4] = [False, False, True, False, False]  # only the empty group
    # a tie: two equal rows of y in one group, both nearest to x[5]
    y[12] = y[20] = x[5] + 0.01
    adj[5] = [False, True, False, False, False]
    ref = jmasked(x, y, adj, group_idxs, sqrt=sqrt, tile=16)
    got = tmasked(torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(adj),
                  torch.from_numpy(group_idxs), sqrt=sqrt, tile=16)
    assert np.array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=RTOL, atol=ATOL)
    assert got[1][3] == -1 and got[1][4] == -1 and np.isinf(got[0][3].item())
    assert got[1][5] == 12
    # the plain masked full-matrix argmin (first index on ties)
    d = tdist.pairwise_distance(torch.from_numpy(x), torch.from_numpy(y), "sqeuclidean")
    gid = np.clip(np.searchsorted(group_idxs, np.arange(70), side="right"), 0, 4)
    d[~torch.from_numpy(adj[:, gid])] = float("inf")
    want = torch.argmin(d, dim=1)
    rows = torch.isfinite(d.min(dim=1).values)
    assert torch.equal(got[1][rows].to(torch.int64), want[rows])


# -- kernel gram matrices ---------------------------------------------------------------------


@pytest.mark.parametrize("kernel", list(tkern.KernelType), ids=lambda k: k.name)
def test_gram_kernels_match_jax(kernel):
    rng = np.random.default_rng(17)
    x = (0.3 * rng.standard_normal((19, 9))).astype(np.float32)
    y = (0.3 * rng.standard_normal((23, 9))).astype(np.float32)
    kw = dict(degree=2, gamma=0.7, coef0=0.4)
    jp = jkern.KernelParams(kernel=jkern.KernelType(int(kernel)), **kw)
    tp = tkern.KernelParams(kernel=kernel, **kw)
    np.testing.assert_allclose(tkern.gram_matrix(torch.from_numpy(x), torch.from_numpy(y), tp).numpy(),
                               np.asarray(jkern.gram_matrix(x, y, jp)), rtol=RTOL, atol=ATOL)
    # y=None: the symmetric gram of x; kwargs stand for params
    np.testing.assert_allclose(tkern.gram_matrix(torch.from_numpy(x), kernel=kernel, **kw).numpy(),
                               np.asarray(jkern.gram_matrix(x, kernel=jkern.KernelType(int(kernel)), **kw)),
                               rtol=RTOL, atol=ATOL)


def test_gram_kernel_functions_match_jax():
    rng = np.random.default_rng(18)
    x = (0.3 * rng.standard_normal((8, 5))).astype(np.float32)
    y = (0.3 * rng.standard_normal((6, 5))).astype(np.float32)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    for t, j in ((tkern.linear_kernel(tx, ty), jkern.linear_kernel(x, y)),
                 (tkern.polynomial_kernel(tx, ty), jkern.polynomial_kernel(x, y)),
                 (tkern.tanh_kernel(tx, ty, 0.5, 0.1), jkern.tanh_kernel(x, y, 0.5, 0.1)),
                 (tkern.rbf_kernel(tx, ty, 2.0), jkern.rbf_kernel(x, y, 2.0))):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL, atol=ATOL)
    assert {k.name: int(k) for k in tkern.KernelType} == {k.name: int(k) for k in jkern.KernelType}


# -- Bitmap and popcount32 --------------------------------------------------------------------


def test_bitmap_matches_jax():
    rng = np.random.default_rng(19)
    mask = rng.random((7, 45)) < 0.5
    jb = jbitset.Bitmap.from_mask(jnp.asarray(mask))
    tb = tbitset.Bitmap.from_mask(torch.from_numpy(mask))
    assert (tb.rows, tb.cols) == (jb.rows, jb.cols) == (7, 45)
    assert np.array_equal(tb.bitset.words(), np.asarray(jb.bitset.bits))
    assert np.array_equal(tb.to_mask().numpy(), mask)
    r = rng.integers(0, 7, 30)
    c = rng.integers(0, 45, 30)
    assert np.array_equal(tb.test(torch.from_numpy(r), torch.from_numpy(c)).numpy(),
                          np.asarray(jb.test(jnp.asarray(r), jnp.asarray(c))))


def test_popcount32_matches_jax_with_the_high_bit_set():
    rng = np.random.default_rng(20)
    v = np.concatenate([np.array([0, 1, 0x80000000, 0xFFFFFFFF, 0x7FFFFFFF, 0x80000001],
                                 np.uint32),
                        rng.integers(0, 1 << 32, 200, dtype=np.uint64).astype(np.uint32)])
    ref = np.asarray(jbitset.popcount32(jnp.asarray(v)))
    for t in (torch.from_numpy(v.view(np.int32)), torch.from_numpy(v.astype(np.int64))):
        out = tbitset.popcount32(t)
        assert out.dtype == torch.int32
        assert np.array_equal(out.numpy(), ref)
    bs = tbitset.Bitset.from_mask(torch.from_numpy(rng.random(100) < 0.3))
    assert int(tbitset.popcount32(bs.bits).sum()) == bs.count()
