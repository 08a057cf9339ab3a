"""``stats``, ``label``, ``linalg``, ``matrix`` and ``core``'s
``array``/``logging``/``tracing``/``interruptible`` of raft_tpu_torch
against raft_tpu on the same numpy inputs (seeded). Tolerance: allclose
at rtol 1e-5 (f32; atol 1e-5 where a value can be near 0). ``svd``,
``eig_dc`` and ``qr`` are compared by their singular values or
eigenvalues and their reconstructions, so the freedom of signs is not a
failure; ``rsvd`` of an exactly low-rank matrix by its leading singular
values (1e-3 relative). ``histogram``, ``contingency_matrix``,
``make_monotonic``, ``merge_labels``, the arg-reductions and the gathers
are equal. The logging callback, pattern and level round-trip as in JAX;
tracing is a no-op when off and shows its ranges in a ``torch.profiler``
trace when on; ``interruptible.cancel`` from another thread raises at the
thread's next ``yield_`` (every join bounded); the ``core.interruptible``
lock runs under the lock witness with no violation."""
import contextlib
import json
import logging as pylogging
import os
import subprocess
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu import label as jlabel
from raft_tpu import linalg as jla
from raft_tpu import matrix as jmat
from raft_tpu import stats as jst
from raft_tpu.core import array as jarray
from raft_tpu.core import logging as jlog
from raft_tpu_torch import label as tlabel
from raft_tpu_torch import linalg as tla
from raft_tpu_torch import matrix as tmat
from raft_tpu_torch import stats as tst
from raft_tpu_torch.core import array as tarray
from raft_tpu_torch.core import interruptible as tint
from raft_tpu_torch.core import logging as tlog
from raft_tpu_torch.core import tracing as ttrace
from raft_tpu_torch.core.errors import LogicError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-5, 1e-5


def close(t, j, rtol=RTOL, atol=ATOL):
    if isinstance(t, (tuple, list)):
        assert len(t) == len(j)
        for a, b in zip(t, j):
            close(a, b, rtol, atol)
        return
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    np.testing.assert_allclose(t, np.asarray(j), rtol=rtol, atol=atol)


def equal(t, j):
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    np.testing.assert_array_equal(t, np.asarray(j))


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((300, 7)).astype(np.float32) * 2 + 1
    w = rng.uniform(0.1, 2.0, 300).astype(np.float32)
    return x, w, rng


# -- stats: summary ----------------------------------------------------------------------------


@pytest.mark.parametrize("along_rows", [True, False])
def test_summary_statistics_match_jax(data, along_rows):
    x, w, _ = data
    tx = torch.from_numpy(x)
    wv = w if along_rows else w[:7]
    close(tst.mean(tx, along_rows), jst.mean(x, along_rows))
    close(tst.sum_(tx, along_rows), jst.sum_(x, along_rows), atol=1e-4)
    for sample in (False, True):
        close(tst.stddev(tx, sample, along_rows), jst.stddev(x, sample, along_rows))
        close(tst.meanvar(tx, sample, along_rows), jst.meanvar(x, sample, along_rows))
    close(tst.mean_center(tx, along_rows=along_rows), jst.mean_center(x, along_rows=along_rows))
    mu = np.array(jst.mean(x, along_rows))
    close(tst.mean_center(tx, torch.from_numpy(mu), along_rows),
          jst.mean_center(x, jnp.asarray(mu), along_rows))
    close(tst.mean_add(tx, torch.from_numpy(mu), along_rows), jst.mean_add(x, jnp.asarray(mu), along_rows))
    close(tst.weighted_mean(tx, torch.from_numpy(wv), along_rows), jst.weighted_mean(x, wv, along_rows))
    equal(tst.minmax(tx, along_rows)[0], jst.minmax(x, along_rows)[0])
    equal(tst.minmax(tx, along_rows)[1], jst.minmax(x, along_rows)[1])


@pytest.mark.parametrize("sample", [True, False])
@pytest.mark.parametrize("stable", [True, False])
def test_cov_matches_jax(data, sample, stable):
    x, _, _ = data
    close(tst.cov(torch.from_numpy(x), sample=sample, stable=stable),
          jst.cov(x, sample=sample, stable=stable), atol=1e-4)


def test_histogram_equals_jax(data):
    x, _, _ = data
    for n_bins, lo, hi in ((10, -3.0, 5.0), (7, 0.0, 1.0), (32, -8.0, 8.0)):
        t = tst.histogram(torch.from_numpy(x), n_bins, lo, hi)
        assert t.dtype == torch.int32
        equal(t, jst.histogram(x, n_bins, lo, hi))


# -- stats: metrics ----------------------------------------------------------------------------


@pytest.fixture(scope="module")
def labelings():
    rng = np.random.default_rng(1)
    a = rng.integers(0, 6, 500)
    b = np.where(rng.random(500) < 0.7, a, rng.integers(0, 6, 500))
    return a.astype(np.int32), b.astype(np.int32)


def test_label_metrics_match_jax(labelings):
    a, b = labelings
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    equal(tst.contingency_matrix(ta, tb), jst.contingency_matrix(a, b))
    equal(tst.contingency_matrix(ta, tb, 9), jst.contingency_matrix(a, b, 9))
    close(tst.accuracy(ta, tb), jst.accuracy(a, b))
    for name in ("rand_index", "adjusted_rand_index", "mutual_info_score", "homogeneity_score",
                 "completeness_score", "v_measure"):
        close(getattr(tst, name)(ta, tb), getattr(jst, name)(a, b))
    close(tst.v_measure(ta, tb, beta=0.5), jst.v_measure(a, b, beta=0.5))
    close(tst.entropy(ta), jst.entropy(a))
    close(tst.entropy(ta, 8), jst.entropy(a, 8))
    # one class on one side: homogeneity / completeness take their 1.0 branch
    z = np.zeros_like(a)
    close(tst.homogeneity_score(torch.from_numpy(z), tb), jst.homogeneity_score(z, b))
    close(tst.completeness_score(ta, torch.from_numpy(z)), jst.completeness_score(a, z))


def test_regression_and_divergence_metrics_match_jax(data):
    x, w, rng = data
    y, yh = x[:, 0], x[:, 0] + 0.3 * x[:, 1]
    close(tst.r2_score(torch.from_numpy(y), torch.from_numpy(yh)), jst.r2_score(y, yh))
    for n in (300, 299):  # the median of an even and of an odd count
        close(tst.regression_metrics(torch.from_numpy(yh[:n]), torch.from_numpy(y[:n])),
              jst.regression_metrics(yh[:n], y[:n]))
    p = rng.uniform(0, 1, 50).astype(np.float32)
    q = rng.uniform(0, 1, 50).astype(np.float32)
    p[3] = q[7] = 0.0
    p, q = p / p.sum(), q / q.sum()
    close(tst.kl_divergence(torch.from_numpy(p), torch.from_numpy(q)), jst.kl_divergence(p, q))
    cents = x[:5]
    sizes = np.array([3, 10, 0, 7, 1], np.float32)
    close(tst.dispersion(torch.from_numpy(cents), torch.from_numpy(sizes)),
          jst.dispersion(cents, sizes))
    g = np.ones(7, np.float32)
    close(tst.dispersion(cents, sizes, g), jst.dispersion(cents, sizes, jnp.asarray(g)))
    for crit in tst.CriterionType:
        ll = np.array([-120.5, -80.25], np.float32)
        close(tst.information_criterion(torch.from_numpy(ll), crit, 4, 100),
              jst.information_criterion(ll, jst.CriterionType(int(crit)), 4, 100))


@pytest.mark.parametrize("chunk", [2048, 64])
def test_silhouette_and_trustworthiness_match_jax(data, chunk):
    x, _, rng = data
    labels = (x[:, 0] > 1).astype(np.int32) + 2 * (x[:, 1] > 1).astype(np.int32)
    labels[:2] = 4  # a cluster of two
    labels[2] = 5  # a singleton
    close(tst.silhouette_score(torch.from_numpy(x), torch.from_numpy(labels), chunk=chunk),
          jst.silhouette_score(x, labels, chunk=chunk))
    emb = x[:, :2] + 0.1 * rng.standard_normal((300, 2)).astype(np.float32)
    close(tst.trustworthiness_score(torch.from_numpy(x), torch.from_numpy(emb), 5, chunk=chunk),
          jst.trustworthiness_score(x, emb, 5, chunk=chunk))


# -- label -------------------------------------------------------------------------------------


def test_classlabels_equal_jax():
    rng = np.random.default_rng(2)
    y = rng.choice([-3, 4, 9, 17, 100], 200).astype(np.int32)
    equal(tlabel.get_classes(torch.from_numpy(y)), jlabel.get_classes(y))
    for zb in (True, False):
        tl, tc = tlabel.make_monotonic(torch.from_numpy(y), zero_based=zb)
        jl, jc = jlabel.make_monotonic(y, zero_based=zb)
        assert tl.dtype == torch.int32
        equal(tl, jl)
        equal(tc, jc)


def test_merge_labels_equal_jax():
    rng = np.random.default_rng(3)
    n = 120
    # a chain of alternating equivalences needs many passes
    a = (np.arange(n) // 2).astype(np.int32)
    b = ((np.arange(n) + 1) // 2).astype(np.int32)
    equal(tlabel.merge_labels(torch.from_numpy(a), torch.from_numpy(b)), jlabel.merge_labels(a, b))
    a = rng.integers(0, 40, n).astype(np.int32)
    b = rng.integers(0, 40, n).astype(np.int32)
    mask = rng.random(n) < 0.6
    for kw in ({}, {"mask": mask}, {"n_iters": 2}, {"mask": mask, "n_iters": 1}):
        t = tlabel.merge_labels(torch.from_numpy(a), torch.from_numpy(b), **kw)
        assert t.dtype == torch.int32
        equal(t, jlabel.merge_labels(a, b, **kw))


# -- linalg ------------------------------------------------------------------------------------


def test_blas_and_elementwise_match_jax(data):
    x, w, rng = data
    a = x[:20, :5]
    b = rng.standard_normal((5, 9)).astype(np.float32)
    c = rng.standard_normal((20, 9)).astype(np.float32)
    ta, tb, tc = (torch.from_numpy(v) for v in (a, b, c))
    close(tla.gemm(ta, tb), jla.gemm(a, b))
    close(tla.gemm(ta.T.contiguous(), tb.T.contiguous(), trans_a=True, trans_b=True, alpha=0.5,
                   beta=2.0, c=tc),
          jla.gemm(a.T, b.T, trans_a=True, trans_b=True, alpha=0.5, beta=2.0, c=c))
    with pytest.raises(LogicError):
        tla.gemm(ta, tb, beta=1.0)
    v = b[:, 0].copy()
    close(tla.gemv(ta, torch.from_numpy(v)), jla.gemv(a, v))
    close(tla.gemv(ta.T.contiguous(), torch.from_numpy(v), trans_a=True, alpha=2.0, beta=-1.0,
                   y=torch.from_numpy(a[:, 0].copy())),
          jla.gemv(a.T, v, trans_a=True, alpha=2.0, beta=-1.0, y=a[:, 0]))
    close(tla.dot(torch.from_numpy(w), torch.from_numpy(w)), jla.dot(w, w), rtol=1e-5)
    close(tla.axpy(1.5, ta, ta), jla.axpy(1.5, a, a))
    p = np.abs(a) + 0.5
    for name in ("add", "subtract", "eltwise_multiply", "eltwise_add", "divide", "power"):
        close(getattr(tla, name)(torch.from_numpy(p), ta), getattr(jla, name)(p, a))
    close(tla.multiply_scalar(ta, -3.0), jla.multiply_scalar(a, -3.0))
    close(tla.sqrt(torch.from_numpy(p)), jla.sqrt(p))
    close(tla.unary_op(ta, torch.exp), jla.unary_op(a, jnp.exp))
    close(tla.binary_op(ta, torch.from_numpy(p), torch.maximum),
          jla.binary_op(a, p, jnp.maximum))
    close(tla.ternary_op(ta, ta, torch.from_numpy(p), lambda u, v, z: u * v + z),
          jla.ternary_op(a, a, p, lambda u, v, z: u * v + z))
    close(tla.map_(lambda u, v: u - 2 * v, ta, torch.from_numpy(p)),
          jla.map_(lambda u, v: u - 2 * v, a, p))
    close(tla.transpose(ta), jla.transpose(a))
    close(tla.mean_squared_error(ta, torch.from_numpy(p), 0.5), jla.mean_squared_error(a, p, 0.5))


@pytest.mark.parametrize("n", [1, 2, 7, 64, 300])
def test_map_reduce_matches_jax(data, n):
    x, _, _ = data
    v = x[:n, 0].copy()
    close(tla.map_reduce(lambda u: u * u, torch.add, torch.from_numpy(v)),
          jla.map_reduce(lambda u: u * u, jnp.add, v), atol=1e-4)
    close(tla.map_reduce(lambda u, z: u - z, torch.maximum, torch.from_numpy(v),
                         torch.from_numpy(v[::-1].copy()), init=-np.inf),
          jla.map_reduce(lambda u, z: u - z, jnp.maximum, v, v[::-1], init=-np.inf))


def test_reductions_and_norms_match_jax(data):
    x, w, _ = data
    tx = torch.from_numpy(x)
    for along in (False, True):
        close(tla.reduce_(tx, along), jla.reduce_(x, along), atol=1e-4)
        close(tla.reduce_(tx, along, main_op=torch.abs, reduce_op=torch.amax, final_op=torch.sqrt),
              jla.reduce_(x, along, main_op=jnp.abs, reduce_op=jnp.max, final_op=jnp.sqrt))
        for nt in tla.ops.NormType:
            for sq in (False, True):
                close(tla.norm(tx, nt, along, sq), jla.norm(x, jla.ops.NormType(int(nt)), along, sq),
                      atol=1e-4)
        close(tla.matrix_vector_op(tx, torch.from_numpy(w[:7] if along else w), torch.mul, along),
              jla.matrix_vector_op(x, w[:7] if along else w, jnp.multiply, along))
    for nt in tla.ops.NormType:
        close(tla.normalize(tx, nt), jla.normalize(x, jla.ops.NormType(int(nt))))
    keys = (np.arange(300) * 7 % 11).astype(np.int32)
    close(tla.reduce_rows_by_key(tx, torch.from_numpy(keys), 13),
          jla.reduce_rows_by_key(x, keys, 13), atol=1e-4)
    close(tla.reduce_rows_by_key(tx, torch.from_numpy(keys), 11, weights=torch.from_numpy(w)),
          jla.reduce_rows_by_key(x, keys, 11, weights=w), atol=1e-4)
    ckeys = np.array([0, 2, 2, 1, 0, 3, 2], np.int32)
    close(tla.reduce_cols_by_key(tx, torch.from_numpy(ckeys), 4),
          jla.reduce_cols_by_key(x, ckeys, 4))


def test_decompositions_match_jax(data):
    x, _, rng = data
    a = x[:40, :7].astype(np.float32)
    sym = (a.T @ a / 40.0).astype(np.float32)
    tw, tv = tla.eig_dc(torch.from_numpy(sym))
    jw, _ = jla.eig_dc(sym)
    close(tw, jw, atol=1e-4)
    close(tv @ torch.diag(tw) @ tv.T, sym, atol=1e-4)
    for full in (False, True):
        tu, ts, tvv = tla.svd(torch.from_numpy(a), full_matrices=full)
        _, js, _ = jla.svd(a, full_matrices=full)
        close(ts, js, atol=1e-4)
        close(tu[:, :7] @ torch.diag(ts) @ tvv.T, a, atol=1e-4)
    tq, tr = tla.qr(torch.from_numpy(a))
    jq, jr = jla.qr(a)
    assert tuple(tq.shape) == np.asarray(jq).shape and tuple(tr.shape) == np.asarray(jr).shape
    close(tq @ tr, a, atol=1e-4)
    close(tq.T @ tq, np.eye(7), atol=1e-5)
    close(torch.triu(tr), tr)
    close(torch.abs(torch.diagonal(tr)), np.abs(np.diag(np.asarray(jr))), atol=1e-4)
    spd = sym + np.eye(7, dtype=np.float32)
    for lower in (True, False):
        close(tla.cholesky(torch.from_numpy(spd), lower), jla.cholesky(spd, lower), atol=1e-5)
    b = rng.standard_normal((40, 3)).astype(np.float32)
    close(tla.lstsq(torch.from_numpy(a), torch.from_numpy(b)), jla.lstsq(a, b), atol=1e-5)
    close(tla.lstsq(torch.from_numpy(a), torch.from_numpy(b[:, 0].copy())), jla.lstsq(a, b[:, 0]),
          atol=1e-5)
    # a rank-deficient system: both cut the zero singular value
    ad = np.concatenate([a[:, :3], a[:, :1] + a[:, 1:2]], axis=1)
    close(tla.lstsq(torch.from_numpy(ad), torch.from_numpy(b)), jla.lstsq(ad, b), atol=1e-4)


def test_rsvd_of_a_low_rank_matrix(data):
    _, _, rng = data
    u = np.linalg.qr(rng.standard_normal((200, 6)))[0]
    v = np.linalg.qr(rng.standard_normal((50, 6)))[0]
    s = np.array([40.0, 20.0, 9.0, 5.0, 2.0, 1.0])
    m = (u * s) @ v.T
    m = m.astype(np.float32)
    tu, ts, tv = tla.rsvd(torch.from_numpy(m), 4, key=3)
    _, js, _ = jla.rsvd(m, 4)
    np.testing.assert_allclose(ts.numpy(), s[:4], rtol=1e-3)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-3)
    assert tuple(tu.shape) == (200, 4) and tuple(tv.shape) == (50, 4)
    close(tu.T @ tu, np.eye(4), atol=1e-4)
    g = torch.Generator().manual_seed(9)
    np.testing.assert_allclose(tla.rsvd(torch.from_numpy(m), 6, p=4, key=g)[1].numpy(), s,
                               rtol=1e-3)


# -- matrix ------------------------------------------------------------------------------------


def test_matrix_ops_match_jax(data):
    x, _, rng = data
    tx = torch.from_numpy(x)
    idx = rng.integers(0, 300, 25).astype(np.int32)
    equal(tmat.gather(tx, torch.from_numpy(idx)), jmat.gather(x, idx))
    sten = rng.standard_normal(25).astype(np.float32)
    equal(tmat.gather_if(tx, torch.from_numpy(idx), torch.from_numpy(sten), lambda s: s > 0, fill=-1),
          jmat.gather_if(x, idx, sten, lambda s: s > 0, fill=-1))
    rows = np.array([5, 0, 17], np.int32)
    upd = rng.standard_normal((3, 7)).astype(np.float32)
    equal(tmat.scatter(tx, torch.from_numpy(rows), torch.from_numpy(upd)), jmat.scatter(x, rows, upd))
    assert torch.equal(tx, torch.from_numpy(x))  # a new tensor, as JAX's
    equal(tmat.matrix_slice(tx, 3, 1, 40, 6), jmat.matrix_slice(x, 3, 1, 40, 6))
    with pytest.raises(LogicError):
        tmat.matrix_slice(tx, 3, 1, 3, 6)
    ties = np.round(x * 2) / 2  # ties: the first index wins in both
    for name in ("argmax", "argmin"):
        t = getattr(tmat, name)(torch.from_numpy(ties))
        assert t.dtype == torch.int32
        equal(t, getattr(jmat, name)(ties))
    for asc in (True, False):
        equal(tmat.col_wise_sort(tx, asc), jmat.col_wise_sort(x, asc))
    sq = x[:7]
    equal(tmat.diagonal(torch.from_numpy(sq)), jmat.diagonal(sq))
    v7, v300 = x[0], x[:, 0].copy()
    close(tmat.linewise_op(tx, torch.from_numpy(v7), torch.sub), jmat.linewise_op(x, v7, jnp.subtract))
    close(tmat.linewise_op(tx, torch.from_numpy(v300), torch.mul, along_lines=False),
          jmat.linewise_op(x, v300, jnp.multiply, along_lines=False))
    for along in (False, True):
        equal(tmat.reverse(tx, along), jmat.reverse(x, along))
    equal(tmat.sign_flip(tx), jmat.sign_flip(x))
    equal(tmat.threshold(tx, 0.5, fill=-9.0), jmat.threshold(x, 0.5, fill=-9.0))
    equal(tmat.triangular_upper(tx), jmat.triangular_upper(x))
    sv, si = tmat.select_k(tx, 3)
    jv, ji = jmat.select_k(x, 3)
    equal(sv, jv)
    equal(si, ji)


def test_sample_rows_draws_distinct_rows(data):
    x, _, _ = data
    tx = torch.from_numpy(x)
    s = tmat.sample_rows(4, tx, 50)
    assert tuple(s.shape) == (50, 7)
    hits = (s[:, None, :] == tx[None, :, :]).all(-1)
    assert bool(hits.any(1).all()) and len(set(torch.nonzero(hits)[:, 1].tolist())) == 50
    g = torch.Generator().manual_seed(4)
    assert torch.equal(tmat.sample_rows(g, tx, 50), s)
    assert tuple(np.asarray(jmat.sample_rows(4, x, 50)).shape) == (50, 7)
    with pytest.raises(LogicError):
        tmat.sample_rows(0, tx, 301)


# -- core --------------------------------------------------------------------------------------


def test_array_ingestion_and_checks():
    a = np.arange(12, dtype=np.float64).reshape(3, 4)
    t = tarray.as_array(a, dtype=np.float32, ndim=2, device="cpu")
    j = jarray.as_array(a, dtype=jnp.float32, ndim=2)
    assert t.dtype == torch.float32 and str(np.asarray(j).dtype) == "float32"
    equal(t, j)
    src = torch.ones(2, 3)
    assert tarray.as_array(src) is src
    assert tarray.as_array(src, dtype=torch.int32).dtype == torch.int32
    equal(tarray.as_array([[1, 2], [3, 4]], device="cpu"), jarray.as_array([[1, 2], [3, 4]]))
    equal(tarray.as_array(jnp.arange(5), device="cpu"), np.arange(5))
    with pytest.raises(LogicError, match="x must be 3-dimensional"):
        tarray.as_array(a, ndim=3, name="x", device="cpu")
    tarray.check_matching_dims(t, torch.zeros(4, 2), 1, 0, "mm")
    with pytest.raises(LogicError, match="mm: dimension mismatch"):
        tarray.check_matching_dims(t, torch.zeros(5, 2), 1, 0, "mm")
    tarray.check_dtype_one_of(t, [np.float32, torch.float16])
    with pytest.raises(LogicError, match="unsupported dtype"):
        tarray.check_dtype_one_of(t, [np.int8, torch.uint8], name="codes")


def _log_script(mod):
    got = []
    mod.set_callback(lambda lvl, msg: got.append((lvl, msg)))
    try:
        mod.set_pattern("%(message)s")
        mod.set_level(mod.LEVEL_INFO)
        mod.info("hello %d", 42)
        mod.warn("careful")
        mod.debug("filtered out")
        mod.set_pattern("[%(levelname)s] %(message)s")
        mod.error("boom")
        mod.set_level(mod.LEVEL_TRACE)
        mod.trace("deep %s", "detail")
        mod.set_level(mod.LEVEL_OFF)
        mod.critical("silenced")
        levels = []
        for lvl in (mod.LEVEL_OFF, mod.LEVEL_CRITICAL, mod.LEVEL_ERROR, mod.LEVEL_WARN,
                    mod.LEVEL_INFO, mod.LEVEL_DEBUG, mod.LEVEL_TRACE, 999):
            mod.set_level(lvl)
            levels.append(mod.get_level())
        mod.set_level(mod.LEVEL_INFO)
        mod.set_callback(None)
        removed = mod._cb_handler not in mod.logger.handlers
        mod.info("dropped")
    finally:
        mod.set_callback(None)
        mod.set_level(mod.LEVEL_INFO)
    return got, levels, removed


def test_logging_round_trips_as_jax():
    assert _log_script(tlog) == _log_script(jlog)
    got, levels, removed = _log_script(tlog)
    assert got == [(pylogging.INFO, "hello 42"), (pylogging.WARNING, "careful"),
                   (pylogging.ERROR, "[ERROR] boom"), (5, "[Level 5] deep detail")]
    assert levels == [0, 1, 2, 3, 4, 5, 6, 4] and removed
    assert tlog.logger.name == "raft_tpu_torch"


@pytest.fixture
def tracing_state():
    was = ttrace.is_enabled()
    yield
    ttrace.enable(was)


def test_tracing_off_is_a_no_op(tracing_state, monkeypatch):
    calls = []

    class Count(contextlib.nullcontext):
        def __init__(self, name):
            calls.append(name)
            super().__init__()

    monkeypatch.setattr(torch.profiler, "record_function", Count)

    @ttrace.annotate()
    def work(a, b=1):
        return a + b

    ttrace.enable(False)
    with ttrace.push_range("off"):
        pass
    assert work(1) == 2
    assert isinstance(ttrace.named_scope("off"), contextlib.nullcontext)
    assert calls == []
    ttrace.enable(True)
    with ttrace.push_range("on"):
        pass
    assert work(2, b=3) == 5 and work.__name__ == "work"
    with ttrace.named_scope("scope"):
        pass
    assert calls == ["on", f"raft_tpu_torch::{work.__wrapped__.__qualname__}", "scope"]
    assert ttrace.range is ttrace.push_range


def test_tracing_ranges_show_in_a_profiler_trace(tracing_state):
    ttrace.enable(True)

    @ttrace.annotate("unit.annotated")
    def work():
        return torch.ones(8).sum()

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with ttrace.push_range("unit.range"):
            torch.arange(16.0).sum()
        work()
        with ttrace.named_scope("unit.scope"):
            torch.zeros(4).add_(1)
    names = {e.name for e in prof.events()}
    assert {"unit.range", "unit.annotated", "unit.scope"} <= names


def test_interruptible_cancel_from_another_thread():
    assert not tint.yield_no_throw()
    tint.cancel(threading.get_ident())
    assert tint.yield_no_throw() and not tint.yield_no_throw()
    ready, go = threading.Event(), threading.Event()
    out = {}

    def worker():
        out["tid"] = threading.get_ident()
        ready.set()
        go.wait(timeout=30)
        try:
            tint.yield_()
            out["raised"] = False
        except tint.InterruptedException:
            out["raised"] = True
        tint.yield_()  # the token was cleared
        out["value"] = tint.synchronize(torch.ones(3))

    th = threading.Thread(target=worker)
    th.start()
    assert ready.wait(timeout=30)
    tint.cancel(out["tid"])
    go.set()
    th.join(timeout=30)
    assert not th.is_alive()
    assert out["raised"] is True and torch.equal(out["value"], torch.ones(3))
    tint.cancel(threading.get_ident())
    with pytest.raises(tint.InterruptedException):
        tint.synchronize()
    assert issubclass(tint.InterruptedException, tint.RaftError)


_LOCKCHECK = r"""
import json, threading
from raft_tpu_torch.core import interruptible as ti
from raft_tpu_torch.utils import lockcheck as tl
assert tl.is_enabled()
tl.reset()
ti.yield_no_throw()
th = threading.Thread(target=lambda: ti.cancel(threading.get_ident() + 1))
th.start(); th.join(timeout=30)
print(json.dumps({"name": ti._lock.name, "violations": tl.violations()}))
"""


def test_interruptible_lock_under_the_witness():
    env = dict(os.environ, RAFT_TPU_LOCKCHECK="1")
    env.pop("RAFT_TPU_LOCKCHECK_MANIFEST", None)
    out = subprocess.run([sys.executable, "-c", _LOCKCHECK], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    rep = json.loads(out.stdout.strip().splitlines()[-1])
    assert rep == {"name": "core.interruptible", "violations": []}
