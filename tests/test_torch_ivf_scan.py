"""The fused probed-list scan (kernel B1's module) against raft_tpu: probe
tables and spatial rank exactly equal, and the port's plain
``fused_list_topk`` against the Pallas kernel in interpret mode with
``merge="exact"``. The CUDA kernel itself is held against the same plain
version on the card by ``chip_smoke.py``."""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.neighbors.ivf_common import probe_selection as j_probe_selection
from raft_tpu.ops.distance import DistanceType as JDT
from raft_tpu_torch.core.errors import LogicError
from raft_tpu_torch.ops import ivf_scan as tscan
from raft_tpu_torch.ops.distance import DistanceType as TDT

jscan = importlib.import_module("raft_tpu.ops.pallas.ivf_scan")

METRICS = ["L2Expanded", "L2SqrtExpanded", "InnerProduct", "CosineExpanded"]


def assert_topk_equal(tv, ts, jv, js, tol=1e-5):
    """Scores allclose(rtol=1e-5, atol=1e-4); slots equal except where the
    reference row holds another score within ``tol`` (relative) of it."""
    tv, ts = tv.numpy(), ts.numpy()
    jv, js = np.asarray(jv), np.asarray(js)
    assert np.array_equal(np.isfinite(tv), np.isfinite(jv))
    fin = np.isfinite(jv)
    np.testing.assert_allclose(tv[fin], jv[fin], rtol=1e-5, atol=1e-4)
    for i, j in np.argwhere(ts != js):
        v = jv[i, j]
        near = np.abs(jv[i] - v) <= tol * max(1.0, abs(v))
        assert near.sum() >= 2, (i, j, ts[i], js[i], jv[i])


@pytest.mark.parametrize("group", [1, 2])
@pytest.mark.parametrize("nq", [29, 32])
def test_build_tile_probe_tables_exactly_equal(group, nq):
    rng = np.random.default_rng(nq + group)
    n_lists, d = 12, 6
    centers = rng.normal(size=(n_lists, d)).astype(np.float32)
    q = rng.normal(size=(nq, d)).astype(np.float32)
    coarse, probed = j_probe_selection(jnp.asarray(centers), jnp.asarray(q), 3, JDT.L2Expanded)
    # integer-valued coarse scores force argmin ties
    coarse = np.round(np.asarray(coarse))
    rank = rng.permutation(n_lists).astype(np.int32)
    kw = dict(nq=nq, qt=8, n_lists=n_lists, group=group, n_probes=3, probe_factor=2)
    jo, jt, jv = jscan.build_tile_probe_tables(jnp.asarray(coarse), probed, jnp.asarray(rank), **kw)
    to, tt, tv = tscan.build_tile_probe_tables(
        torch.from_numpy(coarse), torch.from_numpy(np.array(probed)), torch.from_numpy(rank), **kw)
    assert np.array_equal(to.numpy(), np.asarray(jo))
    assert np.array_equal(tt.numpy(), np.asarray(jt))
    assert np.array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("n", [7, 64, 300])
def test_spatial_center_rank_equal(n):
    c = np.random.default_rng(n).normal(size=(n, 10)).astype(np.float32)
    assert np.array_equal(tscan.spatial_center_rank(c), jscan.spatial_center_rank(c))


def _scan_inputs(dtype, with_filter, seed=0):
    rng = np.random.default_rng(seed)
    n_units, gm, d, qt, n_qt, p = 6, 40, 16, 8, 3, 4
    if dtype == "int8":
        data = rng.integers(-20, 20, size=(n_units, gm, d)).astype(np.int8)
    else:
        data = rng.normal(size=(n_units, gm, d)).astype(np.float32)
    if dtype == "bfloat16":  # f32 values that bf16 holds exactly
        data = torch.from_numpy(data).to(torch.bfloat16).to(torch.float32).numpy()
    ids = np.arange(n_units * gm, dtype=np.int32).reshape(n_units, gm)
    ids[:, 33:] = -1  # padded tail of every unit
    norms = (data.astype(np.float32) ** 2).sum(axis=2)
    if with_filter:
        keep = rng.random(n_units * gm) < 0.7
        ids = np.where((ids >= 0) & keep[np.clip(ids, 0, None)], ids, -1).astype(np.int32)
    queries = rng.normal(size=(n_qt * qt, d)).astype(np.float32)
    if dtype == "int8":
        queries = np.round(queries * 8)  # integer queries: exact dots, real ties
    tp = np.zeros((n_qt, p), np.int32)
    pv = np.zeros((n_qt, p), np.int32)
    for i in range(n_qt):
        nv = 2 + i % 3
        units = np.sort(rng.choice(n_units, nv, replace=False))
        tp[i, :nv], pv[i, :nv] = units, 1
        tp[i, nv:] = units[-1]
    return data, norms, ids, queries, tp, pv, qt


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("dtype", ["float32", "int8", "bfloat16"])
@pytest.mark.parametrize("with_filter", [False, True])
def test_plain_fused_list_topk_matches_pallas_exact(metric, dtype, with_filter):
    """bf16 lists: both sides round the f32 queries to bf16 (the Pallas
    kernel for its bf16 matmul, the port before its f32 one)."""
    data, norms, ids, queries, tp, pv, qt = _scan_inputs(dtype, with_filter)
    if metric == "CosineExpanded":
        queries = queries / np.maximum(np.linalg.norm(queries, axis=1, keepdims=True), 1e-12)
    k = 10
    j_data, t_data = jnp.asarray(data), torch.from_numpy(data)
    if dtype == "bfloat16":
        j_data, t_data = j_data.astype(jnp.bfloat16), t_data.to(torch.bfloat16)
    jv, js = jscan.fused_list_topk(
        j_data, jnp.asarray(norms), jnp.asarray(ids), jnp.asarray(queries),
        jnp.asarray(tp), jnp.asarray(pv), k=k, metric=JDT[metric], qt=qt, merge="exact",
        interpret=True,
    )
    tv, ts = tscan.fused_list_topk(
        t_data, torch.from_numpy(norms), torch.from_numpy(ids),
        torch.from_numpy(queries), torch.from_numpy(tp), torch.from_numpy(pv),
        k=k, metric=TDT[metric], qt=qt,
    )
    assert ts.dtype == torch.int32
    assert_topk_equal(tv, ts, jv, js)


def test_k_larger_than_candidates_fills_empty():
    data, norms, ids, queries, tp, pv, qt = _scan_inputs("float32", True)
    tv, ts = tscan.fused_list_topk(
        torch.from_numpy(data), torch.from_numpy(norms), torch.from_numpy(ids),
        torch.from_numpy(queries), torch.from_numpy(tp), torch.from_numpy(pv),
        k=200, metric=TDT.L2Expanded, qt=qt,
    )
    empty = ts.numpy() < 0
    assert empty.any() and np.isinf(tv.numpy()[empty]).all()
    assert np.isfinite(tv.numpy()[~empty]).all()


def test_k_above_kernel_limit_raises():
    data, norms, ids, queries, tp, pv, qt = _scan_inputs("float32", False)
    with pytest.raises(LogicError):
        tscan.fused_list_topk(
            torch.from_numpy(data), torch.from_numpy(norms), torch.from_numpy(ids),
            torch.from_numpy(queries), torch.from_numpy(tp), torch.from_numpy(pv),
            k=tscan.MAX_K + 1, metric=TDT.L2Expanded, qt=qt,
        )


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    """CPU tensors never reach the kernel build or the launch counter."""

    def no_build(*a, **kw):
        raise AssertionError("kernel build reached from CPU tensors")

    monkeypatch.setattr(tscan, "build_kernel", no_build)
    before = tscan.fused_list_topk.launches
    data, norms, ids, queries, tp, pv, qt = _scan_inputs("float32", False)
    tscan.fused_list_topk(
        torch.from_numpy(data), torch.from_numpy(norms), torch.from_numpy(ids),
        torch.from_numpy(queries), torch.from_numpy(tp), torch.from_numpy(pv),
        k=5, metric=TDT.InnerProduct, qt=qt,
    )
    assert tscan.fused_list_topk.launches == before


@pytest.mark.parametrize("metric", METRICS)
def test_prepare_epilogue_matches_pallas_wrapper(metric):
    """The per-slot term equals what raft_tpu's wrapper hands its kernel
    (ivf_scan.py:390-398)."""
    _, norms, ids, *_ = _scan_inputs("float32", True)
    ln = tscan.prepare_epilogue(torch.from_numpy(norms), torch.from_numpy(ids), TDT[metric]).numpy()
    valid = ids >= 0
    if metric in ("L2Expanded", "L2SqrtExpanded"):
        ref = np.where(valid, norms, np.inf)
    elif metric == "InnerProduct":
        ref = np.where(valid, 0.0, np.inf)
    else:
        ref = 1.0 / np.sqrt(np.maximum(norms, 1e-24))
    np.testing.assert_allclose(ln, ref.astype(np.float32), rtol=1e-6)
