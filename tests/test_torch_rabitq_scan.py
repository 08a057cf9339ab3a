"""The fused RaBitQ scan (kernel B3's module) against raft_tpu: the port's
plain ``fused_rabitq_topk`` against the Pallas kernel in interpret mode on
the same inputs, in the lossless window of the Pallas ``bank8`` merge
(single-list units of at most 8 * 128 rows, ``extract_every=1``; see
``tests/test_torch_pq_scan.py``). Slots are equal except at ties; scores
agree within ``1e-5 * sum|terms| + 1e-5``. The CUDA kernel is held against
the same plain version on the card by ``chip_smoke.py``."""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.ops.distance import DistanceType as JDT
from raft_tpu_torch.core.errors import LogicError
from raft_tpu_torch.ops import rabitq_scan as trq
from raft_tpu_torch.ops.distance import DistanceType as TDT

jrq = importlib.import_module("raft_tpu.ops.pallas.rabitq_scan")


def rabitq_inputs(metric, with_filter, seed=0, rot_dim=32):
    """Random kernel inputs: 6 single-list units of 40 rows (the last 7
    empty), 3 tiles of 8 queries, random sign codes and channels."""
    rng = np.random.default_rng(seed)
    n_units, m, qt, n_qt, p = 6, 40, 8, 3, 4
    codes = rng.integers(0, 256, (n_units, m, rot_dim // 8)).astype(np.uint8)
    q_rot = rng.normal(size=(n_qt * qt, rot_dim)).astype(np.float32)
    centers_rot = rng.normal(size=(n_units, 1, rot_dim)).astype(np.float32)
    valid = np.ones((n_units, m), bool)
    valid[:, 33:] = False
    if with_filter:
        valid &= rng.random((n_units, m)) < 0.7
    c1 = rng.uniform(1.0, 30.0, (n_units, m)) if metric != "InnerProduct" else np.zeros((n_units, m))
    g = rng.uniform(0.1, 3.0, (n_units, m))
    ln = np.where(valid, c1, np.inf).astype(np.float32).reshape(n_units, 1, m)
    corr = np.where(valid, g, 0.0).astype(np.float32).reshape(n_units, 1, m)
    tp = np.zeros((n_qt, p), np.int32)
    pv = np.zeros((n_qt, p), np.int32)
    for i in range(n_qt):
        nv = 2 + i % 3
        units = np.sort(rng.choice(n_units, nv, replace=False))
        tp[i, :nv], pv[i, :nv] = units, 1
        tp[i, nv:] = units[-1]
    return dict(codes=codes, ln=ln, corr=corr, q_rot=q_rot, centers_rot=centers_rot, tp=tp, pv=pv,
                qt=qt, m=m)


def rabitq_tolerance(inp):
    """``1e-5 * sum|terms| + 1e-5`` per query: the largest C1, ``2|q||c|``
    and the largest ``g`` times ``1.5 * sum|q_rot|``."""
    ln = inp["ln"][np.isfinite(inp["ln"])]
    aq = np.abs(inp["q_rot"])
    qc = aq @ np.abs(inp["centers_rot"][:, 0, :]).max(axis=0)
    terms = (np.abs(ln).max() if ln.size else 0.0) + 2.0 * qc + 1.5 * inp["corr"].max() * aq.sum(1)
    return (1e-5 * terms + 1e-5)[:, None]


def assert_close_topk(tv, ts, jv, js, tol):
    """Scores within ``tol`` [nq, 1]; slots equal except where the JAX row
    holds another score within ``tol`` of the differing one."""
    tv, ts, jv, js = tv.numpy(), ts.numpy(), np.asarray(jv), np.asarray(js)
    fin = np.isfinite(jv)
    assert np.array_equal(np.isfinite(tv), fin)
    err = np.where(fin, np.abs(tv - np.where(fin, jv, 0.0)), 0.0)
    assert (err <= np.broadcast_to(tol, err.shape)).all(), err.max()
    for i, j in np.argwhere(ts != js):
        near = np.abs(jv[i] - jv[i, j]) <= tol[i, 0]
        assert near.sum() >= 2, (i, j, ts[i], js[i], jv[i])


def _both(inp, metric, k):
    jv, js = jrq.fused_rabitq_topk(
        jnp.asarray(inp["codes"]), jnp.asarray(inp["ln"]), jnp.asarray(inp["corr"]),
        jnp.asarray(inp["q_rot"]), jnp.asarray(inp["centers_rot"]), jnp.asarray(inp["tp"]),
        jnp.asarray(inp["pv"]), k=k, metric=JDT[metric], qt=inp["qt"], merge="bank8",
        extract_every=1, interpret=True,
    )
    tv, ts = trq.fused_rabitq_topk(
        torch.from_numpy(inp["codes"]), torch.from_numpy(inp["ln"]), torch.from_numpy(inp["corr"]),
        torch.from_numpy(inp["q_rot"]), torch.from_numpy(inp["centers_rot"]),
        torch.from_numpy(inp["tp"]), torch.from_numpy(inp["pv"]), k=k, metric=TDT[metric],
        qt=inp["qt"],
    )
    return tv, ts, jv, js


@pytest.mark.parametrize("metric", ["L2Expanded", "L2SqrtExpanded", "InnerProduct"])
@pytest.mark.parametrize("with_filter", [False, True])
@pytest.mark.parametrize("rot_dim", [32, 136])
def test_plain_fused_rabitq_topk_matches_pallas_exact(metric, with_filter, rot_dim):
    inp = rabitq_inputs(metric, with_filter, rot_dim=rot_dim)
    assert inp["m"] <= 8 * 128  # one 128-lane group per bank: the bank8 merge is lossless
    tv, ts, jv, js = _both(inp, metric, k=10)
    assert ts.dtype == torch.int32 and tv.dtype == torch.float32
    assert_close_topk(tv, ts, jv, js, rabitq_tolerance(inp))


def test_k_larger_than_candidates_fills_empty():
    inp = rabitq_inputs("L2Expanded", True)
    tv, ts = trq.fused_rabitq_topk(
        torch.from_numpy(inp["codes"]), torch.from_numpy(inp["ln"]), torch.from_numpy(inp["corr"]),
        torch.from_numpy(inp["q_rot"]), torch.from_numpy(inp["centers_rot"]),
        torch.from_numpy(inp["tp"]), torch.from_numpy(inp["pv"]), k=200,
        metric=TDT.L2Expanded, qt=inp["qt"],
    )
    empty = ts.numpy() < 0
    assert empty.any() and np.isinf(tv.numpy()[empty]).all()
    assert np.isfinite(tv.numpy()[~empty]).all()


def test_sign_bits_match_pallas_unpack():
    codes = np.random.default_rng(3).integers(0, 256, (20, 4)).astype(np.uint8)
    ref = np.asarray(jrq._sign_bits(jnp.asarray(codes), rows=20, bpr=4, rot_dim=32))
    assert np.array_equal(trq.sign_bits(torch.from_numpy(codes)).numpy(), ref > 0)


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    def no_build(*a, **kw):
        raise AssertionError("kernel build reached from CPU tensors")

    monkeypatch.setattr(trq, "build_kernel", no_build)
    before = trq.fused_rabitq_topk.launches
    inp = rabitq_inputs("InnerProduct", False)
    _both(inp, "InnerProduct", k=5)
    assert trq.fused_rabitq_topk.launches == before


def test_bits_must_cover_rot_dim():
    inp = rabitq_inputs("L2Expanded", False)
    with pytest.raises(LogicError):
        trq.fused_rabitq_topk(
            torch.from_numpy(inp["codes"][:, :, :3].copy()), torch.from_numpy(inp["ln"]),
            torch.from_numpy(inp["corr"]), torch.from_numpy(inp["q_rot"]),
            torch.from_numpy(inp["centers_rot"]), torch.from_numpy(inp["tp"]),
            torch.from_numpy(inp["pv"]), k=5, metric=TDT.L2Expanded, qt=inp["qt"],
        )
