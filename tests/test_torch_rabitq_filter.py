"""The filter of kernel B3 (``raft_tpu_torch/csrc/rabitq_scan.cu``) on the
CPU: the bf16 product's error bound (:func:`filter_error`), the estimator's
lower bound (:func:`estimator_lower_bound`), the kernel's schedule in plain
PyTorch (:func:`fused_rabitq_topk_filtered_reference`) against the plain
version and against the Pallas kernel in interpret mode, and the CTA plan
the wrapper mirrors from the ``.cu``. The kernel itself is held against
the plain version, and its filter's bound counted, on the card by
``chip_smoke.py``."""
import importlib
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from raft_tpu.ops.distance import DistanceType as JDT
from raft_tpu_torch.core.errors import LogicError, RaftError
from raft_tpu_torch.ops import rabitq_scan as trq
from raft_tpu_torch.ops.distance import DistanceType as TDT
from raft_tpu_torch.ops.pq_scan import SMEM_LIMIT_BYTES

jrq = importlib.import_module("raft_tpu.ops.pallas.rabitq_scan")

_CU = os.path.join(os.path.dirname(trq.__file__), os.pardir, "csrc", "rabitq_scan.cu")
_SETTINGS = settings(max_examples=40, deadline=None, derandomize=True)


def mixed_queries(rng, n, rot_dim):
    """Queries of mixed sign and of scales from 1e-3 to 1e3, per query and
    per dimension."""
    scale = 10.0 ** rng.uniform(-3, 3, (n, 1)) * 10.0 ** rng.uniform(-1.5, 1.5, (n, rot_dim))
    return (rng.standard_normal((n, rot_dim)) * scale).astype(np.float32)


def dim_order_dot(q, bits):
    """``b . q`` summed in dimension order in f32, as the plain version."""
    acc = torch.zeros((q.shape[0], bits.shape[0]), dtype=torch.float32)
    for t in range(q.shape[1]):
        acc = acc + torch.where(bits[None, :, t], q[:, t, None], torch.zeros(()))
    return acc


def _round_toward_zero(x64):
    """f64 -> f32 rounded toward zero (a truncating accumulator's step)."""
    x32 = x64.astype(np.float32)
    over = np.abs(x32.astype(np.float64)) > np.abs(x64)
    x32[over] = np.nextafter(x32[over], np.float32(0))
    return x32


def hi_sums(hi, bits):
    """``hi . b`` in f32 in several orders: forward, reverse, pairwise,
    ``torch.matmul``, and 16 products at a time added exactly and truncated
    toward zero (a tensor core's f32 sum). ``[nq, D]``, ``[rows, D]`` ->
    dict of ``[nq, rows]`` f32."""
    prod = torch.where(bits[None], hi[:, None, :], torch.zeros(()))  # [nq, rows, D]
    fwd = torch.zeros(prod.shape[:2], dtype=torch.float32)
    rev = torch.zeros(prod.shape[:2], dtype=torch.float32)
    for t in range(prod.shape[2]):
        fwd = fwd + prod[:, :, t]
        rev = rev + prod[:, :, prod.shape[2] - 1 - t]
    level = prod
    while level.shape[2] > 1:
        if level.shape[2] % 2:
            level = torch.nn.functional.pad(level, (0, 1))
        level = level[:, :, 0::2] + level[:, :, 1::2]
    p64 = prod.numpy().astype(np.float64)
    trunc = np.zeros(prod.shape[:2], np.float32)
    for t0 in range(0, p64.shape[2], 16):
        trunc = _round_toward_zero(trunc.astype(np.float64) + p64[:, :, t0:t0 + 16].sum(axis=2))
    return {"forward": fwd, "reverse": rev, "pairwise": level[:, :, 0],
            "matmul": hi @ bits.to(torch.float32).T, "truncated_k16": torch.from_numpy(trunc)}


@_SETTINGS
@given(seed=st.integers(0, 2 ** 31 - 1), rot_dim=st.sampled_from([8, 24, 136]),
       density=st.sampled_from([0.1, 0.5, 0.9, 1.0]))
def test_filter_error_bounds_the_bf16_product_in_any_order(seed, rot_dim, density):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(mixed_queries(rng, 6, rot_dim))
    bits = torch.from_numpy(rng.random((40, rot_dim)) < density)
    hi = trq.bf16_plane(q).to(torch.float32)
    delta = trq.filter_error(q).to(torch.float64)
    exact = dim_order_dot(q, bits).to(torch.float64)
    for order, acc in hi_sums(hi, bits).items():
        gap = (acc.to(torch.float64) - exact).abs()
        assert (gap <= delta[:, None]).all(), (order, float((gap - delta[:, None]).max()))


def test_filter_error_covers_the_product_depth_padding():
    """rot_dim 8 and 24 are summed over 16 and 32 products (the padded
    depth): the bound grows with the padded depth, not the true one."""
    q = torch.ones((1, 24), dtype=torch.float32)
    assert float(trq.filter_error(q)) >= 8 * 32 * 2.0 ** -23 * 24
    assert trq.filter_error(q).dtype == torch.float32


def _lb_case(seed, metric, g_sign):
    rng = np.random.default_rng(seed)
    rot_dim = int(rng.choice([8, 24, 136]))
    q = torch.from_numpy(mixed_queries(rng, 4, rot_dim))
    bits = torch.from_numpy(rng.random((32, rot_dim)) < 0.5)
    qc = (torch.from_numpy(rng.standard_normal((4, 1)).astype(np.float32))
          * q.abs().sum(1, keepdim=True))
    ln = torch.from_numpy(rng.uniform(0, 50, (1, 32)).astype(np.float32))
    ln[0, :3] = float("inf")  # empty or filtered slots
    g = torch.from_numpy(rng.uniform(0.01, 4.0, (1, 32)).astype(np.float32)) * g_sign
    g[0, ::7] = 0.0
    coef = 1.0 if metric == "InnerProduct" else 2.0
    sq = torch.zeros((4,), dtype=torch.float32)
    for t in range(rot_dim):
        sq = sq + q[:, t]
    h = 0.5 * sq[:, None]
    t2 = ln - coef * qc
    dot = dim_order_dot(q, bits)
    exact = t2 - g * (dot - h)
    delta = trq.filter_error(q)[:, None]
    hi = trq.bf16_plane(q).to(torch.float32)
    accs = list(hi_sums(hi, bits).values())
    # the ends of the interval the bound admits, rounded inward
    accs += [torch.nextafter(dot + delta, dot), torch.nextafter(dot - delta, dot)]
    return exact, [trq.estimator_lower_bound(acc, delta, h, t2, g) for acc in accs], ln


@_SETTINGS
@given(seed=st.integers(0, 2 ** 31 - 1),
       metric=st.sampled_from(["L2Expanded", "L2SqrtExpanded", "InnerProduct"]),
       g_sign=st.sampled_from([-1.0, 0.0, 1.0]))
def test_lower_bound_never_exceeds_the_exact_score(seed, metric, g_sign):
    exact, bounds, ln = _lb_case(seed, metric, g_sign)
    for lb in bounds:
        assert (lb <= exact).all(), float((lb - exact).max())
    # an empty slot scores +inf and so does its bound: it never enters a list
    assert torch.isinf(exact[:, :3]).all() and all(torch.isinf(lb[:, :3]).all() for lb in bounds)


def _inputs(seed, rot_dim=32, with_filter=False, m=300, n_units=5, qt=24, n_qt=2, p=4):
    """Kernel inputs with units of two lists of ``m`` rows (the last ones
    empty), large enough that candidate buffers fill and flush."""
    rng = np.random.default_rng(seed)
    G = 2
    gm = G * m
    codes = rng.integers(0, 256, (n_units, gm, rot_dim // 8)).astype(np.uint8)
    q_rot = mixed_queries(rng, n_qt * qt, rot_dim) / 1e3 + rng.normal(size=(n_qt * qt, rot_dim))
    centers_rot = rng.normal(size=(n_units, G, rot_dim)).astype(np.float32)
    valid = np.ones((n_units, gm), bool)
    valid[:, m - 17:m] = False
    valid[:, gm - 40:] = False
    if with_filter:
        valid &= rng.random((n_units, gm)) < 0.7
    c1 = rng.uniform(1.0, 30.0, (n_units, gm))
    g = rng.uniform(-0.5, 3.0, (n_units, gm))
    tp = np.zeros((n_qt, p), np.int32)
    pv = np.zeros((n_qt, p), np.int32)
    for i in range(n_qt):
        nv = 2 + i % 3
        units = np.sort(rng.choice(n_units, nv, replace=False))
        tp[i, :nv], pv[i, :nv] = units, 1
        tp[i, nv:] = units[-1]
    return dict(codes=codes, c1=c1, g=g, valid=valid, q_rot=q_rot.astype(np.float32),
                centers_rot=centers_rot, tp=tp, pv=pv, qt=qt)


def _tensors(inp):
    n_units, gm = inp["valid"].shape
    ln = np.where(inp["valid"], inp["c1"], np.inf).astype(np.float32).reshape(n_units, 1, gm)
    corr = np.where(inp["valid"], inp["g"], 0.0).astype(np.float32).reshape(n_units, 1, gm)
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in
            (inp["codes"], ln, corr, inp["q_rot"], inp["centers_rot"], inp["tp"], inp["pv"])]


def _plant_tie(inp, k, metric):
    """Copy the row at query 0's k-th place into three other valid rows of
    its list (lower and higher slots): its score then holds the k-th place
    and the one after it."""
    args = _tensors(inp)
    v, s = trq.fused_rabitq_topk_reference(*args, k=k, metric=metric, qt=inp["qt"])
    slot = int(s[0, k - 1])
    assert slot >= 0
    gm = inp["valid"].shape[1]
    u, r = divmod(slot, gm)
    m = gm // 2
    lo = (r // m) * m
    held = set(s[0].tolist())
    others = [x for x in range(lo, lo + m - 17) if x != r and u * gm + x not in held]
    others = [others[0], others[1], others[-1]]  # below and above the row's slot
    for x in others:
        inp["codes"][u, x] = inp["codes"][u, r]
        inp["c1"][u, x], inp["g"][u, x], inp["valid"][u, x] = inp["c1"][u, r], inp["g"][u, r], True
    args = _tensors(inp)
    v2, s2 = trq.fused_rabitq_topk_reference(*args, k=k, metric=metric, qt=inp["qt"])
    # the four equal scores hold the k-th place and the three after it
    planted = {u * gm + x for x in others + [r]}
    assert len(others) == 3 and float(v2[0, k - 1]) == float(v[0, k - 1])
    assert len(planted & set(s2[0].tolist())) == 1 and int(s2[0, k - 1]) in planted
    return args


@pytest.mark.parametrize("k", [1, 10, 80, 256])
@pytest.mark.parametrize("with_filter", [False, True])
@pytest.mark.parametrize("n_split", [1, 3])
def test_filtered_schedule_equals_plain_version_bit_for_bit(k, with_filter, n_split):
    metric = TDT.InnerProduct if k == 80 else TDT.L2Expanded
    inp = _inputs(7 + k, with_filter=with_filter, rot_dim=136 if k == 10 else 32)
    args = _plant_tie(inp, k, metric)
    rv, rs = trq.fused_rabitq_topk_reference(*args, k=k, metric=metric, qt=inp["qt"])
    fv, fs = trq.fused_rabitq_topk_filtered_reference(*args, k=k, metric=metric, qt=inp["qt"],
                                                      n_split=n_split)
    assert torch.equal(fv.view(torch.int32), rv.view(torch.int32))
    assert torch.equal(fs, rs)
    assert (rs >= 0).any() and fs.dtype == torch.int32


def test_filtered_schedule_flushes_and_holds_ties_at_small_plans():
    """The smallest plan (8 queries a CTA, 64-row chunks) flushes its
    buffers many times over these units and still equals the plain version."""
    inp = _inputs(3, m=700, qt=8, n_qt=2)
    args = _plant_tie(inp, 10, TDT.L2Expanded)
    plan = trq.CtaPlan(queries=8, rows=64, smem_bytes=0, ctas_per_sm=1)
    rv, rs = trq.fused_rabitq_topk_reference(*args, k=10, metric=TDT.L2Expanded, qt=8)
    fv, fs = trq.fused_rabitq_topk_filtered_reference(*args, k=10, metric=TDT.L2Expanded, qt=8,
                                                      plan=plan)
    assert torch.equal(fv.view(torch.int32), rv.view(torch.int32)) and torch.equal(fs, rs)


@pytest.mark.parametrize("metric", ["L2Expanded", "InnerProduct"])
def test_filtered_schedule_matches_pallas(metric):
    """The kernel's schedule against the Pallas kernel in interpret mode, in
    the lossless window of its bank8 merge (single-list units of at most
    8 * 128 rows, ``extract_every=1``), as tests/test_torch_rabitq_scan.py
    holds the plain version."""
    from test_torch_rabitq_scan import assert_close_topk, rabitq_inputs, rabitq_tolerance

    inp = rabitq_inputs(metric, True, seed=5, rot_dim=136)
    jv, js = jrq.fused_rabitq_topk(
        *(jnp.asarray(inp[x]) for x in ("codes", "ln", "corr", "q_rot", "centers_rot", "tp", "pv")),
        k=10, metric=JDT[metric], qt=inp["qt"], merge="bank8", extract_every=1, interpret=True)
    tv, ts = trq.fused_rabitq_topk_filtered_reference(
        *(torch.from_numpy(inp[x]) for x in ("codes", "ln", "corr", "q_rot", "centers_rot", "tp",
                                             "pv")), k=10, metric=TDT[metric], qt=inp["qt"])
    assert_close_topk(tv, ts, jv, js, rabitq_tolerance(inp))


def _cu_constant(name):
    src = open(_CU).read()
    return int(eval(re.search(rf"constexpr int {name} = ([^;]+);", src).group(1)))


def test_constants_mirror_the_cu_source():
    got = tuple(_cu_constant(n) for n in ("QB_MAX", "QW", "ROUND", "CAP", "NS", "ROW_PAD",
                                          "LUT_BYTES", "DS"))
    assert got == trq._LAYOUT
    assert trq.QUERIES_PER_CTA[0] == got[0] and all(q % got[1] == 0 for q in trq.QUERIES_PER_CTA)
    assert all(r % got[2] == 0 for r in trq.ROWS_PER_CHUNK) and got[7] % 16 == 0


def test_cta_plan_at_the_served_shape():
    plan = trq.cta_plan(128, 80, 8, 128)
    assert (plan.queries, plan.rows, plan.ctas_per_sm, plan.sliced) == (64, 128, 1, False)
    assert plan.smem_bytes == trq.cta_smem_bytes(64, 128, 80, 8, 128) <= SMEM_LIMIT_BYTES
    assert trq.cta_plan(128, 80, 8, 16).queries == 16  # a 16-query tile needs two warps
    assert trq.cta_plan(136, 256, 8, 128).queries == 32
    assert trq.cta_plan(136, 256, 8, 8).queries == 8


def test_cta_plan_fits_every_rot_dim():
    """Every rot_dim the index can have (a multiple of 8, here up to 65,536)
    has a plan within 227 KB: whole in shared memory from 8 up to a few
    hundred, depth-sliced past it with as many queries a CTA as at the
    served width, with its code rows staged up to a few thousand. Only a k
    past MAX_K, or lists a unit past what 8 queries a CTA hold, have none."""
    for k in (1, 80, 256):
        modes = {}
        for rot_dim in range(8, 65536 + 8, 8):
            plan = trq.cta_plan(rot_dim, k, 8, 128)
            assert plan.smem_bytes <= SMEM_LIMIT_BYTES and plan.ctas_per_sm >= 1
            assert plan.smem_bytes == trq.cta_smem_bytes(plan.queries, rot_dim, k, 8, plan.rows,
                                                         plan.mode)
            modes.setdefault(plan.mode, []).append(rot_dim)
            if plan.sliced:
                assert plan.rows == trq._ROUND and plan.queries >= (32 if k == 256 else 64)
        # each layout over one run of rot_dims: whole (the served 128 among
        # them), sliced with staged code rows (1,536 among them), sliced
        last = 0
        for mode in (0, 1, 2):
            dims = modes[mode]
            assert dims == list(range(last + 8, dims[-1] + 8, 8))
            last = dims[-1]
        assert 128 in modes[0] and 1536 in modes[1] and last == 65536
    with pytest.raises(LogicError):
        trq.cta_plan(128, 257, 8)
    with pytest.raises(RaftError):
        trq.cta_plan(128, 256, 8192)  # a unit of 8,192 lists: not even 8 queries fit


def test_sliced_schedule_at_1544_dims_equals_plain_version():
    """At rot_dim 1,544 (193 code bytes a row, past the whole layout; the
    last depth slice half padding) the plan is depth-sliced with 64-row
    chunks, and the kernel's schedule under it equals the plain version."""
    plan = trq.cta_plan(1544, 10, 2, 24)
    assert plan.mode == 1 and plan.rows == 64 and plan.queries == 32
    inp = _inputs(11, rot_dim=1544, m=100, n_units=3, qt=24, n_qt=1, p=2)
    args = _tensors(inp)
    rv, rs = trq.fused_rabitq_topk_reference(*args, k=10, metric=TDT.L2Expanded, qt=24)
    fv, fs = trq.fused_rabitq_topk_filtered_reference(*args, k=10, metric=TDT.L2Expanded, qt=24,
                                                      plan=plan)
    assert torch.equal(fv.view(torch.int32), rv.view(torch.int32)) and torch.equal(fs, rs)
    assert (rs >= 0).all()


def test_fused_mode_takes_a_rot_dim_past_the_whole_layout():
    """A RaBitQ index whose rot_dim the whole layout cannot hold is still
    searched in fused mode (the sliced plan): same ids as the probe path
    when every list is probed."""
    from raft_tpu_torch.core.resources import Resources
    from raft_tpu_torch.neighbors import ivf_pq

    d = 1100
    assert trq.cta_plan(1104, 10, 8).sliced
    x = np.random.default_rng(0).standard_normal((200, d)).astype(np.float32)
    index = ivf_pq.build(x, ivf_pq.IvfPqIndexParams(n_lists=4, pq_bits=1),
                         res=Resources(device="cpu", seed=0))
    params = ivf_pq.IvfPqSearchParams(n_probes=4, refine_ratio=1)
    _, fused = ivf_pq.search(index, x[:4], 10, params, mode="fused")
    _, probe = ivf_pq.search(index, x[:4], 10, params, mode="probe")
    assert fused.shape == (4, 10) and index.rot_dim == 1104
    assert torch.equal(torch.as_tensor(fused), torch.as_tensor(probe))


def test_chunk_table_lists_chunks_with_a_valid_slot():
    ln = torch.full((2, 1, 300), float("inf"))
    ln[0, 0, 5] = 1.0
    ln[1, 0, 299] = 2.0
    ln[1, 0, 130] = 0.0
    got = trq.chunk_table(ln, 128)
    assert got.tolist() == [[True, False, False], [False, True, True]]


def test_work_list_lists_each_tiles_chunks_in_step_order():
    tp = torch.tensor([[2, 0, 1], [1, 1, 1]], dtype=torch.int32)
    pv = torch.tensor([[1, 1, 0], [1, 0, 0]], dtype=torch.int32)
    chunks = torch.tensor([[True, False], [False, True], [True, True]])
    work, n_work = trq.work_list(tp, pv, chunks)
    assert n_work.tolist() == [3, 1] and work.dtype == torch.int32 and work.shape == (2, 6)
    assert work[0, :3].tolist() == [4, 5, 0] and work[1, :1].tolist() == [3]


def test_work_list_deals_the_steps_out_to_the_shares():
    tp = torch.tensor([[0, 1, 2, 3]], dtype=torch.int32)
    pv = torch.ones((1, 4), dtype=torch.int32)
    chunks = torch.tensor([[True, True], [True, False], [True, True], [False, True]])
    work, n_work = trq.work_list(tp, pv, chunks, n_split=2)
    # steps 0 and 2 first (run 0), then steps 1 and 3 (run 1)
    assert int(n_work[0]) == 6 and work[0, :6].tolist() == [0, 1, 4, 5, 2, 7]


@pytest.mark.parametrize("n_split", [2, 3, 16])
def test_work_list_shares_list_the_same_chunks(n_split):
    """Dealing the steps out reorders a tile's listed chunks and nothing
    else: the same entries, valid steps only, none twice."""
    rng = np.random.default_rng(n_split)
    n_units, P, n_chunks = 12, 24, 5
    tp = np.stack([rng.permutation(n_units).repeat(2)[:P] for _ in range(3)]).astype(np.int32)
    pv = (rng.random((3, P)) < 0.5).astype(np.int32)
    chunks = torch.from_numpy(rng.random((n_units, n_chunks)) < 0.6)
    w1, n1 = trq.work_list(torch.from_numpy(tp), torch.from_numpy(pv), chunks)
    ws, ns = trq.work_list(torch.from_numpy(tp), torch.from_numpy(pv), chunks, n_split)
    assert torch.equal(n1, ns)
    for i in range(3):
        got = ws[i, : ns[i]].tolist()
        assert sorted(got) == sorted(w1[i, : n1[i]].tolist())
        valid = {int(tp[i, j]) * n_chunks + c for j in range(P) if pv[i, j]
                 for c in range(n_chunks) if chunks[tp[i, j], c]}
        assert set(got) == valid and len(got) == int(ns[i])
