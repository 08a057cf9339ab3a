"""The filter of kernel B1 (``raft_tpu_torch/csrc/ivf_scan.cu``) on the CPU:
the TF32 product's error bound (:func:`filter_error`, relative to the cut
operands' norms), the lower bound of each score (:func:`dot_upper_bound`,
:func:`score_epilogue`), the kernel's
schedule in plain PyTorch (:func:`fused_list_topk_filtered_reference`)
against the plain version and against the Pallas kernel in interpret mode,
the chunk lists and the CTA plan the wrapper mirrors from the ``.cu``. The
kernel itself is held against the plain version and against its checking
build, and its filter's bound counted, on the card by ``chip_smoke.py``."""
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
from raft_tpu_torch.core.errors import LogicError
from raft_tpu_torch.ops import ivf_scan as tscan
from raft_tpu_torch.ops.distance import DistanceType as TDT

jscan = importlib.import_module("raft_tpu.ops.pallas.ivf_scan")

_CU = os.path.join(os.path.dirname(tscan.__file__), os.pardir, "csrc", "ivf_scan.cu")
_SETTINGS = settings(max_examples=25, deadline=None, derandomize=True)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8,
          "uint8": torch.uint8}


def mixed(rng, shape, spread=2.0):
    """f32 values of mixed sign and of scales 10^-spread to 10^spread, per
    row and per element."""
    scale = (10.0 ** rng.uniform(-spread, spread, (shape[0], 1))
             * 10.0 ** rng.uniform(-1, 1, shape))
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def rows_of(rng, dtype, n, d):
    """List rows of ``dtype`` (as the kernel stores them), ``[n, d]``."""
    if dtype == "int8":
        return torch.from_numpy(rng.integers(-128, 128, (n, d)).astype(np.int8))
    if dtype == "uint8":
        return torch.from_numpy(rng.integers(0, 256, (n, d)).astype(np.uint8))
    y = torch.from_numpy(mixed(rng, (n, d)))
    return y.to(torch.bfloat16) if dtype == "bfloat16" else y


def _round_toward_zero(x64):
    """f64 -> f32 rounded toward zero (a truncating accumulator's step)."""
    x32 = x64.astype(np.float32)
    over = np.abs(x32.astype(np.float64)) > np.abs(x64)
    x32[over] = np.nextafter(x32[over], np.float32(0))
    return x32


def f32_sums(a, b):
    """``a . b`` in f32 in several orders: forward, reverse, pairwise,
    ``torch.matmul``, and 8 products at a time added exactly and truncated
    toward zero (a tensor core's k-step). ``[nq, d]``, ``[rows, d]`` f32 ->
    dict of ``[nq, rows]`` f32."""
    prod = a[:, None, :] * b[None, :, :]  # exact for TF32 operands
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
    p64 = a.numpy().astype(np.float64)[:, None, :] * b.numpy().astype(np.float64)[None, :, :]
    trunc = np.zeros(prod.shape[:2], np.float32)
    for t0 in range(0, p64.shape[2], 8):
        trunc = _round_toward_zero(trunc.astype(np.float64) + p64[:, :, t0:t0 + 8].sum(axis=2))
    return {"forward": fwd, "reverse": rev, "pairwise": level[:, :, 0], "matmul": a @ b.T,
            "truncated_k8": torch.from_numpy(trunc)}


def fma_chain(q, y):
    """``q . y`` as the kernel scores it: one FMA a dimension from 0 (each
    step's product exact in f64, the sum rounded to f32)."""
    q64 = q.numpy().astype(np.float64)
    y64 = y.numpy().astype(np.float64)
    acc = np.zeros((q64.shape[0], y64.shape[0]), np.float32)
    for t in range(q64.shape[1]):
        acc = (acc.astype(np.float64) + q64[:, None, t] * y64[None, :, t]).astype(np.float32)
    return torch.from_numpy(acc)


def _bound_case(seed, dtype, d):
    rng = np.random.default_rng(seed)
    y = rows_of(rng, dtype, 24, d)
    q = tscan.kernel_queries(torch.from_numpy(mixed(rng, (5, d))), y[None])
    yf = y.to(torch.float32)
    yf[3] = 0.0  # a zero row
    bound = tscan.filter_error(d, y.dtype)
    dots = f32_sums(tscan.tf32_cut(q), tscan.tf32_cut(yf))
    exacts = {"fma": fma_chain(q, yf), "matmul": q @ yf.T}
    return q, yf, bound, dots, exacts


@_SETTINGS
@given(seed=st.integers(0, 2 ** 31 - 1), dtype=st.sampled_from(sorted(DTYPES)),
       d=st.sampled_from([8, 100, 136, 960]))
def test_filter_error_bounds_the_tf32_product_in_any_order(seed, dtype, d):
    """|dot_tc - dot| <= kappa |q~| |y~| + eps for every summation order of
    the TF32 product and of the exact dot (the kernel's FMA chain, the plain
    version's matmul), at depths that are and are not multiples of the
    k-step, for each list dtype, with the cut operands' exact norms (the
    kernel's, summed rounding upward, are no smaller)."""
    q, yf, bound, dots, exacts = _bound_case(seed, dtype, d)
    qn = torch.sqrt((tscan.tf32_cut(q).to(torch.float64) ** 2).sum(1))[:, None]
    yn = torch.sqrt((tscan.tf32_cut(yf).to(torch.float64) ** 2).sum(1))[None, :]
    assert (tscan.cut_norms(q).to(torch.float64) >= qn[:, 0]).all()
    for name, dot_tc in dots.items():
        for ename, exact in exacts.items():
            gap = (dot_tc.to(torch.float64) - exact.to(torch.float64)).abs()
            slack = bound.kappa * qn * yn + bound.eps
            assert (gap <= slack).all(), (name, ename, float((gap - slack).max()))


def test_filter_error_counts_the_cut_only_where_it_cuts():
    """f32 rows and queries are cut (2^-10 each); bf16 rows with bf16-rounded
    queries are held exactly by TF32; int8 and uint8 rows too, their f32
    queries not. The bound grows with the padded depth."""
    k32 = tscan.filter_error(128, torch.float32).kappa
    kbf = tscan.filter_error(128, torch.bfloat16).kappa
    ki8 = tscan.filter_error(128, torch.int8).kappa
    assert k32 > ki8 > kbf > 0 and abs(k32 - 2.0 ** -9) < 2.0 ** -11
    assert (tscan.filter_error(100, torch.bfloat16).kappa
            > tscan.filter_error(96, torch.bfloat16).kappa)
    assert tscan.filter_error(104, torch.bfloat16).eps == 104 * 2.0 ** -100


def test_tf32_cut_truncates_toward_zero():
    """Within 2^-10 of each value; a subnormal (1e-40) within TF32's
    spacing there, 2^-136, which the bound's ``eps`` covers."""
    x = torch.tensor([1.0 + 2.0 ** -10 + 2.0 ** -12, -(1.0 + 2.0 ** -11), 3.0, -0.0, 1e-40])
    cut = tscan.tf32_cut(x)
    assert cut.tolist()[:4] == [1.0 + 2.0 ** -10, -1.0, 3.0, -0.0]
    gap = (x - cut).abs().to(torch.float64)
    assert (cut.abs() <= x.abs()).all() and (gap[:4] <= 2.0 ** -10 * x[:4].abs()).all()
    assert 0 < gap[4] < 2.0 ** -136


@_SETTINGS
@given(seed=st.integers(0, 2 ** 31 - 1), dtype=st.sampled_from(sorted(DTYPES)),
       metric=st.sampled_from(["L2Expanded", "InnerProduct", "CosineExpanded"]))
def test_lower_bound_never_exceeds_the_exact_score(seed, dtype, metric):
    """The epilogue at the dot's upper bound is below every exact score,
    with negative dots, zero rows and filtered (+inf) slots."""
    q, yf, bound, dots, exacts = _bound_case(seed, dtype, 100)
    m = TDT[metric]
    rng = np.random.default_rng(seed)
    if m == TDT.L2Expanded:
        ln = (yf * yf).sum(1)
    elif m == TDT.InnerProduct:
        ln = torch.zeros(yf.shape[0])
    else:
        ln = torch.rsqrt(torch.clamp((yf * yf).sum(1), min=1e-24))
    ln = ln[None, :].clone()
    if m != TDT.CosineExpanded:
        ln[0, rng.choice(yf.shape[0], 4, replace=False)] = float("inf")  # filtered slots
    yn = tscan.cut_norms(yf)[None, :]
    for name, dot_tc in dots.items():
        lb = tscan.score_epilogue(
            ln, tscan.dot_upper_bound(dot_tc, tscan.cut_norms(q)[:, None], yn, bound), m)
        for exact in exacts.values():
            score = tscan.score_epilogue(ln, exact, m)
            assert (lb <= score).all(), (name, float((lb - score).max()))
            # a filtered slot's bound is +inf: it is never a candidate
            assert torch.equal(torch.isinf(lb) & (lb > 0), torch.isinf(score) & (score > 0))
    assert (exacts["matmul"] < 0).any()


def _inputs(seed, dtype="float32", d=40, with_filter=False, gm=300, n_units=6, qt=24, n_qt=2,
            p=4):
    """Kernel inputs with units of ``gm`` rows (the last 60 empty, as list
    padding), large enough for k = 256 and several 64-row chunks."""
    rng = np.random.default_rng(seed)
    data = rows_of(rng, dtype, n_units * gm, d).reshape(n_units, gm, d)
    if dtype == "float32":
        data = torch.from_numpy(rng.normal(size=(n_units, gm, d)).astype(np.float32))
    ids = np.arange(n_units * gm, dtype=np.int32).reshape(n_units, gm)
    ids[:, gm - 60:] = -1
    if with_filter:
        keep = rng.random(n_units * gm) < 0.7
        ids = np.where((ids >= 0) & keep[np.clip(ids, 0, None)], ids, -1).astype(np.int32)
    norms = (data.to(torch.float32) ** 2).sum(2)
    queries = rng.normal(size=(n_qt * qt, d)).astype(np.float32)
    if dtype in ("int8", "uint8"):
        queries = np.round(queries * 8)
    tp = np.zeros((n_qt, p), np.int32)
    pv = np.zeros((n_qt, p), np.int32)
    for i in range(n_qt):
        nv = 2 + i % 2
        units = np.sort(rng.choice(n_units, nv, replace=False))
        tp[i, :nv], pv[i, :nv] = units, 1
        tp[i, nv:] = units[-1]
    return dict(data=data, norms=norms, ids=torch.from_numpy(ids),
                queries=torch.from_numpy(queries), tp=torch.from_numpy(tp),
                pv=torch.from_numpy(pv), qt=qt)


def _args(inp):
    return (inp["data"], inp["norms"], inp["ids"], inp["queries"], inp["tp"], inp["pv"])


def _plant_tie(inp, k, metric):
    """Copy the row at query 0's k-th place into three other filled rows of
    its unit (lower and higher slots): its score then holds the k-th place
    and the places after it."""
    v, s = tscan.fused_list_topk_reference(*_args(inp), k=k, metric=metric, qt=inp["qt"])
    slot = int(s[0, k - 1])
    assert slot >= 0
    gm = inp["ids"].shape[1]
    u, r = divmod(slot, gm)
    held = set(s[0].tolist())
    others = [x for x in range(gm) if x != r and int(inp["ids"][u, x]) >= 0
              and u * gm + x not in held]
    others = [others[0], others[1], others[-1]]  # below and above the row's slot
    for x in others:
        inp["data"][u, x] = inp["data"][u, r]
        inp["norms"][u, x] = inp["norms"][u, r]
    v2, s2 = tscan.fused_list_topk_reference(*_args(inp), k=k, metric=metric, qt=inp["qt"])
    planted = {u * gm + x for x in others + [r]}
    assert float(v2[0, k - 1]) == float(v[0, k - 1]) and int(s2[0, k - 1]) in planted
    return inp


def _assert_bit_equal(fv, fs, rv, rs):
    assert torch.equal(fv.view(torch.int32), rv.view(torch.int32))
    assert torch.equal(fs, rs) and fs.dtype == torch.int32


@pytest.mark.parametrize("k", [1, 10, 100, 256])
@pytest.mark.parametrize("with_filter", [False, True])
@pytest.mark.parametrize("n_split", [1, 3])
@pytest.mark.parametrize("qt", [16, 24])
def test_filtered_schedule_equals_plain_version_bit_for_bit(k, with_filter, n_split, qt):
    metric = TDT.InnerProduct if k == 100 else TDT.L2Expanded
    inp = _plant_tie(_inputs(7 + k + qt, with_filter=with_filter, qt=qt), min(k, 10), metric)
    rv, rs = tscan.fused_list_topk_reference(*_args(inp), k=k, metric=metric, qt=qt)
    fv, fs = tscan.fused_list_topk_filtered_reference(*_args(inp), k=k, metric=metric, qt=qt,
                                                      n_split=n_split)
    _assert_bit_equal(fv, fs, rv, rs)
    assert (rs >= 0).any()


@pytest.mark.parametrize("n_qt,qt,cta", [(9, 16, None), (3, 16, (32, 2)), (3, 16, (16, 1)),
                                         (5, 24, None)])
def test_filtered_schedule_over_tile_groups(n_qt, qt, cta):
    """Tiles scanned in groups (8 tiles of 16 and a ninth alone; groups of
    2 with a last one of 1; one tile a CTA; 5 tiles of 24 in 120 of a
    CTA's 128 queries), each query scoring only its own tile's units."""
    inp = _inputs(17 + n_qt, with_filter=True, qt=qt, n_qt=n_qt, n_units=8, p=5, gm=200)
    plan = None
    if cta is not None:
        plan = (tscan.CtaPlan(queries=cta[0], smem_bytes=0, qglobal=False, ctas_per_sm=1), cta[1])
    else:
        assert tscan.launch_plan(40, 10, 4, qt, n_qt)[1] == min(n_qt, 128 // qt)
    rv, rs = tscan.fused_list_topk_reference(*_args(inp), k=10, metric=TDT.L2Expanded, qt=qt)
    fv, fs = tscan.fused_list_topk_filtered_reference(*_args(inp), k=10, metric=TDT.L2Expanded,
                                                      qt=qt, n_split=2, plan=plan)
    _assert_bit_equal(fv, fs, rv, rs)


def test_group_tables_mark_each_tiles_units():
    tp = torch.tensor([[0, 2, 2], [1, 2, 3], [3, 0, 0]], dtype=torch.int32)
    pv = torch.tensor([[1, 1, 0], [1, 1, 1], [1, 0, 0]], dtype=torch.int32)
    probes, valid, mask = tscan.group_tables(tp, pv, 4, 2)
    assert mask.tolist() == [[1, 2, 3, 2], [0, 0, 0, 1]]
    assert valid.tolist() == [[1, 1, 1, 1], [0, 0, 0, 1]]
    assert probes.tolist() == [[0, 1, 2, 3]] * 2 and mask.dtype == torch.int32
    assert int(tscan.group_tables(tp[:1], pv[:1], 4, 32)[2][0, 2]) == 1


@pytest.mark.parametrize("dtype,metric,d", [("bfloat16", "L2Expanded", 100),
                                            ("int8", "L2SqrtExpanded", 136),
                                            ("uint8", "InnerProduct", 8),
                                            ("float32", "CosineExpanded", 136)])
def test_filtered_schedule_across_list_dtypes_and_metrics(dtype, metric, d):
    inp = _inputs(11, dtype=dtype, d=d, with_filter=True, qt=16)
    m = TDT[metric]
    rv, rs = tscan.fused_list_topk_reference(*_args(inp), k=10, metric=m, qt=16)
    fv, fs = tscan.fused_list_topk_filtered_reference(*_args(inp), k=10, metric=m, qt=16,
                                                      n_split=2)
    _assert_bit_equal(fv, fs, rv, rs)


def test_filtered_schedule_filters():
    """At the served data's kind of spread (clustered rows), most (query,
    row) pairs are dropped by the bound: the survivors are the rows near a
    query's k-th score, and the first chunks' warm-up."""
    rng = np.random.default_rng(3)
    n_units, gm, d, qt = 4, 512, 32, 16
    centers = rng.normal(size=(n_units, 1, d)) * 8
    data = torch.from_numpy((centers + rng.normal(size=(n_units, gm, d))).astype(np.float32))
    ids = torch.arange(n_units * gm, dtype=torch.int32).reshape(n_units, gm)
    q = torch.from_numpy((centers[0, 0] + rng.normal(size=(qt, d))).astype(np.float32))
    y = data.reshape(-1, d)
    lb = tscan.score_epilogue((y * y).sum(1)[None], tscan.dot_upper_bound(
        tscan.tf32_cut(q) @ tscan.tf32_cut(y).T, tscan.cut_norms(q)[:, None],
        tscan.cut_norms(y)[None, :], tscan.filter_error(d, torch.float32)), TDT.L2Expanded)
    v, _ = tscan.fused_list_topk_reference(
        data, (data ** 2).sum(2), ids, q, torch.tensor([[0, 1, 2, 3]], dtype=torch.int32),
        torch.ones((1, 4), dtype=torch.int32), k=10, metric=TDT.L2Expanded, qt=qt)
    assert float((lb <= v[:, 9:10]).to(torch.float32).mean()) < 0.05


@pytest.mark.parametrize("metric", ["L2Expanded", "CosineExpanded"])
def test_filtered_schedule_matches_pallas(metric):
    """The kernel's schedule against the Pallas kernel in interpret mode
    (``merge="exact"``), as tests/test_torch_ivf_scan.py holds the plain
    version."""
    from test_torch_ivf_scan import _scan_inputs, assert_topk_equal

    data, norms, ids, queries, tp, pv, qt = _scan_inputs("float32", True, seed=4)
    if metric == "CosineExpanded":
        queries = queries / np.maximum(np.linalg.norm(queries, axis=1, keepdims=True), 1e-12)
    jv, js = jscan.fused_list_topk(
        jnp.asarray(data), jnp.asarray(norms), jnp.asarray(ids), jnp.asarray(queries),
        jnp.asarray(tp), jnp.asarray(pv), k=10, metric=JDT[metric], qt=qt, merge="exact",
        interpret=True)
    tv, ts = tscan.fused_list_topk_filtered_reference(
        *(torch.from_numpy(x) for x in (data, norms, ids, queries, tp, pv)), k=10,
        metric=TDT[metric], qt=qt, n_split=2)
    assert_topk_equal(tv, ts, jv, js)


def _cu_constant(name):
    src = open(_CU).read()
    return int(eval(re.search(rf"constexpr (?:int|unsigned) {name} = ([^;]+);",
                              src).group(1).rstrip("u")))


def test_constants_mirror_the_cu_source():
    got = tuple(_cu_constant(n) for n in ("QB_MAX", "QW", "R", "DS", "NS", "WIDE_QB", "ROW_PAD",
                                          "TF32_MASK"))
    assert got[:7] == tscan._LAYOUT[:7] and got[7] == tscan._TF32_MASK
    assert got[7] - 2 ** 32 == tscan._LAYOUT[7]
    assert tscan.QUERIES_PER_CTA[0] == got[0] and all(q % 16 == 0 for q in tscan.QUERIES_PER_CTA)
    assert got[2] == tscan.ROWS_PER_CHUNK and got[3] % 8 == 0 and got[5] in tscan.QUERIES_PER_CTA
    assert _cu_constant("MAX_SHARES") == tscan.MAX_SHARES
    # the C signature the wrapper binds: 15 pointers, 13 ints, 2 floats (and the stream)
    sig = re.search(r'extern "C" int ivf_scan_fused_list_topk\(([^)]*)\)', open(_CU).read()).group(1)
    kinds = ["float" if p.split()[0] == "float" and "*" not in p else
             "int" if p.split()[0] == "int" and "*" not in p else "ptr"
             for p in (x.strip() for x in sig.split(","))]
    bound = tscan._SIGNATURES["ivf_scan_fused_list_topk"]
    assert len(kinds) == len(bound)
    assert kinds.count("float") == 2 and kinds.count("int") == 13
    assert [b.__name__ for b, kind in zip(bound, kinds) if kind == "int"] == ["c_int"] * 13


def test_cta_plan_at_the_main_path_shapes():
    serve = tscan.cta_plan(128, 10, 4, 16)
    assert (serve.queries, serve.qglobal, serve.ctas_per_sm) == (16, False, 2)
    assert serve.smem_bytes == tscan.cta_smem_bytes(16, 128, 10, 4)
    batch = tscan.cta_plan(128, 10, 4, 128)
    assert (batch.queries, batch.qglobal, batch.ctas_per_sm) == (128, False, 1)
    assert tscan.cta_plan(128, 10, 4, 24).queries == 32
    assert tscan.cta_plan(128, 256, 4, 128).queries == 32
    # d = 960: 32 queries a CTA with two staged slices rather than 16 with three
    wide = tscan.cta_plan(960, 10, 4, 128)
    assert (wide.queries, wide.staged, wide.qglobal) == (32, 2, False)


def test_cta_plan_fits_every_d_and_k():
    """Every d (here up to 8,192) and k up to MAX_K has a plan within 227 KB
    for every list item size: queries in shared memory up to about 2,000
    dimensions, read through the caches past it."""
    for k in (1, 100, 256):
        for isz in (1, 2, 4):
            last_shared = 0
            for d in list(range(1, 300)) + list(range(300, 8193, 37)):
                plan = tscan.cta_plan(d, k, isz, 128)
                assert plan.smem_bytes <= tscan.SMEM_LIMIT_BYTES and plan.ctas_per_sm >= 1
                assert plan.smem_bytes == tscan.cta_smem_bytes(plan.queries, d, k, isz,
                                                               plan.qglobal, staged=plan.staged)
                if not plan.qglobal:
                    last_shared = d
                else:
                    assert plan.queries == 16
            assert 1000 < last_shared < 4000
    with pytest.raises(LogicError):
        tscan.cta_plan(128, 257, 4)


def test_default_split_fills_the_waves():
    assert tscan.default_split(8, 80, 264) == 30  # the serving batch: 240 of 264 slots
    assert tscan.default_split(79, 80, 132) == 5  # 79 tiles of 128: three full waves
    assert tscan.default_split(8, 3, 264) == 3    # never past the probe steps
    assert tscan.default_split(396, 80, 132) == 1   # three full waves already


def test_chunk_table_lists_chunks_with_a_filled_slot():
    ids = torch.full((2, 150), -1, dtype=torch.int32)
    ids[0, 5] = 1
    ids[1, 149] = 2
    ids[1, 64] = 3
    assert tscan.chunk_table(ids).tolist() == [[True, False, False], [False, True, True]]


@pytest.mark.parametrize("n_split", [1, 3, 16])
@pytest.mark.parametrize("with_filter", [False, True])
def test_work_list_covers_exactly_the_filled_chunks(n_split, with_filter):
    """Each tile's listed chunks are the chunks with a filled slot of its
    valid probe steps' units, each once, whatever the split."""
    inp = _inputs(5, with_filter=with_filter, gm=700, n_units=8, n_qt=3, p=6)
    ids = inp["ids"].clone()
    ids[2, :] = -1  # a unit with no filled slot
    ids[4, 64:128] = -1  # a chunk emptied by the filter
    gm = ids.shape[1]
    chunks = tscan.chunk_table(ids)
    work, n_work = tscan.work_list(inp["tp"], inp["pv"], chunks, n_split)
    n_chunks = chunks.shape[1]
    for i in range(inp["tp"].shape[0]):
        got = work[i, : n_work[i]].tolist()
        want = {int(u) * n_chunks + c for u, ok in zip(inp["tp"][i], inp["pv"][i]) if ok
                for c in range(n_chunks)
                if (ids[u, c * 64: min(gm, (c + 1) * 64)] >= 0).any()}
        assert len(got) == len(set(got)) and set(got) == want
