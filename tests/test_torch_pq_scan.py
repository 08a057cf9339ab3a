"""The fused IVF-PQ scan (kernel B2's module) against raft_tpu: the LUT, and
the port's plain ``fused_pq_topk`` against the Pallas kernel in interpret
mode on the same inputs (JAX's own bf16 LUT included).

The Pallas kernel's ``bank8`` merge loses nothing when each probe step is
one list (``group=1``) of at most 8 * 128 rows and the top-k is extracted
after every step (``extract_every=1``): each bank then holds one 128-lane
group. Under that setting both sides compute the exact top-k, so slots are
equal except at ties, and scores agree within the f32 summation-order
tolerance ``1e-5 * sum|terms| + 1e-5``. The CUDA kernel is held against
the same plain version on the card by ``chip_smoke.py``."""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.ops.distance import DistanceType as JDT
from raft_tpu_torch.core.errors import LogicError
from raft_tpu_torch.neighbors import ivf_pq as tivf_pq
from raft_tpu_torch.ops import pq_scan as tpq
from raft_tpu_torch.ops.distance import DistanceType as TDT

jpq = importlib.import_module("raft_tpu.ops.pallas.pq_scan")

PQ_DIM, PQ_LEN = 8, 2
# code mode -> (ksub of the codes, ksub_eff of the LUT books)
MODES = {"nib8": (256, 32), "u8": (16, 16), "p4": (16, 16), "b5": (32, 32)}


def _tables(rng, n_units, n_qt, p):
    tp = np.zeros((n_qt, p), np.int32)
    pv = np.zeros((n_qt, p), np.int32)
    for i in range(n_qt):
        nv = 2 + i % 3
        units = np.sort(rng.choice(n_units, nv, replace=False))
        tp[i, :nv], pv[i, :nv] = units, 1
        tp[i, nv:] = units[-1]
    return tp, pv


def _codes(rng, mode, n_units, m):
    if mode == "nib8":
        return rng.integers(0, 256, (n_units, m, PQ_DIM)).astype(np.uint8)
    ksub = MODES[mode][0]
    raw = torch.from_numpy(rng.integers(0, ksub, (n_units, m, PQ_DIM)).astype(np.uint8))
    if mode == "u8":
        return raw.numpy()
    return tivf_pq.pack_codes_bits(raw, 4 if mode == "p4" else 5).numpy()


def pq_inputs(mode, metric, with_filter, seed=0):
    """Random kernel inputs: 6 single-list units of 40 rows (the last 7
    empty), 3 tiles of 8 queries, the bf16 LUT made by the JAX package."""
    rng = np.random.default_rng(seed)
    n_units, m, qt, n_qt, p = 6, 40, 8, 3, 4
    rot_dim = PQ_DIM * PQ_LEN
    codes = _codes(rng, mode, n_units, m)
    books = rng.normal(size=(PQ_DIM, MODES[mode][1], PQ_LEN)).astype(np.float32)
    q_rot = rng.normal(size=(n_qt * qt, rot_dim)).astype(np.float32)
    centers_rot = rng.normal(size=(n_units, 1, rot_dim)).astype(np.float32)
    valid = np.ones((n_units, m), bool)
    valid[:, 33:] = False
    if with_filter:
        valid &= rng.random((n_units, m)) < 0.7
    if metric == "InnerProduct":
        ln = np.where(valid, 0.0, np.inf)
    else:
        ln = np.where(valid, rng.uniform(1.0, 20.0, (n_units, m)), np.inf)
    ln = ln.astype(np.float32).reshape(n_units, 1, m)
    w = np.array(jpq.pq_lut(jnp.asarray(q_rot), jnp.asarray(books)).astype(jnp.float32))
    tp, pv = _tables(rng, n_units, n_qt, p)
    return dict(codes=codes, ln=ln, w=w, q_rot=q_rot, centers_rot=centers_rot, tp=tp, pv=pv,
                qt=qt, m=m, ksub=MODES[mode][1] if mode != "nib8" else 16)


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


def pq_tolerance(inp):
    """``1e-5 * sum|terms| + 1e-5`` per query, bounding the terms by every
    LUT entry of the query, the largest ``ln`` and ``|q||c|``."""
    ln = inp["ln"][np.isfinite(inp["ln"])]
    qc = np.abs(inp["q_rot"]) @ np.abs(inp["centers_rot"][:, 0, :]).max(axis=0)
    terms = np.abs(inp["w"]).sum(axis=1) + qc + (np.abs(ln).max() if ln.size else 0.0)
    return (1e-5 * 2.0 * terms + 1e-5)[:, None]


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("metric", ["L2Expanded", "InnerProduct"])
@pytest.mark.parametrize("with_filter", [False, True])
def test_plain_fused_pq_topk_matches_pallas_exact(mode, metric, with_filter):
    inp = pq_inputs(mode, metric, with_filter)
    assert inp["m"] <= 8 * 128  # one 128-lane group per bank: the bank8 merge is lossless
    k = 10
    jv, js = jpq.fused_pq_topk(
        jnp.asarray(inp["codes"]), jnp.asarray(inp["ln"]),
        jnp.asarray(inp["w"]).astype(jnp.bfloat16), jnp.asarray(inp["q_rot"]),
        jnp.asarray(inp["centers_rot"]), jnp.asarray(inp["tp"]), jnp.asarray(inp["pv"]),
        k=k, metric=JDT[metric], qt=inp["qt"], merge="bank8", code_mode=mode, ksub=inp["ksub"],
        extract_every=1, interpret=True,
    )
    tv, ts = tpq.fused_pq_topk(
        torch.from_numpy(inp["codes"]), torch.from_numpy(inp["ln"]),
        torch.from_numpy(inp["w"]).to(torch.bfloat16), torch.from_numpy(inp["q_rot"]),
        torch.from_numpy(inp["centers_rot"]), torch.from_numpy(inp["tp"]),
        torch.from_numpy(inp["pv"]), k=k, metric=TDT[metric], qt=inp["qt"], code_mode=mode,
        ksub=inp["ksub"],
    )
    assert ts.dtype == torch.int32 and tv.dtype == torch.float32
    assert_close_topk(tv, ts, jv, js, pq_tolerance(inp))


def test_pq_lut_matches_jax_as_bf16():
    rng = np.random.default_rng(1)
    q_rot = rng.normal(size=(64, 64)).astype(np.float32)
    books = rng.normal(size=(32, 32, 2)).astype(np.float32)
    j = np.asarray(jpq.pq_lut(jnp.asarray(q_rot), jnp.asarray(books)).astype(jnp.float32))
    t = tpq.pq_lut(torch.from_numpy(q_rot), torch.from_numpy(books))
    assert t.dtype == torch.bfloat16 and t.shape == j.shape
    t = t.to(torch.float32).numpy()
    same = t == j
    assert same.mean() >= 0.999
    # the rest differ by one bf16 ulp (8 significant bits)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(j), 1e-30))) - 7)
    assert (np.abs(t - j)[~same] <= ulp[~same]).all()


@pytest.mark.parametrize("mode,ksub", [("u8", 16), ("nib8", 16), ("p4", 16), ("b5", 32),
                                        ("b3", 8), ("b6", 64), ("b7", 128)])
def test_lookup_columns_match_pallas_multi_hot(mode, ksub):
    """The plain decode's LUT columns are exactly the ones hot in the
    Pallas kernel's multi-hot decode."""
    rng = np.random.default_rng(2)
    m = 12
    if mode == "nib8":
        codes = rng.integers(0, 256, (m, PQ_DIM)).astype(np.uint8)
    else:
        raw = torch.from_numpy(rng.integers(0, ksub, (1, m, PQ_DIM)).astype(np.uint8))
        bits = 8 if mode == "u8" else (4 if mode == "p4" else int(mode[1:]))
        codes = (raw if bits == 8 else tivf_pq.pack_codes_bits(raw, bits))[0].numpy()
    bpr = codes.shape[1]
    hot = np.asarray(jpq._multi_hot(jnp.asarray(codes), code_mode=mode, ksub=ksub, m=m, bpr=bpr))
    cols = tpq.lookup_columns(torch.from_numpy(codes), mode, ksub).numpy()
    ref = np.zeros_like(hot)
    np.put_along_axis(ref, cols, 1.0, axis=1)
    assert np.array_equal(ref, hot)


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    def no_build(*a, **kw):
        raise AssertionError("kernel build reached from CPU tensors")

    monkeypatch.setattr(tpq, "build_kernel", no_build)
    before = tpq.fused_pq_topk.launches
    inp = pq_inputs("nib8", "L2Expanded", False)
    tpq.fused_pq_topk(
        torch.from_numpy(inp["codes"]), torch.from_numpy(inp["ln"]),
        torch.from_numpy(inp["w"]).to(torch.bfloat16), torch.from_numpy(inp["q_rot"]),
        torch.from_numpy(inp["centers_rot"]), torch.from_numpy(inp["tp"]),
        torch.from_numpy(inp["pv"]), k=5, metric=TDT.L2Expanded, qt=inp["qt"],
        code_mode="nib8", ksub=16,
    )
    assert tpq.fused_pq_topk.launches == before


def test_shared_memory_limit_is_checked():
    """One query's LUT must fit the 227 KB of shared memory: 128 KB at
    pq_dim=256 with ksub=256 does, a LUT twice as wide does not. A CTA
    holds 8 (LUTs of at most 2048 columns), 4 or 1 queries: their bf16
    LUT rows, per query a candidate buffer of two 256-row chunks (8 B an
    entry), its top-k list (8 B an entry), its q.c terms and its count, and
    the CTA's next work item."""
    assert tpq.queries_per_cta(256 * 256, 80, 8) == 1
    assert tpq.queries_per_cta(64 * 32, 80, 8) == tpq.MAX_QUERIES_PER_CTA == 8
    assert tpq.queries_per_cta(64 * 32, 256, 8) == 8  # nib8 at pq_dim 64, the largest k
    assert tpq.queries_per_cta(64 * 256, 80, 8) == 4  # u8 at ksub 256
    assert tpq.queries_per_cta(64 * 128, 80, 8) == 4  # b7 codes
    assert tpq.queries_per_cta(16 * 128, 256, 8) == 8  # u8 ksub 16 at pq_dim 128
    assert tpq.queries_per_cta(16 * 129, 10, 8) == 4  # past 8 queries' 2048 columns
    # the LUT, per query its buffers, list, q.c terms and count, and the next work item
    assert tpq.cta_smem_bytes(8, 512, 80, 8) == 8 * 2048 * 2 + 8 * (4096 + 640 + 32 + 4) + 4
    assert tpq.cta_smem_bytes(4, 512, 80, 8) == 4 * 512 * 2 + 4 * (4096 + 640 + 32 + 4) + 4
    assert 3 * (tpq.cta_smem_bytes(8, 2048, 80, 8) + 1024) <= 228 * 1024  # three an SM
    for K, k, g in ((2048, 80, 8), (16384, 80, 8), (8192, 10, 1), (65536, 256, 8), (512, 80, 8)):
        qb = tpq.queries_per_cta(K, k, g)
        assert qb in tpq.QUERIES_PER_CTA
        assert tpq.cta_smem_bytes(qb, K, k, g) <= tpq.SMEM_LIMIT_BYTES
        bigger = [b for b in tpq.QUERIES_PER_CTA if b > qb]
        assert all(tpq.cta_smem_bytes(b, K, k, g) > tpq.SMEM_LIMIT_BYTES or (b == 8 and K > 2048)
                   for b in bigger)
    with pytest.raises(LogicError):
        tpq.queries_per_cta(512 * 256, 10, 8)


def test_kernel_layout_matches_the_wrapper():
    """The constants the wrapper mirrors from ``csrc/pq_scan.cu`` (the
    built library reports them too, and ``build_kernel`` checks that on
    the card) and its shared-memory count, read from the source."""
    import re
    from pathlib import Path

    src = (Path(tpq.__file__).parent.parent / "csrc" / "pq_scan.cu").read_text()
    const = {name: expr for name, expr in re.findall(r"constexpr int (\w+) = ([^;]+);", src)}
    env = {}
    for name, expr in const.items():
        env[name] = eval(expr, {}, dict(env))  # literals and earlier names only
    assert tpq._LAYOUT == (env["QB_MAX"], env["STRIDE"], env["CTAS_PER_SM"], env["R"], env["CAP"],
                           env["ITEM"], env["WARPS"], 32)
    body = re.search(r"size_t cta_smem_bytes\(int qb, int K, int k, int G\) \{(.*?)\n\}", src,
                     re.S).group(1)
    expr = " ".join(body.replace("return", "").replace("(size_t)", "").replace(";", "").split())
    expr = expr.replace("sizeof(float)", "4").replace("sizeof(int)", "4")
    expr = re.sub(r"\(qb == QB_MAX \? STRIDE : K\)", "(STRIDE if qb == QB_MAX else K)", expr)
    for K, k, g in ((2048, 80, 8), (16384, 80, 8), (512, 10, 1)):
        for qb in tpq.QUERIES_PER_CTA:
            got = eval(expr, {}, dict(env, qb=qb, K=K, k=k, G=g))
            assert got == tpq.cta_smem_bytes(qb, K, k, g)


def test_group_tables_list_the_valid_warp_groups():
    """Each unit's 32-row groups that hold a valid slot, first and in row
    order, and how many of them each chunk of 8 takes."""
    rng = np.random.default_rng(4)
    n_units, gm = 6, 1200  # a ragged last group
    ln = np.full((n_units, 1, gm), np.inf, np.float32)
    for u in range(n_units - 1):
        ln[u, 0, : rng.integers(0, gm)] = 1.0
    ln[3, 0, rng.random(gm) < 0.05] = 2.0  # scattered slots (a prefilter)
    groups, chunk_w = (t.numpy() for t in tpq.group_tables(torch.isfinite(torch.from_numpy(ln))))
    n_groups = -(-gm // 32)
    assert groups.shape == (n_units, n_groups) and chunk_w.shape == (n_units, -(-n_groups // 8))
    assert groups.dtype == np.int32 and chunk_w.dtype == np.int32
    for u in range(n_units):
        want = [g for g in range(n_groups) if np.isfinite(ln[u, 0, 32 * g : 32 * g + 32]).any()]
        assert groups[u, : len(want)].tolist() == want
        assert sorted(groups[u].tolist()) == list(range(n_groups))
        assert chunk_w[u].sum() == len(want) and (chunk_w[u] <= 8).all()
        assert (np.diff(chunk_w[u]) <= 0).all()  # full chunks, then the short one, then none


@pytest.mark.parametrize("n_split", [1, 2, 3, 7, 32])
def test_work_lists_cover_every_chunk_once_and_balance(n_split):
    """Each tile's work list holds every chunk of its valid steps that has
    a valid group, once and in step-major order. Taken as the kernel takes
    it, ``CHUNKS_PER_ITEM`` at a time by whichever of the ``n_split`` CTAs
    is free first (a chunk costing its weight), no CTA ends more than one
    item's weight, at most one unit's rows, above the mean."""
    rng = np.random.default_rng(n_split)
    n_units, n_chunks, n_qt, P = 40, 24, 6, 12
    cw = rng.integers(0, 9, (n_units, n_chunks)).astype(np.int32)
    cw[rng.random(n_units) < 0.2] = 0  # whole empty units
    tp = np.stack([rng.permutation(n_units)[:P] for _ in range(n_qt)]).astype(np.int32)
    pv = (rng.random((n_qt, P)) < 0.8).astype(np.int32)
    pv[0] = 0  # a tile with no valid step
    work, n_work = (t.numpy() for t in tpq.work_lists(
        torch.from_numpy(tp), torch.from_numpy(pv), torch.from_numpy(cw)))
    assert work.shape == (n_qt, P * n_chunks) and work.dtype == n_work.dtype == np.int32
    item = tpq.CHUNKS_PER_ITEM
    for i in range(n_qt):
        want = [j * n_chunks + c for j in range(P) if pv[i, j] > 0 for c in range(n_chunks)
                if cw[tp[i, j], c] > 0]
        assert n_work[i] == len(want) and work[i, : n_work[i]].tolist() == want
        weight = [int(cw[tp[i, g // n_chunks], g % n_chunks]) for g in want]
        load = np.zeros(n_split)
        for i0 in range(0, len(weight), item):
            load[np.argmin(load)] += sum(weight[i0 : i0 + item])
        assert load.max() <= load.sum() / n_split + item * cw.max()
        assert load.max() <= load.sum() / n_split + cw.sum(axis=1).max()


def test_bad_arguments_raise():
    inp = pq_inputs("u8", "L2Expanded", False)
    args = (torch.from_numpy(inp["codes"]), torch.from_numpy(inp["ln"]),
            torch.from_numpy(inp["w"]).to(torch.bfloat16), torch.from_numpy(inp["q_rot"]),
            torch.from_numpy(inp["centers_rot"]), torch.from_numpy(inp["tp"]),
            torch.from_numpy(inp["pv"]))
    with pytest.raises(LogicError):  # k above the kernel's limit
        tpq.fused_pq_topk(*args, k=tpq.MAX_K + 1, metric=TDT.L2Expanded, qt=inp["qt"],
                          code_mode="u8", ksub=16)
    with pytest.raises(LogicError):  # the LUT width does not fit the code layout
        tpq.fused_pq_topk(*args, k=5, metric=TDT.L2Expanded, qt=inp["qt"], code_mode="u8",
                          ksub=32)
    with pytest.raises(LogicError):
        tpq.fused_pq_topk(*args, k=5, metric=TDT.CosineExpanded, qt=inp["qt"], code_mode="u8",
                          ksub=16)
