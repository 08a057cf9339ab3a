"""The design of kernel B4 (``raft_tpu_torch/csrc/cagra_search.cu``) on the
CPU: the pick by rank (:func:`pick_ranks`) against rounds of min-extract,
the rank merge (:func:`rank_merge`) against the stable union sort, the
kernel's whole schedule in plain PyTorch (:func:`cagra_beam_kernel_reference`:
staged groups, four candidates a warp, steps without a valid parent)
against :func:`cagra_beam_reference` bit for bit, the shared-memory layout
and launch plan the wrapper mirrors from the ``.cu``, and the seeds the
fused search caches on the index. The kernel itself is held against the
plain version on the card by ``chip_smoke.py``."""
import os
import re

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from raft_tpu_torch.core.errors import LogicError
from raft_tpu_torch.neighbors import cagra as tcagra
from raft_tpu_torch.ops import cagra_search as tcs
from raft_tpu_torch.utils.math import next_pow2

_CU = os.path.join(os.path.dirname(tcs.__file__), os.pardir, "csrc", "cagra_search.cu")
_SETTINGS = settings(max_examples=40, deadline=None, derandomize=True)
WORST = np.float32(tcs.WORST)
NAN = np.float32("nan")
# values with planted ties, both zeros, NaN of both signs, infinities,
# WORST and beyond it
_POOL = [0.0, -0.0, 1.5, 1.5, -2.0, 7.25, np.inf, -np.inf, float(WORST), 3.2e38, 0.5, 1e-30]


def _values(draw, n):
    pool = st.sampled_from(_POOL + [NAN, -NAN]) | st.floats(-100, 100, width=32)
    return np.array(draw(st.lists(pool, min_size=n, max_size=n)), dtype=np.float32)


def _idf(draw, n):
    kind = st.lists(st.sampled_from(["empty", "fresh", "fresh", "visited"]), min_size=n, max_size=n)
    ids = np.arange(n, dtype=np.int32) * 3 + 5
    return np.array([-1 if k == "empty" else ids[i] * 2 + (k == "visited")
                     for i, k in enumerate(draw(kind))], dtype=np.int32)


def _min_extract(vals, idf, width):
    """The kernel's first pick, one query: ``width`` rounds of min-extract over
    the slots not visited and not empty (``v < best`` or a tie at a lower
    slot, from ``(WORST, itopk)``: NaN never wins), each pick valid only
    below WORST and masked for the later rounds."""
    itopk = len(vals)
    masked = np.where((idf & 1) | (idf < 0), WORST, vals).astype(np.float32)
    out = []
    for _ in range(width):
        best, sel = WORST, itopk
        for s in range(itopk):
            v = masked[s]
            if v < best or (v == best and s < sel):
                best, sel = v, s
        out.append(sel if best < WORST else -1)
        if best < WORST:
            masked[sel] = WORST
    return out


@st.composite
def beams(draw):
    itopk = draw(st.integers(1, 40))
    width = draw(st.integers(1, itopk))
    return _values(draw, itopk), _idf(draw, itopk), width


@_SETTINGS
@given(beams())
def test_pick_by_rank_equals_min_extract(beam):
    """(a) The rank pick is the first kernel's rounds of min-extract, and
    ``pick_positions`` over today's masking (NaN and values at or past WORST
    masked like visited and empty slots), wherever that is defined."""
    vals, idf, width = beam
    pos, valid = tcs.pick_ranks(torch.from_numpy(vals)[None], torch.from_numpy(idf)[None], width)
    got = [int(p) if v else -1 for p, v in zip(pos[0], valid[0])]
    assert got == _min_extract(vals, idf, width)
    masked = torch.from_numpy(np.where((idf & 1) | (idf < 0) | ~(vals < WORST), WORST, vals))
    ppos, pvalid = tcs.pick_positions(masked[None], width, float(WORST))
    assert torch.equal(pvalid, valid)
    assert torch.equal(ppos[pvalid], pos[valid])


def test_pick_with_fewer_unmasked_slots_than_width():
    vals = torch.tensor([[3.0, -0.0, 0.0, 2.0, float("nan"), 1.0]])
    idf = torch.tensor([[2, 4, 6, 9, 10, -1]], dtype=torch.int32)  # slot 3 visited, 5 empty
    pos, valid = tcs.pick_ranks(vals, idf, 5)
    assert valid.tolist() == [[True, True, True, False, False]]
    assert pos[0, :3].tolist() == [1, 2, 0]  # -0 and +0 tie: the lower slot first


def _sort_merge(uv, uidf, itopk):
    """The kernel's first merge, one query: the union sorted by the 64-bit key (the
    value's order-preserving bits with -0 folded onto +0, then the union
    position), the first ``itopk`` kept, a value >= WORST to id -1, then
    the adjacent-id kill."""
    order = np.lexsort((np.arange(len(uv)), tcs.order_keys(torch.from_numpy(uv)).numpy()))[:itopk]
    v, i = uv[order], np.where(uv[order] >= WORST, -1, uidf[order])
    ids = i >> 1
    prev = np.concatenate([[-2], ids[:-1]])
    dup = (ids == prev) & (ids >= 0)
    return np.where(dup, WORST, v).astype(np.float32), np.where(dup, -1, i).astype(np.int32)


@st.composite
def unions(draw):
    itopk = draw(st.integers(1, 24))
    w = draw(st.integers(1, 24))
    uv = _values(draw, itopk + w)
    # candidates carry ids shared with the beam, so the kill has work
    cid = np.array(draw(st.lists(st.integers(-1, 8), min_size=w, max_size=w)), dtype=np.int32)
    uidf = np.concatenate([_idf(draw, itopk), cid * 2]).astype(np.int32)
    uidf[itopk:][cid < 0] = -2
    uv[itopk:][cid < 0] = WORST
    return uv, uidf, itopk


@_SETTINGS
@given(unions())
def test_rank_merge_equals_stable_sort(union):
    """(b) The rank merge is the bitonic sort of the first kernel's keys (NaN of either
    sign included) with the WORST -> -1 step and the adjacent kill, and,
    without NaN, the plain version's stable sort of the union."""
    uv, uidf, itopk = union
    tv, ti = tcs.rank_merge(torch.from_numpy(uv)[None], torch.from_numpy(uidf)[None], itopk)
    ev, ei = _sort_merge(uv, uidf, itopk)
    np.testing.assert_array_equal(tv[0].numpy().view(np.int32), ev.view(np.int32))
    np.testing.assert_array_equal(ti[0].numpy(), ei)
    if not np.isnan(uv).any():
        _, pos = torch.sort(torch.from_numpy(uv)[None] + 0.0, dim=1, stable=True)
        pos = pos[:, :itopk]
        nv = torch.gather(torch.from_numpy(uv)[None], 1, pos)
        assert torch.equal(nv.view(torch.int32), torch.from_numpy(ev)[None].view(torch.int32))


@_SETTINGS
@given(unions(), st.integers(1, 8), st.lists(st.booleans(), min_size=24, max_size=24))
def test_pick_by_prefix_on_a_merged_beam(union, width, visited):
    """After a merge the kernel picks by the count of unmasked slots before
    each: a merged beam is sorted but for killed slots, which are masked,
    so that count is the rank, whatever slots were visited since."""
    uv, uidf, itopk = union
    tv, ti = tcs.rank_merge(torch.from_numpy(uv)[None], torch.from_numpy(uidf)[None], itopk)
    ti = torch.where((ti >= 0) & torch.tensor(visited[:itopk])[None], ti | 1, ti)
    width = min(width, itopk)
    by_rank = tcs.pick_ranks(tv, ti, width)
    by_prefix = tcs.pick_ranks(tv, ti, width, sorted_beam=True)
    assert all(torch.equal(a, b) for a, b in zip(by_rank, by_prefix))


# -- whole searches: the kernel's schedule against the plain version --------

N, D, DEG, NQ = 240, 24, 8, 4


@pytest.fixture(scope="module")
def graph_data():
    rng = np.random.default_rng(10)
    x = rng.standard_normal((N, D)).astype(np.float32)
    g = rng.integers(0, N, (N, DEG)).astype(np.int32)
    g[::4, -1] = -1  # -1 graph entries
    g[::9, 2] = -1
    q = rng.standard_normal((NQ, D)).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(g), torch.from_numpy(q)


def _seed(x, q, itopk, ip, rng):
    """A seed beam in the kernel's min-ordered form, two empty slots last."""
    seed = torch.from_numpy(rng.choice(N, itopk, replace=False).astype(np.int64))
    sv = tcs.lane_tree_score(q[:, None, :], x[seed][None], ip)
    v0, pos = torch.sort(sv, dim=1, stable=True)
    iv, ii = v0.clone(), (seed[pos] * 2).to(torch.int32)
    if itopk > 2:
        iv[:, -2:], ii[:, -2:] = tcs.WORST, -1
    return iv, ii


# (metric, width, table dtype, itopk, plan as (group_rows, buffers, bitonic))
_SEARCHES = [
    (False, 1, "float32", 16, None),
    (False, 4, "float32", 32, (8, 2, False)),
    (False, 8, "bfloat16", 32, (1, 2, False)),
    (True, 1, "bfloat16", 16, (0, 0, False)),
    (True, 4, "bfloat16", 32, (32, 1, True)),
    (True, 8, "float32", 32, (16, 2, False)),
    (False, 4, "bfloat16", 16, (0, 0, True)),
]


@pytest.mark.parametrize("ip,width,dtype,itopk,plan", _SEARCHES)
def test_kernel_schedule_equals_plain_version(graph_data, ip, width, dtype, itopk, plan):
    """(c) Whole searches through the kernel's schedule (the pick by rank,
    staged groups, batches of four a warp, the rank merge or the bitonic
    sort) equal the plain version bit for bit; width x iters passes the
    beam, so late steps have no valid parent."""
    x, g, q = graph_data
    tab = tcs.build_neighbor_table(x, g, dtype=getattr(torch, dtype))
    iv, ii = _seed(x, q, itopk, ip, np.random.default_rng(itopk + width))
    iters = 2 * itopk // width + 2
    bp = None if plan is None else tcs.BeamPlan(*plan, smem_bytes=0, ctas_per_sm=0)
    rv, ri = tcs.cagra_beam_reference(tab, g, q, iv, ii, itopk=itopk, width=width, iters=iters,
                                      ip=ip)
    kv, ki = tcs.cagra_beam_kernel_reference(tab, g, q, iv, ii, itopk=itopk, width=width,
                                             iters=iters, ip=ip, plan=bp)
    assert torch.equal(ki, ri)
    assert torch.equal(kv.view(torch.int32), rv.view(torch.int32))
    assert (ri >= 0).any() and (ri & 1).any()


@pytest.mark.parametrize("ip", [False, True], ids=["l2", "ip"])
def test_quad_lanes_fold_as_the_lane_tree(ip):
    """Eight lanes a candidate, each keeping the sums of lanes l, l + 8,
    l + 16 and l + 24, folded (l + l + 16) + (l + 8 + l + 24), then as a
    tree over 4, 2, 1, give :func:`lane_tree_score`'s bits (f32
    throughout, as in the kernel)."""
    rng = np.random.default_rng(5)
    for d in (5, 16, 100, 128, 960):
        q = rng.standard_normal(d).astype(np.float32)
        v = (rng.standard_normal((6, d)) * 10.0 ** rng.uniform(-3, 3, (6, 1))).astype(np.float32)
        e = q * v if ip else (q - v) * (q - v)
        for row, want in zip(e, tcs.lane_tree_score(torch.from_numpy(q)[None],
                                                     torch.from_numpy(v), ip).numpy()):
            acc = [np.float32(0)] * 32  # lane L: dimensions L, L + 32, ... in turn
            for t, x in enumerate(row):
                acc[t % 32] = np.float32(acc[t % 32] + x)
            s8 = [np.float32(np.float32(acc[l] + acc[l + 16]) + np.float32(acc[l + 8] + acc[l + 24]))
                  for l in range(8)]
            for off in (4, 2, 1):
                s8 = [np.float32(s8[l] + s8[l + off]) for l in range(off)]
            got = -s8[0] if ip else s8[0]
            assert np.float32(got).view(np.int32) == np.float32(want).view(np.int32)


def test_step_without_valid_parent_still_merges(graph_data):
    """A step whose picks are all invalid still moves a killed slot in the
    middle of the beam to its end, in both versions."""
    x, g, q = graph_data
    tab = tcs.build_neighbor_table(x, g, dtype=torch.float32)
    iv = torch.tensor([[1.0, tcs.WORST, 2.0, 3.0]] * NQ)
    ii = torch.tensor([[11, -1, 21, 31]] * NQ, dtype=torch.int32)  # all visited or empty
    for fn in (tcs.cagra_beam_reference, tcs.cagra_beam_kernel_reference):
        v, i = fn(tab, g, q, iv, ii, itopk=4, width=2, iters=1)
        assert i[0].tolist() == [11, 21, 31, -1]
        assert v[0].tolist() == [1.0, 2.0, 3.0, np.float32(tcs.WORST)]


# -- the shared-memory layout and the launch plan ----------------------------


def _first_smem(itopk, width, deg, d):
    """The kernel's first shared-memory count (one bitonic layout), the
    shapes it accepted being what the plans must keep serving."""
    w = width * deg
    return 8 * next_pow2(itopk + w) + 4 * (d + 4 * itopk + 2 * w + width)


def test_every_shape_served_before_still_has_a_plan():
    """(d) Wherever the first count fits a CTA, some plan fits (the
    unstaged bitonic one takes exactly those bytes), for f32 and bf16
    tables; a shape no plan fits raises."""
    served = 0
    for itopk in (1, 3, 16, 64, 128, 256, 512, 1024, 4096):
        for width in (1, 2, 8, 16, 32, 64):
            if width > itopk:
                continue
            for deg in (1, 3, 16, 32, 64):
                for d in (1, 17, 100, 128, 960, 3072, 20000, 56000, 58000):
                    old = _first_smem(itopk, width, deg, d)
                    assert tcs.smem_bytes(itopk, width, deg, d, bitonic=True) == old
                    for esize in (2, 4):
                        if old > tcs.SMEM_LIMIT_BYTES:  # the rank merge may fit all the same
                            continue
                        plan = tcs.launch_plan(itopk, width, deg, d, esize, 64, 132)
                        assert plan.smem_bytes <= tcs.SMEM_LIMIT_BYTES
                        assert plan.smem_bytes == tcs.smem_bytes(
                            itopk, width, deg, d, esize, plan.group_rows, plan.buffers,
                            plan.bitonic)
                        served += 1
    assert served > 1000
    with pytest.raises(LogicError):
        tcs.launch_plan(8192, 8, 64, 128, 4, 64, 132)


def test_constants_mirror_the_kernel():
    """(d) The module's constants are the .cu's."""
    src = open(_CU).read()

    def const(name):
        return re.search(rf"constexpr \w+ {name} = ([0-9.e]+)f?;", src).group(1)

    assert int(const("THREADS")) == tcs.THREADS
    assert int(const("BATCH")) == tcs.BATCH
    assert int(const("RANK_MAX")) == tcs.RANK_MAX
    assert int(const("MIN_CTAS")) == tcs.MIN_CTAS
    assert float(const("WORST")) == tcs.WORST
    assert int(const("SMEM_LIMIT")) == tcs.SMEM_LIMIT_BYTES
    assert int(const("ROW_PAD")) == tcs.ROW_PAD
    assert tcs._LAYOUT == (tcs.THREADS, tcs.BATCH, tcs.RANK_MAX, tcs.MIN_CTAS, tcs.ROW_PAD)


def test_launch_plan_stages_by_batch_size():
    """(d) The plan stages as many rows at once as keeps the fewest waves:
    every row of a step at 128 and at 1,024 queries (five CTAs an SM take
    two waves, as six would), groups of 4 rows at d = 960 (one wave) where
    groups of 8 take two; past a rank merge's union the bitonic sort; a row
    too wide to stage is read from global memory."""
    regs6 = lambda smem, direct: tcs.smem_ctas_per_sm(smem, 6)
    serving = tcs.launch_plan(128, 8, 16, 128, 2, 128, 132, regs6)
    assert (serving.group_rows, serving.buffers, serving.bitonic) == (128, 1, False)
    assert serving.smem_bytes == tcs.smem_bytes(128, 8, 16, 128) + 128 * (128 + tcs.ROW_PAD) * 2
    big = tcs.launch_plan(128, 8, 16, 128, 2, 1024, 132, regs6)
    assert (big.group_rows, big.buffers, big.ctas_per_sm) == (128, 1, 5)
    assert tcs.launch_plan(256, 16, 32, 128, 4, 512, 132).bitonic
    wide = tcs.launch_plan(128, 8, 16, 32768, 4, 10, 132)
    assert (wide.group_rows, wide.buffers) == (0, 0)
    d960 = tcs.launch_plan(128, 8, 16, 960, 4, 512, 132, regs6)
    assert (d960.group_rows, d960.buffers, d960.ctas_per_sm) == (4, 2, 5)


# -- the seeds the fused search caches -------------------------------------


def test_cached_seeds_give_the_same_seed_beam(monkeypatch):
    """(e) The cached strided ids equal the numpy formula, their rows and
    norms equal a fresh gather, the seed beam from them is equal, and a
    fused search reads the cache and makes no generator."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((500, 16)).astype(np.float32)
    g = rng.integers(0, 500, (500, 8)).astype(np.int32)
    index = tcagra.from_graph(torch.from_numpy(x), torch.from_numpy(g), "sqeuclidean",
                              device="cpu")
    for sample in (64, 500, 700):
        ids, rows, norms = tcagra._fused_seeds(index, sample)
        s = min(sample, 500)
        np.testing.assert_array_equal(ids.numpy(), (np.arange(s) * 500) // s)
        assert ids.dtype == torch.int32 and tcagra._fused_seeds(index, sample)[0] is ids
        assert torch.equal(rows, index.dataset[ids.to(torch.int64)].to(torch.float32))
        assert torch.equal(norms, index.sqnorms[ids.to(torch.int64)])
        qf = torch.from_numpy(rng.standard_normal((5, 16)).astype(np.float32))
        qn = torch.sum(qf * qf, dim=1)
        fresh = tcagra.strided_seed_ids(500, sample)
        want = tcagra._seed_select(qf, qn, index.dataset[fresh.to(torch.int64)], index.sqnorms[fresh.to(torch.int64)],
                                   fresh, itopk=32, select_min=True, worst=float("inf"))
        got = tcagra._seed_select(qf, qn, rows, norms, ids, itopk=32, select_min=True,
                                  worst=float("inf"))
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    sp = tcagra.CagraSearchParams(itopk_size=32, search_width=4, init_sample=64, dedup="post")
    monkeypatch.setattr(torch, "Generator", None)  # a fused search must not make one
    v, i = tcagra.search(index, torch.from_numpy(x[:7]), 5, sp, mode="fused")
    assert i.shape == (7, 5) and (i >= 0).all() and 64 in index._fused_seed_cache
