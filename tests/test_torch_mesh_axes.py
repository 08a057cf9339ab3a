"""Meshes of several axes: the port's verbs and lists-sharded searches on a
``2 x 4`` single-controller CPU mesh (``make_mesh(["cpu"] * 8, shape=(2,
4), axis_names=("rows", "cols"))``) against raft_tpu on
``make_mesh(jax.devices()[:8], shape=(2, 4))``, the pattern of
``tests/test_comms.py:172-187``.

Every verb runs along each axis on the same numpy blocks (shard ``(i,
j)`` holds block ``[i, j]``): moved bytes and reductions must equal JAX's
``shard_map`` bit for bit on every shard, and the ``comms.*`` counters
JAX's (bytes scaled by the size of the axis the verb ran on). The
searches shard along one axis and replicate over the other: each equals
the port's search on a one-axis mesh of that axis's size bit for bit
under every merge mode, with ids equal to raft_tpu's on the 2-D mesh and
values within rtol 1e-5. So do the query-sharded IVF-PQ and CAGRA searches
(CAGRA with random seeds held within JAX's 0.1 recall margin, its seeds
drawn by the coordinate along the axis), the distributed build's Lloyd and
codebook steps and the whole build from JAX's draws (codes equal, fields
within rtol 1e-5, ``comms.*`` counters JAX's), ``TieredShardedIndex`` and
the engine's sharded and tiered sharded registrations, whose served bits
equal the direct search on the same mesh and the one-axis mesh's.
"""
import contextlib
import functools
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from raft_tpu import obs as jobs
from raft_tpu.neighbors import ivf_flat as jflat
from raft_tpu.neighbors import ivf_pq as jpq
from raft_tpu.parallel import comms as jcomms
from raft_tpu.parallel import make_mesh as jmake_mesh
from raft_tpu.parallel._compat import shard_map
from raft_tpu.parallel import sharded_ann as jsa
from raft_tpu.parallel.sharded_ann import sharded_ivf_flat_search as j_sharded_flat
from raft_tpu.parallel.sharded_ann import sharded_ivf_pq_lists_search as j_sharded_pq
from raft_tpu.parallel.sharded_knn import sharded_knn as j_sharded_knn
from raft_tpu_torch import obs
from raft_tpu_torch.core.errors import LogicError, ShardFailure
from raft_tpu_torch.neighbors import ivf_flat as tflat
from raft_tpu_torch.neighbors import ivf_pq as tpq
from raft_tpu_torch.parallel import sharded_ann as tsa
from raft_tpu_torch.parallel import (
    comms,
    make_mesh,
    sharded_cagra_search,
    sharded_ivf_flat_search,
    sharded_ivf_pq_build,
    sharded_ivf_pq_lists_search,
    sharded_ivf_pq_search,
    sharded_knn,
)

SHAPE, AXES = (2, 4), ("rows", "cols")
SIZE = {"rows": 2, "cols": 4}
N, D, N_LISTS, NQ, K, N_PROBES = 2048, 16, 16, 20, 7, 3
MODES = ("ring", "fused_ring", "gather")


def port_mesh():
    return make_mesh(["cpu"] * 8, shape=SHAPE, axis_names=AXES)


def jax_mesh():
    return jmake_mesh(jax.devices()[:8], shape=SHAPE, axis_names=AXES)


def grid(shape, seed):
    """One f32 block per shard: ``[2, 4, *shape]``, distinct everywhere."""
    return np.random.default_rng(seed).standard_normal(SHAPE + tuple(shape)).astype(np.float32)


def jax_shards(fn, *grids):
    """``fn`` on each shard of JAX's 2-D mesh (shard ``(i, j)`` given
    ``g[i, j]`` of each input); the outputs as ``[2, 4, ...]`` arrays."""

    def body(*bs):
        return jax.tree_util.tree_map(lambda o: o[None, None], fn(*[b[0, 0] for b in bs]))

    f = jax.jit(shard_map(body, mesh=jax_mesh(), in_specs=tuple(P(*AXES) for _ in grids),
                          out_specs=P(*AXES), check_vma=False))
    return jax.tree_util.tree_map(np.asarray, f(*[jnp.asarray(g) for g in grids]))


def port_shards(g):
    return [torch.from_numpy(g[r // 4, r % 4].copy()) for r in range(8)]


def assert_shards_equal(got, want):
    assert len(got) == 8
    for r, t in enumerate(got):
        w = want[r // 4, r % 4]
        assert t.numpy().dtype == w.dtype, (t.dtype, w.dtype)
        np.testing.assert_array_equal(t.numpy(), w, err_msg=f"shard {r}")


def _cases(axis):
    """``{verb: (jax fn of one block, port fn of (mesh, xs), input grid)}``
    along ``axis``."""
    n = SIZE[axis]
    x, sq = grid((4, 3), 3), grid((n, 2, 3), 4)
    ring = [(i, (i + 1) % n) for i in range(n)]
    cases = {f"allreduce_{op}": (lambda b, op=op: jcomms.allreduce(b, op=op, axis=axis),
                                 lambda m, xs, op=op: comms.allreduce(m, xs, op=op, axis=axis), x)
             for op in ("sum", "max", "min", "prod")}
    cases.update({
        "allgather": (lambda b: jcomms.allgather(b, axis=axis),
                      lambda m, xs: comms.allgather(m, xs, axis=axis), x),
        "allgather_tiled": (lambda b: jcomms.allgather(b, axis=axis, tiled=True),
                            lambda m, xs: comms.allgather(m, xs, tiled=True, axis=axis), x),
        "reducescatter": (lambda b: jcomms.reducescatter(b, axis=axis),
                          lambda m, xs: comms.reducescatter(m, xs, axis=axis), x),
        "bcast": (lambda b: jcomms.bcast(b, root=n - 1, axis=axis),
                  lambda m, xs: comms.bcast(m, xs, root=n - 1, axis=axis), x),
        "reduce": (lambda b: jcomms.reduce(b, root=1, axis=axis),
                   lambda m, xs: comms.reduce(m, xs, root=1, axis=axis), x),
        "ppermute": (lambda b: jcomms.ppermute(b, ring, axis=axis),
                     lambda m, xs: comms.ppermute(m, xs, ring, axis=axis), x),
        "send_recv": (lambda b: jcomms.send_recv(b, n - 1, 0, axis=axis),
                      lambda m, xs: comms.send_recv(m, xs, n - 1, 0, axis=axis), x),
        "gather": (lambda b: jcomms.gather(b, root=n - 1, axis=axis),
                   lambda m, xs: comms.gather(m, xs, root=n - 1, axis=axis), x),
        "scatter": (lambda b: jcomms.scatter(b, root=n - 1, axis=axis),
                    lambda m, xs: comms.scatter(m, xs, root=n - 1, axis=axis), sq),
        "device_sendrecv": (lambda b: jcomms.device_sendrecv(b, [(0, n - 1)], axis=axis),
                            lambda m, xs: comms.device_sendrecv(m, xs, [(0, n - 1)], axis=axis), x),
        "multicast_sendrecv": (
            lambda b: jcomms.multicast_sendrecv(b, [(n - 1, 0), (n - 1, 1)], axis=axis),
            lambda m, xs: comms.multicast_sendrecv(m, xs, [(n - 1, 0), (n - 1, 1)], axis=axis), x),
        "barrier": (lambda b: jcomms.barrier(axis=axis),
                    lambda m, xs: comms.barrier(m, axis=axis), x),
        "comm_rank": (lambda b: jcomms.comm_rank(axis),
                      lambda m, xs: comms.comm_rank(m, axis), x),
    })
    return cases


VERBS = sorted(_cases("rows"))


@pytest.mark.parametrize("verb", VERBS)
@pytest.mark.parametrize("axis", AXES)
def test_each_verb_along_each_axis_matches_jax(axis, verb):
    jfn, tfn, g = _cases(axis)[verb]
    want = jax_shards(jfn, g)
    got = tfn(port_mesh(), port_shards(g))
    if verb == "comm_rank":
        want = want.astype(np.int32)
    assert_shards_equal(got, want)


@pytest.mark.parametrize("axis", AXES)
def test_gatherv_along_each_axis_matches_jax(axis):
    x = grid((4, 3), 5)
    valid = (np.arange(8).reshape(SHAPE) % 3 + 1).astype(np.int32)
    jb, js = jax_shards(lambda b, v: jcomms.gatherv(b, v, root=1, axis=axis), x, valid)
    got = comms.gatherv(port_mesh(), port_shards(x), [int(v) for v in valid.reshape(-1)], root=1,
                        axis=axis)
    assert_shards_equal([b for b, _ in got], jb)
    assert_shards_equal([s for _, s in got], js)


def test_rows_and_cols_sums_as_test_comms():
    """``tests/test_comms.py::test_mesh_2d_subcomms``: ones summed along
    each axis give 2 and 4 on every shard."""
    ones = [torch.ones((), dtype=torch.float32) for _ in range(8)]
    mesh = port_mesh()
    assert [float(t) for t in comms.allreduce(mesh, ones, axis="rows")] == [2.0] * 8
    assert [float(t) for t in comms.allreduce(mesh, ones, axis="cols")] == [4.0] * 8


@contextlib.contextmanager
def counting(mod):
    reg = mod.registry()
    reg.reset()
    mod.enable()
    out = {}
    try:
        yield out
        out.update({k: v for k, v in reg.as_dict()["counters"].items() if k.startswith("comms.")})
    finally:
        mod.disable()
        reg.reset()


@pytest.mark.parametrize("verb", ["allreduce_sum", "allgather", "reducescatter", "ppermute",
                                  "scatter", "bcast"])
@pytest.mark.parametrize("axis", AXES)
def test_counters_label_the_axis_and_scale_by_its_size_as_jax(axis, verb):
    jfn, tfn, g = _cases(axis)[verb]
    with counting(jobs) as jc:
        jax_shards(jfn, g)
    with counting(obs) as tc:
        tfn(port_mesh(), port_shards(g))
    assert tc and all(f'axis="{axis}"' in key for key in tc)
    assert tc == jc


def test_mesh_layout_is_row_major_with_an_ordered_shape():
    mesh = port_mesh()
    assert mesh.size == 8 and list(mesh.shape.items()) == [("rows", 2), ("cols", 4)]
    assert mesh.shape == dict(jax_mesh().shape)
    assert [mesh.coord(r, "rows") for r in range(8)] == [0] * 4 + [1] * 4
    assert [mesh.coord(r, "cols") for r in range(8)] == [0, 1, 2, 3] * 2
    assert comms.comm_size(mesh, "cols") == 4 and comms.comm_split(mesh, "rows") == {
        "axis": "rows", "size": 2}
    assert [g for _, g in mesh.along("rows")] == [(0, 4), (1, 5), (2, 6), (3, 7)]
    assert [g for _, g in mesh.along("cols")] == [(0, 1, 2, 3), (4, 5, 6, 7)]


def test_init_comms_takes_jax_s_parameter_order():
    from raft_tpu_torch.core.resources import Resources

    res = Resources(device="cpu")
    mesh = comms.init_comms(res, ["cpu"] * 8, (4, 2), ("a", "b"))
    assert res.get_mesh() is mesh and mesh.shape == {"a": 4, "b": 2}
    assert comms.make_mesh(["cpu"] * 6, (2, 3), ("a", "b")).shape == {"a": 2, "b": 3}


@pytest.mark.parametrize("bad", [dict(shape=(3, 4)), dict(shape=(8,), axis_names=("a", "b")),
                                 dict(shape=(2, 4), axis_names=("a", "a"))])
def test_a_shape_that_does_not_fit_raises(bad):
    with pytest.raises(LogicError):
        make_mesh(["cpu"] * 8, **{"axis_names": ("a", "b"), **bad})


def test_a_verb_needs_an_axis_on_a_mesh_of_several():
    xs = port_shards(grid((2,), 0))
    with pytest.raises(LogicError, match="several axes"):
        comms.allreduce(port_mesh(), xs)
    with pytest.raises(LogicError, match="not in mesh axes"):
        comms.allreduce(port_mesh(), xs, axis="data")


# -- searches ----------------------------------------------------------------------------


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(73)
    centers = rng.normal(size=(20, D)).astype(np.float32) * 3
    x = (centers[rng.integers(0, 20, N)] + rng.normal(size=(N, D))).astype(np.float32)
    q = (centers[rng.integers(0, 20, NQ)] + rng.normal(size=(NQ, D))).astype(np.float32)
    return x, q


@pytest.fixture(scope="module")
def indexes(corpus):
    x, _ = corpus
    jf = jflat.build(x, jflat.IvfFlatIndexParams(n_lists=N_LISTS))
    jp = jpq.build(x, jpq.IvfPqIndexParams(n_lists=N_LISTS, pq_dim=8, kmeans_n_iters=4))
    out = {}
    for name, jmod, tmod, ji in (("flat", jflat, tflat, jf), ("pq", jpq, tpq, jp)):
        buf = io.BytesIO()
        jmod.save(ji, buf)
        buf.seek(0)
        out[name] = (ji, tmod.load(buf, device="cpu"))
    return out


def _search(kind, mesh, indexes, corpus, axis, mode, jax=False):
    x, q = corpus
    if kind == "knn":
        if jax:
            return j_sharded_knn(mesh, x, q, K, metric="sqeuclidean", axis=axis, merge_mode=mode)
        return sharded_knn(mesh, torch.from_numpy(x), torch.from_numpy(q), K, metric="sqeuclidean",
                           axis=axis, merge_mode=mode)
    ji, ti = indexes[kind]
    health = [s != 1 for s in range(SIZE[axis])] if kind == "pq" else None
    if jax:
        fn = j_sharded_flat if kind == "flat" else j_sharded_pq
        return fn(mesh, ji, q, K, n_probes=N_PROBES, axis=axis, merge_mode=mode,
                  health=None if health is None else np.array(health))
    fn = sharded_ivf_flat_search if kind == "flat" else sharded_ivf_pq_lists_search
    return fn(mesh, ti, torch.from_numpy(q), K, n_probes=N_PROBES, axis=axis, merge_mode=mode,
              health=health)


@pytest.mark.parametrize("kind", ["knn", "flat", "pq"])
@pytest.mark.parametrize("axis", AXES)
def test_each_search_along_each_axis_matches_jax_and_the_one_axis_mesh(indexes, corpus, axis,
                                                                        kind):
    jd, ji = (np.asarray(a) for a in _search(kind, jax_mesh(), indexes, corpus, axis, "gather",
                                             jax=True))
    one = _search(kind, make_mesh(["cpu"] * SIZE[axis], axis_names=(axis,)), indexes, corpus,
                  axis, "gather")
    for mode in MODES:
        d, i = _search(kind, port_mesh(), indexes, corpus, axis, mode)
        assert torch.equal(i, one[1]) and torch.equal(d.view(torch.int32), one[0].view(torch.int32))
        np.testing.assert_array_equal(i.numpy(), ji)
        np.testing.assert_allclose(d.numpy(), jd, rtol=1e-5, atol=1e-5)


def test_the_ring_runs_in_every_group_of_the_axis(monkeypatch):
    """A ring along ``cols`` runs once in each of the two rows' groups,
    each of them a one-axis view of four shards."""
    from raft_tpu_torch.ops import ring_topk as rt

    seen = []
    real = rt.ring_topk_reference

    def spy(vs, is_, k, select_min, mesh, scan_fold=False):
        seen.append((mesh.size, mesh.axis_names))
        return real(vs, is_, k, select_min, mesh, scan_fold)

    monkeypatch.setattr(rt, "ring_topk_reference", spy)
    g = grid((5, 9), 8)
    vs = port_shards(g)
    is_ = [torch.arange(45, dtype=torch.int32).reshape(5, 9) + 100 * r for r in range(8)]
    vals, ids = rt.ring_topk(port_mesh(), vs, is_, 4, axis="cols")
    assert seen == [(4, ("cols",)), (4, ("cols",))]
    for row in range(2):
        gv, gi = rt.gather_merge(make_mesh(["cpu"] * 4), vs[4 * row:4 * row + 4],
                                 is_[4 * row:4 * row + 4], 4, True)
        for j in range(4):
            assert torch.equal(vals[4 * row + j], gv[j]) and torch.equal(ids[4 * row + j], gi[j])


# -- query-sharded search ----------------------------------------------------------------

PQ_KINDS = {"nibble": dict(), "kmeans": dict(pq_kind="kmeans"),
            "per_cluster": dict(pq_kind="kmeans", codebook_kind="per_cluster")}
CAGRA_SP = dict(itopk_size=64, search_width=4)


def _load(jmod, tmod, index):
    buf = io.BytesIO()
    jmod.save(index, buf)
    buf.seek(0)
    return tmod.load(buf, device="cpu")


def one_axis(axis):
    return make_mesh(["cpu"] * SIZE[axis], axis_names=(axis,))


def assert_bits(got, want):
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))


def assert_ids_and_values(got, want):
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def pq_kinds(corpus):
    x, _ = corpus
    out = {}
    for kind, kw in PQ_KINDS.items():
        ji = jpq.build(x, jpq.IvfPqIndexParams(n_lists=N_LISTS, pq_dim=8, kmeans_n_iters=4, **kw))
        out[kind] = (ji, _load(jpq, tpq, ji))
    return out


@pytest.fixture(scope="module")
def cagra_pair(corpus):
    from raft_tpu.neighbors import cagra as jcagra
    from raft_tpu_torch.neighbors import cagra as tcagra

    x, q = corpus
    selfd = (x * x).sum(1)[:, None] + (x * x).sum(1)[None, :] - 2.0 * x @ x.T
    np.fill_diagonal(selfd, np.inf)
    knn = np.argsort(selfd, axis=1, kind="stable")[:, :32].astype(np.int32)
    ji = jcagra.from_graph(x, np.asarray(jcagra.optimize(knn, 16)), "sqeuclidean")
    d2 = (q * q).sum(1)[:, None] + (x * x).sum(1)[None, :] - 2.0 * q @ x.T
    gt = torch.from_numpy(np.argsort(d2, axis=1, kind="stable")[:, :K].astype(np.int32))
    return ji, _load(jcagra, tcagra, ji), gt


@pytest.mark.parametrize("kind", sorted(PQ_KINDS))
@pytest.mark.parametrize("axis", AXES)
def test_query_sharded_ivf_pq_along_each_axis(pq_kinds, corpus, axis, kind):
    _, q = corpus
    ji, ti = pq_kinds[kind]
    want = jsa.sharded_ivf_pq_search(jax_mesh(), ji, q, K, jpq.IvfPqSearchParams(n_probes=N_PROBES),
                                     axis=axis)
    p = tpq.IvfPqSearchParams(n_probes=N_PROBES)
    got = sharded_ivf_pq_search(port_mesh(), ti, q, K, p, axis=axis)
    assert_ids_and_values(got, want)
    assert_bits(got, sharded_ivf_pq_search(one_axis(axis), ti, q, K, p, axis=axis))


@pytest.mark.parametrize("init_sample", [512, 0])
@pytest.mark.parametrize("axis", AXES)
def test_query_sharded_cagra_along_each_axis(cagra_pair, corpus, axis, init_sample):
    from raft_tpu.neighbors import cagra as jcagra
    from raft_tpu_torch.neighbors import cagra as tcagra
    from raft_tpu_torch.stats.recall import neighborhood_recall

    _, q = corpus
    ji, ti, gt = cagra_pair
    sp = dict(CAGRA_SP, init_sample=init_sample, seed=3)
    want = jsa.sharded_cagra_search(jax_mesh(), ji, q, K, jcagra.CagraSearchParams(**sp), axis=axis)
    got = sharded_cagra_search(port_mesh(), ti, q, K, tcagra.CagraSearchParams(**sp), axis=axis)
    assert_bits(got, sharded_cagra_search(one_axis(axis), ti, q, K, tcagra.CagraSearchParams(**sp),
                                          axis=axis))
    if init_sample:
        assert_ids_and_values(got, want)
    else:  # random seeds: the packages draw differently, JAX's margin
        jrec = neighborhood_recall(torch.from_numpy(np.array(want[1])), gt)
        assert neighborhood_recall(got[1], gt) >= jrec - 0.1


def test_cagra_seeds_follow_the_coordinate_along_the_axis(cagra_pair, corpus, monkeypatch):
    """Shards that differ only on the other axis draw their random seeds
    from the same ``(seed, coordinate)``, as JAX folds
    ``lax.axis_index(axis)`` into its key."""
    from raft_tpu_torch.neighbors import cagra as tcagra
    from raft_tpu_torch.parallel import sharded_ann as tsa

    seen, real = [], tsa._rank_generator
    monkeypatch.setattr(tsa, "_rank_generator",
                        lambda seed, a, dev: seen.append((seed, a)) or real(seed, a, dev))
    _, ti, _ = cagra_pair
    sp = tcagra.CagraSearchParams(**CAGRA_SP, init_sample=0, seed=5)
    for axis in AXES:
        seen.clear()
        sharded_cagra_search(port_mesh(), ti, corpus[1], K, sp, axis=axis)
        assert seen == [(5, port_mesh().coord(r, axis)) for r in range(8)], axis
    draws = {a: torch.randint(0, 100, (8,), generator=real(5, a, "cpu")) for a in range(2)}
    assert not torch.equal(draws[0], draws[1])


# -- the distributed build ---------------------------------------------------------------

BUILD_ITERS, PQ_DIM, KSUB = 4, 8, 16


def j_steps(axis, step, init, rows, iters, **kw):
    """JAX's step ``step`` inside ``shard_map`` on the 2-D mesh, the rows
    split along ``axis``: the replicated state after each iteration."""
    from raft_tpu.cluster.kmeans import flash_norm_cache as j_flash_norm_cache
    from raft_tpu_torch.ops.distance import DistanceType

    ca = kw.get("comm_mode") == "ca"

    @functools.partial(shard_map, mesh=jax_mesh(), in_specs=(P(), P(axis)), out_specs=P(),
                       check_vma=False)
    def run(c0, xl):
        c, carry, outs = c0, None, []
        cache = j_flash_norm_cache(xl, DistanceType.L2Expanded) if step == "lloyd" else None
        for _ in range(iters):
            if step == "lloyd":
                out = jsa.dist_lloyd_step(c, xl, N_LISTS, axis, cache=cache, carry=carry, **kw)
            else:
                out = jsa.dist_codebook_step(c, xl, KSUB, axis, carry=carry, **kw)
            if ca:
                c, carry = out[0], out[-1]
            else:
                c = out[0] if step == "lloyd" else out
            outs.append(c)
        return jnp.stack(outs)

    return np.asarray(jax.jit(run)(jnp.asarray(init), jnp.asarray(rows)))


def t_steps(mesh, axis, step, init, rows, iters, **kw):
    """The port's step on ``mesh`` along ``axis``: every local shard's
    state after each iteration, ``[iters, shards, ...]``."""
    from raft_tpu_torch.cluster.kmeans import flash_norm_cache

    ca = kw.get("comm_mode") == "ca"
    xs = comms.row_sharded(mesh, torch.from_numpy(rows), axis)
    caches = [flash_norm_cache(x) for x in xs] if step == "lloyd" else None
    c, carry, outs = comms.replicated(mesh, torch.from_numpy(init)), None, []
    for _ in range(iters):
        if step == "lloyd":
            out = tsa.dist_lloyd_step(mesh, c, xs, N_LISTS, axis, caches=caches, carry=carry, **kw)
        else:
            out = tsa.dist_codebook_step(mesh, c, xs, KSUB, axis, carry=carry, **kw)
        if ca:
            c, carry = out[0], out[-1]
        else:
            c = out[0] if step == "lloyd" else out
        outs.append(torch.stack(c))
    return torch.stack(outs)


def step_inputs(step, x):
    if step == "lloyd":
        return x[:N_LISTS], x
    resid = (x - x.mean(axis=0)).reshape(N, PQ_DIM, -1)
    pick = np.random.default_rng(5).choice(N, KSUB, replace=False)
    return resid[pick].transpose(1, 0, 2).copy(), resid


@pytest.mark.parametrize("mode", ["full", "ca"])
@pytest.mark.parametrize("step", ["lloyd", "codebook"])
@pytest.mark.parametrize("axis", AXES)
def test_build_steps_along_each_axis(corpus, axis, step, mode):
    """Every shard's state after each step: within rtol 1e-5 of JAX's on the
    2-D mesh, and the one-axis mesh's bits (every shard of a group holds
    the same)."""
    init, rows = step_inputs(step, corpus[0])
    kw = {} if mode == "full" else dict(comm_mode="ca")
    want = j_steps(axis, step, init, rows, BUILD_ITERS, **kw)
    got = t_steps(port_mesh(), axis, step, init, rows, BUILD_ITERS, **kw)
    one = t_steps(one_axis(axis), axis, step, init, rows, BUILD_ITERS, **kw)
    for r in range(8):
        assert torch.equal(got[:, r], one[:, 0]), r
        np.testing.assert_allclose(got[:, r].numpy(), want, rtol=1e-5, atol=1e-5)


def jax_draws(x, params):
    """The JAX build's own draws: initial centers and the rotation."""
    from raft_tpu.random.rng import as_key

    k_init, k_rot = jax.random.split(as_key(params.seed))
    init = np.asarray(jnp.asarray(x)[jax.random.permutation(k_init, N)[:params.n_lists]])
    rot_dim = -(-D // params.pq_dim) * params.pq_dim
    rotation = np.asarray(jpq._make_rotation(k_rot, rot_dim, D, params.force_random_rotation))
    return init, rotation


BUILD_FIELDS = ("centers", "rotation", "pq_centers", "codes", "list_indices", "list_sizes",
                "rot_sqnorms")


@pytest.mark.parametrize("mode", ["full", "ca"])
@pytest.mark.parametrize("axis", AXES)
def test_build_from_jax_draws_along_each_axis(corpus, axis, mode):
    x, _ = corpus
    kw = dict(n_lists=N_LISTS, pq_dim=PQ_DIM, kmeans_n_iters=BUILD_ITERS, seed=2)
    with counting(jobs) as jc:
        ji = jsa.sharded_ivf_pq_build(jax_mesh(), x, jpq.IvfPqIndexParams(**kw), axis=axis,
                                      comm_mode=mode)
    init, rotation = jax_draws(x, jpq.IvfPqIndexParams(**kw))
    with counting(obs) as tc:
        ti = tsa._sharded_ivf_pq_build_from(port_mesh(), x, tpq.IvfPqIndexParams(**kw), init,
                                            rotation, axis=axis, comm_mode=mode)
    one = tsa._sharded_ivf_pq_build_from(one_axis(axis), x, tpq.IvfPqIndexParams(**kw), init,
                                         rotation, axis=axis, comm_mode=mode)
    for name in BUILD_FIELDS:
        assert torch.equal(getattr(ti, name), getattr(one, name)), name
    np.testing.assert_array_equal(ti.codes.numpy(), np.asarray(ji.codes))
    np.testing.assert_array_equal(ti.list_indices.numpy(), np.asarray(ji.list_indices))
    for name in ("centers", "pq_centers", "rot_sqnorms"):
        np.testing.assert_allclose(getattr(ti, name).numpy(), np.asarray(getattr(ji, name)),
                                   rtol=1e-5, atol=1e-5)
    assert any(key.startswith("comms.build.bytes") for key in jc)
    assert tc == jc


def test_the_build_with_its_own_draws_is_the_one_axis_build(corpus):
    x, _ = corpus
    p = tpq.IvfPqIndexParams(n_lists=N_LISTS, pq_dim=PQ_DIM, kmeans_n_iters=BUILD_ITERS, seed=4)
    for axis in AXES:
        got = sharded_ivf_pq_build(port_mesh(), x, p, axis=axis, comm_mode="ca")
        want = sharded_ivf_pq_build(one_axis(axis), x, p, axis=axis, comm_mode="ca")
        for name in BUILD_FIELDS:
            assert torch.equal(getattr(got, name), getattr(want, name)), (axis, name)


# -- tiered sharded search and the engine ------------------------------------------------


def tiered(mesh, indexes, pq_kinds, corpus, axis, algo, **kw):
    from raft_tpu_torch.tiered import ShardedHostTier, TieredShardedIndex

    ti = indexes["flat"][1] if algo == "ivf_flat" else pq_kinds["kmeans"][1]
    sp = (tflat.IvfFlatSearchParams(n_probes=N_PROBES) if algo == "ivf_flat" else
          tpq.IvfPqSearchParams(n_probes=N_PROBES))
    tier = ShardedHostTier.from_lists(ti, corpus[0], SIZE[axis])
    return TieredShardedIndex(mesh, algo, ti, tier, axis=axis, refine_ratio=2, micro_batch=8,
                              search_params=sp, **kw)


@pytest.mark.parametrize("algo", ["ivf_flat", "ivf_pq_lists"])
@pytest.mark.parametrize("axis", AXES)
def test_tiered_sharded_along_each_axis(indexes, pq_kinds, corpus, axis, algo):
    """Healthy, then shard 1 demoted: the one-axis tiered search's bits, the
    same coverage, and ids equal to raft_tpu's tiered sharded search on the
    2-D mesh."""
    from raft_tpu.tiered import ShardedHostTier as JTier
    from raft_tpu.tiered import TieredShardedIndex as JTieredSharded

    x, q = corpus
    ji = indexes["flat"][0] if algo == "ivf_flat" else pq_kinds["kmeans"][0]
    jsp = (jflat.IvfFlatSearchParams(n_probes=N_PROBES) if algo == "ivf_flat" else
           jpq.IvfPqSearchParams(n_probes=N_PROBES))
    jt = JTieredSharded(jax_mesh(), algo, ji, JTier.from_lists(ji, x, SIZE[axis]), axis=axis,
                        refine_ratio=2, micro_batch=8, search_params=jsp)
    got_t = tiered(port_mesh(), indexes, pq_kinds, corpus, axis, algo)
    one_t = tiered(one_axis(axis), indexes, pq_kinds, corpus, axis, algo)
    for health in (None, [s != 1 for s in range(SIZE[axis])]):
        got, one, want = (t.search(q, K, health=health) for t in (got_t, one_t, jt))
        assert_bits(tuple(got), tuple(one))
        assert (got.coverage, got.failed_shards) == (one.coverage, one.failed_shards) == (
            want.coverage, want.failed_shards)
        assert_ids_and_values(tuple(got), tuple(want))


def _served(eng, index_id, q, rows=4):
    futs = eng.submit_many(index_id, q, K, request_rows=rows)
    eng.run_until_idle()
    out = [f.result() for f in futs]
    return (torch.from_numpy(np.concatenate([r.distances for r in out])),
            torch.from_numpy(np.concatenate([r.indices for r in out])), out)


@pytest.mark.parametrize("algo", ["sharded_ivf_flat", "sharded_ivf_pq_lists", "tiered_sharded"])
@pytest.mark.parametrize("axis", AXES)
def test_engine_registrations_along_each_axis(indexes, pq_kinds, corpus, axis, algo):
    """Served on the 2-D mesh: each request's bits equal the direct search
    of its padded batch on that mesh, and the one-axis mesh's engine serves
    the same bits; with shard 1's probe down, the same bits, coverage and
    failed shards as there."""
    from raft_tpu_torch.core.resources import Resources
    from raft_tpu_torch.robust import faults
    from raft_tpu_torch.robust.degrade import sharded_search_degraded
    from raft_tpu_torch.serve import ServingEngine

    _, q = corpus
    got = {}
    for name, mesh in (("2d", port_mesh()), ("1d", one_axis(axis))):
        eng = ServingEngine(max_batch=8, max_wait_ms=0.0, res=Resources(device="cpu"))
        if algo == "tiered_sharded":
            eng.register("s", algo, tiered(mesh, indexes, pq_kinds, corpus, axis, "ivf_pq_lists",
                                           merge_mode="ring"))
        else:
            ti = indexes["flat"][1] if algo == "sharded_ivf_flat" else pq_kinds["kmeans"][1]
            eng.register("s", algo, ti, mesh=mesh, axis=axis, n_probes=N_PROBES)
        got[name] = _served(eng, "s", q)
        with faults.injected("sharded_ann.shard_scan", error=ShardFailure("down", shard=1),
                             match={"shard": 1}):
            got[name + "_down"] = _served(eng, "s", q)
    for case in ("", "_down"):
        assert_bits(got["2d" + case][:2], got["1d" + case][:2])
        cov = {(r.coverage, r.failed_shards) for r in got["2d" + case][2]}
        assert cov == ({(1.0, ())} if not case else {(1 - 1 / SIZE[axis], (1,))})
    if algo != "tiered_sharded":
        ti = indexes["flat"][1] if algo == "sharded_ivf_flat" else pq_kinds["kmeans"][1]
        for b in range(0, NQ, 8):  # each served batch: 8 rows, as the direct search
            d, i = sharded_search_degraded(port_mesh(), ti, torch.from_numpy(q[b:b + 8]), K,
                                           algo=algo.replace("sharded_", ""), axis=axis,
                                           n_probes=N_PROBES)
            assert_bits((got["2d"][0][b:b + 8], got["2d"][1][b:b + 8]), (d, i))


def test_probe_shard_health_is_indexed_by_the_coordinate_along_the_axis():
    from raft_tpu_torch.robust import faults
    from raft_tpu_torch.robust.degrade import probe_shard_health

    with faults.injected("sharded_ann.shard_scan", error=ShardFailure("down", shard=1),
                         match={"shard": 1}):
        assert probe_shard_health(port_mesh(), "cols") == (True, False, True, True)
        assert probe_shard_health(port_mesh(), "rows") == (True, False)
