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
values within rtol 1e-5. The entry points not yet ported to such meshes
raise ``LogicError`` naming them.
"""
import contextlib
import io
import types

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
from raft_tpu.parallel.sharded_ann import sharded_ivf_flat_search as j_sharded_flat
from raft_tpu.parallel.sharded_ann import sharded_ivf_pq_lists_search as j_sharded_pq
from raft_tpu.parallel.sharded_knn import sharded_knn as j_sharded_knn
from raft_tpu_torch import obs
from raft_tpu_torch.core.errors import LogicError
from raft_tpu_torch.neighbors import ivf_flat as tflat
from raft_tpu_torch.neighbors import ivf_pq as tpq
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


ENTRY_POINTS = {
    "sharded_ivf_pq_search": lambda m: sharded_ivf_pq_search(m, None, None, 1),
    "sharded_cagra_search": lambda m: sharded_cagra_search(m, None, None, 1),
    "sharded_ivf_pq_build": lambda m: sharded_ivf_pq_build(m, None),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
@pytest.mark.parametrize("kind", ["two_axes", "process"])
def test_entry_points_not_yet_ported_raise_and_name_themselves(name, kind):
    mesh = (port_mesh() if kind == "two_axes" else
            types.SimpleNamespace(is_process=True, axis_names=("data",)))
    with pytest.raises(LogicError, match=name):
        ENTRY_POINTS[name](mesh)


def test_the_engine_refuses_a_sharded_registration_on_a_mesh_of_two_axes(indexes):
    from raft_tpu_torch.core.resources import Resources
    from raft_tpu_torch.serve import ServingEngine

    eng = ServingEngine(res=Resources(device="cpu"))
    with pytest.raises(LogicError, match="sharded_ivf_flat"):
        eng.register("x", "sharded_ivf_flat", indexes["flat"][1], mesh=port_mesh(), axis="cols")
