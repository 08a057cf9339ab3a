"""The distributed IVF-PQ build of the port against raft_tpu's.

2,048 rows of 16 dimensions (numpy seed), 4 shards: JAX on 4 of the 8
virtual CPU devices inside ``shard_map``, the port on ``make_mesh(["cpu"] *
4)`` with per-shard tensor lists. Both packages are fed the same inputs
(the initial centers, the rotation, JAX's own random draws for the whole
build).

Tolerances: centers and codebooks allclose(rtol=1e-5, atol=1e-5) (JAX sums
in f32 in its own order, the port sums exactly in fixed point and rounds
once); codes equal on >= 0.99 of the rows (a near tie between two codes can
round either way); recall@5 of the port's distributed build within 0.05 of
the port's single-device build (JAX's margin,
``tests/test_sharded_ann.py:376-401``). Inside the port the CA exchange at
full cap is ``torch.equal`` to the full exchange, iteration by iteration.
"""
import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from raft_tpu import obs as jobs
from raft_tpu.cluster.kmeans import flash_norm_cache as j_flash_norm_cache
from raft_tpu.neighbors import ivf_pq as jpq
from raft_tpu.parallel import make_mesh as jmake_mesh
from raft_tpu.parallel import sharded_ann as jsa
from raft_tpu.parallel._compat import shard_map
from raft_tpu.random.rng import as_key
from raft_tpu_torch import obs
from raft_tpu_torch.cluster.kmeans import flash_norm_cache
from raft_tpu_torch.core.errors import LogicError
from raft_tpu_torch.core.resources import Resources
from raft_tpu_torch.neighbors import brute_force as tbf
from raft_tpu_torch.neighbors import ivf_pq as tpq
from raft_tpu_torch.ops.distance import DistanceType
from raft_tpu_torch.parallel import comms, make_mesh
from raft_tpu_torch.parallel import sharded_ann as tsa
from raft_tpu_torch.stats.recall import neighborhood_recall

N, D, N_LISTS, PQ_DIM, ITERS, NQ, K = 2048, 16, 32, 8, 5, 64, 5
SHARDS = 4
CPU = Resources(device="cpu")
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(21)
    centers = rng.normal(size=(48, D)).astype(np.float32) * 4
    x = (centers[rng.integers(0, 48, N)] + rng.normal(size=(N, D))).astype(np.float32)
    q = (centers[rng.integers(0, 48, NQ)] + rng.normal(size=(NQ, D))).astype(np.float32)
    return x, q


@pytest.fixture(scope="module")
def jmesh(eight_devices):
    return jmake_mesh(eight_devices[:SHARDS])


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(["cpu"] * SHARDS)


@contextlib.contextmanager
def counting(mod):
    """Obs on for the block, the registry's counters in the yielded dict."""
    reg = mod.registry()
    reg.reset()
    mod.enable()
    out = {}
    try:
        yield out
        out.update(reg.as_dict()["counters"])
    finally:
        mod.disable()
        reg.reset()


def shards_of(x):
    return list(torch.from_numpy(x).chunk(SHARDS))


# -- one Lloyd step at a time ---------------------------------------------------------


def j_lloyd(jmesh, x, init, iters, **kw):
    """JAX's centers after each of ``iters`` steps, ``[iters, n_lists, d]``."""
    ca = kw.get("comm_mode") == "ca"

    @functools.partial(shard_map, mesh=jmesh, in_specs=(P(), P("data")), out_specs=P(),
                       check_vma=False)
    def run(c0, xl):
        cache = j_flash_norm_cache(xl, DistanceType.L2Expanded)
        c, carry, outs = c0, None, []
        for _ in range(iters):
            if ca:
                c, _, carry = jsa.dist_lloyd_step(c, xl, N_LISTS, "data", cache=cache,
                                                  carry=carry, **kw)
            else:
                c, _ = jsa.dist_lloyd_step(c, xl, N_LISTS, "data", cache=cache, **kw)
            outs.append(c)
        return jnp.stack(outs)

    return np.asarray(jax.jit(run)(jnp.asarray(init), jnp.asarray(x)))


def t_lloyd(mesh, x, init, iters, **kw):
    """The port's centers after each step (every shard's replica equal)."""
    ca = kw.get("comm_mode") == "ca"
    xs = shards_of(x)
    caches = [flash_norm_cache(xl) for xl in xs]
    c, carry, outs = comms.replicated(mesh, torch.from_numpy(init)), None, []
    for _ in range(iters):
        if ca:
            c, _, carry = tsa.dist_lloyd_step(mesh, c, xs, N_LISTS, caches=caches, carry=carry,
                                              **kw)
        else:
            c, _ = tsa.dist_lloyd_step(mesh, c, xs, N_LISTS, caches=caches, **kw)
        assert all(torch.equal(c[0], cr) for cr in c[1:])
        outs.append(c[0])
    return torch.stack(outs)


LLOYD_CASES = {"fused": dict(), "unfused": dict(fuse_comms=False),
               "ca": dict(comm_mode="ca"), "ca_full_cap": dict(comm_mode="ca", ca_cap=N_LISTS)}


@pytest.mark.parametrize("case", list(LLOYD_CASES))
def test_dist_lloyd_step_matches_jax(data, jmesh, mesh, case):
    x, _ = data
    init = x[:N_LISTS]
    want = j_lloyd(jmesh, x, init, ITERS, **LLOYD_CASES[case])
    got = t_lloyd(mesh, x, init, ITERS, **LLOYD_CASES[case])
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_ca_lloyd_at_full_cap_is_the_full_trajectory(data, mesh):
    x, _ = data
    init = x[:N_LISTS]
    full = t_lloyd(mesh, x, init, ITERS)
    assert torch.equal(full, t_lloyd(mesh, x, init, ITERS, comm_mode="ca", ca_cap=N_LISTS))
    assert torch.equal(full, t_lloyd(mesh, x, init, ITERS, fuse_comms=False))


# -- one codebook step at a time ------------------------------------------------------


def residuals(x, ksub, seed=5):
    """Rotated residuals ``[n, PQ_DIM, pq_len]`` and seed books drawn from
    them."""
    rng = np.random.default_rng(seed)
    resid = (x - x.mean(axis=0)).reshape(N, PQ_DIM, -1)
    books = resid[rng.choice(N, ksub, replace=False)].transpose(1, 0, 2).copy()
    return resid, books


def j_books(jmesh, resid, books, ksub, iters, **kw):
    ca = kw.get("comm_mode") == "ca"

    @functools.partial(shard_map, mesh=jmesh, in_specs=(P(), P("data")), out_specs=P(),
                       check_vma=False)
    def run(b0, rl):
        b, carry, outs = b0, None, []
        for _ in range(iters):
            if ca:
                b, carry = jsa.dist_codebook_step(b, rl, ksub, "data", carry=carry, **kw)
            else:
                b = jsa.dist_codebook_step(b, rl, ksub, "data", **kw)
            outs.append(b)
        return jnp.stack(outs)

    return np.asarray(jax.jit(run)(jnp.asarray(books), jnp.asarray(resid)))


def t_books(mesh, resid, books, ksub, iters, **kw):
    ca = kw.get("comm_mode") == "ca"
    rs = shards_of(resid)
    b, carry, outs = comms.replicated(mesh, torch.from_numpy(books)), None, []
    for _ in range(iters):
        if ca:
            b, carry = tsa.dist_codebook_step(mesh, b, rs, ksub, carry=carry, **kw)
        else:
            b = tsa.dist_codebook_step(mesh, b, rs, ksub, **kw)
        outs.append(b[0])
    return torch.stack(outs)


@pytest.mark.parametrize("case", list(LLOYD_CASES))
def test_dist_codebook_step_matches_jax(data, jmesh, mesh, case):
    kw = dict(LLOYD_CASES[case])
    if "ca_cap" in kw:
        kw["ca_cap"] = PQ_DIM * 16
    resid, books = residuals(data[0], 16)
    want = j_books(jmesh, resid, books, 16, 4, **kw)
    got = t_books(mesh, resid, books, 16, 4, **kw)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_codebook_step_blocks_and_ca_full_cap(data, mesh, monkeypatch):
    """Row blocks of the assignment (here 7 rows) change nothing, and the CA
    exchange at full cap is the full trajectory bit for bit."""
    resid, books = residuals(data[0], 16)
    full = t_books(mesh, resid, books, 16, 4)
    assert torch.equal(full, t_books(mesh, resid, books, 16, 4, comm_mode="ca",
                                     ca_cap=PQ_DIM * 16))
    monkeypatch.setattr(tsa, "CODEBOOK_BLOCK_BYTES", 7 * 8 * PQ_DIM * 16)
    assert torch.equal(full, t_books(mesh, resid, books, 16, 4))


# -- the whole build ------------------------------------------------------------------


def jax_draws(x, params):
    """The JAX build's own draws: initial centers and the rotation."""
    k_init, k_rot = jax.random.split(as_key(params.seed))
    init = np.asarray(jnp.asarray(x)[jax.random.permutation(k_init, N)[:params.n_lists]])
    pq_dim = params.pq_dim
    rot_dim = -(-D // pq_dim) * pq_dim
    rotation = np.asarray(jpq._make_rotation(k_rot, rot_dim, D, params.force_random_rotation))
    return init, rotation


def jparams(**kw):
    return jpq.IvfPqIndexParams(n_lists=N_LISTS, pq_dim=PQ_DIM, kmeans_n_iters=ITERS, seed=2,
                                **kw)


def tparams(**kw):
    return tpq.IvfPqIndexParams(n_lists=N_LISTS, pq_dim=PQ_DIM, kmeans_n_iters=ITERS, seed=2,
                                **kw)


@pytest.fixture(scope="module")
def builds(data, jmesh, mesh):
    """mode -> (JAX index, JAX build counters, the port's index on JAX's
    draws, the port's build counters)."""
    x, _ = data
    out = {}
    for mode in ("full", "ca"):
        with counting(jobs) as jc:
            ji = jsa.sharded_ivf_pq_build(jmesh, x, jparams(), comm_mode=mode)
        init, rotation = jax_draws(x, jparams())
        with counting(obs) as tc:
            ti = tsa._sharded_ivf_pq_build_from(mesh, x, tparams(), init, rotation, comm_mode=mode)
        out[mode] = (ji, jc, ti, tc)
    return out


@pytest.mark.parametrize("mode", ["full", "ca"])
def test_build_on_jax_draws_matches_jax(builds, mode):
    ji, _, ti, _ = builds[mode]
    np.testing.assert_allclose(ti.centers.numpy(), np.asarray(ji.centers), **TOL)
    np.testing.assert_allclose(ti.pq_centers.numpy(), np.asarray(ji.pq_centers), **TOL)
    np.testing.assert_allclose(ti.rotation.numpy(), np.asarray(ji.rotation))
    assert ti.max_list == ji.max_list and ti.pq_bits == ji.pq_bits
    assert (ti.codebook_kind, ti.packed, ti.center_rank) == (ji.codebook_kind, False, None)
    np.testing.assert_array_equal(ti.list_indices.numpy(), np.asarray(ji.list_indices))
    np.testing.assert_array_equal(ti.list_sizes.numpy(), np.asarray(ji.list_sizes))
    filled = ti.list_indices.numpy() >= 0
    same = (ti.codes.numpy() == np.asarray(ji.codes)).all(axis=-1)[filled]
    assert same.mean() >= 0.99, same.mean()


@pytest.mark.parametrize("mode", ["full", "ca"])
def test_build_counters_match_jax(builds, mode):
    """``comms.build.{launches,bytes}`` by phase and the ``comms.*`` verb
    counters equal JAX's (JAX traces the build's program once a build, the
    port counts once a call: the same counts)."""
    _, jc, _, tc = builds[mode]
    keys = {k for k in jc if k.startswith("comms.")}
    assert keys == {k for k in tc if k.startswith("comms.")}
    assert any(k.startswith("comms.build.bytes") for k in keys)
    for key in keys:
        assert tc[key] == pytest.approx(jc[key], rel=1e-12), key
    if mode == "ca":
        assert tc['comms.build.launches{phase="kmeans_full"}'] == 2.0
        assert tc['comms.build.launches{phase="seed"}'] == 1.0


@pytest.mark.parametrize("n_shards,rows", [(1, None), (2, None), (4, 32), (8, None)])
def test_resolve_comm_mode_matches_jax(monkeypatch, n_shards, rows):
    for gate in ("1", "0"):
        monkeypatch.setenv("RAFT_TPU_PLAN", gate)
        for mode in tsa._COMM_MODES:
            kw = dict(n_rows=rows, d=16 if rows else None)
            assert tsa._resolve_comm_mode(mode, n_shards, **kw) == jsa._resolve_comm_mode(
                mode, n_shards, **kw)
    with pytest.raises(LogicError, match="comm_mode"):
        tsa._resolve_comm_mode("tree", 2)


def test_build_recall_within_margin_of_single_device(data, mesh):
    """The port's own draws: each mode's distributed build within 0.05 of
    the single-device ``ivf_pq.build(pq_kind="kmeans")`` recall@5 (dense
    scan, 16 probes); two builds from one seed are equal."""
    x, q = data
    _, gt = tbf.knn(x, q, K, metric="sqeuclidean", res=CPU)
    p = tpq.IvfPqSearchParams(n_probes=16, refine_ratio=1)

    def rec(index):
        return neighborhood_recall(tpq.search(index, torch.from_numpy(q), K, p, mode="scan")[1],
                                   gt)

    single = rec(tpq.build(x, tparams(pq_kind="kmeans"), res=CPU))
    for mode in ("full", "ca"):
        built = tsa.sharded_ivf_pq_build(mesh, x, tparams(), comm_mode=mode)
        assert rec(built) >= single - 0.05, (mode, rec(built), single)
    again = tsa.sharded_ivf_pq_build(mesh, x, tparams(), comm_mode="ca")
    for name in ("centers", "rotation", "pq_centers", "codes", "list_indices", "rot_sqnorms"):
        assert torch.equal(getattr(built, name), getattr(again, name)), name


def test_build_checks(data, mesh):
    x, _ = data
    with pytest.raises(LogicError, match="not divisible"):
        tsa.sharded_ivf_pq_build(make_mesh(["cpu"] * 3), x[:1000], tparams())
    with pytest.raises(LogicError, match="ca_cap"):
        tsa.sharded_ivf_pq_build(mesh, x, tparams(), comm_mode="ca", ca_cap=N_LISTS + 1)
