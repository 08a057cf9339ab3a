"""The comms verbs the port added to its single-controller mesh
(``gather``, ``gatherv``, ``scatter``, ``device_sendrecv``,
``multicast_sendrecv``, ``comm_rank``, ``comm_split``, ``init_comms``)
against raft_tpu's verbs inside ``shard_map``.

Each verb runs rank by rank on the same numpy blocks: JAX on the first n of
its 8 virtual CPU devices, the port on ``make_mesh(["cpu"] * n)``, for n = 1,
2, 3 and 8, with roots other than 0 and ranks that receive nothing. The
outputs are moved bytes, so each rank's output must be equal, bit for bit.
The ``comms.{verb}.calls`` and ``.bytes`` counters of one call must equal
JAX's (JAX counts while it traces, once for the fresh program of each call
here).
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from raft_tpu import obs as jobs
from raft_tpu.parallel import comms as jcomms
from raft_tpu.parallel import make_mesh as jmake_mesh
from raft_tpu.parallel._compat import shard_map
from raft_tpu_torch import obs
from raft_tpu_torch.core.errors import LogicError
from raft_tpu_torch.core.resources import Resources
from raft_tpu_torch.parallel import comms, make_mesh

SIZES = (1, 2, 3, 8)
ROOT = {1: 0, 2: 1, 3: 2, 8: 5}
PAIRS = {1: [], 2: [(0, 1)], 3: [(0, 2)], 8: [(0, 5), (2, 3)]}
MULTI = {1: [(0, 0)], 2: [(1, 0)], 3: [(2, 0), (2, 1)], 8: [(3, 0), (3, 5), (6, 7), (1, 1)]}


def blocks(n, shape=(3, 2), seed=0):
    """Per-rank blocks ``[n, *shape]`` f32, distinct on every rank."""
    rng = np.random.default_rng([n, seed])
    return rng.standard_normal((n,) + shape).astype(np.float32)


def jax_ranks(n, fn, *stacks):
    """``fn`` on each rank of a JAX mesh of ``n`` devices, rank r given
    ``stack[r]`` of each input; returns the per-rank outputs stacked on a
    leading rank axis (a tuple when ``fn`` returns one)."""
    mesh = jmake_mesh(jax.devices()[:n])

    def body(*xs):
        out = fn(*[x[0] for x in xs])
        return jax.tree_util.tree_map(lambda o: o[None], out)

    f = jax.jit(shard_map(body, mesh=mesh, in_specs=tuple(P("data") for _ in stacks),
                          out_specs=P("data"), check_vma=False))
    return jax.tree_util.tree_map(np.asarray, f(*[jnp.asarray(s) for s in stacks]))


def port_ranks(n, stack):
    return make_mesh(["cpu"] * n), [torch.from_numpy(stack[r].copy()) for r in range(n)]


def assert_ranks_equal(got, want):
    assert len(got) == want.shape[0]
    for r, g in enumerate(got):
        np.testing.assert_array_equal(g.numpy(), want[r])


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


@pytest.mark.parametrize("n", SIZES)
def test_gather_matches_jax(n):
    x = blocks(n)
    want = jax_ranks(n, lambda b: jcomms.gather(b, root=ROOT[n]), x)
    mesh, xs = port_ranks(n, x)
    assert_ranks_equal(comms.gather(mesh, xs, root=ROOT[n]), want)


@pytest.mark.parametrize("n", SIZES)
def test_gatherv_matches_jax(n):
    x = blocks(n, (4, 2), seed=1)
    valid = np.arange(n, dtype=np.int32) % 5
    want = jax_ranks(n, lambda b, v: jcomms.gatherv(b, v[0], root=ROOT[n]), x, valid[:, None])
    mesh, xs = port_ranks(n, x)
    got = comms.gatherv(mesh, xs, [int(v) for v in valid], root=ROOT[n])
    assert_ranks_equal([b for b, _ in got], want[0])
    assert_ranks_equal([s for _, s in got], want[1])
    assert got[ROOT[n]][1].dtype == torch.int32


@pytest.mark.parametrize("n", SIZES)
def test_scatter_matches_jax(n):
    x = blocks(n, (n, 3), seed=2)  # every rank passes an [n, 3] buffer
    want = jax_ranks(n, lambda b: jcomms.scatter(b, root=ROOT[n]), x)
    mesh, xs = port_ranks(n, x)
    got = comms.scatter(mesh, xs, root=ROOT[n])
    assert_ranks_equal(got, want)
    for r in range(n):  # rank r gets the root's block r
        np.testing.assert_array_equal(got[r].numpy(), x[ROOT[n]][r])


@pytest.mark.parametrize("n", SIZES)
def test_device_sendrecv_matches_jax(n):
    x = blocks(n, seed=3)
    want = jax_ranks(n, lambda b: jcomms.device_sendrecv(b, PAIRS[n]), x)
    mesh, xs = port_ranks(n, x)
    got = comms.device_sendrecv(mesh, xs, PAIRS[n])
    assert_ranks_equal(got, want)
    named = {r for p in PAIRS[n] for r in p}
    for r in set(range(n)) - named:  # a rank in no pair receives zeros
        assert not bool(got[r].any())


@pytest.mark.parametrize("n", SIZES)
def test_multicast_sendrecv_matches_jax(n):
    x = blocks(n, seed=4)
    want = jax_ranks(n, lambda b: jcomms.multicast_sendrecv(b, MULTI[n]), x)
    mesh, xs = port_ranks(n, x)
    got = comms.multicast_sendrecv(mesh, xs, MULTI[n])
    assert_ranks_equal(got, want)
    for s, d in MULTI[n]:
        np.testing.assert_array_equal(got[d].numpy(), x[s])


@pytest.mark.parametrize("n", SIZES)
def test_comm_rank_matches_jax(n):
    want = jax_ranks(n, lambda b: jcomms.comm_rank("data") + 0 * b[0, 0].astype(jnp.int32),
                     blocks(n))
    got = comms.comm_rank(make_mesh(["cpu"] * n))
    assert [int(g) for g in got] == want.tolist() == list(range(n))
    assert all(g.dtype == torch.int32 and g.ndim == 0 for g in got)


@pytest.mark.parametrize("n", [2, 3, 8])
def test_counters_match_jax(n):
    """One call of each verb with obs on: the same ``comms.*`` counters,
    calls and wire-model bytes, as JAX (``scatter`` counts its inner
    ``bcast`` too, in both)."""
    x, sq = blocks(n, seed=5), blocks(n, (n, 3), seed=6)
    valid = np.ones((n, 1), np.int32)
    cases = [
        ("gather", lambda b: jcomms.gather(b, root=ROOT[n]),
         lambda m, xs: comms.gather(m, xs, root=ROOT[n]), x),
        ("gatherv", lambda b, v: jcomms.gatherv(b, v[0], root=ROOT[n]),
         lambda m, xs: comms.gatherv(m, xs, [1] * n, root=ROOT[n]), x),
        ("scatter", lambda b: jcomms.scatter(b, root=ROOT[n]),
         lambda m, xs: comms.scatter(m, xs, root=ROOT[n]), sq),
        ("device_sendrecv", lambda b: jcomms.device_sendrecv(b, PAIRS[n]),
         lambda m, xs: comms.device_sendrecv(m, xs, PAIRS[n]), x),
        ("multicast_sendrecv", lambda b: jcomms.multicast_sendrecv(b, MULTI[n]),
         lambda m, xs: comms.multicast_sendrecv(m, xs, MULTI[n]), x),
    ]
    for verb, jfn, tfn, stack in cases:
        with counting(jobs) as jc:
            jax_ranks(n, jfn, *((stack, valid) if verb == "gatherv" else (stack,)))
        with counting(obs) as tc:
            tfn(*port_ranks(n, stack))
        assert f'comms.{verb}.calls{{axis="data"}}' in tc, verb
        assert tc == jc, (verb, tc, jc)


def test_init_comms_and_comm_split():
    res = Resources(device="cpu")
    with pytest.raises(LogicError, match="no mesh"):
        res.get_mesh()
    mesh = comms.init_comms(res, devices=["cpu"] * 3)
    assert res.get_mesh() is mesh and mesh.size == 3 and mesh.axis_names == ("data",)
    jmesh = jmake_mesh(jax.devices()[:3])
    assert comms.comm_split(mesh, "data") == jcomms.comm_split(jmesh, "data") == {
        "axis": "data", "size": 3}
    other = comms.init_comms(Resources(device="cpu"), devices=["cpu"] * 2, axis_names=("model",))
    assert comms.comm_split(other, "model") == {"axis": "model", "size": 2}
    with pytest.raises(LogicError, match="not in mesh axes"):
        comms.comm_split(mesh, "model")
    with pytest.raises(Exception, match="not in mesh axes"):
        jcomms.comm_split(jmesh, "model")
    with pytest.raises(LogicError, match="one-axis"):
        comms.init_comms(res, devices=["cpu"] * 2, axis_names=("a", "b"))
