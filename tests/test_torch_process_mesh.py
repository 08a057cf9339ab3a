"""Process meshes: the port's comms verbs and sharded searches across
worlds of 2 and 4 gloo processes, against its single-controller mesh and
against raft_tpu.

A module fixture spawns both worlds at once: one ``python -c`` child a
process (it imports only ``torch`` and ``raft_tpu_torch``), a ``file://``
store in a temporary directory, every join bounded (the children are
killed past :data:`JOIN_S`). Each child bootstraps with
``bootstrap.init_distributed(backend="gloo")``, holds one CPU shard of
``global_mesh()`` and runs once: the comms self test, every verb (with obs
on, so its own counters are kept), every verb along each axis of a
``2 x 2`` process mesh (in the world of 2 each process holds a row of two
shards, so one axis stays inside a process), and the three lists-sharded
searches under ``ring``, ``fused_ring`` and ``gather``, healthy and with
shard 1 demoted, on small indexes the parent built with raft_tpu and saved
through the port's serializer. Each rank writes an ``.npz``.

The bar: every verb on every rank equals the single-controller verb on
``make_mesh(["cpu"] * n)`` (or the ``2 x 2`` mesh) bit for bit, and raft_tpu's
verb inside ``shard_map``; each search equals the single-controller
port's bit for bit on every rank, with ids equal to raft_tpu's sharded
search and values within rtol 1e-5.
"""
import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from raft_tpu.neighbors import ivf_flat as jflat
from raft_tpu.neighbors import ivf_pq as jpq
from raft_tpu.parallel import comms as jcomms
from raft_tpu.parallel import make_mesh as jmake_mesh
from raft_tpu.parallel._compat import shard_map
from raft_tpu.parallel.sharded_ann import sharded_ivf_flat_search as j_sharded_flat
from raft_tpu.parallel.sharded_ann import sharded_ivf_pq_lists_search as j_sharded_pq
from raft_tpu.parallel.sharded_knn import sharded_knn as j_sharded_knn
from raft_tpu_torch.neighbors import ivf_flat as tflat
from raft_tpu_torch.neighbors import ivf_pq as tpq
from raft_tpu_torch.parallel import comms, make_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLDS = (2, 4)
JOIN_S = 150
N, D, N_LISTS, NQ, K, N_PROBES = 2048, 16, 16, 24, 8, 4

#: shared by the children and the parent: the inputs and the verb cases
LIB = r'''
import numpy as np
import torch

MODES = ("ring", "fused_ring", "gather")
SEED = 19
#: the host schedule's cases: k, and tiles narrower, as wide and wider (B7)
RING_K = 10
RING_KC = (6, 10, 23)


def block(rank, shape=(4, 3), seed=SEED):
    """Global rank ``rank``'s input block (f32, distinct on every rank)."""
    return np.random.default_rng([seed, rank]).standard_normal(shape).astype(np.float32)


def verb_cases(comms, mesh, axis=None):
    """Every verb along ``axis`` on the local shards' blocks: ``{case:
    [one numpy array a local shard]}``."""
    n = comms.comm_size(mesh, axis)
    ranks = mesh.local_ranks
    ax = dict(axis=axis)
    xs = [torch.from_numpy(block(r)) for r in ranks]
    xi = [torch.from_numpy((block(r, (2, 5), SEED + 2) * 100).astype(np.int32)) for r in ranks]
    sc = [torch.from_numpy(block(r, (n, 2, 3), SEED + 1)) for r in ranks]
    out = {}
    for op in ("sum", "max", "min", "prod"):
        out["allreduce_" + op] = comms.allreduce(mesh, xs, op=op, **ax)
    out["allgather"] = comms.allgather(mesh, xs, **ax)
    out["allgather_tiled"] = comms.allgather(mesh, xs, tiled=True, **ax)
    out["allgather_int32"] = comms.allgather(mesh, xi, **ax)
    out["reducescatter"] = comms.reducescatter(mesh, xs, **ax)
    out["bcast"] = comms.bcast(mesh, xs, root=n - 1, **ax)
    out["reduce"] = comms.reduce(mesh, xs, root=n - 1, **ax)
    out["ppermute"] = comms.ppermute(mesh, xs, [(i, (i + 1) % n) for i in range(n)], **ax)
    out["send_recv"] = comms.send_recv(mesh, xs, 0, n - 1, **ax)
    out["barrier"] = comms.barrier(mesh, **ax)
    out["gather"] = comms.gather(mesh, xs, root=n - 1, **ax)
    gv = comms.gatherv(mesh, xs, [1 + r % 3 for r in ranks], root=0, **ax)
    out["gatherv_blocks"] = [b for b, _ in gv]
    out["gatherv_sizes"] = [s for _, s in gv]
    out["scatter"] = comms.scatter(mesh, sc, root=n - 1, **ax)
    out["device_sendrecv"] = comms.device_sendrecv(mesh, xs, [(0, n - 1)], **ax)
    out["multicast_sendrecv"] = comms.multicast_sendrecv(mesh, xs, [(n - 1, 0), (n - 1, n // 2)],
                                                         **ax)
    out["comm_rank"] = comms.comm_rank(mesh, **ax)
    out["raw_allgather"] = comms._allgather(mesh, xs, **ax)
    out["raw_ppermute"] = comms._ppermute(mesh, xs, [(n - 1, 0)], **ax)
    return {name: [t.numpy() for t in ts] for name, ts in out.items()}


def search_cases(mesh, flat, pq, data, queries, spec, axis="data"):
    """The three lists-sharded searches under every merge mode, healthy and
    (the IVF ones) with shard 1 demoted: ``{case: (dist, ids)}``."""
    from raft_tpu_torch.parallel import (sharded_ivf_flat_search, sharded_ivf_pq_lists_search,
                                         sharded_knn)

    n = mesh.shape[axis]
    k, n_probes = spec["k"], spec["n_probes"]
    demoted = [r != 1 for r in range(n)]
    out = {}
    for mode in MODES:
        for tag, health in (("healthy", None), ("demoted", demoted)):
            out[f"flat_{tag}_{mode}"] = sharded_ivf_flat_search(
                mesh, flat, queries, k, n_probes=n_probes, axis=axis, health=health,
                merge_mode=mode)
            out[f"pq_{tag}_{mode}"] = sharded_ivf_pq_lists_search(
                mesh, pq, queries, k, n_probes=n_probes, axis=axis, health=health,
                merge_mode=mode)
        out[f"knn_healthy_{mode}"] = sharded_knn(mesh, data, queries, k, metric="sqeuclidean",
                                                 axis=axis, merge_mode=mode)
    return {name: (d.numpy(), i.numpy()) for name, (d, i) in out.items()}


def ring_parts(rank, kc, nq=11, seed=SEED + 5):
    """Global rank ``rank``'s ``[nq, kc]`` ring candidates (ids global;
    rank 1 demoted: every value the worst, every id -1)."""
    rng = np.random.default_rng([seed, rank, kc])
    v = rng.standard_normal((nq, kc)).astype(np.float32)
    i = (rank * 1000 + np.arange(nq * kc).reshape(nq, kc)).astype(np.int32)
    if rank == 1:
        v[:], i[:] = np.inf, -1
    return torch.from_numpy(v), torch.from_numpy(i)


def host_schedule(mesh, vs, is_, k, select_min=True):
    """``ring_topk``'s host schedule (``_run_ring``: the engines
    ``"schedule"`` and ``"process"``) on CPU shards, its two kernels
    replaced by their plain versions (``ring_stage``: ``_prep``'s layout,
    B7's scan fold for wider tiles; ``ring_fold``: ``hop_merge_reference``)
    and its streams and events by no-ops. Returns ``(vals, ids)``, one
    tensor a local shard."""
    import contextlib

    from raft_tpu_torch.ops import ring_topk as trt

    class Event:
        def record(self, *a):
            pass

    class Stream:
        def wait_event(self, ev):
            pass

    def stage(lib, v, i, rank, n, B, w, select_min):
        _, pos, val, ids, _ = trt._prep(v, i, w, select_min, rank, n, scan_fold=v.shape[1] > w)
        lanes = (pos, val.view(torch.int32), ids)
        return torch.stack([x.reshape(n, B, w) for x in lanes], dim=1).contiguous()

    def fold(lib, dst, got, key_sign):
        def lanes(t):
            val = t[1].view(torch.float32)
            return (val * key_sign, t[0], val, t[2])

        _, pos, val, ids = trt.hop_merge_reference(lanes(dst), lanes(got))
        dst.copy_(torch.stack([pos, val.view(torch.int32), ids]))

    saved = (trt._stage, trt._fold_block, trt.build_kernel, torch.cuda.Event, mesh.streams)
    trt._stage, trt._fold_block = stage, fold
    trt.build_kernel = lambda *a: (None, 0.0, "")
    torch.cuda.Event = Event
    mesh.streams = tuple(Stream() for _ in mesh.devices)
    mesh.on = lambda j: contextlib.nullcontext()
    mesh.fork = lambda: None
    try:
        (vals, ids), _ = trt._run_ring(mesh, vs, is_, k, select_min)
    finally:
        trt._stage, trt._fold_block, trt.build_kernel, torch.cuda.Event, mesh.streams = saved
        del mesh.on, mesh.fork
    return vals, ids
'''

CHILD = r'''
import json
import sys

import numpy as np
import torch

torch.set_num_threads(1)
from raft_tpu_torch import obs
from raft_tpu_torch.neighbors import ivf_flat, ivf_pq
from raft_tpu_torch.parallel import bootstrap, comms

rank, world, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
spec = json.load(open(f"{work}/spec.json"))
assert bootstrap.init_distributed(f"file://{work}/store{world}", world, rank, backend="gloo",
                                  timeout_s=60)
assert bootstrap.init_distributed() is True
out = {}
mesh = bootstrap.global_mesh()
out["mesh"] = np.array([mesh.size, *mesh.local_ranks])
out["self_test"] = np.array(bootstrap.run_comms_self_test(mesh))
reg = obs.registry()
reg.reset()
obs.enable()
cases = verb_cases(comms, mesh)
obs.disable()
counters = {k: v for k, v in reg.as_dict()["counters"].items() if k.startswith("comms.")}
out["counters"] = np.array(json.dumps(counters, sort_keys=True))
for name, per in cases.items():
    for r, a in zip(mesh.local_ranks, per):
        out[f"1d/{name}/{r}"] = a
mesh2 = bootstrap.global_mesh(("x", "y"), shape=(2, 2), devices=["cpu"] * (4 // world))
for axis in ("x", "y"):
    for name, per in verb_cases(comms, mesh2, axis).items():
        for r, a in zip(mesh2.local_ranks, per):
            out[f"2d_{axis}/{name}/{r}"] = a
flat = ivf_flat.load_path(f"{work}/flat.idx", device="cpu")
pq = ivf_pq.load_path(f"{work}/pq.idx", device="cpu")
data = torch.from_numpy(np.load(f"{work}/data.npy"))
queries = torch.from_numpy(np.load(f"{work}/queries.npy"))
for name, (d, i) in search_cases(mesh, flat, pq, data, queries, spec).items():
    out[f"search/{name}/d"], out[f"search/{name}/i"] = d, i
from raft_tpu_torch.parallel import sharded_ivf_flat_search

for axis in ("x", "y"):
    for mode in ("ring", "gather"):
        d, i = sharded_ivf_flat_search(mesh2, flat, queries, spec["k"], n_probes=spec["n_probes"],
                                       axis=axis, merge_mode=mode)
        out[f"search2d_{axis}/{mode}/d"], out[f"search2d_{axis}/{mode}/i"] = d.numpy(), i.numpy()
# the host schedule over the process backend: one shard a process, and two
# (ring hops inside a process and across processes)
mesh_two = bootstrap.global_mesh(devices=["cpu"] * 2)
for tag, m in (("one", mesh), ("two", mesh_two)):
    for kc in RING_KC:
        parts = [ring_parts(r, kc) for r in m.local_ranks]
        vals, ids = host_schedule(m, [v for v, _ in parts], [i for _, i in parts], RING_K)
        for r, v, i in zip(m.local_ranks, vals, ids):
            out[f"host/{tag}_{kc}/{r}/d"], out[f"host/{tag}_{kc}/{r}/i"] = v.numpy(), i.numpy()
np.savez(f"{work}/w{world}_rank{rank}.npz", **out)
bootstrap.shutdown()
'''

lib = {}
exec(LIB, lib)


def _spawn(world, work):
    """Start a world's children together; returns the processes."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    return [subprocess.Popen([sys.executable, "-c", LIB + CHILD, str(r), str(world), work],
                             cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for r in range(world)]


def _join(procs, deadline):
    """Wait for every child until ``deadline``; kill them all past it.
    Returns each child's exit code and output."""
    out = []
    try:
        for p in procs:
            text, _ = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            out.append((p.returncode, text.decode(errors="replace")))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(61)
    centers = rng.normal(size=(24, D)).astype(np.float32) * 3
    x = (centers[rng.integers(0, 24, N)] + rng.normal(size=(N, D))).astype(np.float32)
    q = (centers[rng.integers(0, 24, NQ)] + rng.normal(size=(NQ, D))).astype(np.float32)
    return x, q


@pytest.fixture(scope="module")
def indexes(corpus, tmp_path_factory):
    """raft_tpu's indexes, loaded into the port and saved through the
    port's serializer into the worlds' directory."""
    import io

    work = str(tmp_path_factory.mktemp("procs"))
    x, q = corpus
    jf = jflat.build(x, jflat.IvfFlatIndexParams(n_lists=N_LISTS))
    jp = jpq.build(x, jpq.IvfPqIndexParams(n_lists=N_LISTS, pq_dim=8, kmeans_n_iters=5))
    out = {"work": work, "jax": (jf, jp)}
    for name, jmod, tmod, ji in (("flat", jflat, tflat, jf), ("pq", jpq, tpq, jp)):
        buf = io.BytesIO()
        jmod.save(ji, buf)
        buf.seek(0)
        out[name] = tmod.load(buf, device="cpu")
        tmod.save_path(out[name], f"{work}/{name}.idx")
    np.save(f"{work}/data.npy", x)
    np.save(f"{work}/queries.npy", q)
    with open(f"{work}/spec.json", "w") as f:
        json.dump({"k": K, "n_probes": N_PROBES}, f)
    return out


@pytest.fixture(scope="module")
def worlds(indexes):
    """Both worlds, run once at the same time: ``{n: [rank's npz]}``."""
    work = indexes["work"]
    deadline = time.monotonic() + JOIN_S
    procs = {n: _spawn(n, work) for n in WORLDS}
    results = {n: _join(p, deadline) for n, p in procs.items()}
    for n, res in results.items():
        for r, (rc, text) in enumerate(res):
            assert rc == 0, f"world {n} rank {r} exited {rc}:\n{text[-4000:]}"
    return {n: [dict(np.load(f"{work}/w{n}_rank{r}.npz")) for r in range(n)] for n in WORLDS}


# -- the verbs ----------------------------------------------------------------------


def _single(n, shape=None, axis=None):
    """The verb cases on the single-controller CPU mesh, by global rank."""
    mesh = (make_mesh(["cpu"] * n) if shape is None else
            make_mesh(["cpu"] * n, shape=shape, axis_names=("x", "y")))
    return lib["verb_cases"](comms, mesh, axis)


VERBS = sorted(_single(2))


@pytest.mark.parametrize("n", WORLDS)
def test_every_rank_passes_the_self_test_on_its_process_mesh(worlds, n):
    for r, got in enumerate(worlds[n]):
        assert bool(got["self_test"]), r
        assert got["mesh"].tolist() == [n, r]


@pytest.mark.parametrize("verb", VERBS)
@pytest.mark.parametrize("n", WORLDS)
def test_each_verb_equals_the_single_controller_verb(worlds, n, verb):
    want = _single(n)[verb]
    for r, got in enumerate(worlds[n]):
        g = got[f"1d/{verb}/{r}"]
        assert g.dtype == want[r].dtype and g.shape == want[r].shape
        assert g.tobytes() == want[r].tobytes(), (verb, r)


@pytest.mark.parametrize("axis", ["x", "y"])
@pytest.mark.parametrize("n", WORLDS)
def test_verbs_along_each_axis_of_a_2x2_process_mesh(worlds, n, axis):
    want = _single(4, (2, 2), axis)
    held = 4 // n
    for p, got in enumerate(worlds[n]):
        for verb, per_rank in want.items():
            for r in range(p * held, (p + 1) * held):
                assert got[f"2d_{axis}/{verb}/{r}"].tobytes() == per_rank[r].tobytes(), (verb, r)


def _jax_cases(n):
    """raft_tpu's verbs inside ``shard_map`` on the same blocks, by rank."""
    mesh = jmake_mesh(jax.devices()[:n])
    x = np.stack([lib["block"](r) for r in range(n)])
    xi = np.stack([(lib["block"](r, (2, 5), lib["SEED"] + 2) * 100).astype(np.int32)
                   for r in range(n)])
    sc = np.stack([lib["block"](r, (n, 2, 3), lib["SEED"] + 1) for r in range(n)])
    valid = np.array([[1 + r % 3] for r in range(n)], np.int32)
    ring = [(i, (i + 1) % n) for i in range(n)]
    cases = {f"allreduce_{op}": (lambda b, op=op: jcomms.allreduce(b, op=op), x)
             for op in ("sum", "max", "min", "prod")}
    cases.update({
        "allgather": (lambda b: jcomms.allgather(b), x),
        "allgather_tiled": (lambda b: jcomms.allgather(b, tiled=True), x),
        "allgather_int32": (lambda b: jcomms.allgather(b), xi),
        "raw_allgather": (lambda b: jcomms.allgather(b), x),
        "reducescatter": (lambda b: jcomms.reducescatter(b), x),
        "bcast": (lambda b: jcomms.bcast(b, root=n - 1), x),
        "reduce": (lambda b: jcomms.reduce(b, root=n - 1), x),
        "ppermute": (lambda b: jcomms.ppermute(b, ring), x),
        "raw_ppermute": (lambda b: jcomms.ppermute(b, [(n - 1, 0)]), x),
        "send_recv": (lambda b: jcomms.send_recv(b, 0, n - 1), x),
        "barrier": (lambda b: jcomms.barrier(), x),
        "gather": (lambda b: jcomms.gather(b, root=n - 1), x),
        "scatter": (lambda b: jcomms.scatter(b, root=n - 1), sc),
        "device_sendrecv": (lambda b: jcomms.device_sendrecv(b, [(0, n - 1)]), x),
        "multicast_sendrecv": (
            lambda b: jcomms.multicast_sendrecv(b, [(n - 1, 0), (n - 1, n // 2)]), x),
        "comm_rank": (lambda b: jcomms.comm_rank(), x),
    })
    out = {}
    for name, (fn, stack) in cases.items():
        body = lambda b, fn=fn: jax.tree_util.tree_map(lambda o: o[None], fn(b[0]))  # noqa: E731
        f = jax.jit(shard_map(body, mesh=mesh, in_specs=(P("data"),), out_specs=P("data"),
                              check_vma=False))
        out[name] = np.asarray(f(jnp.asarray(stack)))
    gv = jax.jit(shard_map(lambda b, v: jax.tree_util.tree_map(
        lambda o: o[None], jcomms.gatherv(b[0], v[0, 0], root=0)), mesh=mesh,
        in_specs=(P("data"), P("data")), out_specs=P("data"), check_vma=False))
    out["gatherv_blocks"], out["gatherv_sizes"] = (np.asarray(a) for a in gv(jnp.asarray(x),
                                                                             jnp.asarray(valid)))
    return out


@pytest.mark.parametrize("n", WORLDS)
def test_each_verb_equals_raft_tpu_s_verb(worlds, n):
    want = _jax_cases(n)
    assert sorted(want) == VERBS
    for r, got in enumerate(worlds[n]):
        for verb, w in want.items():
            g = got[f"1d/{verb}/{r}"]
            np.testing.assert_array_equal(g, w[r].astype(g.dtype), err_msg=f"{verb} rank {r}")


@pytest.mark.parametrize("n", WORLDS)
def test_the_comms_counters_are_per_process(worlds, n):
    """Each process counts its own calls once, with the wire model at the
    axis size: the counters the single-controller mesh counts for the same
    calls (which, in one process, are every shard's)."""
    from raft_tpu_torch import obs

    reg = obs.registry()
    reg.reset()
    obs.enable()
    try:
        _single(n)
        want = {k: v for k, v in reg.as_dict()["counters"].items() if k.startswith("comms.")}
    finally:
        obs.disable()
        reg.reset()
    assert want['comms.allreduce.calls{axis="data"}'] == 5.0  # four ops and the reduce
    for r, got in enumerate(worlds[n]):
        assert json.loads(str(got["counters"])) == want, r


# -- the searches --------------------------------------------------------------------


SEARCHES = ([f"{s}_{t}_{m}" for s in ("flat", "pq") for t in ("healthy", "demoted")
             for m in lib["MODES"]] + [f"knn_healthy_{m}" for m in lib["MODES"]])


@pytest.fixture(scope="module")
def single_searches(indexes, corpus):
    x, q = corpus
    out = {}
    for n in WORLDS:
        out[n] = lib["search_cases"](make_mesh(["cpu"] * n), indexes["flat"], indexes["pq"],
                                     torch.from_numpy(x), torch.from_numpy(q),
                                     {"k": K, "n_probes": N_PROBES})
    return out


@pytest.mark.parametrize("case", SEARCHES)
@pytest.mark.parametrize("n", WORLDS)
def test_each_search_equals_the_single_controller_port_on_every_rank(worlds, single_searches, n,
                                                                     case):
    d, i = single_searches[n][case]
    for r, got in enumerate(worlds[n]):
        assert got[f"search/{case}/i"].tobytes() == i.tobytes(), r
        assert got[f"search/{case}/d"].tobytes() == d.tobytes(), r


@pytest.mark.parametrize("n", WORLDS)
def test_every_rank_holds_the_same_answer_under_every_merge_mode(worlds, n):
    base = worlds[n][0]
    for case in SEARCHES:
        kind, tag, _ = case.split("_", 2)
        ring = f"{kind}_{tag}_ring"
        for got in worlds[n]:
            for part in ("d", "i"):
                want = base[f"search/{ring}/{part}"]
                assert got[f"search/{case}/{part}"].tobytes() == want.tobytes()


@pytest.fixture(scope="module")
def jax_searches(indexes, corpus):
    x, q = corpus
    jf, jp = indexes["jax"]
    out = {}
    for n in WORLDS:
        jm = jmake_mesh(jax.devices()[:n])
        demoted = np.array([r != 1 for r in range(n)])
        for tag, health in (("healthy", None), ("demoted", demoted)):
            out[n, "flat", tag] = j_sharded_flat(jm, jf, q, K, n_probes=N_PROBES, health=health,
                                                 merge_mode="gather")
            out[n, "pq", tag] = j_sharded_pq(jm, jp, q, K, n_probes=N_PROBES, health=health,
                                             merge_mode="gather")
        out[n, "knn", "healthy"] = j_sharded_knn(jm, x, q, K, metric="sqeuclidean",
                                                 merge_mode="gather")
    return out


@pytest.mark.parametrize("case", SEARCHES)
@pytest.mark.parametrize("n", WORLDS)
def test_each_search_s_ids_equal_raft_tpu_s_sharded_search(worlds, jax_searches, n, case):
    kind, tag, _ = case.split("_", 2)
    jd, ji = (np.asarray(a) for a in jax_searches[n, kind, tag])
    for r, got in enumerate(worlds[n]):
        np.testing.assert_array_equal(got[f"search/{case}/i"], ji, err_msg=f"rank {r}")
        np.testing.assert_allclose(got[f"search/{case}/d"], jd, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("axis", ["x", "y"])
@pytest.mark.parametrize("n", WORLDS)
def test_ivf_flat_along_each_axis_of_a_2x2_process_mesh(worlds, indexes, corpus, n, axis):
    from raft_tpu_torch.parallel import sharded_ivf_flat_search

    mesh = make_mesh(["cpu"] * 4, shape=(2, 2), axis_names=("x", "y"))
    d, i = sharded_ivf_flat_search(mesh, indexes["flat"], torch.from_numpy(corpus[1]), K,
                                   n_probes=N_PROBES, axis=axis, merge_mode="gather")
    for r, got in enumerate(worlds[n]):
        for mode in ("ring", "gather"):
            assert got[f"search2d_{axis}/{mode}/i"].tobytes() == i.numpy().tobytes(), (r, mode)
            assert got[f"search2d_{axis}/{mode}/d"].tobytes() == d.numpy().tobytes(), (r, mode)


# -- the ring's host schedule --------------------------------------------------------


def _ring_want(size, kc):
    """The plain ring on the single-controller CPU mesh of ``size``
    shards: ``(vals, ids)`` by global rank."""
    from raft_tpu_torch.ops import ring_topk as trt

    parts = [lib["ring_parts"](r, kc) for r in range(size)]
    return trt.ring_topk_reference([v for v, _ in parts], [i for _, i in parts], lib["RING_K"],
                                   True, make_mesh(["cpu"] * size), scan_fold=kc > lib["RING_K"])


@pytest.mark.parametrize("kc", [6, 10, 23])
@pytest.mark.parametrize("n", [2, 3, 4])
def test_host_schedule_on_one_controller_equals_the_plain_ring(n, kc):
    """The host schedule over the single-controller mesh (its hops peer
    copies) gives the plain ring's bits on every shard."""
    mesh = make_mesh(["cpu"] * n)
    parts = [lib["ring_parts"](r, kc) for r in range(n)]
    vals, ids = lib["host_schedule"](mesh, [v for v, _ in parts], [i for _, i in parts],
                                     lib["RING_K"])
    want_v, want_i = _ring_want(n, kc)
    for r in range(n):
        assert vals[r].numpy().tobytes() == want_v[r].numpy().tobytes(), r
        assert ids[r].numpy().tobytes() == want_i[r].numpy().tobytes(), r


@pytest.mark.parametrize("kc", [6, 10, 23])
@pytest.mark.parametrize("held", ["one", "two"])
@pytest.mark.parametrize("n", WORLDS)
def test_host_schedule_on_a_process_mesh_equals_the_plain_ring(worlds, n, held, kc):
    """The same schedule over the process backend (one or two shards a
    process, so hops within a process and across processes) gives the
    single-controller plain ring's bits on every rank."""
    m = 1 if held == "one" else 2
    want_v, want_i = _ring_want(n * m, kc)
    for p, got in enumerate(worlds[n]):
        for r in range(p * m, (p + 1) * m):
            assert got[f"host/{held}_{kc}/{r}/d"].tobytes() == want_v[r].numpy().tobytes(), r
            assert got[f"host/{held}_{kc}/{r}/i"].tobytes() == want_i[r].numpy().tobytes(), r
