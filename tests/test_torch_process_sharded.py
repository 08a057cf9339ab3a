"""Process meshes: the query-sharded IVF-PQ and CAGRA searches, the
distributed IVF-PQ build and its steps, ``TieredShardedIndex`` and the
engine's sharded and tiered sharded registrations across worlds of 2 and 4
gloo processes, against the port's single-controller mesh and raft_tpu.

A module fixture spawns both worlds at once (the pattern of
``tests/test_torch_process_mesh.py``): one ``python -c`` child a process,
importing only ``torch`` and ``raft_tpu_torch``, a ``file://`` store in a
temporary directory, every join bounded (the children are killed past
:data:`JOIN_S`). Each child holds one CPU shard of ``global_mesh()`` and
runs :func:`cases` (in ``LIB``) along its one axis, then on a ``2 x 2``
process mesh along each axis (in the world of 2 each process holds a row
of two shards), and writes an ``.npz``. The parent runs the same cases on
``make_mesh(["cpu"] * n)`` and on the ``2 x 2`` single-controller mesh.

The bar: every case on every rank equals the single-controller mesh's bit
for bit (ids, value bits, every build field, coverage and failed shards);
the build's fields are the same in every process; the query-sharded
searches' ids equal raft_tpu's. The fault cases down shard 1's health
probe in one process only (the one holding its first shard) and shard 0's
host tier in another: the processes agree, so every process serves the
single-controller mesh's degraded answer.
"""
import io
import json
import os
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from raft_tpu.neighbors import cagra as jcagra
from raft_tpu.neighbors import ivf_flat as jflat
from raft_tpu.neighbors import ivf_pq as jpq
from raft_tpu.parallel import make_mesh as jmake_mesh
from raft_tpu.parallel import sharded_ann as jsa
from raft_tpu_torch.neighbors import cagra as tcagra
from raft_tpu_torch.neighbors import ivf_flat as tflat
from raft_tpu_torch.neighbors import ivf_pq as tpq
from raft_tpu_torch.parallel import make_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLDS = (2, 4)
JOIN_S = 200
N, D, N_LISTS, NQ = 2048, 16, 16, 24

#: shared by the children and the parent: the cases of every entry point
LIB = r'''
import contextlib
import json

import numpy as np
import torch

K, N_PROBES, ITERS = 8, 4, 3
CAGRA_SP = dict(itopk_size=64, search_width=4)
BUILD = dict(n_lists=16, pq_dim=8, kmeans_n_iters=4, seed=2)
FIELDS = ("centers", "rotation", "pq_centers", "codes", "list_indices", "list_sizes",
          "rot_sqnorms")
#: the cases run on the 2 x 2 meshes (a subset of the one-axis mesh's)
CASES_2D = ("qpq", "qcagra_sample", "build_ca", "tiered", "tiered_tier_down", "engine_flat",
            "engine_flat_down")


def holds_first(mesh, axis, s):
    """Whether this process holds the first shard at coordinate ``s`` along
    ``axis`` (always on one controller): the one process a fault is
    installed in."""
    first = min(r for r in range(mesh.size) if mesh.coord(r, axis) == s)
    return first in mesh.local_ranks


def fault_in(mesh, axis, s, point, error):
    """``point`` failing for shard ``s``, installed only where
    :func:`holds_first` says."""
    from raft_tpu_torch.robust import faults

    if not holds_first(mesh, axis, s):
        return contextlib.nullcontext()
    return faults.injected(point, error=error, match={"shard": s})


def served(eng, index_id, q):
    futs = eng.submit_many(index_id, q, K, request_rows=4)
    eng.run_until_idle()
    out = [f.result() for f in futs]
    return {"d": np.concatenate([r.distances for r in out]),
            "i": np.concatenate([r.indices for r in out]),
            "cov": np.array(json.dumps(sorted({(r.coverage, r.failed_shards) for r in out})))}


def steps(mesh, axis, step, init, rows, mode):
    """ITERS of the build's Lloyd or codebook step: the first local shard's
    state (every shard holds the same)."""
    from raft_tpu_torch.cluster.kmeans import flash_norm_cache
    from raft_tpu_torch.parallel import comms
    from raft_tpu_torch.parallel import sharded_ann as tsa

    xs = comms.row_sharded(mesh, rows, axis)
    c, carry = comms.replicated(mesh, init), None
    kw = dict(comm_mode="ca") if mode == "ca" else {}
    for _ in range(ITERS):
        if step == "lloyd":
            out = tsa.dist_lloyd_step(mesh, c, xs, BUILD["n_lists"], axis,
                                      caches=[flash_norm_cache(x) for x in xs], carry=carry, **kw)
        else:
            out = tsa.dist_codebook_step(mesh, c, xs, 16, axis, carry=carry, **kw)
        if mode == "ca":
            c, carry = out[0], out[-1]
        else:
            c = out[0] if step == "lloyd" else out
    assert all(torch.equal(c[0], x) for x in c[1:])
    return c[0].numpy()


def cases(mesh, axis, flat, pq, cg, data, queries, only=None):
    """Every entry point of the slice on ``mesh`` along ``axis``: ``{case:
    {part: numpy array}}`` (``only``: a subset of the cases)."""
    from raft_tpu_torch.core.errors import ShardFailure
    from raft_tpu_torch.core.resources import Resources
    from raft_tpu_torch.neighbors import cagra, ivf_flat, ivf_pq
    from raft_tpu_torch.parallel import (sharded_cagra_search, sharded_ivf_pq_build,
                                         sharded_ivf_pq_search)
    from raft_tpu_torch.serve import ServingEngine
    from raft_tpu_torch.tiered import ShardedHostTier, TieredShardedIndex

    n = mesh.shape[axis]
    want = (lambda c: only is None or c in only)
    out = {}

    def pair(d, i):
        return {"d": d.numpy(), "i": i.numpy()}

    if want("qpq"):
        out["qpq"] = pair(*sharded_ivf_pq_search(mesh, pq, queries, K, n_probes=N_PROBES,
                                                 axis=axis))
    for tag, sample in (("sample", 256), ("random", 0)):
        if want("qcagra_" + tag):
            sp = cagra.CagraSearchParams(**CAGRA_SP, init_sample=sample, seed=3)
            out["qcagra_" + tag] = pair(*sharded_cagra_search(mesh, cg, queries, K, sp, axis=axis))
    resid = (data - data.mean(dim=0)).reshape(data.shape[0], BUILD["pq_dim"], -1)
    books0 = resid[torch.arange(16) * 97].transpose(0, 1).contiguous()
    for step, init, rows in (("lloyd", data[:BUILD["n_lists"]], data), ("books", books0, resid)):
        for mode in ("full", "ca"):
            if want(f"{step}_{mode}"):
                out[f"{step}_{mode}"] = {"state": steps(mesh, axis, step, init, rows, mode)}
    for mode in ("full", "ca"):
        if want("build_" + mode):
            built = sharded_ivf_pq_build(mesh, data, ivf_pq.IvfPqIndexParams(**BUILD), axis=axis,
                                         comm_mode=mode)
            out["build_" + mode] = {f: getattr(built, f).numpy() for f in FIELDS}
    fp = ivf_flat.IvfFlatSearchParams(n_probes=N_PROBES)

    def tiered(merge_mode="auto"):
        tier = ShardedHostTier.from_lists(flat, data, n)
        return TieredShardedIndex(mesh, "ivf_flat", flat, tier, axis=axis, refine_ratio=2,
                                  micro_batch=8, search_params=fp, merge_mode=merge_mode)

    if want("tiered"):
        r = tiered().search(queries, K)
        out["tiered"] = dict(pair(r.distances, r.indices), cov=np.array([r.coverage]))
    if want("tiered_tier_down"):
        with fault_in(mesh, axis, 0, "host.fetch", OSError("host tier lost")):
            r = tiered().search(queries, K)
        out["tiered_tier_down"] = dict(pair(r.distances, r.indices), cov=np.array(
            [r.coverage, *r.failed_shards]))
    for name, algo, index, merge in (("flat", "sharded_ivf_flat", flat, "auto"),
                                     ("pq", "sharded_ivf_pq_lists", pq, "gather"),
                                     ("tiered", "tiered_sharded", None, "fused_ring")):
        if not (want("engine_" + name) or want(f"engine_{name}_down")):
            continue
        eng = ServingEngine(max_batch=8, max_wait_ms=0.0, res=Resources(device="cpu"))
        if algo == "tiered_sharded":
            eng.register("s", algo, tiered(merge))
        else:
            eng.register("s", algo, index, mesh=mesh, axis=axis, merge_mode=merge,
                         n_probes=N_PROBES)
        if want("engine_" + name):
            out["engine_" + name] = served(eng, "s", queries)
        if want(f"engine_{name}_down"):
            with fault_in(mesh, axis, 1, "sharded_ann.shard_scan", ShardFailure("down", shard=1)):
                out[f"engine_{name}_down"] = served(eng, "s", queries)
    return out


def flatten(prefix, got):
    return {f"{prefix}/{case}/{part}": a for case, parts in got.items() for part, a in parts.items()}
'''

CHILD = r'''
import json
import sys

import numpy as np
import torch

torch.set_num_threads(1)
from raft_tpu_torch.neighbors import cagra, ivf_flat, ivf_pq
from raft_tpu_torch.parallel import bootstrap

rank, world, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
assert bootstrap.init_distributed(f"file://{work}/store{world}", world, rank, backend="gloo",
                                  timeout_s=90)
flat = ivf_flat.load_path(f"{work}/flat.idx", device="cpu")
pq = ivf_pq.load_path(f"{work}/pq.idx", device="cpu")
cg = cagra.load_path(f"{work}/cagra.idx", device="cpu")
data = torch.from_numpy(np.load(f"{work}/data.npy"))
queries = torch.from_numpy(np.load(f"{work}/queries.npy"))
mesh = bootstrap.global_mesh()
out = {"mesh": np.array([mesh.size, *mesh.local_ranks])}
out.update(flatten("1d", cases(mesh, "data", flat, pq, cg, data, queries)))
mesh2 = bootstrap.global_mesh(("x", "y"), shape=(2, 2), devices=["cpu"] * (4 // world))
for axis in ("x", "y"):
    out.update(flatten("2d_" + axis, cases(mesh2, axis, flat, pq, cg, data, queries,
                                           only=CASES_2D)))
np.savez(f"{work}/w{world}_rank{rank}.npz", **out)
bootstrap.shutdown()
'''

lib = {}
exec(LIB, lib)


def _spawn(world, work):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    return [subprocess.Popen([sys.executable, "-c", LIB + CHILD, str(r), str(world), work],
                             cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for r in range(world)]


def _join(procs, deadline):
    """Wait for every child until ``deadline``; kill them all past it."""
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


def _load(jmod, tmod, index):
    buf = io.BytesIO()
    jmod.save(index, buf)
    buf.seek(0)
    return tmod.load(buf, device="cpu")


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(47)
    centers = rng.normal(size=(24, D)).astype(np.float32) * 3
    x = (centers[rng.integers(0, 24, N)] + rng.normal(size=(N, D))).astype(np.float32)
    q = (centers[rng.integers(0, 24, NQ)] + rng.normal(size=(NQ, D))).astype(np.float32)
    return x, q


@pytest.fixture(scope="module")
def indexes(corpus, tmp_path_factory):
    """raft_tpu's IVF-Flat, IVF-PQ and CAGRA indexes, loaded into the port
    and saved through its serializer into the worlds' directory."""
    work = str(tmp_path_factory.mktemp("procs_sharded"))
    x, q = corpus
    selfd = (x * x).sum(1)[:, None] + (x * x).sum(1)[None, :] - 2.0 * x @ x.T
    np.fill_diagonal(selfd, np.inf)
    knn = np.argsort(selfd, axis=1, kind="stable")[:, :32].astype(np.int32)
    jax_idx = {
        "flat": jflat.build(x, jflat.IvfFlatIndexParams(n_lists=N_LISTS)),
        "pq": jpq.build(x, jpq.IvfPqIndexParams(n_lists=N_LISTS, pq_dim=8, pq_kind="kmeans",
                                                kmeans_n_iters=4)),
        "cagra": jcagra.from_graph(x, np.asarray(jcagra.optimize(knn, 16)), "sqeuclidean")}
    out = {"work": work, "jax": jax_idx}
    for name, jmod, tmod in (("flat", jflat, tflat), ("pq", jpq, tpq),
                             ("cagra", jcagra, tcagra)):
        out[name] = _load(jmod, tmod, jax_idx[name])
        tmod.save_path(out[name], f"{work}/{name}.idx")
    np.save(f"{work}/data.npy", x)
    np.save(f"{work}/queries.npy", q)
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
    return {n: [dict(np.load(f"{work}/w{n}_rank{r}.npz")) for r in range(n)]
            for n in WORLDS}


def _single(indexes, corpus, mesh, axis, only=None):
    x, q = corpus
    return lib["flatten"]("", lib["cases"](mesh, axis, indexes["flat"], indexes["pq"],
                                           indexes["cagra"], torch.from_numpy(x),
                                           torch.from_numpy(q), only=only))


@pytest.fixture(scope="module")
def single(indexes, corpus):
    """The cases on the single-controller meshes: ``{(n, axis): {key: array}}``."""
    out = {(n, "data"): _single(indexes, corpus, make_mesh(["cpu"] * n), "data")
           for n in WORLDS}
    mesh2 = make_mesh(["cpu"] * 4, shape=(2, 2), axis_names=("x", "y"))
    for axis in ("x", "y"):
        out[4, axis] = _single(indexes, corpus, mesh2, axis, only=lib["CASES_2D"])
    return out


CASES_1D = ["qpq", "qcagra_sample", "qcagra_random", "lloyd_full", "lloyd_ca", "books_full",
            "books_ca", "build_full", "build_ca", "tiered", "tiered_tier_down", "engine_flat",
            "engine_flat_down", "engine_pq", "engine_pq_down", "engine_tiered",
            "engine_tiered_down"]


def _assert_case_equal(got, want, prefix, case, who):
    keys = [k for k in want if k.startswith(f"/{case}/")]
    assert keys, case
    for k in keys:
        g, w = got[prefix + k], want[k]
        assert g.dtype == w.dtype and g.shape == w.shape, (who, k)
        assert g.tobytes() == w.tobytes(), (who, k)


@pytest.mark.parametrize("case", CASES_1D)
@pytest.mark.parametrize("n", WORLDS)
def test_each_entry_point_equals_the_single_controller_mesh(worlds, single, n, case):
    for r, got in enumerate(worlds[n]):
        assert got["mesh"].tolist() == [n, r]
        _assert_case_equal(got, single[n, "data"], "1d", case, r)


@pytest.mark.parametrize("case", list(lib["CASES_2D"]))
@pytest.mark.parametrize("axis", ["x", "y"])
@pytest.mark.parametrize("n", WORLDS)
def test_each_entry_point_along_each_axis_of_a_2x2_process_mesh(worlds, single, n, axis, case):
    for r, got in enumerate(worlds[n]):
        _assert_case_equal(got, single[4, axis], "2d_" + axis, case, r)


@pytest.mark.parametrize("n", WORLDS)
def test_the_build_is_the_same_index_in_every_process(worlds, n):
    for mode in ("full", "ca"):
        for f in lib["FIELDS"]:
            first = worlds[n][0][f"1d/build_{mode}/{f}"]
            for got in worlds[n][1:]:
                assert got[f"1d/build_{mode}/{f}"].tobytes() == first.tobytes(), (mode, f)


@pytest.mark.parametrize("n", WORLDS)
def test_a_fault_in_one_process_degrades_every_process_alike(worlds, n):
    """Shard 1's probe down in process 1 only, shard 0's tier in process 0
    only: every process reports the same coverage and failed shards."""
    for got in worlds[n]:
        for name in ("flat", "pq", "tiered"):
            assert json.loads(str(got[f"1d/engine_{name}_down/cov"])) == [[1 - 1 / n, [1]]], name
            assert json.loads(str(got[f"1d/engine_{name}/cov"])) == [[1.0, []]], name
        assert got["1d/tiered_tier_down/cov"].tolist() == [1 - 1 / n, 0]


@pytest.mark.parametrize("n", WORLDS)
def test_query_sharded_ids_equal_raft_tpu_s(worlds, indexes, corpus, n):
    _, q = corpus
    jm = jmake_mesh(jax.devices()[:n])
    k, n_probes = lib["K"], lib["N_PROBES"]
    jd, ji = jsa.sharded_ivf_pq_search(jm, indexes["jax"]["pq"], q, k,
                                       jpq.IvfPqSearchParams(n_probes=n_probes))
    cd, ci = jsa.sharded_cagra_search(jm, indexes["jax"]["cagra"], q, k, jcagra.CagraSearchParams(
        **lib["CAGRA_SP"], init_sample=256, seed=3))
    for got in worlds[n]:
        for key, d, i in (("qpq", jd, ji), ("qcagra_sample", cd, ci)):
            np.testing.assert_array_equal(got[f"1d/{key}/i"], np.asarray(i))
            np.testing.assert_allclose(got[f"1d/{key}/d"], np.asarray(d), rtol=1e-5, atol=1e-5)
