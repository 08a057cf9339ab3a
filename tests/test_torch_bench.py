"""The port's bench (``raft_tpu_torch.bench``) against raft_tpu's: the
datasets and their ``.fbin`` files, the ground truth and its cache, the
download, the grids, the harness's rows and analysis, ``run_case`` and
``sweep`` on every algorithm, the CLI, the export and the plot, the prims.
Inputs come from numpy seeds; JAX runs on the CPU. Recall after a build
is held at the port's build-randomness tolerance of 0.02 (k-means and the
graph draw from a ``torch.Generator``)."""
import csv
import importlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from raft_tpu import bench as jbench
from raft_tpu.bench import configs as jconfigs
from raft_tpu.bench import data_export as jexport
from raft_tpu.bench import datasets as jds
from raft_tpu.bench import harness as jh
from raft_tpu.core.errors import LogicError as JLogicError
from raft_tpu.robust.retry import RetryError as JRetryError
from raft_tpu.robust.retry import RetryPolicy as JRetryPolicy
from raft_tpu_torch import bench as tbench
from raft_tpu_torch.bench import __main__ as tcli
from raft_tpu_torch.bench import configs as tconfigs
from raft_tpu_torch.bench import data_export as texport
from raft_tpu_torch.bench import datasets as tds
from raft_tpu_torch.bench import harness as th
from raft_tpu_torch.bench import plot as tplot
from raft_tpu_torch.bench import prims as tprims
from raft_tpu_torch.core.resources import Resources
from raft_tpu_torch.robust.retry import RetryError as TRetryError
from raft_tpu_torch.robust.retry import RetryPolicy as TRetryPolicy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = Resources(device="cpu")
RECALL_TOL = 0.02


@pytest.fixture(autouse=True)
def data_dir(tmp_path, monkeypatch):
    """Both packages' ``DATA_DIR`` under the test's own directory."""
    d = str(tmp_path / "bench_data")
    monkeypatch.setattr(jds, "DATA_DIR", d)
    monkeypatch.setattr(tds, "DATA_DIR", d)
    return d


@pytest.fixture(scope="module")
def small():
    """The 2,000 x 32 clustered set, 64 queries, in both packages."""
    return (jds.make_clustered("small", 2000, 32, 64, seed=7),
            tds.make_clustered("small", 2000, 32, 64, seed=7))


def test_all_is_jax_s():
    assert tbench.__all__ == jbench.__all__
    assert len(tbench.__all__) == 19
    for name in tbench.__all__:
        assert type(getattr(tbench, name)).__name__ == type(getattr(jbench, name)).__name__


def test_import_stays_cheap():
    """Importing the bench loads no kernel library, no triton, no JAX and
    no matplotlib."""
    code = (
        "import sys\n"
        "import raft_tpu_torch.bench, raft_tpu_torch.bench.prims, raft_tpu_torch.bench.plot\n"
        "import raft_tpu_torch.bench.data_export, raft_tpu_torch.bench.__main__\n"
        "maps = open('/proc/self/maps').read()\n"
        "print([m in sys.modules for m in ('triton', 'jax', 'raft_tpu', 'matplotlib')],\n"
        "      'raft_tpu_torch/_build' in maps)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split("\n")[0] == "[False, False, False, False] False"


# -- datasets ---------------------------------------------------------------------------------


@pytest.mark.parametrize("make", ["clustered", "uniform", "smoke-10k"])
def test_generated_arrays_are_bit_equal(make):
    if make == "clustered":
        j = jds.make_clustered("c", 3000, 24, 50, n_centers=40, cluster_std=0.3, seed=11)
        t = tds.make_clustered("c", 3000, 24, 50, n_centers=40, cluster_std=0.3, seed=11)
    elif make == "uniform":
        j, t = (m.make_uniform("u", 1000, 16, 30, metric="inner_product", seed=5) for m in (jds, tds))
    else:
        j, t = jds.get_dataset(make), tds.get_dataset(make)
    assert (t.name, t.metric, t.n, t.dim) == (j.name, j.metric, j.n, j.dim)
    assert t.base.dtype == j.base.dtype == np.float32
    np.testing.assert_array_equal(t.base, j.base)
    np.testing.assert_array_equal(t.queries, j.queries)


def test_registry_is_jax_s():
    assert tds._REGISTRY == jds._REGISTRY
    with pytest.raises(KeyError):
        tds.get_dataset("no-such-set")


@pytest.mark.parametrize("writer,reader", [(jds, tds), (tds, jds)], ids=["jax->torch", "torch->jax"])
def test_fbin_crosses_packages(tmp_path, writer, reader):
    rng = np.random.default_rng(3)
    arr = rng.standard_normal((37, 9)).astype(np.float32)
    ids = rng.integers(0, 1000, (5, 4)).astype(np.int32)
    writer.write_fbin(str(tmp_path / "a.fbin"), arr)
    writer.write_fbin(str(tmp_path / "a.ibin"), ids)
    np.testing.assert_array_equal(reader.read_fbin(str(tmp_path / "a.fbin")), arr)
    np.testing.assert_array_equal(reader.read_fbin(str(tmp_path / "a.ibin"), np.int32), ids)
    assert sorted(os.listdir(tmp_path)) == ["a.fbin", "a.ibin"]  # no temp file left
    with open(tmp_path / "a.fbin", "rb") as f:
        assert np.frombuffer(f.read(8), np.int32).tolist() == [37, 9]


def test_on_disk_pair_takes_precedence(data_dir):
    rng = np.random.default_rng(4)
    base = rng.standard_normal((50, 8)).astype(np.float32)
    query = rng.standard_normal((6, 8)).astype(np.float32)
    for name in ("smoke-10k", "my-own-set"):
        tds.write_fbin(os.path.join(data_dir, name, "base.fbin"), base)
        tds.write_fbin(os.path.join(data_dir, name, "query.fbin"), query)
        t, j = tds.get_dataset(name), jds.get_dataset(name)
        np.testing.assert_array_equal(t.base, base)
        np.testing.assert_array_equal(t.queries, query)
        np.testing.assert_array_equal(j.base, t.base)
        assert t.metric == j.metric == "euclidean"


def test_ground_truth_equal_and_cached(data_dir, monkeypatch):
    j = jds.make_clustered("small", 2000, 32, 64, seed=7)
    t = tds.make_clustered("small", 2000, 32, 64, seed=7)
    gj = j.ground_truth(10)
    gt = t.ground_truth(10, res=CPU)
    assert gt.shape == gj.shape == (64, 10)
    np.testing.assert_array_equal(gt, gj)
    cache = tds._gt_cache_path(t)
    assert cache.startswith(os.path.abspath(data_dir)) and os.path.exists(cache)
    assert cache == jds._gt_cache_path(j)

    def no_knn(*a, **kw):
        raise AssertionError("the ground truth was not taken from the cache")

    monkeypatch.setattr(tds, "_exact_knn", no_knn)
    again = tds.make_clustered("small", 2000, 32, 64, seed=7)
    np.testing.assert_array_equal(again.ground_truth(10, res=CPU), gj)
    np.testing.assert_array_equal(again.ground_truth(5, res=CPU), gj[:, :5])


def test_download_file_from_a_file_url(tmp_path):
    src = tmp_path / "src.bin"
    payload = np.arange(100_000, dtype=np.int32).tobytes()
    src.write_bytes(payload)
    for mod, name in ((tds, "t"), (jds, "j")):
        dest = tmp_path / "out" / f"{name}.bin"
        assert mod.download_file(src.as_uri(), str(dest), chunk=4096) == str(dest)
        assert dest.read_bytes() == payload
    assert sorted(os.listdir(tmp_path / "out")) == ["j.bin", "t.bin"]


def test_download_file_gives_up_after_the_policy_s_attempts(tmp_path):
    missing = (tmp_path / "missing.bin").as_uri()
    attempts = {}
    for mod, policy_cls, err in ((tds, TRetryPolicy, TRetryError), (jds, JRetryPolicy, JRetryError)):
        policy = policy_cls(max_attempts=3, base_delay_s=0.0, max_delay_s=0.0,
                            retryable=(OSError,))
        with pytest.raises(err) as e:
            mod.download_file(missing, str(tmp_path / "dl" / "x.bin"), policy=policy)
        attempts[mod.__name__] = e.value.attempts
    assert attempts == {tds.__name__: 3, jds.__name__: 3}
    assert not os.path.exists(tmp_path / "dl" / "x.bin")
    assert [f for f in os.listdir(tmp_path / "dl") if ".tmp" in f] == []


# -- grids --------------------------------------------------------------------------------


def test_groups_and_constraints_are_jax_s():
    assert tconfigs.GROUPS == jconfigs.GROUPS
    n = 0
    for group in tconfigs.GROUPS.values():
        for algo, grids in group.items():
            jc, tc = jconfigs.constraint(algo), tconfigs.constraint(algo)
            assert (jc is None) == (tc is None)
            for bp in th._grid(grids["build"]):
                for sp in th._grid(grids["search"]):
                    n += 1
                    if jc is not None:
                        assert tc(bp, sp) == jc(bp, sp)
    assert n == 97
    assert [list(th._grid(g)) for g in ({}, {"a": [1, 2], "b": ["x"]})] == \
        [list(jh._grid(g)) for g in ({}, {"a": [1, 2], "b": ["x"]})]


# -- rows and their analysis ----------------------------------------------------------------


def _rows(mod, seed: int = 0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(12):
        out.append(mod.BenchResult(
            name=f"algo.b{i % 3}/s{i}/k=10/batch=32", algo=f"algo{i % 2}", dataset="d", k=10,
            batch=32, build_params={"nlist": 16 * (1 + i % 3)}, search_params={"nprobe": i},
            build_time=float(rng.random()), end_to_end=float(rng.random()) + 0.1,
            iterations=int(rng.integers(1, 5)), total_queries=64 * (1 + i),
            qps=float(rng.integers(100, 10_000)), latency=float(rng.random()) * 1e-3,
            recall=float(np.round(rng.random(), 2))))
    return out


def test_to_json_recall_pareto_and_operating_point_are_jax_s():
    jr, tr = _rows(jh), _rows(th)
    assert [r.to_json() for r in tr] == [r.to_json() for r in jr]
    assert [r.name for r in th.pareto_frontier(tr)] == [r.name for r in jh.pareto_frontier(jr)]
    for thr in (0.0, 0.5, 0.9, 0.99, 1.01):
        a, b = th.operating_point(tr, thr), jh.operating_point(jr, thr)
        assert (a is None and b is None) or a.name == b.name
    rng = np.random.default_rng(1)
    found = rng.integers(0, 50, (40, 12))
    gt = rng.integers(0, 50, (40, 12))
    for k in (1, 5, 10):
        assert th.recall_at_k(found, gt, k) == jh.recall_at_k(found, gt, k)
    params = {"nprobe": 5, "_dataset": object(), "fused_qt": 128}
    assert th._fmt(params) == jh._fmt(params) == "nprobe=5,fused_qt=128"
    assert th._fmt({}) == jh._fmt({}) == "default"


def test_save_report_round_trip(tmp_path):
    rows = _rows(th)
    path = str(tmp_path / "r" / "report.json")
    th.save_report(rows, path, context={"run": "unit"}, device="cpu")
    with open(path) as f:
        doc = json.load(f)
    assert doc["benchmarks"] == [r.to_json() for r in rows]
    ctx = doc["context"]
    assert (ctx["executable"], ctx["device"], ctx["num_devices"], ctx["run"]) == (
        "raft_tpu_torch.bench", "cpu", 1, "unit")
    assert set(ctx) == set(jh.to_report([], {"run": "unit"})["context"])
    assert os.listdir(tmp_path / "r") == ["report.json"]


# -- run_case and sweep -----------------------------------------------------------------------

def _same_runs(algo, tr, jr, t):
    assert [r.name for r in tr] == [r.name for r in jr] and tr
    for a, b in zip(tr, jr):
        assert a.to_json().keys() == b.to_json().keys()
        assert (a.iterations, a.total_queries, a.batch, a.k) == (1, 64, 32, 10)
        assert a.found.shape == (64, 10)
        assert a.recall == th.recall_at_k(a.found, t.ground_truth(10, res=CPU), 10)
        if algo == "raft_brute_force":
            assert a.recall == b.recall == 1.0
        else:
            assert a.recall >= b.recall - RECALL_TOL, (a.name, a.recall, b.recall)


@pytest.mark.parametrize("algo", sorted(tconfigs.GROUPS["smoke"]))
def test_sweep_and_run_case_match_jax(small, algo):
    """``sweep`` over the ``smoke`` grid (``run_case`` for each build point)
    on the 2,000-row set, 64 queries in batches of 32: JAX's result names,
    brute force's recall equal, the others' within the tolerance."""
    j, t = small
    kw = dict(k=10, batch=32, min_search_time=0.0, verbose=False)
    grids = tconfigs.GROUPS["smoke"][algo]
    tr = th.sweep(t, algo, grids["build"], grids["search"], constraint=tconfigs.constraint(algo),
                  res=CPU, **kw)
    if algo != "raft_cagra":
        jr = jh.sweep(j, algo, grids["build"], grids["search"],
                      constraint=jconfigs.constraint(algo), **kw)
        _same_runs(algo, tr, jr, t)
        return
    # the JAX package cannot build the smoke grid's CAGRA under the grid's
    # default spelling ("NN_DESCENT"): the names from the grid, then the
    # recall against JAX's build of the same route under its own spelling
    assert [r.name for r in tr] == [
        f"{algo}.{jh._fmt(bp)}/{jh._fmt(sp)}/k=10/batch=32"
        for bp in jh._grid(grids["build"]) for sp in jh._grid(grids["search"])]
    jbuild = dict(grids["build"], graph_build_algo=["nn_descent"])
    jr = jh.sweep(j, algo, jbuild, grids["search"], **kw)
    for a, b in zip(tr, jr):
        b.name = a.name
    _same_runs(algo, tr, jr, t)


def test_the_reference_s_spellings_build_in_the_port_only(small):
    """Differences by design: the JAX package passes the yaml's
    ``graph_build_algo`` spelling to ``build_algo`` unchanged and raises;
    the port maps ``NN_DESCENT``/``IVF_PQ`` (any case) onto its routes (the
    smoke sweep above builds ``NN_DESCENT``)."""
    from raft_tpu_torch.core.errors import LogicError

    j, t = small
    kw = dict(k=10, batch=32, min_search_time=0.0, verbose=False)
    bp = {"graph_degree": 16, "intermediate_graph_degree": 32}
    for spelling in ("NN_DESCENT", "IVF_PQ"):
        with pytest.raises(JLogicError, match=f"unknown build_algo {spelling}"):
            jh.run_case(j, "raft_cagra", dict(bp, graph_build_algo=spelling), [{"itopk": 32}], **kw)
    assert [th._cagra_build_algo(s) for s in ("NN_DESCENT", "nn_descent", "Nn_Descent", "IVF_PQ",
                                                "ivf_pq", "HNSW")] == \
        ["nn_descent"] * 3 + ["ivf_pq"] * 2 + ["HNSW"]
    (r,) = th.run_case(t, "raft_cagra", dict(bp, graph_build_algo="IVF_PQ"), [{"itopk": 32}],
                       res=CPU, **kw)
    assert r.recall >= 0.9
    with pytest.raises(LogicError, match="unknown build_algo"):
        th.run_case(t, "raft_cagra", dict(bp, graph_build_algo="HNSW"), [{"itopk": 32}],
                    res=CPU, **kw)


def test_ivf_pq_refine_runs_in_the_port(small, monkeypatch):
    """The ``refine_ratio`` points of the ``base`` grid: the port refines
    against its device copy of the base rows. The JAX package's adapter
    calls ``refine`` on ``raft_tpu.neighbors.refine``, which is the
    function, and raises (its search is stubbed here to reach that line)."""
    import jax.numpy as jnp
    from raft_tpu.neighbors import ivf_pq as jpq

    j, t = small
    monkeypatch.setattr(jpq, "search", lambda index, q, k, *a, **kw: (
        jnp.zeros((len(q), k)), jnp.zeros((len(q), k), jnp.int32)))
    with pytest.raises(AttributeError, match="refine"):
        jh._search_ivf_pq(None, j.queries[:32], 10, {"refine_ratio": 2, "_dataset": j}, 32)
    bp, sps = {"nlist": 16, "pq_dim": 8}, [{"nprobe": 8}, {"nprobe": 8, "refine_ratio": 2}]
    plain, refined = th.run_case(t, "raft_ivf_pq", bp, sps, k=10, batch=32,
                                 min_search_time=0.0, verbose=False, res=CPU)
    assert refined.recall > plain.recall
    assert refined.search_params == {"nprobe": 8, "refine_ratio": 2}


def test_half_lists_carry_their_own_norms(small):
    _, t = small
    index = th._build_ivf_flat(t, {"nlist": 16, "list_dtype": "half"}, CPU)
    import torch

    assert index.list_data.dtype == torch.bfloat16
    want = (index.list_data.to(torch.float32) ** 2).sum(-1)
    assert torch.equal(index.list_norms, want)


def test_cli_on_the_cpu_writes_json_csv_and_png(tmp_path, capsys):
    out, csv_out, png = (str(tmp_path / n) for n in ("r.json", "r.csv", "r.png"))
    rc = tcli.main(["--dataset", "smoke-10k", "--group", "smoke",
                    "--algos", "raft_brute_force,raft_ivf_flat", "--batch", "100",
                    "--min-search-time", "0", "--out", out, "--csv-out", csv_out,
                    "--plot-out", png, "--device", "cpu"])
    assert rc == 0
    with open(out) as f:
        doc = json.load(f)
    names = [b["name"] for b in doc["benchmarks"]]
    assert len(names) == 3 and names[0].startswith("raft_brute_force.")
    assert doc["context"]["device"] == "cpu"
    assert doc["benchmarks"][0]["Recall"] == 1.0
    with open(csv_out) as f:
        rows = list(csv.DictReader(f))
    assert [r["name"] for r in rows] == names
    assert os.path.getsize(png) > 1000
    assert "## raft_brute_force @ recall>=0.95" in capsys.readouterr().out


# -- export and plot -------------------------------------------------------------------------


def _report():
    return {
        "context": {"device": "cpu-test"},
        "benchmarks": [
            {"name": f"ivf_flat/npr={p}", "algo": a, "dataset": "unit", "k": 10, "n_queries": 64,
             "Recall": r, "items_per_second": q, "Latency": 0.001, "end_to_end": 0.01,
             "build_time": 1.0, "build_params": {"n_lists": 16, "b": [1, 2]},
             "search_params": {"n_probes": p}}
            for p, r, q, a in [(4, 0.8, 1000.0, "ivf_flat"), (8, 0.9, 700.0, "ivf_flat"),
                               (16, 0.97, 400.0, "ivf_flat"), (8, 0.85, 300.0, "ivf_pq")]
        ],
    }


def test_csv_is_byte_equal_to_jax_s(tmp_path):
    a = texport.export_csv(_report(), str(tmp_path / "t.csv"))
    path = tmp_path / "rep.json"
    path.write_text(json.dumps(_report()))
    b = jexport.export_csv(str(path), str(tmp_path / "j.csv"))
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    assert texport._COLUMNS == jexport._COLUMNS
    assert texport.main([str(path), "--out", str(tmp_path / "m.csv")]) == 0
    assert (tmp_path / "m.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()


def test_plot_report_and_frontier(tmp_path):
    from raft_tpu.bench.plot import _frontier as jfront

    pts = [(0.8, 1000.0), (0.9, 700.0), (0.97, 400.0), (0.85, 300.0)]
    assert tplot._frontier(pts) == jfront(pts) == [(0.8, 1000.0), (0.9, 700.0), (0.97, 400.0)]
    out = tplot.plot_report(_report(), str(tmp_path / "p" / "plot.png"), title="unit")
    assert os.path.getsize(out) > 1000
    path = tmp_path / "rep.json"
    path.write_text(json.dumps(_report()))
    assert tplot.main([str(path)]) == 0
    assert os.path.getsize(tmp_path / "rep.png") > 1000


# -- prims ----------------------------------------------------------------------------------


def test_prims_cases_are_jax_s():
    from raft_tpu.bench import prims as jprims

    assert [n for n, _ in tprims._cases()] == [n for n, _ in jprims._cases()]


@pytest.mark.parametrize("filt,names", [
    ("matrix/select_k", ["matrix/select_k_exact", "matrix/select_k_approx"]),
    ("random", ["random/normal_16M"]),
])
def test_prims_run_on_the_cpu(filt, names, tmp_path):
    rows = tprims.run(filt, inner=1, device="cpu")
    assert [r["name"] for r in rows] == names
    for r in rows:
        assert r["real_time"] > 0 and r["items_per_second"] > 0 and r["time_unit"] == "s"
    out = str(tmp_path / "prims.json")
    assert tprims.main(["--filter", "random", "--inner", "1", "--device", "cpu",
                        "--out", out]) == 0
    with open(out) as f:
        assert [r["name"] for r in json.load(f)["benchmarks"]] == ["random/normal_16M"]


def test_modules_import_nothing_of_jax():
    for name in ("datasets", "configs", "harness", "loadgen", "prims", "data_export", "plot",
                 "__main__", "__init__"):
        path = os.path.join(REPO, "raft_tpu_torch", "bench", f"{name}.py")
        with open(path) as f:
            src = f.read()
        assert "import jax" not in src and "from raft_tpu." not in src and "import raft_tpu\n" not in src
        mod = importlib.import_module("raft_tpu_torch.bench" + ("" if name == "__init__" else f".{name}"))
        assert mod.__file__ == path
