"""The port's host tier (``raft_tpu_torch.tiered``) and the engine's
placement against raft_tpu's.

Indexes are built by raft_tpu, saved and loaded into the port, so both
packages scan the same lists. Held here:

* the port's :class:`TieredIndex` agrees with the JAX package's (ids equal
  up to ties, distances ``allclose(rtol=1e-5, atol=1e-4)``) for IVF-PQ with
  kmeans, nibble and RaBitQ codes, IVF-Flat and brute force, overlapped or
  not, over a partial last micro-batch; and equals the port's resident
  ``search(dataset=...)`` by ``torch.equal``;
* host-vector files written by either package open in the other, mapped or
  read; a corrupt file fails typed, a bad shape is rejected, ``-1`` takes
  row 0; dedup, the fetch depth, read-ahead and ``fault_context`` as in
  ``tests/test_tiered.py``;
* the ``host.fetch`` seam: latency leaves results alone, a transient fault
  is retried, a permanent one raises ``HostFetchError``;
* ``ServingEngine(hbm_budget_bytes=...)``: over budget the dataset spills
  to a ``HostVectorStore`` with the resident bits, under budget it stays,
  an infeasible budget fails typed, a pre-built ``TieredIndex`` serves, and
  a sharded registration over its per-shard budget converts to
  ``tiered_sharded`` as the JAX engine's does
  (``tests/test_torch_tiered_sharded.py`` serves it).
"""
import io

import jax
import numpy as np
import pytest
import torch

from raft_tpu import obs as jobs
from raft_tpu.neighbors import brute_force as jbf
from raft_tpu.neighbors import ivf_flat as jflat
from raft_tpu.neighbors import ivf_pq as jpq
from raft_tpu.parallel import make_mesh as jmake_mesh
from raft_tpu.robust import faults as jfaults
from raft_tpu.serve.engine import ServingEngine as JEngine
from raft_tpu.tiered import HostVectorStore as JStore
from raft_tpu.tiered import TieredIndex as JTiered
from raft_tpu_torch import obs
from raft_tpu_torch.core.errors import CorruptIndexError, HostFetchError, LogicError
from raft_tpu_torch.core.resources import Resources
from raft_tpu_torch.neighbors import brute_force as tbf
from raft_tpu_torch.neighbors import ivf_flat as tflat
from raft_tpu_torch.neighbors import ivf_pq as tpq
from raft_tpu_torch.neighbors.refine import is_host_dataset
from raft_tpu_torch.ops.hbm_model import residency_for_index
from raft_tpu_torch.parallel import make_mesh
from raft_tpu_torch.robust import faults
from raft_tpu_torch.serve import ServingEngine
from raft_tpu_torch.tiered import HostVectorStore, TieredIndex
from test_torch_ivf_pq import assert_search_equal

N, DIM, K, MB, RATIO = 3000, 40, 10, 256, 4
FAMILIES = ("kmeans", "nibble", "rabitq", "ivf_flat", "brute_force")
CPU = Resources(device="cpu")


@pytest.fixture(scope="module")
def data():
    return np.random.default_rng(71).standard_normal((N, DIM)).astype(np.float32)


@pytest.fixture(scope="module")
def queries():
    # 600 rows: two full micro-batches and a partial one of 88
    return np.random.default_rng(72).standard_normal((600, DIM)).astype(np.float32)


def _load(jmod, tmod, index):
    buf = io.BytesIO()
    jmod.save(index, buf)
    buf.seek(0)
    return tmod.load(buf, device="cpu")


@pytest.fixture(scope="module")
def family(data):
    """name -> (algo, JAX index, port index, JAX params, port params),
    built by raft_tpu once."""
    built = {}

    def get(name):
        if name in built:
            return built[name]
        if name in ("kmeans", "nibble", "rabitq"):
            kw = {"kmeans": dict(pq_dim=10, pq_kind="kmeans"), "nibble": dict(pq_dim=10),
                  "rabitq": dict(pq_bits=1)}[name]
            ji = jpq.build(data, jpq.IvfPqIndexParams(n_lists=8, kmeans_n_iters=4, seed=1, **kw))
            built[name] = ("ivf_pq", ji, _load(jpq, tpq, ji),
                           jpq.IvfPqSearchParams(n_probes=6, refine_ratio=RATIO),
                           tpq.IvfPqSearchParams(n_probes=6, refine_ratio=RATIO))
        elif name == "ivf_flat":
            ji = jflat.build(data, jflat.IvfFlatIndexParams(n_lists=8, kmeans_n_iters=4, seed=3))
            built[name] = ("ivf_flat", ji, _load(jflat, tflat, ji),
                           jflat.IvfFlatSearchParams(n_probes=6, refine_ratio=RATIO),
                           tflat.IvfFlatSearchParams(n_probes=6, refine_ratio=RATIO))
        else:
            ji = jbf.build(data)
            built[name] = ("brute_force", ji, _load(jbf, tbf, ji), None, None)
        return built[name]

    return get


def resident(algo, index, params, q, data, query_batch=MB):
    """The port's all-resident refine search of ``q``."""
    X = torch.from_numpy(data)
    if algo == "brute_force":
        return tbf.search(index, q, K, query_batch=query_batch, dataset=X, refine_ratio=RATIO)
    mod = tpq if algo == "ivf_pq" else tflat
    return mod.search(index, q, K, params, query_batch=query_batch, dataset=X)


def resident_batches(algo, index, params, q, data, mb=MB):
    """The resident search a micro-batch at a time: the batches a
    ``TieredIndex`` re-ranks."""
    outs = [resident(algo, index, params, q[s : s + mb], data) for s in range(0, len(q), mb)]
    return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])


def assert_equal(got, want):
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0], want[0])


# -- TieredIndex against JAX and against the port's resident search -------------------


@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("name", FAMILIES)
def test_tiered_matches_jax_and_the_resident_search(family, data, queries, name, overlap):
    algo, ji, ti, jsp, tsp = family(name)
    jd, jids = JTiered(algo, ji, JStore(data), refine_ratio=RATIO, micro_batch=MB,
                       search_params=jsp).search(queries, K, overlap=overlap)
    tt = TieredIndex(algo, ti, HostVectorStore(data), refine_ratio=RATIO, micro_batch=MB,
                     search_params=tsp)
    td, tids = tt.search(queries, K, overlap=overlap)
    assert_search_equal(td, tids, jd, jids)
    assert_equal((td, tids), resident_batches(algo, ti, tsp, queries, data))


def test_single_partial_batch_equals_resident(family, data, queries):
    algo, _, ti, _, tsp = family("nibble")
    tt = TieredIndex(algo, ti, HostVectorStore(data), refine_ratio=RATIO, micro_batch=MB,
                     search_params=tsp)
    q = queries[:7]
    assert_equal(tt.search(q, K), resident(algo, ti, tsp, q, data))


def test_tiered_search_of_a_bf16_store(family, data, queries):
    """A bfloat16 store re-ranks its bf16 rows as a resident bf16 dataset
    does."""
    algo, _, ti, _, tsp = family("ivf_flat")
    Xb = torch.from_numpy(data).to(torch.bfloat16)
    store = HostVectorStore(Xb)
    assert store.dtype == torch.bfloat16 and store.nbytes == N * DIM * 2
    got = TieredIndex(algo, ti, store, refine_ratio=RATIO, micro_batch=MB,
                      search_params=tsp).search(queries[:MB], K)
    assert_equal(got, tflat.search(ti, queries[:MB], K, tsp, query_batch=MB, dataset=Xb))


def test_brute_force_tiered_under_lp_reranks_with_its_p(data, queries):
    """A brute-force index under ``LpUnexpanded`` (p = 3): the re-rank
    reads the tier's ``metric_arg``, as JAX's does, and returns p = 3
    distances, the resident search's."""
    ji = jbf.build(data, metric="lp", metric_arg=3.0)
    ti = _load(jbf, tbf, ji)
    q = queries[:MB + 40]
    jd, jids = JTiered("brute_force", ji, JStore(data), refine_ratio=RATIO, micro_batch=MB,
                       metric_arg=3.0).search(q, K)
    tt = TieredIndex("brute_force", ti, HostVectorStore(data), refine_ratio=RATIO,
                     micro_batch=MB, metric_arg=3.0)
    td, tids = tt.search(q, K)
    assert_search_equal(td, tids, jd, jids)
    assert_equal((td, tids), resident_batches("brute_force", ti, None, q, data))
    want = (np.abs(q[:, None, :] - data[tids.numpy()]) ** 3).sum(-1) ** (1 / 3)
    np.testing.assert_allclose(td.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["nibble", "ivf_flat", "brute_force"])
def test_short_refine_dataset_fails_before_the_scan(family, data, queries, name):
    algo, _, ti, _, tsp = family(name)
    with pytest.raises(LogicError, match=r"%s refine dataset has 1000 rows" % algo):
        resident(algo, ti, tsp, queries[:4], data[:1000])


def test_corpus_four_times_the_device_budget_serves_tiered():
    """Raw rows at least 4x the budget the planner grants the scan: tiering
    is the only way, and the results are the resident search's."""
    rng = np.random.default_rng(11)
    wide = rng.standard_normal((6000, 128)).astype(np.float32)
    idx = tpq.build(wide, tpq.IvfPqIndexParams(n_lists=16, pq_dim=16, pq_bits=4,
                                               kmeans_n_iters=4), res=CPU)
    sp = tpq.IvfPqSearchParams(n_probes=16, refine_ratio=RATIO)
    res = residency_for_index("big", "ivf_pq", idx, refine_rows=wide.shape[0])
    budget = int(res.required_bytes / 0.9) + (8 << 10)
    store = HostVectorStore(wide)
    assert store.nbytes >= 4 * budget
    from raft_tpu_torch.ops.hbm_model import plan_placement

    placement = plan_placement([res], hbm_budget=budget)
    assert placement.feasible and placement.tier("big", "raw_vectors") == "host"
    q = rng.standard_normal((500, 128)).astype(np.float32)
    got = TieredIndex("ivf_pq", idx, store, refine_ratio=RATIO, micro_batch=MB,
                      search_params=sp).search(q, K)
    assert_equal(got, resident_batches("ivf_pq", idx, sp, q, wide))


# -- the store: gather and files ------------------------------------------------------


def test_gather_substitutes_row_zero_for_invalid_ids(data):
    store = HostVectorStore(data)
    cand = np.array([[5, -1, 17], [-1, 0, 2]], np.int32)
    slab = store.gather(cand)
    assert slab.shape == (2, 3, DIM)
    np.testing.assert_array_equal(slab, data[np.where(cand >= 0, cand, 0)])
    np.testing.assert_array_equal(slab, JStore(data).gather(cand))
    t = store.gather_to(torch.from_numpy(cand), "cpu")
    assert torch.equal(t, torch.from_numpy(data[np.where(cand >= 0, cand, 0)]))


def test_double_buffered_staging(data):
    store = HostVectorStore(data)
    a = store.gather(np.array([[1, 2]], np.int32))
    b = store.gather(np.array([[3, 4]], np.int32))
    assert a is not b  # the previous slab survives the next gather
    np.testing.assert_array_equal(a[0, 0], data[1])
    np.testing.assert_array_equal(b[0, 0], data[3])


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_store_files_open_in_either_package(tmp_path, data, writer, bf16):
    path = str(tmp_path / "vectors.bin")
    rows = np.array([[3, 2999, -1, 3]], np.int32)
    if bf16:
        import jax.numpy as jnp

        src = np.asarray(jnp.asarray(data, jnp.bfloat16))
        (JStore if writer == "jax" else HostVectorStore).save(
            path, src if writer == "jax" else torch.from_numpy(data).to(torch.bfloat16))
        want = torch.from_numpy(data).to(torch.bfloat16)[np.where(rows >= 0, rows, 0)]
    else:
        (JStore if writer == "jax" else HostVectorStore).save(path, data)
        want = torch.from_numpy(data[np.where(rows >= 0, rows, 0)])
    for mmap in (True, False):
        t = HostVectorStore.open(path, mmap=mmap)
        assert t.is_mmap == mmap and t.shape == data.shape
        assert torch.equal(t.gather_to(rows, "cpu"), want)
        j = np.asarray(JStore.open(path, mmap=mmap).gather(rows))
        assert np.array_equal(j.view(np.uint16) if bf16 else j,
                              want.view(torch.int16).numpy().view(np.uint16) if bf16
                              else want.numpy())


def test_mmap_store_searches_as_the_resident_search(tmp_path, family, data, queries):
    algo, _, ti, _, tsp = family("nibble")
    path = str(tmp_path / "vectors.bin")
    HostVectorStore.save(path, data)
    want = resident_batches(algo, ti, tsp, queries, data)
    for mmap in (True, False):
        tt = TieredIndex(algo, ti, HostVectorStore.open(path, mmap=mmap), refine_ratio=RATIO,
                         micro_batch=MB, search_params=tsp)
        assert_equal(tt.search(queries, K), want)


@pytest.mark.parametrize("mmap", [True, False])
def test_corrupt_file_fails_typed(tmp_path, data, mmap):
    path = str(tmp_path / "vectors.bin")
    HostVectorStore.save(path, data)
    blob = bytearray(open(path, "rb").read())
    blob[-100] ^= 0xFF  # a payload byte
    with open(path, "wb") as f:
        f.write(blob)
    with pytest.raises(CorruptIndexError):
        HostVectorStore.open(path, mmap=mmap)


def test_bad_shapes_rejected(family, data):
    with pytest.raises(LogicError):
        HostVectorStore(np.zeros(8, np.float32))
    algo, _, ti, _, tsp = family("nibble")
    with pytest.raises(LogicError, match="HostVectorStore"):
        TieredIndex(algo, ti, HostVectorStore(data[: N // 2]), search_params=tsp)
    with pytest.raises(LogicError, match="candidates"):
        HostVectorStore(data).gather(np.arange(4))


# -- fetch controls: dedup, depth, read-ahead, fault context ---------------------------


def _counters(fn, o=obs):
    o.registry().reset()
    o.enable()
    try:
        fn()
        return o.registry().as_dict()
    finally:
        o.disable()
        o.registry().reset()


def test_dedup_counts_as_jax(data):
    cand = np.array([[7, 7, 7, 9], [9, 7, 7, 7]], np.int32)
    rows = np.array([5, 17, 5, 5, 42, 17], np.int32)

    def run(store_cls, o):
        snap = _counters(lambda: (store_cls(data).gather(cand), store_cls(data).gather_rows(rows)),
                         o)
        return snap["counters"], snap["histograms"].keys()

    (tc, th), (jc, jh) = run(HostVectorStore, obs), run(JStore, jobs)
    assert tc == jc
    assert tc["tiered.fetch.rows"] == 2 + 3 and tc["tiered.fetch.dedup_rows"] == 6 + 3
    assert th == jh


@pytest.mark.parametrize("depth", [1, 7, 64, None])
def test_fetch_depth_is_result_invariant(data, depth):
    rows = np.random.default_rng(21).integers(0, N, size=200).astype(np.int32)
    np.testing.assert_array_equal(HostVectorStore(data, fetch_depth_rows=depth).gather_rows(rows),
                                  data[rows])


def test_fetch_depth_validated(data):
    with pytest.raises(LogicError):
        HostVectorStore(data, fetch_depth_rows=0)


@pytest.mark.parametrize("readahead", [True, False])
def test_mmap_readahead_counted_and_opted_out(tmp_path, data, readahead):
    import mmap as mmap_mod

    if readahead and not hasattr(mmap_mod, "MADV_WILLNEED"):
        pytest.skip("madvise(MADV_WILLNEED) unavailable on this platform")
    path = str(tmp_path / "vectors.bin")
    HostVectorStore.save(path, data)
    rows = np.random.default_rng(22).integers(0, N, size=100).astype(np.int32)
    got = {}

    def run():
        got["t"] = HostVectorStore.open(path, fetch_depth_rows=16,
                                        readahead=readahead).gather_rows(rows)

    snap = _counters(run)
    jsnap = _counters(lambda: JStore.open(path, fetch_depth_rows=16,
                                          readahead=readahead).gather_rows(rows), jobs)
    np.testing.assert_array_equal(got["t"], data[rows])
    assert (snap["counters"].get("tiered.fetch.readahead_ranges", 0) > 0) == readahead
    assert snap["counters"] == jsnap["counters"]


def test_fault_context_targets_one_store(data):
    healthy = HostVectorStore(data[:100], fault_context={"shard": 0})
    doomed = HostVectorStore(data[:100], fault_context={"shard": 1})
    rows = np.arange(10, dtype=np.int32)
    with faults.injected("host.fetch", error=OSError("host down"), match={"shard": 1}):
        np.testing.assert_array_equal(healthy.gather_rows(rows), data[:10])
        with pytest.raises(HostFetchError):
            doomed.gather_rows(rows)


# -- the host.fetch seam ----------------------------------------------------------------


def _tiered(family, data, name="nibble"):
    algo, _, ti, _, tsp = family(name)
    return TieredIndex(algo, ti, HostVectorStore(data), refine_ratio=RATIO, micro_batch=MB,
                       search_params=tsp)


def test_fetch_latency_leaves_results_unchanged(family, data, queries):
    tt = _tiered(family, data)
    want = tt.search(queries, K)
    with faults.injected("host.fetch", latency_s=0.01):
        assert_equal(tt.search(queries, K, overlap=True), want)


def test_transient_fetch_fault_is_retried_as_in_jax(family, data, queries):
    tt = _tiered(family, data)
    want = tt.search(queries[:100], K)
    spec = dict(error=OSError("page fault storm"), trigger="first_n", first_n=2)
    with faults.injected("host.fetch", **spec):
        snap = _counters(lambda: assert_equal(tt.search(queries[:100], K), want))
    algo, ji, _, jsp, _ = family("nibble")
    jt = JTiered(algo, ji, JStore(data), refine_ratio=RATIO, micro_batch=MB, search_params=jsp)
    with jfaults.injected("host.fetch", **spec):
        jsnap = _counters(lambda: jt.search(queries[:100], K), jobs)
    keys = ("retry.recovered", "retry.attempts_failed")
    assert ({k: v for k, v in snap["counters"].items() if k.startswith(keys)}
            == {k: v for k, v in jsnap["counters"].items() if k.startswith(keys)})


def test_permanent_fetch_fault_raises_host_fetch_error(family, data, queries):
    tt = _tiered(family, data)
    with faults.injected("host.fetch", error=OSError("dead disk")):
        with pytest.raises(HostFetchError) as ei:
            tt.search(queries[:32], K)
    assert ei.value.attempts == 3 and "rows=" in str(ei.value)


def test_tiered_obs_names_as_jax(family, data, queries):
    """The JAX names: ``tiered.search.{calls,queries}``, the fetch
    counters and histogram, the overlap gauge, and the spans."""
    algo, ji, _, jsp, _ = family("nibble")
    tt = _tiered(family, data)
    jt = JTiered(algo, ji, JStore(data), refine_ratio=RATIO, micro_batch=MB, search_params=jsp)
    spans = {}

    def run(o, t, key):
        t.search(queries, K)
        spans[key] = {s["name"] for s in o.registry().spans()}

    snap = _counters(lambda: run(obs, tt, "t"))
    jsnap = _counters(lambda: run(jobs, jt, "j"), jobs)

    def names(s):
        return {k for k in s if k.startswith(("tiered.", "host."))}

    assert names(snap["counters"]) == names(jsnap["counters"])
    assert snap["counters"]['tiered.search.calls{algo="ivf_pq"}'] == 1
    assert snap["counters"]["tiered.search.queries"] == len(queries)
    assert names(snap["histograms"]) == names(jsnap["histograms"])
    assert 0.0 <= snap["gauges"]["tiered.overlap_efficiency"] <= 1.0
    want = {"tiered.search", "tiered.refine", "host.fetch"}
    assert want <= spans["t"] and want <= spans["j"]


# -- the engine's placement -------------------------------------------------------------


def _engine(family, data, budget, **kw):
    algo, _, ti, _, tsp = family("nibble")
    eng = ServingEngine(max_batch=32, max_wait_ms=0.0, res=CPU, hbm_budget_bytes=budget, **kw)
    eng.register("a", "ivf_pq", ti, params=tsp, dataset=torch.from_numpy(data))
    return eng, ti, tsp


def _served(eng, index_id, q, rows=13):
    futs = eng.submit_many(index_id, q, K, request_rows=rows)
    eng.run_until_idle()
    return [f.result() for f in futs]


def test_over_budget_registration_serves_tiered_with_resident_bits(family, data, queries):
    _, _, ti, _, tsp = family("nibble")
    res = residency_for_index("a", "ivf_pq", ti, refine_rows=N)
    budget = int((res.required_bytes + res.optional_bytes // 2) / 0.9)
    snap = {}

    def run():
        snap["eng"] = _engine(family, data, budget)[0]
        snap["out"] = _served(snap["eng"], "a", queries[:64])

    counters = _counters(run)["counters"]
    eng = snap["eng"]
    assert is_host_dataset(eng._indexes["a"].dataset) and eng.placement.spilled("a")
    assert eng.placement.tier("a", "raw_vectors") == "host"
    assert counters['serve.tiered_degrades{algo="ivf_pq",index_id="a"}'] == 1
    assert counters["tiered.fetch.rows"] > 0
    resident_eng = ServingEngine(max_batch=32, max_wait_ms=0.0, res=CPU)
    resident_eng.register("a", "ivf_pq", ti, params=tsp, dataset=torch.from_numpy(data))
    for got, want in zip(snap["out"], _served(resident_eng, "a", queries[:64])):
        np.testing.assert_array_equal(got.indices, want.indices)
        np.testing.assert_array_equal(got.distances, want.distances)
    # the JAX engine spills the same registration at the same budget
    _, ji, _, jsp, _ = family("nibble")
    jeng = JEngine(max_batch=32, hbm_budget_bytes=budget)
    jeng.register("a", "ivf_pq", ji, params=jsp, dataset=data)
    assert jeng.placement.tier("a", "raw_vectors") == "host"


def test_under_budget_registration_stays_resident(family, data):
    _, _, ti, _, _ = family("nibble")
    res = residency_for_index("a", "ivf_pq", ti, refine_rows=N)
    eng, _, _ = _engine(family, data, int(res.total_bytes / 0.9) + (1 << 20))
    assert isinstance(eng._indexes["a"].dataset, torch.Tensor)
    assert not eng.placement.spilled("a")
    assert eng._tier_label(eng._indexes["a"]) == "resident"


def test_infeasible_budget_fails_typed(family, data):
    with pytest.raises(LogicError, match="scan-resident"):
        _engine(family, data, 1024)


def test_fleet_plan_spills_the_second_registration(family, data):
    """A second index joins the fleet: the budget left after the first
    one's resident slab spills the second's."""
    _, _, ti, _, tsp = family("nibble")
    _, _, fi, _, fsp = family("ivf_flat")
    a = residency_for_index("a", "ivf_pq", ti, refine_rows=N)
    b = residency_for_index("b", "ivf_flat", fi, refine_rows=N)
    budget = int((a.total_bytes + b.required_bytes + N * DIM) / 0.9)
    eng, _, _ = _engine(family, data, budget)
    assert eng.placement.tier("a", "raw_vectors") == "device"
    eng.register("b", "ivf_flat", fi, params=fsp, dataset=torch.from_numpy(data))
    assert is_host_dataset(eng._indexes["b"].dataset)
    assert set(eng.placement.tiers) == {"a", "b"}


def test_register_a_prebuilt_tiered_index(family, data, queries):
    algo, _, ti, _, tsp = family("nibble")
    tt = TieredIndex(algo, ti, HostVectorStore(data), refine_ratio=RATIO, micro_batch=32,
                     search_params=tsp)
    eng = ServingEngine(max_batch=32, max_wait_ms=0.0, res=CPU)
    eng.register("t", "tiered", tt)
    eng.warmup("t", K)
    out = _served(eng, "t", queries[:32], rows=32)[0]
    want = resident(algo, ti, tsp, queries[:32], data)
    np.testing.assert_array_equal(out.indices, want[1].numpy())
    np.testing.assert_array_equal(out.distances, want[0].numpy())
    assert eng._tier_label(eng._indexes["t"]) == "tiered"


@pytest.mark.parametrize("spill", [False, True])
def test_sharded_registration_under_a_budget(family, data, spill):
    """Where the per-shard plan keeps the slab on the device the sharded
    registration stands; where it moves the slab off the device the
    registration converts to ``tiered_sharded``, as the JAX engine's does
    (the spill case raised before the sharded host tier was ported)."""
    _, ji, ti, _, _ = family("ivf_flat")
    mesh = make_mesh(["cpu"] * 4)
    res = residency_for_index("s", "ivf_flat", ti, refine_rows=N)
    req = sum(c.per_shard_bytes(4) for c in res.components if c.required)
    budget = int(req / 0.9) + 1024 if spill else int(res.total_bytes / 0.9)
    eng = ServingEngine(max_batch=32, max_wait_ms=0.0, res=CPU, hbm_budget_bytes=budget)
    jmesh = jmake_mesh(jax.devices()[:4])
    jeng = JEngine(max_batch=32, hbm_budget_bytes=budget)
    jeng.register("s", "sharded_ivf_flat", ji, mesh=jmesh, dataset=data)
    assert jeng._indexes["s"].algo == ("tiered_sharded" if spill else "sharded_ivf_flat")
    if spill:
        eng.register("s", "sharded_ivf_flat", ti, mesh=mesh, dataset=torch.from_numpy(data))
        reg, jreg = eng._indexes["s"], jeng._indexes["s"]
        assert (reg.algo, reg.dataset, reg.mode) == (jreg.algo, None, jreg.mode)
        assert type(reg.index).__name__ == type(jreg.index).__name__ == "TieredShardedIndex"
        assert (reg.index.algo, reg.index.refine_ratio) == (jreg.index.algo, jreg.index.refine_ratio)
        assert eng.sharded_placements["s"].tier("s", "raw_vectors") == \
            jeng.sharded_placements["s"].tier("s", "raw_vectors") != "device"
        assert eng._tier_label(reg) == jeng._tier_label(jreg) == "tiered_sharded"
    else:
        eng.register("s", "sharded_ivf_flat", ti, mesh=mesh, dataset=torch.from_numpy(data))
        assert eng.sharded_placements["s"].tier("s", "raw_vectors") == "device"
        assert eng._tier_label(eng._indexes["s"]) == "resident"
