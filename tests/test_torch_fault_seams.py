"""The six fault seams the port fires, each against raft_tpu's.

``pallas.pq_scan`` (before B2 and B3), ``pallas.cagra_search`` (before each
B4 batch), ``comms.ring_topk`` (``kind="scan"`` on the scan ring),
``comms.all_gather``, ``serialize.load`` and ``sharded_ann.shard_scan``
(the health probe). For each point the same spec is installed in both
packages, the same call is made on the CPU, and the outcome must be the
same: the same typed error (or the same answer), and the same
``faults.fired{point,kind}`` count.

Where they differ, by design: the JAX package falls back after a failure
of a fused kernel in ``mode="auto"`` (to ``scan`` / ``xla``) and after a
failed ring (to the gather merge); the port has no fallback and raises.
Those cases, named ``..._is_the_no_fallback_difference``, assert JAX's
fallback and the port's error side by side. JAX's ``auto`` takes a fused kernel only on a TPU, so
those cases make JAX believe it is on one (``jax.default_backend``), as
the JAX package's own tests do, and make the port's ``auto`` choose
``fused`` as it does on a CUDA index.

The JAX comms seams fire while a ``shard_map`` body is traced: every JAX
call here traces a new program (a fresh ``jax.jit``), so they fire on every
call. Meshes of two shards keep clear of the JAX sharded programs other
files cache.
"""
import functools
import io
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from raft_tpu import obs as jobs
from raft_tpu.core import errors as jerrors
from raft_tpu.neighbors import brute_force as jbf
from raft_tpu.neighbors import cagra as jcagra
from raft_tpu.neighbors import ivf_flat as jflat
from raft_tpu.neighbors import ivf_pq as jpq
from raft_tpu.ops.pallas import ring_topk as jrt
from raft_tpu.parallel import comms as jcomms
from raft_tpu.parallel import make_mesh as jmake_mesh
from raft_tpu.parallel._compat import shard_map
from raft_tpu.parallel.sharded_ann import sharded_ivf_flat_search as j_sharded_flat
from raft_tpu.robust import degrade as jdegrade
from raft_tpu.robust import faults as jfaults
from raft_tpu_torch import obs as tobs
from raft_tpu_torch.core import errors as terrors
from raft_tpu_torch.core.resources import Resources
from raft_tpu_torch.neighbors import brute_force as tbf
from raft_tpu_torch.neighbors import cagra as tcagra
from raft_tpu_torch.neighbors import ivf_common as tcommon
from raft_tpu_torch.neighbors import ivf_flat as tflat
from raft_tpu_torch.neighbors import ivf_pq as tpq
from raft_tpu_torch.ops import ring_topk as trt
from raft_tpu_torch.parallel import comms as tcomms
from raft_tpu_torch.parallel import make_mesh, sharded_ivf_flat_search
from raft_tpu_torch.robust import degrade as tdegrade
from raft_tpu_torch.robust import faults as tfaults

N, D, NQ, K = 1500, 32, 24, 7


@pytest.fixture
def both():
    """Both packages' obs registries empty and enabled, both fault
    registries empty; restored after."""
    for o in (jobs, tobs):
        o.registry().reset()
        o.enable()
    yield
    for o, f in ((jobs, jfaults), (tobs, tfaults)):
        o.disable()
        o.registry().reset()
        f.clear()
        f.disable()


def fired(o) -> dict:
    return {k: v for k, v in o.registry().as_dict()["counters"].items()
            if k.startswith("faults.fired")}


def assert_same_fired(expected: dict):
    assert fired(jobs) == fired(tobs) == expected


def jax_fell_back(algo: str) -> float:
    """JAX's fallback count for ``algo`` (its warning is once a process, so
    the count, not the warning, says that this call fell back)."""
    key = f'fallbacks{{algo="{algo}",reason="KernelFailure"}}'
    return jobs.registry().as_dict()["counters"].get(key, 0.0)


class inject:
    """The same spec in both packages (errors made per package)."""

    def __init__(self, point, error=None, **kw):
        self.specs = [(f, point, error(e) if error else None, kw)
                      for f, e in ((jfaults, jerrors), (tfaults, terrors))]

    def __enter__(self):
        for f, point, err, kw in self.specs:
            f.enable()
            f.install(point, err, **kw)
        return self

    def __exit__(self, *exc):
        for f, *_ in self.specs:
            f.clear()
            f.disable()
        return False


def kernel_failure(e):
    return e.KernelFailure("chaos")


def _load(jmod, tmod, index, **kw):
    buf = io.BytesIO()
    jmod.save(index, buf)
    buf.seek(0)
    return tmod.load(buf, device="cpu", **kw)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(12)
    centers = rng.normal(size=(20, D)).astype(np.float32) * 3
    x = (centers[rng.integers(0, 20, N)] + rng.normal(size=(N, D))).astype(np.float32)
    q = (centers[rng.integers(0, 20, NQ)] + rng.normal(size=(NQ, D))).astype(np.float32)
    return x, q


@pytest.fixture(scope="module")
def pq_pair(data):
    ji = jpq.build(data[0], jpq.IvfPqIndexParams(n_lists=8, pq_dim=8, kmeans_n_iters=4))
    return ji, _load(jpq, tpq, ji)


@pytest.fixture(scope="module")
def rabitq_pair(data):
    ji = jpq.build(data[0], jpq.IvfPqIndexParams(n_lists=8, pq_bits=1, kmeans_n_iters=4))
    return ji, _load(jpq, tpq, ji)


@pytest.fixture(scope="module")
def cagra_pair(data):
    graph = np.random.default_rng(3).integers(0, N, (N, 16)).astype(np.int32)
    return jcagra.from_graph(data[0], graph), tcagra.from_graph(data[0], graph, device="cpu")


# -- pallas.pq_scan / pallas.cagra_search -----------------------------------------------


@pytest.mark.parametrize("which", ["pq", "rabitq"])
def test_pq_scan_seam_raises_in_explicit_fused_mode(both, data, pq_pair, rabitq_pair, which):
    """Explicit ``mode="fused"``: both packages raise the injected error
    before B2 (PQ codes) or B3 (RaBitQ), and count one firing."""
    ji, ti = pq_pair if which == "pq" else rabitq_pair
    q = data[1]
    sp = dict(n_probes=3)
    with inject("pallas.pq_scan", kernel_failure):
        with pytest.raises(jerrors.KernelFailure):
            jpq.search(ji, q, K, jpq.IvfPqSearchParams(**sp), mode="fused")
        with pytest.raises(terrors.KernelFailure):
            tpq.search(ti, q, K, tpq.IvfPqSearchParams(**sp), mode="fused")
    assert_same_fired({'faults.fired{kind="KernelFailure",point="pallas.pq_scan"}': 1.0})


def test_pq_scan_seam_in_auto_mode_is_the_no_fallback_difference(both, data, pq_pair,
                                                                 monkeypatch):
    """``auto`` where it takes B2 (JAX: on a TPU; the port: on a CUDA
    index): JAX falls back to its scan and answers as ``mode="scan"``; the
    port raises (no fallback, by design). Both fired once."""
    ji, ti = pq_pair
    q = np.concatenate([data[1]] * 6)[:128]  # auto takes fused from 128 queries
    sp = jpq.IvfPqSearchParams(n_probes=3)
    _, want = jpq.search(ji, q, K, sp, mode="scan")
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(tcommon, "auto_search_mode", lambda *a, **kw: "fused")
    with inject("pallas.pq_scan", kernel_failure), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _, got = jpq.search(ji, q, K, sp, mode="auto")
        with pytest.raises(terrors.KernelFailure):
            tpq.search(ti, q, K, tpq.IvfPqSearchParams(n_probes=3), mode="auto")
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert jax_fell_back("ivf_pq") == 1.0
    assert_same_fired({'faults.fired{kind="KernelFailure",point="pallas.pq_scan"}': 1.0})


def test_auto_on_a_cpu_index_reaches_no_kernel_seam(both, data, pq_pair, cagra_pair):
    """On the CPU both packages' ``auto`` takes the scan / xla path, so a
    kernel seam's spec never fires and the answers are the uninjected
    ones."""
    (jp, tp), (jc, tc) = pq_pair, cagra_pair
    q = data[1]
    want = tpq.search(tp, q, K, n_probes=3)[1], tcagra.search(tc, q, K)[1]
    with inject("pallas.pq_scan", kernel_failure), inject("pallas.cagra_search", kernel_failure):
        jpq.search(jp, q, K, n_probes=3)
        jcagra.search(jc, q, K)
        got = tpq.search(tp, q, K, n_probes=3)[1], tcagra.search(tc, q, K)[1]
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert_same_fired({})


def test_cagra_seam_raises_in_explicit_fused_mode(both, data, cagra_pair):
    """Explicit ``mode="fused"``: the seam fires before the first B4 batch
    in both packages, with the batch's ``nq`` in its context (a spec
    matching another ``nq`` does not fire)."""
    jc, tc = cagra_pair
    q = data[1]
    with inject("pallas.cagra_search", kernel_failure, match={"nq": NQ}):
        with pytest.raises(jerrors.KernelFailure):
            jcagra.search(jc, q, K, mode="fused")
        with pytest.raises(terrors.KernelFailure):
            tcagra.search(tc, q, K, mode="fused")
    with inject("pallas.cagra_search", kernel_failure, match={"nq": NQ + 1}):
        tcagra.search(tc, q, K, mode="fused")
    assert_same_fired({'faults.fired{kind="KernelFailure",point="pallas.cagra_search"}': 1.0})


def test_cagra_seam_in_auto_mode_is_the_no_fallback_difference(both, data, cagra_pair,
                                                               monkeypatch):
    """JAX on a "TPU" falls back to xla after the injected failure and
    answers as ``mode="xla"``; the port's fused batch raises (no fallback, by design),
    which is what its ``auto`` runs on a CUDA index."""
    jc, tc = cagra_pair
    q = data[1]
    _, want = jcagra.search(jc, q, K, mode="xla")
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    with inject("pallas.cagra_search", kernel_failure), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _, got = jcagra.search(jc, q, K, mode="auto")
        with pytest.raises(terrors.KernelFailure):
            tcagra.search(tc, q, K, mode="fused")
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert jax_fell_back("cagra") == 1.0
    assert_same_fired({'faults.fired{kind="KernelFailure",point="pallas.cagra_search"}': 1.0})


# -- comms.all_gather ----------------------------------------------------------------------


def jax_allgather(n, x):
    mesh = jmake_mesh(jax.devices()[:n])
    prog = shard_map(lambda xs: jcomms.allgather(xs), mesh=mesh, in_specs=(P("data"),),
                     out_specs=P(None, "data"), check_vma=False)
    return jax.jit(prog)(jnp.asarray(x))


def test_all_gather_seam(both):
    """An error spec raises from both packages' ``allgather`` (JAX while it
    traces); a latency spec fires and the gathered blocks are JAX's."""
    x = np.arange(2 * 6, dtype=np.float32).reshape(2, 6)
    mesh = make_mesh(["cpu"] * 2)
    xs = [torch.from_numpy(x[r : r + 1]) for r in range(2)]
    with inject("comms.all_gather", kernel_failure, match={"axis": "data"}):
        with pytest.raises(jerrors.KernelFailure):
            jax_allgather(2, x)
        with pytest.raises(terrors.KernelFailure):
            tcomms.allgather(mesh, xs)
    with inject("comms.all_gather", latency_s=0.001):
        want = np.asarray(jax_allgather(2, x))
        got = tcomms.allgather(mesh, xs)
    for r in range(2):
        np.testing.assert_array_equal(got[r][:, 0].numpy(), want[:, r])
    assert_same_fired({'faults.fired{kind="KernelFailure",point="comms.all_gather"}': 1.0,
                       'faults.fired{kind="latency",point="comms.all_gather"}': 1.0})


def test_gather_merge_fires_no_all_gather_seam(both, data):
    """The sharded search's gather merge runs the raw collective in both
    packages (JAX's ``lax.all_gather``): an ``all_gather`` spec leaves it
    alone."""
    ji = jflat.build(data[0], jflat.IvfFlatIndexParams(n_lists=8))
    ti = _load(jflat, tflat, ji)
    with inject("comms.all_gather", kernel_failure):
        j_sharded_flat(jmake_mesh(jax.devices()[:2]), ji, data[1], K, n_probes=3,
                       merge_mode="gather")
        sharded_ivf_flat_search(make_mesh(["cpu"] * 2), ti, data[1], K, n_probes=3,
                                merge_mode="gather")
    assert_same_fired({})


# -- comms.ring_topk -----------------------------------------------------------------------


def shard_tiles(n, nq, kc, seed):
    rng = np.random.default_rng(seed)
    vs = rng.random((n, nq, kc), dtype=np.float32)
    ins = rng.permutation(n * nq * kc).reshape(n, nq, kc).astype(np.int32)
    return vs, ins


def jax_ring(n, vs, ins, k, scan=False):
    mesh = jmake_mesh(jax.devices()[:n])
    fn = jrt.scan_ring_topk if scan else jrt.ring_topk

    @functools.partial(shard_map, mesh=mesh, in_specs=(P("data"), P("data")),
                       out_specs=(P(), P()))
    def prog(vb, ib):
        return fn(vb[0], ib[0], k, select_min=True, axis="data", use_fused=False)

    return jax.jit(prog)(jnp.asarray(vs), jnp.asarray(ins))


@pytest.mark.parametrize("scan", [False, True])
def test_ring_seam_raises_from_either_ring(both, scan):
    """A spec with no match fires on both rings of both packages and
    raises; one matching ``kind="scan"`` fires on the scan ring only."""
    n, nq, kc = 2, 9, 12 if scan else K
    vs, ins = shard_tiles(n, nq, kc, 5)
    mesh = make_mesh(["cpu"] * n)
    tv, ti = [torch.from_numpy(v) for v in vs], [torch.from_numpy(i) for i in ins]
    tring = functools.partial(trt.scan_ring_topk if scan else trt.ring_topk, mesh, tv, ti, K)
    with inject("comms.ring_topk", kernel_failure, match={"n_shards": n}):
        with pytest.raises(jerrors.KernelFailure):
            jax_ring(n, vs, ins, K, scan)
        with pytest.raises(terrors.KernelFailure):
            tring()
    with inject("comms.ring_topk", kernel_failure, match={"kind": "scan"}):
        if scan:
            with pytest.raises(jerrors.KernelFailure):
                jax_ring(n, vs, ins, K, scan)
            with pytest.raises(terrors.KernelFailure):
                tring()
        else:
            jv, ji = jax_ring(n, vs, ins, K, scan)
            v, i = tring()
            np.testing.assert_array_equal(i[0].numpy(), np.asarray(ji))
            np.testing.assert_array_equal(v[0].numpy(), np.asarray(jv))
    assert_same_fired({'faults.fired{kind="KernelFailure",point="comms.ring_topk"}':
                       2.0 if scan else 1.0})


@pytest.mark.parametrize("merge_mode", ["ring", "fused_ring"])
def test_ring_seam_in_sharded_search_is_the_no_fallback_difference(both, data, merge_mode):
    """Sharded search over a failing ring: JAX falls back to the gather
    merge and answers as ``merge_mode="gather"``; the port raises
    (no fallback, by design). Both fired once."""
    ji = jflat.build(data[0], jflat.IvfFlatIndexParams(n_lists=8))
    ti = _load(jflat, tflat, ji)
    jmesh = jmake_mesh(jax.devices()[:2])
    _, want = j_sharded_flat(jmesh, ji, data[1], K, n_probes=3, merge_mode="gather")
    with inject("comms.ring_topk", kernel_failure), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _, got = j_sharded_flat(jmesh, ji, data[1], K, n_probes=3, merge_mode=merge_mode)
        with pytest.raises(terrors.KernelFailure):
            sharded_ivf_flat_search(make_mesh(["cpu"] * 2), ti, data[1], K, n_probes=3,
                                    merge_mode=merge_mode)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert jax_fell_back("scan_ring_topk" if merge_mode == "fused_ring" else "ring_topk") == 1.0
    assert_same_fired({'faults.fired{kind="KernelFailure",point="comms.ring_topk"}': 1.0})


# -- serialize.load ------------------------------------------------------------------------


def test_serialize_load_seam(both, data):
    """The seam fires after the header parse with the snapshot's kind: a
    spec matching ``kind="brute_force"`` fails a brute-force load with the
    injected ``CorruptIndexError`` and leaves an IVF-Flat load alone."""
    jb = jbf.build(data[0][:64])
    jf = jflat.build(data[0], jflat.IvfFlatIndexParams(n_lists=8))
    blobs = {}
    for name, mod, idx in (("bf", jbf, jb), ("flat", jflat, jf)):
        buf = io.BytesIO()
        mod.save(idx, buf)
        blobs[name] = buf.getvalue()
    with inject("serialize.load", lambda e: e.CorruptIndexError("chaos"),
                match={"kind": "brute_force"}):
        with pytest.raises(jerrors.CorruptIndexError):
            jbf.load(io.BytesIO(blobs["bf"]))
        with pytest.raises(terrors.CorruptIndexError):
            tbf.load(io.BytesIO(blobs["bf"]), device="cpu")
        jflat.load(io.BytesIO(blobs["flat"]))
        ti = tflat.load(io.BytesIO(blobs["flat"]), device="cpu")
    assert ti.n_lists == 8
    assert_same_fired({'faults.fired{kind="CorruptIndexError",point="serialize.load"}': 1.0})


def test_serialize_load_seam_nth_trigger(both, data):
    """``trigger="nth"``: only the second load of each package fails."""
    buf = io.BytesIO()
    jbf.save(jbf.build(data[0][:64]), buf)
    blob = buf.getvalue()
    with inject("serialize.load", lambda e: e.CorruptIndexError("chaos"), trigger="nth", nth=1):
        outcomes = []
        for load, err in ((jbf.load, jerrors.CorruptIndexError),
                          (functools.partial(tbf.load, device="cpu"), terrors.CorruptIndexError)):
            got = []
            for _ in range(3):
                try:
                    load(io.BytesIO(blob))
                    got.append("ok")
                except err:
                    got.append("raised")
            outcomes.append(got)
    assert outcomes[0] == outcomes[1] == ["ok", "raised", "ok"]
    assert_same_fired({'faults.fired{kind="CorruptIndexError",point="serialize.load"}': 1.0})


# -- sharded_ann.shard_scan (the health probe) ---------------------------------------------


@pytest.mark.parametrize("spec, want", [
    (dict(error=lambda e: e.ShardFailure("chaos", shard=2), match={"shard": 2}),
     (True, True, False, True)),
    (dict(error=lambda e: e.ShardFailure("chaos"), trigger="first_n", first_n=2),
     (False, False, True, True)),
    (dict(latency_s=0.001, match={"shard": 1}), (True, True, True, True)),
])
def test_probe_seam_gives_jax_s_mask(both, spec, want):
    """The same spec gives the same health mask in both packages (the
    untimed probe ignores latency) and the same counts."""
    spec = dict(spec)
    err = spec.pop("error", None)
    with inject("sharded_ann.shard_scan", err, **spec):
        jmask = jdegrade.probe_shard_health(jmake_mesh(jax.devices()[:4]))
        tmask = tdegrade.probe_shard_health(make_mesh(["cpu"] * 4))
    assert jmask == tmask == want
    j, t = jobs.registry().as_dict()["counters"], tobs.registry().as_dict()["counters"]
    assert j == t


def test_probe_seam_lets_other_errors_through(both):
    with inject("sharded_ann.shard_scan", kernel_failure, match={"shard": 0}):
        with pytest.raises(jerrors.KernelFailure):
            jdegrade.probe_shard_health(jmake_mesh(jax.devices()[:2]))
        with pytest.raises(terrors.KernelFailure):
            tdegrade.probe_shard_health(make_mesh(["cpu"] * 2))
    assert_same_fired({'faults.fired{kind="KernelFailure",point="sharded_ann.shard_scan"}': 1.0})


# -- the gate --------------------------------------------------------------------------------


def test_a_disabled_registry_fires_nothing(both, data, pq_pair, cagra_pair):
    """Specs installed at all six points with injection off: every call
    answers as without them, and nothing is counted."""
    points = ("pallas.pq_scan", "pallas.cagra_search", "comms.ring_topk", "comms.all_gather",
              "serialize.load", "sharded_ann.shard_scan")
    (_, tp), (_, tc) = pq_pair, cagra_pair
    q = data[1]
    mesh = make_mesh(["cpu"] * 2)
    blob = io.BytesIO()
    tbf.save(tbf.build(data[0][:64], res=Resources(device="cpu")), blob)

    def run():
        return (tpq.search(tp, q, K, n_probes=3, mode="fused")[1],
                tcagra.search(tc, q, K, mode="fused")[1],
                trt.ring_topk(mesh, [torch.from_numpy(v) for v in shard_tiles(2, 5, K, 1)[0]],
                              [torch.from_numpy(i) for i in shard_tiles(2, 5, K, 1)[1]], K)[1][0],
                tcomms.allgather(mesh, [torch.ones(3), torch.zeros(3)])[0],
                tbf.load(io.BytesIO(blob.getvalue()), device="cpu").dataset,
                torch.tensor(tdegrade.probe_shard_health(mesh)))

    want = run()
    for p in points:
        tfaults.install(p, terrors.ShardFailure("armed but gated"))
    assert not tfaults.is_enabled()
    got = run()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert fired(tobs) == {}

