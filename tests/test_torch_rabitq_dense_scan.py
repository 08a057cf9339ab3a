"""RaBitQ's dense scan (``ivf_pq.search(mode="scan")`` on a RaBitQ index,
``rabitq_scan_core``) against raft_tpu's, and ``auto`` on a CPU RaBitQ index.

2,048 rows of 32 dimensions (numpy seed), indexes built by raft_tpu with
``pq_bits=1``, saved and loaded into the port. Tolerance: ids equal,
distances allclose(rtol=1e-5, atol=1e-4). ``auto`` on a CPU index takes the
dense scan from 128 queries and the probe path below, in both packages,
with the planner's gate on and off; the port's ``auto`` is bit-equal to its
explicit mode. The chunking of the scan does not change its result.
"""
import io

import numpy as np
import pytest
import torch

from raft_tpu import obs as jobs
from raft_tpu import plan as jplan
from raft_tpu.core.bitset import Bitset as JBitset
from raft_tpu.neighbors import ivf_pq as jpq
from raft_tpu_torch import obs, plan
from raft_tpu_torch.core.bitset import Bitset as TBitset
from raft_tpu_torch.neighbors import ivf_common
from raft_tpu_torch.neighbors import ivf_pq as tpq

N, D, N_LISTS, K, N_PROBES = 2048, 32, 32, 10, 6
BUCKETS = (1, 4, 32, 127, 128, 512, 1024)


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(17)
    centers = rng.normal(size=(40, D)).astype(np.float32) * 2
    x = (centers[rng.integers(0, 40, N)] + rng.normal(size=(N, D))).astype(np.float32)
    q = (centers[rng.integers(0, 40, 1024)] + rng.normal(size=(1024, D))).astype(np.float32)
    return x, q


@pytest.fixture(scope="module")
def pair(corpus):
    built = {}

    def get(metric="sqeuclidean"):
        if metric not in built:
            ji = jpq.build(corpus[0], jpq.IvfPqIndexParams(n_lists=N_LISTS, pq_bits=1,
                                                           kmeans_n_iters=5, metric=metric))
            buf = io.BytesIO()
            jpq.save(ji, buf)
            buf.seek(0)
            built[metric] = (ji, tpq.load(buf, device="cpu"))
        return built[metric]

    return get


def assert_equal_to_jax(td, ti, jd, ji):
    jd, ji = np.asarray(jd), np.asarray(ji)
    np.testing.assert_array_equal(ti.numpy(), ji)
    fin = np.isfinite(jd)
    assert np.array_equal(np.isfinite(td.numpy()), fin)
    np.testing.assert_allclose(td.numpy()[fin], jd[fin], rtol=1e-5, atol=1e-4)


def filter_bits(seed=3):
    keep = np.random.default_rng(seed).random(N) < 0.6
    return keep


@pytest.mark.parametrize("metric", ["sqeuclidean", "euclidean", "inner_product"])
@pytest.mark.parametrize("with_filter", [False, True])
def test_scan_matches_jax(corpus, pair, metric, with_filter):
    _, q = corpus
    ji, ti = pair(metric)
    kw_j = kw_t = {}
    if with_filter:
        keep = filter_bits()
        kw_j = dict(prefilter=JBitset.from_mask(keep))
        kw_t = dict(prefilter=TBitset.from_mask(torch.from_numpy(keep)))
    jd, jidx = jpq.search(ji, q[:96], K, jpq.IvfPqSearchParams(n_probes=N_PROBES, refine_ratio=1),
                          mode="scan", **kw_j)
    td, tidx = tpq.search(ti, torch.from_numpy(q[:96]), K,
                          tpq.IvfPqSearchParams(n_probes=N_PROBES, refine_ratio=1), mode="scan",
                          **kw_t)
    assert_equal_to_jax(td, tidx, jd, jidx)
    if with_filter:
        assert bool(np.all(keep[tidx.numpy()[tidx.numpy() >= 0]]))


def test_scan_padded_tail_matches_jax(corpus, pair):
    """Batches of 40 over 96 queries: a zero-padded tail in both packages."""
    _, q = corpus
    ji, ti = pair()
    jd, jidx = jpq.search(ji, q[:96], K, jpq.IvfPqSearchParams(n_probes=N_PROBES, refine_ratio=1),
                          mode="scan", query_batch=40)
    td, tidx = tpq.search(ti, torch.from_numpy(q[:96]), K,
                          tpq.IvfPqSearchParams(n_probes=N_PROBES, refine_ratio=1), mode="scan",
                          query_batch=40)
    assert_equal_to_jax(td, tidx, jd, jidx)


def test_scan_with_refine_matches_jax(corpus, pair):
    x, q = corpus
    ji, ti = pair()
    jd, jidx = jpq.search(ji, q[:64], K, jpq.IvfPqSearchParams(n_probes=N_PROBES), mode="scan",
                          dataset=x)
    td, tidx = tpq.search(ti, torch.from_numpy(q[:64]), K, tpq.IvfPqSearchParams(n_probes=N_PROBES),
                          mode="scan", dataset=torch.from_numpy(x))
    assert_equal_to_jax(td, tidx, jd, jidx)


def test_chunking_does_not_change_the_scan(corpus, pair, monkeypatch):
    """One list a chunk, and all lists in one chunk, give the same bits."""
    _, q = corpus
    _, ti = pair()
    qt = torch.from_numpy(q[:64])
    p = tpq.IvfPqSearchParams(n_probes=N_PROBES, refine_ratio=1)
    want = tpq.search(ti, qt, K, p, mode="scan")
    # the chunk's scratch stays under the budget: bits, products and scores
    g = tpq.rabitq_scan_chunk_lists(1024, 1152, 128, 1024)
    assert 1024 % g == 0 and g * 1152 * (4 * 128 + 8 * 1024) <= tpq.RABITQ_SCAN_CHUNK_BYTES
    for g in (1, N_LISTS):
        monkeypatch.setattr(tpq, "rabitq_scan_chunk_lists", lambda *a, _g=g: _g)
        got = tpq.search(ti, qt, K, p, mode="scan")
        assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])


@pytest.mark.parametrize("gate", ["1", "0"])
def test_auto_on_a_cpu_index_matches_jax(corpus, pair, monkeypatch, gate):
    monkeypatch.setenv("RAFT_TPU_PLAN", gate)
    _, q = corpus
    ji, ti = pair()
    for rows in BUCKETS:
        jd, jidx = jpq.search(ji, q[:rows], K, jpq.IvfPqSearchParams(n_probes=N_PROBES,
                                                                       refine_ratio=1))
        p = tpq.IvfPqSearchParams(n_probes=N_PROBES, refine_ratio=1)
        auto = tpq.search(ti, torch.from_numpy(q[:rows]), K, p)
        assert_equal_to_jax(auto[0], auto[1], jd, jidx)
        mode = "scan" if rows >= 128 else "probe"
        assert ivf_common.auto_search_mode(ti.device, rows, True, algo="ivf_pq") == mode
        want = tpq.search(ti, torch.from_numpy(q[:rows]), K, p, mode=mode)
        assert torch.equal(auto[1], want[1]) and torch.equal(auto[0], want[0])


def test_planner_explain_matches_jax():
    """The planner's search-mode decision for a CPU RaBitQ index: scan
    eligible, the same choice and costs as JAX's off a TPU."""
    for nq in BUCKETS:
        ok, reason = ivf_common.auto_scan(torch.device("cpu"))
        t = plan.plan_search_mode("ivf_pq", nq, on_cuda=False, fused_ok=True, scan_ok=ok,
                                  scan_reason=reason)
        j = jplan.plan_search_mode("ivf_pq", nq, on_tpu=False, fused_ok=True)
        assert t.choice == j.choice == ("scan" if nq >= 128 else "probe")
        assert [(c.name, c.eligible, c.cost) for c in t.candidates] == [
            (c.name, c.eligible, c.cost) for c in j.candidates]
        text = t.explain()
        assert "x fused" in text and "ineligible" in text and "- scan" in text


def test_scan_records_the_rabitq_xla_span(corpus, pair):
    """The scan's counters and spans as JAX's: ``ivf_pq.search.calls
    {mode=scan, lut=rabitq}`` and the same spans at the same depths: the
    ``rabitq_xla`` span under the search."""
    _, q = corpus
    ji, ti = pair("inner_product")
    names = []
    for mod, run in ((jobs, lambda: jpq.search(ji, q[:77], K, jpq.IvfPqSearchParams(
            n_probes=N_PROBES, refine_ratio=1), mode="scan")),
                     (obs, lambda: tpq.search(ti, torch.from_numpy(q[:77]), K,
                                              tpq.IvfPqSearchParams(n_probes=N_PROBES,
                                                                    refine_ratio=1),
                                              mode="scan"))):
        reg = mod.registry()
        reg.reset()
        mod.enable()
        try:
            run()
            snap = reg.as_dict()
            spans = {(sp["name"], sp["depth"]) for sp in reg.spans()}
        finally:
            mod.disable()
            reg.reset()
        assert snap["counters"]['ivf_pq.search.calls{lut="rabitq",mode="scan"}'] == 1.0
        names.append(spans)
    assert ("ivf_pq.search.rabitq_xla", 1) in names[1]
    assert names[0] == names[1]
