"""The port's instrumentation of IVF-Flat's fused search, on the CPU.

* ``obs.observe_device`` reads nothing until the registry is dumped, then
  gives plain ``observe``'s histogram, and its pending state stays fixed.
* ``obs.span`` is a ``torch.profiler`` range while obs is on, and its
  ``ts_ns`` is on the profiler's clock; off, it opens no range.
* The counters ``ivf_flat.fused.*`` equal counts made here from the plain
  tables: ``pairs_probed`` from ``probe_mask`` and the list sizes,
  ``pairs_scanned`` from the tile tables and the lists' filled chunks,
  ``probes_dropped`` from each query's probed lists against its tile's
  kept units.
* With obs on, the search gives the same bits and makes the same host
  reads as with it off; ``ivf_flat.search.host_reads`` counts one a call.
"""
import numpy as np
import pytest
import torch

from raft_tpu_torch import obs
from raft_tpu_torch.core.resources import Resources
from raft_tpu_torch.neighbors import ivf_flat
from raft_tpu_torch.obs.metrics import Registry
from raft_tpu_torch.ops import ivf_scan

N, D, NQ, LISTS, BATCH = 3000, 16, 300, 32, 128


@pytest.fixture
def obs_on():
    obs.registry().reset()
    obs.enable()
    try:
        yield obs.registry()
    finally:
        obs.disable()
        obs.registry().reset()


@pytest.fixture(scope="module")
def flat():
    rng = np.random.default_rng(7)
    centers = rng.normal(size=(48, D)).astype(np.float32) * 3
    x = torch.from_numpy(centers[rng.integers(0, 48, N)] + rng.normal(size=(N, D)).astype(np.float32))
    q = torch.from_numpy(centers[rng.integers(0, 48, NQ)] + rng.normal(size=(NQ, D)).astype(np.float32))
    index = ivf_flat.build(x, ivf_flat.IvfFlatIndexParams(n_lists=LISTS), res=Resources(device="cpu"))
    return index, q


def _params(n_probes=6, factor=8, group=2, qt=32):
    return ivf_flat.IvfFlatSearchParams(n_probes=n_probes, fused_qt=qt,
                                        fused_probe_factor=factor, fused_group=group)


def _batches(q):
    """The query batches ``search`` hands the fused scan: the tail padded
    with zero rows to ``BATCH``."""
    out = []
    for s in range(0, q.shape[0], BATCH):
        b = q[s : s + BATCH]
        out.append(torch.cat([b, torch.zeros((BATCH - b.shape[0], D))]))
    return out


def _tables(index, params, qc):
    return ivf_scan.fused_search_inputs(
        index.centers, index.center_rank, index.list_data, index.list_indices, index.list_norms,
        qc, None, n_probes=params.n_probes, metric=index.metric, qt=params.fused_qt,
        probe_factor=params.fused_probe_factor, group=ivf_flat.fused_group(index, params))


def _fused_sums(reg):
    h = reg.as_dict()["histograms"]
    return {name: h[f"ivf_flat.fused.{name}"]
            for name in ("pairs_probed", "pairs_scanned", "probes_dropped")}


# -- observe_device -------------------------------------------------------------------------


def _refuse(*a, **kw):
    raise AssertionError("a host read while observing")


def test_observe_device_reads_nothing_until_a_dump(obs_on, monkeypatch):
    reg = Registry()
    values = [0.25, 3.0, 7.5, 0.0, 250.0, 1e4, 2.5e6, 42.0]
    tensors = [torch.tensor(v, dtype=torch.float32) for v in values[:4]]
    tensors += [torch.tensor(int(v), dtype=torch.int64) for v in values[4:]]
    with monkeypatch.context() as m:
        for name in ("item", "tolist", "cpu"):
            m.setattr(torch.Tensor, name, _refuse)
        for t in tensors:
            reg.observe_device("dev", t)
    for v in values:
        reg.observe("host", v)
    h = reg.as_dict()["histograms"]
    assert h["dev"]["counts"] == h["host"]["counts"]
    assert h["dev"]["sum"] == h["host"]["sum"] == sum(values)
    assert h["dev"]["count"] == h["host"]["count"] == len(values)
    # a second dump reads nothing new; sample() sees the same totals
    assert reg.as_dict()["histograms"]["dev"] == h["dev"]
    (row,) = [r for r in reg.sample() if r[1] == "dev"]
    assert row[3] == (tuple(reg.histogram("dev").buckets), tuple(h["dev"]["counts"]),
                      h["dev"]["sum"], h["dev"]["count"])


def test_observe_device_state_does_not_grow(obs_on):
    reg = Registry()
    reg.observe_device("dev", torch.tensor(5))
    pending = reg.histogram("dev")._pending

    def state():
        return [(t.data_ptr(), t.numel()) for st in pending.values() for t in st]

    before = state()
    for i in range(200):
        reg.observe_device("dev", torch.tensor(i))
    assert len(pending) == 1 and state() == before
    assert reg.as_dict()["histograms"]["dev"]["count"] == 201
    assert state() == before


def test_observe_device_off_does_nothing():
    assert not obs.is_enabled()
    obs.registry().reset()
    obs.observe_device("dev", torch.tensor(1.0))
    assert obs.registry().as_dict()["histograms"] == {}


# -- spans on the profiler's clock ----------------------------------------------------------


def test_span_is_a_profiler_range_on_its_clock(obs_on):
    x = torch.randn(256, 256)
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(3):
            with obs.span("x"):
                torch.mm(x, x)
    events = prof.profiler.kineto_results.events()
    mm = [e for e in events if e.name() == "aten::mm"]
    spans = obs_on.spans("x")
    assert len(mm) == len(spans) == 3
    assert sum(e.name() == "x" for e in events) == 3
    for e, s in zip(sorted(mm, key=lambda e: e.start_ns()), spans):
        assert s["ts_ns"] - 50_000 <= e.start_ns()
        assert e.end_ns() <= s["ts_ns"] + s["dur_us"] * 1e3 + 50_000


def test_span_off_opens_no_range():
    assert not obs.is_enabled()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with obs.span("x"):
            torch.ones(4).sum()
    assert "x" not in {e.name() for e in prof.profiler.kineto_results.events()}
    assert obs.registry().spans("x") == []


# -- the fused path's counters -------------------------------------------------------------


def test_pairs_probed_and_scanned_match_the_plain_tables(flat, obs_on):
    index, q = flat
    params = _params()
    ivf_flat.search(index, q, 5, params, query_batch=BATCH, mode="fused")
    got = _fused_sums(obs_on)
    sizes = index.list_sizes.to(torch.int64)
    probed = scanned = 0
    for qc in _batches(q):
        mask = ivf_flat.probe_mask(index.centers, qc, params.n_probes, index.metric)
        probed += int(sum(int(sizes[row].sum()) for row in mask))
        fi = _tables(index, params, qc)
        for t in range(fi.tile_probes.shape[0]):
            units = {int(u) for u, v in zip(fi.tile_probes[t], fi.probe_valid[t]) if v > 0}
            for u in units:
                li = fi.list_indices[u]
                chunks = sum(bool((li[c : c + ivf_scan.ROWS_PER_CHUNK] >= 0).any())
                             for c in range(0, li.shape[0], ivf_scan.ROWS_PER_CHUNK))
                scanned += params.fused_qt * chunks * ivf_scan.ROWS_PER_CHUNK
    n_batches = len(_batches(q))
    assert got["pairs_probed"]["count"] == got["pairs_scanned"]["count"] == n_batches
    assert got["pairs_probed"]["sum"] == probed
    assert got["pairs_scanned"]["sum"] == scanned
    assert scanned > probed > 0


def _dropped_by_hand(index, params, q):
    group = ivf_flat.fused_group(index, params)
    dropped = 0
    for qc in _batches(q):
        mask = ivf_flat.probe_mask(index.centers, qc, params.n_probes, index.metric)
        fi = _tables(index, params, qc)
        for pos, row in enumerate(fi.order_pad[: qc.shape[0]].tolist()):
            t = pos // params.fused_qt
            kept = {int(u) for u, v in zip(fi.tile_probes[t], fi.probe_valid[t]) if v > 0}
            dropped += sum(int(lst) // group not in kept for lst in mask[row].nonzero().flatten())
    return dropped


@pytest.mark.parametrize("factor,group", [(LISTS // 6 + 1, 1), (1, 1), (1, 2)],
                         ids=["every_probe_kept", "drops", "drops_group2"])
def test_probes_dropped_is_the_count_by_hand(flat, obs_on, factor, group):
    index, q = flat
    params = _params(factor=factor, group=group)
    ivf_flat.search(index, q, 5, params, query_batch=BATCH, mode="fused")
    got = _fused_sums(obs_on)["probes_dropped"]["sum"]
    assert got == _dropped_by_hand(index, params, q)
    if factor * params.n_probes >= LISTS:
        assert got == 0
    else:
        assert got > 0


# -- the same program with obs on ----------------------------------------------------------

_READS = ("aten::_local_scalar_dense", "aten::item")


def _profiled_search(index, q, params):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        d, i = ivf_flat.search(index, q, 5, params, query_batch=BATCH, mode="fused")
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    return d, i, {r: names.count(r) for r in _READS}


def test_obs_changes_no_bit_and_no_host_read(flat):
    index, q = flat
    params = _params()
    d0, i0, reads0 = _profiled_search(index, q, params)
    obs.registry().reset()
    obs.enable()
    try:
        d1, i1, reads1 = _profiled_search(index, q, params)
        spans = {s["name"] for s in obs.registry().spans()}
    finally:
        obs.disable()
        obs.registry().reset()
    assert torch.equal(d0, d1) and torch.equal(i0, i1)
    assert reads0 == reads1
    assert {"ivf_flat.search", "ivf_flat.search.tables", "ivf_flat.search.scan",
            "ivf_flat.search.unsort", "ivf_flat.search.host_read"} <= spans


def test_host_reads_one_a_call(flat, obs_on):
    index, q = flat
    for _ in range(3):
        ivf_flat.search(index, q, 5, _params(), query_batch=BATCH, mode="fused")
    h = obs_on.as_dict()["histograms"]["ivf_flat.search.host_reads"]
    assert h["count"] == 3 and h["sum"] == 3.0
    assert len(obs_on.spans("ivf_flat.search.host_read")) == 3
    top = obs_on.spans("ivf_flat.search")
    assert [s["depth"] for s in top] == [0, 0, 0]
    assert len(obs_on.spans("ivf_flat.search.scan")) == 3 * len(_batches(q))
