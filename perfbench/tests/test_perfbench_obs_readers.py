"""The readers of the program's own spans and counters
(``b1_overscan.batch``, ``b1_pair_rate.batch``, ``search_host_idle.batch``)
on a traced run built by hand, against values worked out by hand. (The
tiny cell runs the scan path on the CPU, so no CPU run reaches the fused
path these read.)"""
import types

import pytest
import torch

from perfbench import harness, roofline
from perfbench.trace import TraceData

B1 = "void (anonymous namespace)::ivf_filter_kernel<float, 128, false>"


def read(metric, trace):
    return harness.reader(types.SimpleNamespace(root=harness.ROOT), metric)(trace)


def _context(calls=5):
    # four lists on a line; each query probes its two nearest (as in test_perfbench_roofline)
    view = {"centers": torch.tensor([[0.0, 0.0], [10.0, 0.0], [20.0, 0.0], [30.0, 0.0]]),
            "list_sizes": torch.tensor([3, 5, 7, 11], dtype=torch.int32)}
    queries = torch.tensor([[1.0, 0.0], [4.0, 0.0], [29.0, 0.0]])
    config = {"search": {"n_probes": 2}, "query_batch": 2, "k": 2}
    return {"config": config, "view": view, "queries": queries, "calls": calls}


def _hist(total, count=1):
    return {"sum": float(total), "count": count, "buckets": [], "counts": []}


def _span(name, ts_ns, dur_ns, depth):
    return {"name": name, "ts_us": 0.0, "dur_us": dur_ns / 1e3, "tid": 1, "depth": depth,
            "args": {}, "ts_ns": ts_ns}


def _trace(spans=(), histograms=None, events=(), window_s=1e-3, calls=5):
    return TraceData(list(spans), histograms or {}, list(events), window_s, 0.0, _context(calls))


def test_overscan_is_scanned_over_the_real_queries_pairs():
    # probes {0, 1}, {0, 1}, {3, 2}: 8 + 8 + 18 = 34 pairs a call; 3 queries at
    # query_batch 2 pad one zero row, which probes {0, 1}: 8 pairs
    assert roofline._probed(_context()["view"], _context()["queries"], 2)[0] == 34
    t = _trace(histograms={
        "ivf_flat.fused.pairs_scanned": _hist(1000, 10),
        "ivf_flat.fused.pairs_probed": _hist((34 + 8) * 5, 10),
        "ivf_flat.fused.probes_dropped": _hist(3, 10),
        "ivf_flat.search.host_reads": _hist(5, 5)})
    assert read("b1_overscan.batch", t) == pytest.approx(1000 / (34 * 5))
    notes = "\n".join(t.notes)
    assert "roofline 210 over the same 20 rows (1 zero rows a call), difference 0 " in notes
    assert "3 of 40 (query row, probe) pairs (7.500000e-02)" in notes
    assert "5 over 5 calls (1 a call)" in notes


def test_pair_rate_is_the_pairs_operations_over_b1_s_time():
    t = _trace(histograms={"ivf_flat.fused.pairs_scanned": _hist(1000)},
               events=[(B1, 0, 2_000_000), ("aten::sort", 0, 9_000_000)])
    want = 100.0 * (2 * 2 * 1000) / 0.002 / roofline.PEAKS["tf32_flops_per_s"]
    assert read("b1_pair_rate.batch", t) == pytest.approx(want)


def test_host_idle_counts_what_device_work_leaves_uncovered_in_each_call():
    spans = [
        # call A [1000, 11000): plan's read, tables and scan inside it
        _span("ivf_flat.search.host_read", 1000, 1000, 2),
        _span("ivf_flat.search.tables", 3000, 2000, 1),
        _span("ivf_flat.search.scan", 6000, 3000, 1),
        _span("ivf_flat.search", 1000, 10000, 0),
        # call B [20000, 25000): its scan's kernel starts 1 us in
        _span("ivf_flat.search.scan", 20000, 1000, 1),
        _span("ivf_flat.search", 20000, 5000, 0),
    ]
    events = [("a", 0, 3000), ("b", 2000, 4000), (B1, 8000, 20000), (B1, 21000, 30000)]
    t = _trace(spans, events=events, window_s=1e-3)
    # busy [0, 4000), [8000, 20000), [21000, 30000): A idles [4000, 8000), B [20000, 21000)
    assert read("search_host_idle.batch", t) == pytest.approx(100.0 * 5000e-9 / 1e-3)
    split, clock = t.notes
    assert ("host_read 0.000000 s (0.00 %), tables 0.000001 s (20.00 %), scan 0.000003 s "
            "(60.00 %), unsort 0.000000 s (0.00 %), rest 0.000001 s (20.00 %)") in split
    assert ("2 B1 kernels paired with scan spans, the earliest starts 1.000 us after its "
            "span's start; 0 start more than 50 us before it") in clock


def test_a_kernel_that_starts_before_its_span_fails_the_clock_check():
    spans = [_span("ivf_flat.search.scan", 100_000, 1000, 1),
             _span("ivf_flat.search", 90_000, 20_000, 0)]
    t = _trace(spans, events=[(B1, 40_000, 95_000)])
    read("search_host_idle.batch", t)
    assert "starts -60.000 us after its span's start; 1 start more than 50 us" in t.notes[-1]


@pytest.mark.parametrize("metric", ["b1_overscan.batch", "b1_pair_rate.batch",
                                    "search_host_idle.batch"])
def test_a_program_without_the_spans_and_counters_reads_nothing(metric):
    """The parent program records none of these, and its spans carry no
    ``ts_ns``: each reader returns None and raises nothing."""
    old = {k: v for k, v in _span("ivf_flat.search", 0, 1000, 0).items() if k != "ts_ns"}
    t = _trace([old], events=[(B1, 0, 1000)])
    assert read(metric, t) is None
