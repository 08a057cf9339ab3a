"""The roofline counts against counts made by hand on small probe sets."""
import pytest
import torch

from perfbench import roofline


def _view():
    # four lists on a line; each query probes its two nearest
    centers = torch.tensor([[0.0, 0.0], [10.0, 0.0], [20.0, 0.0], [30.0, 0.0]])
    sizes = torch.tensor([3, 5, 7, 11], dtype=torch.int32)
    return {"centers": centers, "list_sizes": sizes}


def test_ivf_flat_counts_by_hand():
    q = torch.tensor([[1.0, 0.0], [4.0, 0.0], [29.0, 0.0]])
    w = roofline.ivf_flat_scan(_view(), q, n_probes=2, k=2)
    # probes: {0, 1}, {0, 1}, {3, 2}: pairs 8 + 8 + 18 = 34; lists read 0, 1, 2, 3
    assert w["flops"] == 2 * 2 * 34
    rows = 3 + 5 + 7 + 11
    assert w["bytes"] == rows * (2 * 4 + 8) + 3 * 2 * 4 + 4 * 2 * 4 + 3 * 2 * 8
    t_ops = w["flops"] / roofline.PEAKS["tf32_flops_per_s"]
    t_bytes = w["bytes"] / roofline.PEAKS["hbm_bytes_per_s"]
    assert w["bound_s"] == pytest.approx(max(t_ops, t_bytes))
    assert w["by"] == ("operations" if t_ops >= t_bytes else "bytes")


def test_ivf_pq_counts_by_hand():
    v = _view()
    v["codes"] = torch.zeros((4, 11, 6), dtype=torch.uint8)
    v["pq_centers"] = torch.zeros((6, 256, 1))
    q = torch.tensor([[1.0, 0.0], [21.0, 0.0]])
    w = roofline.ivf_pq_scan(v, q, n_probes=1, k_scan=5)
    # probes: {0}, {2}: pairs 3 + 7; lists read 0 and 2
    assert w["flops"] == 6 * 10
    assert w["bytes"] == (10 * (6 + 8) + 2 * 2 * 4 + 4 * 2 * 4 + 6 * 256 * 4 + 2 * 5 * 8)
    assert w["by"] == "bytes"


def test_a_list_probed_by_many_queries_is_read_once():
    v = _view()
    q = torch.zeros((50, 2))
    w = roofline.ivf_flat_scan(v, q, n_probes=1, k=1)
    assert w["flops"] == 2 * 2 * 3 * 50
    assert w["bytes"] == 3 * 16 + 50 * 8 + 4 * 8 + 50 * 8
