"""The control and the faults come out as not correct.

The control puts the plain reference, with its products rounded to TF32,
in the program's place (the nearest precision below the configuration's
float32 with TF32 off). The faults break the timed path underneath a run
whose look for a card is skipped: half of each batch answered with the
other half's answers, an answer altered where the search produces it, and
fewer lists probed than the configuration states. At a cell's own size on
the card, a build that skips k-means fails too.

Each test runs the benchmark's IVF-Flat cell and an IVF-PQ cell added in a
copy of the benchmark (``tiny.pq_cell``), at tiny sizes on the CPU.
"""
import pytest
import torch

from perfbench import check, faults, harness, index
from perfbench.tests import tiny

FLAT = "sift1m-ivf_flat.batch10k"


@pytest.fixture(params=["ivf_flat", "ivf_pq"])
def cell_at(request, tmp_path):
    """``(root, workload)`` of a cell of each index type."""
    if request.param == "ivf_flat":
        return harness.ROOT, FLAT
    return tiny.pq_cell(tmp_path)


def _program(workload):
    from raft_tpu_torch.neighbors import ivf_flat, ivf_pq

    return ivf_pq if "ivf_pq" in workload else ivf_flat


def test_the_control_fails_the_limits(cell_at):
    root, workload = cell_at
    out = tiny.run(workload, root=root, control=True)
    assert out["correct"] is True, out["check"]
    assert not _verdict(out["control"], tiny.cell(workload, root).limits)[0]


def _verdict(readings, limits):
    """The verdict on the numbers ``readings`` has."""
    return check.verdict(readings, {k: v for k, v in limits.items() if k in readings})


@pytest.mark.parametrize("fault", [faults.half_left_out, faults.answer_altered,
                                   faults.fewer_probes])
def test_a_broken_timed_path_is_not_correct(cell_at, fault, monkeypatch):
    root, workload = cell_at
    mod = _program(workload)
    monkeypatch.setattr(mod, "search", fault(mod.search))
    out = tiny.run(workload, root=root)
    assert out["correct"] is False, out["check"]


def test_a_build_that_skips_kmeans_is_not_correct(cell_at, monkeypatch):
    from raft_tpu_torch.cluster import kmeans_balanced

    root, workload = cell_at
    monkeypatch.setattr(kmeans_balanced, "fit", faults.untrained(kmeans_balanced.fit))
    out = tiny.run(workload, root=root)
    assert out["correct"] is False, out["check"]
    assert out["check"]["kmeans_excess"]["value"] > out["check"]["kmeans_excess"]["limit"]


def test_the_reference_answers_as_the_program_does_where_it_probes_each_querys_lists(cell_at):
    """Where the program scans each query's own ``n_probes`` lists (its
    plain path on the CPU), it and the reference give the same ids."""
    root, workload = cell_at
    c = tiny.cell(workload, root).config
    rows, queries = tiny_data(c)
    idx = index.build(c, rows, "cpu", 7)
    d, i = index.search(c, idx, rows, queries, index.search_params(c))
    judge = check.Judge(c, rows, index.view(c, idx))
    _, ref_i = judge.reference(queries)
    assert torch.equal(ref_i, i.to(torch.int64))


def tiny_data(c):
    from perfbench import data

    return data.make(c, 7, "cpu", c["n_rows"], c["n_queries"])


@pytest.mark.chip
@pytest.mark.parametrize("workload", [FLAT])
def test_the_control_fails_at_the_cells_own_size(workload, cuda_card):
    """At the cell's own size on the card, three seeds: every seed's
    program run within its limits, every control run outside them."""
    cell = harness.load_cell(workload)
    for seed in (2**31 + 11, 2**31 + 12, 2**31 + 13):
        out = harness.run_cell(cell, seed=seed, seconds=2.0, trace=False, device=cuda_card,
                               control=True)
        assert out["correct"] is True, out["check"]
        assert not _verdict(out["control"], cell.limits)[0], out["control"]
        torch.cuda.empty_cache()


@pytest.mark.chip
@pytest.mark.parametrize("workload", [FLAT])
def test_a_build_that_skips_kmeans_fails_at_the_cells_own_size(workload, cuda_card,
                                                                monkeypatch):
    """Centres drawn at random from the rows instead of trained: the lists
    and the search still agree with each other, and the centres' excess
    over a plain k-means has to catch it, on three seeds."""
    from raft_tpu_torch.cluster import kmeans_balanced

    monkeypatch.setattr(kmeans_balanced, "fit", faults.untrained(kmeans_balanced.fit))
    cell = harness.load_cell(workload)
    for seed in (2**31 + 21, 2**31 + 22, 2**31 + 23):
        out = harness.run_cell(cell, seed=seed, seconds=2.0, trace=False, device=cuda_card)
        assert out["correct"] is False, out["check"]
        assert out["check"]["kmeans_excess"]["value"] > out["check"]["kmeans_excess"]["limit"]
        torch.cuda.empty_cache()
