"""Every cell of BENCHMARK.json runs end to end at a tiny size on the CPU,
through the program's plain paths, and gives the contract's result."""
import json
import os
import subprocess
import sys

import pytest

from perfbench import harness
from perfbench.tests import tiny

SPEC = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
WORKLOADS = [w["name"] for w in SPEC["workloads"]]


@pytest.mark.parametrize("workload", WORKLOADS)
@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_and_is_correct(workload, trace):
    out = tiny.run(workload, trace=trace)
    assert list(out)[:3] == ["correct", "attempted", "failed"]
    assert list(out)[-1] == "check"
    assert out["correct"] is True, out["check"]
    assert out["attempted"] > 0 and out["failed"] == 0
    cell = tiny.cell(workload)
    if trace:
        assert "breakdown" in out and {"busy_s", "window_s"} <= set(out["device"])
        assert set(out["metrics"]) <= {m["name"] for m in cell.per_layer}
    else:
        assert set(out["metrics"]) == {m["name"] for m in cell.end_to_end}
        assert "setup_s" in out["metrics"]
        assert all(v["value"] > 0 for v in out["metrics"].values())
    json.dumps(out)


def test_cli_refuses_without_enough_cards():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this test checks the refusal on a machine without a card")
    proc = subprocess.run(
        [sys.executable, "-m", "perfbench.run", "--workload", WORKLOADS[0], "--seed", "1",
         "--seconds", "1", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": str(harness.ROOT)})
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_every_cell_reports_what_benchmark_json_asks():
    names = {m["name"] for m in SPEC["end_to_end"]}
    for w in WORKLOADS:
        cell = harness.load_cell(w)
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer, w
        for m in cell.per_layer:
            assert m["moves"] in e2e and m["moves"] in names
            assert (harness.ROOT / "perfbench" / "metrics" / f"{m['name']}.py").exists()
