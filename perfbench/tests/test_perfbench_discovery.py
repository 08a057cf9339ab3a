"""A configuration, a traffic mix, limits and a cell added as files alone
(in a copy of the benchmark) are found by name and run."""
import json

from perfbench.tests import tiny


def test_a_configuration_added_as_a_file_is_found_and_run(tmp_path):
    root = tiny.checkout(tmp_path)
    base = json.loads((root / "perfbench/configs/sift1m-ivf_flat.json").read_text())
    (root / "perfbench/traffic/batch300.json").write_text(
        json.dumps({"kind": "batch", "batch_queries": 300}))
    limits = json.loads((root / "perfbench/limits/sift1m-ivf_flat.batch10k.json").read_text())
    tiny.add_cell(root, {**base, "name": "gist-like-ivf_flat", "dim": 96,
                         "search": {"n_probes": 8}},
                  "batch300", limits["limits"], like="sift1m-ivf_flat.batch10k")

    cell = tiny.cell("gist-like-ivf_flat.batch300", root=root)
    assert cell.config["dim"] == 96 and cell.traffic["batch_queries"] == 300
    assert {m["name"] for m in cell.per_layer} == {"b1_roofline.batch", "device_idle.batch"}
    out = tiny.run("gist-like-ivf_flat.batch300", root=root)
    assert out["correct"] is True, out["check"]
    assert set(out["metrics"]) == {"search_qps", "setup_s"}


def test_a_metric_reader_is_found_by_name(tmp_path):
    root = tiny.checkout(tmp_path)
    (root / "perfbench/metrics/answers_total.batch.py").write_text(
        "def read(trace):\n    return float(trace.context['calls'])\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["per_layer"].append({"name": "answers_total.batch", "unit": "calls", "better": "higher",
                              "source": "program_counter", "layer": "device",
                              "moves": "search_qps",
                              "workloads": ["sift1m-ivf_flat.batch10k"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    out = tiny.run("sift1m-ivf_flat.batch10k", root=root, trace=True)
    assert out["metrics"]["answers_total.batch"]["value"] >= 1
