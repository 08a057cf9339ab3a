"""The benchmark's driver, run by ``python3 -m perfbench.run``.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix. The
harness finds everything by name:

* ``BENCHMARK.json``'s configuration entry gives the file of sizes
  (``perfbench/configs/<config>.json``);
* ``perfbench/traffic/<traffic>.json`` gives the mix, whose ``kind``
  names the general runner in ``perfbench/kinds/<kind>.py``;
* ``perfbench/limits/<workload>.json`` gives the limit of each number
  compared to decide ``correct``;
* each per-layer metric is read by ``perfbench/metrics/<metric>.py``.

A run sets up (data from the seed, the index, every shape warmed),
measures for ``--seconds``, reads the device's peak memory, frees what it
can, checks the answers against the plain reference, and prints one JSON
line.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

from perfbench import check
from perfbench.trace import Tracer

ROOT = Path(__file__).resolve().parent.parent
#: top-level module names a run may not hold once its window has closed
BANNED = ("jax", "jaxlib", "flax", "raft_tpu")


@dataclasses.dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with its files loaded."""

    root: Path
    workload: str
    chips: int
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]


def _read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(workload: str, root: Path = ROOT, overrides: Optional[dict] = None) -> Cell:
    """The cell ``workload`` as ``root``'s files define it; ``overrides``
    replaces top-level keys of the configuration (the tests' tiny sizes)."""
    spec = _read_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    config = {**_read_json(root / conf["file"]), **(overrides or {})}
    traffic = _read_json(root / "perfbench" / "traffic" / f"{w['traffic']}.json")
    limits = _read_json(root / "perfbench" / "limits" / f"{workload}.json")["limits"]

    def here(m):
        return "workloads" not in m or workload in m["workloads"]

    e2e = [m for m in spec["end_to_end"] if here(m)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return Cell(root, workload, int(w["chips"]), config, traffic, limits, e2e, per_layer)


def kind_module(cell: Cell):
    return importlib.import_module(f"perfbench.kinds.{cell.traffic['kind']}")


def reader(cell: Cell, metric: str):
    """The ``read(trace)`` function of ``perfbench/metrics/<metric>.py``."""
    path = cell.root / "perfbench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def banned_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in BANNED)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_info(device: torch.device, chips: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def run_cell(cell: Cell, *, seed: int, seconds: float, trace: bool, device,
             t_start: Optional[float] = None, control: bool = False,
             log=None) -> Dict[str, object]:
    """One run of ``cell``: returns the result line's object (``check``
    last). ``t_start`` is when the process started (set-up counts from
    it). ``control`` adds the control's readings under ``control``."""
    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    log = log or (lambda line: print(line, file=sys.stderr, flush=True))
    kind = kind_module(cell)
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.zeros(1, device=device)  # the allocator exists before its peak is reset
        torch.cuda.reset_peak_memory_stats(device)
    state = kind.setup(cell, seed=seed, seconds=seconds, device=device, log=log)
    setup_s = time.perf_counter() - t_start
    with Tracer(trace, device) as tracer:
        e2e = kind.window(state, seconds=seconds, log=log)
    dev = device_info(device, cell.chips)
    breakdown, per_layer = None, {}
    if trace:
        data, breakdown = tracer.result(kind.trace_context(state))
        dev["busy_s"], dev["window_s"] = data.busy_s, data.window_s
        for m in cell.per_layer:
            value = reader(cell, m["name"])(data)
            if value is not None:
                per_layer[m["name"]] = {"value": value, "unit": m["unit"]}
        for line in data.notes:
            log(line)
    kind.release(state)
    t0 = time.perf_counter()
    readings, attempted, failed = kind.check(state, seed=seed, log=log)
    log(f"check {time.perf_counter() - t0:.3f} s")
    ok, lines = check.verdict(readings, cell.limits)
    out: Dict[str, object] = {"correct": bool(ok), "attempted": int(attempted),
                              "failed": int(failed)}
    if trace:
        out["metrics"] = per_layer
    else:
        values = {**e2e, "setup_s": setup_s}
        out["metrics"] = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                          for m in cell.end_to_end}
    out["device"] = dev
    if breakdown is not None:
        out["breakdown"] = breakdown
    if control:
        out["control"] = kind.control(state, seed=seed, log=log)
    out["check"] = {name: {"value": readings.get(name), "limit": limit}
                    for name, limit in cell.limits.items()}
    for line in lines:
        log(line)
    return out
