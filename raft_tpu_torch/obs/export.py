"""Export the obs registry as Chrome-trace/Perfetto ``trace_events``
JSON and as a metrics JSONL snapshot (``raft_tpu.obs.export``
counterpart).

The trace format is the Trace Event Format's JSON Object Format: a
top-level ``{"traceEvents": [...]}`` where each span is a complete
duration event (``"ph": "X"`` with ``ts``/``dur`` in microseconds) and
each counter is sampled once at trace end as a counter event
(``"ph": "C"``). Files written by :func:`write_trace` open directly in
``ui.perfetto.dev`` (or ``chrome://tracing``); :func:`validate_trace`
is the schema check the round-trip tests and ``tools/obs_report.py``
share.

Spans tagged with request trace IDs (:mod:`raft_tpu_torch.obs.request`)
additionally produce **flow events** (``"ph": "s"/"t"/"f"``): one arrow
chain per trace ID, binding to the tagged slices in timestamp order.
That is what makes one request render as a connected track across
threads in Perfetto — the synthetic per-request ``serve.queue`` slice,
the worker thread's ``serve.dispatch``, and the tiered ``host.fetch`` /
refine slices are visually chained even though they live on different
``tid`` s.
"""
from __future__ import annotations

import io
import json
import os
import zlib
from typing import Any, Dict, List, Optional

from raft_tpu_torch.core import serialize
from raft_tpu_torch.obs import metrics as _metrics


def chrome_trace(registry: Optional[_metrics.Registry] = None) -> Dict[str, Any]:
    """Build the ``trace_events`` document from a registry snapshot."""
    reg = registry or _metrics.registry()
    pid = os.getpid()
    events = []
    end_ts = 0.0
    by_trace: Dict[str, List[Dict[str, Any]]] = {}
    for s in reg.spans():
        end_ts = max(end_ts, s["ts_us"] + s["dur_us"])
        args = {**s["args"], "depth": s["depth"]}
        trace = s.get("trace") or ()
        if trace:
            args["trace"] = list(trace)
        ev = {
            "ph": "X",
            "name": s["name"],
            "cat": "raft_tpu",
            "ts": round(s["ts_us"], 3),
            "dur": round(s["dur_us"], 3),
            "pid": pid,
            "tid": s["tid"],
            "args": args,
        }
        events.append(ev)
        for t in trace:
            by_trace.setdefault(t, []).append(ev)
    # one flow chain per trace ID: start on the earliest tagged slice,
    # step through the rest, finish (enclosing bind) on the last — this
    # is what draws the request's arrows across thread tracks
    for trace_id, evs in sorted(by_trace.items()):
        if len(evs) < 2:
            continue  # an arrow needs two endpoints
        evs.sort(key=lambda e: (e["ts"], e["args"]["depth"]))
        flow_id = zlib.crc32(trace_id.encode("utf-8"))
        for j, ev in enumerate(evs):
            ph = "s" if j == 0 else ("f" if j == len(evs) - 1 else "t")
            flow = {
                "ph": ph,
                "name": "request",
                "cat": "trace",
                "id": flow_id,
                "ts": ev["ts"],
                "pid": pid,
                "tid": ev["tid"],
                "args": {"trace": trace_id},
            }
            if ph == "f":
                flow["bp"] = "e"
            events.append(flow)
    snap = reg.as_dict()
    for key, value in snap["counters"].items():
        events.append(
            {
                "ph": "C",
                "name": key,
                "cat": "raft_tpu",
                "ts": round(end_ts, 3),
                "pid": pid,
                "tid": 0,
                "args": {"value": value},
            }
        )
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {"producer": "raft_tpu_torch.obs", "spans_dropped": snap["spans_dropped"]},
    }


def validate_trace(doc: Any) -> None:
    """Raise ``ValueError`` unless ``doc`` is a well-formed Trace Event
    Format JSON object (the contract ``ui.perfetto.dev`` parses)."""
    if not isinstance(doc, dict):
        raise ValueError("trace document must be a JSON object")
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        raise ValueError("trace document must have a 'traceEvents' list")
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            raise ValueError(f"traceEvents[{i}] is not an object")
        ph = ev.get("ph")
        if not isinstance(ph, str) or not ph:
            raise ValueError(f"traceEvents[{i}] missing phase 'ph'")
        if ph == "X":
            if not isinstance(ev.get("name"), str):
                raise ValueError(f"traceEvents[{i}]: duration event needs a 'name'")
            for field in ("ts", "dur"):
                v = ev.get(field)
                if not isinstance(v, (int, float)) or isinstance(v, bool):
                    raise ValueError(f"traceEvents[{i}]: '{field}' must be a number")
            if ev["dur"] < 0:
                raise ValueError(f"traceEvents[{i}]: negative 'dur'")
            for field in ("pid", "tid"):
                if not isinstance(ev.get(field), int):
                    raise ValueError(f"traceEvents[{i}]: '{field}' must be an int")
        elif ph == "C":
            if not isinstance(ev.get("name"), str):
                raise ValueError(f"traceEvents[{i}]: counter event needs a 'name'")
            if not isinstance(ev.get("args"), dict):
                raise ValueError(f"traceEvents[{i}]: counter event needs 'args'")
        elif ph in ("s", "t", "f"):
            if not isinstance(ev.get("name"), str):
                raise ValueError(f"traceEvents[{i}]: flow event needs a 'name'")
            if not isinstance(ev.get("id"), (int, str)) or isinstance(ev.get("id"), bool):
                raise ValueError(f"traceEvents[{i}]: flow event needs an 'id'")
            v = ev.get("ts")
            if not isinstance(v, (int, float)) or isinstance(v, bool):
                raise ValueError(f"traceEvents[{i}]: 'ts' must be a number")
            for field in ("pid", "tid"):
                if not isinstance(ev.get(field), int):
                    raise ValueError(f"traceEvents[{i}]: '{field}' must be an int")


def write_trace(path: str, registry: Optional[_metrics.Registry] = None) -> str:
    """Write (and validate) the Chrome-trace JSON; returns ``path``."""
    doc = chrome_trace(registry)
    validate_trace(doc)
    payload = json.dumps(doc).encode("utf-8")
    # temp-fsync-rename: a crash mid-export must not tear a trace a
    # later tooling pass would choke on
    return serialize.atomic_write(path, lambda f: f.write(payload))


def load_trace(path: str) -> Dict[str, Any]:
    """Read + validate a trace file written by :func:`write_trace`."""
    with open(path, "r", encoding="utf-8") as f:
        doc = json.load(f)
    validate_trace(doc)
    return doc


def write_metrics_jsonl(path: str, registry: Optional[_metrics.Registry] = None) -> str:
    """Write the metrics + spans JSONL snapshot; returns ``path``."""
    reg = registry or _metrics.registry()
    buf = io.StringIO()
    reg.dump_jsonl(buf)
    payload = buf.getvalue().encode("utf-8")
    return serialize.atomic_write(path, lambda f: f.write(payload))
