"""The traced run: the program's ``obs`` spans and counters, and a
``torch.profiler`` trace of the device, over the measured window.

:class:`Tracer` turns both on around the window; :meth:`Tracer.result`
reduces the profile to device intervals, the busy and idle share, the top
device operations and the longest idle gaps, each gap named by the
innermost host event that covers it.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Tuple

import torch

WINDOW = "perfbench.window"
#: entries of each breakdown list
TOP = 10


def region(name: str):
    """A host region the profiler records (named in the idle gaps)."""
    return torch.profiler.record_function(name)


class TraceData:
    """What the per-layer readers read after a traced window."""

    def __init__(self, spans: List[dict], histograms: Dict[str, dict],
                 device_events: List[Tuple[str, int, int]], window_s: float, busy_s: float,
                 context: dict):
        self._spans = spans
        self.histograms = histograms
        #: (name, start_ns, end_ns) of every device activity in the window
        self.device_events = device_events
        self.window_s = window_s
        self.busy_s = busy_s
        #: what the cell hands its readers (its index view, queries, calls)
        self.context = context
        #: lines the readers print on standard error
        self.notes: List[str] = []

    def spans(self, name: str, depth: Optional[int] = None) -> List[dict]:
        return [s for s in self._spans
                if s["name"] == name and (depth is None or s["depth"] == depth)]

    def histogram(self, name: str) -> Optional[dict]:
        """The histogram ``name`` with its labels summed."""
        found = [h for key, h in self.histograms.items() if key.split("{")[0] == name]
        if not found:
            return None
        return {"sum": sum(h["sum"] for h in found), "count": sum(h["count"] for h in found)}

    def kernel_seconds(self, fragment: str) -> float:
        return sum(e - s for n, s, e in self.device_events if fragment in n) / 1e9


def _merge(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


class Tracer:
    """Context manager around the measured window; off, it does nothing."""

    def __init__(self, on: bool, device: torch.device):
        self.on = on
        self.device = torch.device(device)
        self._prof = None
        self._stack = contextlib.ExitStack()

    def __enter__(self):
        if not self.on:
            return self
        from raft_tpu_torch import obs

        obs.enable()
        obs.registry().reset()
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = self._stack.enter_context(torch.profiler.profile(activities=acts))
        self._stack.enter_context(region(WINDOW))
        return self

    def __exit__(self, *exc):
        if self.on:
            from raft_tpu_torch import obs

            self._spans = obs.registry().spans()
            self._hist = obs.registry().as_dict()["histograms"]
            obs.disable()
        self._stack.close()
        return False

    def result(self, context: dict) -> Tuple[TraceData, dict]:
        """``(TraceData, breakdown)`` of the window just traced."""
        t0 = time.perf_counter()
        events = self._prof.profiler.kineto_results.events()
        win = [(e.start_ns(), e.end_ns()) for e in events if e.name() == WINDOW]
        w0, w1 = (win[0] if win else (min(e.start_ns() for e in events),
                                      max(e.end_ns() for e in events)))
        dev, host = [], []
        for e in events:
            s, t = max(e.start_ns(), w0), min(e.end_ns(), w1)
            if t <= s:
                continue
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                if not e.is_user_annotation():  # the host's regions, mirrored on the GPU
                    dev.append((e.name(), s, t))
            elif e.name() != WINDOW:
                host.append((e.name(), s, t))
        busy = _merge([(s, t) for _, s, t in dev])
        busy_s = sum(t - s for s, t in busy) / 1e9
        window_s = (w1 - w0) / 1e9
        data = TraceData(self._spans, self._hist, dev, window_s, busy_s, context)
        by_op: Dict[str, float] = {}
        for n, s, t in dev:
            by_op[n] = by_op.get(n, 0.0) + (t - s) / 1e9
        ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP]
        edges = [w0] + [x for iv in busy for x in iv] + [w1]
        gaps = sorted(((edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
                       if edges[i + 1] > edges[i]), key=lambda g: g[0] - g[1])[:TOP]
        idle = [[_host_at(host, (s + t) // 2), (t - s) / 1e9] for s, t in gaps]
        breakdown = {"device_ops": [[n[:160], v] for n, v in ops], "idle_gaps": idle}
        data.notes.append(f"trace reduced in {time.perf_counter() - t0:.3f} s "
                          f"({len(dev)} device events, {len(host)} host events)")
        return data, breakdown


def _host_at(host: List[Tuple[str, int, int]], t: int) -> str:
    """The innermost host event covering ``t`` (the shortest)."""
    best = None
    for n, s, e in host:
        if s <= t <= e and (best is None or e - s < best[1]):
            best = (n, e - s)
    return (best[0] if best else "host: outside any recorded region")[:160]
