"""The device's idle inside the library's search calls (%): for each
depth-0 ``ivf_flat.search`` span (the host's enqueue of one call), its
length less the time device activity covers inside it, both on the
profiler's clock (the span's ``ts_ns``), summed over the window and
divided by the window.

On standard error beside it: that idle split between the spans inside a
call (``.host_read``, ``.tables``, ``.scan``, ``.unsort``) and the rest of
``ivf_flat.search``; and the clock check, the start of the i-th B1 kernel
of the window against the start of the i-th ``ivf_flat.search.scan`` span
that launched it."""
import bisect
from typing import List, Tuple

from perfbench.trace import _merge

SPAN = "ivf_flat.search"
PARTS = ("host_read", "tables", "scan", "unsort")


def _idle_in(busy: List[Tuple[int, int]], starts: List[int], span: dict) -> float:
    """Seconds of ``span`` that no interval of ``busy`` (merged, sorted;
    ``starts`` their starts) covers."""
    s = span["ts_ns"]
    e = s + span["dur_us"] * 1e3
    covered = 0.0
    i = max(0, bisect.bisect_right(starts, s) - 1)
    while i < len(busy) and busy[i][0] < e:
        covered += max(0.0, min(e, busy[i][1]) - max(s, busy[i][0]))
        i += 1
    return (e - s - covered) / 1e9


def _clock_check(trace) -> str:
    kernels = sorted(s for n, s, _ in trace.device_events if "ivf_filter_kernel" in n)
    scans = sorted(s["ts_ns"] for s in trace.spans(f"{SPAN}.scan") if "ts_ns" in s)
    if not kernels or len(kernels) != len(scans):
        return f"clock check: {len(kernels)} B1 kernels, {len(scans)} scan spans: not paired"
    leads = [(k - s) / 1e3 for k, s in zip(kernels, scans)]
    early = sum(1 for v in leads if v < -50.0)
    return (f"clock check: {len(kernels)} B1 kernels paired with scan spans, the earliest "
            f"starts {min(leads):.3f} us after its span's start; {early} start more than "
            f"50 us before it")


def read(trace):
    top = [s for s in trace.spans(SPAN, depth=0) if "ts_ns" in s]
    if not top or trace.window_s <= 0:
        return None
    busy = _merge([(s, e) for _, s, e in trace.device_events])
    starts = [s for s, _ in busy]
    idle = sum(_idle_in(busy, starts, s) for s in top)
    parts = {p: sum(_idle_in(busy, starts, s) for s in trace.spans(f"{SPAN}.{p}") if "ts_ns" in s)
             for p in PARTS}
    parts["rest"] = idle - sum(parts.values())
    split = ", ".join(f"{p} {v:.6f} s ({100.0 * v / idle if idle else 0.0:.2f} %)"
                      for p, v in parts.items())
    trace.notes.append(f"search host idle: {idle:.6f} s in {len(top)} calls of a "
                       f"{trace.window_s:.6f} s window; {split}")
    trace.notes.append(_clock_check(trace))
    return 100.0 * idle / trace.window_s
