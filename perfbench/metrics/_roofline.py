"""Helper of the roofline readers (no metric of its own)."""
from __future__ import annotations

from typing import Optional


def share(trace, kernel: str, work: dict, label: str) -> Optional[float]:
    """The bound of ``calls`` calls over ``kernel``'s device time (%)."""
    t = trace.kernel_seconds(kernel)
    calls = trace.context.get("calls", 0)
    if t <= 0 or not calls:
        return None
    bound = work["bound_s"] * calls
    trace.notes.append(f"{label}: bound {work['bound_s'] * 1e3:.6f} ms a call by {work['by']} "
                       f"({work['flops']:.6g} operations, {work['bytes']:.6g} bytes), "
                       f"{calls} calls, kernel {t * 1e3:.4f} ms")
    return 100.0 * bound / t
