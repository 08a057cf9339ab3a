"""raft_tpu_torch.obs — observability: metrics registry, request trace
identity and device-sync-aware spans (``raft_tpu.obs`` counterpart;
its export, flight recorder, SLO and time-series modules are not ported
yet).

::

    from raft_tpu_torch import obs

    with obs.span("serve.dispatch", algo=algo) as sp:
        out = run(...)
        sp.sync(out)            # wait for the outputs' CUDA stream
    if obs.is_enabled():
        obs.inc("serve.batches", index_id=index_id)

Disabled by default; enable with ``RAFT_TPU_OBS=1`` or ``obs.enable()``.
"""
from raft_tpu_torch.obs.metrics import (
    DEFAULT_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    Registry,
    disable,
    enable,
    inc,
    is_enabled,
    observe,
    registry,
    set_gauge,
)
from raft_tpu_torch.obs.request import (
    NULL_SCOPE,
    current_trace,
    iter_trace_spans,
    new_trace_id,
    trace_scope,
)
from raft_tpu_torch.obs.spans import Span, span, traced

__all__ = [
    "DEFAULT_BUCKETS",
    "Counter",
    "Gauge",
    "Histogram",
    "NULL_SCOPE",
    "Registry",
    "Span",
    "current_trace",
    "disable",
    "enable",
    "inc",
    "is_enabled",
    "iter_trace_spans",
    "new_trace_id",
    "observe",
    "registry",
    "set_gauge",
    "span",
    "trace_scope",
    "traced",
]
