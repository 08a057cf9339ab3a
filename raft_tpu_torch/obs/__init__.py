"""raft_tpu_torch.obs — observability: metrics registry, request trace
identity, device-sync-aware spans, Perfetto/Chrome-trace export,
bounded time series with drift detectors, SLO burn-rate tracking and the
flight recorder (``raft_tpu.obs`` counterpart, every module of it).

::

    from raft_tpu_torch import obs

    with obs.span("serve.dispatch", algo=algo) as sp:
        out = run(...)
        sp.sync(out)            # wait for the outputs' CUDA stream
    if obs.is_enabled():
        obs.inc("serve.batches", index_id=index_id)
        obs.observe_device("ivf_flat.fused.pairs_scanned", pairs)  # 0-d tensor, read at dump

Disabled by default; enable with ``RAFT_TPU_OBS=1`` or ``obs.enable()``.
"""
from raft_tpu_torch.obs.export import (
    chrome_trace,
    load_trace,
    validate_trace,
    write_metrics_jsonl,
    write_trace,
)
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
    observe_device,
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
from raft_tpu_torch.obs import recorder, timeseries
from raft_tpu_torch.obs.recorder import FlightRecorder, list_bundles, load_bundle
from raft_tpu_torch.obs.slo import SLO, SloStatus, SloTracker
from raft_tpu_torch.obs.spans import Span, span, traced
from raft_tpu_torch.obs.timeseries import (
    Anomaly,
    EwmaDetector,
    HistogramSeries,
    SeriesBank,
    TimeSeries,
    default_detectors,
)

__all__ = [
    "Anomaly",
    "DEFAULT_BUCKETS",
    "Counter",
    "EwmaDetector",
    "FlightRecorder",
    "Gauge",
    "Histogram",
    "HistogramSeries",
    "NULL_SCOPE",
    "Registry",
    "SLO",
    "SeriesBank",
    "SloStatus",
    "SloTracker",
    "Span",
    "TimeSeries",
    "chrome_trace",
    "current_trace",
    "default_detectors",
    "disable",
    "enable",
    "inc",
    "is_enabled",
    "iter_trace_spans",
    "list_bundles",
    "load_bundle",
    "load_trace",
    "new_trace_id",
    "observe",
    "observe_device",
    "recorder",
    "registry",
    "set_gauge",
    "span",
    "timeseries",
    "trace_scope",
    "traced",
    "validate_trace",
    "write_metrics_jsonl",
    "write_trace",
]
