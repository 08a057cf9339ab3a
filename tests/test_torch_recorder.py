"""The rest of obs, each against raft_tpu's: time series, drift detectors,
SLO trackers, the flight recorder and the trace export.

The same sample streams, made from a numpy seed, go through both packages'
``TimeSeries``, ``HistogramSeries``, ``EwmaDetector`` and ``SloTracker`` on
the same virtual clock, and every query gives the same number. Bundles
cross over: a port bundle loads with ``raft_tpu.obs.load_bundle`` and a JAX
bundle with the port's; a port ``chrome_trace`` passes JAX's
``validate_trace``. The recorder's trigger rules, the torn ``recorder.dump``
drill, the SLO drill (exactly one bundle), gates-off parity and the hooks
the port wires into faults, breakers, the compactor and the engine are held
as the JAX package's own tests hold them.
"""
import os
import threading
import types

import numpy as np
import pytest

from raft_tpu import obs as jobs
from raft_tpu.neighbors import brute_force as jbf
from raft_tpu.obs import export as jexport
from raft_tpu.obs import recorder as jrec
from raft_tpu.obs import slo as jslo
from raft_tpu.obs import timeseries as jts
from raft_tpu.robust import faults as jfaults
from raft_tpu.robust import retry as jretry
from raft_tpu.serve import ServingEngine as JEngine
from raft_tpu_torch import obs as tobs
from raft_tpu_torch.core.resources import Resources
from raft_tpu_torch.neighbors import brute_force as tbf
from raft_tpu_torch.obs import export as texport
from raft_tpu_torch.obs import recorder as trec
from raft_tpu_torch.obs import slo as tslo
from raft_tpu_torch.obs import timeseries as tts
from raft_tpu_torch.robust import faults as tfaults
from raft_tpu_torch.robust import retry as tretry
from raft_tpu_torch.serve import ServingEngine as TEngine

CPU = Resources(device="cpu")

J = types.SimpleNamespace(name="jax", obs=jobs, rec=jrec, ts=jts, slo=jslo, export=jexport,
                          faults=jfaults, retry=jretry)
T = types.SimpleNamespace(name="torch", obs=tobs, rec=trec, ts=tts, slo=tslo, export=texport,
                          faults=tfaults, retry=tretry)
BOTH = (J, T)


def _reset():
    for p in BOTH:
        p.faults.disable()
        p.faults.clear()
        p.obs.disable()
        p.obs.registry().reset()
        p.rec.uninstall()


@pytest.fixture(autouse=True)
def _pristine_gates():
    """Injection off, fault registries empty, obs off and reset, no recorder
    installed, in both packages, before and after every test."""
    _reset()
    yield
    _reset()


@pytest.fixture
def obs_on():
    for p in BOTH:
        p.obs.enable()
    yield
    for p in BOTH:
        p.obs.disable()


class VClock:
    def __init__(self, t=0.0):
        self.t = float(t)

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(11)
    c = rng.standard_normal((16, 16)).astype(np.float32)
    X = (c[rng.integers(0, 16, 256)] + 0.25 * rng.standard_normal((256, 16))).astype(np.float32)
    Q = (c[rng.integers(0, 16, 64)] + 0.25 * rng.standard_normal((64, 16))).astype(np.float32)
    return X, Q


@pytest.fixture(scope="module")
def bf_pair(corpus):
    X, _ = corpus
    return jbf.build(X), tbf.build(X, res=CPU)


def _counters(p, prefix=""):
    return {k: v for k, v in p.obs.registry().as_dict()["counters"].items()
            if k.startswith(prefix)}


def _gauges(p, prefix=""):
    return {k: v for k, v in p.obs.registry().as_dict()["gauges"].items()
            if k.startswith(prefix)}


# -- TimeSeries / HistogramSeries: the same numbers on the same streams -------


def _stream(seed, n):
    rng = np.random.default_rng(seed)
    t = np.cumsum(rng.uniform(0.0, 2.0, n)).tolist()
    v = np.round(rng.standard_normal(n) * 10.0, 3).tolist()
    return t, v, rng


def _series_queries(s, now, rng):
    out = [len(s), s.latest(), s.points(), s.points(since=now / 2), s.as_dict()]
    for w in (0.5, 3.0, 10.0, 1e9):
        out += [s.delta(w, now), s.rate(w, now), s.mean(w, now)]
        for q in (0.0, 50.0, 90.0, 99.0, 100.0, float(rng.uniform(0, 100))):
            out.append(s.percentile(q, w, now))
    return out


@pytest.mark.parametrize("seed", range(6))
def test_time_series_queries_equal_jax_s(seed):
    t, v, _ = _stream(seed, 40)
    cap = [4, 16, 512][seed % 3]
    kind = "counter" if seed % 2 else "gauge"
    got = []
    for p in BOTH:
        s = p.ts.TimeSeries("g", labels={"index_id": "a"}, capacity=cap, kind=kind)
        for ti, vi in zip(t, v):
            s.append(ti, vi)
        got.append(_series_queries(s, t[-1], np.random.default_rng(seed)))
    assert got[0] == got[1]


@pytest.mark.parametrize("seed", range(4))
def test_histogram_series_queries_equal_jax_s(seed):
    rng = np.random.default_rng(100 + seed)
    buckets = tuple(sorted(set(np.round(rng.uniform(0.1, 100.0, 5), 2).tolist())))
    counts = np.zeros(len(buckets) + 1, np.int64)
    total, n = 0.0, 0
    snaps = []
    t = 0.0
    for _ in range(30):
        t += float(rng.uniform(0.0, 1.5))
        add = rng.integers(0, 4, len(counts))
        counts = counts + add
        n += int(add.sum())
        total += float(add.sum()) * 3.5
        snaps.append((t, tuple(int(c) for c in counts), total, n))
    got = []
    for p in BOTH:
        h = p.ts.HistogramSeries("h", buckets=buckets, capacity=[8, 512][seed % 2])
        for snap in snaps:
            h.append(*snap)
        got.append(_series_queries(h, t, np.random.default_rng(seed)))
    assert got[0] == got[1]


def test_inf_bucket_resolves_to_last_finite_bound():
    for p in BOTH:
        h = p.ts.HistogramSeries("h", buckets=(1.0, 10.0))
        h.append(0.0, (0, 0, 0), 0.0, 0)
        h.append(1.0, (0, 0, 5), 5000.0, 5)
        assert h.percentile(99.0, 10.0, now=1.0) == 10.0


# -- SeriesBank ---------------------------------------------------------------


def _emit_serving(p, rng_seed=0):
    rng = np.random.default_rng(rng_seed)
    for i in range(3):
        p.obs.inc("serve.requests", index_id=f"idx{i}")
    p.obs.set_gauge("serve.queue_depth", 3.0)
    p.obs.inc("brute_force.search.calls")  # not tracked
    for v in rng.uniform(0.0, 30.0, 20):
        p.obs.observe("serve.time_in_queue_ms", float(v))


def test_series_bank_discovers_the_tracked_prefixes_as_jax(obs_on):
    got = []
    for p in BOTH:
        _emit_serving(p)
        bank = p.ts.SeriesBank(clock=VClock(1.0))
        bank.sample(p.obs.registry())
        assert "brute_force.search.calls" not in {s.name for s in bank.series()}
        (h,) = bank.find("serve.time_in_queue_ms")
        assert isinstance(h, p.ts.HistogramSeries) and h.latest()[3] == 20
        assert bank.get("serve.requests", index_id="idx1") is not None
        assert bank.get("serve.requests", index_id="zzz") is None
        got.append(bank.as_dict())
    assert got[0] == got[1]


def test_series_bank_overflow_is_counted_as_jax(obs_on):
    got = []
    for p in BOTH:
        _emit_serving(p)
        bank = p.ts.SeriesBank(max_series=2, clock=VClock(1.0))
        bank.sample(p.obs.registry())
        got.append((len(bank), bank.stats()))
    assert got[0] == got[1] and got[1][0] == 2 and got[1][1]["dropped"] > 0


def test_series_bank_sample_is_a_noop_with_obs_off():
    for p in BOTH:
        bank = p.ts.SeriesBank(clock=VClock(1.0))
        bank.sample()
        assert len(bank) == 0 and bank.stats()["samples"] == 0


# -- drift detectors ------------------------------------------------------------


def _replay(pairs):
    def extract(bank, now, window_s):
        return list(pairs)

    return extract


@pytest.mark.parametrize("mode,threshold", [("ratio_above", 2.0), ("ratio_below", 0.5),
                                            ("abs_above", 3.0)])
@pytest.mark.parametrize("seed", range(3))
def test_ewma_detector_fires_as_jax_s(mode, threshold, seed):
    rng = np.random.default_rng(200 + seed)
    values = np.abs(rng.standard_normal((40, 3))) * rng.choice([0.3, 1.0, 6.0], (40, 3))
    got = []
    for p in BOTH:
        pairs = []
        det = p.ts.EwmaDetector("sig", _replay(pairs), mode=mode, threshold=threshold,
                                alpha=0.3, warmup=3, min_baseline=0.1)
        bank = p.ts.SeriesBank()
        out = []
        for t, row in enumerate(values):
            pairs[:] = [(f"i{j}", float(x)) for j, x in enumerate(row)]
            out.append([a.as_dict() for a in det.check(bank, float(t))])
        got.append(out)
    assert got[0] == got[1]
    assert any(got[1])


def test_ewma_detector_rejects_an_unknown_mode():
    for p in BOTH:
        with pytest.raises(ValueError):
            p.ts.EwmaDetector("x", _replay([]), mode="bogus")


def test_default_detectors_over_a_serving_run_equal_jax_s(obs_on):
    """The four stock detectors over one scripted registry history: the
    same anomalies (latency drift, QPS cliff, coverage drop, burn slope)."""
    got = []
    for p in BOTH:
        clk = VClock(0.0)
        bank = p.ts.SeriesBank(clock=clk)
        dets = p.ts.default_detectors()
        reg = p.obs.registry()
        out = []
        for step in range(40):
            clk.advance(10.0)
            qps = 50 if step < 30 else 2
            for _ in range(qps):
                p.obs.inc("serve.requests", index_id="a")
            lat = 1.0 if step < 25 else 40.0
            for _ in range(5):
                p.obs.observe("serve.time_in_queue_ms", lat)
            p.obs.set_gauge("serve.coverage", 1.0 if step < 20 else 0.5, index_id="a")
            p.obs.set_gauge("slo.burn_rate", 0.1 * step if step > 30 else 0.0,
                            index_id="a", window="fast")
            bank.sample(reg)
            for d in dets:
                out.extend(sorted((a.signal, a.index_id, a.value, a.baseline, a.t)
                                  for a in d.check(bank, clk())))
        got.append(out)
    assert got[0] == got[1]
    assert {a[0] for a in got[1]} >= {"latency_drift", "qps_cliff", "coverage_drop"}


# -- SLO trackers ----------------------------------------------------------------


@pytest.mark.parametrize("latency_ms,target,burn", [(5.0, 0.9, 2.0), (None, 0.99, 5.0),
                                                    (1.0, 0.999, 10.0)])
@pytest.mark.parametrize("seed", range(2))
def test_slo_tracker_evaluates_as_jax_s(obs_on, latency_ms, target, burn, seed):
    """The same (dt, latency, ok) stream on one virtual clock: every
    ``evaluate`` snapshot, the ``slo.*`` gauges and counters equal."""
    rng = np.random.default_rng(300 + seed)
    events = [(float(rng.uniform(0.0, 3.0)), float(rng.exponential(4.0)),
               bool(rng.uniform() > 0.05)) for _ in range(300)]
    got = []
    for p in BOTH:
        clk = VClock(0.0)
        tr = p.slo.SloTracker(p.slo.SLO("idx", latency_ms=latency_ms, target=target,
                                        window_s=300.0, fast_window_s=20.0,
                                        slow_window_s=100.0, burn_threshold=burn), clock=clk)
        snaps = []
        for dt, lat, ok in events:
            clk.advance(dt)
            tr.record(latency_ms=lat, ok=ok)
            snaps.append(tr.evaluate().as_dict())
        got.append((snaps, _counters(p, "slo."), _gauges(p, "slo.")))
    assert got[0] == got[1]


def test_slo_validation_equals_jax_s():
    bad = [dict(target=1.0), dict(latency_ms=0.0), dict(fast_window_s=500.0),
           dict(burn_threshold=0.0)]
    for kw in bad:
        with pytest.raises(Exception) as je:
            jslo.SLO("a", **kw)
        with pytest.raises(Exception) as te:
            tslo.SLO("a", **kw)
        assert type(je.value).__name__ == type(te.value).__name__


def _engines(bf_pair, clk, **kw):
    j = JEngine(max_batch=8, max_wait_ms=0.0, clock=clk, **kw)
    t = TEngine(max_batch=8, max_wait_ms=0.0, clock=clk, res=CPU, **kw)
    j.register("wiki", "brute_force", bf_pair[0])
    t.register("wiki", "brute_force", bf_pair[1])
    return j, t


def test_engine_slo_health_and_burn_equal_jax_s(obs_on, corpus, bf_pair):
    """``set_slo`` on both engines, one virtual clock: requests that
    complete late, on time and past their deadline give the same
    ``health()["indexes"][id]["slo"]`` and ``slo_burn``."""
    _, Q = corpus
    out = []
    for which in (0, 1):
        clk = VClock(0.0)
        eng = _engines(bf_pair, clk)[which]
        # built before the stream: the admission estimate then follows the
        # served batches, not a first build
        eng.warmup("wiki", 5)
        assert eng.health()["indexes"]["wiki"]["slo"] is None and eng.slo_burn("wiki") is None
        eng.set_slo("wiki", latency_ms=5.0, target=0.9, fast_window_s=10.0,
                    slow_window_s=30.0, window_s=60.0, burn_threshold=2.0)
        trail = []
        for i in range(12):
            fut = eng.submit("wiki", Q[i : i + 2], 5, deadline_ms=25.0 if i % 4 == 3 else None)
            clk.advance(0.030 if i % 3 == 0 else 0.001)  # late, or on time (or shed)
            eng.step(force=True)
            assert fut.done()
            trail.append((eng.health()["indexes"]["wiki"]["slo"], eng.slo_burn("wiki")))
        out.append(trail)
    assert out[0] == out[1]
    assert out[1][-1][0]["bad"] > 0 and out[1][-1][0]["alerts_fired"] >= 1


def test_evict_queued_equals_jax_s(corpus, bf_pair):
    _, Q = corpus
    clk = VClock(0.0)
    j, t = _engines(bf_pair, clk)
    got = []
    for eng in (j, t):
        futs = [eng.submit("wiki", Q[i : i + 3], 5) for i in range(4)]
        evicted = eng.evict_queued()
        got.append(([r.n_rows for r in evicted], eng.queue_depth(),
                     [f.done() for f in futs], eng.run_until_idle()))
    assert got[0] == got[1] == ([3, 3, 3, 3], 0, [False] * 4, 0)


# -- the flight recorder: events and triggers --------------------------------------


def _recorders(tmp_path, t0=0.0, **kw):
    """One recorder a package, each on its own virtual clock at ``t0``."""
    return [p.rec.FlightRecorder(str(tmp_path / p.name), clock=VClock(t0), **kw)
            for p in BOTH]


def _strip(events):
    return [{k: v for k, v in e.items()} for e in events]


def test_event_ring_is_bounded_and_windowed_as_jax(obs_on, tmp_path):
    got = []
    for r in _recorders(tmp_path, max_events=8):
        for i in range(20):
            r.note_fault("wal.append", "latency")
        r._clock.advance(100.0)
        r.note_breaker("replica1", "half_open")
        got.append((len(r.events()), _strip(r.events(window_s=10.0))))
    assert got[0] == got[1] and got[1][0] == 8


def test_gated_off_notes_record_nothing(tmp_path):
    for r in _recorders(tmp_path):
        r.note_fault("wal.append", "error")
        r.note_breaker("replica0", "open")
        assert r.events() == [] and r._pending[0] is None and r.dump() is None
    for p in BOTH:
        assert p.rec.list_bundles(str(tmp_path / p.name)) == []


def test_error_fault_latches_and_tick_drains_as_jax(obs_on, tmp_path):
    got = []
    for p, r in zip(BOTH, _recorders(tmp_path, t0=10.0)):
        r.note_fault("wal.append", "error")
        assert r._pending[0] is not None
        assert p.rec.list_bundles(str(tmp_path / p.name)) == []
        r._clock.advance(1.0)
        r.tick(p.obs.registry())
        (path,) = p.rec.list_bundles(str(tmp_path / p.name))
        got.append((os.path.basename(path), p.rec.load_bundle(path)["trigger"], r._pending[0]))
    assert got[0] == got[1]
    assert got[1][1] == {"cause": "fault", "ctx": {"point": "wal.append", "fault_kind": "error",
                                                   "latched_t": 10.0}, "t": 11.0}


def test_latency_faults_never_latch(obs_on, tmp_path):
    for r in _recorders(tmp_path):
        r.note_fault("serve.dispatch", "latency")
        assert r._pending[0] is None
        assert [e["fault_kind"] for e in r.events()] == ["latency"]


def test_breaker_open_dumps_inline_as_jax(obs_on, tmp_path):
    got = []
    for p, r in zip(BOTH, _recorders(tmp_path, t0=5.0)):
        assert r.note_breaker("replica2", "half_open") is None
        path = r.note_breaker("replica2", "open")
        got.append((os.path.basename(path), p.rec.load_bundle(path)["trigger"]))
    assert got[0] == got[1] and got[1][1]["cause"] == "breaker"


def test_auto_dumps_debounce_manual_does_not(obs_on, tmp_path):
    got = []
    for r in _recorders(tmp_path, min_dump_interval_s=5.0, t0=0.0):
        seq = [r.note_breaker("a", "open") is not None]
        r._clock.advance(1.0)
        seq += [r.note_breaker("b", "open") is not None, r.dump() is not None]
        r._clock.advance(5.0)
        seq += [r.note_breaker("c", "open") is not None, len(r.dumps())]
        got.append(seq)
    assert got[0] == got[1] == [True, False, True, True, 3]


def test_untriggered_causes_do_not_dump(obs_on, tmp_path):
    for p, r in zip(BOTH, _recorders(tmp_path, triggers=("slo",))):
        assert r.note_breaker("a", "open") is None
        assert r.note_plan_flip("i", 3) is None
        assert r.note_election("g", 2, "f0", "expiry") is None
        assert p.rec.list_bundles(str(tmp_path / p.name)) == []


def test_bundle_body_shape_equals_jax_s(obs_on, tmp_path):
    shapes = []
    for p, r in zip(BOTH, _recorders(tmp_path, t0=1.0)):
        p.obs.inc("serve.requests", index_id="a")
        p.obs.inc("brute_force.search.calls")
        p.obs.observe("serve.time_in_queue_ms", 4.0, trace_id="t-1")
        p.obs.registry().record_span("serve.queue", 0.0, 4000.0, 1, 0, trace=("t-1",))
        r.tick(p.obs.registry())
        path = r.dump(ctx={"who": "test"})
        b = p.rec.load_bundle(path)
        assert b["format"] == "raft_tpu.obs_bundle"
        assert b["trigger"] == {"cause": "manual", "ctx": {"who": "test"}, "t": 1.0}
        names = {s["name"] for s in b["series"]["series"]}
        assert "serve.requests" in names and "brute_force.search.calls" not in names
        assert b["slow_traces"][0]["trace_id"] == "t-1"
        assert {s["name"] for s in b["slow_traces"][0]["spans"]} == {"serve.queue"}
        assert r.dumps() == [path]
        shapes.append((sorted(b), b["series"], b["metrics"]["counters"],
                       sorted(b["lockcheck"]), sorted(b["health"])))
    assert shapes[0] == shapes[1]


def test_tick_sampling_is_rate_limited_as_jax(obs_on, tmp_path):
    got = []
    for p, r in zip(BOTH, _recorders(tmp_path, sample_interval_s=1.0, t0=0.0)):
        reg = p.obs.registry()
        p.obs.inc("serve.requests", index_id="a")
        trail = []
        r.tick(reg)
        trail.append(r._bank.stats()["samples"])
        r._clock.advance(0.2)
        r.note_fault("wal.append", "error")
        r.tick(reg)  # the latched dump's at-trigger sample
        trail.append(r._bank.stats()["samples"])
        r._clock.advance(0.2)
        r.tick(reg)  # inside the interval
        trail.append(r._bank.stats()["samples"])
        r._clock.advance(1.0)
        r.tick(reg)
        trail.append(r._bank.stats()["samples"])
        got.append(trail)
    assert got[0] == got[1] == [1, 2, 2, 3]


# -- bundles and traces across the packages -----------------------------------------


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_a_bundle_loads_in_the_other_package(obs_on, tmp_path, writer):
    src, dst = (T, J) if writer == "torch" else (J, T)
    src.obs.inc("serve.requests", index_id="a")
    src.obs.observe("serve.time_in_queue_ms", 7.0, trace_id="t-9")
    r = src.rec.FlightRecorder(str(tmp_path), clock=VClock(3.0))
    r.note_fault("wal.append", "latency")
    path = r.dump(ctx={"n": 1})
    assert dst.rec.list_bundles(str(tmp_path)) == [path]
    assert dst.rec.load_bundle(path) == src.rec.load_bundle(path)
    with open(path, "rb") as f:
        blob = bytearray(f.read())
    blob[-3] ^= 0xFF
    bad = str(tmp_path / "bad.raftbundle")
    with open(bad, "wb") as f:
        f.write(bytes(blob))
    for p in BOTH:
        with pytest.raises(Exception, match="CRC"):
            p.rec.load_bundle(bad)


def _traced_registry(p):
    reg = p.obs.registry()
    with p.obs.trace_scope(("r-1", "r-2")):
        with p.obs.span("serve.dispatch", algo="bf", bucket=8):
            with p.obs.span("brute_force.search"):
                pass
    reg.record_span("serve.queue", reg.now_us() - 500.0, 400.0, 7, 0, trace=("r-1",))
    p.obs.inc("serve.batches", index_id="a")
    return reg


@pytest.mark.parametrize("producer", ["torch", "jax"])
def test_chrome_trace_passes_the_other_package_s_validator(obs_on, tmp_path, producer):
    src, dst = (T, J) if producer == "torch" else (J, T)
    doc = src.export.chrome_trace(_traced_registry(src))
    dst.export.validate_trace(doc)
    phases = sorted({e["ph"] for e in doc["traceEvents"]})
    assert phases == ["C", "X", "f", "s", "t"]
    path = src.export.write_trace(str(tmp_path / "trace.json"))
    assert dst.export.load_trace(path)["traceEvents"]
    jl = src.export.write_metrics_jsonl(str(tmp_path / "m.jsonl"))
    assert os.path.getsize(jl) > 0


def test_chrome_trace_events_equal_jax_s_up_to_times(obs_on):
    docs = []
    for p in BOTH:
        doc = p.export.chrome_trace(_traced_registry(p))
        docs.append(sorted((e["ph"], e["name"], e.get("id"), tuple(sorted(e.get("args", {})
                                                                         .keys())))
                           for e in doc["traceEvents"]))
    assert docs[0] == docs[1]


def test_validate_trace_rejects_what_jax_rejects():
    bad = [[], {"traceEvents": 1}, {"traceEvents": [{"ph": "X", "name": "a", "ts": 0}]},
           {"traceEvents": [{"ph": "X", "name": "a", "ts": 0, "dur": -1, "pid": 1, "tid": 1}]},
           {"traceEvents": [{"ph": "C", "name": "a"}]},
           {"traceEvents": [{"ph": "s", "name": "a", "id": True, "ts": 0, "pid": 1, "tid": 1}]}]
    for doc in bad:
        for p in BOTH:
            with pytest.raises(ValueError):
                p.export.validate_trace(doc)


# -- the recorder.dump seam: a torn dump ---------------------------------------------


def test_torn_dump_leaves_no_file_as_jax(obs_on, tmp_path):
    got = []
    for p, r in zip(BOTH, _recorders(tmp_path, t0=1.0)):
        p.obs.inc("serve.requests", index_id="a")
        spec_seen = []
        with p.faults.injected("recorder.dump", error=RuntimeError("torn"),
                               match={"cause": "manual"}) as spec:
            assert r.dump() is None
            spec_seen.append((spec.calls, spec.fired))
        d = str(tmp_path / p.name)
        assert p.rec.list_bundles(d) == [] and os.listdir(d) == []
        assert r._pending[0] is None  # its own seam never latches a dump
        path = r.dump()
        assert p.rec.load_bundle(path)["trigger"]["cause"] == "manual"
        got.append((spec_seen, _counters(p, "recorder.dump_failures"),
                    _counters(p, "faults.fired")))
    assert got[0] == got[1]
    assert got[1][0] == [(1, 1)]


def test_a_killed_dump_never_leaves_a_torn_bundle(obs_on, tmp_path):
    """A kill at the seam, for any of the first dumps: every bundle on
    disk is CRC-valid, the killed ones are absent."""
    r = trec.FlightRecorder(str(tmp_path), clock=VClock(1.0), min_dump_interval_s=0.0)
    tfaults.enable()
    tfaults.install("recorder.dump", error=RuntimeError("kill"), trigger="nth", nth=1)
    paths = [r.dump(cause="manual") for _ in range(3)]
    assert paths[1] is None and paths[0] and paths[2]
    listed = trec.list_bundles(str(tmp_path))
    assert listed == [paths[0], paths[2]]
    for path in listed:
        jrec.load_bundle(path)
        trec.load_bundle(path)


# -- the SLO drill, gates-off parity ---------------------------------------------------


def test_slo_alert_dumps_exactly_one_complete_bundle(corpus, bf_pair, tmp_path):
    """JAX's SLO drill on the port's engine: every request breaches a 1 ms
    objective (a 20 ms latency fault at ``serve.dispatch``); the alert
    fires once and yields exactly one CRC-valid bundle, which JAX loads."""
    _, Q = corpus
    tobs.enable()
    r = trec.install(str(tmp_path), triggers=("slo",), min_dump_interval_s=300.0, slow_traces=3)
    eng = TEngine(max_batch=8, max_wait_ms=0.0, maintenance_interval_ms=1.0, res=CPU)
    r.attach_engine(eng)
    eng.register("wiki", "brute_force", bf_pair[1])
    with tfaults.injected("serve.dispatch", latency_s=0.02):
        for i in range(3):
            eng.submit("wiki", Q[i : i + 1], k=5)
            eng.run_until_idle()
        eng.set_slo("wiki", latency_ms=1.0, target=0.9, burn_threshold=2.0)
        for i in range(3):
            eng.submit("wiki", Q[i : i + 1], k=5)
            eng.run_until_idle()
    (path,) = trec.list_bundles(str(tmp_path))
    bundle = trec.load_bundle(path)
    assert jrec.load_bundle(path) == bundle
    assert bundle["trigger"]["cause"] == "slo" and bundle["trigger"]["ctx"]["index_id"] == "wiki"
    kinds = {e["kind"] for e in bundle["events"]}
    assert {"fault", "slo"} <= kinds
    slo_events = [e for e in bundle["events"] if e["kind"] == "slo"]
    assert slo_events[-1]["transition"] == "fire" and slo_events[-1]["burn_fast"] >= 2.0
    tiq = [s for s in bundle["series"]["series"] if s["name"] == "serve.time_in_queue_ms"]
    assert tiq and tiq[0]["points"][0][0] <= bundle["trigger"]["t"]
    slowest = bundle["slow_traces"][0]
    assert {"serve.queue", "serve.dispatch"} <= {s["name"] for s in slowest["spans"]}
    assert sorted(slowest["spans"], key=lambda s: s["ts_us"])[0]["name"] == "serve.queue"
    (h,) = bundle["health"]["engines"]
    assert h["indexes"]["wiki"]["slo"]["alerting"] is True
    assert h["indexes"]["wiki"]["slo"]["alerts_fired"] == 1
    assert "wiki" in bundle["plans"]
    assert _counters(T, "recorder.dumps") == {'recorder.dumps{cause="slo"}': 1.0}


def test_installed_recorder_with_obs_off_changes_nothing(corpus, bf_pair, tmp_path):
    _, Q = corpus

    def serve(p, idx, eng_cls, install, **kw):
        r = p.rec.install(str(tmp_path / p.name)) if install else None
        eng = eng_cls(max_batch=8, max_wait_ms=0.0, maintenance_interval_ms=0.0, **kw)
        eng.register("wiki", "brute_force", idx)
        futs = [eng.submit("wiki", Q[i : i + 8], k=10) for i in range(3)]
        eng.run_until_idle()
        return [f.result() for f in futs], r

    base, _ = serve(T, bf_pair[1], TEngine, False, res=CPU)
    res, r = serve(T, bf_pair[1], TEngine, True, res=CPU)
    ref, _ = serve(J, bf_pair[0], JEngine, False)
    for a, b, c in zip(base, res, ref):
        assert np.array_equal(a.indices, b.indices) and np.array_equal(a.distances, b.distances)
        assert np.array_equal(b.indices, np.asarray(c.indices))
        np.testing.assert_allclose(b.distances, np.asarray(c.distances), rtol=1e-5)
    assert r.events() == [] and r._bank.stats()["samples"] == 0 and r.dump() is None
    assert trec.list_bundles(str(tmp_path / "torch")) == []


def test_module_level_hooks_noop_without_an_active_recorder(obs_on):
    for p in BOTH:
        p.rec.uninstall()
        p.rec.note_fault("wal.append", "error")
        p.rec.note_breaker("a", "open")
        p.rec.note_election("g", 2, "f0", "expiry")
        p.rec.tick()
        assert p.rec.dump() is None and p.rec.installed() is None


# -- the hooks the port wires ------------------------------------------------------------


def test_faults_fire_notes_the_fault_as_jax(obs_on, tmp_path):
    got = []
    for p in BOTH:
        r = p.rec.install(str(tmp_path / p.name), clock=VClock(2.0))
        with p.faults.injected("wal.append", error=OSError("disk")):
            with pytest.raises(OSError):
                p.faults.fire("wal.append", stage="pre")
        got.append((_strip(r.events()), r._pending[0]))
    assert got[0] == got[1]
    assert got[1][0] == [{"point": "wal.append", "fault_kind": "OSError", "t": 2.0,
                          "kind": "fault"}]


def test_breaker_transitions_note_the_recorder_as_jax(obs_on, tmp_path):
    got = []
    for p in BOTH:
        clk = VClock(0.0)
        r = p.rec.install(str(tmp_path / p.name), clock=clk, min_dump_interval_s=0.0)
        b = p.retry.CircuitBreaker("peer", failure_threshold=2, reset_timeout_s=1.0, clock=clk)
        b.record_failure()
        b.record_failure()  # open: dumps inline
        clk.advance(2.0)
        assert b.allow()  # half-open
        b.record_success()  # closed
        got.append(([(e["target"], e["to"]) for e in r.events()],
                    [os.path.basename(x) for x in r.dumps()]))
    assert got[0] == got[1]
    assert got[1] == ([("peer", "open"), ("peer", "half_open"), ("peer", "closed")],
                      ["bundle-0001-breaker.raftbundle"])


def test_compactor_worker_death_notes_the_recorder(obs_on, tmp_path):
    from raft_tpu_torch.mutable import Compactor, MutableIndex

    class Kill(RuntimeError):
        pass

    r = trec.install(str(tmp_path / "bundles"), clock=VClock(4.0))
    mut = MutableIndex.open(str(tmp_path / "m"), "brute_force", 8, device="cpu")
    mut.insert(np.random.default_rng(0).standard_normal((32, 8)).astype(np.float32))
    comp = Compactor(mut, poll_interval_s=0.002)
    old_hook = threading.excepthook
    threading.excepthook = lambda args: None
    try:
        comp.start()
        with tfaults.injected("compact.worker", Kill("die"), trigger="first_n", first_n=1):
            assert comp.request()
            assert comp.wait_idle(timeout_s=30.0)
    finally:
        threading.excepthook = old_hook
        comp.stop()
    mut.close()
    assert comp.worker_restarts == 1
    assert [e for e in r.events() if e["kind"] == "worker_death"] == [
        {"index": comp.name, "t": 4.0, "kind": "worker_death"}]
    (path,) = [p for p in r.dumps() if "-worker." in p]
    assert trec.load_bundle(path)["trigger"]["ctx"] == {"index": comp.name}


def test_engine_tick_samples_the_installed_recorder(obs_on, corpus, bf_pair, tmp_path):
    _, Q = corpus
    clk = VClock(0.0)
    r = trec.install(str(tmp_path), clock=clk, sample_interval_s=0.5)
    eng = TEngine(max_batch=8, max_wait_ms=0.0, maintenance_interval_ms=0.0, clock=clk, res=CPU)
    eng.register("wiki", "brute_force", bf_pair[1])
    for i in range(4):
        eng.submit("wiki", Q[i : i + 1], 5)
        eng.run_until_idle()
        clk.advance(0.5)
    assert r._bank.stats()["samples"] == 4
    assert r._bank.get("serve.requests", index_id="wiki", algo="brute_force") is not None


def test_a_plan_flip_notes_the_recorder(obs_on, tmp_path):
    from raft_tpu_torch import plan
    from raft_tpu_torch.neighbors import ivf_flat

    rng = np.random.default_rng(7)
    X = rng.standard_normal((512, 8)).astype(np.float32)
    flat = ivf_flat.build(X, ivf_flat.IvfFlatIndexParams(n_lists=8), res=CPU)
    r = trec.install(str(tmp_path), clock=VClock(9.0), min_dump_interval_s=0.0)
    eng = TEngine(max_batch=16, max_wait_ms=0.0, res=CPU)
    eng.register("drift", "ivf_flat", flat, params=ivf_flat.IvfFlatSearchParams(n_probes=4))
    for _ in range(plan.TRAFFIC_MIN_SAMPLES + 2):
        eng.submit("drift", X[:7], k=5)
        eng.run_until_idle()
    eng.maintenance_tick()
    assert eng._indexes["drift"].plan.epoch == 1
    flips = [e for e in r.events() if e["kind"] == "plan_flip"]
    assert flips == [{"index_id": "drift", "epoch": 1, "t": 9.0, "kind": "plan_flip"}]
    assert any(p.endswith("-plan_flip.raftbundle") for p in r.dumps())
