"""The port's cost planner (``raft_tpu_torch.plan``) against raft_tpu's.

* every resolver gives the JAX resolver's choice, and each candidate its
  cost and eligibility, on the same inputs (``on_tpu`` <-> ``on_cuda``)
  over the envelope ``tests/test_plan.py`` sweeps;
* with the gate on, each of the port's ``auto`` sites (the IVF search
  engine, CAGRA's engine, the merge engine, the mutable delta route, the PQ
  code family) resolves as its inline rule does, across batches of 1 to
  1,024 on a CPU and a CUDA index; serving gives the same bits with
  ``RAFT_TPU_PLAN`` on and off;
* ``plan_explain`` carries every candidate; the re-plan tick flips on a
  traffic shift, re-costs without an epoch, holds inside its hysteresis,
  keeps programs within engines x buckets, re-costs a growing mutable
  index, and never plans a pinned mode (``tests/test_plan.py:265-370``).
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

from raft_tpu import obs as jobs
from raft_tpu import plan as jplan
from raft_tpu_torch import obs
from raft_tpu_torch import plan
from raft_tpu_torch.core.resources import Resources
from raft_tpu_torch.mutable import MutableIndex, segments
from raft_tpu_torch.neighbors import cagra, ivf_common, ivf_flat, ivf_pq
from raft_tpu_torch.parallel import sharded_ann
from raft_tpu_torch.serve import ServingEngine
from raft_tpu_torch.serve.bucketing import bucket_sizes

NQ_SWEEP = list(range(1, 16)) + [63, 64, 126, 127, 128, 129, 192, 256, 1024]
BUCKETS = [1 << i for i in range(11)]  # 1 .. 1,024
CPU = Resources(device="cpu")


def assert_same_plan(t, j):
    """Same choice, and each candidate the same cost and eligibility."""
    assert t.choice == j.choice, (t.explain(), j.explain())
    assert [c.name for c in t.candidates] == [c.name for c in j.candidates]
    for tc, jc in zip(t.candidates, j.candidates):
        assert tc.eligible == jc.eligible, (tc, jc)
        assert tc.cost == jc.cost or (math.isinf(tc.cost) and math.isinf(jc.cost)), (tc, jc)
        assert [(x.name, x.value) for x in tc.terms] == [(x.name, x.value) for x in jc.terms]


def test_gate_default_on_and_env_off(monkeypatch):
    monkeypatch.delenv("RAFT_TPU_PLAN", raising=False)
    assert plan.is_enabled() and jplan.is_enabled()
    for off in ("0", "false", "OFF", " no "):
        monkeypatch.setenv("RAFT_TPU_PLAN", off)
        assert not plan.is_enabled() and not jplan.is_enabled()
    monkeypatch.setenv("RAFT_TPU_PLAN", "1")
    assert plan.is_enabled()


# -- every resolver against JAX's ---------------------------------------------------------


@pytest.mark.parametrize("wants_f32_lut", [False, True])
@pytest.mark.parametrize("fused_ok", [False, True])
@pytest.mark.parametrize("on", [False, True])
def test_search_mode_matches_jax(on, fused_ok, wants_f32_lut):
    for nq in NQ_SWEEP:
        for algo in ("ivf_pq", "ivf_flat"):
            assert_same_plan(
                plan.plan_search_mode(algo, nq, on_cuda=on, fused_ok=fused_ok,
                                      wants_f32_lut=wants_f32_lut),
                jplan.plan_search_mode(algo, nq, on_tpu=on, fused_ok=fused_ok,
                                       wants_f32_lut=wants_f32_lut))


@pytest.mark.parametrize("fused_ok", [False, True])
@pytest.mark.parametrize("on", [False, True])
def test_cagra_mode_matches_jax(on, fused_ok):
    for nq in NQ_SWEEP:
        assert_same_plan(plan.plan_cagra_mode(nq, on_cuda=on, fused_ok=fused_ok),
                         jplan.plan_cagra_mode(nq, on_tpu=on, fused_ok=fused_ok))


def test_merge_mode_matches_jax():
    for n_shards in (1, 2, 3, 4, 8, 16):
        for k in (1, 5, 10, 64, 128):
            for width in (None, k, 4 * k, 64):
                assert_same_plan(plan.plan_merge_mode(n_shards, k, tile_width=width),
                                 jplan.plan_merge_mode(n_shards, k, tile_width=width))
    assert plan.plan_merge_mode(4, 10, tile_width=64).choice == "fused_ring"


def test_comm_mode_matches_jax():
    for n_shards in (1, 2, 4, 8):
        for n_rows in (4, 32, 256, 4096):
            for d in (8, 64, 768):
                for cap in (None, 4):
                    assert_same_plan(plan.plan_comm_mode(n_rows, d, n_shards, ca_cap=cap),
                                     jplan.plan_comm_mode(n_rows, d, n_shards, ca_cap=cap))


@pytest.mark.parametrize("eligible", [False, True])
@pytest.mark.parametrize("on", [False, True])
def test_delta_mode_matches_jax(eligible, on):
    assert_same_plan(plan.plan_delta_mode(eligible=eligible, on_cuda=on),
                     jplan.plan_delta_mode(eligible=eligible, on_tpu=on))


@pytest.mark.parametrize("per_subspace", [False, True])
def test_pq_kind_and_sparse_mode_match_jax(per_subspace):
    for pq_bits in range(1, 9):
        for pq_dim in (4, 16, 64):
            assert_same_plan(plan.plan_pq_kind(pq_bits, per_subspace, pq_dim=pq_dim),
                             jplan.plan_pq_kind(pq_bits, per_subspace, pq_dim=pq_dim))
    B = 1 << 18
    for n_cols in (16, B - 1, B, B + 1, B * 4):
        assert_same_plan(plan.plan_sparse_mode(n_cols, native_ok=per_subspace),
                         jplan.plan_sparse_mode(n_cols, native_ok=per_subspace))


def test_decisions_counted_as_jax():
    def run(o, p, **on):
        reg = o.registry()
        reg.reset()
        o.enable()
        try:
            p.plan_merge_mode(4, 10)
            p.plan_search_mode("ivf_pq", 8, fused_ok=True, **on)
            return reg.as_dict()["counters"]
        finally:
            o.disable()
            reg.reset()

    assert run(obs, plan, on_cuda=False) == run(jobs, jplan, on_tpu=False)


# -- the port's auto sites: planner == inline rule -------------------------------------------


def _both_ways(monkeypatch, fn):
    """``fn()`` with the gate on, then off (a raised error as its type and
    message)."""
    out = []
    for gate in ("1", "0"):
        monkeypatch.setenv("RAFT_TPU_PLAN", gate)
        try:
            out.append(fn())
        except Exception as e:  # the inline rule's own checks, both ways
            out.append((type(e), str(e)))
    return out


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_ivf_auto_site_resolves_as_its_inline_rule(monkeypatch, device):
    for nq in BUCKETS + [127, 129]:
        for fused_ok in (False, True):
            for scan_ok in (False, True):
                on, off = _both_ways(monkeypatch, lambda: ivf_common.auto_search_mode(
                    torch.device(device), nq, fused_ok, scan_ok=scan_ok, algo="ivf_pq"))
                assert on == off, (device, nq, fused_ok, scan_ok)


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_cagra_auto_site_resolves_as_its_inline_rule(monkeypatch, device):
    for nq in BUCKETS:
        for eligible in (False, True):
            on, off = _both_ways(monkeypatch, lambda: cagra.auto_mode(torch.device(device), nq,
                                                                      eligible))
            assert on == off, (device, nq, eligible)


def test_cagra_auto_search_same_bits_gate_on_and_off(monkeypatch):
    rng = np.random.default_rng(3)
    idx = cagra.build(rng.standard_normal((400, 16)).astype(np.float32),
                      cagra.CagraIndexParams(intermediate_graph_degree=16, graph_degree=8),
                      res=CPU)
    q = rng.standard_normal((5, 16)).astype(np.float32)
    on, off = _both_ways(monkeypatch, lambda: cagra.search(idx, q, 5, cagra.CagraSearchParams(
        itopk_size=16)))
    assert torch.equal(on[1], off[1]) and torch.equal(on[0], off[0])


@pytest.mark.parametrize("device", ["cpu", "cuda", None])
def test_delta_route_resolves_as_its_inline_rule(monkeypatch, device):
    from raft_tpu_torch.ops.distance import DistanceType

    for metric in (DistanceType.L2Expanded, DistanceType.CosineExpanded):
        for cap in (1024, 32 * 1024, 64 * 1024):
            for k in (10, 200):
                on, off = _both_ways(monkeypatch, lambda: segments._delta_route(
                    "auto", metric, cap, k, device))
                assert on == off, (device, metric, cap, k)


def test_merge_and_pq_kind_sites_resolve_as_their_inline_rules(monkeypatch):
    for n_shards in (1, 2, 4, 8):
        for k in (1, 10, 100):
            on, off = _both_ways(monkeypatch,
                                 lambda: sharded_ann._resolve_merge_mode("auto", n_shards, k))
            assert on == off
    for pq_bits in range(1, 9):
        for kind in (ivf_pq.PER_SUBSPACE, ivf_pq.PER_CLUSTER):
            for pq_dim in (0, 8):
                p = ivf_pq.IvfPqIndexParams(pq_bits=pq_bits, codebook_kind=kind, pq_dim=pq_dim)
                on, off = _both_ways(monkeypatch, lambda: ivf_pq._resolve_kind(p))
                assert on == off


def test_on_cuda_needs_a_cuda_device_of_capability_9(monkeypatch):
    assert not plan.on_cuda("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_capability", lambda d=None: (9, 0))
    assert plan.on_cuda("cuda:0")
    monkeypatch.setattr(torch.cuda, "get_device_capability", lambda d=None: (8, 0))
    assert not plan.on_cuda(torch.device("cuda", 0))
    assert "capability 9.x" in plan.plan_search_mode(
        "ivf_flat", 256, on_cuda=False, fused_ok=True).explain()


# -- serving bits with the gate on and off ----------------------------------------------------


@pytest.fixture(scope="module")
def small():
    rng = np.random.default_rng(11)
    X = rng.standard_normal((512, 16)).astype(np.float32)
    Q = rng.standard_normal((300, 16)).astype(np.float32)
    flat = ivf_flat.build(X, ivf_flat.IvfFlatIndexParams(n_lists=8, seed=3), res=CPU)
    return X, Q, flat


@pytest.mark.parametrize("algo", ["ivf_flat", "ivf_pq", "rabitq"])
def test_engine_serving_bit_identical_gate_on_and_off(monkeypatch, small, algo):
    X, Q, flat = small
    if algo == "ivf_flat":
        idx, sp = flat, ivf_flat.IvfFlatSearchParams(n_probes=4)
    else:
        kw = dict(pq_bits=1) if algo == "rabitq" else dict(pq_dim=8)
        idx = ivf_pq.build(X, ivf_pq.IvfPqIndexParams(n_lists=8, seed=3, **kw), res=CPU)
        sp = ivf_pq.IvfPqSearchParams(n_probes=4)
    sizes = [1, 3, 7, 30, 64, 128, 67]

    def serve():
        eng = ServingEngine(max_batch=128, max_wait_ms=0.0, res=CPU)
        eng.register("t", "ivf_flat" if algo == "ivf_flat" else "ivf_pq", idx, params=sp,
                     dataset=torch.from_numpy(X))
        out, s = [], 0
        for m in sizes:
            fut = eng.submit("t", Q[s : s + m], k=5)
            eng.run_until_idle()
            out.append(fut.result())
            s += m
        return eng, out

    (e_on, on), (e_off, off) = _both_ways(monkeypatch, serve)
    assert e_on._indexes["t"].plan is not None and e_off._indexes["t"].plan is None
    modes = dict(e_on._indexes["t"].plan.bucket_modes)
    # a CPU index: the dense scan from 128 queries, RaBitQ's too (as JAX)
    assert modes[64] == "probe" and modes[128] == "scan"
    for a, b in zip(on, off):
        np.testing.assert_array_equal(a.indices, b.indices)
        np.testing.assert_array_equal(a.distances, b.distances)


# -- explain ----------------------------------------------------------------------------------


def test_plan_explain_carries_every_candidate():
    text = plan.plan_search_mode("ivf_pq", 8, on_cuda=False, fused_ok=False).explain()
    for part in ("ivf_pq.search_mode", "probe", "scan", "fused", "ineligible", "cu", "nq=8"):
        assert part in text
    text = plan.plan_search_mode("ivf_pq", 256, on_cuda=True, fused_ok=True, scan_ok=False,
                                 scan_reason="no scan here").explain()
    assert "no scan here" in text and "fused" in text.splitlines()[0]


def test_registration_plan_explain(small):
    _, _, flat = small
    eng = ServingEngine(max_batch=16, max_wait_ms=0.0, res=CPU)
    eng.register("exp", "ivf_flat", flat, params=ivf_flat.IvfFlatSearchParams(n_probes=4))
    text = eng.plan_explain("exp")
    assert "plan[exp]" in text and "epoch=0" in text and "bucket modes:" in text
    for b in bucket_sizes(16):
        assert f" {b}→" in text
    assert text.count("plan ivf_flat.search_mode") == len(bucket_sizes(16))


# -- re-planning ---------------------------------------------------------------------------------


@pytest.fixture
def serve_obs():
    reg = obs.registry()
    reg.reset()
    obs.enable()
    yield reg
    obs.disable()
    reg.reset()


def _counter(registry, name, **labels):
    total = 0.0
    for key, value in registry.as_dict()["counters"].items():
        if key.startswith(name) and all(f'{k}="{v}"' in key for k, v in labels.items()):
            total += value
    return total


def _drift_engine(flat, max_batch=16):
    eng = ServingEngine(max_batch=max_batch, max_wait_ms=0.0, res=CPU)
    eng.register("drift", "ivf_flat", flat, params=ivf_flat.IvfFlatSearchParams(n_probes=4))
    return eng


def _pump(eng, Q, nq, batches, k=5):
    outs = []
    for _ in range(batches):
        fut = eng.submit("drift", Q[:nq], k=k)
        eng.run_until_idle()
        outs.append(fut.result())
    return outs


def test_traffic_shift_flips_plan_without_caller_error(small, serve_obs):
    _, Q, flat = small
    eng = _drift_engine(flat)
    plan0 = eng._indexes["drift"].plan
    assert plan0.epoch == 0
    _pump(eng, Q, nq=7, batches=plan.TRAFFIC_MIN_SAMPLES + 2)
    eng.maintenance_tick()
    plan1 = eng._indexes["drift"].plan
    assert plan1.epoch == 1 and plan1.dominant_bucket == 8 and 8 in plan1.warm_buckets
    assert _counter(serve_obs, "serve.plan_flips", index_id="drift") == 1
    assert serve_obs.as_dict()["gauges"]['serve.plan.epoch{index_id="drift"}'] == 1.0
    assert {"plan.build", "plan.flip"} <= {s["name"] for s in serve_obs.spans()}
    assert _pump(eng, Q, nq=7, batches=2)[-1].indices.shape == (7, 5)


def test_recost_without_decision_change_keeps_epoch(small, serve_obs):
    _, Q, flat = small
    eng = _drift_engine(flat)
    reg = eng._indexes["drift"]
    _pump(eng, Q, nq=7, batches=plan.TRAFFIC_MIN_SAMPLES + 2)
    eng.maintenance_tick()
    epoch = reg.plan.epoch
    _pump(eng, Q, nq=7, batches=plan.TRAFFIC_MIN_SAMPLES + 2)
    anchor = int(reg.plan.corpus_rows // (plan.GROWTH_REPLAN_FACTOR * 2))
    reg.plan = dataclasses.replace(reg.plan, corpus_rows=anchor)
    eng.maintenance_tick()
    assert _counter(serve_obs, "serve.plan.recosts", index_id="drift") == 1
    assert reg.plan.epoch == epoch and reg.plan.corpus_rows == 512
    assert _counter(serve_obs, "serve.plan_flips", index_id="drift") == 1


def test_hysteresis_holds_plan_inside_thresholds(small):
    _, Q, flat = small
    eng = _drift_engine(flat)
    plan0 = eng._indexes["drift"].plan
    _pump(eng, Q, nq=7, batches=3)
    eng.maintenance_tick()
    assert eng._indexes["drift"].plan is plan0


def test_programs_bounded_by_engines_times_buckets(small):
    _, Q, flat = small
    eng = _drift_engine(flat)
    _pump(eng, Q, nq=7, batches=plan.TRAFFIC_MIN_SAMPLES + 2)
    eng.maintenance_tick()
    _pump(eng, Q, nq=7, batches=4)
    st = eng.cache.stats()
    assert st.misses <= 1 + plan.WARM_BUCKETS, st
    assert st.hits >= plan.TRAFFIC_MIN_SAMPLES, st


def test_mutable_growth_recosts_from_tick(serve_obs):
    rng = np.random.default_rng(5)
    mi = MutableIndex("brute_force", 8, device="cpu")
    mi.insert(rng.standard_normal((64, 8)).astype(np.float32))
    eng = ServingEngine(max_batch=8, max_wait_ms=0.0, res=CPU)
    eng.register_mutable("grow", mi)
    reg = eng._indexes["grow"]
    assert reg.plan is not None and reg.plan.corpus_rows == 64
    mi.insert(rng.standard_normal((64, 8)).astype(np.float32))
    eng.maintenance_tick()
    assert _counter(serve_obs, "serve.plan.recosts", index_id="grow") == 1
    assert reg.plan.corpus_rows == 128


def test_pinned_mode_never_planned(small):
    _, _, flat = small
    eng = ServingEngine(max_batch=16, max_wait_ms=0.0, res=CPU)
    eng.register("pinned", "ivf_flat", flat, mode="scan",
                 params=ivf_flat.IvfFlatSearchParams(n_probes=4))
    assert eng._indexes["pinned"].plan.bucket_modes == ()


def test_gate_off_registers_no_plan(monkeypatch, small):
    _, _, flat = small
    monkeypatch.setenv("RAFT_TPU_PLAN", "0")
    eng = _drift_engine(flat)
    assert eng._indexes["drift"].plan is None and eng.plan_explain("drift") is None
    eng.maintenance_tick()  # nothing to re-plan
