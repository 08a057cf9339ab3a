"""``batch``: batches of the seeded query set searched back to back, the
throughput mode of raft-ann-bench. The next batch is enqueued before the
host waits on the previous one's results. ``search_qps`` is every query
answered in the window over the whole window."""
from __future__ import annotations

import time
import types

import torch

from perfbench import data, index
from perfbench.check import Judge, sample
from perfbench.harness import sync
from perfbench.trace import region

#: queries of the check's sample (the reference searches these again)
SAMPLE_QUERIES = 1024


def setup(cell, *, seed, seconds, device, log):
    c = cell.config
    rows, queries = data.make(c, seed, device, c["n_rows"], c["n_queries"])
    t0 = time.perf_counter()
    idx = index.build(c, rows, device, seed)
    sync(device)
    log(f"build {time.perf_counter() - t0:.3f} s")
    params = index.search_params(c, cell.traffic.get("search"))
    batch = queries[: int(cell.traffic["batch_queries"])]
    t0 = time.perf_counter()
    index.search(c, idx, rows, batch, params)  # builds every kernel and shape it uses
    sync(device)
    log(f"warm-up search {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    d, i = index.search(c, idx, rows, batch, params)
    sync(device)
    per_call = time.perf_counter() - t0
    st = types.SimpleNamespace(cell=cell, config=c, device=device, rows=rows, batch=batch,
                               index=idx, params=params, kept=[], calls=0)
    _grow(st, d, i, int(seconds / per_call * 1.25) + 8)
    return st


def _grow(st, d, i, calls: int):
    """Room for the answers of ``calls`` more calls, allocated at once: a
    call's answers are copied there, so the window allocates nothing new
    and the allocator never has to ask the driver for memory in it."""
    st.kept.append((torch.empty((calls, *d.shape), dtype=d.dtype, device=d.device),
                    torch.empty((calls, *i.shape), dtype=i.dtype, device=i.device)))


def _answers(st):
    """Every call's ``(distances, ids)``, in order."""
    for d, i in st.kept:
        for r in range(d.shape[0]):
            yield d[r], i[r]


def window(st, *, seconds, log):
    cuda = st.device.type == "cuda"
    sync(st.device)
    pending = None
    room, row = st.kept[0][0].shape[0], 0
    t0 = time.perf_counter()
    while True:
        with region("perfbench.batch.enqueue"):
            d, i = index.search(st.config, st.index, st.rows, st.batch, st.params)
            if row == room:
                _grow(st, d, i, 64)
                room, row = 64, 0
            st.kept[-1][0][row].copy_(d)
            st.kept[-1][1][row].copy_(i)
            row += 1
            st.calls += 1
        ev = None
        if cuda:
            ev = torch.cuda.Event()
            ev.record()
        if pending is not None:
            with region("perfbench.batch.wait"):
                pending.synchronize()
        pending = ev
        if time.perf_counter() - t0 >= seconds:
            break
    with region("perfbench.batch.wait"):
        sync(st.device)
    st.elapsed = time.perf_counter() - t0
    d, i = st.kept[-1]
    st.kept[-1] = (d[:row], i[:row])
    n = st.calls * st.batch.shape[0]
    log(f"window {st.elapsed:.4f} s, {st.calls} batches of {st.batch.shape[0]} queries")
    return {"search_qps": n / st.elapsed}


def trace_context(st):
    return {"config": st.config, "view": index.view(st.config, st.index), "queries": st.batch,
            "calls": st.calls}


def release(st):
    """Keep the index's tensors for the check, drop the rest."""
    st.view = index.view(st.config, st.index)
    st.index = None
    if st.device.type == "cuda":
        torch.cuda.empty_cache()


def _judge(st):
    return Judge(st.config, st.rows, st.view, st.cell.traffic.get("search"))


def _positions(st, seed):
    return torch.from_numpy(sample(st.batch.shape[0], SAMPLE_QUERIES, seed,
                                   "check.queries")).to(st.batch.device)


def check(st, *, seed, log):
    judge = _judge(st)
    pos = _positions(st, seed)
    q = st.batch[pos]
    ref_d, _ = judge.reference(q)
    exact = judge.exact(q)
    invalid, err, misses, slots, recall_miss = 0, 0.0, 0, 0, 0.0
    for d, i in _answers(st):
        inv, e, true, _ = judge.answers(st.batch, d, i)
        invalid += inv
        err = max(err, e)
        t = torch.sort(true[pos], dim=1).values
        misses += judge.misses(q, t, ref_d)
        slots += t.numel()
        recall_miss = max(recall_miss, judge.recall_miss(i[pos], exact))
    log(f"recall@{judge.k} vs exact kNN over {len(pos)} sampled queries (worst call): "
        f"{1.0 - recall_miss:.6f}")
    readings = {"invalid": invalid, "dist_err": err, "topk_miss": misses / max(slots, 1),
                "recall_miss": recall_miss}
    readings.update(judge.index_numbers(seed))
    return readings, st.calls * st.batch.shape[0], invalid


def control(st, *, seed, log):
    """The control's readings: the reference at TF32 in the program's
    place, judged as the program is."""
    judge = _judge(st)
    q = st.batch[_positions(st, seed)]
    ref_d, _ = judge.reference(q)
    d, i = judge.reference(q, precision="tf32")
    inv, err, true, _ = judge.answers(q, d.to(torch.float32), i)
    t = torch.sort(true, dim=1).values
    out = {"invalid": inv, "dist_err": err, "topk_miss": judge.misses(q, t, ref_d) / t.numel(),
           "recall_miss": judge.recall_miss(i, judge.exact(q))}
    out.update(judge.index_numbers(seed, precision="tf32"))
    return out
