"""Tiered index: the scan on the device, the re-rank's rows from the host
(``raft_tpu.tiered.index`` counterpart).

``TieredIndex`` wraps one of the refine-capable families (``ivf_pq`` with
kmeans, nibble or RaBitQ codes, ``ivf_flat``, ``brute_force``) together with
a :class:`raft_tpu_torch.tiered.store.HostVectorStore` holding the raw
vectors. A search runs the family's scan on the index's device for
``k * refine_ratio`` candidates, gathers the winners' rows from the host
tier and re-ranks them with
:func:`raft_tpu_torch.neighbors.refine._exact_rerank`, the core the
resident ``search(dataset=...)`` refine runs, so a micro-batch's results
are the resident search's bits for the same batch (the gather takes row 0
for invalid ids, as the device gather does).

The overlap schedule (``overlap=True``, the default) hides the host fetch
behind the next micro-batch's scan::

    enqueue scan[0]
    for i in batches:
        enqueue scan[i+1]           # the card starts the next scan
        wait for scan[i]'s ids      # the one sync: cand.cpu() on a side stream
        gather batch i on the host  # while the card runs scan[i+1]
        enqueue refine[i]           # rides behind scan[i+1]

On a card, the ids of scan *i* come to the host on a side stream that
waits only for the event recorded after scan *i*, so the copy does not
queue behind scan *i+1*. The store's slabs are double-buffered, each
guarded by the event of its copy. A batch's fetch counts as hidden when
the event recorded after the next scan has not completed when the fetch
ends; the share of fetch time hidden so is the
``tiered.overlap_efficiency`` gauge. Off a card the probe reports "ready",
so the gauge degrades and never inflates.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Tuple

import torch

from raft_tpu_torch import obs
from raft_tpu_torch.core import serialize as ser
from raft_tpu_torch.core.errors import expects
from raft_tpu_torch.neighbors.refine import _exact_rerank, check_refine_dataset
from raft_tpu_torch.ops.distance import resolve_metric
from raft_tpu_torch.tiered.store import HostVectorStore

#: families whose search has the integrated refine contract
FAMILIES = ("ivf_pq", "ivf_flat", "brute_force")

#: a fetch counts as hidden when the next scan still had this much work
#: left after the fetch returned (guards against scheduler-noise zeros)
_OVERLAP_EPS_S = 1e-5


def _index_device(index) -> torch.device:
    return index.dataset.device if hasattr(index, "dataset") else index.device


class TieredIndex:
    """One device-resident index and its host-resident raw vectors.

    ``algo`` picks the scan family; ``index`` is the built index (its codes
    and centers stay on its device); ``store`` holds the ``[n_rows, dim]``
    raw vectors on the host tier."""

    def __init__(
        self,
        algo: str,
        index,
        store: HostVectorStore,
        *,
        refine_ratio: int = 8,
        micro_batch: int = 256,
        search_params=None,
        metric_arg: float = 2.0,
    ):
        expects(algo in FAMILIES, "tiered algo must be one of %s, got %r", FAMILIES, algo)
        expects(refine_ratio >= 1, "refine_ratio must be >= 1")
        expects(micro_batch >= 1, "micro_batch must be >= 1")
        check_refine_dataset(store, int(index.size), algo)
        self.algo = algo
        self.index = index
        self.store = store
        self.refine_ratio = int(refine_ratio)
        self.micro_batch = int(micro_batch)
        self.search_params = search_params
        self.metric_arg = float(metric_arg)

    @property
    def size(self) -> int:
        return int(self.index.size)

    @property
    def dim(self) -> int:
        return self.store.dim

    @property
    def device(self) -> torch.device:
        return _index_device(self.index)

    @property
    def metric(self):
        return resolve_metric(self.index.metric)

    # -- stage 1: the scan on the device -------------------------------------

    def _scan(self, queries, kk: int, mode: Optional[str], **kwargs):
        """Enqueue the family's scan for ``kk`` candidates; returns device
        tensors without a sync (the pipeline owns it)."""
        qb = max(self.micro_batch, queries.shape[0])
        if self.algo == "brute_force":
            from raft_tpu_torch.neighbors import brute_force

            expects(mode in (None, "exact"), "brute_force tiered search: mode must be "
                    "'exact', got %r", mode)
            return brute_force.search(self.index, queries, kk, query_batch=qb, **kwargs)
        if self.algo == "ivf_pq":
            from raft_tpu_torch.neighbors import ivf_pq as family

            params = self.search_params or family.IvfPqSearchParams()
        else:
            from raft_tpu_torch.neighbors import ivf_flat as family

            params = self.search_params or family.IvfFlatSearchParams()
        inner = dataclasses.replace(params, refine_ratio=1)
        return family.search(self.index, queries, kk, inner, query_batch=qb,
                             mode=mode or "auto", **kwargs)

    # -- stages 2 and 3: host gather, device re-rank ---------------------------

    def _refine(self, slab, queries, candidates, k: int):
        # the span measures the enqueue only: the pipeline owns the sync
        with obs.span("tiered.refine", nq=int(queries.shape[0]), k=int(k)):
            return _exact_rerank(slab, queries, candidates, candidates >= 0, k=k,
                                 metric=self.metric, metric_arg=self.metric_arg)

    def _consume(self, queries, cand, cand_host, k: int):
        """Gather batch rows ``cand_host`` on the host, then enqueue their
        re-rank; returns ``(out, fetch seconds)``."""
        t0 = time.perf_counter()
        slab = self.store.gather_to(cand_host, queries.device)
        dt = time.perf_counter() - t0
        return self._refine(slab, queries, cand, k), dt

    def search(
        self,
        queries,
        k: int,
        *,
        mode: Optional[str] = None,
        overlap: bool = True,
        micro_batch: Optional[int] = None,
        **kwargs,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Tiered search: best-first ``(distances [nq, k] f32, indices [nq,
        k] i32)`` on the index's device, the family's resident
        ``search(..., dataset=raw)`` results for the same micro-batches.
        ``overlap=False`` runs scan, fetch and re-rank in turn for each
        micro-batch (the card idles during the gather); the results are the
        same."""
        queries = ser.as_tensor(queries, self.device)
        expects(queries.ndim == 2 and queries.shape[1] == self.dim, "bad query shape")
        expects(1 <= k <= self.size, "k=%d out of range for index of size %d", k, self.size)
        kk = min(k * self.refine_ratio, self.size)
        mb = int(micro_batch or self.micro_batch)
        nq = queries.shape[0]
        spans = [(s, min(s + mb, nq)) for s in range(0, nq, mb)]

        if obs.is_enabled():
            obs.inc("tiered.search.calls", algo=self.algo)
            obs.inc("tiered.search.queries", float(nq))

        with obs.span("tiered.search", algo=self.algo, nq=int(nq), k=int(k)):
            if not overlap or len(spans) == 1:
                outs = []
                for s, e in spans:
                    qb = queries[s:e]
                    _, cand = self._scan(qb, kk, mode, **kwargs)
                    # the sequential schedule: the card idles during the gather
                    outs.append(self._consume(qb, cand, cand.cpu(), k)[0])
                if obs.is_enabled():
                    obs.set_gauge("tiered.overlap_efficiency", 0.0)
                return _collect(outs)

            # scan i + 1 is in flight while batch i's rows come from the host
            def consume(i, cand, cand_host):
                s, e = spans[i]
                return self._consume(queries[s:e], cand, cand_host, k)

            outs, eff = run_overlapped(
                len(spans),
                lambda i: self._scan(queries[spans[i][0]:spans[i][1]], kk, mode, **kwargs),
                consume,
            )
            if obs.is_enabled():
                obs.set_gauge("tiered.overlap_efficiency", eff)
            return _collect(outs)


def run_overlapped(n_batches: int, scan, consume):
    """The scan -> fetch -> re-rank overlap schedule.

    ``scan(i)`` enqueues batch *i*'s scan and returns ``(values, ids)``
    device tensors without a sync; ``consume(i, ids, ids_host)`` gathers
    and re-ranks batch *i* and returns ``(out, fetch_seconds)``. The helper
    keeps the pipeline's invariants: scan *i+1* enqueued before batch *i*'s
    sync, one sync a batch (its candidate ids to the host, which on a card
    waits for scan *i* only), and the probe of the event after scan *i+1*
    that credits a fetch as hidden. Returns ``(outs, efficiency)``: the
    share of the fetch time hidden behind a still-running next scan."""
    outs = [None] * n_batches
    fetch_s = [0.0] * n_batches
    hidden = [False] * n_batches
    scan_next = scan(0)
    ev_next = _record(scan_next[1])
    for i in range(n_batches):
        scan_cur, ev_cur = scan_next, ev_next
        if i + 1 < n_batches:
            scan_next = scan(i + 1)
            ev_next = _record(scan_next[1])
        # the pipeline's one forced sync: batch i's candidate ids
        cand_host = _to_host(scan_cur[1], ev_cur)
        outs[i], fetch_s[i] = consume(i, scan_cur[1], cand_host)
        if i + 1 < n_batches:
            # the next scan still running after the fetch: the fetch cost
            # the pipeline nothing
            hidden[i] = not _is_ready(ev_next)
    total = sum(fetch_s)
    eff = (
        sum(f for f, h in zip(fetch_s, hidden) if h) / total
        if total > _OVERLAP_EPS_S else 0.0
    )
    return outs, eff


def _record(t: torch.Tensor):
    """An event recorded on ``t``'s stream after the work that makes it
    (None off a card)."""
    if t.device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(t.device))
    return ev


_COPY_STREAMS = {}


def _to_host(t: torch.Tensor, ready) -> torch.Tensor:
    """``t`` on the host once the work before ``ready`` is done: on a card
    a copy on a side stream that waits for ``ready`` only, so it does not
    queue behind work enqueued after it."""
    if ready is None:
        return t.cpu()
    side = _COPY_STREAMS.get(t.device)
    if side is None:
        side = _COPY_STREAMS[t.device] = torch.cuda.Stream(t.device)
    side.wait_event(ready)
    with torch.cuda.stream(side):
        out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        out.copy_(t, non_blocking=True)
    t.record_stream(side)
    side.synchronize()
    return out


def _is_ready(ev) -> bool:
    """Non-blocking "has the work before this event finished?" probe; off a
    card (no event) it reports ready, so no overlap credit is claimed."""
    return True if ev is None else bool(ev.query())


def _collect(outs) -> Tuple[torch.Tensor, torch.Tensor]:
    if len(outs) == 1:
        return outs[0]
    return torch.cat([v for v, _ in outs], dim=0), torch.cat([i for _, i in outs], dim=0)
