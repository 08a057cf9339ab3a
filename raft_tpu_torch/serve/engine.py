"""Online query-serving engine (``raft_tpu.serve.engine`` counterpart,
reduced).

:class:`ServingEngine` turns a stream of small requests into the
power-of-two micro-batches the search paths want: requests enter through
:meth:`~ServingEngine.submit` / :meth:`~ServingEngine.submit_many` into a
bounded :class:`~raft_tpu_torch.serve.batcher.MicroBatcher`, each
micro-batch is zero-padded to its bucket, dispatched through a
:class:`~raft_tpu_torch.serve.bucketing.ProgramCache` closure on the
engine's device, un-padded, and every request's future completes with a
:class:`ServeResult`. The engine is synchronous: :meth:`~ServingEngine.step`
processes at most one micro-batch on the caller's thread.

It serves ``brute_force``, ``ivf_flat`` and ``ivf_pq`` indexes. The JAX
engine's observability, planner, robustness, tiering, mutable-index and
replica hooks are not ported yet.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from raft_tpu_torch.core.errors import expects
from raft_tpu_torch.core.resources import Resources, ensure_resources
from raft_tpu_torch.serve.batcher import MicroBatcher, Request, ServeFuture
from raft_tpu_torch.serve.bucketing import (
    ProgramCache,
    ProgramKey,
    bucket_for,
    bucket_sizes,
    pad_rows,
    params_key,
)

#: algo name -> default dispatch mode at registration
_DEFAULT_MODES = {"brute_force": "exact", "ivf_flat": "auto", "ivf_pq": "auto"}


@dataclasses.dataclass(frozen=True)
class ServeResult:
    """One request's response."""

    distances: np.ndarray  # [m, k]
    indices: np.ndarray  # [m, k]
    time_in_queue_ms: float = 0.0
    #: arrival -> results on the host, on the engine clock
    latency_ms: float = 0.0
    bucket: int = 0
    batch_rows: int = 0

    def __iter__(self):  # unpack like a plain (distances, indices)
        return iter((self.distances, self.indices))


@dataclasses.dataclass
class _Registration:
    index_id: str
    algo: str
    index: object
    params: object
    mode: str
    dataset: object = None
    search_kwargs: Dict[str, object] = dataclasses.field(default_factory=dict)


class ServingEngine:
    """Dynamic micro-batching serving engine over registered indexes.

    >>> eng = ServingEngine(max_batch=128, max_wait_ms=2.0)
    >>> eng.register("sift", "ivf_flat", index, params=params)
    >>> fut = eng.submit("sift", query_rows, k=10)
    >>> eng.run_until_idle()
    >>> res = fut.result()          # ServeResult
    """

    def __init__(self, max_batch: int = 64, max_wait_ms: float = 2.0,
                 queue_capacity: int = 1024, res: Optional[Resources] = None):
        self.max_batch = int(max_batch)
        self.res = ensure_resources(res)
        self.batcher = MicroBatcher(max_batch=max_batch, max_wait_ms=max_wait_ms,
                                    capacity=queue_capacity)
        self.cache = ProgramCache()
        self._indexes: Dict[str, _Registration] = {}

    # -- registration ------------------------------------------------------

    def register(self, index_id: str, algo: str, index, *, params=None,
                 mode: Optional[str] = None, dataset=None, **search_kwargs) -> None:
        """Register ``index`` (``algo`` = ``brute_force`` | ``ivf_flat`` |
        ``ivf_pq``). ``params``/``mode``/``search_kwargs`` are pinned at
        registration; ``dataset`` enables integrated refine (for ``ivf_pq``
        at the params' ``refine_ratio``, 8 by default)."""
        expects(algo in _DEFAULT_MODES, "unknown serving algo %r (want one of %s)",
                algo, ", ".join(sorted(_DEFAULT_MODES)))
        self._indexes[index_id] = _Registration(
            index_id=index_id, algo=algo, index=index, params=params,
            mode=mode if mode is not None else _DEFAULT_MODES[algo],
            dataset=dataset, search_kwargs=dict(search_kwargs),
        )

    def registered(self) -> List[str]:
        return list(self._indexes)

    # -- submission --------------------------------------------------------

    def submit(self, index_id: str, queries, k: int,
               deadline_ms: Optional[float] = None) -> ServeFuture:
        """Enqueue one request (``queries`` [m, dim] or one [dim] row) and
        return its future. Raises ``QueueFull`` / ``DeadlineExceeded`` at
        admission."""
        self._reg(index_id)
        q = np.asarray(queries, dtype=np.float32)
        if q.ndim == 1:
            q = q[None, :]
        expects(q.ndim == 2, "queries must be [m, dim] (or one [dim] row)")
        expects(q.shape[0] <= self.max_batch,
                "request has %d rows > max_batch %d — use submit_many to split",
                q.shape[0], self.max_batch)
        now = self.batcher.now()
        req = Request(
            queries=q, k=int(k), group=(index_id, int(k)), t_arrival=now,
            deadline_s=(now + deadline_ms / 1e3) if deadline_ms is not None else None,
        )
        self.batcher.offer(req)
        return req.future

    def submit_many(self, index_id: str, queries, k: int,
                    deadline_ms: Optional[float] = None, request_rows: int = 1) -> List[ServeFuture]:
        """Split ``queries`` [n, dim] into requests of ``request_rows`` rows
        and submit them all; one future per request."""
        q = np.asarray(queries)
        expects(q.ndim == 2, "queries must be [n, dim]")
        expects(1 <= request_rows <= self.max_batch, "request_rows must be in [1, max_batch]")
        return [self.submit(index_id, q[s : s + request_rows], k, deadline_ms=deadline_ms)
                for s in range(0, q.shape[0], request_rows)]

    # -- the synchronous loop driver ---------------------------------------

    def step(self, force: bool = False) -> int:
        """Process at most one micro-batch; returns requests completed
        (deadline rejections included)."""
        now = self.batcher.now()
        if not self.batcher.ready(now) and not (force and self.batcher.depth_requests()):
            return 0
        batch, expired = self.batcher.next_batch(now)
        if batch:
            self._dispatch(batch, now)
        return len(expired) + len(batch)

    def run_until_idle(self, max_steps: int = 1_000_000) -> int:
        """Drive :meth:`step` until the queue is empty."""
        total = 0
        for _ in range(max_steps):
            if not self.batcher.depth_requests():
                break
            total += self.step(force=True)
        return total

    def queue_depth(self) -> int:
        return self.batcher.depth_rows()

    def warmup(self, index_id: str, k: int, run: bool = True) -> List[ProgramKey]:
        """Build (and with ``run=True`` run once on zero queries, which
        builds the kernels) every bucket's program for ``(index_id, k)``."""
        reg = self._reg(index_id)
        keys = [ProgramKey(index_id, reg.algo, b, int(k), params_key(reg.params))
                for b in bucket_sizes(self.max_batch)]
        built = self.cache.warmup(keys, lambda key: (lambda: self._build_program(reg, key.bucket, key.k)))
        if run:
            for key in keys:
                prog = self.cache.get(key, lambda: self._build_program(reg, key.bucket, key.k))
                zeros = torch.zeros((key.bucket, int(reg.index.dim)), device=self.res.device)
                out = prog(zeros)
                out[0].cpu()  # wait for the run
        return built

    # -- internals ---------------------------------------------------------

    def _reg(self, index_id: str) -> _Registration:
        expects(index_id in self._indexes, "no index registered as %r", index_id)
        return self._indexes[index_id]

    def _build_program(self, reg: _Registration, bucket: int, k: int) -> Callable:
        from raft_tpu_torch.neighbors import brute_force, ivf_flat, ivf_pq

        kw = reg.search_kwargs
        if reg.algo == "brute_force":
            return lambda q: brute_force.search(reg.index, q, k, query_batch=bucket,
                                                dataset=reg.dataset, **kw)
        algo = ivf_flat if reg.algo == "ivf_flat" else ivf_pq
        return lambda q: algo.search(reg.index, q, k, reg.params, query_batch=bucket,
                                     mode=reg.mode, dataset=reg.dataset, **kw)

    def _dispatch(self, batch: Sequence[Request], now: float) -> None:
        """Pad the batch to its bucket, run its program, complete every
        future. A failure fails this batch's futures and the engine keeps
        serving."""
        reg = self._reg(batch[0].group[0])
        k = batch[0].group[1]
        rows = np.concatenate([r.queries for r in batch], axis=0)
        n = rows.shape[0]
        bucket = bucket_for(n, self.max_batch)
        padded = torch.from_numpy(pad_rows(rows, bucket)).to(self.res.device)
        key = ProgramKey(reg.index_id, reg.algo, bucket, k, params_key(reg.params))
        try:
            program = self.cache.get(key, lambda: self._build_program(reg, bucket, k))
            t0 = time.perf_counter()
            dv, iv = program(padded)
            d_np = dv.cpu().numpy()
            i_np = iv.cpu().numpy()
            self.batcher.note_service_time(time.perf_counter() - t0)
        except Exception as e:  # the serving loop must survive one bad batch
            for r in batch:
                r.future.set_exception(e)
            return
        t_done = self.batcher.now()
        off = 0
        for r in batch:
            m = r.n_rows
            r.future.set_result(ServeResult(
                distances=d_np[off : off + m],
                indices=i_np[off : off + m],
                time_in_queue_ms=(now - r.t_arrival) * 1e3,
                latency_ms=(t_done - r.t_arrival) * 1e3,
                bucket=bucket,
                batch_rows=n,
            ))
            off += m
