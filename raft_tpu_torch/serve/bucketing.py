"""Shape buckets + program cache for online serving
(``raft_tpu.serve.bucketing`` counterpart).

Query counts are rounded up to power-of-two buckets (1, 2, 4, ...,
``max_batch``), requests are padded to the bucket and un-padded on the way
out, so the engine dispatches a closed set of shapes per ``(index, algo,
k, params)``. PyTorch runs eagerly and compiles nothing per shape; the
buckets are kept because they decide which search mode a batch takes
(the fused scan for ``nq >= 128``) and they are the natural unit for
CUDA-graph capture later. :class:`ProgramCache` is an LRU of the per-key
dispatch closures.
"""
from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from typing import Callable, List, Sequence, Tuple

import numpy as np

from raft_tpu_torch.core.errors import expects
from raft_tpu_torch.utils import lockcheck


def bucket_sizes(max_batch: int) -> Tuple[int, ...]:
    """Powers of two up to (and including) ``max_batch``, rounded up."""
    expects(max_batch >= 1, "max_batch must be >= 1, got %d", max_batch)
    out = []
    b = 1
    while b < max_batch:
        out.append(b)
        b <<= 1
    out.append(b)
    return tuple(out)


def bucket_for(n_queries: int, max_batch: int) -> int:
    """Smallest bucket holding ``n_queries`` rows (<= ``max_batch``)."""
    expects(n_queries >= 1, "n_queries must be >= 1, got %d", n_queries)
    expects(
        n_queries <= max_batch,
        "n_queries %d exceeds max_batch %d — split the batch first",
        n_queries, max_batch,
    )
    b = 1
    while b < n_queries:
        b <<= 1
    return b


def pad_rows(arr: np.ndarray, bucket: int) -> np.ndarray:
    """Zero-pad ``arr`` [n, ...] to ``bucket`` rows (no-op when full)."""
    n = arr.shape[0]
    if n == bucket:
        return arr
    expects(n < bucket, "rows %d exceed bucket %d", n, bucket)
    pad = [(0, bucket - n)] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, pad)


def unpad_rows(arr, n: int):
    """Strip bucket padding back to the ``n`` real rows."""
    return arr[:n]


def params_key(params) -> Tuple:
    """A hashable identity for a search-params dataclass (or None)."""
    if params is None:
        return ()
    if dataclasses.is_dataclass(params):
        items = []
        for f in dataclasses.fields(params):
            v = getattr(params, f.name)
            try:
                hash(v)
            except TypeError:
                v = str(v)
            items.append((f.name, v))
        return (type(params).__name__,) + tuple(items)
    return (str(params),)


@dataclasses.dataclass(frozen=True)
class ProgramKey:
    """Identity of one dispatch program."""

    index_id: str
    algo: str
    bucket: int
    k: int
    params: Tuple = ()
    #: mutable-index generation the program serves; 0 for immutable
    #: registrations. Bumping it on compaction retires stale programs
    #: through the LRU and bounds distinct programs to generations x
    #: buckets per configuration.
    generation: int = 0


@dataclasses.dataclass(frozen=True)
class CacheStats:
    """Snapshot of :class:`ProgramCache` counters."""

    hits: int
    misses: int
    evictions: int
    size: int

    @property
    def distinct_programs(self) -> int:
        """Programs built over the cache's lifetime (its misses)."""
        return self.misses


@lockcheck.guarded_fields
class ProgramCache:
    """LRU cache of dispatch closures keyed by :class:`ProgramKey`. Builds
    run outside the lock (``serve.program_cache``), which guards only the
    map and its counters."""

    def __init__(self, capacity: int = 64):
        expects(capacity >= 1, "capacity must be >= 1, got %d", capacity)
        self.capacity = capacity
        self._lock = lockcheck.tracked(threading.RLock(), "serve.program_cache")
        self._programs: "OrderedDict[ProgramKey, Callable]" = OrderedDict()
        self._hits = 0
        self._misses = 0
        self._evictions = 0

    def get(self, key: ProgramKey, builder: Callable[[], Callable]) -> Callable:
        with self._lock:
            prog = self._programs.get(key)
            if prog is not None:
                self._hits += 1
                self._programs.move_to_end(key)
                return prog
            self._misses += 1
        prog = builder()
        with self._lock:
            self._programs[key] = prog
            self._programs.move_to_end(key)
            while len(self._programs) > self.capacity:
                self._programs.popitem(last=False)
                self._evictions += 1
        return prog

    def warmup(self, keys: Sequence[ProgramKey],
               builder_for: Callable[[ProgramKey], Callable[[], Callable]]) -> List[ProgramKey]:
        """Pre-populate programs for ``keys``; returns the keys built."""
        built = []
        for key in keys:
            with self._lock:
                cached = key in self._programs
            if not cached:
                built.append(key)
            self.get(key, builder_for(key))
        return built

    def __contains__(self, key: ProgramKey) -> bool:
        with self._lock:
            return key in self._programs

    def __len__(self) -> int:
        with self._lock:
            return len(self._programs)

    def keys(self) -> List[ProgramKey]:
        with self._lock:
            return list(self._programs.keys())

    def stats(self) -> CacheStats:
        with self._lock:
            return CacheStats(hits=self._hits, misses=self._misses,
                              evictions=self._evictions, size=len(self._programs))

    def clear(self) -> None:
        """Drop every program; the counters stay."""
        with self._lock:
            self._programs.clear()
