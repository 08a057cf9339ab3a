"""The host tier: raw vectors in host RAM (or mmap'd from a snapshot),
gathered a batch at a time (``raft_tpu.tiered.store`` counterpart).

A :class:`HostVectorStore` stands in for the ``dataset`` argument of
:func:`raft_tpu_torch.neighbors.refine.refine` (and the integrated refine
of ``ivf_pq`` / ``ivf_flat`` / ``brute_force`` ``search``): instead of a
``dataset[ids]`` gather on the card, the store runs ``np.take`` on host
memory into a staging slab, which is copied to the card. Rows reach device
memory only as the ``[batch, n_cand, dim]`` winner slab, so a corpus may
exceed device memory by the inverse of its code compression ratio.

The gather core (:meth:`HostVectorStore.gather_rows`) keeps the JAX
package's knobs for the mmap path:

* **read-ahead hints**: candidate rows are coalesced into page-aligned
  byte ranges advertised with ``madvise(MADV_WILLNEED)`` before the copy
  touches them;
* **fetch-depth budget**: ``fetch_depth_rows`` caps the rows a chunk of
  the copy takes, the next chunk's read-ahead issued before the current
  chunk is copied.

Duplicate ids within a batch are read once and the slab filled by an
in-RAM scatter (``tiered.fetch.dedup_rows`` counts the rows that never
crossed the tier). Every gather crosses the ``host.fetch`` fault seam
under :data:`FETCH_RETRY` before surfacing a typed
:class:`~raft_tpu_torch.core.errors.HostFetchError`; ``fault_context`` tags
every fire, so a spec can ``match=`` one store among many.

Staging, in PyTorch's idiom: two slabs a result shape, used in turn. For a
CUDA destination (:meth:`HostVectorStore.gather_to`) they are pinned CPU
tensors filled through their ``.numpy()`` view by ``np.take(..., out=)``
and copied with ``non_blocking=True``; each records a CUDA event after its
copy, and refilling a slab first waits for its event, so a slab is never
overwritten while its copy is in flight. For a CPU destination they are
ordinary tensors. A bfloat16 store keeps its uint16 bit patterns (numpy
has no bfloat16) and hands out a ``torch.bfloat16`` view.
"""
from __future__ import annotations

import io
import time
from typing import Dict, Optional

import numpy as np
import torch

from raft_tpu_torch import obs
from raft_tpu_torch.core import serialize as ser
from raft_tpu_torch.core.errors import HostFetchError, expects
from raft_tpu_torch.robust import faults
from raft_tpu_torch.robust.retry import RetryError, RetryPolicy, retry_call

#: serialized-snapshot kind tag for a standalone host-tier vector file
_KIND = "host_vectors"
_VERSION = 1

#: retries for a transient host fetch failure (mmap IO error, injected
#: fault): two quick retries, then fail typed; the fetch is on the query path
FETCH_RETRY = RetryPolicy(max_attempts=3, base_delay_s=0.005, max_delay_s=0.1)


def _torch_dtype(dtype) -> torch.dtype:
    """The tensor dtype of a numpy dtype."""
    return torch.from_numpy(np.empty(0, dtype)).dtype


class _Slab:
    """One staging buffer: a CPU tensor (pinned for a CUDA destination),
    its numpy view and the event recorded after its last copy to a card."""

    __slots__ = ("tensor", "array", "event")

    def __init__(self, shape, storage: torch.dtype, pinned: bool, bf16: bool):
        self.tensor = torch.empty(shape, dtype=storage, pin_memory=pinned)
        self.array = self.tensor.numpy().view(np.uint16) if bf16 else self.tensor.numpy()
        self.event = None


class _Staging:
    """Two staging slabs a ``(shape, pinned)``, used in turn, of one storage
    dtype (int16 bit patterns for bfloat16). A slab whose copy to a card
    may still be in flight is waited for before it is handed out again."""

    def __init__(self, storage: torch.dtype, bf16: bool):
        self._storage = storage
        self._bf16 = bf16
        # (shape, pinned) -> [slab_a, slab_b]; _flip picks the live one
        self._bufs: Dict[tuple, list] = {}
        self._flip = 0

    def next(self, shape, pinned: bool) -> _Slab:
        key = (tuple(shape), pinned)
        bufs = self._bufs.get(key)
        if bufs is None:
            bufs = self._bufs[key] = [_Slab(shape, self._storage, pinned, self._bf16)
                                      for _ in range(2)]
        self._flip ^= 1
        slab = bufs[self._flip]
        if slab.event is not None:
            slab.event.synchronize()
            slab.event = None
        return slab

    def to_device(self, slab: _Slab, device: torch.device) -> torch.Tensor:
        """The slab as a tensor on ``device``: on a card a ``non_blocking``
        copy of the pinned slab, the slab's event recorded after it; on the
        CPU the slab itself (valid until the gather after next of its
        shape)."""
        t = slab.tensor.view(torch.bfloat16) if self._bf16 else slab.tensor
        if device.type != "cuda":
            return t.to(device)
        out = t.to(device, non_blocking=True)
        slab.event = torch.cuda.Event()
        slab.event.record(torch.cuda.current_stream(device))
        return out


class HostVectorStore:
    """Host-resident ``[n_rows, dim]`` vectors with a staged batch gather.

    ``data`` is a numpy array (kept as is, a C-contiguous copy only if
    needed), an ``np.memmap`` from :meth:`open`, or a tensor (copied to the
    host). ``bf16=True`` says a uint16 array holds bfloat16 bit patterns (a
    bfloat16 tensor sets it itself). ``fetch_depth_rows`` bounds the rows a
    chunk of the copy takes (None: one chunk); ``readahead`` gates the
    madvise hints on the mmap path; ``fault_context`` is merged into every
    ``host.fetch`` fire."""

    #: duck-type marker read by :func:`raft_tpu_torch.neighbors.refine.is_host_dataset`
    is_host_tier = True

    def __init__(
        self,
        data,
        *,
        retry_policy: RetryPolicy = FETCH_RETRY,
        source_path: Optional[str] = None,
        fetch_depth_rows: Optional[int] = None,
        readahead: bool = True,
        fault_context: Optional[Dict[str, object]] = None,
        bf16: bool = False,
    ):
        if isinstance(data, torch.Tensor):
            bf16 = bf16 or data.dtype == torch.bfloat16
            data = ser.to_numpy(data)
        if not isinstance(data, np.memmap):
            data = np.ascontiguousarray(data)
        expects(data.ndim == 2, "host vector store needs [n_rows, dim] data")
        expects(not bf16 or data.dtype == np.uint16,
                "a bfloat16 host store holds uint16 bit patterns, got %s", data.dtype)
        expects(
            fetch_depth_rows is None or fetch_depth_rows >= 1,
            "fetch_depth_rows must be >= 1 (or None for unbounded)",
        )
        self._data = data
        self._bf16 = bool(bf16)
        self._retry = retry_policy
        self.source_path = source_path
        self.fetch_depth_rows = fetch_depth_rows
        self.readahead = bool(readahead)
        self._fault_context = dict(fault_context or {})
        self._staging = self._new_staging()

    # -- array-protocol surface the refine path reads -----------------------

    @property
    def shape(self):
        return self._data.shape

    @property
    def dtype(self) -> torch.dtype:
        """The rows' dtype as a tensor gives it (``torch.bfloat16`` for a
        bfloat16 store)."""
        if self._bf16:
            return torch.bfloat16
        return _torch_dtype(self._data.dtype)

    @property
    def size(self) -> int:
        return int(self._data.shape[0])

    @property
    def dim(self) -> int:
        return int(self._data.shape[1])

    @property
    def nbytes(self) -> int:
        return int(self._data.nbytes)

    @property
    def is_mmap(self) -> bool:
        return isinstance(self._data, np.memmap)

    def __len__(self) -> int:
        return self.size

    # -- the gather ----------------------------------------------------------

    def _new_staging(self) -> _Staging:
        """Staging slabs of this store's row dtype (also a sharded tier's,
        whose slab holds several stores' rows)."""
        return _Staging(torch.int16 if self._bf16 else _torch_dtype(self._data.dtype), self._bf16)

    def _advise(self, rows: np.ndarray) -> None:
        """madvise(WILLNEED) the page-aligned byte ranges covering ``rows``
        of the backing mmap, one hint per run of rows within a page of each
        other. Advisory: without an mmap, without madvise, or when the OS
        refuses, the copy pages the rows in on demand."""
        if not self.readahead or rows.size == 0 or not self.is_mmap:
            return
        mm = getattr(self._data, "_mmap", None)
        if mm is None or not hasattr(mm, "madvise"):
            return
        import mmap as _mmap

        if not hasattr(_mmap, "MADV_WILLNEED"):
            return
        page = _mmap.ALLOCATIONGRANULARITY
        row_b = int(self._data.strides[0])
        base = int(getattr(self._data, "offset", 0))
        srt = np.sort(np.asarray(rows, np.int64))
        starts = base + srt * row_b
        ends = starts + row_b
        # merge runs whose gap is under one page: one hint per run
        brk = np.nonzero(starts[1:] > ends[:-1] + page)[0] + 1
        run_s = starts[np.concatenate(([0], brk))]
        run_e = ends[np.concatenate((brk - 1, [srt.size - 1]))]
        total = len(mm)
        n_hints = 0
        try:
            for s, e in zip(run_s, run_e):
                a = (int(s) // page) * page
                length = min(int(e), total) - a
                if length <= 0:
                    continue
                mm.madvise(_mmap.MADV_WILLNEED, a, length)
                n_hints += 1
        except (OSError, ValueError):
            return  # hints are advisory; the copy below still works
        if n_hints and obs.is_enabled():
            obs.inc("tiered.fetch.readahead_ranges", float(n_hints))

    def _read_rows(self, rows: np.ndarray, dest: np.ndarray) -> None:
        """Copy ``rows`` (1-D valid ids) into ``dest [len(rows), dim]`` in
        chunks of ``fetch_depth_rows``, the next chunk's read-ahead issued
        before the current chunk's copy."""
        n = int(rows.size)
        depth = self.fetch_depth_rows or n or 1
        self._advise(rows[:depth])
        for s in range(0, n, depth):
            e = min(s + depth, n)
            if e < n:
                self._advise(rows[e : min(e + depth, n)])
            np.take(self._data, rows[s:e], axis=0, out=dest[s:e])

    def gather_rows(self, rows, out: Optional[np.ndarray] = None) -> np.ndarray:
        """Fetch ``rows`` (1-D valid ids) into ``out [len(rows), dim]``
        (allocated when None), the numpy array of the store's own dtype
        (uint16 bit patterns for bfloat16). Duplicate ids are fetched once
        (``tiered.fetch.dedup_rows``); ``tiered.fetch.rows`` and
        ``tiered.fetch.bytes`` count what crossed the tier. Crosses the
        ``host.fetch`` seam under retry; timed into ``tiered.fetch_ms``
        and a ``host.fetch`` span."""
        rows = np.asarray(rows).reshape(-1)
        if out is None:
            out = np.empty((rows.size, self.dim), self._data.dtype)
        uniq, inverse = np.unique(rows, return_inverse=True)
        dedup = uniq.size < rows.size
        fetch = uniq if dedup else rows
        dest = np.empty((fetch.size, self.dim), self._data.dtype) if dedup else out
        t0 = time.perf_counter()

        def _fetch():
            faults.fire("host.fetch", rows=int(fetch.size), **self._fault_context)
            self._read_rows(fetch, dest)
            return dest

        try:
            with obs.span("host.fetch", rows=int(fetch.size)):
                retry_call(_fetch, policy=self._retry, op="host.fetch")
        except RetryError as e:
            raise HostFetchError(
                "host-tier vector fetch failed", rows=int(fetch.size), attempts=e.attempts,
            ) from e.last
        if dedup:
            np.take(dest, inverse.reshape(-1), axis=0, out=out)
        if obs.is_enabled():
            dt_ms = (time.perf_counter() - t0) * 1e3
            row_bytes = self.dim * self._data.dtype.itemsize
            obs.inc("tiered.fetch.rows", float(fetch.size))
            obs.inc("tiered.fetch.bytes", float(fetch.size * row_bytes))
            if dedup:
                obs.inc("tiered.fetch.dedup_rows", float(rows.size - uniq.size))
            obs.observe("tiered.fetch_ms", dt_ms)
        return out

    def _fill(self, candidates, pinned: bool) -> _Slab:
        c = np.asarray(candidates.cpu() if isinstance(candidates, torch.Tensor) else candidates)
        expects(c.ndim == 2, "candidates must be [nq, n_cand]")
        safe = np.where(c >= 0, c, 0).reshape(-1)
        slab = self._staging.next(c.shape + (self.dim,), pinned)
        self.gather_rows(safe, out=slab.array.reshape(-1, self.dim))
        return slab

    def gather(self, candidates) -> np.ndarray:
        """Fetch the candidate rows: ``[nq, n_cand]`` ids (-1 = invalid,
        substituted by row 0 exactly as the device gather in
        :func:`raft_tpu_torch.neighbors.refine.refine`) -> the ``[nq,
        n_cand, dim]`` staging slab as a numpy array (uint16 bit patterns
        for bfloat16). See :meth:`gather_rows` for the fetch itself."""
        return self._fill(candidates, pinned=False).array

    def gather_to(self, candidates, device) -> torch.Tensor:
        """:meth:`gather`, then the slab as a tensor on ``device``: on a
        card a ``non_blocking`` copy of the pinned slab, with the slab's
        event recorded after it; on the CPU the slab itself (valid until
        the gather after next of its shape)."""
        device = torch.device(device)
        return self._staging.to_device(self._fill(candidates, pinned=device.type == "cuda"),
                                       device)

    # -- persistence ---------------------------------------------------------

    @staticmethod
    def save(path: str, data) -> str:
        """Write a standalone host-vector snapshot of ``data`` (an array, or
        a tensor: a bfloat16 one keeps its dtype) in the v4 checksummed
        envelope, temp-then-rename, that :meth:`open` loads eagerly or maps
        lazily; the JAX package's ``HostVectorStore.open`` reads it too."""
        if not isinstance(data, torch.Tensor):
            data = np.ascontiguousarray(np.asarray(data))
        expects(len(data.shape) == 2, "host vector store needs [n_rows, dim] data")
        body = io.BytesIO()
        ser.serialize_array(body, data)
        return ser.atomic_write(
            path, lambda f: ser.save_stream(f, _KIND, _VERSION, body.getvalue())
        )

    @classmethod
    def open(
        cls,
        path: str,
        *,
        mmap: bool = True,
        verify_crc: bool = True,
        retry_policy: RetryPolicy = FETCH_RETRY,
        fetch_depth_rows: Optional[int] = None,
        readahead: bool = True,
    ) -> "HostVectorStore":
        """Open a snapshot written by :meth:`save` (by either package).

        ``mmap=True`` maps the npy payload read-only in place (the CRC
        verified by streaming once unless ``verify_crc=False``): the
        resident set grows only with the rows queries touch. ``mmap=False``
        reads the array into host RAM."""
        kw = dict(retry_policy=retry_policy, source_path=path,
                  fetch_depth_rows=fetch_depth_rows, readahead=readahead)
        if mmap:
            _, offset, _ = ser.open_payload(path, _KIND, verify_crc=verify_crc)
            arr, _, name = ser.mmap_array_at(path, offset)
            return cls(arr, bf16=name == "bfloat16", **kw)
        with open(path, "rb") as f:
            _, body = ser.load_stream(f, _KIND)
            name = ser.deserialize_string(body)
            arr = np.load(body, allow_pickle=False)
        return cls(arr, bf16=name == "bfloat16", **kw)
