"""HNSW interop (``raft_tpu.neighbors.hnsw`` counterpart; reference
``neighbors/hnsw.hpp:62`` ``from_cagra`` and ``cagra_serialize.cuh``
``serialize_to_hnswlib``).

Writes a CAGRA index as a base-layer-only hnswlib file (the JAX package's
bytes for the same index: hnswlib's ``loadIndex`` takes it with
``max_level=1`` and every point on level 0), reads such a file back
without the hnswlib package, and searches the graph through
:func:`raft_tpu_torch.neighbors.cagra.search` (``ef`` is ``itopk_size``),
which on a CUDA index launches kernel B4.

Where the JAX package makes a fresh ``CagraIndex`` on every search, an
:class:`HnswIndex` keeps one (made at the first search, or the index it
came from): B4's neighbour table and seed rows are cached on the
``CagraIndex``, so every search after the first reuses them. The answers
are the same either way.
"""
from __future__ import annotations

import dataclasses
import struct
import threading
from typing import BinaryIO, Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch import obs
from raft_tpu_torch.core import serialize as ser
from raft_tpu_torch.core.errors import expects
from raft_tpu_torch.core.resources import ensure_resources
from raft_tpu_torch.neighbors.cagra import CagraIndex, CagraSearchParams, from_graph
from raft_tpu_torch.neighbors.cagra import search as cagra_search
from raft_tpu_torch.ops.distance import DistanceType

#: guards the first making of an HnswIndex's CagraIndex (threads may share one index)
_CAGRA_LOCK = threading.Lock()


def serialize_to_hnswlib(index: CagraIndex, stream: BinaryIO) -> None:
    """Write the hnswlib ``HierarchicalNSW`` file layout (the reference
    writer's field order and widths: size_t header fields, a record an
    element ``[link_count:int][links:u32*deg][data:T*dim][label:size_t]``,
    then one int 0 an element for the upper link lists). A ``-1`` link
    (no neighbour) points at the element itself."""
    expects(index.dataset is not None, "serialize_to_hnswlib needs the raw dataset")
    dataset = np.ascontiguousarray(ser.to_numpy(index.dataset))
    graph = ser.to_numpy(index.graph).astype(np.int64)
    n, dim = dataset.shape
    deg = graph.shape[1]
    size_data_per_element = deg * 4 + 4 + dim * dataset.dtype.itemsize + 8
    stream.write(struct.pack(
        "<QQQQQQiiQQQdQ",
        0,  # offset_level_0
        n,  # max_element
        n,  # curr_element_count
        size_data_per_element,
        size_data_per_element - 8,  # label_offset
        deg * 4 + 4,  # offset_data
        1,  # max_level
        n // 2,  # entrypoint_node
        deg // 2,  # max_M
        deg,  # max_M0
        deg // 2,  # M
        0.42424242,  # mult (unused by the loader)
        500,  # efConstruction (unused)
    ))
    rec = np.dtype([("cnt", "<i4"), ("links", "<u4", (deg,)), ("data", dataset.dtype, (dim,)),
                    ("label", "<u8")])
    out = np.empty(n, rec)
    out["cnt"] = deg
    out["links"] = np.where(graph < 0, np.arange(n, dtype=np.int64)[:, None], graph).astype(np.uint32)
    out["data"] = dataset
    out["label"] = np.arange(n, dtype=np.uint64)
    stream.write(out.tobytes())
    stream.write(np.zeros(n, "<i4").tobytes())


@dataclasses.dataclass
class HnswIndex:
    """A loaded base-layer hnsw graph (``hnsw::index`` analog,
    ``neighbors/detail/hnsw_types.hpp``) on one device."""

    dataset: torch.Tensor  # [n, dim]
    graph: torch.Tensor  # [n, degree] i32
    entrypoint: int
    metric: DistanceType
    _cagra: Optional[CagraIndex] = dataclasses.field(default=None, repr=False, compare=False)

    @property
    def dim(self) -> int:
        return self.dataset.shape[1]

    def to_cagra(self) -> CagraIndex:
        """The graph as a :class:`CagraIndex`: made once and kept, with the
        fused search's caches it gathers."""
        with _CAGRA_LOCK:
            if self._cagra is None:
                self._cagra = from_graph(self.dataset, self.graph, self.metric,
                                         device=self.dataset.device)
            return self._cagra


def from_cagra(index: CagraIndex) -> HnswIndex:
    """``hnsw::from_cagra`` (``neighbors/hnsw.hpp:62``): the CAGRA graph
    viewed as a base-layer hnsw index, searching through ``index`` itself."""
    expects(index.dataset is not None, "from_cagra needs the raw dataset")
    return HnswIndex(dataset=index.dataset, graph=index.graph, entrypoint=index.size // 2,
                     metric=index.metric, _cagra=index)


def load_hnswlib(stream: BinaryIO, dtype=np.float32, metric=DistanceType.L2Expanded,
                 device=None) -> HnswIndex:
    """Parse an hnswlib file written by :func:`serialize_to_hnswlib` into
    an index on ``device`` (default ``cuda``)."""
    dev = ensure_resources(device=device if device is not None else "cuda").device
    _, n, count, size_per, label_off, offset_data = struct.unpack("<QQQQQQ", stream.read(48))
    max_level, entry = struct.unpack("<ii", stream.read(8))
    struct.unpack("<QQQ", stream.read(24))  # max_M, max_M0, M
    struct.unpack("<dQ", stream.read(16))  # mult, efConstruction
    expects(max_level == 1, "only base-layer-only files supported")
    deg = (offset_data - 4) // 4
    itemsize = np.dtype(dtype).itemsize
    dim = (label_off - offset_data) // itemsize
    rec = np.dtype([("cnt", "<i4"), ("links", "<u4", (deg,)),
                    ("data", np.dtype(dtype).newbyteorder("<"), (dim,)), ("label", "<u8")])
    expects(rec.itemsize == size_per, "record size mismatch: corrupt file?")
    raw = np.frombuffer(stream.read(size_per * count), rec, count=count)
    order = np.argsort(raw["label"])  # rows by label (the writer emits them in order)
    graph = raw["links"][order].astype(np.int32)
    data = np.ascontiguousarray(raw["data"][order])
    return HnswIndex(dataset=ser.from_numpy(data, dev), graph=ser.from_numpy(graph, dev),
                     entrypoint=int(entry), metric=metric)


def search(index: HnswIndex, queries, k: int, ef: int = 64) -> Tuple[torch.Tensor, torch.Tensor]:
    """Base-layer search (the reference hands it to hnswlib's CPU
    ``searchKnn``; here the graph runs through the batched beam search with
    ``itopk_size=max(ef, k)``). Returns ``(distances, ids)`` on the index's
    device.

    With :mod:`raft_tpu_torch.obs` enabled the call is an ``hnsw.search``
    span (the nested ``cagra.search`` span shows the traversal) with
    ``hnsw.search.calls{ef}`` and ``hnsw.search.queries``."""
    params = CagraSearchParams(itopk_size=max(ef, k))
    if not obs.is_enabled():
        return cagra_search(index.to_cagra(), queries, k, params)
    nq = int(np.shape(queries)[0]) if len(np.shape(queries)) == 2 else 1
    obs.inc("hnsw.search.calls", ef=str(ef))
    obs.inc("hnsw.search.queries", float(nq))
    with obs.span("hnsw.search", k=k, nq=nq, ef=ef) as sp:
        return sp.sync(cagra_search(index.to_cagra(), queries, k, params))
