"""Benchmark datasets (``raft_tpu.bench.datasets`` counterpart): the
``get_dataset`` and ``generate_groundtruth`` stages of
``python/raft-ann-bench`` and the harness's dataset object
(``cpp/bench/ann/src/common/dataset.hpp``).

The registry generates each named dataset from a seed, shaped like the
standard sets (SIFT-1M-like clustered float32, DEEP-like, uniform), with
the JAX package's numpy draws in its order, so both packages hold the same
arrays. ``.fbin`` files already on disk (``dataset.hpp:37-94``: two int32
``[n_rows, dim]``, then the row-major data) take precedence.

Ground truth is the exact top-k of the port's brute-force index on the
caller's device, cached on disk beside the data.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
from typing import Optional

import numpy as np

from raft_tpu_torch.core import serialize
from raft_tpu_torch.core.resources import Resources

DATA_DIR = os.environ.get("RAFT_TPU_BENCH_DATA", os.path.join(os.path.dirname(__file__), "..", "..", ".bench_cache"))


@dataclasses.dataclass
class Dataset:
    """Base and query vectors with a lazily computed, cached ground truth."""

    name: str
    base: np.ndarray  # [n, d]
    queries: np.ndarray  # [nq, d]
    metric: str = "euclidean"  # "euclidean" | "inner_product"
    _gt: Optional[np.ndarray] = None

    @property
    def n(self) -> int:
        return self.base.shape[0]

    @property
    def dim(self) -> int:
        return self.base.shape[1]

    def ground_truth(self, k: int, batch: int = 512, res: Optional[Resources] = None) -> np.ndarray:
        """Exact top-k ids ``[nq, k]`` by brute force on ``res``'s device
        (default ``cuda``); cached on disk."""
        if self._gt is not None and self._gt.shape[1] >= k:
            return self._gt[:, :k]
        cache = _gt_cache_path(self)
        if cache and os.path.exists(cache):
            gt = np.load(cache)
            if gt.shape[0] == self.queries.shape[0] and gt.shape[1] >= k:
                self._gt = gt
                return gt[:, :k]
        gt = _exact_knn(self.base, self.queries, max(k, 100), self.metric, batch, res)
        if cache:
            os.makedirs(os.path.dirname(cache), exist_ok=True)
            np.save(cache, gt)
        self._gt = gt
        return gt[:, :k]


def download_file(
    url: str,
    dest: str,
    policy=None,
    timeout: float = 60.0,
    chunk: int = 1 << 20,
) -> str:
    """Fetch ``url`` to ``dest`` with retries and an atomic rename.

    Transient errors are retried per ``policy``
    (:class:`raft_tpu_torch.robust.retry.RetryPolicy`, by default 3
    attempts with backoff). Bytes land in ``dest + ".tmp<pid>"`` and are
    renamed onto ``dest`` only after a complete read, so a partial file is
    never seen at ``dest``. Returns ``dest``. The tests fetch ``file://``
    URLs."""
    import urllib.error
    import urllib.request

    from raft_tpu_torch.robust.retry import RetryPolicy, retry_call

    if policy is None:
        policy = RetryPolicy(
            max_attempts=3, base_delay_s=0.5, max_delay_s=10.0,
            retryable=(urllib.error.URLError, ConnectionError, TimeoutError, OSError),
        )

    def _fetch() -> str:
        os.makedirs(os.path.dirname(os.path.abspath(dest)), exist_ok=True)
        tmp = dest + f".tmp{os.getpid()}"
        try:
            with urllib.request.urlopen(url, timeout=timeout) as r, open(tmp, "wb") as f:
                while True:
                    buf = r.read(chunk)
                    if not buf:
                        break
                    f.write(buf)
            os.replace(tmp, dest)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return dest

    return retry_call(_fetch, policy=policy, op="datasets.download")


def _fingerprint(ds: Dataset) -> str:
    h = hashlib.sha1()
    h.update(f"{ds.name}:{ds.base.shape}:{ds.queries.shape}:{ds.metric}".encode())
    # a sample of rows, so data made from another seed misses the cache
    h.update(np.ascontiguousarray(ds.base[:: max(1, ds.n // 64)][:64]).tobytes())
    h.update(np.ascontiguousarray(ds.queries[:16]).tobytes())
    return h.hexdigest()[:16]


def _gt_cache_path(ds: Dataset) -> Optional[str]:
    try:
        return os.path.join(os.path.abspath(DATA_DIR), "gt", f"{ds.name}-{_fingerprint(ds)}.npy")
    except (TypeError, ValueError, AttributeError):
        return None


def _exact_knn(base: np.ndarray, queries: np.ndarray, k: int, metric: str, batch: int,
               res: Optional[Resources] = None) -> np.ndarray:
    """Ground truth through the port's exact index (the reference uses
    pylibraft's brute force, ``generate_groundtruth/__main__.py:58``). The
    batches' ids stay on the device and come to the host once."""
    import torch

    from raft_tpu_torch.neighbors import brute_force
    from raft_tpu_torch.ops.distance import DistanceType

    m = DistanceType.InnerProduct if metric == "inner_product" else DistanceType.L2Expanded
    index = brute_force.build(base, metric=m, res=res)
    dev = index.dataset.device
    q = torch.from_numpy(np.ascontiguousarray(queries)).to(dev)
    outs = [brute_force.search(index, q[s: s + batch], k, res=res)[1]
            for s in range(0, q.shape[0], batch)]
    return torch.cat(outs, dim=0).cpu().numpy()


# -- generators (the registry) ---------------------------------------------------------


def make_clustered(
    name: str,
    n: int,
    dim: int,
    n_queries: int,
    n_centers: Optional[int] = None,
    cluster_std: float = 0.5,
    metric: str = "euclidean",
    seed: int = 1234,
) -> Dataset:
    """Clustered float32 data, the regime real embeddings are in (on
    uniform gaussians every IVF or graph method looks bad)."""
    rng = np.random.default_rng(seed)
    nc = n_centers or max(64, int(np.sqrt(n)))
    centers = rng.standard_normal((nc, dim)).astype(np.float32)
    base = centers[rng.integers(0, nc, n)] + cluster_std * rng.standard_normal((n, dim)).astype(np.float32)
    queries = centers[rng.integers(0, nc, n_queries)] + cluster_std * rng.standard_normal(
        (n_queries, dim)
    ).astype(np.float32)
    return Dataset(name, base.astype(np.float32), queries.astype(np.float32), metric)


def make_uniform(name: str, n: int, dim: int, n_queries: int, metric: str = "euclidean", seed: int = 1234) -> Dataset:
    rng = np.random.default_rng(seed)
    return Dataset(
        name,
        rng.standard_normal((n, dim)).astype(np.float32),
        rng.standard_normal((n_queries, dim)).astype(np.float32),
        metric,
    )


def read_fbin(path: str, dtype=np.float32) -> np.ndarray:
    """``.fbin``/``.ibin`` reader (``cpp/bench/ann/src/common/dataset.hpp:37``:
    two int32 ``[n_rows, dim]``, then the row-major data)."""
    with open(path, "rb") as f:
        n, d = np.fromfile(f, np.int32, 2)
        return np.fromfile(f, dtype, int(n) * int(d)).reshape(int(n), int(d))


def write_fbin(path: str, arr: np.ndarray) -> None:
    def _write(f):
        np.asarray(arr.shape, np.int32).tofile(f)
        np.ascontiguousarray(arr).tofile(f)

    serialize.atomic_write(path, _write)


def load_fbin_dataset(name: str, base_path: str, query_path: str, metric: str = "euclidean", dtype=np.float32) -> Dataset:
    return Dataset(name, read_fbin(base_path, dtype), read_fbin(query_path, dtype), metric)


#: the shapes of ``run/conf/datasets.yaml``, generated
_REGISTRY = {
    # name: (n, dim, n_queries, metric)
    "sift-128-euclidean": (1_000_000, 128, 1_000, "euclidean"),
    "sift-128-euclidean-100k": (100_000, 128, 1_000, "euclidean"),
    "deep-image-96-angular-1M": (1_000_000, 96, 1_000, "inner_product"),
    "glove-100-angular-1M": (1_100_000, 100, 1_000, "inner_product"),
    "nytimes-256-angular": (290_000, 256, 1_000, "inner_product"),
    "smoke-10k": (10_000, 64, 200, "euclidean"),
}


def get_dataset(name: str, seed: int = 1234) -> Dataset:
    """The on-disk pair ``<DATA_DIR>/<name>/base.fbin`` + ``query.fbin``
    when present, else the registered generated dataset."""
    disk_base = os.path.join(DATA_DIR, name, "base.fbin")
    if os.path.exists(disk_base):
        metric = _REGISTRY[name][3] if name in _REGISTRY else "euclidean"
        return load_fbin_dataset(
            name, disk_base, os.path.join(DATA_DIR, name, "query.fbin"), metric=metric
        )
    if name not in _REGISTRY:
        raise KeyError(f"unknown dataset {name!r}; known: {sorted(_REGISTRY)}")
    n, dim, nq, metric = _REGISTRY[name]
    return make_clustered(name, n, dim, nq, metric=metric, seed=seed)
