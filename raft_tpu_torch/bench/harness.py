"""ANN benchmark harness, layer L8 (``raft_tpu.bench.harness`` counterpart).

The reference's algorithm-agnostic bench over the port:

* a build and a search adapter per algorithm, the ``ANN<T>`` interface
  (``cpp/bench/ann/src/common/ann_types.hpp:74,116``);
* a timed build and timed search sweeps after a warm-up, recall computed
  in the harness against the cached exact ground truth, QPS and latency
  (``cpp/bench/ann/src/common/benchmark.hpp:120,175,379``);
* the gbench JSON schema (``items_per_second``, ``Recall``, ``Latency``,
  ``end_to_end``, ``total_queries``, ``benchmark.hpp:330-385``), so the
  reference's export and plot tools read the rows;
* grid sweeps and the recall-constrained operating point, the
  orchestration of ``raft_ann_bench/run/__main__.py:141``.

Everything runs on ``res``'s device (default ``cuda``). Launches are
asynchronous, so the build and every timed sweep end in a synchronise of
that device. The queries, and for IVF-PQ's refine the base rows, are
copied to the device once, before the timed loop. A kernel's failure
propagates: nothing here falls back to a plain version.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from raft_tpu_torch.bench.datasets import Dataset
from raft_tpu_torch.core import serialize
from raft_tpu_torch.core.resources import Resources, ensure_resources

# -- algorithm adapters (ann_types.hpp:74 ANN<T>::build / ::search) ---------------------


def _metric_of(ds: Dataset):
    from raft_tpu_torch.ops.distance import DistanceType

    return DistanceType.InnerProduct if ds.metric == "inner_product" else DistanceType.L2Expanded


def _build_brute_force(ds: Dataset, p: Dict[str, Any], res: Resources):
    from raft_tpu_torch.neighbors import brute_force

    return brute_force.build(ds.base, metric=_metric_of(ds), res=res)


def _search_brute_force(index, queries, k: int, p: Dict[str, Any], batch: int):
    from raft_tpu_torch.neighbors import brute_force

    return brute_force.search(
        index,
        queries,
        k,
        query_batch=batch,
        mode=p.get("mode", "exact"),
        recall_target=p.get("recall_target", 0.99),
    )


def _half_lists(index):
    """``index`` with bf16 lists (the reference's half-precision lists):
    half the bytes kernel B1 reads. The norms are those of the bf16 rows,
    as a build from bf16 data gives."""
    from raft_tpu_torch.ops.distance import row_norms

    data = index.list_data.to(torch.bfloat16)
    norms = None
    if index.list_norms is not None:
        norms = row_norms(data.reshape(-1, data.shape[-1])).reshape(data.shape[:2])
    return dataclasses.replace(index, list_data=data, list_norms=norms)


def _build_ivf_flat(ds: Dataset, p: Dict[str, Any], res: Resources):
    from raft_tpu_torch.neighbors import ivf_flat

    index = ivf_flat.build(
        ds.base,
        ivf_flat.IvfFlatIndexParams(
            n_lists=p.get("nlist", 1024),
            metric=_metric_of(ds),
            kmeans_n_iters=p.get("niter", 20),
            kmeans_trainset_fraction=1.0 / p.get("ratio", 2),
        ),
        res=res,
    )
    if p.get("list_dtype") == "half":
        index = _half_lists(index)
    return index


def _search_ivf_flat(index, queries, k: int, p: Dict[str, Any], batch: int):
    from raft_tpu_torch.neighbors import ivf_flat

    return ivf_flat.search(
        index,
        queries,
        k,
        ivf_flat.IvfFlatSearchParams(
            n_probes=p.get("nprobe", 20),
            fused_qt=p.get("fused_qt", 64),
            fused_probe_factor=p.get("fused_pf", 4),
            fused_group=p.get("fused_group", 1),
            fused_merge=p.get("fused_merge", "seg"),
            fused_precision=p.get("fused_precision", "highest"),
        ),
        query_batch=batch,
        mode=p.get("mode", "auto"),
    )


def _build_ivf_pq(ds: Dataset, p: Dict[str, Any], res: Resources):
    from raft_tpu_torch.neighbors import ivf_pq

    return ivf_pq.build(
        ds.base,
        ivf_pq.IvfPqIndexParams(
            n_lists=p.get("nlist", 1024),
            metric=_metric_of(ds),
            pq_dim=p.get("pq_dim", 0),
            pq_bits=p.get("pq_bits", 8),
            kmeans_n_iters=p.get("niter", 20),
            kmeans_trainset_fraction=1.0 / p.get("ratio", 10),
        ),
        res=res,
    )


#: ``smemLutDtype`` -> the LUT dtype (fp8 scores in bf16, as in the JAX package)
_LUT_DTYPES = {"float": torch.float32, "half": torch.bfloat16, "bf16": torch.bfloat16,
               "fp8": torch.bfloat16}


def _search_ivf_pq(index, queries, k: int, p: Dict[str, Any], batch: int):
    from raft_tpu_torch.neighbors import ivf_pq
    from raft_tpu_torch.neighbors.refine import refine

    # only an explicit smemLutDtype demands a precision; absent, "auto"
    # keeps the fused bf16-LUT kernel
    lut = _LUT_DTYPES[p["smemLutDtype"]] if "smemLutDtype" in p else None
    rr = p.get("refine_ratio", 1)
    d, i = ivf_pq.search(
        index,
        queries,
        k * rr,
        ivf_pq.IvfPqSearchParams(n_probes=p.get("nprobe", 20), lut_dtype=lut),
        query_batch=batch,
    )
    if rr > 1:
        # the base rows' device copy, made by run_case before the timed loop
        d, i = refine(p["_base"], queries, i, k, metric=_metric_of(p["_dataset"]))
    return d, i


def _cagra_build_algo(name: str) -> str:
    """The port's ``build_algo`` for a spelling of the reference's yaml
    (``"NN_DESCENT"``, ``"IVF_PQ"``, any case); other names pass through,
    and ``cagra.build`` rejects them."""
    from raft_tpu_torch.neighbors import cagra

    return {"nn_descent": cagra.NN_DESCENT, "ivf_pq": cagra.IVF_PQ}.get(str(name).lower(), name)


def _build_cagra(ds: Dataset, p: Dict[str, Any], res: Resources):
    from raft_tpu_torch.neighbors import cagra

    return cagra.build(
        ds.base,
        cagra.CagraIndexParams(
            intermediate_graph_degree=p.get("intermediate_graph_degree", 64),
            graph_degree=p.get("graph_degree", 32),
            build_algo=_cagra_build_algo(p.get("graph_build_algo", "NN_DESCENT")),
            metric=_metric_of(ds),
        ),
        res=res,
    )


def _search_cagra(index, queries, k: int, p: Dict[str, Any], batch: int):
    from raft_tpu_torch.neighbors import cagra

    return cagra.search(
        index,
        queries,
        k,
        cagra.CagraSearchParams(
            itopk_size=p.get("itopk", 64),
            search_width=p.get("search_width", 1),
            max_iterations=p.get("max_iterations", 0),
        ),
        query_batch=batch,
    )


ALGOS: Dict[str, Tuple[Callable, Callable]] = {
    "raft_brute_force": (_build_brute_force, _search_brute_force),
    "raft_ivf_flat": (_build_ivf_flat, _search_ivf_flat),
    "raft_ivf_pq": (_build_ivf_pq, _search_ivf_pq),
    "raft_cagra": (_build_cagra, _search_cagra),
}


# -- the result record (benchmark.hpp:330-385 counters) -------------------------------


@dataclasses.dataclass
class BenchResult:
    name: str
    algo: str
    dataset: str
    k: int
    batch: int
    build_params: Dict[str, Any]
    search_params: Dict[str, Any]
    build_time: float
    end_to_end: float  # total timed search seconds
    iterations: int  # timed sweeps over the query set
    total_queries: int
    qps: float  # items_per_second
    latency: float  # mean seconds a batch
    recall: float
    #: the ids of the first timed sweep, ``[nq, k]`` (not in the report)
    found: Optional[np.ndarray] = dataclasses.field(default=None, repr=False, compare=False)

    def to_json(self) -> Dict[str, Any]:
        """One gbench-style benchmark entry (``benchmark.hpp:330-385``)."""
        return {
            "name": self.name,
            "run_type": "iteration",
            "iterations": self.iterations,
            "real_time": self.end_to_end / max(self.iterations, 1),
            "time_unit": "s",
            "items_per_second": self.qps,
            "Recall": self.recall,
            "Latency": self.latency,
            "end_to_end": self.end_to_end,
            "total_queries": self.total_queries,
            "build_time": self.build_time,
            "k": self.k,
            "n_queries": self.batch,
            "algo": self.algo,
            "dataset": self.dataset,
            "build_params": self.build_params,
            "search_params": self.search_params,
        }


def recall_at_k(found: np.ndarray, gt: np.ndarray, k: int) -> float:
    """Set-overlap recall, the harness's metric (``benchmark.hpp:346-379``)."""
    found = found[:, :k]
    gt = gt[:, :k]
    hits = 0
    for row_f, row_g in zip(found, gt):
        hits += len(np.intersect1d(row_f, row_g, assume_unique=False))
    return hits / float(gt.shape[0] * k)


# -- the runner --------------------------------------------------------------------------


def _grid(space: Dict[str, Sequence[Any]]) -> Iterable[Dict[str, Any]]:
    """Cartesian product of a ``{param: [values...]}`` grid (run/__main__.py:141)."""
    if not space:
        yield {}
        return
    keys = list(space)
    for combo in itertools.product(*(space[key] for key in keys)):
        yield dict(zip(keys, combo))


def _fmt(params: Dict[str, Any]) -> str:
    return ",".join(f"{k}={v}" for k, v in params.items() if not k.startswith("_")) or "default"


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_case(
    ds: Dataset,
    algo: str,
    build_params: Dict[str, Any],
    search_params_list: Sequence[Dict[str, Any]],
    k: int = 10,
    batch: int = 1024,
    min_search_time: float = 2.0,
    max_iterations: int = 20,
    constraint: Optional[Callable[[Dict[str, Any], Dict[str, Any]], bool]] = None,
    verbose: bool = True,
    res: Optional[Resources] = None,
) -> List[BenchResult]:
    """Build once on ``res``'s device (default ``cuda``), then time every
    search-parameter point (the reference's build/search split,
    ``benchmark.hpp:120,175``). Each result's ``found`` ids come from the
    first timed sweep."""
    res = ensure_resources(res)
    dev = res.device
    build_fn, search_fn = ALGOS[algo]
    gt = ds.ground_truth(k, res=res)

    _sync(dev)
    t0 = time.perf_counter()
    index = build_fn(ds, build_params, res)
    _sync(dev)  # the build's packing and encoding too
    build_time = time.perf_counter() - t0
    if verbose:
        print(f"# {algo} [{_fmt(build_params)}] built in {build_time:.1f}s", flush=True)

    nq = ds.queries.shape[0]
    # whole batches only, as the JAX package times them
    if nq > batch:
        nq = (nq // batch) * batch
        gt = gt[:nq]
    queries = torch.from_numpy(np.ascontiguousarray(ds.queries[:nq])).to(dev)
    base = None
    if algo == "raft_ivf_pq" and any(sp.get("refine_ratio", 1) > 1 for sp in search_params_list):
        base = torch.from_numpy(np.ascontiguousarray(ds.base)).to(dev)
    results = []
    for sp in search_params_list:
        if constraint is not None and not constraint(build_params, sp):
            continue
        sp = dict(sp, _dataset=ds, _base=base)
        search_fn(index, queries[:batch], k, sp, batch)  # warm-up
        _sync(dev)

        # timed: sweep the query set until min_search_time
        iters = 0
        total_q = 0
        found = None
        t0 = time.perf_counter()
        while True:
            outs = [search_fn(index, queries[s: s + batch], k, sp, batch)
                    for s in range(0, nq, batch)]
            _sync(dev)
            iters += 1
            total_q += nq
            if found is None:
                found = torch.cat([o[1] for o in outs], dim=0).cpu().numpy()
            if time.perf_counter() - t0 >= min_search_time or iters >= max_iterations:
                break
        end_to_end = time.perf_counter() - t0

        rec = recall_at_k(found, gt, k)
        n_batches = iters * -(-nq // batch)
        result = BenchResult(
            name=f"{algo}.{_fmt(build_params)}/{_fmt(sp)}/k={k}/batch={batch}",
            algo=algo,
            dataset=ds.name,
            k=k,
            batch=batch,
            build_params=dict(build_params),
            search_params={key: v for key, v in sp.items() if not key.startswith("_")},
            build_time=build_time,
            end_to_end=end_to_end,
            iterations=iters,
            total_queries=total_q,
            qps=total_q / end_to_end,
            latency=end_to_end / n_batches,
            recall=rec,
            found=found,
        )
        results.append(result)
        if verbose:
            print(
                f"  {_fmt(result.search_params):<40s} qps={result.qps:>12,.0f}  "
                f"recall@{k}={rec:.4f}  lat={result.latency*1e3:.2f}ms",
                flush=True,
            )
    return results


def sweep(
    ds: Dataset,
    algo: str,
    build_grid: Dict[str, Sequence[Any]],
    search_grid: Dict[str, Sequence[Any]],
    **kw,
) -> List[BenchResult]:
    """The whole build grid × search grid of one algorithm."""
    out: List[BenchResult] = []
    for bp in _grid(build_grid):
        out.extend(run_case(ds, algo, bp, list(_grid(search_grid)), **kw))
    return out


# -- analysis (the data_export and plot analogs) ---------------------------------------


def pareto_frontier(results: Sequence[BenchResult]) -> List[BenchResult]:
    """The recall-QPS Pareto frontier (``raft_ann_bench/plot/__main__.py``)."""
    pts = sorted(results, key=lambda r: (-r.recall, -r.qps))
    front: List[BenchResult] = []
    best_qps = -1.0
    for r in pts:
        if r.qps > best_qps:
            front.append(r)
            best_qps = r.qps
    return list(reversed(front))


def operating_point(results: Sequence[BenchResult], min_recall: float = 0.95) -> Optional[BenchResult]:
    """The highest-QPS configuration with recall >= ``min_recall``."""
    ok = [r for r in results if r.recall >= min_recall]
    return max(ok, key=lambda r: r.qps) if ok else None


def _device_context(device) -> Tuple[str, int]:
    """``(device name, device count)``: the card's name and the visible
    cards, or ``("cpu", 1)``."""
    dev = torch.device(device if device is not None
                       else ("cuda" if torch.cuda.is_available() else "cpu"))
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev), torch.cuda.device_count()
    return "cpu", 1


def to_report(results: Sequence[BenchResult], context: Optional[Dict[str, Any]] = None,
              device=None) -> Dict[str, Any]:
    """A gbench-shaped JSON document ``{context, benchmarks}``. ``device``:
    where the results ran (default: ``cuda`` when a card is visible)."""
    name, count = _device_context(device)
    ctx = {
        "date": time.strftime("%Y-%m-%dT%H:%M:%S"),
        "executable": "raft_tpu_torch.bench",
        "device": name,
        "num_devices": count,
    }
    ctx.update(context or {})
    return {"context": ctx, "benchmarks": [r.to_json() for r in results]}


def save_report(results: Sequence[BenchResult], path: str, context: Optional[Dict[str, Any]] = None,
                device=None) -> None:
    payload = json.dumps(to_report(results, context, device), indent=2).encode("utf-8")
    serialize.atomic_write(path, lambda f: f.write(payload))
