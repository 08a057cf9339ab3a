"""The program's entry points as the benchmark calls them: building an
index from a configuration, its search parameters, one search call, and a
plain view of the index's tensors for the reference and the roofline
counts. This is the one module of the harness that names the program's
index types."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch


def _module(config: dict):
    from raft_tpu_torch.neighbors import ivf_flat, ivf_pq

    return {"ivf_flat": ivf_flat, "ivf_pq": ivf_pq}[config["index"]]


def _resources(device):
    from raft_tpu_torch.core.resources import Resources

    return Resources(device=device)


def build(config: dict, rows: torch.Tensor, device, seed: int):
    """The configuration's index over ``rows``; the build's own seed is
    the run's (numpy and the program take it below 2**31)."""
    mod = _module(config)
    cls = mod.IvfFlatIndexParams if config["index"] == "ivf_flat" else mod.IvfPqIndexParams
    params = cls(**config["build"], seed=int(seed) % (1 << 31))
    return mod.build(rows, params, res=_resources(device))


def search_params(config: dict, overrides: Optional[dict] = None):
    mod = _module(config)
    cls = mod.IvfFlatSearchParams if config["index"] == "ivf_flat" else mod.IvfPqSearchParams
    return cls(**{**config["search"], **(overrides or {})})


def search(config: dict, index, rows: torch.Tensor, queries: torch.Tensor,
           params) -> Tuple[torch.Tensor, torch.Tensor]:
    """One call of the library's search: ``(distances, ids)``; IVF-PQ
    re-ranks against the rows held on the device."""
    mod = _module(config)
    dataset = rows if config["index"] == "ivf_pq" else None
    return mod.search(index, queries, config["k"], params, dataset=dataset,
                      query_batch=int(config["query_batch"]))


def view(config: dict, index) -> Dict[str, torch.Tensor]:
    """The index's tensors under plain names (what the reference judges
    and what the roofline counts read)."""
    out = {"centers": index.centers, "list_indices": index.list_indices,
           "list_sizes": index.list_sizes}
    if config["index"] == "ivf_flat":
        out["list_data"] = index.list_data
    else:
        if index.packed or index.rabitq:
            raise ValueError("the reference reads one PQ code a byte")
        out.update(codes=index.codes, pq_centers=index.pq_centers, rotation=index.rotation)
    return out
