"""Faults planted in the program, which the check has to come out as not
correct on: the tests plant them, and ``python3 -m perfbench.calibrate
--fault <name>`` reads them at a cell's own size. Each takes the
function it breaks and returns the broken one."""
from __future__ import annotations

import dataclasses

import torch


def half_left_out(search):
    """Search whose second half of each batch is answered with the first
    half's answers."""
    def broken(index, queries, k, *a, **kw):
        d, i = search(index, queries, k, *a, **kw)
        h = d.shape[0] // 2
        if h:
            d, i = d.clone(), i.clone()
            d[h : 2 * h], i[h : 2 * h] = d[:h], i[:h]
        return d, i
    return broken


def answer_altered(search):
    """Search whose last id of each answer is altered where it is made."""
    def broken(index, queries, k, *a, **kw):
        d, i = search(index, queries, k, *a, **kw)
        i = i.clone()
        i[:, -1] = (i[:, -1] + 1) % index.size
        return d, i
    return broken


def fewer_probes(search):
    """Search over a tenth of the lists the configuration states: what a
    scan that drops probes answers (at the tests' tiny size a query's few
    nearest lists hold all its neighbours, so only a deep cut shows)."""
    def broken(index, queries, k, params, *a, **kw):
        params = dataclasses.replace(params, n_probes=max(1, params.n_probes // 10))
        return search(index, queries, k, params, *a, **kw)
    return broken


def untrained(fit):
    """Balanced k-means that skips its training: the centres are rows of
    the trainset drawn at random from the build's seed."""
    def broken(X, params=None, res=None, **kw):
        k = params.n_clusters if params is not None else kw["n_clusters"]
        seed = params.seed if params is not None else kw.get("seed", 0)
        X = torch.as_tensor(X).to(torch.float32)
        g = torch.Generator(device=X.device)
        g.manual_seed(int(seed))
        return X[torch.randperm(X.shape[0], generator=g, device=X.device)[:k]].clone()
    return broken


#: ``name: (module, attribute, fault)``: what ``--fault <name>`` breaks
PLANTED = {
    "untrained": ("raft_tpu_torch.cluster.kmeans_balanced", "fit", untrained),
}


def plant(name: str) -> None:
    """Break the program's function that fault ``name`` names, for the rest
    of the process."""
    import importlib

    module, attr, fault = PLANTED[name]
    mod = importlib.import_module(module)
    setattr(mod, attr, fault(getattr(mod, attr)))
