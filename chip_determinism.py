"""The measurements behind the port's reproducible builds, on one NVIDIA GPU.

    python3 chip_determinism.py [--seed 0]

Every k-means update of the port's builds sums rows by label
(``cluster.kmeans.segment_sum``). This script holds four ways of doing it
against each other on the card:

- ``fixed_point``: the values as exact int64 multiples of one power of two,
  added with ``index_add_`` (integer sums come out the same in any order);
- ``index_put``: ``index_put_(accumulate=True)``, which sorts the labels
  and adds each label's rows in that order;
- ``sort_segment_reduce``: a stable argsort of the labels and
  ``torch.segment_reduce``;
- ``atomic_index_add``: float ``index_add_``, which adds with atomics.

It prints, one JSON object per line with the card's name and power limit:
ms per call at the 1M-row IVF build's shapes (the balanced k-means EM step,
500,000 x 128 rows and 1,024 labels; the nibble codebook step, 64 subspaces
x 500,000 x 2 and 16 labels) and whether ten calls give the same bits; then
the seconds of 1,000,000 x 128 IVF-Flat and IVF-PQ builds (1,024 lists,
the data of ``chip_smoke.py``) with each way installed, each built twice in
turns, and whether the two builds are equal. Last, whether three runs from
one seed give the same bits for the draws of balanced k-means' re-seeding:
a float prefix sum of 500,000 weights, ``torch.multinomial``'s 1,024 draws
against it, and ``kmeans_balanced.draw_proportional``'s (which the port
uses). Exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch


def _flat(values, labels, k: int, batched: bool):
    """``values [N, ...]``, ``labels [N]`` int64 and the segment count; a
    batched call's labels offset by ``k`` per batch."""
    if not batched:
        return values, labels.to(torch.int64), k
    B, n = labels.shape
    flat = (labels.to(torch.int64) + k * torch.arange(B, device=labels.device)[:, None]).reshape(-1)
    return values.reshape((B * n,) + tuple(values.shape[2:])), flat, B * k


def _unflat(out, labels, k: int, batched: bool):
    return out.reshape((labels.shape[0], k) + tuple(out.shape[1:])) if batched else out


def index_put_sum(values, labels, k: int, batched: bool = False) -> torch.Tensor:
    v, lab, m = _flat(values, labels, k, batched)
    out = torch.zeros((m,) + tuple(v.shape[1:]), dtype=torch.float32, device=v.device)
    out.index_put_((lab,), v.to(torch.float32), accumulate=True)
    return _unflat(out, labels, k, batched)


def sort_reduce_sum(values, labels, k: int, batched: bool = False) -> torch.Tensor:
    v, lab, m = _flat(values, labels, k, batched)
    order = torch.argsort(lab, stable=True)
    out = torch.segment_reduce(v.to(torch.float32)[order], "sum",
                               lengths=torch.bincount(lab, minlength=m), axis=0)
    return _unflat(out, labels, k, batched)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_determinism: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from chip_smoke import (Clustered, atomic_segment_sum, card_line, cuda_ms, differing_fields,
                            emit, timed_build)
    from raft_tpu_torch.cluster.kmeans import segment_sum
    from raft_tpu_torch.cluster.kmeans_balanced import draw_proportional
    from raft_tpu_torch.core.resources import Resources
    from raft_tpu_torch.neighbors import ivf_flat, ivf_pq

    card = card_line()
    print(card, flush=True)
    ways = {"fixed_point": segment_sum, "index_put": index_put_sum,
            "sort_segment_reduce": sort_reduce_sum, "atomic_index_add": atomic_segment_sum}

    g = torch.Generator()
    g.manual_seed(args.seed)
    shapes = {"em_500000x128_k1024": ((500_000, 128), 1024, False),
              "pq_64x500000x2_k16": ((64, 500_000, 2), 16, True)}
    for shape_name, (shape, k, batched) in shapes.items():
        x = torch.randn(shape, generator=g).cuda()
        lab = torch.randint(0, k, shape[:-1], generator=g).cuda()
        v, fl, m = _flat(x, lab, k, batched)
        want = torch.zeros((m, shape[-1]), dtype=torch.float64, device=x.device)
        want = _unflat(want.index_add_(0, fl, v.double()), lab, k, batched)
        out = {}
        for name, fn in ways.items():
            runs = [fn(x, lab, k, batched=batched) for _ in range(10)]
            out[name] = dict(ms=cuda_ms(lambda: fn(x, lab, k, batched=batched), reps=10),
                             same_bits_in_ten_calls=all(torch.equal(runs[0], r) for r in runs[1:]),
                             max_abs_err_vs_f64=float((runs[0].double() - want).abs().max()))
        emit(card, phase="segment_sums", metric="ms_per_call", shape=shape_name, ways=out)
        del x, lab, want, v, fl

    rng = np.random.default_rng(args.seed)
    res = Resources(device="cuda", seed=args.seed)
    gen = Clustered(rng, 128, 4096)
    X = torch.from_numpy(gen.sample(1_000_000)).cuda()
    builds = {
        "ivf_flat_1m": (lambda: ivf_flat.build(X, ivf_flat.IvfFlatIndexParams(n_lists=1024), res=res),
                        ("centers", "list_sizes", "list_indices", "list_data", "list_norms")),
        "ivf_pq_1m": (lambda: ivf_pq.build(X, ivf_pq.IvfPqIndexParams(n_lists=1024), res=res),
                      ("centers", "pq_centers", "list_sizes", "list_indices", "codes", "rot_sqnorms")),
    }
    timed_build(builds["ivf_pq_1m"][0])  # warm-up: allocator, first launches
    for index_name, (build, fields) in builds.items():
        got = {name: [] for name in ways}
        for _ in range(2):
            for name, fn in ways.items():
                got[name].append(timed_build(build, fn))
        for name, ((a, sa), (b, sb)) in got.items():
            emit(card, phase="segment_sums", metric="build_s", index=index_name, way=name,
                 build_s=[sa, sb], fields_differing=differing_fields(a, b, fields),
                 max_list=[a.max_list, b.max_list])
        del got

    p = torch.randint(1, 600, (500_000,), generator=g).to(torch.float32).cuda()
    same = {}
    for name, fn in (("float_cumsum", lambda gen: torch.cumsum(p, 0)),
                     ("multinomial", lambda gen: torch.multinomial(p, 1024, replacement=True,
                                                                   generator=gen)),
                     ("draw_proportional", lambda gen: draw_proportional(gen, p, 1024))):
        runs = []
        for _ in range(3):
            gen = torch.Generator(device=p.device)
            gen.manual_seed(args.seed)
            runs.append(fn(gen))
        same[name] = all(torch.equal(runs[0], r) for r in runs[1:])
    emit(card, phase="draws", metric="same_bits_in_three_runs", value=same)
    return 0


if __name__ == "__main__":
    sys.exit(main())
