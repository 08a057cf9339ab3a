"""The CLI (``raft_tpu.bench.__main__`` counterpart): the
``raft-ann-bench`` run orchestration
(``python/raft-ann-bench/src/raft_ann_bench/run/__main__.py:141``).

Examples::

    python -m raft_tpu_torch.bench --dataset smoke-10k --algos raft_ivf_flat --group smoke
    python -m raft_tpu_torch.bench --dataset sift-128-euclidean --algos raft_ivf_flat,raft_cagra \
        --k 10 --batch 1024 --out results.json
    python -m raft_tpu_torch.bench --device cpu --group smoke --algos raft_brute_force

``--device`` (default ``cuda``) is where the indexes are built and
searched; the entry points never fall back to the CPU by themselves.
"""
from __future__ import annotations

import argparse
import json

from raft_tpu_torch.bench import configs, datasets, harness
from raft_tpu_torch.core.resources import Resources


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("raft_tpu_torch.bench")
    ap.add_argument("--dataset", default="smoke-10k")
    ap.add_argument("--algos", default="raft_brute_force,raft_ivf_flat,raft_ivf_pq,raft_cagra")
    ap.add_argument("--group", default="base", choices=sorted(configs.GROUPS))
    ap.add_argument("-k", "--k", type=int, default=10)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--min-recall", type=float, default=0.95)
    ap.add_argument("--min-search-time", type=float, default=2.0)
    ap.add_argument("--out", default=None, help="write gbench-style JSON report here")
    ap.add_argument("--csv-out", default=None, help="also export results as CSV (data_export)")
    ap.add_argument("--plot-out", default=None, help="also render the recall-QPS plot (PNG)")
    ap.add_argument("--device", default="cuda", help="where to build and search (cuda | cpu)")
    args = ap.parse_args(argv)
    res = Resources(device=args.device)

    ds = datasets.get_dataset(args.dataset)
    print(f"# dataset {ds.name}: n={ds.n} dim={ds.dim} nq={ds.queries.shape[0]} metric={ds.metric}")

    all_results = []
    for algo in args.algos.split(","):
        algo = algo.strip()
        grids = configs.GROUPS[args.group][algo]
        rows = harness.sweep(
            ds,
            algo,
            grids["build"],
            grids["search"],
            k=args.k,
            batch=args.batch,
            min_search_time=args.min_search_time,
            constraint=configs.constraint(algo),
            res=res,
        )
        all_results.extend(rows)
        op = harness.operating_point(rows, args.min_recall)
        if op:
            print(
                f"## {algo} @ recall>={args.min_recall}: {op.qps:,.0f} qps "
                f"(recall={op.recall:.4f}, {harness._fmt(op.search_params)})"
            )
        else:
            print(f"## {algo}: no config reached recall {args.min_recall}")

    if args.out:
        harness.save_report(all_results, args.out, device=res.device)
        print(f"# wrote {args.out}")
    else:
        print(json.dumps([r.to_json() for r in harness.pareto_frontier(all_results)], indent=2))
    if args.csv_out:
        from raft_tpu_torch.bench.data_export import export_results_csv

        print(f"# wrote {export_results_csv(all_results, args.csv_out)}")
    if args.plot_out:
        from raft_tpu_torch.bench.plot import plot_results

        print(f"# wrote {plot_results(all_results, args.plot_out)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
