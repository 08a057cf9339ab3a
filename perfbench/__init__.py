"""The benchmark of ``raft_tpu_torch`` on NVIDIA H100 cards.

``python3 -m perfbench.run --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json``. See
``perfbench/README.md``.
"""
