"""Statistics: recall.

Exports ``neighborhood_recall`` of the JAX package's
``raft_tpu.stats.__all__``; the summary statistics and model metrics
(``stats/{summary,metrics}.py``) are ROADMAP queue A7c."""
from raft_tpu_torch.stats.recall import neighborhood_recall

__all__ = ["neighborhood_recall"]
