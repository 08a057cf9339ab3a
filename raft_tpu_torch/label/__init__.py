"""Label utilities: unique classes, monotonic relabelling, label merging.

Exports the JAX package's ``raft_tpu.label.__all__``."""
from raft_tpu_torch.label.classlabels import get_classes, make_monotonic, merge_labels

__all__ = ["get_classes", "make_monotonic", "merge_labels"]
