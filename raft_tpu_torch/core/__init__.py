"""Core: errors, resources, serialization, bitsets, logging, tracing,
interruptible cancellation and array ingestion.

Exports the JAX package's ``raft_tpu.core.__all__``."""
from raft_tpu_torch.core.array import as_array, check_dtype_one_of, check_matching_dims
from raft_tpu_torch.core.bitset import Bitmap, Bitset, popcount32
from raft_tpu_torch.core.errors import LogicError, RaftError, expects, fail
from raft_tpu_torch.core.resources import Resources, default_resources, ensure_resources
from raft_tpu_torch.core import interruptible, logging, serialize, tracing

__all__ = [
    "as_array",
    "check_dtype_one_of",
    "check_matching_dims",
    "Bitmap",
    "Bitset",
    "popcount32",
    "LogicError",
    "RaftError",
    "expects",
    "fail",
    "Resources",
    "default_resources",
    "ensure_resources",
    "interruptible",
    "logging",
    "serialize",
    "tracing",
]
