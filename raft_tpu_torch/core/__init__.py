"""Core: errors, resources, serialization, bitsets.

Exports the JAX package's ``raft_tpu.core.__all__`` except the modules
still to port: ``core/{array,logging,tracing,interruptible}`` (ROADMAP
queue A7c)."""
from raft_tpu_torch.core.bitset import Bitmap, Bitset, popcount32
from raft_tpu_torch.core.errors import LogicError, RaftError, expects, fail
from raft_tpu_torch.core.resources import Resources, default_resources, ensure_resources
from raft_tpu_torch.core import serialize

__all__ = [
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
    "serialize",
]
