"""Online serving: shape buckets, micro-batcher, engine."""
from raft_tpu_torch.serve.batcher import DeadlineExceeded, MicroBatcher, QueueFull, Request, ServeFuture
from raft_tpu_torch.serve.bucketing import ProgramCache, ProgramKey, bucket_for, bucket_sizes, pad_rows, unpad_rows
from raft_tpu_torch.serve.engine import ServeResult, ServingEngine

__all__ = [
    "DeadlineExceeded", "MicroBatcher", "ProgramCache", "ProgramKey", "QueueFull", "Request",
    "ServeFuture", "ServeResult", "ServingEngine", "bucket_for", "bucket_sizes", "pad_rows",
    "unpad_rows",
]
