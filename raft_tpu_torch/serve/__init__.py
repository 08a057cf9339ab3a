"""Online serving: shape buckets, micro-batcher, engine."""
from raft_tpu_torch.serve.batcher import DeadlineExceeded, MicroBatcher, QueueFull, Request, ServeFuture
from raft_tpu_torch.serve.bucketing import (CacheStats, ProgramCache, ProgramKey, bucket_for,
                                           bucket_sizes, pad_rows, params_key, unpad_rows)
from raft_tpu_torch.serve.engine import ServeResult, ServingEngine

__all__ = [
    "CacheStats", "DeadlineExceeded", "MicroBatcher", "ProgramCache", "ProgramKey", "QueueFull",
    "Request", "ServeFuture", "ServeResult", "ServingEngine", "bucket_for", "bucket_sizes",
    "pad_rows", "params_key", "unpad_rows",
]
