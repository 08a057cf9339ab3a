"""Clustered synthetic data (``raft_tpu.random.make_blobs`` counterpart;
reference ``random/make_blobs.cuh``)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from raft_tpu_torch.core import serialize as ser
from raft_tpu_torch.core.errors import expects
from raft_tpu_torch.random.rng import KeyLike, as_key


def make_blobs(
    key: KeyLike,
    n_samples: int,
    n_features: int,
    n_clusters: int = 5,
    cluster_std: float = 1.0,
    center_box: Tuple[float, float] = (-10.0, 10.0),
    centers=None,
    shuffle: bool = True,
    dtype=torch.float32,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(X [n_samples, n_features], labels [n_samples] i32, centers
    [n_clusters, n_features])`` on the generator's device. Samples go to
    the clusters round-robin (the reference's equal proportions), then are
    optionally shuffled. Draws from ``key`` in order: the centers (unless
    given), the noise, the shuffle."""
    expects(n_samples > 0 and n_features > 0 and n_clusters > 0, "sizes must be positive")
    g = as_key(key, device=device)
    dev = g.device
    if centers is None:
        u = torch.rand((n_clusters, n_features), generator=g, device=dev)
        centers = center_box[0] + (center_box[1] - center_box[0]) * u
    else:
        centers = ser.as_tensor(centers, dev).to(torch.float32)
        expects(tuple(centers.shape) == (n_clusters, n_features), "centers shape mismatch")
    labels = torch.arange(n_samples, dtype=torch.int32, device=dev) % n_clusters
    noise = cluster_std * torch.randn((n_samples, n_features), generator=g, device=dev)
    X = centers[labels.to(torch.int64)] + noise
    if shuffle:
        perm = torch.randperm(n_samples, generator=g, device=dev)
        X = X[perm]
        labels = labels[perm]
    return X.to(dtype), labels, centers
