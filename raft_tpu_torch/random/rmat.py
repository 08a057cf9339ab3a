"""R-MAT graphs (``raft_tpu.random.rmat`` counterpart; reference
``random/rmat_rectangular_generator.cuh``).

One categorical draw a (edge, level) picks a quadrant ``q`` in {0, 1, 2,
3} with probabilities (a, b, c, d), and its bits ``(q >> 1, q & 1)`` are
that level's row and column bits, most significant first; a level past an
axis' scale adds nothing to that axis. The draw is one uniform a slot
against the cumulative probabilities.
"""
from __future__ import annotations

from typing import Tuple

import torch

from raft_tpu_torch.core.errors import expects
from raft_tpu_torch.random.rng import KeyLike, as_key


def rmat(key: KeyLike, n_edges: int, r_scale: int, c_scale: int, a: float = 0.57,
         b: float = 0.19, c: float = 0.19, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``n_edges`` edges of an R-MAT graph over ``2^r_scale x 2^c_scale``
    vertices: ``(src, dst)`` int32 on the generator's device; ``d = 1 - a
    - b - c``."""
    d = 1.0 - a - b - c
    expects(d >= -1e-6, "rmat probabilities exceed 1")
    expects(r_scale > 0 and c_scale > 0, "scales must be positive")
    g = as_key(key, device=device)
    max_scale = max(r_scale, c_scale)
    u = torch.rand((n_edges, max_scale), generator=g, device=g.device)
    q = ((u >= a).to(torch.int32) + (u >= a + b).to(torch.int32)
         + (u >= a + b + c).to(torch.int32))
    levels = torch.arange(max_scale, dtype=torch.int64, device=g.device)

    def weights(scale):
        w = torch.bitwise_left_shift(torch.ones_like(levels),
                                     scale - 1 - torch.clamp(levels, max=scale - 1))
        return torch.where(levels < scale, w, torch.zeros_like(w))

    src = torch.sum(((q >> 1) & 1) * weights(r_scale)[None, :], dim=1).to(torch.int32)
    dst = torch.sum((q & 1) * weights(c_scale)[None, :], dim=1).to(torch.int32)
    return src, dst
