"""Layout helpers; the lock witness (``lockcheck``) and graph helpers are
imported by module. Exports the JAX package's ``raft_tpu.utils.__all__``
(``utils/math.py`` keeps the list layout's lane constants)."""
from raft_tpu_torch.utils.math import (
    LANES,
    SUBLANES,
    cdiv,
    is_pow2,
    next_pow2,
    pad_to_lanes,
    prev_pow2,
    round_down,
    round_up,
)

__all__ = [
    "LANES",
    "SUBLANES",
    "cdiv",
    "is_pow2",
    "next_pow2",
    "pad_to_lanes",
    "prev_pow2",
    "round_down",
    "round_up",
]
