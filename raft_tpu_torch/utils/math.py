"""Small math/layout helpers (``raft_tpu.utils.math`` counterpart).

``LANES``/``SUBLANES`` are kept because the index layout the two packages
share (``choose_max_list``'s lane alignment) is defined in those units.
"""
from __future__ import annotations

LANES = 128  # TPU lane count (last-dim tile of the shared list layout)
SUBLANES = 8  # float32 sublane count


def cdiv(a: int, b: int) -> int:
    """Ceiling division."""
    return -(-a // b)


def round_up(a: int, b: int) -> int:
    """Round ``a`` up to the next multiple of ``b``."""
    return cdiv(a, b) * b


def round_down(a: int, b: int) -> int:
    """Round ``a`` down to a multiple of ``b``."""
    return (a // b) * b


def is_pow2(x: int) -> bool:
    return x > 0 and (x & (x - 1)) == 0


def next_pow2(x: int) -> int:
    """Smallest power of two >= x (x >= 1)."""
    if x <= 1:
        return 1
    return 1 << (x - 1).bit_length()


def prev_pow2(x: int) -> int:
    """Largest power of two <= x (x >= 1)."""
    if x < 1:
        raise ValueError("x must be >= 1")
    return 1 << (x.bit_length() - 1)


def pad_to_lanes(n: int) -> int:
    """Pad a trailing dimension up to the lane width."""
    return round_up(n, LANES)
