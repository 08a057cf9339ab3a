"""Packed bitset used as ANN search prefilters (``raft_tpu.core.bitset``
counterpart).

The word layout is the JAX package's: bit ``i`` lives in word ``i // 32``
at bit position ``i % 32``, bit = 1 means "keep", tail bits beyond
``size`` are 0. PyTorch's unsigned 32-bit type supports few operations, so
the words are held as int32 with the identical bit pattern;
:meth:`Bitset.words` returns them as numpy uint32.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from raft_tpu_torch.utils.math import cdiv

_BITS = 32


def _wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 with the same low 32 bits."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


@dataclasses.dataclass
class Bitset:
    """A fixed-size set of bits over ``[0, size)``; bit=1 means "keep"."""

    bits: torch.Tensor  # int32[ceil(size/32)], uint32 bit pattern
    size: int

    @staticmethod
    def create(size: int, default: bool = True, device=None) -> "Bitset":
        return Bitset.from_mask(torch.full((size,), bool(default), device=device))

    @staticmethod
    def from_mask(mask: torch.Tensor) -> "Bitset":
        """Pack a boolean vector (True = keep) into a bitset."""
        size = mask.shape[0]
        n_words = cdiv(size, _BITS)
        pad = n_words * _BITS - size
        m = torch.nn.functional.pad(mask.to(torch.int64), (0, pad)).reshape(n_words, _BITS)
        weights = (1 << torch.arange(_BITS, dtype=torch.int64, device=mask.device))[None, :]
        return Bitset(bits=_wrap_i32((m * weights).sum(dim=1)), size=size)

    @staticmethod
    def from_numpy_words(words: np.ndarray, size: int, device=None) -> "Bitset":
        """Adopt uint32 words (e.g. the JAX package's ``Bitset.bits``)."""
        w = np.ascontiguousarray(np.asarray(words, np.uint32)).view(np.int32).copy()
        return Bitset(bits=torch.from_numpy(w).to(device), size=int(size))

    @staticmethod
    def from_unset_indices(size: int, indices: torch.Tensor, device=None) -> "Bitset":
        """All-set bitset with ``indices`` cleared (deleted-rows ctor)."""
        return Bitset.create(size, default=True, device=device).unset(indices)

    def words(self) -> np.ndarray:
        """The words as numpy uint32."""
        return self.bits.cpu().numpy().view(np.uint32)

    def test(self, indices: torch.Tensor) -> torch.Tensor:
        """Gather bit values at ``indices`` -> bool tensor."""
        indices = indices.to(torch.int64)
        word = self.bits[indices // _BITS]
        return ((word >> (indices % _BITS).to(torch.int32)) & 1).to(torch.bool)

    def set(self, indices: torch.Tensor) -> "Bitset":
        mask = self.to_mask().clone()
        mask[indices.to(torch.int64)] = True
        return Bitset.from_mask(mask)

    def unset(self, indices: torch.Tensor) -> "Bitset":
        mask = self.to_mask().clone()
        mask[indices.to(torch.int64)] = False
        return Bitset.from_mask(mask)

    def flip(self) -> "Bitset":
        return Bitset.from_mask(~self.to_mask())

    def count(self) -> int:
        """Number of set bits."""
        return int(self.to_mask().sum())

    def to_mask(self) -> torch.Tensor:
        """Unpack into a bool[size] vector."""
        shifts = torch.arange(_BITS, dtype=torch.int32, device=self.bits.device)[None, :]
        unpacked = ((self.bits[:, None] >> shifts) & 1).to(torch.bool)
        return unpacked.reshape(-1)[: self.size]


@dataclasses.dataclass
class Bitmap:
    """A 2-D bitset (``core/bitmap.hpp``): ``rows x cols`` bits over a
    :class:`Bitset` of the row-major flattened indices, as in the JAX
    package (per-query filters)."""

    bitset: Bitset
    rows: int
    cols: int

    @staticmethod
    def from_mask(mask2d: torch.Tensor) -> "Bitmap":
        rows, cols = mask2d.shape
        return Bitmap(Bitset.from_mask(mask2d.reshape(-1)), int(rows), int(cols))

    def test(self, row: torch.Tensor, col: torch.Tensor) -> torch.Tensor:
        row = torch.as_tensor(row).to(torch.int64)
        return self.bitset.test(row * self.cols + torch.as_tensor(col).to(torch.int64))

    def to_mask(self) -> torch.Tensor:
        return self.bitset.to_mask().reshape(self.rows, self.cols)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit word (SWAR), as int32. ``x`` holds the
    words in any integer dtype (the bitset's int32 bit patterns, or
    uint32 values); only the low 32 bits count. The arithmetic runs on
    int64 masked to 32 bits, since PyTorch lacks uint32 shifts on some
    builds."""
    x = torch.as_tensor(x).to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (((x * 0x01010101) & 0xFFFFFFFF) >> 24).to(torch.int32)
