"""Seeded data, made on the device.

:class:`Clustered` draws vectors of a low intrinsic dimension: blobs on a
latent subspace of R^d plus small isotropic noise. Its parameters are
assumed, not fitted to a published dataset (each configuration lists them
under ``assumed``); how a cell's numbers move with ``latent`` is recorded
beside the cell's readings. Every draw comes from a ``torch.Generator``
on the device, in a few large calls.
"""
from __future__ import annotations

import hashlib
import math

import torch

#: rows drawn a call
CHUNK = 1 << 21


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for the stream ``tag`` of run seed ``seed`` (any
    integer, however large)."""
    h = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(h[:8], "little") & ((1 << 63) - 1)


def generator(seed: int, tag: str, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, tag))
    return g


class Clustered:
    """``n_clusters`` Gaussian blobs (centres ``center_scale * N(0, I)``,
    unit spread) on a ``latent``-dimensional subspace, mapped to R^dim by a
    random ``[latent, dim]`` basis scaled by ``1/sqrt(latent)``, plus
    ``noise * N(0, I)`` in every dimension."""

    def __init__(self, seed: int, *, dim: int, n_clusters: int, latent: int,
                 center_scale: float, noise: float, device):
        g = generator(seed, "clustered.shape", device)
        self.device = torch.device(device)
        self.basis = torch.randn((latent, dim), generator=g, device=device) / math.sqrt(latent)
        self.centers = center_scale * torch.randn((n_clusters, latent), generator=g,
                                                  device=device)
        self.noise = float(noise)

    def sample(self, n: int, seed: int, tag: str) -> torch.Tensor:
        """``[n, dim]`` float32 rows of stream ``tag``."""
        g = generator(seed, tag, self.device)
        latent, dim = self.basis.shape
        out = torch.empty((n, dim), dtype=torch.float32, device=self.device)
        for s in range(0, n, CHUNK):
            m = min(CHUNK, n - s)
            lab = torch.randint(0, self.centers.shape[0], (m,), generator=g, device=self.device)
            z = self.centers[lab] + torch.randn((m, latent), generator=g, device=self.device)
            torch.matmul(z, self.basis, out=out[s : s + m])
            out[s : s + m] += self.noise * torch.randn((m, dim), generator=g, device=self.device)
        return out


def make(config: dict, seed: int, device, n_rows: int, n_queries: int):
    """The rows and queries of ``config["data"]`` for ``seed``."""
    spec = config["data"]
    gen = Clustered(seed, dim=config["dim"], n_clusters=spec["n_clusters"],
                    latent=spec["latent"], center_scale=spec["center_scale"],
                    noise=spec["noise"], device=device)
    return gen.sample(n_rows, seed, "rows"), gen.sample(n_queries, seed, "queries")
