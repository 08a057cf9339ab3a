"""Random distributions and sampling (``raft_tpu.random.rng``
counterpart; reference ``random/rng.cuh``, ``random/rng_state.hpp:30-52``).

The reference's ``RngState`` becomes a ``torch.Generator``: ``as_key``
takes an int seed (a new generator on ``device``, default ``cuda``), a
generator (used as it is, so successive draws advance it) or ``None`` (the
``Resources`` handle's generator). Draws land on the generator's device.
Their bits differ from the JAX package's Threefry draws by design; each
distribution is the same one (held by its moments and a two-sample KS test).
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from raft_tpu_torch.core.errors import expects
from raft_tpu_torch.core.resources import Resources, ensure_resources

KeyLike = Union[torch.Generator, int]


def as_key(key: Optional[KeyLike], res: Optional[Resources] = None, device=None) -> torch.Generator:
    """An int seed, a generator or ``None`` (the handle's generator) as a
    ``torch.Generator`` (the ``RngState(seed)`` analog)."""
    if key is None:
        return ensure_resources(res, device).generator
    if isinstance(key, torch.Generator):
        return key
    expects(isinstance(key, (int, np.integer)), "a key is an int seed, a torch.Generator or None")
    g = torch.Generator(device=ensure_resources(res, device).device)
    g.manual_seed(int(key))
    return g


def _shape(shape) -> tuple:
    return tuple(int(s) for s in np.atleast_1d(shape)) if np.ndim(shape) else (int(shape),)


# -- distributions (rng.cuh surface) ---------------------------------------


def uniform(key: KeyLike, shape, low=0.0, high=1.0, dtype=torch.float32, device=None):
    """``uniform`` / ``uniformInt`` (``random/rng.cuh``) on ``[low, high)``.
    Integer dtypes need explicit integer bounds."""
    g = as_key(key, device=device)
    if not dtype.is_floating_point:
        expects(
            int(high) > int(low) + 1 or (low, high) != (0.0, 1.0),
            "integer uniform requires explicit integer bounds, got [%s, %s)",
            low,
            high,
        )
        return torch.randint(int(low), int(high), _shape(shape), generator=g, device=g.device,
                             dtype=dtype)
    u = torch.rand(_shape(shape), generator=g, device=g.device, dtype=dtype)
    return low + (high - low) * u


def normal(key: KeyLike, shape, mu=0.0, sigma=1.0, dtype=torch.float32, device=None):
    """``normal`` (``random/rng.cuh``)."""
    g = as_key(key, device=device)
    return mu + sigma * torch.randn(_shape(shape), generator=g, device=g.device, dtype=dtype)


def lognormal(key: KeyLike, shape, mu=0.0, sigma=1.0, dtype=torch.float32, device=None):
    return torch.exp(normal(key, shape, mu, sigma, dtype, device))


def _open_unit(key, shape, dtype, device):
    """Uniform on ``(0, 1)``: ``[0, 1)`` with 0 moved to the smallest
    normal float."""
    g = as_key(key, device=device)
    u = torch.rand(_shape(shape), generator=g, device=g.device, dtype=dtype)
    return torch.clamp(u, min=torch.finfo(dtype).tiny)


def gumbel(key: KeyLike, shape, mu=0.0, beta=1.0, dtype=torch.float32, device=None):
    return mu - beta * torch.log(-torch.log(_open_unit(key, shape, dtype, device)))


def exponential(key: KeyLike, shape, lam=1.0, dtype=torch.float32, device=None):
    return -torch.log(_open_unit(key, shape, dtype, device)) / lam


def laplace(key: KeyLike, shape, mu=0.0, scale=1.0, dtype=torch.float32, device=None):
    u = _open_unit(key, shape, dtype, device)  # (0, 1) -> (-1, 1) with mass at neither end
    v = 2.0 * u - 1.0
    return mu - scale * torch.sign(v) * torch.log1p(-torch.abs(v))


def rayleigh(key: KeyLike, shape, sigma=1.0, dtype=torch.float32, device=None):
    g = as_key(key, device=device)
    u = 1e-12 + (1.0 - 1e-12) * torch.rand(_shape(shape), generator=g, device=g.device, dtype=dtype)
    return sigma * torch.sqrt(-2.0 * torch.log(u))


def bernoulli(key: KeyLike, shape, prob=0.5, device=None):
    g = as_key(key, device=device)
    return torch.rand(_shape(shape), generator=g, device=g.device) < prob


# -- sampling utilities -----------------------------------------------------


def permute(key: KeyLike, n_or_array, axis: int = 0, device=None):
    """Random permutation (``random/permute.cuh``): of ``arange(n)`` for an
    int, else the tensor shuffled along ``axis`` (on its own device)."""
    if isinstance(n_or_array, (int, np.integer)):
        g = as_key(key, device=device)
        return torch.randperm(int(n_or_array), generator=g, device=g.device)
    x = torch.as_tensor(n_or_array)
    g = as_key(key, device=x.device if device is None else device)
    perm = torch.randperm(x.shape[axis], generator=g, device=g.device).to(x.device)
    return torch.index_select(x, axis, perm)


def sample_without_replacement(key: KeyLike, n_population: int, n_samples: int,
                               weights=None, device=None) -> torch.Tensor:
    """Uniform (or weighted) sampling without replacement
    (``random/sample_without_replacement.cuh``): int32 indices. Weighted
    draws take the top ``n_samples`` of ``log(w) + Gumbel`` (exact)."""
    expects(n_samples <= n_population, "cannot sample %d from %d", n_samples, n_population)
    if weights is None:
        g = as_key(key, device=device)
        return torch.randperm(n_population, generator=g, device=g.device)[:n_samples].to(torch.int32)
    w = torch.as_tensor(weights).to(torch.float32)
    g = as_key(key, device=w.device if device is None else device)
    scores = torch.log(torch.clamp(w.to(g.device), min=1e-30)) + gumbel(g, (n_population,))
    return torch.topk(scores, n_samples).indices.to(torch.int32)


def excess_subsample(key: KeyLike, n_population: int, n_samples: int, device=None) -> torch.Tensor:
    """IVF-PQ's trainset subsample (``rng_impl.cuh`` ``excess_subsample``):
    a permutation prefix."""
    return sample_without_replacement(key, n_population, n_samples, device=device)
