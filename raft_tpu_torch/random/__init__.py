"""Random: distributions from a ``torch.Generator``, sampling,
``make_blobs``, ``make_regression`` and R-MAT graphs.

Exports the JAX package's ``raft_tpu.random.__all__``."""
from raft_tpu_torch.random.make_blobs import make_blobs
from raft_tpu_torch.random.make_regression import make_regression, multi_variable_gaussian
from raft_tpu_torch.random.rmat import rmat
from raft_tpu_torch.random.rng import (
    as_key,
    bernoulli,
    excess_subsample,
    exponential,
    gumbel,
    laplace,
    lognormal,
    normal,
    permute,
    rayleigh,
    sample_without_replacement,
    uniform,
)

__all__ = [
    "make_blobs",
    "make_regression",
    "multi_variable_gaussian",
    "rmat",
    "as_key",
    "bernoulli",
    "excess_subsample",
    "exponential",
    "gumbel",
    "laplace",
    "lognormal",
    "normal",
    "permute",
    "rayleigh",
    "sample_without_replacement",
    "uniform",
]
