"""Matrix operations: gather and scatter, slices, row and column ops;
``select_k`` and ``merge_parts`` from :mod:`raft_tpu_torch.ops.select_k`.

Exports the JAX package's ``raft_tpu.matrix.__all__``."""
from raft_tpu_torch.matrix.ops import (
    argmax,
    argmin,
    col_wise_sort,
    diagonal,
    gather,
    gather_if,
    linewise_op,
    matrix_slice,
    reverse,
    sample_rows,
    scatter,
    sign_flip,
    threshold,
    triangular_upper,
)
from raft_tpu_torch.ops.select_k import merge_parts, select_k

__all__ = [
    "argmax",
    "argmin",
    "col_wise_sort",
    "diagonal",
    "gather",
    "gather_if",
    "linewise_op",
    "matrix_slice",
    "merge_parts",
    "reverse",
    "sample_rows",
    "scatter",
    "select_k",
    "sign_flip",
    "threshold",
    "triangular_upper",
]
