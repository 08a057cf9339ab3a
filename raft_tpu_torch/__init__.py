"""raft_tpu_torch — the PyTorch/CUDA port of raft_tpu for one NVIDIA H100.

The package mirrors ``raft_tpu``'s layout module for module and never
imports JAX or ``raft_tpu``. Entry points run on ``cuda`` unless given
``device="cpu"`` (or a CPU ``Resources``). Hand kernels live in ``csrc/``
and are built with nvcc at first use; their plain PyTorch versions sit
beside them and run for CPU tensors.

Float32 matmuls (the coarse ``q @ centers.T``, the plain versions) must be
full f32 to match the JAX package's ``HIGHEST`` precision, so TF32 is
turned off here for both cuBLAS and cuDNN.
"""
import torch as _torch

_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

from raft_tpu_torch.core import Resources, default_resources  # noqa: E402

__all__ = ["Resources", "default_resources", "__version__"]
