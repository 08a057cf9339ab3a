"""Execution context (``raft_tpu.core.resources`` counterpart).

``Resources`` carries what the reference's ``raft::resources`` handle
carries that PyTorch does not already own: the device new tensors go to,
the stream kernels launch on, and an explicit ``torch.Generator``.

``device=None`` means ``torch.device("cuda")``. Without a card that
raises: the port never quietly runs on the CPU. Tests pass
``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, Optional, Union

import torch

from raft_tpu_torch.core.errors import LogicError
from raft_tpu_torch.utils import lockcheck


def resolve_device(device: Union[None, str, torch.device]) -> torch.device:
    """``None`` -> ``cuda``; a CUDA device must exist."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise LogicError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU"
        )
    return dev


@dataclasses.dataclass
class Resources:
    """Per-call execution context.

    ``device``: where new tensors are placed (default ``cuda``).
    ``seed``: seeds the resource-owned ``torch.Generator``.
    ``workspace_bytes``: byte budget batching heuristics may assume for
    temporaries (1 GiB, as in the JAX package).
    ``mesh``: the :class:`raft_tpu_torch.parallel.Mesh` that
    :func:`raft_tpu_torch.parallel.init_comms` installs, read back through
    :meth:`get_mesh` (``resource::get_comms``).

    Named resources (:meth:`set_resource`, :meth:`get_resource`) live in a
    per-handle registry under the handle's lock (``core.resources``).
    """

    device: Union[None, str, torch.device] = None
    seed: int = 0
    workspace_bytes: int = 1 << 30
    mesh: Optional[object] = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(self.seed)
        self._lock = lockcheck.tracked(threading.Lock(), "core.resources")
        self._registry: dict = {}

    @property
    def stream(self):
        """The stream kernels launch on (None on the CPU)."""
        if self.device.type != "cuda":
            return None
        return torch.cuda.current_stream(self.device)

    def get_mesh(self):
        """The installed mesh; raises when none is set."""
        if self.mesh is None:
            raise LogicError(
                "no mesh set on Resources; call raft_tpu_torch.parallel.init_comms() or pass "
                "mesh= explicitly"
            )
        return self.mesh

    def has_mesh(self) -> bool:
        return self.mesh is not None

    def set_resource(self, name: str, value: Any) -> None:
        with self._lock:
            self._registry[name] = value

    def get_resource(self, name: str, factory=None) -> Any:
        """The named resource, made once by ``factory`` when missing;
        ``KeyError`` when it is missing and there is no factory."""
        with self._lock:
            if name not in self._registry:
                if factory is None:
                    raise KeyError(name)
                self._registry[name] = factory()
            return self._registry[name]

    def sync(self) -> None:
        """Block until all queued work on this device is complete."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


_default_resources: Optional[Resources] = None
_default_lock = lockcheck.tracked(threading.Lock(), "core.resources_default")


def default_resources() -> Resources:
    """Process-global default handle on ``cuda`` (lazy)."""
    global _default_resources
    with _default_lock:
        if _default_resources is None:
            _default_resources = Resources()
        return _default_resources


def ensure_resources(res: Optional[Resources] = None, device=None) -> Resources:
    """``res`` if given; else a handle on ``device`` if given; else the
    process default (``cuda``)."""
    if res is not None:
        return res
    if device is not None:
        return Resources(device=device)
    return default_resources()
