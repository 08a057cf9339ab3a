"""Builds the hand-written CUDA kernels of ``raft_tpu_torch/csrc`` and loads
them with ``ctypes``.

Each source is compiled on its own by ``nvcc -gencode
arch=compute_90a,code=sm_90a`` into a shared library with a plain C
interface, ``raft_tpu_torch/_build/lib<name>_<digest>.so``, at its first
use. The digest covers the source and every ``csrc/*.cuh`` it may
include, so an edited kernel gets a new library. Different sources build
in parallel (one lock per source, held across threads); a source
already loaded in this process is returned at once. A build or load that
fails raises :class:`~raft_tpu_torch.core.errors.KernelFailure`
(:mod:`raft_tpu_torch.ops.guard`).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Sequence, Tuple

from raft_tpu_torch.core.errors import KernelFailure
from raft_tpu_torch.ops.guard import kernel_guard

_PKG = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)
CSRC_DIR = os.path.normpath(os.path.join(_PKG, "csrc"))
BUILD_DIR = os.path.normpath(os.path.join(_PKG, "_build"))

_locks_guard = threading.Lock()
_locks: Dict[str, threading.Lock] = {}
_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise KernelFailure("nvcc not found: the CUDA toolkit is needed to build the kernels")
    return path


def _digest(src: str) -> str:
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for path in [src] + [os.path.join(CSRC_DIR, f) for f in headers]:
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def build_library(
    source: str,
    signatures: Dict[str, Sequence],
    verbose: bool = False,
) -> Tuple[ctypes.CDLL, float, str]:
    """Compile ``csrc/<source>`` (once per content) and load it.

    ``signatures`` maps each exported C function to its ctypes argument
    types; every one returns an ``int`` (a ``cudaError_t``).
    ``verbose`` adds ``-Xptxas=-v`` (registers, shared memory and spills
    per kernel). Returns ``(library, build seconds, compiler output)``;
    the seconds are 0 and the output empty when the library was already
    loaded."""
    with _locks_guard:
        lock = _locks.setdefault(source, threading.Lock())
    with lock:
        if source in _loaded:
            return _loaded[source], 0.0, ""
        src = os.path.join(CSRC_DIR, source)
        stem = os.path.splitext(source)[0]
        os.makedirs(BUILD_DIR, exist_ok=True)
        so = os.path.join(BUILD_DIR, f"lib{stem}_{_digest(src)}.so")
        t0 = time.perf_counter()
        log = ""
        with kernel_guard(f"build {source}"):
            if not os.path.exists(so):
                tmp = f"{so}.tmp{os.getpid()}"
                cmd = [
                    _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-o", tmp, src,
                ]
                if verbose:
                    cmd.insert(1, "-Xptxas=-v")
                proc = subprocess.run(cmd, capture_output=True, text=True)
                log = proc.stdout + proc.stderr
                if proc.returncode != 0:
                    raise KernelFailure(f"nvcc failed to build {source}:\n{log}")
                os.replace(tmp, so)
            lib = ctypes.CDLL(so)
            for name, argtypes in signatures.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
        _loaded[source] = lib
        return lib, time.perf_counter() - t0, log
