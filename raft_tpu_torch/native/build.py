"""Compiles the host-side C components of ``raft_tpu_torch/native`` and
loads them with ``ctypes`` (``raft_tpu.native.build`` counterpart).

One ``cc -O3 -shared -fPIC`` a source, at its first use, into
``raft_tpu_torch/_build/lib<name>_<digest>.so`` (gitignored, beside the CUDA
kernels' libraries), keyed by the source's digest, so an edited source gets
a new library. The compile is retried once (``op="native.compile"``) for
transient toolchain failures. Where JAX returns ``None`` and falls back to
numpy, the port raises :class:`~raft_tpu_torch.core.errors.KernelFailure`:
no compiler, a failed compile or a library that does not load.

The lock ``native.build`` covers the loaded-library cache only, never the
compile (its retry loop records obs metrics and blocks for seconds). Two
threads on a cold cache may both compile; each writes a pid-suffixed file
and ``os.replace`` s it into place, so the copies are identical and the first
to publish wins the cache slot.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sysconfig
import threading
from typing import Optional

from raft_tpu_torch.core.errors import KernelFailure
from raft_tpu_torch.ops.cuda_build import BUILD_DIR
from raft_tpu_torch.ops.guard import kernel_guard
from raft_tpu_torch.robust.retry import RetryError, RetryPolicy, retry_call
from raft_tpu_torch.utils import lockcheck

_SRC_DIR = os.path.dirname(os.path.abspath(__file__))
_LOCK = lockcheck.tracked(threading.Lock(), "native.build")
_LOADED: dict = {}

#: file-system and toolchain hiccups are transient; keep the budget small
_COMPILE_RETRY = RetryPolicy(
    max_attempts=2, base_delay_s=0.2,
    retryable=(subprocess.SubprocessError, OSError),
)


def compiler() -> Optional[str]:
    """The C compiler command: ``$CC``, Python's own ``CC``, then ``cc``,
    ``gcc`` or ``clang`` on the path; None when there is none."""
    for cand in (os.environ.get("CC"), sysconfig.get_config_var("CC"), "cc", "gcc", "clang"):
        if cand and shutil.which(cand.split()[0]):
            return cand
    return None


def load_native(name: str) -> ctypes.CDLL:
    """Compile (once a content) and load ``raft_tpu_torch/native/<name>.c``;
    raises :class:`KernelFailure` when that fails."""
    with _LOCK:
        if name in _LOADED:
            return _LOADED[name]
    lib = _build_and_load(name)
    with _LOCK:
        return _LOADED.setdefault(name, lib)


def _build_and_load(name: str) -> ctypes.CDLL:
    src = os.path.join(_SRC_DIR, f"{name}.c")
    with kernel_guard(f"native build {name}"):
        with open(src, "rb") as f:
            code = f.read()
        out = os.path.join(BUILD_DIR, f"lib{name}_{hashlib.sha256(code).hexdigest()[:16]}.so")
        if not os.path.exists(out):
            cc = compiler()
            if cc is None:
                raise KernelFailure(f"native build {name}: no C compiler ($CC, cc, gcc, clang)")
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{out}.tmp{os.getpid()}"
            cmd = cc.split() + ["-O3", "-shared", "-fPIC", "-o", tmp, src]

            def _compile():
                subprocess.run(cmd, check=True, capture_output=True, timeout=120)
                os.replace(tmp, out)

            try:
                retry_call(_compile, policy=_COMPILE_RETRY, op="native.compile")
            except RetryError as e:
                detail = getattr(e.last, "stderr", b"") or b""
                raise KernelFailure(f"native build {name}: {e.last!r} "
                                    f"{detail.decode(errors='replace')[-2000:]}") from e
        return ctypes.CDLL(out)
