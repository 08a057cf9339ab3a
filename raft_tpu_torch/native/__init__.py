"""Host-side C components, compiled at first use and bound through
``ctypes`` (``raft_tpu.native`` counterpart). Importing the package builds
nothing; a source that cannot be built raises ``KernelFailure``."""
from raft_tpu_torch.native.build import load_native  # noqa: F401
