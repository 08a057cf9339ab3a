"""``raft_tpu_torch.parallel.bootstrap`` against ``raft_tpu.parallel.bootstrap``.

In this process: the single-process path, the ``bootstrap.init`` fault
point under JAX's retry cases (``tests/test_robust.py:373-405``) beside
JAX's own behaviour on the same injected faults, the rendezvous URL, the
mesh sizes and the comms self test on CPU meshes, and that every fault
point the port declares is fired by some call site. Anything that
initialises ``torch.distributed`` runs in a ``python -c`` child (the port
and torch only), bounded by :data:`CHILD_S`: a world of 1 under gloo, the
launcher's group, ``backend="nccl"`` without a card, and a world of 2
whose second process never arrives.
"""
import ast
import os
import subprocess
import sys

import jax
import pytest
import torch

from raft_tpu.parallel import bootstrap as jboot
from raft_tpu.parallel import make_mesh as jmake_mesh
from raft_tpu.robust import RetryError as JRetryError
from raft_tpu.robust import RetryPolicy as JRetryPolicy
from raft_tpu.robust import faults as jfaults
from raft_tpu_torch.parallel import bootstrap, make_mesh
from raft_tpu_torch.robust import faults
from raft_tpu_torch.robust.retry import RetryError, RetryPolicy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD_S = 90
RETRYABLE = (ConnectionError, TimeoutError, OSError, RuntimeError)


def _run_child(code: str, *args: str) -> str:
    """Run ``code`` in a fresh interpreter (the port importable); returns
    its output, failing on a non-zero exit."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    env.pop("MASTER_ADDR", None)
    env.pop("WORLD_SIZE", None)
    p = subprocess.run([sys.executable, "-c", code, *args], cwd=REPO, env=env, timeout=CHILD_S,
                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    text = p.stdout.decode(errors="replace")
    assert p.returncode == 0, text[-4000:]
    return text


# -- one process -----------------------------------------------------------------------


def test_the_single_process_path_returns_false_as_jax_s():
    assert bootstrap.init_distributed() is False
    assert jboot.init_distributed() is False


def test_init_faults_are_retried_as_jax_retries_them():
    for pkg_faults, pkg_boot, policy_cls in ((faults, bootstrap, RetryPolicy),
                                             (jfaults, jboot, JRetryPolicy)):
        policy = policy_cls(max_attempts=4, base_delay_s=0.001, max_delay_s=0.002,
                            retryable=RETRYABLE)
        with pkg_faults.injected("bootstrap.init", ConnectionError("coordinator down"),
                                 trigger="first_n", first_n=2) as spec:
            assert pkg_boot.init_distributed(retry_policy=policy) is False
        assert spec.fired == 2


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_no_policy_fails_fast(pkg):
    pkg_faults, pkg_boot = (faults, bootstrap) if pkg == "port" else (jfaults, jboot)
    with pkg_faults.injected("bootstrap.init", ConnectionError("coordinator down")) as spec:
        with pytest.raises(ConnectionError):
            pkg_boot.init_distributed(retry_policy=None)
    assert spec.fired == 1


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_exhausted_retries_surface_as_retry_error(pkg):
    if pkg == "port":
        policy = RetryPolicy(max_attempts=2, base_delay_s=0.001, retryable=(ConnectionError,))
        ctx, boot, err = faults.injected, bootstrap, RetryError
    else:
        policy = JRetryPolicy(max_attempts=2, base_delay_s=0.001, retryable=(ConnectionError,))
        ctx, boot, err = jfaults.injected, jboot, JRetryError
    with ctx("bootstrap.init", ConnectionError("still down")) as spec:
        with pytest.raises(err):
            boot.init_distributed(retry_policy=policy)
    assert spec.fired == 2


def test_the_seam_fires_with_jax_s_coordinator_key():
    """The fault point sees the address it was asked to reach, as JAX's does
    (it fires before any connection is tried)."""
    for pkg_faults, pkg_boot in ((faults, bootstrap), (jfaults, jboot)):
        with pkg_faults.injected("bootstrap.init", ConnectionError("no route"),
                                 match={"coordinator": "10.0.0.1:1234"}) as spec:
            with pytest.raises(ConnectionError):
                pkg_boot.init_distributed("10.0.0.1:1234", 2, 0, retry_policy=None,
                                          **({"backend": "gloo"} if pkg_boot is bootstrap else {}))
        assert spec.fired == 1


def test_every_declared_fault_point_is_fired_by_a_call_site():
    """No fault point of the port is declared but inert: each name in
    ``FAULT_POINTS`` is the first argument of some ``faults.fire`` call in
    the package."""
    fired = set()
    root = os.path.join(REPO, "raft_tpu_torch")
    for dirpath, _, files in os.walk(root):
        for name in files:
            if not name.endswith(".py"):
                continue
            with open(os.path.join(dirpath, name)) as f:
                tree = ast.parse(f.read())
            for node in ast.walk(tree):
                if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                        and node.func.attr == "fire" and isinstance(node.func.value, ast.Name)
                        and node.func.value.id == "faults" and node.args
                        and isinstance(node.args[0], ast.Constant)):
                    fired.add(node.args[0].value)
    assert sorted(set(faults.FAULT_POINTS) - fired) == []


@pytest.mark.parametrize("address,want", [
    ("host0:1234", "tcp://host0:1234"),
    ("tcp://10.0.0.2:29500", "tcp://10.0.0.2:29500"),
    ("file:///tmp/store", "file:///tmp/store"),
])
def test_the_rendezvous_url(address, want):
    assert bootstrap._init_method(address) == want


def test_no_address_takes_the_launcher_s_environment(monkeypatch):
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert bootstrap._init_method(None) is None
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    assert bootstrap._init_method(None) is None
    monkeypatch.setenv("WORLD_SIZE", "2")
    assert bootstrap._init_method(None) == "env://"


def test_an_unknown_backend_raises():
    from raft_tpu_torch.core.errors import LogicError

    with pytest.raises(LogicError, match="backend"):
        bootstrap.init_distributed("h:1", 2, 0, backend="mpi")


def test_global_and_local_mesh_sizes():
    """With no group: the single-controller mesh over this process's
    devices (the CPU here), as JAX's are over its local devices."""
    g, loc = bootstrap.global_mesh(), bootstrap.local_mesh()
    assert not g.is_process and not loc.is_process
    assert g.size == loc.size == len(bootstrap.local_devices()) == 1
    g8 = bootstrap.global_mesh(devices=["cpu"] * 8)
    assert g8.size == jboot.global_mesh().devices.size == 8
    assert jboot.local_mesh().devices.size == len(jax.local_devices())
    g2 = bootstrap.global_mesh(("x", "y"), shape=(2, 4), devices=["cpu"] * 8)
    assert g2.shape == {"x": 2, "y": 4}


@pytest.mark.parametrize("backend", ["gloo", "nccl"])
@pytest.mark.parametrize("cards,local_rank,want", [(2, None, "cuda:1"), (2, "0", "cuda:0"),
                                                   (4, None, "cuda:3"), (0, None, "cpu")])
def test_a_process_in_a_group_defaults_to_its_card(monkeypatch, backend, cards, local_rank, want):
    """In a group a process holds its card under either backend (the
    launcher's ``LOCAL_RANK``, else its rank, modulo the visible cards), so
    a gloo process's default mesh sits on the card; the CPU only under gloo
    with no card visible, and NCCL without one raises."""
    from raft_tpu_torch.core.errors import LogicError

    monkeypatch.setattr(torch.cuda, "is_available", lambda: cards > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(bootstrap.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(bootstrap.dist, "get_backend", lambda *a: backend)
    monkeypatch.setattr(bootstrap.dist, "get_rank", lambda *a: 3)
    if local_rank is None:
        monkeypatch.delenv("LOCAL_RANK", raising=False)
    else:
        monkeypatch.setenv("LOCAL_RANK", local_rank)
    if backend == "nccl" and cards == 0:
        with pytest.raises(LogicError, match="visible card"):
            bootstrap.local_devices()
        return
    assert bootstrap.local_devices() == [torch.device(want)]


def test_the_self_test_passes_on_eight_cpu_shards_as_jax_s_on_eight_devices():
    assert bootstrap.run_comms_self_test(make_mesh(["cpu"] * 8)) is True
    assert jboot.run_comms_self_test(jmake_mesh(jax.devices()[:8])) is True


@pytest.mark.parametrize("axis", ["x", "y"])
def test_the_self_test_along_each_axis_of_a_2x4_mesh(axis):
    mesh = make_mesh(["cpu"] * 8, shape=(2, 4), axis_names=("x", "y"))
    assert bootstrap.run_comms_self_test(mesh, axis=axis) is True
    jm = jmake_mesh(jax.devices()[:8], shape=(2, 4), axis_names=("x", "y"))
    assert jboot.run_comms_self_test(jm, axis=axis) is True


def test_the_self_test_needs_an_axis_on_a_mesh_of_several():
    from raft_tpu_torch.core.errors import LogicError

    with pytest.raises(LogicError, match="several axes"):
        bootstrap.run_comms_self_test(make_mesh(["cpu"] * 4, shape=(2, 2),
                                                axis_names=("x", "y")))


# -- children that initialise torch.distributed ----------------------------------------------


WORLD_OF_ONE = r'''
import sys
from raft_tpu_torch.parallel import bootstrap
from raft_tpu_torch.robust import faults

store = sys.argv[1]
assert bootstrap.init_distributed("file://" + store, 1, 0, backend="gloo", timeout_s=30) is True
with faults.injected("bootstrap.init", ConnectionError("x")) as spec:
    assert bootstrap.init_distributed() is True      # called again: no new attempt
assert spec.fired == 0
mesh = bootstrap.global_mesh()
assert mesh.is_process and mesh.size == 1 and mesh.local_ranks == (0,), mesh
assert bootstrap.run_comms_self_test(mesh) is True
assert bootstrap.local_mesh().size == 1
bootstrap.shutdown()
import torch.distributed as dist
assert not dist.is_initialized()
print("ok")
'''


def test_a_world_of_one_under_gloo(tmp_path):
    assert "ok" in _run_child(WORLD_OF_ONE, str(tmp_path / "store"))


LAUNCHER = r'''
import sys, datetime
import torch.distributed as dist
from raft_tpu_torch.parallel import bootstrap
from raft_tpu_torch.robust import faults

dist.init_process_group("gloo", init_method="file://" + sys.argv[1], world_size=1, rank=0,
                        timeout=datetime.timedelta(seconds=30))
with faults.injected("bootstrap.init", ConnectionError("x"), trigger="first_n", first_n=1) as spec:
    # the launcher's group is success: the attempt after the injected one returns True
    assert bootstrap.init_distributed(retry_policy=bootstrap.DEFAULT_INIT_RETRY) is True
assert spec.fired == 1
assert bootstrap.init_distributed() is True
assert bootstrap.global_mesh().is_process
bootstrap.shutdown()
print("ok")
'''


def test_the_launcher_s_group_counts_as_initialised(tmp_path):
    assert "ok" in _run_child(LAUNCHER, str(tmp_path / "store"))


NCCL_WITHOUT_CARD = r'''
import sys
import torch, torch.distributed as dist
from raft_tpu_torch.core.errors import LogicError
from raft_tpu_torch.parallel import bootstrap

assert not torch.cuda.is_available()
try:
    bootstrap.init_distributed("file://" + sys.argv[1], 1, 0, backend="nccl", timeout_s=10)
except LogicError as e:
    assert "nccl" in str(e)
else:
    raise AssertionError("nccl without a card did not raise")
assert not dist.is_initialized()          # no fallback to gloo
print("ok")
'''


def test_nccl_without_a_card_raises_and_never_falls_back(tmp_path):
    assert "ok" in _run_child(NCCL_WITHOUT_CARD, str(tmp_path / "store"))


MISSING_PEER = r'''
import sys, time
import torch.distributed as dist
from raft_tpu_torch.parallel import bootstrap

address, timeout = sys.argv[1], float(sys.argv[2])
t0 = time.monotonic()
try:
    bootstrap.init_distributed(address, 2, 0, backend="gloo", timeout_s=timeout)
except RuntimeError as e:
    took = time.monotonic() - t0
    assert took < timeout + 5, took
    print("raised", type(e).__name__, round(took, 2))
else:
    raise AssertionError("a world of 2 with one process started did not raise")
assert not dist.is_initialized()
'''


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("scheme", ["file", "tcp"])
def test_a_peer_that_never_arrives_raises_within_the_timeout(tmp_path, scheme):
    address = (f"file://{tmp_path / 'store'}" if scheme == "file" else
               f"127.0.0.1:{_free_port()}")
    assert "raised" in _run_child(MISSING_PEER, address, "3")
