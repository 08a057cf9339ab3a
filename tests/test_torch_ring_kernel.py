"""The one-launch ring (B6/B7 on one card) on the CPU: its plain mirror
``ring_kernel_reference`` and its host-side plan, against raft_tpu.

``ring_onecard`` runs only on a card; ``chip_smoke.py`` holds it against
the mirror there. Here the mirror (per row group and rank: staging, the
reduce-scatter through receive slots and flags, the kernel's rank-count
fold, the all-gather straight into ``[nq, k]``) is held bit for bit against
JAX's XLA ring engine ``_ring_topk_xla`` (inside this file's own
``shard_map`` on the 8 virtual CPU devices) and against the port's gather
merge. Inputs come from a numpy seed. The grid sizing, the epoch wrap and
the engine chosen by a mesh's layout are pure functions, tested without a
card.
"""
import functools
import re
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from raft_tpu.ops.pallas import ring_topk as jrt
from raft_tpu.parallel import make_mesh as jmake_mesh
from raft_tpu.parallel._compat import shard_map
from raft_tpu_torch.core.errors import RaftError
from raft_tpu_torch.ops import ring_topk as trt
from raft_tpu_torch.parallel import make_mesh

K = 10
CU = Path(trt.__file__).resolve().parent.parent / "csrc" / "ring_topk.cu"


def bits(x) -> np.ndarray:
    a = np.ascontiguousarray(np.asarray(x))
    return a.view(np.int32) if a.dtype == np.float32 else a


def assert_bits_equal(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(bits(x), bits(y))


def candidates(rng, n, nq, kc, select_min, *, demote=(), nan=False):
    """Per-shard tiles ``[n, nq, kc]``, unsorted: integer values (ties
    across shards), ``±inf`` and signed zeros with real ids, NaN of both
    signs with ``nan``, worst-value/-1 tiles for the ``demote``d shards."""
    v = rng.integers(-4, 5, (n, nq, kc)).astype(np.float32)
    v[rng.random(v.shape) < 0.05] = np.inf
    v[rng.random(v.shape) < 0.05] = -np.inf
    v[rng.random(v.shape) < 0.1] = np.float32(-0.0)
    if nan:
        m = rng.random(v.shape) < 0.1
        v[m] = np.where(rng.random(m.sum()) < 0.5, np.float32(np.nan), -np.float32(np.nan))
    i = rng.integers(0, 1 << 30, (n, nq, kc)).astype(np.int32)
    for s in demote:
        v[s] = np.inf if select_min else -np.inf
        i[s] = -1
    return v, i


def port_parts(vs, ins):
    return ([torch.from_numpy(np.ascontiguousarray(x)) for x in vs],
            [torch.from_numpy(np.ascontiguousarray(x)) for x in ins])


def jax_ring(n, vs, ins, k, select_min):
    """The JAX package's XLA ring engine inside this file's own shard_map."""
    mesh = jmake_mesh(jax.devices()[:n])

    @functools.partial(shard_map, mesh=mesh, in_specs=(P("data"), P("data")),
                       out_specs=(P(), P()))
    def prog(vb, ib):
        return jrt.ring_topk(vb[0], ib[0], k, select_min=select_min, axis="data", use_fused=False)

    return jax.jit(prog)(jnp.asarray(vs), jnp.asarray(ins))


# -- the mirror against the XLA engine and the gather merge -------------------------


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("nq", [1, 37, 128])
@pytest.mark.parametrize("kc", [6, 10, 23, 83])
@pytest.mark.parametrize("select_min", [True, False])
def test_mirror_matches_xla_engine_and_gather(eight_devices, n, nq, kc, select_min):
    """Row groups of 3 rows (B = 1, 10, 43, ... rows a block: the last
    group short), one shard demoted, ``±inf`` and ``-0``; unsorted tiles
    narrower than, equal to and wider than k (B7's scan fold)."""
    rng = np.random.default_rng(1000 * n + 10 * kc + nq + select_min)
    vs, ins = candidates(rng, n, nq, kc, select_min, demote=(n // 2,) if n > 1 else ())
    mv, mi = trt.ring_kernel_reference(*port_parts(vs, ins), K, select_min, warps=3)
    jv, ji = jax_ring(n, vs, ins, K, select_min)
    for r in range(n):  # replicated: every shard holds the same answer
        assert_bits_equal((mv[r].numpy(), mi[r].numpy()), (jv, ji))
    if n > 1 or kc > K:  # one shard's tile of at most k columns comes back as it came
        pv, pi = trt.gather_merge(make_mesh(["cpu"] * n), *port_parts(vs, ins), K, select_min)
        for r in range(n):
            assert_bits_equal((mv[r].numpy(), mi[r].numpy()), (pv[r].numpy(), pi[r].numpy()))


@pytest.mark.parametrize("n,kc", [(3, 10), (4, 23)])
@pytest.mark.parametrize("select_min", [True, False])
def test_mirror_orders_nan_as_the_xla_engine(eight_devices, n, kc, select_min):
    """Every NaN (either sign) is one key after ``+inf``, ties by position,
    as ``lax.sort`` orders them; the payloads are carried."""
    rng = np.random.default_rng(7 * n + kc + select_min)
    vs, ins = candidates(rng, n, 29, kc, select_min, nan=True)
    mv, mi = trt.ring_kernel_reference(*port_parts(vs, ins), K, select_min, warps=4)
    jv, ji = jax_ring(n, vs, ins, K, select_min)
    assert_bits_equal((mv[0].numpy(), mi[0].numpy()), (jv, ji))
    tv, ti = trt.ring_topk_reference(*port_parts(vs, ins), K, select_min, make_mesh(["cpu"] * n))
    assert_bits_equal((mv[-1].numpy(), mi[-1].numpy()), (tv[-1].numpy(), ti[-1].numpy()))


@pytest.mark.parametrize("w", [4, 10, 40])
@pytest.mark.parametrize("select_min", [True, False])
def test_rank_fold_equals_the_sort_fold(w, select_min):
    """The kernel's rank-count fold gives the plain sort fold's entries,
    in order, on ties, infinities, signed zeros, NaN and padding."""
    rng = np.random.default_rng(w + select_min)
    lanes = []
    for parity in (0, 1):
        v = rng.integers(-2, 3, (33, w)).astype(np.float32)
        v[rng.random(v.shape) < 0.1] = np.float32(-0.0)
        v[rng.random(v.shape) < 0.1] = np.nan
        v[rng.random(v.shape) < 0.1] = np.inf if select_min else -np.inf
        pos = (2 * rng.permutation(33 * w * 2)[: 33 * w] + parity).reshape(33, w).astype(np.int32)
        pad = rng.random(v.shape) < 0.1
        pos[pad] = trt._PAD_POS
        v[pad] = np.inf if select_min else -np.inf
        ids = np.where(pad, -1, pos + 5).astype(np.int32)
        lanes.append((torch.from_numpy(pos), torch.from_numpy(v), torch.from_numpy(ids)))
    got = trt._rank_fold(lanes[0], lanes[1], w, 1 if select_min else -1)
    key = lambda ln: ln[1] if select_min else -ln[1]  # noqa: E731
    ref = trt._fold(*[(key(ln), *ln) for ln in lanes], w)[1:]
    assert_bits_equal([x.numpy() for x in got], [x.numpy() for x in ref])


# -- the workspace and the epoch ------------------------------------------------------


def test_epoch_rises_and_wraps():
    assert trt.next_epoch(0) == (1, False)
    assert trt.next_epoch(41) == (42, False)
    assert trt.next_epoch(trt.EPOCH_MAX - 1) == (trt.EPOCH_MAX, False)
    assert trt.next_epoch(trt.EPOCH_MAX) == (1, True)


def test_workspace_survives_calls_and_the_epoch_wrap():
    """Calls through one workspace: the flags keep the last call's epoch
    (never reset between calls), and the call after ``EPOCH_MAX`` re-zeroes
    them and starts at epoch 1; every call's answer stays the gather's."""
    n, nq, kc = 4, 37, 13
    rng = np.random.default_rng(3)
    B = -(-nq // n)
    ws = trt.RingWorkspace(n, K, B + 2, 8, "cpu")
    ws.epoch = trt.EPOCH_MAX - 1
    mesh = make_mesh(["cpu"] * n)
    for epoch in (trt.EPOCH_MAX, 1, 2):
        vs, ins = port_parts(*candidates(rng, n, nq, kc, True, demote=(2,)))
        mv, mi = trt.ring_kernel_reference(vs, ins, K, True, warps=2, workspace=ws)
        assert ws.epoch == epoch
        G = -(-B // 2)
        assert set(ws.flags[:, :G].unique().tolist()) == {epoch}  # every flag of this call set
        assert not ws.flags[:, G:].any()  # and no other
        pv, pi = trt.gather_merge(mesh, vs, ins, K, True)
        assert_bits_equal((mv[1].numpy(), mi[1].numpy()), (pv[1].numpy(), pi[1].numpy()))


def test_workspace_must_fit_the_call():
    vs, ins = port_parts(*candidates(np.random.default_rng(5), 2, 40, 10, True))
    with pytest.raises(Exception, match="workspace"):
        trt.ring_kernel_reference(vs, ins, K, workspace=trt.RingWorkspace(2, K, 4, 1, "cpu"))


# -- the grid ----------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 4, 8, 16])
def test_grid_covers_every_row_within_the_co_resident_ctas(n):
    for warps in (1, 3, 8):
        for capacity in (n, 2 * n + 1, 132 * 8):
            for B in list(range(1, 70)) + [256, 1000, 4096]:
                G, grid_x = trt.plan_grid(B, n, warps, capacity)
                assert (G - 1) * warps < B <= G * warps  # every row, no empty group
                assert 1 <= grid_x <= G and grid_x * n <= capacity
                groups = sorted(g for x in range(grid_x) for g in range(x, G, grid_x))
                assert groups == list(range(G))  # each group once over the CTAs' loops


def test_grid_refuses_fewer_co_resident_ctas_than_ranks():
    with pytest.raises(RaftError, match="CTAs at once"):
        trt.plan_grid(10, 8, 4, 7)


def test_warps_a_cta_fit_shared_memory():
    assert trt.onecard_warps(4, 10) == trt.MAX_WARPS
    for n in (1, 4, 16):
        for w in (10, 80, 256, 900):
            warps = trt.onecard_warps(n, w)
            assert trt.onecard_smem_bytes(n, w, warps) <= trt._SMEM_LIMIT
            assert warps == trt.MAX_WARPS or trt.onecard_smem_bytes(n, w, 2 * warps) > trt._SMEM_LIMIT
    with pytest.raises(RaftError, match="shared memory"):
        trt.onecard_warps(16, 4096)


def test_kernel_limits_match_the_wrapper():
    """The constants and the shared-memory count the wrapper mirrors from
    ``csrc/ring_topk.cu`` (on the card ``_onecard_capacity`` also checks
    the count against the kernel's ``ring_onecard_smem_bytes``)."""
    src = CU.read_text()
    const = lambda name: int(re.search(rf"constexpr \w+ {name} = (\d+);", src).group(1))  # noqa: E731
    assert const("MAX_RANKS") == trt.MAX_RANKS and const("MAX_WARPS") == trt.MAX_WARPS
    assert re.search(r"constexpr size_t UNION_BYTES_PER_ENTRY = 8 \+ 4 \* 4;", src)
    assert "warps) * w * (12 * static_cast<size_t>(n) + 2 * UNION_BYTES_PER_ENTRY)" in src
    assert trt.onecard_smem_bytes(4, 10, 8) == 8 * 10 * (12 * 4 + 2 * 24)
    stages = re.search(r"enum RingStage \{([^}]*)\}", (CU.parent / "stage_clock.cuh").read_text())
    names = [re.match(r"\s*k(\w+) = (\d+)", x).groups() for x in stages.group(1).split(",")]
    assert [(nm.lower(), int(i)) for nm, i in names] == [(s, i) for i, s in enumerate(trt.STAGES)]


# -- the engine by layout ------------------------------------------------------------


def test_engine_by_device_list():
    assert trt.ring_engine(["cpu"] * 4) == "plain"
    assert trt.ring_engine(["cuda:0"] * 4) == "kernel"
    assert trt.ring_engine([torch.device("cuda", 1)] * 2) == "kernel"
    assert trt.ring_engine(["cuda:0", "cuda:1"]) == "schedule"
    assert trt.ring_engine(["cuda:0", "cuda:0", "cuda:1", "cuda:1"]) == "schedule"


@pytest.mark.parametrize("devices,engine", [(["cuda:0"] * 4, "kernel"),
                                            (["cuda:0", "cuda:1", "cuda:2", "cuda:3"], "schedule")])
def test_cuda_mesh_takes_its_engine_and_never_reroutes(monkeypatch, devices, engine):
    """A CUDA mesh runs the engine of its layout; a failure of the
    one-launch ring raises and never falls back to the host schedule. B6's
    and B7's counters count ``ring_onecard`` launches: the host schedule
    launches none."""
    calls = []
    monkeypatch.setattr(trt, "_check_parts", lambda *a: None)
    monkeypatch.setattr(trt, "_run_onecard", lambda *a: calls.append("kernel") or ((a[1], a[2]), None, None))
    monkeypatch.setattr(trt, "_run_ring", lambda *a: calls.append("schedule") or ((a[1], a[2]), None))
    mesh = types.SimpleNamespace(devices=tuple(torch.device(d) for d in devices), size=len(devices),
                                 is_cuda=True, axis_names=("data",))
    vs, ins = port_parts(*candidates(np.random.default_rng(6), len(devices), 5, 20, True))
    launches = (trt.fused_ring_topk.launches, trt.fused_scan_ring_topk.launches)
    trt.ring_topk(mesh, vs, ins, K)
    trt.scan_ring_topk(mesh, vs, ins, K)
    assert calls == [engine, engine]
    step = 1 if engine == "kernel" else 0
    assert (trt.fused_ring_topk.launches, trt.fused_scan_ring_topk.launches) == (
        launches[0] + step, launches[1] + step)

    def refused(*a):
        raise RaftError("ring_onecard kernel launch failed (cudaError 720)")

    monkeypatch.setattr(trt, "_run_onecard", refused)
    calls.clear()
    if engine == "kernel":
        with pytest.raises(RaftError, match="720"):
            trt.ring_topk(mesh, vs, ins, K)
        assert calls == []


def test_cpu_mesh_runs_the_plain_schedule(monkeypatch):
    monkeypatch.setattr(trt, "fused_ring_topk", lambda *a: pytest.fail("a CPU mesh launched"))
    monkeypatch.setattr(trt, "fused_scan_ring_topk", lambda *a: pytest.fail("a CPU mesh launched"))
    vs, ins = port_parts(*candidates(np.random.default_rng(8), 3, 9, 23, False))
    mesh = make_mesh(["cpu"] * 3)
    tv, ti = trt.scan_ring_topk(mesh, vs, ins, K, select_min=False)
    mv, mi = trt.ring_kernel_reference(vs, ins, K, False)
    assert_bits_equal((tv[2].numpy(), ti[2].numpy()), (mv[2].numpy(), mi[2].numpy()))
