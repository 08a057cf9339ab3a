"""The ring top-k module (kernels B5-B7's plain versions) against raft_tpu.

Inputs come from a numpy seed. JAX runs on the 8 virtual CPU devices, with
``hop_merge(interpret=True)`` and ``ring_topk``/``scan_ring_topk(use_fused=
False)`` (the XLA engine ``_ring_topk_xla``) inside this file's own
``shard_map``; the port runs on CPU meshes (``["cpu"] * n``). The bar is
bit for bit: the same ids, positions and value bits.

Two places where the JAX package's engines disagree with each other, and
which one the port follows:

* ``-0.0`` and ``+0.0``: ``lax.sort`` (the ring's fold) ties them,
  ``lax.top_k`` (the gather merge) puts ``-0.0`` first. The port's fold and
  its gather merge (a stable ``torch.sort``) tie them, so signed zeros are
  held against ``_fold``/``_ring_topk_xla`` only. The Pallas ``hop_merge``
  places values by one-hot sums, which turn a carried ``-0.0`` into
  ``+0.0``: it is held by value (``==``), ``_fold`` by bits.
* A real candidate at ``±inf`` (id >= 0): the TPU engines clip it to
  ``±WORST`` and return ``WORST``; the XLA engine and the gather merge
  return ``inf``. The port follows the XLA engine
  (:func:`test_real_inf_candidates_follow_the_xla_engine`).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from raft_tpu.ops.pallas import ring_topk as jrt
from raft_tpu.ops.select_k import merge_parts as jmerge_parts
from raft_tpu.parallel import make_mesh as jmake_mesh
from raft_tpu.parallel import wire_model as jwire
from raft_tpu.parallel._compat import shard_map
from raft_tpu_torch.core.errors import LogicError
from raft_tpu_torch.ops import ring_topk as trt
from raft_tpu_torch.parallel import comms, make_mesh
from raft_tpu_torch.parallel import wire_model as twire

PAD = trt._PAD_POS


def bits(x) -> np.ndarray:
    a = np.ascontiguousarray(np.asarray(x))
    return a.view(np.int32) if a.dtype == np.float32 else a


def assert_bits_equal(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(bits(x), bits(y))


def tiles(rng, rows, w, select_min, *, zeros=False, pads=True, parity=0):
    """A ``(key, pos, val, id)`` tile ``[rows, w]``, unsorted: integer values
    (many ties), distinct positions (of one ``parity``, so two tiles of
    different parity never share one), ``±inf`` values with real ids,
    padding entries, and with ``zeros`` signed zeros."""
    v = rng.integers(-3, 4, (rows, w)).astype(np.float32)
    if zeros:
        z = rng.random((rows, w)) < 0.3
        v[z] = np.where(rng.random(z.sum()) < 0.5, np.float32(-0.0), np.float32(0.0))
    v[rng.random((rows, w)) < 0.05] = np.inf
    v[rng.random((rows, w)) < 0.05] = -np.inf
    pos = (2 * rng.permutation(rows * w * 4)[: rows * w] + parity).reshape(rows, w).astype(np.int32)
    ids = (pos + 7).astype(np.int32)
    if pads:
        pad = rng.random((rows, w)) < 0.1
        v[pad] = np.inf if select_min else -np.inf
        pos[pad] = PAD
        ids[pad] = -1
    key = v if select_min else -v
    return key.astype(np.float32), pos, v, ids


def as_torch(t):
    return tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in t)


# -- B5: the fold ---------------------------------------------------------------


@pytest.mark.parametrize("w", [7, 16])
@pytest.mark.parametrize("select_min", [True, False])
@pytest.mark.parametrize("zeros", [False, True])
def test_fold_matches_jax_fold_and_hop_merge(w, select_min, zeros):
    rng = np.random.default_rng(w * 4 + 2 * select_min + zeros)
    a = tiles(rng, 64, w, select_min, zeros=zeros)
    b = tiles(rng, 64, w, select_min, zeros=zeros, parity=1)
    out = [x.numpy() for x in trt.hop_merge(as_torch(a), as_torch(b))]
    ref = [x.numpy() for x in trt.hop_merge_reference(as_torch(a), as_torch(b))]
    assert_bits_equal(out, ref)
    jf = jrt._fold(tuple(map(jnp.asarray, a)), tuple(map(jnp.asarray, b)), w)
    assert_bits_equal(out, jf)
    jh = jrt.hop_merge(tuple(map(jnp.asarray, a)), tuple(map(jnp.asarray, b)), interpret=True)
    for x, y in zip(out, jh):
        np.testing.assert_array_equal(x, np.asarray(y))  # by value: one-hot sums drop -0's sign


def test_fold_canonicalises_nan_as_lax_sort():
    """Every NaN (either sign) is one key after ``+inf``; ties in it fall to
    ``pos``, as ``lax.sort`` orders them."""
    rng = np.random.default_rng(5)
    a = list(tiles(rng, 8, 6, True, pads=False))
    b = list(tiles(rng, 8, 6, True, pads=False, parity=1))
    for t in (a, b):
        m = rng.random(t[0].shape) < 0.3
        t[0][m] = np.where(rng.random(m.sum()) < 0.5, np.float32(np.nan), -np.float32(np.nan))
        t[2] = t[0].copy()
    out = trt.hop_merge_reference(as_torch(a), as_torch(b))
    jf = jrt._fold(tuple(map(jnp.asarray, a)), tuple(map(jnp.asarray, b)), 6)
    for x, y in zip(out[1:], jf[1:]):  # positions, values (NaN payloads carried), ids
        x, y = x.numpy(), np.asarray(y)
        assert np.array_equal(x, y, equal_nan=True)
    np.testing.assert_array_equal(out[1].numpy(), np.asarray(jf[1]))


def test_order_key_is_a_total_order():
    key = torch.tensor([0.0, -0.0, float("nan"), -float("nan"), float("inf"), -float("inf"), 1.0])
    pos = torch.zeros(7, dtype=torch.int32)
    ok = trt.order_key(key, pos)
    assert ok[0] == ok[1] and ok[2] == ok[3]
    assert ok[5] < ok[0] < ok[6] < ok[4] < ok[2]
    assert trt.order_key(torch.tensor([1.0]), torch.tensor([PAD])) > trt.order_key(
        torch.tensor([1.0]), torch.tensor([3]))


# -- B6: the ring ---------------------------------------------------------------


def shard_candidates(rng, n, nq, kc, select_min, *, demote=(), inf=True):
    """Per-shard local top-k tiles ``[n, nq, kc]``, sorted best first as a
    real local top-k is: integer values (cross-shard ties), ``±inf`` values
    with real ids, and worst-value/-1 tiles for the ``demote``d shards."""
    v = rng.integers(-4, 5, (n, nq, kc)).astype(np.float32)
    if inf:
        v[rng.random((n, nq, kc)) < 0.05] = np.inf
        v[rng.random((n, nq, kc)) < 0.05] = -np.inf
    v = np.sort(v, axis=2)
    if not select_min:
        v = v[..., ::-1].copy()
    i = (np.arange(n, dtype=np.int32)[:, None, None] * 10_000
         + np.arange(kc, dtype=np.int32)[None, None, :] + np.zeros((n, nq, 1), np.int32))
    for s in demote:
        v[s] = np.inf if select_min else -np.inf
        i[s] = -1
    return v, i


def jax_ring(n, vs, ins, k, select_min, scan=False):
    """The JAX package's XLA ring engine inside this file's own shard_map."""
    mesh = jmake_mesh(jax.devices()[:n])
    fn = jrt.scan_ring_topk if scan else jrt.ring_topk

    @functools.partial(shard_map, mesh=mesh, in_specs=(P("data"), P("data")),
                       out_specs=(P(), P()))
    def prog(vb, ib):
        return fn(vb[0], ib[0], k, select_min=select_min, axis="data", use_fused=False)

    return jax.jit(prog)(jnp.asarray(vs), jnp.asarray(ins))


def jax_gather(vs, ins, k, select_min):
    n, nq, kc = vs.shape
    cat_v = np.moveaxis(vs, 0, 1).reshape(nq, n * kc)
    cat_i = np.moveaxis(ins, 0, 1).reshape(nq, n * kc)
    return jmerge_parts(jnp.asarray(cat_v), jnp.asarray(cat_i), k, select_min=select_min)


def port_parts(vs, ins):
    return ([torch.from_numpy(np.ascontiguousarray(x)) for x in vs],
            [torch.from_numpy(np.ascontiguousarray(x)) for x in ins])


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("kc", [6, 10, 23])
@pytest.mark.parametrize("select_min", [True, False])
def test_ring_matches_xla_engine_and_gather(eight_devices, n, kc, select_min):
    """Ties, a demoted shard (n > 1), ``±inf`` values, and local widths
    below, at and above k; query rows not a multiple of n."""
    k, nq = 10, 37
    rng = np.random.default_rng(100 * n + kc + select_min)
    demote = (n // 2,) if n > 1 else ()
    vs, ins = shard_candidates(rng, n, nq, kc, select_min, demote=demote)
    mesh = make_mesh(["cpu"] * n)
    tv, ti = trt.ring_topk(mesh, *port_parts(vs, ins), k, select_min=select_min)
    jv, ji = jax_ring(n, vs, ins, k, select_min)
    for r in range(n):  # replicated: every shard holds the same answer
        assert_bits_equal((tv[r].numpy(), ti[r].numpy()), (jv, ji))
    if n * kc >= k:
        gv, gi = jax_gather(vs, ins, k, select_min)
        assert_bits_equal((tv[0].numpy(), ti[0].numpy()), (gv, gi))
        pv, pi = trt.gather_merge(mesh, *port_parts(vs, ins), k, select_min)
        assert_bits_equal((tv[0].numpy(), ti[0].numpy()), (pv[0].numpy(), pi[0].numpy()))


def test_ring_ties_signed_zeros_as_lax_sort(eight_devices):
    """``-0.0`` and ``+0.0`` tie in the ring (the XLA engine's order); the
    port's gather merge ties them too."""
    n, nq, k = 4, 16, 6
    rng = np.random.default_rng(9)
    vs = np.where(rng.random((n, nq, k)) < 0.5, np.float32(-0.0), np.float32(0.0))
    vs[..., 3:] = 1.0
    ins = np.arange(n * nq * k, dtype=np.int32).reshape(n, nq, k)
    mesh = make_mesh(["cpu"] * n)
    tv, ti = trt.ring_topk(mesh, *port_parts(vs, ins), k)
    jv, ji = jax_ring(n, vs, ins, k, True)
    assert_bits_equal((tv[0].numpy(), ti[0].numpy()), (jv, ji))
    pv, pi = trt.gather_merge(mesh, *port_parts(vs, ins), k, True)
    np.testing.assert_array_equal(ti[0].numpy(), pi[0].numpy())


def test_real_inf_candidates_follow_the_xla_engine(eight_devices):
    """A real candidate at ``+inf`` (min-select, id >= 0) comes back as
    ``inf`` with its id, ahead of padding, as from ``_ring_topk_xla`` and the
    gather merge (the TPU engines would report ``WORST``)."""
    n, nq, k = 2, 4, 4
    vs = np.full((n, nq, 2), np.inf, np.float32)
    vs[:, :, 0] = 1.0
    ins = np.arange(n * nq * 2, dtype=np.int32).reshape(n, nq, 2)
    mesh = make_mesh(["cpu"] * n)
    tv, ti = trt.ring_topk(mesh, *port_parts(vs, ins), k)
    jv, ji = jax_ring(n, vs, ins, k, True)
    assert_bits_equal((tv[0].numpy(), ti[0].numpy()), (jv, ji))
    assert np.isinf(tv[0].numpy()[:, 2:]).all() and (ti[0].numpy()[:, 2:] >= 0).all()
    assert not (tv[0].numpy() == trt.WORST).any()


# -- B7: the scan fold and the scan ring -------------------------------------------


@pytest.mark.parametrize("kc", [13, 30, 83])
@pytest.mark.parametrize("select_min", [True, False])
def test_scan_fold_matches_jax_and_sort_truncate(kc, select_min):
    k = 10
    rng = np.random.default_rng(kc + select_min)
    t = tiles(rng, 21, kc, select_min)
    out = trt._scan_fold(*as_torch(t), k, select_min)
    assert_bits_equal([x.numpy() for x in out],
                      jrt._scan_fold(*map(jnp.asarray, t), k, select_min))
    assert_bits_equal([x.numpy() for x in out],
                      [x.numpy() for x in trt._sort_truncate(as_torch(t), k)])


@pytest.mark.parametrize("n,kc", [(1, 80), (3, 10), (4, 30), (4, 83)])
def test_scan_ring_matches_jax_scan_ring_and_gather(eight_devices, n, kc):
    k, nq = 10, 33
    rng = np.random.default_rng(n * kc)
    vs, ins = shard_candidates(rng, n, nq, kc, True, demote=(1,) if n > 1 else ())
    mesh = make_mesh(["cpu"] * n)
    tv, ti = trt.scan_ring_topk(mesh, *port_parts(vs, ins), k)
    jv, ji = jax_ring(n, vs, ins, k, True, scan=True)
    assert_bits_equal((tv[-1].numpy(), ti[-1].numpy()), (jv, ji))
    gv, gi = jax_gather(vs, ins, k, True)
    assert_bits_equal((tv[0].numpy(), ti[0].numpy()), (gv, gi))


def test_kernel_wrappers_need_a_cuda_mesh():
    """On a CPU mesh the dispatch runs the plain versions; the kernel
    wrappers themselves refuse (they never fall back)."""
    mesh = make_mesh(["cpu"] * 2)
    vs, ins = port_parts(*shard_candidates(np.random.default_rng(0), 2, 4, 5, True))
    with pytest.raises(LogicError):
        trt.fused_ring_topk(mesh, vs, ins, 5)
    with pytest.raises(LogicError):
        trt.fused_scan_ring_topk(mesh, vs, ins, 3)


# -- the mesh, the verbs and the wire model -------------------------------------------


def test_make_mesh_raises_without_enough_cuda_devices(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("the CPU build has no CUDA device")
    with pytest.raises(LogicError, match="no CUDA device"):
        make_mesh()
    with pytest.raises(LogicError, match="asked for"):
        make_mesh(["cuda:0"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(LogicError, match="asked for"):
        make_mesh(["cuda:0", "cuda:1"])
    with pytest.raises(LogicError, match="mix"):
        make_mesh(["cpu", "cuda:0"])
    with pytest.raises(LogicError, match="one-axis"):
        make_mesh(["cpu"], axis_names=("a", "b"))


def test_cpu_mesh_layout():
    mesh = make_mesh(["cpu"] * 4)
    assert mesh.size == 4 and mesh.shape == {"data": 4} and mesh.virtual and not mesh.is_cuda
    assert comms.comm_size(mesh) == 4
    x = torch.arange(24.0).reshape(8, 3)
    parts = comms.row_sharded(mesh, x)
    assert all(p.data_ptr() == x[2 * r].data_ptr() for r, p in enumerate(parts))  # views
    assert all(p is x for p in comms.replicated(mesh, x))


def test_verbs_on_a_cpu_mesh():
    n = 4
    mesh = make_mesh(["cpu"] * n)
    xs = [torch.arange(8.0).reshape(4, 2) + 10 * r for r in range(n)]
    total = sum(xs)
    ag = comms.allgather(mesh, xs)
    assert all(torch.equal(a, torch.stack(xs)) for a in ag)
    assert all(torch.equal(a, torch.cat(xs)) for a in comms.allgather(mesh, xs, tiled=True))
    for op, ref in (("sum", total), ("max", xs[-1]), ("min", xs[0]),
                    ("prod", xs[0] * xs[1] * xs[2] * xs[3])):
        assert all(torch.equal(a, ref) for a in comms.allreduce(mesh, xs, op=op))
    rs = comms.reducescatter(mesh, xs)
    assert all(torch.equal(rs[r], total[r:r + 1]) for r in range(n))
    assert all(torch.equal(b, xs[2]) for b in comms.bcast(mesh, xs, root=2))
    red = comms.reduce(mesh, xs, root=1)
    assert torch.equal(red[1], total) and all(not red[r].any() for r in (0, 2, 3))
    pp = comms.ppermute(mesh, xs, [(j, (j + 1) % n) for j in range(n)])
    assert all(torch.equal(pp[(j + 1) % n], xs[j]) for j in range(n))
    sr = comms.send_recv(mesh, xs, 3, 0)
    assert torch.equal(sr[0], xs[3]) and all(not sr[r].any() for r in (1, 2, 3))
    assert all(int(b) == n for b in comms.barrier(mesh))


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_wire_model_values_are_the_jax_packages(n):
    for k in (10, 64):
        for mode in ("ring", "fused_ring", "gather"):
            assert twire.wire_bytes_per_query(n, k, mode) == jwire.wire_bytes_per_query(n, k, mode)
    for verb in list(jwire.WIRE_FACTORS) + ["unknown"]:
        assert twire.wire_bytes(verb, 1000.0, n) == jwire.wire_bytes(verb, 1000.0, n)
    for mode in ("full", "ca"):
        assert (twire.lloyd_wire_bytes_per_iter(64, 32, n, mode)
                == jwire.lloyd_wire_bytes_per_iter(64, 32, n, mode))
        assert (twire.codebook_wire_bytes_per_iter(16, 256, 8, n, mode)
                == jwire.codebook_wire_bytes_per_iter(16, 256, 8, n, mode))
    assert (twire.RS_ENTRY_BYTES, twire.AG_ENTRY_BYTES) == (jwire.RS_ENTRY_BYTES,
                                                            jwire.AG_ENTRY_BYTES) == (12, 8)
    assert twire.ca_exchange_cap(100) == jwire.ca_exchange_cap(100)
