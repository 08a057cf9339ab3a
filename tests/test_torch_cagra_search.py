"""Kernel B4's module against raft_tpu: the same neighbour table, queries and
seed beam go through the JAX package's Pallas ``cagra_fused_search`` (in
interpret mode) and the port's plain ``cagra_beam_reference``, for an f32
table under L2 and inner product, search widths 1 and 4 and beams of 32 and
64, on a query count that is not a multiple of 8, and once with a bf16
table. Both final beams go through the fused path's epilogue (the unique
merge, top 10), and the bar is the JAX package's own fused-vs-xla one
(``tests/test_cagra.py``): ids agree on >= 0.99 of the slots (>= 0.95 with
bf16), top-1 equal, values allclose(rtol=1e-5, atol=1e-5) where the ids
agree. The two packages add each score in another order (the port in its
kernel's lane order), so the last bits differ and a near tie can steer the
two beams apart: the beams themselves agree only in most slots."""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.neighbors import cagra as jcagra
from raft_tpu_torch.ops import cagra_search as tcs
from raft_tpu_torch.ops.select_k import running_merge_unique

jcs = importlib.import_module("raft_tpu.ops.pallas.cagra_search")

N, D, DEG, NQ = 2000, 16, 16, 45


def _data(rng, n, d, n_centers=16, scale=0.25):
    centers = rng.standard_normal((n_centers, d)).astype(np.float32)
    labels = rng.integers(0, n_centers, n)
    return (centers[labels] + scale * rng.standard_normal((n, d))).astype(np.float32)


@pytest.fixture(scope="module")
def setup():
    """Data, queries and a CAGRA graph (the JAX package's optimize of the
    exact 33-NN graph)."""
    rng = np.random.default_rng(33)
    x = _data(rng, N, D)
    q = _data(rng, NQ, D)
    d2 = (x * x).sum(1)[:, None] + (x * x).sum(1)[None, :] - 2.0 * x @ x.T
    np.fill_diagonal(d2, np.inf)
    knn = np.argsort(d2, axis=1, kind="stable")[:, :32].astype(np.int32)
    graph = np.asarray(jcagra.optimize(knn, DEG))
    return x, q, graph


def seed_beam(x, q, itopk, ip):
    """The fused path's seed beam, from the JAX package's ``_seed_select``
    over the strided sample, in the kernel's min-ordered form."""
    qf = jnp.asarray(q)
    ids = jcagra.strided_seed_ids(N, 512)
    vecs = jnp.asarray(x)[ids]
    worst = -np.inf if ip else np.inf
    v0, i0 = jcagra._seed_select(
        qf, jnp.sum(qf * qf, axis=1), vecs, jnp.sum(vecs * vecs, axis=1), ids, itopk=itopk,
        select_min=not ip, worst=jnp.float32(worst), filter_bits=None, has_filter=False)
    v0, i0 = np.asarray(v0), np.asarray(i0)
    kv0 = np.where(i0 < 0, jcs.WORST, -v0 if ip else v0).astype(np.float32)
    kidf0 = np.where(i0 < 0, -1, i0 * 2).astype(np.int32)
    return kv0, kidf0


def run_both(setup, itopk, width, ip, dtype):
    x, q, graph = setup
    sp = jcagra.CagraSearchParams(itopk_size=itopk, search_width=width)
    _, _, iters, _ = jcagra.derive_search_config(sp, 10, N)
    kv0, kidf0 = seed_beam(x, q, itopk, ip)
    jtab = jcs.build_neighbor_table(jnp.asarray(x), jnp.asarray(graph),
                                    dtype=jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    jv, jidf = jcs.cagra_fused_search(jtab, jnp.asarray(q), jnp.asarray(kv0), jnp.asarray(kidf0),
                                      itopk=itopk, width=width, iters=iters, qt=32, ip=ip,
                                      interpret=True)
    ttab = tcs.build_neighbor_table(torch.from_numpy(x), torch.from_numpy(graph),
                                    dtype=getattr(torch, dtype))
    launches = tcs.cagra_fused_search.launches
    tv, tidf = tcs.cagra_fused_search(ttab, torch.from_numpy(graph), torch.from_numpy(q),
                                      torch.from_numpy(kv0), torch.from_numpy(kidf0), itopk=itopk,
                                      width=width, iters=iters, ip=ip)
    assert tcs.cagra_fused_search.launches == launches  # CPU tensors take the plain version
    return np.asarray(jv), np.asarray(jidf), tv.numpy(), tidf.numpy()


def final_topk(v, idf, k=10):
    """The fused path's epilogue on a final beam: ids unpacked, one unique
    merge (visited copies win), the best ``k``."""
    v, idf = torch.from_numpy(np.asarray(v)), torch.from_numpy(np.asarray(idf))
    ids = idf >> 1
    nq = v.shape[0]
    out_v, out_i, _ = running_merge_unique(
        torch.where(ids < 0, float("inf"), v), ids, torch.full((nq, 1), float("inf")),
        torch.full((nq, 1), -1, dtype=torch.int32), acc_flags=(idf & 1) == 1)
    return out_v[:, :k].numpy(), out_i[:, :k].numpy()


def assert_agree(jv, jidf, tv, tidf, min_agree):
    a, ai = final_topk(jv, jidf)
    b, bi = final_topk(tv, tidf)
    same = ai == bi
    assert same.mean() >= min_agree, same.mean()
    np.testing.assert_array_equal(bi[:, 0], ai[:, 0])
    np.testing.assert_allclose(b[same], a[same], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("ip", [False, True], ids=["l2", "ip"])
@pytest.mark.parametrize("width", [1, 4])
@pytest.mark.parametrize("itopk", [32, 64])
def test_beam_matches_pallas_f32(setup, itopk, width, ip):
    jv, jidf, tv, tidf = run_both(setup, itopk, width, ip, "float32")
    assert tv.shape == (NQ, itopk) and tidf.dtype == np.int32
    assert_agree(jv, jidf, tv, tidf, 0.99)
    # the beams themselves hold mostly the same live ids
    shared = [len(set(a[a >= 0]) & set(b[b >= 0])) / max(1, (a >= 0).sum())
              for a, b in zip(jidf >> 1, tidf >> 1)]
    assert np.mean(shared) >= 0.9, np.mean(shared)


def test_beam_matches_pallas_bf16(setup):
    jv, jidf, tv, tidf = run_both(setup, 64, 4, False, "bfloat16")
    assert_agree(jv, jidf, tv, tidf, 0.95)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_table_holds_jax_table_vectors(setup, dtype):
    """The port's [n, deg, d] table is the JAX table's vector rows (its
    three id-digit rows dropped), bf16 rounded to nearest even alike."""
    x, _, graph = setup
    g = graph.copy()
    g[::7, -1] = -1  # -1 entries read row 0 in both
    jtab = jcs.build_neighbor_table(jnp.asarray(x), jnp.asarray(g), dtype=getattr(jnp, dtype),
                                    row_chunk=512)
    ttab = tcs.build_neighbor_table(torch.from_numpy(x), torch.from_numpy(g),
                                    dtype=getattr(torch, dtype), row_chunk=300)
    assert tuple(ttab.shape) == (N, DEG, D) and ttab.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(ttab.to(torch.float32).numpy(),
                                  np.asarray(jtab[:, :DEG, :].astype(jnp.float32)))


def test_lane_tree_order():
    """The score adds per lane (dimensions l, l + 32, ...) then folds the 32
    lane sums as a tree; every dimension is counted once."""
    rng = np.random.default_rng(0)
    for d in (16, 32, 100, 128):
        q = torch.from_numpy(rng.standard_normal((3, 1, d)).astype(np.float32))
        v = torch.from_numpy(rng.standard_normal((3, 5, d)).astype(np.float32))
        want = ((q.double() - v.double()) ** 2).sum(-1)
        np.testing.assert_allclose(tcs.lane_tree_score(q, v, False).numpy(), want.numpy(), rtol=1e-5)
        np.testing.assert_allclose(tcs.lane_tree_score(q, v, True).numpy(),
                                   -(q.double() * v.double()).sum(-1).numpy(), rtol=1e-4, atol=1e-5)
        # lane order by hand for one row
        e = ((q[0, 0] - v[0, 0]) ** 2).tolist() + [0.0] * (-d % 32)
        lanes = [np.float32(0)] * 32
        for t, val in enumerate(e):
            lanes[t % 32] = np.float32(lanes[t % 32] + np.float32(val))
        for off in (16, 8, 4, 2, 1):
            lanes = [np.float32(lanes[i] + lanes[i + off]) for i in range(off)]
        assert tcs.lane_tree_score(q, v, False)[0, 0].item() == float(lanes[0])


def test_shared_memory_bound():
    # the operating point: 128 + 8 * 16 = 256 union entries, d = 128
    assert tcs.smem_bytes(128, 8, 16, 128) == 8 * 256 + 4 * (128 + 4 * 128 + 2 * 128 + 8)
    assert tcs.smem_bytes(8192, 8, 64, 128) > 232448


def test_bad_arguments_raise(setup):
    x, q, graph = setup
    tab = tcs.build_neighbor_table(torch.from_numpy(x), torch.from_numpy(graph),
                                   dtype=torch.float32)
    iv = torch.zeros((NQ, 8))
    ii = torch.zeros((NQ, 8), dtype=torch.int32)
    with pytest.raises(Exception, match="search width"):
        tcs.cagra_fused_search(tab, torch.from_numpy(graph), torch.from_numpy(q), iv, ii, itopk=8,
                               width=9, iters=1)
    with pytest.raises(Exception, match="graph must be"):
        tcs.cagra_fused_search(tab, torch.from_numpy(graph[:, :8]), torch.from_numpy(q), iv, ii,
                               itopk=8, width=1, iters=1)
