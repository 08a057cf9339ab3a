"""The IVF-PQ slice end to end against raft_tpu: JAX-built indexes of every
code family (kmeans per-subspace and per-cluster, nibble, packed 4/5-bit,
RaBitQ) loaded by the port and searched by both packages (probe, fused in
the lossless window of the Pallas merge, prefilter, refine), the default
params at a recall tolerance, save/load byte for byte both ways, the build
from injected quantizers, the port's own build at a recall tolerance,
extend, the serving engine, and the modes that raise."""
import dataclasses
import importlib
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.core.bitset import Bitset as JBitset
from raft_tpu.neighbors import brute_force as jbf
from raft_tpu.neighbors import ivf_pq as jivf
from raft_tpu_torch.core.bitset import Bitset as TBitset
from raft_tpu_torch.core.errors import LogicError
from raft_tpu_torch.core.resources import Resources
from raft_tpu_torch.neighbors import ivf_common
from raft_tpu_torch.neighbors import ivf_flat as tflat
from raft_tpu_torch.neighbors import ivf_pq as tivf
from raft_tpu_torch.ops import pq_scan as tpq_scan
from raft_tpu_torch.serve import ServingEngine
from raft_tpu_torch.stats.recall import neighborhood_recall

jpq_scan = importlib.import_module("raft_tpu.ops.pallas.pq_scan")

N, D, N_LISTS, NQ, K = 4000, 32, 16, 48, 10
CPU = Resources(device="cpu")
KINDS = {
    "kmeans": dict(pq_kind="kmeans"),
    "per_cluster": dict(pq_kind="kmeans", codebook_kind="per_cluster"),
    "nibble": dict(),
    "p4": dict(pq_kind="kmeans", pq_bits=4),
    "b5": dict(pq_kind="kmeans", pq_bits=5),
    "rabitq": dict(pq_bits=1),
}
FUSED_KINDS = ["kmeans", "nibble", "p4", "b5", "rabitq"]


def jparams(kind, **kw):
    return jivf.IvfPqIndexParams(n_lists=N_LISTS, pq_dim=16, kmeans_n_iters=5, **KINDS[kind], **kw)


def tparams(kind, **kw):
    return tivf.IvfPqIndexParams(n_lists=N_LISTS, pq_dim=16, kmeans_n_iters=5, **KINDS[kind], **kw)


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(11)
    centers = rng.normal(size=(40, D)).astype(np.float32) * 3
    x = (centers[rng.integers(0, 40, N)] + rng.normal(size=(N, D))).astype(np.float32)
    q = (centers[rng.integers(0, 40, NQ)] + rng.normal(size=(NQ, D))).astype(np.float32)
    _, gt = jbf.search(jbf.build(x, metric="sqeuclidean"), q, K)
    return x, q, torch.from_numpy(np.array(gt))


def _jax_bytes(index) -> bytes:
    buf = io.BytesIO()
    jivf.save(index, buf)
    return buf.getvalue()


@pytest.fixture(scope="module")
def pair(corpus):
    """(kind, metric) -> (JAX index, its saved bytes, the port's load of
    them), built once."""
    built = {}

    def get(kind, metric="sqeuclidean"):
        if (kind, metric) not in built:
            ji = jivf.build(corpus[0], jparams(kind, metric=metric))
            raw = _jax_bytes(ji)
            built[kind, metric] = (ji, raw, tivf.load(io.BytesIO(raw), device="cpu"))
        return built[kind, metric]

    return get


def assert_search_equal(td, ti, jd, ji, tol=1e-5, atol=None):
    """ids equal wherever the distance is not tied within ``tol`` (or
    ``atol``) with another entry of the row; distances allclose(rtol=1e-5,
    atol=1e-4), or within ``atol [nq, 1]`` where given."""
    td, ti = td.numpy(), ti.numpy()
    jd, ji = np.asarray(jd), np.asarray(ji)
    fin = np.isfinite(jd)
    assert np.array_equal(np.isfinite(td), fin)
    if atol is None:
        np.testing.assert_allclose(td[fin], jd[fin], rtol=1e-5, atol=1e-4)
    else:
        err = np.abs(td - np.where(fin, jd, 0.0))
        assert (err[fin] <= np.broadcast_to(atol, err.shape)[fin]).all(), err[fin].max()
    for i, j in np.argwhere(ti != ji):
        bound = tol * max(1.0, abs(jd[i, j])) if atol is None else atol[i, 0]
        near = np.abs(jd[i] - jd[i, j]) <= bound
        assert near.sum() >= 2, (i, j, ti[i], ji[i], jd[i])


def search_tolerance(index, q):
    """None (allclose) for PQ. For RaBitQ the estimate ``||q||^2 + C1 -
    2 q.c - g (b.q_rot - sum(q_rot) / 2)`` cancels large terms, so the f32
    summation-order tolerance is taken against their sizes:
    ``1e-5 * sum|terms| + 1e-5`` per query, with every term bounded by its
    largest value over the index."""
    if not index.rabitq:
        return None
    q_rot = torch.from_numpy(q) @ index.rotation.T
    aq = torch.abs(q_rot)
    qc = (aq @ torch.abs(index.centers_rot).max(dim=0).values)
    terms = (torch.sum(q_rot * q_rot, dim=1) + 2.0 * qc + torch.abs(index.rot_sqnorms).max()
             + index.corrections.max() * 1.5 * aq.sum(dim=1))
    return (1e-5 * terms + 1e-5).numpy()[:, None]


@pytest.fixture
def jax_lut(monkeypatch):
    """The port's fused search builds its bf16 LUT with the JAX package's
    ``pq_lut``, so both searches score with the same table (the LUT
    itself is held in ``tests/test_torch_pq_scan.py``)."""

    def lut(q_rot, books):
        w = jpq_scan.pq_lut(jnp.asarray(q_rot.numpy()), jnp.asarray(books.numpy()))
        return torch.from_numpy(np.array(w.astype(jnp.float32))).to(torch.bfloat16)

    monkeypatch.setattr(tpq_scan, "pq_lut", lut)


# -- search parity on JAX-built indexes --------------------------------------


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("metric", ["sqeuclidean", "inner_product"])
def test_probe_search_matches_jax(corpus, pair, kind, metric):
    _, q, _ = corpus
    ji, _, ti = pair(kind, metric)
    jd, jidx = jivf.search(ji, q, K, jivf.IvfPqSearchParams(n_probes=4, refine_ratio=1), mode="probe")
    td, tidx = tivf.search(ti, torch.from_numpy(q), K, tivf.IvfPqSearchParams(n_probes=4, refine_ratio=1),
                           mode="probe")
    assert tidx.dtype == torch.int32 and td.dtype == torch.float32
    assert_search_equal(td, tidx, jd, jidx, atol=search_tolerance(ti, q))


def _exact_window(**kw):
    """Single-list units and an extraction every step: the Pallas bank8
    merge then loses nothing (the index's lists hold at most 8 * 128 rows)."""
    return dict(n_probes=4, refine_ratio=1, fused_qt=8, fused_group=1, fused_extract_every=1, **kw)


@pytest.mark.parametrize("kind", FUSED_KINDS)
@pytest.mark.parametrize("with_filter", [False, True])
def test_fused_search_matches_jax(corpus, pair, jax_lut, kind, with_filter):
    x, q, _ = corpus
    ji, _, ti = pair(kind)
    assert ji.max_list <= 8 * 128
    jb = tb = None
    if with_filter:
        keep = np.random.default_rng(5).random(N) < 0.5
        jb, tb = JBitset.from_mask(jnp.asarray(keep)), TBitset.from_mask(torch.from_numpy(keep))
    jd, jidx = jivf.search(ji, q, K, jivf.IvfPqSearchParams(**_exact_window()), prefilter=jb,
                           mode="fused")
    td, tidx = tivf.search(ti, torch.from_numpy(q), K, tivf.IvfPqSearchParams(**_exact_window()),
                           prefilter=tb, mode="fused")
    assert_search_equal(td, tidx, jd, jidx, atol=search_tolerance(ti, q))
    if with_filter:
        got = tidx.numpy()
        assert keep[got[got >= 0]].all()


def test_fused_inner_product_matches_jax(corpus, pair, jax_lut):
    _, q, _ = corpus
    ji, _, ti = pair("nibble", "inner_product")
    jd, jidx = jivf.search(ji, q, K, jivf.IvfPqSearchParams(**_exact_window()), mode="fused")
    td, tidx = tivf.search(ti, torch.from_numpy(q), K, tivf.IvfPqSearchParams(**_exact_window()),
                           mode="fused")
    assert_search_equal(td, tidx, jd, jidx)


def test_multi_batch_padding_matches_jax(corpus, pair, jax_lut):
    """Several query batches with a zero-padded tail, as in raft_tpu."""
    _, q, _ = corpus
    ji, _, ti = pair("nibble")
    jd, jidx = jivf.search(ji, q, K, jivf.IvfPqSearchParams(**_exact_window()), mode="fused",
                           query_batch=20)
    td, tidx = tivf.search(ti, torch.from_numpy(q), K, tivf.IvfPqSearchParams(**_exact_window()),
                           mode="fused", query_batch=20)
    assert_search_equal(td, tidx, jd, jidx)


@pytest.mark.parametrize("kind", ["nibble", "rabitq"])
def test_default_params_recall(corpus, pair, kind):
    """Default fused params (bank8 merge, 8-list units, the port's own
    LUT): the port's exact merge holds at least JAX's recall@10, less
    0.005."""
    _, q, gt = corpus
    ji, _, ti = pair(kind)
    jp = jivf.IvfPqSearchParams(n_probes=4, refine_ratio=1)
    tp = tivf.IvfPqSearchParams(n_probes=4, refine_ratio=1)
    assert tp.fused_merge == jp.fused_merge == "bank8" and tp.fused_group == jp.fused_group
    _, jidx = jivf.search(ji, q, K, jp, mode="fused")
    _, tidx = tivf.search(ti, torch.from_numpy(q), K, tp, mode="fused")
    assert neighborhood_recall(tidx, gt) >= neighborhood_recall(torch.from_numpy(np.array(jidx)), gt) - 0.005


@pytest.mark.parametrize("kind", ["nibble", "rabitq"])
def test_integrated_refine_matches_jax(corpus, pair, kind):
    x, q, _ = corpus
    ji, _, ti = pair(kind)
    jd, jidx = jivf.search(ji, q, K, jivf.IvfPqSearchParams(n_probes=4), mode="probe", dataset=x)
    td, tidx = tivf.search(ti, torch.from_numpy(q), K, tivf.IvfPqSearchParams(n_probes=4),
                           mode="probe", dataset=torch.from_numpy(x))
    assert_search_equal(td, tidx, jd, jidx)


# -- serialization -------------------------------------------------------------


@pytest.mark.parametrize("kind", list(KINDS))
def test_jax_saved_index_round_trips_byte_for_byte(pair, kind):
    _, raw, ti = pair(kind)
    buf = io.BytesIO()
    tivf.save(ti, buf)
    assert buf.getvalue() == raw


@pytest.mark.parametrize("kind", ["nibble", "b5", "rabitq"])
def test_port_saved_index_loads_in_jax_byte_for_byte(corpus, kind, tmp_path):
    x, _, _ = corpus
    ti = tivf.build(x[:1500], tparams(kind), res=CPU)
    path = tivf.save_path(ti, str(tmp_path / "pq.idx"))
    with open(path, "rb") as f:
        raw = f.read()
    ji = jivf.load_path(path)
    assert _jax_bytes(ji) == raw
    back = tivf.load_path(path, device="cpu")
    for f in ("codes", "list_indices", "rot_sqnorms", "centers_rot"):
        assert torch.equal(getattr(back, f), getattr(ti, f)), f


def test_from_numpy_carries_a_jax_index(corpus, pair):
    _, q, _ = corpus
    ji, _, loaded = pair("b5")
    arrays = {f: np.asarray(getattr(ji, f)) for f in (
        "centers", "centers_rot", "rotation", "pq_centers", "codes", "list_indices",
        "list_sizes", "rot_sqnorms", "center_rank")}
    ti = tivf.from_numpy(arrays, ji.metric, ji.size, pq_bits=ji.pq_bits, packed=ji.packed,
                         device="cpu")
    assert ti.pq_dim == loaded.pq_dim == 16
    p = tivf.IvfPqSearchParams(n_probes=4, refine_ratio=1)
    a = tivf.search(ti, torch.from_numpy(q), K, p, mode="probe")
    b = tivf.search(loaded, torch.from_numpy(q), K, p, mode="probe")
    assert torch.equal(a[1], b[1]) and torch.equal(a[0], b[0])


# -- build ------------------------------------------------------------------------


@pytest.mark.parametrize("kind", [k for k in KINDS if k != "rabitq"])
def test_build_with_injected_quantizers_encodes_like_jax(corpus, pair, kind):
    x, _, _ = corpus
    ji, _, _ = pair(kind)
    ti = tivf.build_with_quantizers(x, np.asarray(ji.centers), np.asarray(ji.rotation),
                                    np.asarray(ji.pq_centers), tparams(kind), res=CPU)
    assert (ti.additive, ti.packed, ti.pq_bits) == (ji.additive, ji.packed, ji.pq_bits)
    for f in ("list_indices", "list_sizes", "center_rank"):
        assert np.array_equal(getattr(ti, f).numpy(), np.asarray(getattr(ji, f))), f
    tc = ti.codes_unpacked().numpy()
    jc = np.asarray(ji.codes_unpacked())
    assert (tc == jc).mean() >= 0.999  # argmin ties may differ
    same = (tc == jc).all(axis=2)
    np.testing.assert_allclose(ti.rot_sqnorms.numpy()[same], np.asarray(ji.rot_sqnorms)[same],
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(ti.centers_rot.numpy(), np.asarray(ji.centers_rot), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("metric", ["sqeuclidean", "inner_product"])
def test_rabitq_build_with_injected_rotation_encodes_like_jax(corpus, pair, metric):
    x, _, _ = corpus
    ji, _, _ = pair("rabitq", metric)
    ti = tivf.build_with_quantizers(x, np.asarray(ji.centers), np.asarray(ji.rotation),
                                    np.asarray(ji.pq_centers), tparams("rabitq", metric=metric),
                                    res=CPU)
    assert ti.rabitq and ti.packed and ti.pq_bits == 1
    assert np.array_equal(ti.list_indices.numpy(), np.asarray(ji.list_indices))
    assert np.array_equal(ti.codes.numpy(), np.asarray(ji.codes))
    np.testing.assert_allclose(ti.rot_sqnorms.numpy(), np.asarray(ji.rot_sqnorms), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(ti.corrections.numpy(), np.asarray(ji.corrections), rtol=1e-5, atol=1e-5)


def test_batched_lloyd_from_jax_init_matches():
    rng = np.random.default_rng(4)
    cent = rng.normal(size=(4, 16, 2)).astype(np.float32) * 4
    X = (cent[:, rng.integers(0, 16, 600)] + rng.normal(size=(4, 600, 2)) * 0.3).astype(np.float32)
    mask = np.ones((4, 600), np.float32)
    mask[:, 500:] = 0.0
    init = X[:, :16].copy()
    j = jivf._batched_lloyd(jnp.asarray(X), jnp.asarray(mask), jnp.asarray(init), k=16, n_iters=6)
    t = tivf._batched_lloyd(torch.from_numpy(X), torch.from_numpy(mask), torch.from_numpy(init),
                            k=16, n_iters=6)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bits", [3, 4, 5, 6, 7, 1])
def test_pack_codes_bits_match_jax(bits):
    codes = np.random.default_rng(bits).integers(0, 1 << bits, (3, 7, 16)).astype(np.uint8)
    jp = np.asarray(jivf.pack_codes_bits(jnp.asarray(codes), bits))
    tp = tivf.pack_codes_bits(torch.from_numpy(codes), bits)
    assert np.array_equal(tp.numpy(), jp)
    assert np.array_equal(tivf.unpack_codes_bits(tp, bits, 16).numpy(), codes)


def test_nibble_books_match_jax(pair):
    ji, _, ti = pair("nibble")
    assert np.array_equal(tivf.nibble_books(ti.pq_centers).numpy(),
                          np.asarray(jivf.nibble_books(ji.pq_centers)))


@pytest.mark.parametrize("dim", [16, 32, 100, 128, 200, 960])
def test_default_pq_dim_matches_jax(dim):
    assert tivf._default_pq_dim(dim) == jivf._default_pq_dim(dim)


@pytest.mark.parametrize("kind", ["nibble", "kmeans", "rabitq"])
def test_end_to_end_build_recall(corpus, pair, kind):
    """The port trains with its own random draws; its recall@10 stays
    within 0.02 of JAX's. RaBitQ is held at its operating point, with
    refine: the raw estimate's recall depends on the random rotation,
    which the two packages draw differently."""
    x, q, gt = corpus
    ji, _, _ = pair(kind)
    ti = tivf.build(x, tparams(kind), res=CPU)
    assert ti.n_lists == N_LISTS and ti.size == N and ti.pq_bits == ji.pq_bits
    assert (ti.additive, ti.packed, ti.rabitq) == (ji.additive, ji.packed, ji.rabitq)
    for refine in (4,) if kind == "rabitq" else (1, 4):
        jp = jivf.IvfPqSearchParams(n_probes=4, refine_ratio=refine)
        tp = tivf.IvfPqSearchParams(n_probes=4, refine_ratio=refine)
        _, jidx = jivf.search(ji, q, K, jp, mode="probe", dataset=x)
        _, tidx = tivf.search(ti, torch.from_numpy(q), K, tp, dataset=torch.from_numpy(x))
        j_rec = neighborhood_recall(torch.from_numpy(np.array(jidx)), gt)
        assert neighborhood_recall(tidx, gt) >= j_rec - 0.02, (refine, j_rec)


@pytest.mark.parametrize("kind", ["nibble", "b5", "rabitq"])
def test_extend_matches_jax(corpus, pair, kind):
    ji, _, ti = pair(kind)
    new = np.random.default_rng(3).normal(size=(300, D)).astype(np.float32) * 3
    je = jivf.extend(ji, new)
    te = tivf.extend(ti, torch.from_numpy(new))
    assert te.size == je.size and te.max_list == je.max_list
    for f in ("list_indices", "list_sizes"):
        assert np.array_equal(getattr(te, f).numpy(), np.asarray(getattr(je, f))), f
    assert (te.codes_unpacked().numpy() == np.asarray(je.codes_unpacked())).mean() >= 0.999


# -- serving and modes -------------------------------------------------------------


@pytest.mark.parametrize("mode", [None, "fused"])
def test_serving_bucket_aligned_equals_direct_search(corpus, pair, mode):
    x, q, _ = corpus
    _, _, ti = pair("nibble")
    params = tivf.IvfPqSearchParams(n_probes=4, fused_qt=8, refine_ratio=2)
    eng = ServingEngine(max_batch=16, max_wait_ms=0.0, queue_capacity=256, res=CPU)
    eng.register("pq", "ivf_pq", ti, params=params, mode=mode, dataset=torch.from_numpy(x))
    assert len(eng.warmup("pq", K)) == 5
    off = 0
    for rows in (1, 2, 4, 8, 16):
        fut = eng.submit("pq", q[off : off + rows], K)
        eng.step(force=True)
        res = fut.result()
        dv, di = tivf.search(ti, torch.from_numpy(q[off : off + rows]), K, params, query_batch=rows,
                             mode=mode or "auto", dataset=torch.from_numpy(x))
        assert np.array_equal(res.indices, di.numpy())
        assert np.array_equal(res.distances, dv.numpy())
        assert res.bucket == rows
        off += rows


@pytest.mark.parametrize("kind", ["nibble", "rabitq"])
def test_auto_mode_picks_fused_from_128_queries(corpus, pair, monkeypatch, kind):
    """``auto`` takes the fused kernel from 128 queries on a CUDA index
    only (an f32 LUT request keeps PQ off it); this CPU index takes the
    dense scan from 128 queries (RaBitQ's sign-bit scan too, as JAX) and
    the probe path below."""
    cuda = torch.device("cuda")
    assert ivf_common.auto_search_mode(cuda, 128, True) == "fused"
    assert ivf_common.auto_search_mode(cuda, 127, True) == "probe"
    assert ivf_common.auto_search_mode(cuda, 128, False) == "probe"
    _, q, _ = corpus
    _, _, ti = pair(kind)
    calls = []
    names = (("ivf_rabitq_fused_search", "_ivf_rabitq_scan_impl", "_rabitq_probe_search")
             if kind == "rabitq" else ("ivf_pq_fused_search", "_ivf_pq_scan_impl", "_probe_search"))
    scan = names[1]
    for name in names:
        real = getattr(tivf, name)
        monkeypatch.setattr(tivf, name, lambda *a, _n=name, _f=real, **kw: calls.append(_n) or _f(*a, **kw))
    # what search() asks the rule: the f32 LUT request must clear fused_ok
    asked = []
    rule = ivf_common.auto_search_mode
    monkeypatch.setattr(ivf_common, "auto_search_mode", lambda dev, nq, fused_ok, **kw:
                        asked.append(fused_ok) or rule(dev, nq, fused_ok, **kw))
    probe = names[-1]
    qq = torch.from_numpy(np.concatenate([q, q, q]))  # 144 rows
    p = tivf.IvfPqSearchParams(n_probes=4, refine_ratio=1)
    tivf.search(ti, qq[:127], K, p)
    assert set(calls) == {probe}
    calls.clear()
    tivf.search(ti, qq[:128], K, p)
    assert set(calls) == {scan}
    calls.clear()
    tivf.search(ti, qq[:128], K, dataclasses.replace(p, lut_dtype=torch.float32))
    assert set(calls) == {scan}
    # RaBitQ has no LUT: its kernel stays eligible whatever lut_dtype says
    assert asked == ([True] * 3 if kind == "rabitq" else [True, True, False])


@pytest.mark.parametrize("with_filter", [False, True])
def test_fused_search_keeps_group_tables_on_the_index(corpus, pair, monkeypatch, with_filter):
    """Without a filter, B2's group tables are built at the first fused
    search and handed to every later one, equal to what the wrapper
    builds from the search's ``ln``; a filtered search passes none (the
    wrapper builds them from its own ``ln``)."""
    _, q, _ = corpus
    _, _, ti = pair("nibble")
    ti.__dict__.pop("_fused_group_tables", None)
    built, passed = [], []
    real_tables, real_search = tivf.group_tables, tivf.ivf_pq_fused_search
    monkeypatch.setattr(tivf, "group_tables", lambda v: built.append(1) or real_tables(v))
    monkeypatch.setattr(tivf, "ivf_pq_fused_search",
                        lambda *a, **kw: passed.append(kw["tables"]) or real_search(*a, **kw))
    keep = TBitset.from_mask(torch.from_numpy(np.random.default_rng(5).random(N) < 0.5))
    p = tivf.IvfPqSearchParams(n_probes=4, refine_ratio=1)
    for _ in range(2):
        tivf.search(ti, torch.from_numpy(q), K, p, mode="fused",
                    prefilter=keep if with_filter else None)
    if with_filter:
        assert built == [] and passed == [None, None]
        return
    assert len(built) == 1 and passed[0] is passed[1]
    rank, group = tivf.fused_rank_group(ti, p)
    ci = tpq_scan.code_scan_inputs(ti.centers, ti.centers_rot, rank, ti.rotation, ti.codes,
                                   ti.list_indices, torch.from_numpy(q), None, n_probes=4,
                                   metric=ti.metric, qt=p.fused_qt,
                                   probe_factor=p.fused_probe_factor, group=group)
    ln = tpq_scan.pq_epilogue(ci.valid, ti.rot_sqnorms, ti.metric)
    for kept, fresh in zip(passed[0], real_tables(torch.isfinite(ln))):
        assert torch.equal(kept, fresh)


def test_scan_mode_is_not_ported_yet(corpus, pair):
    """RaBitQ's dense scan (``rabitq_scan_core``) against JAX's
    ``mode="scan"`` on the JAX-built index (``assert_search_equal`` with the
    RaBitQ tolerance of :func:`search_tolerance`); the IVF-Flat scan runs
    too (``tests/test_torch_sharded.py`` holds the PQ and IVF-Flat scans
    against raft_tpu). The name is the one the test had while the RaBitQ
    scan raised."""
    _, q, _ = corpus
    ji, _, ti = pair("rabitq")
    jd, jidx = jivf.search(ji, q, K, jivf.IvfPqSearchParams(n_probes=4, refine_ratio=1),
                           mode="scan")
    td, tidx = tivf.search(ti, torch.from_numpy(q), K,
                           tivf.IvfPqSearchParams(n_probes=4, refine_ratio=1), mode="scan")
    assert_search_equal(td, tidx, jd, jidx, atol=search_tolerance(ti, q))
    flat = tflat.build(corpus[0][:500], tflat.IvfFlatIndexParams(n_lists=8), res=CPU)
    d, i = tflat.search(flat, torch.from_numpy(q), K, mode="scan")
    assert tuple(i.shape) == (NQ, K) and bool((i >= 0).all()) and bool(torch.isfinite(d).all())


def test_fused_rejects_per_cluster_and_warns_on_f32_lut(corpus, pair):
    _, q, _ = corpus
    with pytest.raises(LogicError):
        tivf.search(pair("per_cluster")[2], torch.from_numpy(q), K, mode="fused")
    with pytest.warns(UserWarning, match="bf16"):
        tivf.search(pair("nibble")[2], torch.from_numpy(q), K,
                    tivf.IvfPqSearchParams(n_probes=4, refine_ratio=1, lut_dtype=torch.float32),
                    mode="fused")


def test_params_mirror_jax():
    jd = {f.name: f.default for f in dataclasses.fields(jivf.IvfPqIndexParams)}
    td = {f.name: f.default for f in dataclasses.fields(tivf.IvfPqIndexParams)}
    assert jd.keys() == td.keys()
    assert {k: v for k, v in jd.items() if k != "metric"} == {k: v for k, v in td.items() if k != "metric"}
    js = {f.name: f.default for f in dataclasses.fields(jivf.IvfPqSearchParams)}
    ts = {f.name: f.default for f in dataclasses.fields(tivf.IvfPqSearchParams)}
    assert js == ts
