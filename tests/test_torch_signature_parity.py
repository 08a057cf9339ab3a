"""Keyword parity of the port's public functions with raft_tpu's.

For every public function, and every public method of every public class,
of every ported module of the JAX package, JAX's parameter names must be
found among the port's, so that a call written against the JAX package
does not raise ``TypeError`` in the port. The only exceptions are the
differences by design that :func:`design` lists (ROADMAP C). Then the
keywords this parity added: the scan cores' ``has_filter`` (``False``
ignores ``filter_bits``, as JAX does) and the tile hints ``tile`` and
``center_tile``, which change no bit."""
import importlib
import inspect
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.cluster import kmeans as jkmeans
from raft_tpu.neighbors import ivf_flat as jflat
from raft_tpu.neighbors import ivf_pq as jpq
from raft_tpu.ops import fused_1nn as jnn
from raft_tpu.ops.distance import DistanceType as JDT
from raft_tpu_torch.cluster import kmeans as tkmeans
from raft_tpu_torch.neighbors import ivf_flat as tflat
from raft_tpu_torch.neighbors import ivf_pq as tpq
from raft_tpu_torch.ops import fused_1nn as tnn
from raft_tpu_torch.ops.distance import DistanceType as TDT

JAX_ROOT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "raft_tpu")

#: modules of the JAX package the port leaves out: the Pallas kernels
#: (ported as ``ops/*.py`` + ``csrc/*.cu``), the ``shard_map`` shim and the
#: fallback (the port has none)
NOT_PORTED = ("ops.pallas", "parallel._compat", "robust.fallback")


def jax_modules():
    """Dotted names (relative to the package) of every ported JAX module."""
    out = []
    for dirpath, _, files in os.walk(JAX_ROOT):
        for f in files:
            if not f.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(dirpath, f), JAX_ROOT)[:-3].replace(os.sep, ".")
            if rel == "__init__":
                rel = ""
            elif rel.endswith(".__init__"):
                rel = rel[: -len(".__init__")]
            if any(rel == p or rel.startswith(p + ".") for p in NOT_PORTED):
                continue
            out.append(rel)
    return sorted(out)


MODULES = jax_modules()


def design(module: str, qualname: str, param: str, port_params) -> bool:
    """The differences by design (ROADMAP C4): the five listed, no more.
    ``param`` None means the port lacks the whole method."""
    method = qualname.rpartition(".")[2]
    return (
        # the PRNG key: the port draws from a torch.Generator
        (param == "key" and (module, qualname) == ("cluster.kmeans", "kmeans_plus_plus"))
        or (param is None and (module, qualname) == ("core.resources", "Resources.next_key"))
        # the pytree hooks: the port's indexes are no pytrees
        or (param is None and method in ("tree_flatten", "tree_unflatten"))
        # the comms verbs take per-shard lists
        or (module == "parallel.comms" and param == "x" and "xs" in port_params)
        # the distributed Lloyd step keeps one cache a shard
        or (module == "parallel.sharded_ann" and qualname == "dist_lloyd_step"
            and param == "cache" and "caches" in port_params)
        # the device predicate
        or (param == "on_tpu" and "on_cuda" in port_params)
    )


def _params(obj):
    return list(inspect.signature(obj).parameters)


def public_callables(mod):
    """``{qualname: callable}`` of the functions, classes' methods
    (``__init__`` included) and static/class methods defined in ``mod``."""
    out = {}
    for name, obj in vars(mod).items():
        if name.startswith("_") or getattr(obj, "__module__", None) != mod.__name__:
            continue
        if inspect.isclass(obj):
            for mname, m in vars(obj).items():
                if mname.startswith("_") and mname != "__init__":
                    continue
                f = m.__func__ if isinstance(m, (staticmethod, classmethod)) else m
                if inspect.isfunction(f) or (callable(f) and hasattr(f, "__wrapped__")):
                    out[f"{name}.{mname}"] = f
        elif callable(obj):
            out[name] = obj
    return out


def gaps(rel: str):
    """``(module, qualname, param)`` of each JAX parameter the port lacks
    (``param`` None: the port lacks the callable)."""
    jmod = importlib.import_module("raft_tpu" + (f".{rel}" if rel else ""))
    tmod = importlib.import_module("raft_tpu_torch" + (f".{rel}" if rel else ""))
    out = []
    for qualname, jf in public_callables(jmod).items():
        owner, _, method = qualname.partition(".")
        tobj = getattr(tmod, owner, None)
        if method and tobj is not None:
            tobj = getattr(tobj, method, None)
        if tobj is None:
            out.append((rel, qualname, None, ()))
            continue
        tp = _params(tobj)
        out.extend((rel, qualname, p, tp) for p in _params(jf)
                   if p not in tp and p not in ("self", "cls"))
    return out


@pytest.mark.parametrize("rel", MODULES, ids=lambda r: r or "root")
def test_jax_keywords_are_the_port_s(rel):
    missing = [(q, p) for m, q, p, tp in gaps(rel) if not design(m, q, p, tp)]
    assert missing == [], f"raft_tpu_torch.{rel} lacks {missing}"


def test_the_exceptions_are_the_five_by_design():
    """Every exception the walk meets is one of the five kinds, and each
    kind is met: none is stale."""
    used = set()
    for rel in MODULES:
        for m, q, p, tp in gaps(rel):
            if not design(m, q, p, tp):
                continue
            if p is None:
                used.add("next_key" if q.endswith("next_key") else "tree_flatten")
            else:
                used.add({"x": "comms_x", "cache": "cache", "on_tpu": "on_tpu"}.get(p, p))
    assert used == {"key", "next_key", "tree_flatten", "comms_x", "cache", "on_tpu"}


def test_the_walk_covers_the_bench_and_leaves_out_only_by_design():
    assert {"bench", "bench.datasets", "bench.harness", "bench.loadgen", "bench.configs",
            "bench.prims", "bench.data_export", "bench.plot", "bench.__main__"} <= set(MODULES)
    assert not any(r.startswith("ops.pallas") for r in MODULES)
    assert "parallel._compat" not in MODULES and "robust.fallback" not in MODULES


# -- has_filter: False ignores filter_bits, in both packages -------------------------------


def _scan_inputs(seed: int = 0):
    rng = np.random.default_rng(seed)
    n_lists, max_list, nq, n_rows = 8, 16, 6, 100
    ids = np.full((n_lists, max_list), -1, np.int32)
    perm = rng.permutation(n_rows).astype(np.int32)
    ids.reshape(-1)[: n_rows] = perm  # the last lists' tails stay empty
    ids = ids.reshape(n_lists, max_list)
    probed = rng.random((nq, n_lists)) < 0.6
    probed[:, 0] = True
    bits = rng.integers(0, 2 ** 32, size=(n_rows + 31) // 32, dtype=np.uint64).astype(np.uint32)
    return rng, ids, probed, bits


def _both(jfn, tfn, jargs, targs, kw):
    """Each package's core (L2) with the bits ignored, with no bits, and
    with the bits applied (to show that they would filter)."""
    out = {}
    for name, fn, args, metric, bits_of in (
            ("jax", jfn, jargs, JDT.L2Expanded, jnp.asarray),
            ("torch", tfn, targs, TDT.L2Expanded,
             lambda b: torch.from_numpy(b.view(np.int32).copy()))):
        *head, bits = args
        ignored = fn(*head, bits_of(bits), metric=metric, has_filter=False, **kw)
        none = fn(*head, None, metric=metric, has_filter=False, **kw)
        applied = fn(*head, bits_of(bits), metric=metric, has_filter=True, **kw)
        out[name] = [(np.asarray(d), np.asarray(i)) for d, i in (ignored, none, applied)]
    return out


def _check(out):
    for name in ("jax", "torch"):
        (di, ii), (dn, inn), (_, ia) = out[name]
        np.testing.assert_array_equal(ii, inn)
        np.testing.assert_array_equal(di, dn)
        assert not np.array_equal(ii, ia), f"{name}: the bits filter nothing"
    np.testing.assert_array_equal(out["torch"][0][1], out["jax"][0][1])
    np.testing.assert_allclose(out["torch"][0][0], out["jax"][0][0], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(out["torch"][2][1], out["jax"][2][1])


def test_flat_scan_core_has_filter_false_ignores_the_bits():
    rng, ids, probed, bits = _scan_inputs(0)
    d = 8
    data = rng.standard_normal((ids.shape[0], ids.shape[1], d)).astype(np.float32)
    norms = (data * data).sum(-1).astype(np.float32)
    qf = rng.standard_normal((probed.shape[0], d)).astype(np.float32)
    out = _both(
        jflat.flat_scan_core, tflat.flat_scan_core,
        [jnp.asarray(a) for a in (data, ids, norms, qf, probed)] + [bits],
        [torch.from_numpy(a) for a in (data, ids, norms, qf, probed)] + [bits],
        {"k": 5, "chunk_lists": 4},
    )
    _check(out)


def test_pq_scan_core_has_filter_false_ignores_the_bits():
    rng, ids, probed, bits = _scan_inputs(1)
    pq_dim, ksub, pq_len = 4, 16, 2
    books = rng.standard_normal((pq_dim, ksub, pq_len)).astype(np.float32)
    codes = rng.integers(0, ksub, size=ids.shape + (pq_dim,), dtype=np.uint8)
    sqn = rng.random(ids.shape).astype(np.float32) * 4
    q_rot = rng.standard_normal((probed.shape[0], pq_dim * pq_len)).astype(np.float32)
    q_dot_c = rng.standard_normal((probed.shape[0], ids.shape[0])).astype(np.float32)
    arrays = (books, codes, ids, sqn, q_rot, q_dot_c, probed)
    out = _both(
        jpq.pq_scan_core, tpq.pq_scan_core,
        [jnp.asarray(a) for a in arrays] + [bits], [torch.from_numpy(a) for a in arrays] + [bits],
        {"k": 5, "per_cluster": False, "chunk_lists": 4, "bf16": False},
    )
    _check(out)


def test_rabitq_scan_core_has_filter_false_ignores_the_bits():
    rng, ids, probed, bits = _scan_inputs(2)
    rot_dim = 16
    codes = rng.integers(0, 256, size=ids.shape + (rot_dim // 8,), dtype=np.uint8)
    corr = (rng.random(ids.shape) + 0.5).astype(np.float32)
    sqn = rng.random(ids.shape).astype(np.float32) * 4
    q_rot = rng.standard_normal((probed.shape[0], rot_dim)).astype(np.float32)
    q_dot_c = rng.standard_normal((probed.shape[0], ids.shape[0])).astype(np.float32)
    arrays = (codes, corr, ids, sqn, q_rot, q_dot_c, probed)
    out = _both(
        jpq.rabitq_scan_core, tpq.rabitq_scan_core,
        [jnp.asarray(a) for a in arrays] + [bits], [torch.from_numpy(a) for a in arrays] + [bits],
        {"k": 5, "chunk_lists": 4},
    )
    _check(out)


def test_has_filter_is_a_required_keyword():
    for fn in (tflat.flat_scan_core, tpq.pq_scan_core, tpq.rabitq_scan_core):
        p = inspect.signature(fn).parameters["has_filter"]
        assert p.kind is inspect.Parameter.KEYWORD_ONLY and p.default is inspect.Parameter.empty


# -- the tile hints change no bit ---------------------------------------------------------


def test_tile_hints_change_no_bit():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((300, 16)).astype(np.float32)
    c = rng.standard_normal((200, 16)).astype(np.float32)
    xt, ct = torch.from_numpy(x), torch.from_numpy(c)

    v1, i1 = tnn.fused_l2_nn(xt, ct, tile=128)
    v2, i2 = tnn.fused_l2_nn(xt, ct, tile=4096)
    assert torch.equal(v1, v2) and torch.equal(i1, i2)
    jv, ji = jnn.fused_l2_nn(x, c, tile=128)
    np.testing.assert_array_equal(i1.numpy(), np.asarray(ji))
    np.testing.assert_allclose(v1.numpy(), np.asarray(jv), rtol=1e-4, atol=1e-4)

    for metric, jmetric in ((TDT.L2Expanded, JDT.L2Expanded),
                            (TDT.InnerProduct, JDT.InnerProduct),
                            (TDT.CosineExpanded, JDT.CosineExpanded)):
        l1, d1 = tnn.min_cluster_and_distance(xt, ct, metric, tile=128)
        l2, d2 = tnn.min_cluster_and_distance(xt, ct, metric, tile=4096)
        assert torch.equal(l1, l2) and torch.equal(d1, d2)
        jl, _ = jnn.min_cluster_and_distance(x, c, jmetric, tile=128)
        np.testing.assert_array_equal(l1.numpy(), np.asarray(jl))

        f1 = tkmeans.flash_min_cluster_and_distance(xt, ct, metric, center_tile=64)
        f2 = tkmeans.flash_min_cluster_and_distance(xt, ct, metric, center_tile=512)
        assert torch.equal(f1[0], f2[0]) and torch.equal(f1[1], f2[1])
        jf = jkmeans.flash_min_cluster_and_distance(x, c, jmetric, center_tile=64)
        np.testing.assert_array_equal(f1[0].numpy(), np.asarray(jf[0]))
