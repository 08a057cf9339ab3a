"""The port's public surface against raft_tpu's: the package exports
(every name of each JAX ``__all__`` resolves on the port, but for a listed
set still to port), the serving and core API the port lacked (the program
cache's ``keys``/``clear``/``distinct_programs``, the engine's
``cache_capacity``, ``MicroBatcher.drain_expired``, the ``Resources``
registry) and the lock witness's coverage of the serving and core locks.
Each scenario runs in both packages and compares."""
import importlib
import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

from raft_tpu.mutable import MutableIndex as JMutable
from raft_tpu.serve import ServingEngine as JEngine
from raft_tpu.serve import batcher as jbatcher
from raft_tpu.serve import bucketing as jbucketing
from raft_tpu_torch.core import resources as tresources
from raft_tpu_torch.core.errors import LogicError
from raft_tpu_torch.mutable import MutableIndex as TMutable
from raft_tpu_torch.serve import ServingEngine as TEngine
from raft_tpu_torch.serve import batcher as tbatcher
from raft_tpu_torch.serve import bucketing as tbucketing
from raft_tpu_torch.utils import lockcheck as tlockcheck

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIM = 8

#: names of JAX's package ``__all__`` the port leaves out, each with the
#: ROADMAP queue item that ports it (no stubs: they do not resolve)
UNPORTED = {
    "core": {},
    "ops": {},
    "cluster": {},
    "neighbors": {},
    "stats": {},
    "utils": {},
    "serve": {},
    "random": {},
    "linalg": {},
    "matrix": {},
    "label": {},
    "sparse": {},
    "spectral": {},
    "solver": {},
    "": {},
}


@pytest.mark.parametrize("pkg", sorted(UNPORTED), ids=lambda p: p or "root")
def test_package_exports_are_jax_s_minus_the_unported(pkg):
    jmod = importlib.import_module("raft_tpu" + (f".{pkg}" if pkg else ""))
    tmod = importlib.import_module("raft_tpu_torch" + (f".{pkg}" if pkg else ""))
    unported = UNPORTED[pkg]
    assert set(unported) <= set(jmod.__all__)
    assert set(unported.values()) <= {"A7b", "A7c", "A7d"}
    assert set(tmod.__all__) == set(jmod.__all__) - set(unported)
    for name in tmod.__all__:
        got, ref = getattr(tmod, name), getattr(jmod, name)
        assert type(got).__name__ == type(ref).__name__, name
        if callable(ref) and hasattr(ref, "__name__"):
            assert got.__name__ == ref.__name__, name
    for name in unported:
        assert not hasattr(tmod, name), name


def test_import_stays_cheap():
    """Importing every port package loads no kernel library, no triton and
    no JAX."""
    code = (
        "import sys\n"
        "import raft_tpu_torch, raft_tpu_torch.core, raft_tpu_torch.ops, raft_tpu_torch.cluster\n"
        "import raft_tpu_torch.neighbors, raft_tpu_torch.stats, raft_tpu_torch.utils\n"
        "import raft_tpu_torch.serve, raft_tpu_torch.random, raft_tpu_torch.linalg\n"
        "import raft_tpu_torch.matrix, raft_tpu_torch.label\n"
        "import raft_tpu_torch.sparse, raft_tpu_torch.spectral, raft_tpu_torch.solver\n"
        "maps = open('/proc/self/maps').read()\n"
        "print(raft_tpu_torch.Resources.__name__, 'triton' in sys.modules, 'jax' in sys.modules,\n"
        "      'raft_tpu' in sys.modules, 'raft_tpu_torch/_build' in maps)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split() == ["Resources", "False", "False", "False", "False"]


# -- C2: the program cache, the engine's capacity, the batcher, the handle -----------------


def _rows(rng, n):
    return rng.standard_normal((n, DIM)).astype(np.float32)


def _serve_generations(mut, engine, rng):
    engine.register_mutable("live", mut)
    for _ in range(3):
        for m in (1, 3, 5, 8, 2, 7):
            fut = engine.submit("live", _rows(rng, m), k=5)
            engine.run_until_idle()
            assert fut.result().generation == mut.generation
        mut.insert(_rows(rng, 4))
        mut.compact()
    return engine.cache.stats()


def test_distinct_programs_over_generations_match_jax():
    stats = []
    for mk, eng in ((lambda: JMutable("brute_force", DIM), lambda m: JEngine(max_batch=8, max_wait_ms=0.0)),
                    (lambda: TMutable("brute_force", DIM, device="cpu"),
                     lambda m: TEngine(max_batch=8, max_wait_ms=0.0, res=m.res))):
        rng = np.random.default_rng(0)
        mut = mk()
        mut.insert(_rows(rng, 128))
        mut.compact()
        stats.append(_serve_generations(mut, eng(mut), rng))
    j, t = stats
    assert (t.hits, t.misses, t.evictions, t.size) == (j.hits, j.misses, j.evictions, j.size)
    assert t.distinct_programs == j.distinct_programs == t.misses
    assert t.distinct_programs <= 4 * len(tbucketing.bucket_sizes(8))


def test_cache_capacity_evicts_as_jax():
    stats, keys = [], []
    for mk, eng in ((lambda: JMutable("brute_force", DIM),
                     lambda m: JEngine(max_batch=8, max_wait_ms=0.0, cache_capacity=2)),
                    (lambda: TMutable("brute_force", DIM, device="cpu"),
                     lambda m: TEngine(max_batch=8, max_wait_ms=0.0, res=m.res, cache_capacity=2))):
        rng = np.random.default_rng(1)
        mut = mk()
        mut.insert(_rows(rng, 64))
        mut.compact()
        e = eng(mut)
        assert e.cache.capacity == 2
        stats.append(_serve_generations(mut, e, rng))
        keys.append([(k.bucket, k.k, k.generation) for k in e.cache.keys()])
    j, t = stats
    assert (t.hits, t.misses, t.evictions, t.size) == (j.hits, j.misses, j.evictions, j.size)
    assert t.size == 2 and t.evictions > 0
    assert keys[0] == keys[1]


def test_program_cache_keys_and_clear_keep_the_counters():
    out = []
    for mod in (jbucketing, tbucketing):
        cache = mod.ProgramCache(capacity=3)
        built = []
        for b in (1, 2, 4, 1, 8, 2):
            key = mod.ProgramKey("i", "brute_force", b, 10)
            cache.get(key, lambda b=b: built.append(b) or (lambda: b))
        keys = [k.bucket for k in cache.keys()]
        before = cache.stats()
        cache.clear()
        after = cache.stats()
        out.append((keys, built, before, (after.hits, after.misses, after.evictions, after.size),
                    len(cache), cache.keys()))
    (jk, jb, jbefore, jafter, jlen, jkeys), (tk, tb, tbefore, tafter, tlen, tkeys) = out
    assert (tk, tb) == (jk, jb) == ([1, 8, 2], [1, 2, 4, 8, 2])
    assert (tbefore.hits, tbefore.misses, tbefore.evictions, tbefore.size) == (
        jbefore.hits, jbefore.misses, jbefore.evictions, jbefore.size)
    assert tbefore.distinct_programs == jbefore.distinct_programs == 5
    assert tafter == jafter == (1, 5, 2, 0)
    assert tlen == jlen == 0 and tkeys == jkeys == []


def test_drain_expired_rejects_only_the_expired_as_jax():
    results = []
    for mod in (jbatcher, tbatcher):
        t = [10.0]
        b = mod.MicroBatcher(max_batch=8, max_wait_ms=1e6, capacity=64, clock=lambda: t[0])
        reqs = [mod.Request(queries=np.zeros((n, 2), np.float32), k=1, group=("g",),
                            t_arrival=10.0, deadline_s=dl, req_id=100 + i)
                for i, (n, dl) in enumerate([(2, 10.5), (3, None), (1, 10.2), (4, 12.0)])]
        for r in reqs:
            b.offer(r)
        t[0] = 11.0
        expired = b.drain_expired()
        msgs = []
        for r in reqs:
            try:
                r.future.result(timeout=0)
            except TimeoutError:
                msgs.append(None)
            except mod.DeadlineExceeded as e:
                msgs.append(str(e))
        results.append(([r.req_id for r in expired], msgs, b.depth_rows(), b.depth_requests(),
                        [r.req_id for r in b.drain_expired(now=12.5)]))
    assert results[0] == results[1]
    ids, msgs, rows, n, later = results[1]
    assert ids == [100, 102] and rows == 7 and n == 2 and later == [103]
    assert msgs == ["request 100 expired in queue (waited 1000.00 ms)", None,
                    "request 102 expired in queue (waited 1000.00 ms)", None]


def test_resources_registry_and_mesh_predicate():
    res = tresources.Resources(device="cpu")
    assert not res.has_mesh()
    assert tresources.Resources(device="cpu", mesh=object()).has_mesh()
    with pytest.raises(KeyError):
        res.get_resource("workspace")
    made = []
    first = res.get_resource("workspace", lambda: made.append(1) or {"bytes": 1})
    assert res.get_resource("workspace", lambda: made.append(2) or {}) is first
    assert made == [1]
    res.set_resource("workspace", 7)
    assert res.get_resource("workspace") == 7
    # the factory runs once under the handle's lock when threads race
    calls = []
    barrier = threading.Barrier(8)

    def fetch():
        barrier.wait()
        res.get_resource("shared", lambda: calls.append(1) or object())

    threads = [threading.Thread(target=fetch) for _ in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=30)
    assert calls == [1]
    with pytest.raises(LogicError):
        res.get_mesh()


# -- C3: the serving and core locks under the witness ------------------------------------------


def test_lock_witness_tracks_the_serving_and_core_locks():
    was = tlockcheck.is_enabled()
    tlockcheck.enable()
    try:
        got = {
            tbatcher.MicroBatcher()._lock.name,
            tbucketing.ProgramCache()._lock.name,
            tresources.Resources(device="cpu")._lock.name,
        }
    finally:
        tlockcheck.enable(was)
        tlockcheck.reset()
    assert got == {"serve.batcher", "serve.program_cache", "core.resources"}


_INVERSION = r"""
import json, threading
import numpy as np
from raft_tpu.serve import batcher as jb
from raft_tpu.utils import lockcheck as jl
from raft_tpu_torch.core import resources as tr
from raft_tpu_torch.serve import batcher as tb
from raft_tpu_torch.utils import lockcheck as tl
out = {}
for name, lc, mod in (("jax", jl, jb), ("port", tl, tb)):
    assert lc.is_enabled()
    lc.reset()
    batcher = mod.MicroBatcher(max_batch=4, capacity=16)
    group = lc.tracked(threading.Lock(), "replica.group")
    batcher.depth_rows()
    with group:  # a pump holding the group's lock reaches into the queue
        batcher.depth_rows()
    out[name] = {"edges": sorted(lc.edges()), "violations": lc.violations()}
out["default_lock"] = tr._default_lock.name
print(json.dumps(out))
"""


def test_lockcheck_reports_an_inversion_through_the_batcher_as_jax():
    env = dict(os.environ, RAFT_TPU_LOCKCHECK="1")
    env.pop("RAFT_TPU_LOCKCHECK_MANIFEST", None)
    out = subprocess.run([sys.executable, "-c", _INVERSION], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    rep = json.loads(out.stdout.strip().splitlines()[-1])
    assert rep["default_lock"] == "core.resources_default"
    for name in ("jax", "port"):
        assert rep[name]["edges"] == [["replica.group", "serve.batcher"]], rep
        assert len(rep[name]["violations"]) == 1, rep
        assert "replica.group -> serve.batcher" in rep[name]["violations"][0]
