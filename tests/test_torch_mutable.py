"""The mutable index of the port against raft_tpu, on the CPU.

* The WAL: the same records encode to the same bytes in both packages, a
  log written by either replays in the other, and torn or damaged logs
  recover the same prefix (the damage cases of ``tests/test_mutable.py``).
* The manifest: the same JSON; a newer format is rejected.
* A directory written by either package (``brute_force`` and ``ivf_flat``,
  after inserts, deletes, upserts and a compaction) opens in the other with
  the same live rows, ``next_id``, generation and search results; IVF-Flat
  searches its main segment with explicit ``mode="fused"`` in both (B1's
  plain version here, the Pallas kernel in interpret mode there).
* The same operations in memory give the same results in both packages.
* The fused delta route: the port's plain B1, one launch over every bank,
  against JAX's Pallas B1 in interpret mode, at one and two banks, for the
  three metrics, with tombstones and padding.
* The port's own contracts: crash recovery at every seam (an exception at
  the seam, and a child process that dies at it), background compaction,
  serving through ``register_mutable``, the obs names of a mutable run,
  and ``KernelFailure`` raising through the delta and main scans and the
  engine, never falling back.

Tolerances: ids equal exactly (the data has no ties); distances
``allclose(rtol=1e-5, atol=1e-5)`` across packages (both add in f32, in
different orders), bit-equal within the port where the same code runs.
"""
import dataclasses
import os
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from raft_tpu import obs as jobs
from raft_tpu.mutable import MutableIndex as JMut
from raft_tpu.mutable import WalRecord as JRec
from raft_tpu.mutable import WriteAheadLog as JWal
from raft_tpu.mutable import manifest as jman
from raft_tpu.mutable import maintenance as jmaint
from raft_tpu.mutable import replay as jreplay
from raft_tpu.neighbors import ivf_flat as jivf
from raft_tpu.ops.distance import DistanceType as JDT
from raft_tpu.robust import faults as jfaults
from raft_tpu_torch import obs as tobs
from raft_tpu_torch.core.errors import KernelFailure, LogicError
from raft_tpu_torch.mutable import (
    CompactionPolicy,
    Compactor,
    MutableIndex,
    WalRecord,
    WriteAheadLog,
    compact_background,
    replay,
    segment_paths,
)
from raft_tpu_torch.mutable import maintenance as tmaint
from raft_tpu_torch.mutable import manifest as tman
from raft_tpu_torch.mutable import segments as tseg
from raft_tpu_torch.neighbors import ivf_flat as tivf
from raft_tpu_torch.ops.distance import DistanceType
from raft_tpu_torch.robust import faults
from raft_tpu_torch.serve import ServingEngine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIM = 16
METRICS = {"l2": "L2Expanded", "l2sqrt": "L2SqrtExpanded", "ip": "InnerProduct"}


class Kill(RuntimeError):
    """Stand-in for the process dying at a seam."""


def _rows(rng, n):
    return rng.standard_normal((n, DIM)).astype(np.float32)


def tmut(algo="brute_force", **kw):
    return MutableIndex(algo, DIM, device="cpu", **kw)


def topen(d, algo="brute_force", **kw):
    return MutableIndex.open(d, algo, DIM, device="cpu", **kw)


def assert_same_search(t, j):
    """ids equal; distances allclose across packages."""
    np.testing.assert_array_equal(np.asarray(t[1]), np.asarray(j[1]))
    np.testing.assert_allclose(np.asarray(t[0]), np.asarray(j[0]), rtol=1e-5, atol=1e-5)


# -- the WAL ------------------------------------------------------------------------


def _records(rng, mod):
    v = _rows(rng, 5)
    return [
        mod(op="insert", ids=np.arange(5, dtype=np.int64), vectors=v),
        mod(op="delete", ids=np.array([1, 3, 77], np.int64)),
        mod(op="upsert", ids=np.array([2, 900], np.int64), vectors=v[:2] * 2),
        mod(op="insert", ids=np.zeros((0,), np.int64), vectors=np.zeros((0, DIM), np.float32)),
        mod(op="delete", ids=np.zeros((0,), np.int64)),
    ]


def test_wal_frames_are_byte_identical(tmp_path):
    t_recs = _records(np.random.default_rng(1), WalRecord)
    j_recs = _records(np.random.default_rng(1), JRec)
    for t, j in zip(t_recs, j_recs):
        assert t.encode() == j.encode()
    paths = []
    for name, log_cls, recs in (("t", WriteAheadLog, t_recs), ("j", JWal, j_recs)):
        path = str(tmp_path / f"{name}.log")
        log, _ = log_cls.open(path)
        for r in recs:
            log.append(r)
        log.close()
        paths.append(path)
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert a.read() == b.read()


def _same_records(a, b):
    assert [r.op for r in a] == [r.op for r in b]
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x.ids), np.asarray(y.ids))
        assert (x.vectors is None) == (y.vectors is None)
        if x.vectors is not None:
            np.testing.assert_array_equal(np.asarray(x.vectors), np.asarray(y.vectors))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_wal_replays_across_packages(tmp_path, writer):
    rng = np.random.default_rng(2)
    w_cls, w_rec, r_replay, r_open = (
        (JWal, JRec, replay, WriteAheadLog.open) if writer == "jax"
        else (WriteAheadLog, WalRecord, jreplay, JWal.open))
    path = str(tmp_path / "wal.log")
    log, _ = w_cls.open(path, max_bytes=900)
    recs = [w_rec(op="insert", ids=np.array([i], np.int64), vectors=_rows(rng, 1))
            for i in range(6)] + _records(rng, w_rec)
    for r in recs:
        log.append(r)
    log.close()
    log2, got = r_open(path, max_bytes=900)
    log2.close()
    _same_records(got, recs)
    seg0, good = r_replay(path)
    assert good == os.path.getsize(path) and len(seg0) >= 1


def _damaged_log(rng, path, damage):
    """A JAX-written log at ``path`` damaged as ``tests/test_mutable.py``
    damages it; returns max_bytes for the reopen."""
    if damage in ("truncate", "garbage", "bitflip"):
        log, _ = JWal.open(path)
        for i in range(3):
            log.append(JRec(op="insert", ids=np.array([i], np.int64), vectors=_rows(rng, 1)))
        log.close()
        with open(path, "rb") as f:
            data = f.read()
        cut = 2 * (len(data) // 3)
        if damage == "truncate":
            torn = data[: cut + 5]
        elif damage == "garbage":
            torn = data[:cut] + b"\xde\xad\xbe\xef" + data[cut + 4 :]
        else:
            torn = data[: cut + 15] + bytes([data[cut + 15] ^ 0x01]) + data[cut + 16 :]
        with open(path, "wb") as f:
            f.write(torn)
        return None
    log, _ = JWal.open(path, max_bytes=1200)
    for i in range(20):
        log.append(JRec(op="insert", ids=np.array([i], np.int64), vectors=_rows(rng, 1)))
    segs = log.segment_paths()
    log.close()
    target = segs[-1] if damage == "active_tear" else segs[2]
    with open(target, "rb") as f:
        data = f.read()
    with open(target, "wb") as f:
        f.write(data[: -3 if damage == "active_tear" else -5])
    return 1200


@pytest.mark.parametrize("damage", ["truncate", "garbage", "bitflip", "active_tear",
                                    "sealed_tear"])
def test_torn_logs_recover_the_same_prefix(tmp_path, damage):
    rng = np.random.default_rng(3)
    src = tmp_path / "src"
    src.mkdir()
    max_bytes = _damaged_log(rng, str(src / "wal.log"), damage)
    out = {}
    for name, cls, rec in (("jax", JWal, JRec), ("port", WriteAheadLog, WalRecord)):
        d = tmp_path / name
        shutil.copytree(src, d)
        log, recs = cls.open(str(d / "wal.log"), max_bytes=max_bytes)
        seg = log.segment
        log.append(rec(op="delete", ids=np.array([0], np.int64)))
        log.close()
        files = {}
        for f in sorted(os.listdir(d)):
            with open(d / f, "rb") as fh:
                files[f] = fh.read()
        out[name] = ([int(r.ids[0]) for r in recs], seg, files)
    assert out["port"] == out["jax"]
    assert len(out["port"][0]) < (3 if max_bytes is None else 20)


# -- the manifest ----------------------------------------------------------------------


def test_manifest_json_and_swap_match_jax(tmp_path):
    kw = dict(generation=3, algo="ivf_flat", dim=DIM, main="gen-00000003/main.idx",
              rows="gen-00000003/rows.bin", wal="wal-00000003.log", next_id=1234)
    t, j = tman.Manifest(**kw), jman.Manifest(**kw)
    assert t.to_json() == j.to_json()
    assert tman.Manifest.from_json(j.to_json()) == t
    tman.swap(str(tmp_path / "t"), t)
    jman.swap(str(tmp_path / "j"), j)
    with open(tmp_path / "t" / tman.FILENAME) as a, open(tmp_path / "j" / jman.FILENAME) as b:
        assert a.read() == b.read()
    assert tman.read(str(tmp_path / "j")) == t
    assert tman.read(str(tmp_path / "absent")) is None


def test_newer_manifest_format_is_rejected(tmp_path):
    doc = tman.Manifest(generation=0, algo="brute_force", dim=DIM, main=None, rows=None,
                        wal="wal-00000000.log")
    text = doc.to_json().replace('"format": 1', '"format": 2')
    with pytest.raises(ValueError, match="newer than supported"):
        tman.Manifest.from_json(text)
    os.makedirs(tmp_path / "d")
    with open(tmp_path / "d" / tman.FILENAME, "w") as f:
        f.write(text)
    with pytest.raises(ValueError):
        topen(str(tmp_path / "d"))


# -- directories across packages ---------------------------------------------------------

IVF_LISTS = 16
JP = jivf.IvfFlatSearchParams(n_probes=4, fused_qt=8, fused_merge="exact")
TP = tivf.IvfFlatSearchParams(n_probes=4, fused_qt=8)


def _churn(mut, rng):
    """The writer's history: inserts, a compaction, then deletes of main
    and delta rows and upserts of main and new ids, left in the WAL."""
    data = _rows(rng, 700)
    ids = mut.insert(data)
    mut.compact()
    extra = mut.insert(_rows(rng, 40))
    mut.delete(np.concatenate([ids[:30], extra[:5], [10**6]]))
    mut.upsert(np.array([int(ids[40]), int(extra[7]), 5000]), _rows(rng, 3))
    return data


def _open_pair(algo, d, writer):
    if writer == "jax":
        kw = {"index_params": jivf.IvfFlatIndexParams(n_lists=IVF_LISTS)} if algo == "ivf_flat" else {}
        return JMut.open(d, algo, DIM, **kw)
    kw = {"index_params": tivf.IvfFlatIndexParams(n_lists=IVF_LISTS)} if algo == "ivf_flat" else {}
    return topen(d, algo, **kw)


def _search(mut, q, algo, package):
    if algo != "ivf_flat":
        return mut.search(q, 10)
    return mut.search(q, 10, params=JP if package == "jax" else TP, mode="fused")


@pytest.mark.parametrize("algo", ["brute_force", "ivf_flat"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_directory_opens_in_the_other_package(tmp_path, algo, writer):
    rng = np.random.default_rng(4)
    d = str(tmp_path / "idx")
    reader = "port" if writer == "jax" else "jax"
    w = _open_pair(algo, d, writer)
    _churn(w, rng)
    q = _rows(rng, 24)
    want = _search(w, q, algo, writer)
    want_rows = w.live_rows()
    want_meta = (w.next_id, w.generation, w.size)
    w.close()
    r = _open_pair(algo, d, reader)
    try:
        got_rows = r.live_rows()
        np.testing.assert_array_equal(got_rows[0], want_rows[0])
        np.testing.assert_array_equal(got_rows[1], want_rows[1])
        assert (r.next_id, r.generation, r.size) == want_meta == (5001, 1, 706)
        assert_same_search(_search(r, q, algo, reader), want)
        # the reader carries on: a mutation and a compaction the writer
        # reads back
        r.insert(_rows(rng, 2))
        assert r.compact() == 2
        after = _search(r, q, algo, reader)
        after_rows = r.live_rows()
    finally:
        r.close()
    w2 = _open_pair(algo, d, writer)
    try:
        assert w2.generation == 2 and w2.next_id == 5003
        np.testing.assert_array_equal(w2.live_rows()[0], after_rows[0])
        assert_same_search(_search(w2, q, algo, writer), after)
    finally:
        w2.close()


# -- the same operations in memory ---------------------------------------------------------


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_same_operations_in_memory_match_jax(metric):
    m = METRICS[metric]
    t, j = tmut(metric=DistanceType[m]), JMut("brute_force", DIM, metric=JDT[m])
    rng = np.random.default_rng(5)
    data, q = _rows(rng, 60), _rows(rng, 7)
    outs = []

    def both(fn):
        outs.append((fn(t), fn(j)))

    both(lambda mu: mu.search(q, 4))  # empty index
    both(lambda mu: (mu.insert(data), np.zeros(1))[::-1])
    both(lambda mu: mu.search(q, 5))
    both(lambda mu: (mu.delete(np.arange(0, 60, 3)), np.zeros(1))[::-1])
    both(lambda mu: mu.search(q, 100))  # k larger than the size pads
    snaps = (t.snapshot(), j.snapshot())
    both(lambda mu: (mu.upsert(np.array([1, 2, 500]), data[:3] + 1), np.zeros(1))[::-1])
    outs.append((snaps[0].search(q, 5), snaps[1].search(q, 5)))  # isolation
    both(lambda mu: mu.search(q, 5))
    both(lambda mu: (np.zeros(1), np.asarray([mu.compact()])))
    both(lambda mu: mu.search(q, 8))
    both(lambda mu: (mu.insert(_rows(np.random.default_rng(6), 9)), np.zeros(1))[::-1])
    both(lambda mu: mu.search(q, 8))
    both(lambda mu: mu.live_rows()[::-1])
    for tt, jj in outs:
        assert_same_search(tt, jj)
    assert (t.size, t.next_id, t.generation, t.version) == (j.size, j.next_id, j.generation,
                                                           j.version)


# -- the fused delta route -----------------------------------------------------------------


@pytest.fixture(scope="module")
def delta_pair():
    """(metric, banks) -> (port snapshot, JAX snapshot) of a delta-only
    index with tombstones, both fused."""
    built = {}

    def get(metric, banks):
        key = (metric, banks)
        if key not in built:
            rng = np.random.default_rng(7)
            rows = _rows(rng, 300 if banks == 1 else 1300)
            m = METRICS[metric]
            t, j = tmut(metric=DistanceType[m]), JMut("brute_force", DIM, metric=JDT[m])
            for mu in (t, j):
                ids = mu.insert(rows)
                mu.delete(np.concatenate([ids[5:45], ids[-3:]]))
            built[key] = tuple(dataclasses.replace(mu.snapshot(), delta_mode="fused")
                               for mu in (t, j))
        return built[key]

    return get


@pytest.mark.parametrize("metric", list(METRICS))
@pytest.mark.parametrize("banks", [1, 2])
def test_fused_delta_matches_jax_pallas(delta_pair, metric, banks, monkeypatch):
    from raft_tpu_torch.ops import ivf_scan

    ts, js = delta_pair(metric, banks)
    assert int(ts.delta_bf.size) == (512 if banks == 1 else 2048)  # padding rows
    calls = []
    real = ivf_scan.fused_list_topk

    def counted(list_data, *a, **kw):
        calls.append(tuple(list_data.shape))
        return real(list_data, *a, **kw)

    monkeypatch.setattr(ivf_scan, "fused_list_topk", counted)
    q = _rows(np.random.default_rng(8), 33)  # not a whole tile: padded queries
    got = ts.search(q, 10)
    assert calls == [(banks, 512 if banks == 1 else 1024, DIM)]  # one launch, every bank
    assert_same_search(got, js.search(q, 10))
    exact = dataclasses.replace(ts, delta_mode="exact").search(q, 10)
    np.testing.assert_array_equal(got[1], exact[1])
    assert not np.isin(got[1], ts.delta_ids[5:45]).any()


def test_fused_delta_with_fewer_live_rows_than_k():
    mut = tmut(metric=DistanceType.L2Expanded)
    ids = mut.insert(_rows(np.random.default_rng(9), 40))
    mut.delete(ids[3:])
    snap = dataclasses.replace(mut.snapshot(), delta_mode="fused")
    d, i = snap.search(_rows(np.random.default_rng(10), 2), 8)
    assert set(i[:, :3].ravel()) <= {0, 1, 2}
    assert (i[:, 3:] == -1).all() and np.isinf(d[:, 3:]).all()


def test_delta_routing_and_eligibility():
    l2 = DistanceType.L2Expanded
    over = tseg._DELTA_FUSED_MAX_ROWS * tseg._DELTA_FUSED_MAX_BANKS * 2
    assert tseg._delta_route("exact", l2, 256, 10, "cuda") == "exact"
    assert tseg._delta_route("fused", l2, 2048, 10) == "fused"
    assert tseg._delta_route("auto", l2, 32768, 128, torch.device("cuda")) == "fused"
    assert tseg._delta_route("auto", l2, 32768, 10, "cpu") == "exact"  # JAX off a TPU: exact
    assert tseg._delta_route("auto", l2, over, 10, "cuda") == "exact"
    assert tseg._delta_route("auto", DistanceType.CosineExpanded, 256, 10, "cuda") == "exact"
    for args in (("fused", l2, over, 10), ("fused", l2, 256, 129), ("bogus", l2, 256, 10)):
        with pytest.raises(LogicError):
            tseg._delta_route(*args)
    with pytest.raises(LogicError):
        tmut(delta_mode="bogus")
    # the window is the JAX package's
    from raft_tpu.mutable import segments as jseg

    for name in ("_DELTA_FUSED_MAX_ROWS", "_DELTA_FUSED_QT", "_DELTA_FUSED_MAX_BANKS"):
        assert getattr(tseg, name) == getattr(jseg, name)


def test_kernel_failure_raises_through_delta_main_and_engine(monkeypatch):
    """No fallback: a failed B1 launch in the delta or main scan raises
    KernelFailure out of Snapshot.search and fails the served batch."""
    from raft_tpu_torch.neighbors import brute_force
    from raft_tpu_torch.ops import ivf_scan

    rng = np.random.default_rng(11)
    mut = tmut("ivf_flat", index_params=tivf.IvfFlatIndexParams(n_lists=8), delta_mode="fused",
               search_params=TP)
    mut.insert(_rows(rng, 400))
    mut.compact()
    mut.insert(_rows(rng, 20))
    q = _rows(rng, 4)

    def failed(*a, **kw):
        raise KernelFailure("ivf_scan kernel launch failed (cudaError 700)")

    def must_not_run(*a, **kw):
        raise AssertionError("the exact delta scan ran after a kernel failure")

    monkeypatch.setattr(ivf_scan, "fused_list_topk", failed)
    monkeypatch.setattr(brute_force, "search", must_not_run)
    with pytest.raises(KernelFailure):
        mut.search(q, 5)
    eng = ServingEngine(max_batch=8, max_wait_ms=0.0, res=mut.res)
    eng.register_mutable("live", mut)
    fut = eng.submit("live", q, k=5)
    eng.run_until_idle()
    with pytest.raises(KernelFailure):
        fut.result()
    monkeypatch.undo()
    monkeypatch.setattr(tivf, "ivf_flat_fused_search", failed)
    with pytest.raises(KernelFailure):
        mut.search(q, 5, mode="fused")


# -- crash recovery in the port -------------------------------------------------------------


def _state(mut_or_dir, queries, k=5):
    if isinstance(mut_or_dir, MutableIndex):
        return mut_or_dir.search(queries, k)
    m = topen(mut_or_dir)
    try:
        return m.search(queries, k)
    finally:
        m.close()


def _same(a, b):
    return np.array_equal(a[1], b[1]) and np.allclose(a[0], b[0], rtol=1e-5, atol=1e-6)


@pytest.fixture(params=[None, 600], ids=["wal-single", "wal-rotated"])
def seeded(rng, tmp_path, request):
    """A durable index: 64 main rows (generation 1) and 8 delta rows."""
    d = str(tmp_path / "idx")
    mut = topen(d, max_wal_bytes=request.param)
    data = _rows(rng, 64)
    ids = mut.insert(data)
    mut.compact()
    extra = mut.insert(_rows(rng, 8))
    return dict(d=d, mut=mut, data=data, ids=ids, extra=extra, queries=_rows(rng, 4),
                up_rows=_rows(rng, 3))


def _mutations(s):
    return {
        "insert": lambda m: m.insert(s["data"][:3] + 0.25),
        "delete": lambda m: m.delete(np.concatenate([s["ids"][:5], s["extra"][:2]])),
        "upsert": lambda m: m.upsert(
            np.array([int(s["ids"][1]), int(s["extra"][0]), 999]), s["up_rows"]),
    }


def _post_state(s, op):
    replica = tmut()
    live_ids, live_vecs = s["mut"].live_rows()
    replica.insert(live_vecs, ids=live_ids)
    replica.next_id = s["mut"].next_id
    _mutations(s)[op](replica)
    return _state(replica, s["queries"])


@pytest.mark.parametrize("op", ["insert", "delete", "upsert"])
@pytest.mark.parametrize("stage", ["pre", "post"])
def test_kill_in_wal_append(seeded, op, stage):
    s = seeded
    pre, post = _state(s["mut"], s["queries"]), _post_state(s, op)
    with faults.injected("wal.append", Kill("die"), match={"stage": stage}):
        with pytest.raises(Kill):
            _mutations(s)[op](s["mut"])
    s["mut"].close()
    got = _state(s["d"], s["queries"])
    assert _same(got, pre if stage == "pre" else post)


@pytest.mark.parametrize("seam", ["compact.merge", "manifest.swap"])
def test_kill_in_foreground_compaction(seeded, seam):
    s, mut = seeded, seeded["mut"]
    for mutate in _mutations(s).values():
        mutate(mut)
    pre = _state(mut, s["queries"])
    with faults.injected(seam, Kill("die")):
        with pytest.raises(Kill):
            mut.compact()
    mut.close()
    m2 = topen(s["d"])
    try:
        assert m2.generation == 1
        assert _same(_state(m2, s["queries"]), pre)
        assert m2.compact() == 2  # the retried compaction reclaims the number
        assert _same(_state(m2, s["queries"]), pre)
    finally:
        m2.close()


@pytest.mark.parametrize("op", ["insert", "delete", "upsert"])
@pytest.mark.parametrize("seam", ["compact.pin", "compact.replay", "compact.flip",
                                  "manifest.swap"])
def test_kill_in_background_compaction(seeded, seam, op):
    s, mut = seeded, seeded["mut"]
    ran = []

    def hook():
        _mutations(s)[op](mut)
        ran.append(True)

    with faults.injected(seam, Kill("die")):
        with pytest.raises(Kill):
            compact_background(mut, _mid_rebuild=hook)
    assert bool(ran) == (seam != "compact.pin")
    assert mut.generation == 1 and mut._capture is None
    expected = _state(mut, s["queries"])
    mut.close()
    assert _same(_state(s["d"], s["queries"]), expected)
    m2 = topen(s["d"])
    try:
        assert m2.compact() == 2
        assert _same(_state(m2, s["queries"]), expected)
    finally:
        m2.close()


_CHILD = r"""
import os, sys
import numpy as np
from raft_tpu_torch.mutable import MutableIndex
from raft_tpu_torch.robust import faults

d, seam, stage = sys.argv[1], sys.argv[2], sys.argv[3]
real = faults.fire

def fire(point, **ctx):
    if point == seam and (stage == "-" or ctx.get("stage") == stage):
        os._exit(17)  # the process dies at the seam: no cleanup, no flush
    real(point, **ctx)

faults.fire = fire
faults.enable()
mut = MutableIndex.open(d, "brute_force", 16, device="cpu")
rng = np.random.default_rng(12)
if seam == "wal.append":
    mut.upsert(np.array([1, 999]), rng.standard_normal((2, 16)).astype(np.float32))
else:
    mut.delete(np.array([2, 3]))
    mut.compact_background() if seam.startswith("compact") else mut.compact()
sys.exit(0)
"""


@pytest.mark.parametrize("seam,stage,expect", [
    ("wal.append", "pre", "pre"), ("wal.append", "post", "post"),
    ("manifest.swap", "-", "deleted"), ("compact.flip", "-", "deleted"),
], ids=["append-pre", "append-post", "swap", "flip"])
def test_process_death_at_a_seam_recovers_cold(tmp_path, rng, seam, stage, expect):
    d = str(tmp_path / "idx")
    mut = topen(d)
    mut.insert(_rows(rng, 32))
    mut.compact()
    mut.insert(_rows(rng, 4))
    q = _rows(rng, 3)
    pre = _state(mut, q)
    rows_before = mut.live_rows()
    mut.close()
    out = subprocess.run([sys.executable, "-c", _CHILD, d, seam, stage], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 17, out.stderr[-2000:]
    m2 = topen(d)
    try:
        assert m2.generation == 1
        ids = m2.live_rows()[0]
        if expect == "pre":
            assert _same(_state(m2, q), pre)
            np.testing.assert_array_equal(ids, rows_before[0])
        elif expect == "post":
            assert 999 in set(ids.tolist()) and len(ids) == 37
        else:  # the delete is durable, the compaction never published
            assert not {2, 3} & set(ids.tolist()) and len(ids) == 34
    finally:
        m2.close()


# -- background compaction --------------------------------------------------------------------


@pytest.fixture
def obs_reg():
    reg = tobs.registry()
    reg.reset()
    tobs.enable()
    yield reg
    tobs.disable()
    reg.reset()


@pytest.mark.parametrize("op", ["insert", "delete", "upsert", "mixed"])
def test_flip_equals_fresh_rebuild_over_final_rows(seeded, op):
    s, mut = seeded, seeded["mut"]
    names = ["insert", "delete", "upsert"] if op == "mixed" else [op]
    new_gen = compact_background(mut, _mid_rebuild=lambda: [_mutations(s)[n](mut) for n in names])
    assert new_gen == mut.generation == 2
    got = _state(mut, s["queries"])
    live_ids, live_vecs = mut.live_rows()
    fresh = tmut()
    fresh.insert(live_vecs, ids=live_ids)
    assert _same(got, _state(fresh, s["queries"]))
    mut.close()
    assert _same(_state(s["d"], s["queries"]), got)
    m2 = topen(s["d"])
    try:
        m2.compact()
        fresh.compact()
        d1, i1 = m2.search(s["queries"], 5)
        d2, i2 = fresh.search(s["queries"], 5)
        np.testing.assert_array_equal(i1, i2)
        np.testing.assert_array_equal(d1, d2)
    finally:
        m2.close()


def test_writers_not_blocked_during_rebuild(seeded, rng):
    mut = seeded["mut"]
    comp = Compactor(mut, poll_interval_s=0.002)
    comp.start()
    probe = _rows(rng, 1)
    try:
        with faults.injected("compact.merge", latency_s=0.5):
            assert comp.request()
            deadline = time.monotonic() + 5.0
            while mut._capture is None and time.monotonic() < deadline:
                time.sleep(0.001)
            assert mut._capture is not None, "worker never pinned"
            t0 = time.monotonic()
            new_id = mut.insert(probe)
            assert time.monotonic() - t0 < 0.25
            assert comp.wait_idle(timeout_s=30.0)
    finally:
        comp.stop()
    assert comp.completed == 1 and comp.failed == 0 and mut.generation == 2
    dd, ii = mut.search(probe, 1)
    assert ii[0, 0] == new_id[0] and dd[0, 0] < 1e-4
    mut.close()


def test_worker_death_is_restarted_without_losing_the_request(seeded):
    mut = seeded["mut"]
    comp = Compactor(mut, poll_interval_s=0.002)
    old_hook = threading.excepthook
    threading.excepthook = lambda args: None
    try:
        comp.start()
        with faults.injected("compact.worker", Kill("die"), trigger="first_n", first_n=1):
            assert comp.request()
            assert comp.wait_idle(timeout_s=30.0)
    finally:
        threading.excepthook = old_hook
        comp.stop()
    assert comp.worker_restarts == 1 and comp.completed == 1 and comp.failed == 0
    assert mut.generation == 2
    mut.close()


def test_transient_fault_is_retried_on_the_seeded_schedule(seeded, obs_reg):
    mut = seeded["mut"]
    assert (tmaint.COMPACT_RETRY_POLICY.schedule(0) == jmaint.COMPACT_RETRY_POLICY.schedule(0)
            and tmaint.COMPACT_RETRY_POLICY == tmaint.COMPACT_RETRY_POLICY)
    comp = Compactor(mut, poll_interval_s=0.002)
    comp.start()
    try:
        with faults.injected("compact.merge", Kill("flaky"), trigger="first_n", first_n=1):
            assert comp.request()
            assert comp.wait_idle(timeout_s=30.0)
        with faults.injected("compact.merge", Kill("flaky"), trigger="first_n", first_n=1):
            assert mut.compact() == 3
    finally:
        comp.stop()
    assert comp.completed == 1 and comp.failed == 0 and comp.last_error is None
    counters = obs_reg.as_dict()["counters"]
    assert counters['mutable.compact.retries{index="idx",mode="background"}'] == 1.0
    assert counters['mutable.compact.retries{index="idx",mode="sync"}'] == 1.0
    assert counters['retry.recovered{op="mutable.compact.background"}'] == 1.0
    mut.close()


def test_terminal_failure_is_reported_then_recovers(seeded, obs_reg):
    mut = seeded["mut"]
    comp = Compactor(mut, poll_interval_s=0.002)
    comp.start()
    try:
        with faults.injected("compact.flip", Kill("die")):
            assert comp.request()
            assert comp.wait_idle(timeout_s=30.0)
        assert comp.failed == 1 and isinstance(comp.last_error, Kill) and mut.generation == 1
        before = _state(mut, seeded["queries"])
        assert comp.request()
        assert comp.wait_idle(timeout_s=30.0)
    finally:
        comp.stop()
    assert comp.completed == 1 and comp.last_error is None and mut.generation == 2
    assert _same(_state(mut, seeded["queries"]), before)
    assert obs_reg.as_dict()["counters"]['mutable.compact.failed{error="Kill",index="idx"}'] == 1.0
    mut.close()


def test_policy_triggers_and_tick_rate_limit(seeded, rng, obs_reg):
    s, mut = seeded, seeded["mut"]
    assert CompactionPolicy().reason(mut) is None
    assert CompactionPolicy(delta_rows=9).reason(mut) is None
    assert CompactionPolicy(delta_rows=8).reason(mut) == "delta_rows"
    assert CompactionPolicy(tombstone_fraction=0.0).reason(mut) is None
    assert CompactionPolicy(wal_bytes=1).reason(mut) == "wal_bytes"
    assert CompactionPolicy(wal_bytes=10**15).reason(mut) is None
    clk = [0.0]
    comp = Compactor(mut, policy=CompactionPolicy(delta_rows=4, min_interval_s=100.0),
                     poll_interval_s=0.002, clock=lambda: clk[0])
    comp.start()
    try:
        assert comp.tick() == "delta_rows"
        assert comp.wait_idle(timeout_s=30.0)
        assert comp.completed == 1 and mut.generation == 2
        mut.insert(_rows(rng, 6))
        assert comp.tick() is None  # rate-limited by min_interval_s
        clk[0] += 101.0
        assert comp.tick() == "delta_rows"
        assert comp.wait_idle(timeout_s=30.0)
    finally:
        comp.stop()
    assert comp.completed == 2 and mut.generation == 3 and not comp.running
    mut.delete(s["ids"][:8])
    assert CompactionPolicy(tombstone_fraction=0.05).reason(mut) == "tombstone_fraction"
    gauges = obs_reg.as_dict()["gauges"]
    assert any(k.startswith("mutable.compact.backlog") for k in gauges)
    assert any(k.startswith("mutable.maintenance.heartbeat") for k in gauges)
    mut.close()
    mem = tmut()
    mem.insert(_rows(rng, 4))
    assert CompactionPolicy(wal_bytes=1).reason(mem) is None


def test_rebuild_stream_is_a_no_op_off_the_card():
    with tmaint.rebuild_stream("cpu") as stream:
        assert stream is None
    tmaint.adopt_on_stream(None, "cpu")


# -- freshness ------------------------------------------------------------------------------------


@pytest.mark.parametrize("algo", ["brute_force", "ivf_flat"])
def test_post_compaction_equals_a_fresh_build_bit_for_bit(rng, algo):
    kw = {"index_params": tivf.IvfFlatIndexParams(n_lists=IVF_LISTS)} if algo == "ivf_flat" else {}
    mut = tmut(algo, **kw)
    ids = mut.insert(_rows(rng, 400))
    mut.compact()
    mut.insert(_rows(rng, 40))
    mut.delete(ids[::7])
    mut.compact()
    q = _rows(rng, 8)
    d_mut, i_mut = mut.search(q, 10)
    live_ids, live_vecs = mut.live_rows()
    fresh = tmut(algo, **kw)
    fresh.insert(live_vecs, ids=live_ids)
    fresh.compact()
    d_ref, i_ref = fresh.search(q, 10)
    np.testing.assert_array_equal(i_mut, i_ref)
    np.testing.assert_array_equal(d_mut, d_ref)
    for f in dataclasses.fields(mut.main_index):
        a, b = getattr(mut.main_index, f.name), getattr(fresh.main_index, f.name)
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b, f.name


def test_pre_compaction_recall_and_no_deleted_ids(rng):
    from raft_tpu_torch.neighbors import brute_force

    mut = tmut("ivf_flat", index_params=tivf.IvfFlatIndexParams(n_lists=IVF_LISTS),
               search_params=tivf.IvfFlatSearchParams(n_probes=16))
    ids = mut.insert(_rows(rng, 1500))
    mut.compact()
    extra = mut.insert(_rows(rng, 120))
    dead = np.concatenate([ids[:100], extra[:50]])
    mut.delete(dead)
    q = _rows(rng, 32)
    _, got = mut.search(q, 10)
    live_ids, live_vecs = mut.live_rows()
    _, pos = brute_force.search(brute_force.build(live_vecs, metric="sqeuclidean", res=mut.res),
                                q, 10)
    want = live_ids[pos.numpy()]
    recall = np.mean([len(set(got[i]) & set(want[i])) / 10 for i in range(len(q))])
    assert recall >= 0.95, recall
    assert not np.isin(got, dead).any()


def test_rotated_wal_replays_and_compaction_removes_its_segments(rng, tmp_path):
    d = str(tmp_path / "idx")
    mut = topen(d, max_wal_bytes=1200)
    data = _rows(rng, 24)
    for row in data:
        mut.insert(row[None])
    assert mut.wal.segment > 0
    mut.close()
    mut2 = topen(d, max_wal_bytes=1200)
    assert mut2.size == 24
    old = segment_paths(mut2.wal.path)
    assert len(old) > 1
    mut2.compact()
    assert not any(os.path.exists(sp) for sp in old)
    np.testing.assert_array_equal(mut2.search(data[:2], 1)[1][:, 0], [0, 1])
    mut2.close()


def test_auto_ids_never_reused_after_reopen(rng, tmp_path):
    d = str(tmp_path / "idx")
    mut = topen(d)
    ids = mut.insert(_rows(rng, 5))
    mut.delete(ids)
    mut.compact()
    mut.close()
    mut2 = topen(d)
    assert mut2.insert(_rows(rng, 1))[0] == 5
    mut2.close()


# -- serving -------------------------------------------------------------------------------------


def test_generation_in_results_and_bounded_programs(rng):
    from raft_tpu_torch.serve.bucketing import bucket_sizes

    mut = tmut()
    mut.insert(_rows(rng, 128))
    mut.compact()
    eng = ServingEngine(max_batch=8, max_wait_ms=0.0, res=mut.res)
    eng.register_mutable("live", mut)
    assert len(eng.warmup("live", 5)) == len(bucket_sizes(8))
    for _ in range(3):
        for m in (1, 3, 5, 8, 2, 7):
            fut = eng.submit("live", _rows(rng, m), k=5)
            eng.run_until_idle()
            res = fut.result()
            assert res.generation == mut.generation
        mut.insert(_rows(rng, 4))
        mut.compact()
    assert eng.cache.stats().misses <= 4 * len(bucket_sizes(8))


def test_a_batch_sees_one_snapshot(rng):
    mut = tmut()
    data = _rows(rng, 32)
    ids = mut.insert(data)
    mut.compact()
    eng = ServingEngine(max_batch=8, max_wait_ms=1e6, res=mut.res)
    eng.register_mutable("live", mut)
    futs = [eng.submit("live", data[i : i + 1], k=1) for i in range(4)]
    mut.delete(ids[:16])  # mutate while queued
    eng.run_until_idle()
    assert len({f.result().generation for f in futs}) == 1
    for i, f in enumerate(futs):
        assert f.result().indices[0, 0] != ids[i]
    snap_out = mut.snapshot().search(data[:4], 1)
    np.testing.assert_array_equal(np.concatenate([f.result().indices for f in futs]), snap_out[1])


def test_maintenance_tick_drives_the_compactor_and_shutdown_stops_it(rng, obs_reg):
    mut = tmut()
    mut.insert(_rows(rng, 64))
    mut.compact()
    eng = ServingEngine(max_batch=8, max_wait_ms=0.0, res=mut.res, maintenance_interval_ms=0.0)
    eng.register_mutable("live", mut, policy=CompactionPolicy(delta_rows=4))
    comp = eng._reg("live").compactor
    assert comp.running
    mut.insert(_rows(rng, 5))
    q = _rows(rng, 2)
    gens = set()
    deadline = time.monotonic() + 30.0
    while mut.generation < 2 and time.monotonic() < deadline:
        fut = eng.submit("live", q, k=3)
        eng.step(force=True)  # ticks maintenance first
        gens.add(fut.result().generation)
        time.sleep(0.005)
    eng.maintenance_tick()
    fut = eng.submit("live", q, k=3)
    eng.run_until_idle()
    gens.add(fut.result().generation)
    assert mut.generation == 2 and comp.completed == 1 and gens == {1, 2}
    counters = obs_reg.as_dict()["counters"]
    assert counters['serve.generation_flips{index_id="live"}'] == 1.0
    assert obs_reg.as_dict()["gauges"]['serve.generation{index_id="live"}'] == 2.0
    eng.shutdown()
    assert not comp.running


# -- obs names of one mutable run ----------------------------------------------------------------


def _mutable_run(mod_mut, mod_faults, d, rng):
    mut = mod_mut.open(d, "brute_force", DIM, **({} if mod_mut is JMut else {"device": "cpu"}))
    ids = mut.insert(_rows(rng, 40))
    mut.search(_rows(rng, 3), 4)
    mut.compact()
    mut.insert(_rows(rng, 5))
    mut.delete(ids[:3])
    mut.upsert(ids[3:5], _rows(rng, 2))
    mut.search(_rows(rng, 3), 4)
    with mod_faults.injected("compact.merge", Kill("x"), trigger="first_n", first_n=1):
        mut.compact()
    mut.compact_background(_mid_rebuild=lambda: mut.insert(_rows(rng, 2)))
    mut.close()
    mod_mut.open(d, "brute_force", DIM, **({} if mod_mut is JMut else {"device": "cpu"})).close()


def test_obs_names_of_a_mutable_run_match_jax(tmp_path, obs_reg):
    jobs.registry().reset()
    jobs.enable()
    try:
        _mutable_run(JMut, jfaults, str(tmp_path / "j" / "idx"), np.random.default_rng(13))
        j = jobs.registry().as_dict()
    finally:
        jobs.disable()
        jobs.registry().reset()
    _mutable_run(MutableIndex, faults, str(tmp_path / "t" / "idx"), np.random.default_rng(13))
    t = obs_reg.as_dict()

    def names(dump):
        return {kind: sorted(k for k in dump[kind] if k.startswith(("mutable.", "faults.")))
                for kind in ("counters", "gauges", "histograms")}

    assert names(t) == names(j)
    assert names(t)["counters"]
    for kind in ("counters", "gauges"):
        for k in names(t)[kind]:
            if "bytes" not in k:
                assert t[kind][k] == j[kind][k], k
