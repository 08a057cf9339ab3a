"""WAL shipping (``raft_tpu_torch.replica.shipping``), across the packages.

The WAL, the manifest and the main-segment snapshots are the same bytes in
both packages, so a follower of one package ships from a leader of the
other: a port ``Follower`` from a JAX leader's directory and a JAX
``Follower`` from a port leader's reach the leader's ``live_rows()``, and a
port follower reopens a JAX follower's directory at its position. Within
each package the same mutations ship the same way: a damaged chunk is
rejected at its clean-prefix offset and fetched again from the same offsets
JAX fetches, a torn sealed tail is typed after the same retries, a
restarted follower resumes from its persisted position, followers follow a
compaction's generation flip, and the ``wal.ship`` / ``replica.apply``
seams cost one tick, counted, with JAX's context keys. A follower's index
lives on the device it was given (``device="cpu"`` here).
"""
import os
import types

import numpy as np
import pytest

from raft_tpu import obs as jobs
from raft_tpu.mutable import MutableIndex as JMutable
from raft_tpu.mutable import compact as jcompact
from raft_tpu.replica import Follower as JFollower
from raft_tpu.replica import ReplicaGroup as JGroup
from raft_tpu.replica import Replication as JReplication
from raft_tpu.replica import Shipper as JShipper
from raft_tpu.replica import ShipRejected as JShipRejected
from raft_tpu.replica.shipping import _read_file_chunk
from raft_tpu.robust import faults as jfaults
from raft_tpu_torch import obs as tobs
from raft_tpu_torch.core.resources import Resources
from raft_tpu_torch.mutable import MutableIndex as TMutable
from raft_tpu_torch.mutable import compact as tcompact
from raft_tpu_torch.replica import Follower as TFollower
from raft_tpu_torch.replica import ReplicaGroup as TGroup
from raft_tpu_torch.replica import Replication as TReplication
from raft_tpu_torch.replica import Shipper as TShipper
from raft_tpu_torch.replica import ShipRejected as TShipRejected
from raft_tpu_torch.robust import faults as tfaults

CPU = Resources(device="cpu")
DIM = 16

J = types.SimpleNamespace(
    name="jax", obs=jobs, faults=jfaults, compact=jcompact, Replication=JReplication,
    Shipper=JShipper, ShipRejected=JShipRejected,
    open=lambda d, algo="brute_force": JMutable.open(d, algo, DIM),
    follower=lambda lead, d, name="f0": JFollower(lead, d, algo="brute_force", dim=DIM, name=name),
    group=lambda **kw: JGroup(**kw))
T = types.SimpleNamespace(
    name="torch", obs=tobs, faults=tfaults, compact=tcompact, Replication=TReplication,
    Shipper=TShipper, ShipRejected=TShipRejected,
    open=lambda d, algo="brute_force": TMutable.open(d, algo, DIM, device="cpu"),
    follower=lambda lead, d, name="f0": TFollower(lead, d, algo="brute_force", dim=DIM,
                                                  name=name, device="cpu"),
    group=lambda **kw: TGroup(res=CPU, **kw))
BOTH = (J, T)


def _reset():
    for p in BOTH:
        p.faults.disable()
        p.faults.clear()
        p.obs.disable()
        p.obs.registry().reset()


@pytest.fixture(autouse=True)
def _pristine_gates():
    _reset()
    yield
    _reset()


@pytest.fixture
def obs_on():
    for p in BOTH:
        p.obs.enable()
    yield
    for p in BOTH:
        p.obs.disable()


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(17)
    c = rng.standard_normal((8, DIM)).astype(np.float32)
    X = (c[rng.integers(0, 8, 256)] + 0.25 * rng.standard_normal((256, DIM))).astype(np.float32)
    Q = (c[rng.integers(0, 8, 32)] + 0.25 * rng.standard_normal((32, DIM))).astype(np.float32)
    return X, Q


def _counters(p, prefix="replica."):
    return {k: v for k, v in p.obs.registry().as_dict()["counters"].items()
            if k.startswith(prefix)}


def rows(idx):
    ids, vecs = idx.live_rows()
    ids, vecs = np.asarray(ids), np.asarray(vecs)
    o = np.argsort(ids)
    return ids[o], vecs[o]


def same_rows(a, b):
    (ia, va), (ib, vb) = rows(a), rows(b)
    return np.array_equal(ia, ib) and np.array_equal(va, vb)


def same_answers(a, b, Q, k=5):
    da, ia = a.snapshot().search(Q, k)
    db, ib = b.snapshot().search(Q, k)
    return (np.array_equal(np.asarray(ia), np.asarray(ib))
            and np.allclose(np.asarray(da), np.asarray(db), rtol=1e-5))


def _churn(leader, X, lo, hi, seed):
    """Inserts, deletes and upserts of one seed, the same in both packages."""
    rng = np.random.default_rng(seed)
    ids = leader.insert(X[lo:hi])
    ids = np.asarray(ids)
    leader.delete(rng.choice(ids, size=len(ids) // 8, replace=False))
    up = rng.choice(ids, size=4, replace=False)
    leader.upsert(up, X[rng.integers(0, len(X), 4)] + 0.5)


def _files(d):
    return sorted(f for f in os.listdir(d) if not f.startswith("."))


# -- across the packages ----------------------------------------------------------------


@pytest.mark.parametrize("leader_pkg", ["jax", "torch"])
@pytest.mark.parametrize("flip", [False, True], ids=["one_generation", "across_a_flip"])
def test_a_follower_ships_from_the_other_package_s_leader(tmp_path, corpus, leader_pkg, flip):
    """The leader of one package, the follower of the other, one shipper
    over the leader's WAL: the follower's rows equal the leader's after
    every tick, across a compaction's generation flip too."""
    X, Q = corpus
    lp, fp = (J, T) if leader_pkg == "jax" else (T, J)
    lead_dir = str(tmp_path / "leader")
    leader = lp.open(lead_dir)
    _churn(leader, X, 0, 96, 1)
    fol = fp.follower(lead_dir, str(tmp_path / "f0"))
    sh = fp.Shipper(lambda: leader.wal, fol)
    leader.wal.seal()
    assert sh.ship() > 0
    assert same_rows(leader, fol.index) and same_answers(leader, fol.index, Q)
    if flip:
        lp.compact(leader)
        assert fol.sync_generation() and fol.index.generation == leader.generation
    _churn(leader, X, 96, 160, 2)
    leader.wal.seal()
    sh.ship()
    assert fol.position.generation == leader.generation
    assert fol.position.applied_records == leader.wal.record_count()
    assert same_rows(leader, fol.index) and same_answers(leader, fol.index, Q)


def test_a_port_follower_reopens_a_jax_follower_s_directory(tmp_path, corpus):
    X, Q = corpus
    leader = J.open(str(tmp_path / "leader"))
    _churn(leader, X, 0, 128, 3)
    jf = J.follower(str(tmp_path / "leader"), str(tmp_path / "f0"))
    JReplication(leader, [jf], seal_bytes=1).tick()
    tf = T.follower(str(tmp_path / "leader"), str(tmp_path / "f0"))
    assert tf.position.as_dict() == jf.position.as_dict()
    assert same_rows(jf.index, tf.index) and same_answers(jf.index, tf.index, Q)


# -- the same shipping in each package -----------------------------------------------------


def _pipeline(p, tmp_path, X, n=96, seal_bytes=1, **kw):
    root = tmp_path / p.name
    leader = p.open(str(root / "leader"))
    leader.insert(X[:n])
    fol = p.follower(str(root / "leader"), str(root / "f0"))
    return leader, fol, p.Replication(leader, [fol], seal_bytes=seal_bytes, **kw)


def test_incremental_shipping_equals_jax_s(tmp_path, corpus):
    X, Q = corpus
    got = []
    for p in BOTH:
        leader, fol, rep = _pipeline(p, tmp_path, X)
        trail = [rep.tick(), rep.staleness(0), fol.position.as_dict()]
        _churn(leader, X, 96, 128, 4)
        trail += [rep.staleness(0), rep.tick(), rep.staleness(0), fol.position.as_dict(),
                  _files(fol.directory)]
        assert same_answers(leader, fol.index, Q)
        got.append((trail, rows(fol.index)[0].tolist()))
    assert got[0] == got[1]


def _damaged_once(calls):
    def transport(path, offset, nbytes):
        calls.append((os.path.basename(path), offset, nbytes))
        data = _read_file_chunk(path, offset, nbytes)
        if len(calls) == 1:
            broken = bytearray(data)
            broken[-1] ^= 0xFF
            return bytes(broken)
        return data

    return transport


def test_a_damaged_chunk_is_fetched_again_from_jax_s_offsets(obs_on, tmp_path, corpus):
    X, Q = corpus
    got = []
    for p in BOTH:
        leader, fol, _ = _pipeline(p, tmp_path, X)
        _churn(leader, X, 96, 128, 5)
        leader.wal.seal()
        calls = []
        applied = p.Shipper(leader.wal, fol, transport=_damaged_once(calls)).ship()
        assert same_answers(leader, fol.index, Q)
        got.append((applied, calls, fol.position.as_dict(), _counters(p)))
    assert got[0] == got[1]
    assert len(got[1][1]) >= 2
    assert got[1][3]['replica.ship.rejected{follower="f0",reason="crc"}'] == 1


def test_a_torn_sealed_tail_is_typed_after_jax_s_retries(obs_on, tmp_path, corpus):
    """A sealed segment cut mid-frame (storage damage): the clean prefix
    applies, the tail is asked for again from the same offset each time,
    and after ``max_retries`` the ship raises ``ShipRejected`` at that
    offset, as in JAX."""
    X, _ = corpus
    got = []
    for p in BOTH:
        leader, fol, _ = _pipeline(p, tmp_path, X)
        _churn(leader, X, 96, 128, 6)
        leader.wal.seal()
        (sq, sp), = [s for s in leader.wal.sealed_segments()][-1:]
        with open(sp, "r+b") as f:
            f.truncate(os.path.getsize(sp) - 7)
        calls = []

        def transport(path, offset, nbytes, calls=calls):
            calls.append((os.path.basename(path), offset, nbytes))
            return _read_file_chunk(path, offset, nbytes)

        with pytest.raises(p.ShipRejected) as ei:
            p.Shipper(leader.wal, fol, transport=transport, max_retries=2).ship()
        got.append((ei.value.segment, ei.value.offset, calls, fol.position.as_dict(),
                    _counters(p)))
    assert got[0] == got[1]
    assert got[1][4]['replica.ship.rejected{follower="f0",reason="torn_tail"}'] == 3


def test_persistent_corruption_applies_nothing_as_jax(tmp_path, corpus):
    X, _ = corpus
    got = []
    for p in BOTH:
        leader, fol, _ = _pipeline(p, tmp_path, X)
        leader.wal.seal()

        def broken(path, offset, nbytes):
            data = bytearray(_read_file_chunk(path, offset, nbytes))
            data[-1] ^= 0xFF
            return bytes(data)

        with pytest.raises(p.ShipRejected) as ei:
            p.Shipper(leader.wal, fol, transport=broken, max_retries=2).ship()
        got.append((ei.value.offset, fol.position.as_dict()))
    assert got[0] == got[1] and got[1][1]["applied_records"] == 0


def test_a_frame_wider_than_the_chunk_widens_as_jax(tmp_path, corpus):
    X, Q = corpus
    got = []
    for p in BOTH:
        leader, fol, _ = _pipeline(p, tmp_path, X)
        leader.wal.seal()
        calls = []

        def transport(path, offset, nbytes):
            calls.append((offset, nbytes))
            return _read_file_chunk(path, offset, nbytes)

        p.Shipper(leader.wal, fol, transport=transport, chunk_bytes=64).ship()
        assert same_answers(leader, fol.index, Q)
        got.append(calls)
    assert got[0] == got[1] and got[1][1][1] == 128


def test_a_restarted_follower_resumes_from_its_position_as_jax(tmp_path, corpus):
    X, Q = corpus
    got = []
    for p in BOTH:
        leader, fol, rep = _pipeline(p, tmp_path, X)
        rep.tick()
        pos = fol.position
        fol2 = p.follower(leader.directory, fol.directory)
        assert fol2.position == pos and same_answers(fol.index, fol2.index, Q)
        leader.insert(X[128:160])
        p.Replication(leader, [fol2], seal_bytes=1).tick()
        assert same_answers(leader, fol2.index, Q)
        got.append((pos.as_dict(), fol2.position.as_dict()))
    assert got[0] == got[1]
    assert got[1][1]["applied_records"] == got[1][0]["applied_records"] + 1


def test_followers_follow_a_generation_flip_as_jax(obs_on, tmp_path, corpus):
    X, Q = corpus
    got = []
    for p in BOTH:
        leader, fol, rep = _pipeline(p, tmp_path, X)
        rep.tick()
        gen0 = fol.index.generation
        p.compact(leader)
        leader.insert(X[128:160])
        rep.tick()
        assert fol.index.generation == leader.generation > gen0
        assert rep.staleness(0) == 0 and same_answers(leader, fol.index, Q)
        got.append((gen0, fol.position.as_dict(), _files(fol.directory), _counters(p)))
    assert got[0] == got[1]
    assert got[1][3]['replica.generation_syncs{follower="f0"}'] >= 2


def test_ship_and_apply_seams_fail_one_tick_as_jax(obs_on, tmp_path, corpus):
    X, Q = corpus
    got = []
    for p in BOTH:
        leader, fol, rep = _pipeline(p, tmp_path, X)
        trail = []
        with p.faults.injected("wal.ship", error=OSError("link down")) as spec:
            rep.tick()
        trail.append((spec.calls, fol.position.applied_records))
        with p.faults.injected("replica.apply", error=OSError("apply refused")) as spec:
            rep.tick()
        trail.append((spec.calls, fol.position.applied_records))
        rep.tick()
        trail.append(rep.staleness(0))
        assert same_answers(leader, fol.index, Q)
        got.append((trail, _counters(p)))
    assert got[0] == got[1]
    assert got[1][0] == [(1, 0), (1, 0), 0]


def test_wal_ship_and_replica_apply_fire_with_jax_s_context(tmp_path, corpus):
    """Specs matching every context key JAX passes (``segment``,
    ``offset``, ``nbytes``, ``follower``; ``follower``, ``segment``) count
    the same calls in both packages."""
    X, _ = corpus
    got = []
    for p in BOTH:
        leader, fol, rep = _pipeline(p, tmp_path, X)
        leader.wal.seal()
        (sq, sp), = leader.wal.sealed_segments()
        size = os.path.getsize(sp)
        p.faults.enable()
        ship = p.faults.install("wal.ship", latency_s=0.0, match={
            "segment": sq, "offset": 0, "nbytes": size, "follower": "f0"})
        apply = p.faults.install("replica.apply", latency_s=0.0,
                                 match={"follower": "f0", "segment": sq})
        rep.tick()
        got.append((ship.calls, apply.calls))
    assert got == [(1, 1)] * 2


# -- the group over a replication ------------------------------------------------------------


def test_the_staleness_floor_gates_follower_reads_as_jax(tmp_path, corpus):
    X, Q = corpus
    got = []
    for p in BOTH:
        leader, fol, rep = _pipeline(p, tmp_path, X, seal_bytes=1 << 30)
        grp = p.group(n_replicas=2, max_staleness_records=0)
        grp.register_mutable_replicated("m", rep)
        grp.maintenance_tick()
        trail = [grp.router.staleness(1), grp.router.admissible(1)]
        fut = grp.submit("m", Q[:2], 5)
        trail.append(grp._flights[-1].replica)
        grp.run_until_idle()
        leader.wal.seal()
        grp.maintenance_tick()
        trail += [grp.router.staleness(1), grp.router.admissible(1)]
        got.append((trail, np.asarray(fut.result(0).indices).tolist()))
    assert got[0] == got[1]
    assert got[1][0] == [1, False, 0, 0, True]


def test_a_replicated_group_serves_from_leader_and_follower_as_jax(tmp_path, corpus):
    X, Q = corpus
    got = []
    for p in BOTH:
        leader, fol, rep = _pipeline(p, tmp_path, X)
        grp = p.group(n_replicas=2, max_staleness_records=0)
        grp.register_mutable_replicated("m", rep)
        grp.maintenance_tick()
        futs, landed = [], []
        for i in range(8):
            futs.append(grp.submit("m", Q[i : i + 2], 5))
            landed.append(grp._flights[-1].replica)
        grp.run_until_idle()
        res = [f.result(0) for f in futs]
        assert all(r.generation == leader.generation for r in res)
        got.append((landed, [np.asarray(r.indices).tolist() for r in res]))
    assert got[0] == got[1] and set(got[1][0]) == {0, 1}


def test_a_follower_lives_on_the_device_it_is_given(tmp_path, corpus):
    X, _ = corpus
    leader = T.open(str(tmp_path / "leader"))
    leader.insert(X[:64])
    tcompact(leader)
    fol = T.follower(str(tmp_path / "leader"), str(tmp_path / "f0"))
    assert fol.res.device.type == "cpu" and fol.index.res.device.type == "cpu"
    assert fol.index.main_index is not None
    assert fol.index.main_index.dataset.device.type == "cpu"
    with pytest.raises(Exception, match="CUDA"):
        TFollower(str(tmp_path / "leader"), str(tmp_path / "f1"), algo="brute_force", dim=DIM)
