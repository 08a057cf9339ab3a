"""The control plane and the socket transport
(``raft_tpu_torch.replica.{control,transport}``), each against raft_tpu's.

``LeaseStore``: the ``os.link`` CAS gives one winner an epoch, a live lease
governs, an expired one is never renewed, release lets a successor in; a
store of one package reads and contends with a store of the other on the
same directory. ``ControlPlane``: the follower with the highest shipped
cursor is promoted on expiry, the replica count is conserved, every slot
is fenced, a deposed leader's frames raise ``FencedError``; the
``lease.acquire``, ``lease.renew`` and ``election.promote`` seams are
contained and retried, with JAX's context keys. ``SocketTransport``:
mangled content is caught by the follower, a torn wire is retried, a slow
or dead peer is a typed error inside a bounded wait, the breaker opens,
paths outside the served root are refused; the wire is the same in both
packages, so each package's client fetches from the other's server.
``Autoscaler.decide`` gives JAX's decision on the same sequences, and the
group grows and drains as JAX's does.
"""
import os
import time
import types

import numpy as np
import pytest

from raft_tpu import obs as jobs
from raft_tpu.mutable import MutableIndex as JMutable
from raft_tpu.obs import recorder as jrec
from raft_tpu.replica import AutoscalePolicy as JPolicy
from raft_tpu.replica import Autoscaler as JAutoscaler
from raft_tpu.replica import ControlPlane as JControl
from raft_tpu.replica import FencedError as JFenced
from raft_tpu.replica import Follower as JFollower
from raft_tpu.replica import LeaseStore as JLeases
from raft_tpu.replica import ReplicaGroup as JGroup
from raft_tpu.replica import Replication as JReplication
from raft_tpu.replica import SegmentServer as JServer
from raft_tpu.replica import ShipRejected as JShipRejected
from raft_tpu.replica import SocketTransport as JTransport
from raft_tpu.replica import TransportError as JTransportError
from raft_tpu.replica.shipping import _read_file_chunk
from raft_tpu.robust import faults as jfaults
from raft_tpu.robust.retry import CircuitBreaker as JBreaker
from raft_tpu.robust.retry import RetryPolicy as JRetryPolicy
from raft_tpu_torch import obs as tobs
from raft_tpu_torch.core.resources import Resources
from raft_tpu_torch.mutable import MutableIndex as TMutable
from raft_tpu_torch.obs import recorder as trec
from raft_tpu_torch.replica import AutoscalePolicy as TPolicy
from raft_tpu_torch.replica import Autoscaler as TAutoscaler
from raft_tpu_torch.replica import ControlPlane as TControl
from raft_tpu_torch.replica import FencedError as TFenced
from raft_tpu_torch.replica import Follower as TFollower
from raft_tpu_torch.replica import LeaseStore as TLeases
from raft_tpu_torch.replica import ReplicaGroup as TGroup
from raft_tpu_torch.replica import Replication as TReplication
from raft_tpu_torch.replica import SegmentServer as TServer
from raft_tpu_torch.replica import ShipRejected as TShipRejected
from raft_tpu_torch.replica import SocketTransport as TTransport
from raft_tpu_torch.replica import TransportError as TTransportError
from raft_tpu_torch.robust import faults as tfaults
from raft_tpu_torch.robust.retry import CircuitBreaker as TBreaker
from raft_tpu_torch.robust.retry import RetryPolicy as TRetryPolicy

CPU = Resources(device="cpu")
DIM = 12

J = types.SimpleNamespace(
    name="jax", obs=jobs, faults=jfaults, rec=jrec, Leases=JLeases, Control=JControl,
    Fenced=JFenced, Replication=JReplication, Server=JServer, Transport=JTransport,
    TransportError=JTransportError, ShipRejected=JShipRejected, Breaker=JBreaker,
    RetryPolicy=JRetryPolicy, Policy=JPolicy, Autoscaler=JAutoscaler,
    open=lambda d: JMutable.open(d, "brute_force", DIM),
    follower=lambda lead, d, name: JFollower(lead, d, algo="brute_force", dim=DIM, name=name),
    group=lambda **kw: JGroup(**kw))
T = types.SimpleNamespace(
    name="torch", obs=tobs, faults=tfaults, rec=trec, Leases=TLeases, Control=TControl,
    Fenced=TFenced, Replication=TReplication, Server=TServer, Transport=TTransport,
    TransportError=TTransportError, ShipRejected=TShipRejected, Breaker=TBreaker,
    RetryPolicy=TRetryPolicy, Policy=TPolicy, Autoscaler=TAutoscaler,
    open=lambda d: TMutable.open(d, "brute_force", DIM, device="cpu"),
    follower=lambda lead, d, name: TFollower(lead, d, algo="brute_force", dim=DIM, name=name,
                                             device="cpu"),
    group=lambda **kw: TGroup(res=CPU, **kw))
BOTH = (J, T)


def _reset():
    for p in BOTH:
        p.faults.disable()
        p.faults.clear()
        p.obs.disable()
        p.obs.registry().reset()
        p.rec.uninstall()


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


class VClock:
    def __init__(self, t=0.0):
        self.t = float(t)

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(19)
    return (rng.standard_normal((128, DIM)).astype(np.float32),
            rng.standard_normal((16, DIM)).astype(np.float32))


def _counters(p, prefixes=("replica.", "serve.autoscale", "recorder.")):
    return {k: v for k, v in p.obs.registry().as_dict()["counters"].items()
            if k.startswith(prefixes)}


def _gauges(p, prefix="replica."):
    return {k: v for k, v in p.obs.registry().as_dict()["gauges"].items()
            if k.startswith(prefix)}


def rows(idx):
    ids, vecs = idx.live_rows()
    ids, vecs = np.asarray(ids), np.asarray(vecs)
    o = np.argsort(ids)
    return ids[o], vecs[o]


def same_rows(a, b):
    (ia, va), (ib, vb) = rows(a), rows(b)
    return np.array_equal(ia, ib) and np.array_equal(va, vb)


def lease_tuple(lease):
    return None if lease is None else (lease.holder, lease.epoch, lease.expires_s)


# -- LeaseStore ------------------------------------------------------------------------


def _lease_acquire(p, d):
    clk = VClock()
    s = p.Leases(d, ttl_s=1.0, clock=clk)
    out = [lease_tuple(s.current()), s.epoch(), lease_tuple(s.acquire("a"))]
    out += [lease_tuple(s.cached()), lease_tuple(s.current()), lease_tuple(s.acquire("b"))]
    clk.advance(2.0)
    return out + [lease_tuple(s.acquire("b")), s.epoch(), s.expired()]


def _lease_renew(p, d):
    clk = VClock()
    s = p.Leases(d, ttl_s=1.0, clock=clk)
    s.acquire("a")
    clk.advance(0.6)
    out = [lease_tuple(s.renew("a")), lease_tuple(s.renew("b"))]
    clk.advance(2.0)
    return out + [lease_tuple(s.renew("a")), lease_tuple(s.acquire("a"))]


def _lease_release(p, d):
    clk = VClock()
    s = p.Leases(d, ttl_s=100.0, clock=clk)
    s.acquire("a")
    out = [lease_tuple(s.acquire("b")), s.release("a"), lease_tuple(s.acquire("b"))]
    return out + [s.release("a"), sorted(os.listdir(d))]


def _lease_cas(p, d):
    clk = VClock()
    s1, s2 = p.Leases(d, ttl_s=1.0, clock=clk), p.Leases(d, ttl_s=1.0, clock=clk)
    out = [lease_tuple(s1.acquire("a")), lease_tuple(s2.acquire("b"))]
    clk.advance(2.0)
    return out + [lease_tuple(s1.acquire("a")), lease_tuple(s2.current())]


@pytest.mark.parametrize("case", [_lease_acquire, _lease_renew, _lease_release, _lease_cas],
                         ids=["acquire", "renew", "release", "cas_one_winner"])
def test_lease_store_as_jax(tmp_path, case):
    got = [case(p, str(tmp_path / p.name)) for p in BOTH]
    assert got[0] == got[1]


def test_lease_stores_of_both_packages_share_one_directory(tmp_path):
    """The CAS is the file system's: a JAX store and a port store on one
    directory read each other's leases and never both win an epoch."""
    clk = VClock()
    d = str(tmp_path / "l")
    js, ts = J.Leases(d, ttl_s=1.0, clock=clk), T.Leases(d, ttl_s=1.0, clock=clk)
    assert lease_tuple(js.acquire("jax")) == ("jax", 1, 1.0)
    assert ts.acquire("torch") is None
    assert lease_tuple(ts.current()) == ("jax", 1, 1.0)
    clk.advance(0.5)
    assert lease_tuple(js.renew("jax")) == ("jax", 1, 1.5)
    clk.advance(2.0)
    assert lease_tuple(ts.acquire("torch")) == ("torch", 2, 3.5)
    assert js.renew("jax") is None and js.epoch() == 2
    assert ts.release("torch") and lease_tuple(js.acquire("jax")) == ("jax", 3, 3.5)


def test_lease_seams_fire_before_any_io_with_jax_s_context(tmp_path):
    got = []
    for p in BOTH:
        s = p.Leases(str(tmp_path / p.name), ttl_s=1.0, clock=VClock())
        with p.faults.injected("lease.acquire", error=OSError("store down"),
                               match={"holder": "a"}) as spec:
            with pytest.raises(OSError):
                s.acquire("a")
        out = [spec.calls, s.current()]
        s.acquire("a")
        with p.faults.injected("lease.renew", error=OSError("store down"),
                               match={"holder": "a"}) as spec:
            with pytest.raises(OSError):
                s.renew("a")
        got.append(out + [spec.calls, lease_tuple(s.current())])
    assert got == [[1, None, 1, ("a", 1, 1.0)]] * 2


# -- ControlPlane ----------------------------------------------------------------------------


def _pipeline(p, tmp_path, X, *, clk, ttl_s=1.0, n_followers=2, transports=None):
    root = tmp_path / p.name
    leader = p.open(str(root / "leader"))
    leader.insert(X[:96])
    followers = [p.follower(str(root / "leader"), str(root / f"f{j}"), f"f{j}")
                 for j in range(n_followers)]
    rep = p.Replication(leader, followers, seal_bytes=1, transports=transports)
    store = p.Leases(str(root / "lease"), ttl_s=ttl_s, clock=clk)
    cp = p.Control(rep, store, root_dir=str(root / "cp"), clock=clk)
    return leader, rep, store, cp


def test_bootstrap_and_renewal_as_jax(tmp_path, corpus):
    X, _ = corpus
    got = []
    for p in BOTH:
        clk = VClock()
        leader, rep, store, cp = _pipeline(p, tmp_path, X, clk=clk)
        out = [cp.epoch, cp.leader_name, lease_tuple(store.current())]
        rep.tick()
        out.append([f.fence_epoch for f in rep.followers])
        clk.advance(0.3)
        rep.tick()
        out.append(lease_tuple(store.current()))
        clk.advance(0.3)
        rep.tick()
        out += [lease_tuple(store.current()), cp.elections]
        got.append(out)
    assert got[0] == got[1]
    assert got[1] == [1, "leader", ("leader", 1, 1.0), [1, 1], ("leader", 1, 1.0),
                      ("leader", 1, 1.6), 0]


def _elect_highest_cursor(p, tmp_path, X):
    clk = VClock()
    f0_down = {"on": False}

    def flaky(path, offset, nbytes):
        if f0_down["on"]:
            raise OSError("partitioned")
        return _read_file_chunk(path, offset, nbytes)

    leader, rep, store, cp = _pipeline(p, tmp_path, X, clk=clk, transports=[flaky, None])
    rep.tick()
    leader.insert(X[96:128])
    f0_down["on"] = True
    rep.tick()
    cursors = [f.position.as_dict() for f in rep.followers]
    winner_rows = rows(rep.followers[1].index)
    cp.kill_leader()
    out = [rep.active]
    clk.advance(2.0)
    rep.tick()
    out += [cp.elections, cp.leader_name, cp.epoch, lease_tuple(store.current()),
            sorted(f.name for f in rep.followers), [f.fence_epoch for f in rep.followers],
            rep.take_handles_changed(), cursors]
    new_rows = rows(rep.leader)
    assert np.array_equal(winner_rows[0], new_rows[0])
    assert np.array_equal(winner_rows[1], new_rows[1])
    rep.tick()
    for j, f in enumerate(rep.followers):
        assert rep.staleness(j) == 0 and same_rows(rep.leader, f.index)
    return out, _counters(p), _gauges(p)


def test_the_highest_cursor_follower_is_promoted_as_jax(obs_on, tmp_path, corpus):
    X, _ = corpus
    got = [_elect_highest_cursor(p, tmp_path, X) for p in BOTH]
    assert got[0] == got[1]
    out = got[1][0]
    assert out[:4] == [False, 1, "f1", 2] and out[5] == ["f0", "leader-rejoined"]
    assert got[1][1]['replica.elections{reason="expiry"}'] == 1
    assert got[1][2]['replica.leader_epoch{group="control"}'] == 2.0


def test_a_deposed_leader_s_frames_are_fenced_as_jax(obs_on, tmp_path, corpus):
    X, _ = corpus
    got = []
    for p in BOTH:
        clk = VClock()
        leader, rep, store, cp = _pipeline(p, tmp_path, X, clk=clk)
        rep.tick()
        cp.kill_leader()
        clk.advance(2.0)
        rep.tick()
        f = rep.followers[0]
        before = f.position.applied_records
        with pytest.raises(p.Fenced) as ei:
            f.apply(f.position.segment, f.position.offset, b"junk", epoch=1)
        assert not isinstance(ei.value, p.ShipRejected)
        got.append((ei.value.epoch, ei.value.fence_epoch, f.position.applied_records - before,
                    _counters(p)))
    assert got[0] == got[1] and got[1][:3] == (1, 2, 0)


def test_followers_learn_a_higher_epoch_from_frames(tmp_path, corpus):
    X, _ = corpus
    got = []
    for p in BOTH:
        root = tmp_path / p.name
        p.open(str(root / "leader")).insert(X[:8])
        fol = p.follower(str(root / "leader"), str(root / "f0"), "f0")
        out = [fol.fence_epoch]
        fol.apply(fol.position.segment, fol.position.offset, b"", epoch=7)
        out.append(fol.fence_epoch)
        fol.fence(3)
        got.append(out + [fol.fence_epoch])
    assert got == [[0, 7, 7]] * 2


def test_a_live_lease_governs_through_a_partition(tmp_path, corpus):
    X, _ = corpus
    got = []
    for p in BOTH:
        clk = VClock()
        leader, rep, store, cp = _pipeline(p, tmp_path, X, clk=clk)
        cp.kill_leader()
        clk.advance(0.9)
        rep.tick()
        out = [cp.elections]
        clk.advance(0.2)
        rep.tick()
        got.append(out + [cp.elections])
    assert got == [[0, 1]] * 2


@pytest.mark.parametrize("seam,error", [("election.promote", RuntimeError),
                                        ("lease.acquire", OSError)])
def test_an_election_seam_is_contained_and_retried_as_jax(obs_on, tmp_path, corpus, seam,
                                                          error):
    X, _ = corpus
    got = []
    for p in BOTH:
        clk = VClock()
        leader, rep, store, cp = _pipeline(p, tmp_path, X, clk=clk)
        rep.tick()
        cp.kill_leader()
        clk.advance(2.0)
        # equal cursors: the last follower wins (JAX's max over (cursor, slot))
        match = ({"follower": "f1", "reason": "expiry"} if seam == "election.promote"
                 else {"holder": "f1"})
        with p.faults.injected(seam, error=error("coordinator died"), match=match) as spec:
            rep.tick()
        out = [spec.calls, cp.elections, lease_tuple(store.current())]
        rep.tick()
        got.append((out + [cp.elections, cp.epoch], _counters(p)))
    assert got[0] == got[1]
    assert got[1][0] == [1, 0, ("leader", 1, 1.0), 1, 2]
    assert got[1][1][f'replica.control.errors{{kind="{error.__name__}"}}'] == 1


def test_a_failed_renewal_costs_the_lease_not_the_caller(obs_on, tmp_path, corpus):
    X, _ = corpus
    got = []
    for p in BOTH:
        clk = VClock()
        leader, rep, store, cp = _pipeline(p, tmp_path, X, clk=clk, ttl_s=1.0)
        p.faults.enable()
        spec = p.faults.install("lease.renew", error=OSError("store flaky"),
                                match={"holder": "leader"})
        clk.advance(0.6)
        rep.tick()
        clk.advance(0.5)
        rep.tick()
        got.append((spec.calls, cp.elections, cp.epoch, cp.leader_name, _counters(p)))
    assert got[0] == got[1] and got[1][1:3] == (1, 2)


def test_the_recorder_dumps_on_an_election_and_a_fenced_frame(obs_on, tmp_path, corpus):
    X, _ = corpus
    got = []
    for p in BOTH:
        d = str(tmp_path / f"bundles-{p.name}")
        p.rec.install(d, min_dump_interval_s=0.0)
        clk = VClock()
        leader, rep, store, cp = _pipeline(p, tmp_path, X, clk=clk)
        rep.tick()
        cp.kill_leader()
        clk.advance(2.0)
        rep.tick()
        f = rep.followers[0]
        with pytest.raises(p.Fenced):
            f.apply(f.position.segment, f.position.offset, b"", epoch=1)
        got.append(([os.path.basename(x) for x in p.rec.list_bundles(d)],
                    {k: v for k, v in _counters(p).items() if k.startswith("recorder.")}))
        p.rec.uninstall()
    assert got[0] == got[1]
    assert got[1][0] == ["bundle-0001-election.raftbundle", "bundle-0002-fenced.raftbundle"]


# -- a replica group over a controlled pipeline: election, growth, drain -----------------------


def _kill_leader_mid_ship(p, tmp_path, X, Q):
    clk = VClock()
    leader, rep, store, cp = _pipeline(p, tmp_path, X, clk=clk, n_followers=1)
    grp = p.group(n_replicas=2, clock=clk)
    grp.register_mutable_replicated("m", rep)
    grp.maintenance_tick()
    rng = np.random.default_rng(11)
    futs = []
    for i in range(64):
        clk.advance(float(rng.exponential(1.0 / 3000.0)))
        futs.append(grp.submit("m", Q[int(rng.integers(0, len(Q)))][None, :], 5))
        if i == 7:
            cp.kill_leader()
            clk.advance(2.0)  # the dead leader's lease runs out
        grp.step()
    grp.run_until_idle()
    results = [f.result(0) for f in futs]  # raises if a caller saw the election
    grp.maintenance_tick()
    grp.maintenance_tick()
    f = rep.followers[0]
    assert rep.staleness(0) == 0 and same_rows(rep.leader, f.index)
    with pytest.raises(p.Fenced):
        f.apply(f.position.segment, f.position.offset, b"stale", epoch=1)
    return ([np.asarray(r.indices).tolist() for r in results], cp.elections, cp.epoch,
            cp.leader_name, _counters(p))


def test_a_leader_killed_mid_ship_is_invisible_to_callers_as_jax(obs_on, tmp_path, corpus):
    X, Q = corpus
    got = [_kill_leader_mid_ship(p, tmp_path, X, Q) for p in BOTH]
    assert got[0] == got[1]
    assert got[1][1:4] == (1, 2, "f0")


def _autoscale_up(p, tmp_path, X, Q):
    clk = VClock()
    leader, rep, store, cp = _pipeline(p, tmp_path, X, clk=clk, n_followers=1)
    grp = p.group(n_replicas=2, clock=clk)
    grp.register_mutable_replicated("m", rep)
    grp.maintenance_tick()
    grp.enable_autoscaler(p.Policy(up_ticks=1, queue_up_rows=1, max_replicas=3, cooldown_s=0.0),
                          warm_k={"m": 5})
    futs = [grp.submit("m", Q[i : i + 2], 5) for i in range(12)]
    grp.maintenance_tick()
    out = [grp.n_replicas, len(rep.followers)]
    grp.run_until_idle()
    grp.maintenance_tick()
    assert rep.staleness(1) == 0 and same_rows(rep.leader, rep.followers[1].index)
    return out, [np.asarray(f.result(0).indices).tolist() for f in futs], _counters(p)


def test_the_group_grows_under_queue_pressure_as_jax(obs_on, tmp_path, corpus):
    X, Q = corpus
    got = [_autoscale_up(p, tmp_path, X, Q) for p in BOTH]
    assert got[0] == got[1] and got[1][0] == [3, 2]
    assert got[1][2]['serve.autoscale{direction="up"}'] == 1


def _drain(p, tmp_path, X, Q):
    clk = VClock()
    leader, rep, store, cp = _pipeline(p, tmp_path, X, clk=clk, n_followers=2)
    grp = p.group(n_replicas=3, clock=clk)
    grp.register_mutable_replicated("m", rep)
    grp.maintenance_tick()
    grp.enable_autoscaler(p.Policy(min_replicas=2, down_ticks=1, burn_down=0.5,
                                   queue_down_rows=1_000_000, up_ticks=99, cooldown_s=0.0))
    futs = [grp.submit("m", Q[i : i + 1], 5) for i in range(16)]
    grp.maintenance_tick()
    out = [grp.health()["replicas"][2]["draining"], grp.n_replicas]
    grp.run_until_idle()
    grp.maintenance_tick()
    out += [grp.n_replicas, len(rep.followers), [r["draining"] for r in grp.health()["replicas"]]]
    return out, [np.asarray(f.result(0).indices).tolist() for f in futs], _counters(p)


def test_the_group_drains_before_it_retires_a_replica_as_jax(obs_on, tmp_path, corpus):
    X, Q = corpus
    got = [_drain(p, tmp_path, X, Q) for p in BOTH]
    assert got[0] == got[1]
    assert got[1][0] == [True, 3, 2, 1, [False, False]]
    assert got[1][2]['serve.autoscale{direction="down"}'] == 1


# -- the autoscaler ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(8))
def test_autoscaler_decides_as_jax(seed):
    rng = np.random.default_rng(400 + seed)
    kw = dict(min_replicas=int(rng.integers(1, 3)), max_replicas=int(rng.integers(3, 6)),
              burn_up=float(rng.uniform(1.0, 4.0)), queue_up_rows=int(rng.integers(8, 128)),
              burn_down=float(rng.uniform(0.1, 0.9)), queue_down_rows=int(rng.integers(1, 8)),
              up_ticks=int(rng.integers(1, 4)), down_ticks=int(rng.integers(1, 6)),
              cooldown_s=float(rng.choice([0.0, 0.5, 3.0])))
    steps = [(float(rng.uniform(0, 1.0)), float(rng.exponential(2.0)),
              int(rng.integers(0, 400))) for _ in range(80)]
    got = []
    for p in BOTH:
        clk = VClock()
        a = p.Autoscaler(p.Policy(**kw), clock=clk)
        n, trail = 2, []
        for dt, burn, rows_q in steps:
            clk.advance(dt)
            d = a.decide(burn=burn, queue_rows=rows_q, n_replicas=n)
            n = min(max(n + d, 1), 8)
            trail.append(d)
        got.append(trail)
    assert got[0] == got[1]


def test_autoscaler_policy_validation_as_jax():
    for kw in (dict(min_replicas=0), dict(min_replicas=3, max_replicas=2)):
        for p in BOTH:
            with pytest.raises(Exception):
                p.Autoscaler(p.Policy(**kw))


# -- the socket transport ---------------------------------------------------------------------


def _fast(p, srv, **kw):
    kw.setdefault("sleep", lambda s: None)
    return p.Transport(srv.host, srv.port, **kw)


@pytest.fixture
def leader_dir(tmp_path, corpus):
    X, _ = corpus
    leader = T.open(str(tmp_path / "leader"))
    leader.insert(X[:96])
    leader.wal.seal()
    return leader


@pytest.mark.parametrize("server_pkg,client_pkg", [("jax", "torch"), ("torch", "jax"),
                                                   ("torch", "torch")])
def test_a_client_fetches_from_either_package_s_server(obs_on, leader_dir, server_pkg,
                                                       client_pkg):
    """The frame is the WAL's record envelope in both packages: each
    client reads a sealed segment from each server, byte for byte."""
    sp_, cp_ = (J if server_pkg == "jax" else T), (J if client_pkg == "jax" else T)
    srv = sp_.Server(leader_dir.directory)
    try:
        t = _fast(cp_, srv, timeout_s=2.0)
        (_, path), = leader_dir.wal.sealed_segments()
        with open(path, "rb") as f:
            want = f.read()
        assert t(path, 0, len(want)) == want
        assert t(path, 5, 17) == want[5:22]
        assert _counters(cp_)[f'replica.transport.bytes{{peer="{t.name}"}}'] == len(want) + 17
    finally:
        srv.close()


def test_a_pipeline_ships_over_the_wire(obs_on, tmp_path, corpus):
    X, _ = corpus
    leader = T.open(str(tmp_path / "leader"))
    leader.insert(X[:96])
    srv = T.Server(leader.directory)
    try:
        fol = T.follower(leader.directory, str(tmp_path / "f0"), "f0")
        rep = T.Replication(leader, [fol], seal_bytes=1, transports=[_fast(T, srv)])
        rep.tick()
        assert rep.staleness(0) == 0 and same_rows(leader, fol.index)
    finally:
        srv.close()


def test_mangled_content_passes_the_wire_and_is_caught_by_the_follower(obs_on, tmp_path,
                                                                       corpus):
    X, _ = corpus
    got = []
    for p in BOTH:
        leader = p.open(str(tmp_path / p.name / "leader"))
        leader.insert(X[:96])
        srv = p.Server(leader.directory)
        try:
            hits = {"n": 0}

            def mangle(data, hits=hits):
                hits["n"] += 1
                if hits["n"] == 1:
                    b = bytearray(data)
                    b[len(b) // 2] ^= 0xFF
                    return bytes(b)
                return data

            srv.mangle = mangle
            fol = p.follower(leader.directory, str(tmp_path / p.name / "f0"), "f0")
            rep = p.Replication(leader, [fol], seal_bytes=1, transports=[_fast(p, srv)])
            rep.tick()
            assert rep.staleness(0) == 0 and same_rows(leader, fol.index)
            got.append((hits["n"], _counters(p, ("replica.ship",))))
        finally:
            srv.close()
    assert got[0] == got[1]
    assert got[1][1]['replica.ship.rejected{follower="f0",reason="crc"}'] == 1


def test_a_torn_wire_is_retried_then_typed(obs_on, leader_dir):
    (_, path), = leader_dir.wal.sealed_segments()
    srv = T.Server(leader_dir.directory)
    try:
        srv.truncate_wire = 7

        def heal(_):
            srv.truncate_wire = None

        assert len(_fast(T, srv, sleep=heal)(path, 0, 64)) == 64
        srv.truncate_wire = 7
        t = _fast(T, srv, timeout_s=0.5)
        t0 = time.monotonic()
        with pytest.raises(T.TransportError):
            t(path, 0, 64)
        assert time.monotonic() - t0 < 5.0
        assert _counters(T)[f'replica.transport.errors{{kind="TransportError",peer="{t.name}"}}'] \
            == 1
    finally:
        srv.close()


def test_a_slow_peer_hits_the_read_timeout(leader_dir):
    srv = T.Server(leader_dir.directory)
    try:
        srv.delay_s = 1.0
        t = _fast(T, srv, timeout_s=0.1, policy=T.RetryPolicy(max_attempts=1, base_delay_s=0.0,
                                                              retryable=(OSError,)))
        t0 = time.monotonic()
        with pytest.raises(T.TransportError):
            t(os.path.join(leader_dir.directory, "MANIFEST.json"), 0, 64)
        assert time.monotonic() - t0 < 5.0
    finally:
        srv.delay_s = 0.0
        srv.close()


def test_a_dead_peer_is_typed_and_opens_the_breaker(leader_dir):
    srv = T.Server(leader_dir.directory)
    target = os.path.join(leader_dir.directory, "MANIFEST.json")
    breaker = T.Breaker("peer", failure_threshold=1, reset_timeout_s=60.0)
    t = _fast(T, srv, timeout_s=0.2, breaker=breaker)
    srv.close()
    t0 = time.monotonic()
    with pytest.raises(T.TransportError):
        t(target, 0, 16)
    assert time.monotonic() - t0 < 5.0 and breaker.state == T.Breaker.OPEN
    fetches = t.fetches
    with pytest.raises(T.TransportError, match="breaker open"):
        t(target, 0, 16)
    assert t.fetches == fetches


def test_transport_read_fires_with_jax_s_context(leader_dir):
    got = []
    target = os.path.join(leader_dir.directory, "MANIFEST.json")
    for p in BOTH:
        srv = p.Server(leader_dir.directory)
        try:
            t = _fast(p, srv)
            with p.faults.injected("transport.read", error=OSError("injected"),
                                   match={"peer": t.name, "offset": 0, "nbytes": 16}) as spec:
                with pytest.raises(OSError):
                    t(target, 0, 16)
            data = t(target, 0, 1 << 20)
            with open(target, "rb") as f:
                assert data == f.read()
            got.append((spec.calls, spec.fired, t.fetches))
        finally:
            srv.close()
    assert got == [(1, 1, 1)] * 2


def test_paths_outside_the_served_root_are_refused(tmp_path, leader_dir):
    (tmp_path / "secret").write_text("no")
    srv = T.Server(leader_dir.directory)
    try:
        t = _fast(T, srv, policy=T.RetryPolicy(max_attempts=1, base_delay_s=0.0,
                                               retryable=(OSError,)))
        for path in (str(tmp_path / "secret"),
                     os.path.join(leader_dir.directory, "..", "secret")):
            with pytest.raises(T.TransportError, match="refused"):
                t(path, 0, 16)
    finally:
        srv.close()


def test_the_retry_schedule_equals_jax_s(leader_dir):
    """A torn wire on every attempt: both clients sleep the same seeded
    backoff before giving up."""
    (_, path), = leader_dir.wal.sealed_segments()
    got = []
    for p in BOTH:
        srv = p.Server(leader_dir.directory)
        try:
            srv.truncate_wire = 5
            sleeps = []
            t = p.Transport(srv.host, srv.port, timeout_s=0.5, seed=3, sleep=sleeps.append,
                            policy=p.RetryPolicy(max_attempts=4, base_delay_s=0.01,
                                                 retryable=(OSError,)))
            with pytest.raises(p.TransportError):
                t(path, 0, 32)
            got.append(sleeps)
        finally:
            srv.close()
    assert got[0] == got[1] and len(got[1]) == 3
