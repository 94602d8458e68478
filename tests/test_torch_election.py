"""The port's shard election (master/election.py) against the control
plane's: the scenarios of tests/test_election.py through both packages
(transition counters as deltas of each package's own registry), and one
lock contended by a replica of each package through one apiserver (the
HTTP facade, both packages' REST clients): the lock annotations, the
fence bump on takeover and the store's fence check agree across them."""

import os
import time

import pytest

from tests.torch_control_plane import BOTH, IDS, JAX, TORCH


@pytest.fixture(params=BOTH, ids=IDS)
def pkg(request):
    return request.param


def make_election(pkg, kube, replica, shards=1, url="", renew=0.5, ttl=1.5,
                  **hooks):
    ha = pkg.mod("master.shardring").HAConfig(
        shards=shards, election=True, replica=replica,
        advertise_url=url or f"http://{replica}:8080",
        renew_interval_s=renew, lease_duration_s=ttl)
    return pkg.mod("master.election").ShardElection(kube, ha, **hooks)


def fake(pkg):
    return pkg.mod("k8s.client").FakeKubeClient()


def transitions(pkg, outcome, shard="0"):
    return pkg.registry.election_transitions.value(shard=shard,
                                                   outcome=outcome)


def test_acquires_free_shard_and_renews(pkg):
    kube = fake(pkg)
    acquired = []
    before = transitions(pkg, "acquired")
    election = make_election(pkg, kube, "m0",
                             on_acquire=lambda s: acquired.append(s))
    election.tick()
    assert acquired == [0]
    assert election.is_leader(0) and election.token(0) == 1
    assert election.owned() == [0]
    election.tick()
    assert election.token(0) == 1
    assert acquired == [0], "a plain renew is no new acquisition"
    assert transitions(pkg, "acquired") - before == 1
    assert pkg.registry.election_is_leader.value(shard="0") == 1
    snap = election.snapshot()
    assert snap["shards"]["0"]["holder"] == "m0"
    assert snap["shards"]["0"]["leader"] is True
    assert snap["transitions"] == 1


def test_acquire_race_has_one_winner(pkg):
    kube = fake(pkg)
    a = make_election(pkg, kube, "m0")
    b = make_election(pkg, kube, "m1")
    a.tick()
    b.tick()
    assert a.is_leader(0) and not b.is_leader(0)
    assert b.leaders()[0]["holder"] == "m0"
    assert b.leaders()[0]["url"] == "http://m0:8080"


def test_dead_leader_fails_over_with_fence_bump(pkg):
    kube = fake(pkg)
    a = make_election(pkg, kube, "m0", ttl=0.2, renew=0.1)
    b = make_election(pkg, kube, "m1", ttl=0.2, renew=0.1,
                      url="http://m1:8080")
    a.tick()
    assert a.is_leader(0)
    b.tick()
    assert not b.is_leader(0)
    time.sleep(0.25)
    assert not a.is_leader(0), "a non-renewing holder must stop acting"
    lost = transitions(pkg, "lost")
    b.tick()
    assert b.is_leader(0)
    assert b.token(0) == 2, "takeover must bump the fencing token"
    a.tick()
    assert not a.is_leader(0)
    assert transitions(pkg, "lost") - lost == 1


def test_lost_shard_fires_on_lose_hook_and_event(pkg):
    kube = fake(pkg)
    lost = []
    events = pkg.mod("utils.events").EVENTS
    a = make_election(pkg, kube, "m0", ttl=0.2, renew=0.1,
                      on_lose=lambda s: lost.append(s))
    b = make_election(pkg, kube, "m1", ttl=0.2, renew=0.1)
    a.tick()
    time.sleep(0.25)
    b.tick()
    a.tick()
    assert lost == [0]
    tail = [(e["kind"], (e.get("attrs") or {}).get("replica"))
            for e in events.tail(256)]
    assert ("election_lost", "m0") in tail
    assert ("election_acquired", "m1") in tail


def test_demote_on_fenced_write(pkg):
    kube = fake(pkg)
    lost = []
    a = make_election(pkg, kube, "m0", on_lose=lambda s: lost.append(s))
    a.tick()
    assert a.is_leader(0)
    a.demote(0, "fenced store write")
    assert not a.is_leader(0) and lost == [0]
    assert a.token(0) is None


def test_restart_within_own_ttl_resumes_without_fence_bump(pkg):
    kube = fake(pkg)
    a = make_election(pkg, kube, "m0")
    a.tick()
    assert a.token(0) == 1
    a2 = make_election(pkg, kube, "m0")
    a2.tick()
    assert a2.is_leader(0) and a2.token(0) == 1


def test_multi_shard_ownership_is_per_shard(pkg):
    kube = fake(pkg)
    a = make_election(pkg, kube, "m0", shards=2)
    b = make_election(pkg, kube, "m1", shards=2)
    a.tick()
    assert set(a.owned()) == {0, 1}
    b.tick()
    assert b.owned() == []
    assert {b.leaders()[s]["holder"] for s in (0, 1)} == {"m0"}


def test_null_election_owns_everything_with_no_traffic(pkg):
    kube = fake(pkg)
    null = pkg.mod("master.election").NullElection(4)
    assert null.is_leader(3) and null.token(0) is None
    assert null.owned() == [0, 1, 2, 3]
    null.tick()
    null.start()
    null.stop()
    assert kube.cm_calls == 0
    assert null.snapshot() == {"enabled": False, "shards": 4}


def test_election_loop_start_stop(pkg):
    kube = fake(pkg)
    a = make_election(pkg, kube, "m0", renew=0.05, ttl=0.3)
    a.start()
    deadline = time.monotonic() + 5.0
    while not a.is_leader(0):
        assert time.monotonic() < deadline
        time.sleep(0.01)
    a.stop()
    cm = kube.get_config_map(pkg.consts.DEFAULT_POOL_NAMESPACE,
                             a.lock_name(0))
    assert cm["metadata"]["annotations"]["tpumounter.io/holder"] == "m0"


def test_deleted_lock_object_cannot_livelock_below_the_store_fence(pkg):
    kube = fake(pkg)
    election = make_election(pkg, kube, "m0")
    election.tick()
    assert election.token(0) == 1
    election.note_fence(0, 7)
    election.demote(0, "fenced store write")
    assert not election.is_leader(0)
    election.tick()
    assert election.is_leader(0) and election.token(0) == 8
    kube.delete_config_map(pkg.consts.DEFAULT_POOL_NAMESPACE,
                           election.lock_name(0))
    election.note_fence(0, 11)
    election.demote(0, "fenced again")
    election.tick()
    assert election.is_leader(0) and election.token(0) == 12


def test_validity_anchored_at_tick_start_not_patch_completion(pkg):
    chaos = pkg.mod("testing.chaos")
    kube = fake(pkg)
    election = make_election(pkg, kube, "m0", ttl=1.5)
    kube.faults = chaos.FaultInjector([chaos.Fault(
        op="GET", resource="configmaps", latency_s=0.25, times=50)])
    t0 = time.monotonic()
    election.tick()
    kube.faults = None
    assert election._held[0].valid_until <= t0 + 1.5 + 0.05


# -- one lock, a replica of each package ---------------------------------------

@pytest.fixture
def one_apiserver(tmp_path):
    """One fake cluster behind the HTTP facade, and a REST client of each
    package on it: what two replicas of a mixed deployment share."""
    server = TORCH.mod("testing.http_apiserver").HttpApiserver(
        TORCH.mod("k8s.client").FakeKubeClient())
    sa = tmp_path / "serviceaccount"
    os.makedirs(sa)
    (sa / "token").write_text("t")
    clients = {p.name: p.mod("k8s.client").InClusterKubeClient(
        host=server.base, sa_dir=str(sa)) for p in BOTH}
    yield server, clients
    server.close()


@pytest.mark.parametrize("first,second", [(JAX, TORCH), (TORCH, JAX)],
                         ids=["jax-leads", "torch-leads"])
def test_mixed_replicas_contend_for_one_lock(one_apiserver, first, second):
    server, clients = one_apiserver
    a = make_election(first, clients[first.name], "m0", ttl=1.0, renew=0.1)
    b = make_election(second, clients[second.name], "m1", ttl=1.0,
                      renew=0.1)
    # the lock lives in the namespace the config names; both must agree
    a.config.namespace = b.config.namespace = "pool"
    a.tick()
    b.tick()
    assert a.is_leader(0) and not b.is_leader(0)
    assert b.leaders()[0] == {"holder": "m0", "url": "http://m0:8080",
                              "fence": 1, "expired": False}
    lock = server.kube.get_config_map("pool", a.lock_name(0))
    assert lock["metadata"]["name"] == "tpu-mounter-election-0"
    assert sorted(lock["metadata"]["annotations"]) == [
        "tpumounter.io/fence", "tpumounter.io/holder",
        "tpumounter.io/renew-unix", "tpumounter.io/url"]
    # the first replica dies; the other takes over with a bumped fence
    time.sleep(1.05)
    b.tick()
    assert b.is_leader(0) and b.token(0) == 2
    a.tick()
    assert not a.is_leader(0)
    # and its store fences the deposed replica's writes (token 1 < 2)
    stores = {}
    for p, e in ((first, a), (second, b)):
        stores[p.name] = p.mod("master.store").IntentStore(
            clients[p.name], p.mod("master.shardring").ShardRing(1),
            "pool", election=_Token(e, 1 if e is a else 2))
    lease = second.mod("master.store").LeaseRecord(
        namespace="default", pod="w", tenant="t", chips=1)
    assert stores[second.name].put_lease(lease)
    with pytest.raises(first.errors.StoreFencedError) as err:
        stores[first.name].put_lease(first.mod("master.store").LeaseRecord(
            namespace="default", pod="zombie", tenant="t", chips=1))
    assert (err.value.token, err.value.fence) == (1, 2)
    leases, _, torn = stores[first.name].rehydrate(0)
    assert torn == 0 and [r.to_json() for r in leases] == [lease.to_json()]


class _Token:
    """A replica's election as its store sees it, pinned at ``token``
    (the deposed replica keeps presenting its old one)."""

    enabled = True

    def __init__(self, election, token):
        self.replica = election.replica
        self._token = token

    def token(self, shard):
        return self._token

    def leaders(self):
        return {}
