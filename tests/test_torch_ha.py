"""The port's HA plane (the gateway's shard gate and forwarding, the
broker's HA hooks, ``MultiMasterStack``) against the control plane's: the
scenarios of tests/test_ha.py through both packages, with the short
timings of the multi-master stack (renew 0.15 s, TTL 0.45 s). Both
packages answer the forwarding cases with the same status codes and
headers (proxy 200, redirect 307 with ``Location``, leaderless 503 with
``Retry-After``), and a leader killed with parked waiters hands them to
its peer, which adopts and drains them with no double actuation.
(tests/test_ha.py's CLI and ``doctor`` cases wait for the port's CLI.)"""

import http.client
import json
import threading
import time
import urllib.parse

import pytest

from tests.test_torch_broker import BrokerStack, add, events_drained, remove
from tests.torch_control_plane import BOTH, IDS, TORCH


@pytest.fixture(params=BOTH, ids=IDS)
def pkg(request):
    return request.param


@pytest.fixture(autouse=True)
def threaded_front(monkeypatch):
    """Both packages' masters on the thread-per-request front: the
    control plane's multiplexed front takes 2 s to stop (its acceptor
    sits in accept(2)), and these stacks start and stop a dozen masters.
    The handler, and so every status code and header, is the same on
    either front; the port's multiplexed front carries the HA rig
    (tests/test_torch_ha_attach_gpu.py) and the group-commit stack."""
    monkeypatch.setenv("TPU_GATEWAY_FRONT", "threaded")


def req(base, method, path, body=None, headers=None, timeout=30.0):
    """One raw round trip (no redirect following): (status, headers,
    payload)."""
    parsed = urllib.parse.urlparse(base)
    conn = http.client.HTTPConnection(parsed.hostname, parsed.port,
                                      timeout=timeout)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        raw = resp.read()
        try:
            payload = json.loads(raw)
        except ValueError:
            payload = {"raw": raw.decode(errors="replace")}
        return resp.status, dict(resp.getheaders()), payload
    finally:
        conn.close()


def add_path(pod, n, entire=False, ns="default"):
    return (f"/addgpu/namespace/{ns}/pod/{pod}/gpu/{n}"
            f"/isEntireMount/{'true' if entire else 'false'}")


def remove_path(pod, force=False, ns="default"):
    return (f"/removegpu/namespace/{ns}/pod/{pod}"
            f"/force/{'true' if force else 'false'}")


def config(pkg, **kw):
    return pkg.mod("master.admission").BrokerConfig(**kw)


@pytest.fixture
def mm_factory(pkg, tmp_path):
    stacks = []

    def make(**kwargs):
        rig = pkg.rig(tmp_path / f"mm{len(stacks)}",
                      n_chips=kwargs.pop("n_chips", 4))
        stack = pkg.mod("testing.sim").MultiMasterStack(rig, **kwargs)
        stacks.append(stack)
        return stack

    yield make
    for stack in stacks:
        stack.close()


def wait_until(pred, timeout_s=10.0, what="condition"):
    deadline = time.monotonic() + timeout_s
    while not pred():
        if time.monotonic() >= deadline:
            raise TimeoutError(f"timed out waiting for {what}")
        time.sleep(0.03)


def invariants(pkg, broker, sim, store=None):
    pkg.mod("testing.chaos").assert_broker_invariants(broker, sim,
                                                      store=store)


def ghost_lock(pkg, kube):
    """The shard's lock held by an unreachable ghost: live deadline, no
    advertised URL — no takeover, nowhere to forward."""
    c = pkg.consts
    kube.create_config_map(c.DEFAULT_POOL_NAMESPACE, {
        "metadata": {
            "name": f"{c.ELECTION_CONFIGMAP_PREFIX}0",
            "annotations": {
                "tpumounter.io/holder": "ghost",
                "tpumounter.io/url": "",
                c.STORE_FENCE_ANNOTATION: "7",
                "tpumounter.io/renew-unix": f"{time.time() + 300:.3f}"}}})


def ha_gateway(pkg, stack, **ha):
    HAConfig = pkg.mod("master.shardring").HAConfig
    admission = pkg.mod("master.admission")
    return pkg.mod("master.gateway").MasterGateway(
        stack.kube, pkg.mod("master.discovery").WorkerDirectory(
            stack.kube, grpc_port=stack.port),
        broker=admission.AttachBroker(stack.kube, admission.BrokerConfig()),
        ha=HAConfig(**ha))


# -- forwarding ----------------------------------------------------------------

def test_non_owner_proxies_to_leader(pkg, mm_factory):
    stack = mm_factory(masters=2, shards=2)
    stack.wait_converged()
    leader = stack.leader_for("default")
    follower = [i for i in stack.live() if i != leader][0]
    before = pkg.registry.shard_forwards.value(mode="proxy", outcome="ok")
    status, _, payload = req(stack.bases[follower], "GET",
                             add_path("workload", 2))
    assert status == 200 and payload["result"] == "SUCCESS"
    assert payload.get("forwarded_shard") == stack.ring.shard_of("default")
    assert len(stack.gateways[leader].broker.leases.leases()) == 1
    assert stack.gateways[follower].broker.leases.leases() == []
    status, _, payload = req(stack.bases[follower], "POST",
                             remove_path("workload"), body=b"{}")
    assert status == 200 and payload["result"] == "SUCCESS"
    assert stack.gateways[leader].broker.leases.leases() == []
    assert pkg.registry.shard_forwards.value(
        mode="proxy", outcome="ok") - before == 2
    invariants(pkg, stack.gateways[leader].broker, stack.rig.sim,
               store=stack.gateways[leader].broker.store)


def test_redirect_mode_returns_307_with_location(pkg, mm_factory):
    stack = mm_factory(masters=2, shards=2, forward="redirect")
    stack.wait_converged()
    leader = stack.leader_for("default")
    follower = [i for i in stack.live() if i != leader][0]
    path = add_path("workload", 2)
    status, headers, payload = req(stack.bases[follower], "GET", path)
    assert status == 307 and payload["result"] == "ShardRedirect"
    location = headers.get("Location")
    assert location == stack.bases[leader] + path
    parsed = urllib.parse.urlparse(location)
    status, _, payload = req(f"http://{parsed.netloc}", "GET", parsed.path)
    assert status == 200 and payload["result"] == "SUCCESS"


def test_leaderless_shard_answers_503_with_retry_after(pkg, tmp_path):
    stack = BrokerStack(pkg, tmp_path)
    try:
        ghost_lock(pkg, stack.kube)
        gw = ha_gateway(pkg, stack, shards=1, election=True, store=False,
                        replica="m-local",
                        advertise_url="http://127.0.0.1:1",
                        renew_interval_s=0.1, lease_duration_s=30.0)
        gw.election.tick()
        assert not gw.election.is_leader(0)
        status, payload = gw.handle("GET", add_path("workload", 2))
        assert status == 503 and payload["result"] == "ShardLeaderUnknown"
        assert payload["retry_after_s"] >= 0.1
        status, payload = gw.handle("GET", add_path("workload", 2),
                                    headers={"X-Tpu-Forwarded": "1"})
        assert status == 503 and payload["result"] == "ShardLeaderUnknown"
    finally:
        stack.close()


def _forwarding_answers(pkg, tmp_path) -> list:
    """Status, result and the forwarding headers of each forwarding
    case, through one package's stacks."""
    out = []
    for i, forward in enumerate(("proxy", "redirect")):
        rig = pkg.rig(tmp_path / f"{pkg.name}-{forward}", n_chips=4)
        stack = pkg.mod("testing.sim").MultiMasterStack(
            rig, masters=2, shards=2, forward=forward)
        try:
            stack.wait_converged()
            leader = stack.leader_for("default")
            follower = 1 - leader
            status, headers, payload = req(stack.bases[follower], "GET",
                                           add_path("workload", 1))
            location = headers.get("Location", "")
            out.append((forward, status, payload["result"],
                        location.replace(stack.bases[leader], "<leader>"),
                        payload.get("forwarded_shard")))
        finally:
            stack.close()
    stack = BrokerStack(pkg, tmp_path / f"{pkg.name}-ghost")
    try:
        ghost_lock(pkg, stack.kube)
        gw = ha_gateway(pkg, stack, shards=1, election=True, store=False,
                        replica="m-local", renew_interval_s=0.1,
                        lease_duration_s=30.0)
        gw.election.tick()
        server = gw.serve(port=0, address="127.0.0.1")
        try:
            status, headers, payload = req(
                f"http://127.0.0.1:{server.server_port}", "GET",
                add_path("workload", 1))
            out.append(("leaderless", status, payload["result"],
                        headers.get("Retry-After"),
                        payload["retry_after_s"]))
        finally:
            server.shutdown()
    finally:
        stack.close()
    return out


def test_forwarding_answers_agree_across_packages(tmp_path):
    answers = [_forwarding_answers(p, tmp_path) for p in BOTH]
    assert answers[0] == answers[1]
    assert [a[:3] for a in answers[1]] == [
        ("proxy", 200, "SUCCESS"), ("redirect", 307, "ShardRedirect"),
        ("leaderless", 503, "ShardLeaderUnknown")]
    assert answers[1][1][3] == \
        "<leader>" + add_path("workload", 1)
    assert answers[1][2][3] == "1"


# -- shard hand-off wakes waiters ----------------------------------------------

def test_lost_shard_wakes_waiters_to_reroute(pkg, tmp_path):
    stack = BrokerStack(pkg, tmp_path,
                        config=config(pkg, queue_timeout_s=20.0),
                        extra_pods=("w2",))
    try:
        broker = stack.gateway.broker
        broker.bind_ha(None, pkg.mod("master.shardring").ShardRing(1),
                       pkg.mod("master.election").NullElection(1))
        assert add(stack.gateway, "workload", 4, entire=True)[0] == 200
        done = {}

        def park():
            done["res"] = add(stack.gateway, "w2", 2, rid="moved-1")

        thread = threading.Thread(target=park, daemon=True)
        thread.start()
        wait_until(lambda: broker._waiters, what="waiter to park")
        broker.on_shard_lost(0)
        thread.join(timeout=10)
        assert not thread.is_alive()
        status, payload = done["res"]
        assert status == 503 and payload["result"] == "ShardMoved"
        assert payload["retry_after_s"] >= 0.1
    finally:
        stack.close()


# -- restart rehydration (single master, store on) -----------------------------

def test_restart_rehydrates_leases_and_parked_waiters(pkg, tmp_path):
    cfg = config(pkg, queue_timeout_s=4.0)
    stack = BrokerStack(pkg, tmp_path, config=cfg, extra_pods=("w2",))
    try:
        kube = stack.kube
        ShardRing = pkg.mod("master.shardring").ShardRing
        NullElection = pkg.mod("master.election").NullElection
        IntentStore = pkg.mod("master.store").IntentStore
        NS = pkg.consts.DEFAULT_POOL_NAMESPACE
        store = IntentStore(kube, ShardRing(1), NS)
        old_gw = stack.gateway
        old_gw.broker.bind_ha(store, ShardRing(1), NullElection(1))
        status, body = add(old_gw, "workload", 4, entire=True, rid="hold-1")
        assert status == 200
        held_uuids = set(body["device_ids"])
        done = {}

        def park():
            done["res"] = add(old_gw, "w2", 2, rid="park-1")

        thread = threading.Thread(target=park, daemon=True)
        thread.start()
        wait_until(lambda: store.rehydrate(0)[1], what="waiter persisted")
        # "restart": a fresh gateway, broker and store over the cluster
        new_store = IntentStore(kube, ShardRing(1), NS)
        new_gw = stack.new_gateway(cfg)
        new_gw.broker.bind_ha(new_store, ShardRing(1), NullElection(1))
        new_gw.broker.bind_attempt_factory(new_gw._adopted_attempt)
        new_gw.broker.tick()
        lease = new_gw.broker.leases.get("default", "workload")
        assert lease is not None and lease.uuids == held_uuids
        wait_until(lambda: new_gw.broker._waiters,
                   what="adopted waiter to park")
        assert remove(new_gw, "workload")[0] == 200
        wait_until(lambda: new_gw.broker.leases.get("default", "w2"),
                   what="adopted waiter to be granted")
        thread.join(timeout=10)
        assert not thread.is_alive()
        status, payload = done["res"]
        assert status == 503 and payload.get("queue_timeout")
        events_drained(stack.rig.service)
        invariants(pkg, new_gw.broker, stack.rig.sim, store=new_store)
        attached = [e for e in kube.events
                    if e.get("reason") == f"{pkg.dev.upper()}Attached"]
        assert len(attached) == 2
    finally:
        stack.close()


# -- the failover ---------------------------------------------------------------

def test_leader_killed_mid_queue_peer_drains_persisted_waiters(pkg,
                                                               mm_factory):
    """Kill the leading master while its queue holds two persisted
    waiters: the surviving replica takes the shard over, rehydrates the
    parked intent from the store, and both attaches land exactly once."""
    stack = mm_factory(masters=2, shards=2,
                       broker_config=config(pkg, queue_timeout_s=8.0))
    rig = stack.rig
    for name in ("w2", "w3"):
        rig.provision_container(rig.sim.add_target_pod(name=name))
    stack.wait_converged()
    leader = stack.leader_for("default")
    survivor = [i for i in stack.live() if i != leader][0]
    shard = stack.ring.shard_of("default")
    status, _, _ = req(stack.bases[leader], "GET",
                       add_path("workload", 4, entire=True),
                       headers={"X-Request-Id": "hold-1"})
    assert status == 200
    results = {}

    def park(pod, rid):
        try:
            results[rid] = req(stack.bases[leader], "GET", add_path(pod, 2),
                               headers={"X-Request-Id": rid}, timeout=20.0)
        except OSError as e:
            results[rid] = ("dead-master", str(e))

    threads = [threading.Thread(target=park, args=(pod, rid), daemon=True)
               for pod, rid in (("w2", "park-a"), ("w3", "park-b"))]
    for thread in threads:
        thread.start()
    leader_store = stack.gateways[leader].broker.store
    wait_until(lambda: len(leader_store.rehydrate(shard)[1]) == 2,
               what="both waiters persisted")
    fence = leader_store.rehydrate(shard) and int(
        stack.kube.get_config_map(
            pkg.consts.DEFAULT_POOL_NAMESPACE, leader_store.cm_name(shard)
        )["metadata"]["annotations"][pkg.consts.STORE_FENCE_ANNOTATION])
    stack.kill(leader)
    surv = stack.gateways[survivor]
    wait_until(lambda: surv.election.is_leader(shard), timeout_s=5.0,
               what="failover")
    assert surv.election.token(shard) > fence
    wait_until(lambda: len(surv.broker._waiters) == 2,
               what="adopted waiters to park on the survivor")
    status, _, _ = req(stack.bases[survivor], "POST",
                       remove_path("workload"), body=b"{}")
    assert status == 200
    wait_until(lambda: (surv.broker.leases.get("default", "w2")
                        and surv.broker.leases.get("default", "w3")),
               what="both adopted waiters granted")
    for thread in threads:
        thread.join(timeout=20)
        assert not thread.is_alive()
    events_drained(rig.service)
    attached = [e for e in rig.sim.kube.events
                if e.get("reason") == f"{pkg.dev.upper()}Attached"]
    assert len(attached) == 3, [e.get("message") for e in attached]
    invariants(pkg, surv.broker, rig.sim, store=surv.broker.store)
    got = (set(surv.broker.leases.get("default", "w2").uuids)
           | set(surv.broker.leases.get("default", "w3").uuids))
    assert len(got) == 4


def restart(pkg, stack, i):
    """Master ``i`` back as a fresh replica under its identity: the
    port's ``MultiMasterStack.restart``, and the same steps on the control
    plane's stack (which has no such method)."""
    if pkg is TORCH:
        stack.restart(i)
        return
    old = stack.gateways[i]
    ha = pkg.mod("master.shardring").HAConfig(
        shards=stack.shards, election=True, store=True,
        replica=old.ha.replica, forward=old.ha.forward,
        renew_interval_s=old.ha.renew_interval_s,
        lease_duration_s=old.ha.lease_duration_s,
        namespace=old.ha.namespace)
    gateway = pkg.mod("master.gateway").MasterGateway(
        stack.kube, pkg.mod("master.discovery").WorkerDirectory(stack.kube),
        worker_tracez_base=lambda target: None,
        broker=pkg.mod("master.admission").AttachBroker(stack.kube), ha=ha)
    server = gateway.serve(port=0, address="127.0.0.1")
    ha.advertise_url = f"http://127.0.0.1:{server.server_port}"
    stack.gateways[i], stack.http_servers[i] = gateway, server
    stack.bases[i] = ha.advertise_url
    stack.dead.discard(i)


def test_restarted_replica_does_not_take_the_shard_back(pkg, mm_factory):
    # a TTL with slack for a loaded host: the peer must keep renewing
    # through the whole observation window below
    stack = mm_factory(masters=2, shards=1, renew_interval_s=0.2,
                       lease_duration_s=1.5)
    stack.wait_converged()
    leader = stack.leader_for("default")
    peer = 1 - leader
    stack.kill(leader)
    wait_until(lambda: stack.gateways[peer].election.is_leader(0),
               timeout_s=5.0, what="failover")
    token = stack.gateways[peer].election.token(0)
    restart(pkg, stack, leader)
    time.sleep(0.2 * 4)
    assert stack.gateways[peer].election.is_leader(0)
    assert stack.gateways[peer].election.token(0) == token
    assert not stack.gateways[leader].election.is_leader(0)
    stack.wait_converged()
    status, _, payload = req(stack.bases[leader], "GET",
                             add_path("workload", 1))
    assert status == 200 and payload.get("forwarded_shard") == 0


# -- fleet view ----------------------------------------------------------------

def test_fleetz_shows_master_roles_and_store_lag(pkg, mm_factory):
    stack = mm_factory(masters=2, shards=2)
    stack.wait_converged()
    leader0 = stack.leader_for("default")
    masters = stack.gateways[leader0].fleet.snapshot()["masters"]
    assert masters["enabled"] is True
    assert masters["replica"] == f"master-{leader0}"
    shards = masters["election"]["shards"]
    assert len(shards) == 2
    assert any(s["leader"] for s in shards.values())
    assert all(s["holder"].startswith("master-") for s in shards.values())
    assert masters["store"]["lag_s"] == 0.0
    status, _, payload = req(stack.bases[leader0], "GET", "/fleetz")
    assert status == 200 and "masters" in payload
    status, _, brokerz = req(stack.bases[leader0], "GET", "/brokerz")
    assert brokerz["ha"]["enabled"] is True and brokerz["ha"]["shards"] == 2


# -- defaults pin ----------------------------------------------------------------

def test_ha_defaults_off_preserve_single_master_semantics(pkg, tmp_path):
    stack = BrokerStack(pkg, tmp_path,
                        config=config(pkg, queue_timeout_s=0.3),
                        extra_pods=("w2",))
    try:
        gw = stack.gateway
        assert gw.ring is None and gw.election is None
        assert gw.broker.store is None
        assert pkg.mod("master.shardring").HAConfig().enabled is False
        assert add(gw, "workload", 4, entire=True)[0] == 200
        status, payload = add(gw, "w2", 2)
        assert status == 503 and payload.get("queue_timeout")
        assert remove(gw, "workload")[0] == 200
        assert stack.kube.cm_calls == 0
        assert gw.broker.snapshot()["ha"] == {"enabled": False}
        assert gw._shard_gate("default", "GET", "/x", b"", "-", {}) is None
    finally:
        stack.close()


def test_shard_acquired_without_store_still_rederives(pkg, tmp_path):
    stack = BrokerStack(pkg, tmp_path)
    try:
        broker = stack.gateway.broker
        broker.bind_ha(None, pkg.mod("master.shardring").ShardRing(1),
                       pkg.mod("master.election").NullElection(1))
        broker.ensure_rederived()
        assert broker._rederived is True
        broker.on_shard_acquired(0)
        assert broker._rederived is False
    finally:
        stack.close()


def test_sharded_slice_rejects_mixed_namespaces(pkg, mm_factory):
    stack = mm_factory(masters=2, shards=2)
    stack.wait_converged()
    body = json.dumps({"pods": [
        {"namespace": "default", "pod": "a"},
        {"namespace": "other", "pod": "b"}],
        f"{pkg.dev}sPerHost": 2}).encode()
    for route in (f"/add{pkg.dev}slice", f"/remove{pkg.dev}slice",
                  "/slice/resize"):
        status, _, payload = req(stack.bases[0], "POST", route, body=body)
        assert status == 400 and "span namespaces" in payload["message"]


class _Recorder:
    enabled = True

    def __init__(self):
        self.noted, self.demoted = [], []

    def is_leader(self, shard):
        return True

    def owned(self):
        return [0]

    def token(self, shard):
        return 1

    def note_fence(self, shard, fence):
        self.noted.append((shard, fence))

    def demote(self, shard, reason=""):
        self.demoted.append(shard)


def test_tick_routes_flush_dirty_fence_to_demotion(pkg, tmp_path):
    stack = BrokerStack(pkg, tmp_path)
    try:
        broker = stack.gateway.broker
        election = _Recorder()
        broker.bind_ha(None, pkg.mod("master.shardring").ShardRing(1),
                       election)
        fenced = pkg.errors.StoreFencedError

        class _FencingStore:
            def flush_pending(self):
                return 0

            def flush_dirty(self):
                raise fenced(0, 1, 7)

            def rehydrate(self, shard):
                return [], [], 0

            def stop(self):
                pass

        broker.store = _FencingStore()
        broker._rehydrated_shards.add(0)
        broker.tick()
        assert election.noted == [(0, 7)]
        assert election.demoted == [0]
    finally:
        stack.close()


def test_lost_shard_prunes_adoption_history(pkg, tmp_path):
    stack = BrokerStack(pkg, tmp_path)
    try:
        broker = stack.gateway.broker
        broker.bind_ha(None, pkg.mod("master.shardring").ShardRing(2),
                       pkg.mod("master.election").NullElection(2))
        broker._adopted_rids = {"rid-s0": 0, "rid-s1": 1}
        broker.on_shard_lost(0)
        assert broker._adopted_rids == {"rid-s1": 1}
    finally:
        stack.close()


def test_store_only_config_still_surfaces_store_health(pkg, tmp_path):
    stack = BrokerStack(pkg, tmp_path)
    try:
        gw = ha_gateway(pkg, stack, shards=1, election=False, store=True,
                        replica="m-solo")
        view = gw._ha_view()
        assert view["enabled"] is True
        assert view["store"]["lag_s"] == 0.0
        assert view["election"]["enabled"] is False
    finally:
        stack.close()
