"""Node failure domain, unit half, through both packages: the health state
machine (master/nodehealth.py), the broker's lease-fencing seam, the
reaper's fence-after-N-failures escape, the worker-directory negative
cache, and the off / idle payload pins — the cases of
tests/test_nodehealth.py, each run against the control plane and the port
with the same inputs and the same expected answers. One scrape sequence
fed to both packages' trackers gives the same state sequence, events and
gauge. The chaos acceptance lives in tests/test_torch_node_chaos.py; the
CLI and doctor cases wait for the port's CLI (ROADMAP Queue 1 item 13)."""

import time

import pytest

from tests.torch_control_plane import BOTH, IDS


@pytest.fixture(params=BOTH, ids=IDS)
def pkg(request):
    return request.param


def _feed(fresh=True, missed=0, healthz="ok"):
    return {"fresh": fresh, "missed_ticks": missed, "healthz": healthz}


def _tracker(pkg, **kw):
    return pkg.mod("master.nodehealth").NodeHealthTracker(**kw)


def _kinds(pkg, node):
    return [e["kind"] for e in pkg.mod("utils.events").EVENTS.tail(200)
            if e.get("node") == node]


def _node(pkg, name, **status):
    sim = pkg.mod("testing.sim")
    node = (sim.make_gpu_node(name=name) if pkg.name == "torch"
            else sim.make_tpu_node(name=name))
    node.update(status)
    return node


# -- the state machine ---------------------------------------------------------

def test_states_escalate_suspect_then_dead_with_events(pkg):
    dead, drained = [], []
    tracker = _tracker(pkg, on_dead=dead.append, on_drain=drained.append,
                       suspect_after_ticks=2, dead_after_ticks=4)
    node = f"nh-esc-node-{pkg.name}"
    tracker.ingest({node: _feed(fresh=True)})
    assert tracker.state(node) == "healthy"
    assert not tracker.cordoned(node)
    for missed in (1, 2, 3, 4):
        tracker.ingest({node: _feed(fresh=False, missed=missed)})
    assert tracker.state(node) == "dead"
    assert tracker.cordoned(node)
    assert dead == [node]
    assert drained == []
    assert _kinds(pkg, node) == ["node_suspect", "node_dead"]
    assert pkg.registry.node_health_state.value(node=node) == 3.0
    # dying again without recovering must not re-fire on_dead
    tracker.ingest({node: _feed(fresh=False, missed=9)})
    assert dead == [node]


def test_never_scraped_node_is_never_suspected(pkg):
    tracker = _tracker(pkg, suspect_after_ticks=1, dead_after_ticks=2)
    node = "nh-unseen-node"
    for missed in range(1, 10):
        tracker.ingest({node: _feed(fresh=False, missed=missed)})
    assert tracker.state(node) == "healthy"


def test_recovery_needs_consecutive_clean_scrapes(pkg):
    tracker = _tracker(pkg, suspect_after_ticks=1, dead_after_ticks=10,
                       recover_ticks=2)
    node = f"nh-rec-node-{pkg.name}"
    tracker.ingest({node: _feed(fresh=True)})
    tracker.ingest({node: _feed(fresh=False, missed=1)})
    assert tracker.state(node) == "suspect"
    tracker.ingest({node: _feed(fresh=True)})
    assert tracker.state(node) == "suspect"     # hysteresis: 1 < 2
    tracker.ingest({node: _feed(fresh=True)})
    assert tracker.state(node) == "healthy"
    assert _kinds(pkg, node) == ["node_suspect", "node_healthy"]


def test_flapping_port_cannot_complete_recovery_on_a_missed_scrape(pkg):
    tracker = _tracker(pkg, suspect_after_ticks=2, dead_after_ticks=10,
                       recover_ticks=2)
    node = "nh-flap-node"
    tracker.ingest({node: _feed(fresh=True)})
    tracker.ingest({node: _feed(fresh=False, missed=1)})
    tracker.ingest({node: _feed(fresh=False, missed=2)})
    assert tracker.state(node) == "suspect"
    for _ in range(4):      # fresh, missed, fresh, missed ...
        tracker.ingest({node: _feed(fresh=True)})
        assert tracker.state(node) == "suspect"
        tracker.ingest({node: _feed(fresh=False, missed=1)})
        assert tracker.state(node) == "suspect"
    tracker.ingest({node: _feed(fresh=True)})
    tracker.ingest({node: _feed(fresh=True)})
    assert tracker.state(node) == "healthy"     # 2 CONSECUTIVE


def test_draining_healthz_cordons_within_one_tick_and_fires_on_drain(pkg):
    drained = []
    tracker = _tracker(pkg, on_drain=drained.append)
    node = "nh-drain-node"
    tracker.ingest({node: _feed(fresh=True)})
    tracker.ingest({node: _feed(fresh=True, healthz="draining")})
    assert tracker.state(node) == "draining"
    assert tracker.cordoned(node)
    assert drained == [node]


def test_notready_condition_corroborates_silence_into_dead(pkg):
    kube = pkg.mod("k8s.client").FakeKubeClient()
    name = "nh-notready-node"
    kube.put_node(_node(pkg, name, status={"conditions": [
        {"type": "Ready", "status": "False"}]}))
    tracker = _tracker(pkg, kube=kube, suspect_after_ticks=2,
                       dead_after_ticks=50, node_poll_interval_s=0.0)
    tracker.ingest({name: _feed(fresh=True)})
    tracker.ingest({name: _feed(fresh=False, missed=1)})
    assert tracker.state(name) == "suspect"     # k8s says NotReady
    tracker.ingest({name: _feed(fresh=False, missed=2)})
    # NotReady + enough missed scrapes: dead WITHOUT the 50-tick window
    assert tracker.state(name) == "dead"
    assert tracker.snapshot()["nodes"][name]["reason"] == \
        "notready+scrape-silence"


def test_ready_node_veto_caps_silence_at_suspect(pkg, monkeypatch):
    kube = pkg.mod("k8s.client").FakeKubeClient()
    name = "nh-veto-node"
    kube.put_node(_node(pkg, name, status={"conditions": [
        {"type": "Ready", "status": "True"}]}))
    tracker = _tracker(pkg, kube=kube, suspect_after_ticks=2,
                       dead_after_ticks=4, node_poll_interval_s=0.0)
    tracker.ingest({name: _feed(fresh=True)})
    for missed in range(1, 8):
        tracker.ingest({name: _feed(fresh=False, missed=missed)})
    assert tracker.state(name) == "suspect"     # vetoed, not dead
    assert tracker.cordoned(name)
    monkeypatch.setattr(pkg.mod("master.nodehealth"), "READY_VETO_S", 0.0)
    tracker.ingest({name: _feed(fresh=False, missed=9)})
    assert tracker.state(name) == "dead"


def test_termination_taint_cordons_and_triggers_proactive_drain(pkg):
    kube = pkg.mod("k8s.client").FakeKubeClient()
    name = "nh-taint-node"
    kube.put_node(_node(pkg, name, spec={"taints": [
        {"key": pkg.consts.TERMINATION_TAINT_KEYS[0],
         "effect": "NoSchedule"}]}))
    drained = []
    tracker = _tracker(pkg, kube=kube, on_drain=drained.append,
                       node_poll_interval_s=0.0)
    tracker.ingest({name: _feed(fresh=True)})
    tracker.ingest({name: _feed(fresh=True)})
    assert tracker.state(name) == "suspect"
    assert tracker.cordoned(name)
    assert drained == [name]       # migration starts BEFORE death


def test_unschedulable_node_cordons(pkg):
    kube = pkg.mod("k8s.client").FakeKubeClient()
    name = "nh-cordon-node"
    kube.put_node(_node(pkg, name, spec={"unschedulable": True}))
    tracker = _tracker(pkg, kube=kube, node_poll_interval_s=0.0)
    tracker.ingest({name: _feed(fresh=True)})
    assert tracker.state(name) == "suspect"
    assert tracker.snapshot()["nodes"][name]["k8s"] == "unschedulable"


def test_snapshot_and_enabled_knob(pkg):
    tracker = _tracker(pkg)
    tracker.ingest({"nh-snap-node": _feed(fresh=True)})
    snap = tracker.snapshot()
    assert snap["enabled"] is True
    assert snap["nodes"]["nh-snap-node"]["state"] == "healthy"
    nodehealth = pkg.mod("master.nodehealth")
    assert nodehealth.enabled({}) is True
    assert nodehealth.enabled({"TPU_NODE_HEALTH": "0"}) is False


def test_constants_match_the_control_plane():
    jax, torch = (p.consts for p in BOTH)
    for name in ("ENV_NODE_HEALTH", "ENV_NODE_SUSPECT_TICKS",
                 "ENV_NODE_DEAD_TICKS", "DEFAULT_NODE_SUSPECT_TICKS",
                 "DEFAULT_NODE_DEAD_TICKS", "DEFAULT_NODE_RECOVER_TICKS",
                 "DEFAULT_NODE_POLL_INTERVAL_S", "TERMINATION_TAINT_KEYS",
                 "REAP_FENCE_AFTER", "SLICE_SPARE_LABEL_KEY",
                 "SLICE_SPARE_LABEL_VALUE", "DEFAULT_SLICE_REPAIR_BUDGET"):
        assert getattr(jax, name) == getattr(torch, name), name
    mods = [p.mod("master.nodehealth") for p in BOTH]
    for name in ("STATES", "FORGET_AFTER_TICKS", "READY_VETO_S"):
        assert getattr(mods[0], name) == getattr(mods[1], name), name
    assert BOTH[0].mod("master.slicetxn").REPAIR_BUDGET_WINDOW_S == \
        BOTH[1].mod("master.slicetxn").REPAIR_BUDGET_WINDOW_S


# Each step: (fresh, missed, healthz) per node, then the k8s Node changes
# applied before the step (None = leave the node as it is).
SEQUENCE = [
    ({"a": (True, 0, "ok"), "b": (True, 0, "ok"), "c": (False, 1, "")},
     None),
    ({"a": (False, 1, ""), "b": (True, 0, "draining"), "c": (False, 2, "")},
     None),
    ({"a": (False, 2, ""), "b": (True, 0, "draining"), "c": (False, 3, "")},
     None),
    ({"a": (False, 3, ""), "b": (True, 0, "ok"), "c": (False, 4, "")},
     {"a": "False"}),
    ({"a": (False, 4, ""), "b": (True, 0, "ok"), "c": (False, 5, "")},
     None),
    ({"a": (True, 0, "ok"), "b": (False, 1, ""), "c": (False, 6, "")},
     {"a": "True"}),
    ({"a": (True, 0, "ok"), "b": (True, 0, "ok"), "c": (False, 7, "")},
     None),
    ({"a": (True, 0, "ok"), "b": (True, 0, "ok"), "c": (True, 0, "ok")},
     None),
]


def _replay(pkg):
    """Feed SEQUENCE to a fresh tracker of ``pkg``; the per-step states,
    the callbacks, the lifecycle events and the gauge at the end."""
    kube = pkg.mod("k8s.client").FakeKubeClient()
    tag = f"nh-seq-{pkg.name}-"
    calls = []
    tracker = _tracker(pkg, kube=kube, node_poll_interval_s=0.0,
                       on_dead=lambda n: calls.append(("dead", n[-1])),
                       on_drain=lambda n: calls.append(("drain", n[-1])))
    for node in "abc":
        kube.put_node(_node(pkg, tag + node))
    events = pkg.mod("utils.events").EVENTS
    seq0 = events.tail(1)[-1]["seq"] if events.tail(1) else 0
    states = []
    for step, ready in SEQUENCE:
        for node, status in (ready or {}).items():
            kube.put_node(_node(pkg, tag + node, status={"conditions": [
                {"type": "Ready", "status": status}]}))
        tracker.ingest({tag + n: _feed(*v) for n, v in step.items()})
        states.append({n: tracker.state(tag + n) for n in "abc"})
    emitted = [(e["kind"], e["node"][-1], e["attrs"]["prior"],
                e["attrs"]["reason"], e["attrs"]["missed_ticks"])
               for e in events.tail(500)
               if e["seq"] > seq0 and e.get("node", "").startswith(tag)]
    gauge = {n: pkg.registry.node_health_state.value(node=tag + n)
             for n in "abc"}
    snap = {n: {k: v for k, v in rec.items() if k != "since_unix"}
            for n, rec in ((k[-1], v) for k, v in
                           tracker.snapshot()["nodes"].items())}
    return states, calls, emitted, gauge, snap


def test_one_scrape_sequence_gives_the_same_states_in_both_packages():
    jax, torch = (_replay(p) for p in BOTH)
    assert jax == torch
    states, calls, emitted, gauge, _ = torch
    assert [s["a"] for s in states] == ["healthy", "healthy", "suspect",
                                        "dead", "dead", "dead", "healthy",
                                        "healthy"]
    # two clean scrapes end b's drain; one miss below the suspect
    # threshold then leaves it healthy
    assert [s["b"] for s in states] == ["healthy", "draining", "draining",
                                        "draining", "healthy", "healthy",
                                        "healthy", "healthy"]
    assert all(s["c"] == "healthy" for s in states)  # never seen alive
    assert calls == [("drain", "b"), ("dead", "a")]
    assert emitted == [
        ("node_draining", "b", "healthy", "healthz", 0),
        ("node_suspect", "a", "healthy", "scrape-silence", 2),
        ("node_dead", "a", "suspect", "notready+scrape-silence", 3),
        ("node_healthy", "b", "draining", "", 0),
        ("node_healthy", "a", "dead", "", 0)]
    assert gauge == {"a": 0.0, "b": 0.0, "c": 0.0}


def test_broker_tick_renotifies_dead_nodes_with_leases(pkg):
    admission = pkg.mod("master.admission")
    broker = admission.AttachBroker(pkg.mod("k8s.client").FakeKubeClient(),
                                    admission.BrokerConfig())
    broker.bind_node_health(lambda node: "dead"
                            if node == "nh-rnf-node" else "healthy")
    broker.leases.record("d", "p-rnf", "t", "normal", ["0"],
                         node="nh-rnf-node")
    broker.tick()
    deadline = time.monotonic() + 10
    while broker.leases.get("d", "p-rnf") is not None:
        assert time.monotonic() < deadline, "never fenced"
        time.sleep(0.01)
    assert broker.fenced()[-1]["pod"] == "p-rnf"


# -- broker fencing seam -------------------------------------------------------

def _slave(pkg, owner, owner_ns, name, pool, chips=2):
    consts = pkg.consts
    return {
        "metadata": {"name": name, "namespace": pool, "labels": {
            consts.SLAVE_POD_LABEL_KEY: consts.SLAVE_POD_LABEL_VALUE,
            consts.OWNER_POD_LABEL_KEY: owner,
            consts.OWNER_NAMESPACE_LABEL_KEY: owner_ns,
        }},
        "spec": {"containers": [{"name": "p", "resources": {
            "limits": {pkg.resource: str(chips)}}}]},
        "status": {"phase": "Running"},
    }


def test_fence_lease_drops_lease_deletes_slaves_frees_quota(pkg):
    admission = pkg.mod("master.admission")
    pool = pkg.consts.DEFAULT_POOL_NAMESPACE
    kube = pkg.mod("k8s.client").FakeKubeClient()
    kube.put_pod(_slave(pkg, "fence-pod", "fence-ns",
                        "fence-pod-slave-pod-1", pool))
    broker = admission.AttachBroker(kube, admission.BrokerConfig(
        quotas={"fence-tenant": 2}, pool_namespace=pool))
    lease = broker.leases.record("fence-ns", "fence-pod", "fence-tenant",
                                 "normal", ["0", "1"], node="nh-f-node")
    registry = pkg.registry
    before = registry.lease_fences.value(reason="node-dead")
    assert broker.fence_lease(lease, reason="node-dead") is True
    assert broker.leases.get("fence-ns", "fence-pod") is None
    assert broker.leases.tenant_usage("fence-tenant") == 0
    assert kube.list_pods(pool) == []     # cluster truth cleaned
    assert registry.lease_fences.value(reason="node-dead") == before + 1
    fences = [e for e in pkg.mod("utils.events").EVENTS.tail(100)
              if e["kind"] == "lease_fenced"
              and e.get("pod") == "fence-pod"]
    assert fences and fences[-1]["attrs"]["reason"] == "node-dead"
    assert broker.fenced()[-1]["pod"] == "fence-pod"
    assert broker.snapshot()["fenced"][-1]["reason"] == "node-dead"
    # idempotence: the lease is gone — a second fence is a no-op
    assert broker.fence_lease(lease, reason="node-dead") is False
    assert registry.lease_fences.value(reason="node-dead") == before + 1


def test_fence_is_compare_and_pop_against_a_regrant(pkg):
    """A lease re-granted while the fence's cleanup ran is a live
    attachment: the stale fence must not evict it."""
    admission = pkg.mod("master.admission")
    broker = admission.AttachBroker(pkg.mod("k8s.client").FakeKubeClient(),
                                    admission.BrokerConfig())
    old = broker.leases.record("d", "p-cas", "t", "normal", ["0"],
                               node="nh-cas-node")

    def regrant(namespace, pod):
        broker.leases.drop(namespace, pod)
        broker.leases.record(namespace, pod, "t", "normal", ["1"],
                             node="nh-cas-node")
    broker.fence_cleanup = regrant
    assert broker.fence_lease(old, reason="node-dead") is False
    assert sorted(broker.leases.get("d", "p-cas").uuids) == ["1"]


def test_handle_node_down_fences_singles_dead_only(pkg):
    admission = pkg.mod("master.admission")
    broker = admission.AttachBroker(pkg.mod("k8s.client").FakeKubeClient(),
                                    admission.BrokerConfig())
    broker.leases.record("d", "p-dead", "t", "normal", ["0"],
                         node="nh-hd-node")
    broker.leases.record("d", "p-other", "t", "normal", ["1"],
                         node="nh-hd-other")
    broker.handle_node_down("nh-hd-node", dead=False)    # draining
    assert broker.leases.get("d", "p-dead") is not None  # untouched
    broker.handle_node_down("nh-hd-node", dead=True)
    assert broker.leases.get("d", "p-dead") is None
    assert broker.leases.get("d", "p-other") is not None


def test_reaper_fences_expired_lease_on_dead_node_after_n_failures(pkg):
    admission = pkg.mod("master.admission")
    consts = pkg.consts
    calls = []
    broker = admission.AttachBroker(pkg.mod("k8s.client").FakeKubeClient(),
                                    admission.BrokerConfig(lease_ttl_s=0.001))
    broker.bind(lambda lease, cause, force: calls.append(cause) or "ERROR")
    broker.bind_node_health(lambda node: "dead"
                            if node == "nh-reap-node" else "healthy")
    broker.leases.record("d", "p-reap", "t", "normal", ["0"],
                         node="nh-reap-node", ttl_s=0.001)
    time.sleep(0.01)
    before = pkg.registry.lease_fences.value(reason="reap-unreachable")
    for _ in range(consts.REAP_FENCE_AFTER):
        lease = broker.leases.get("d", "p-reap")
        assert lease is not None
        lease.expires_at = time.monotonic() - 1.0
        broker._reap(lease)
    assert broker.leases.get("d", "p-reap") is None
    assert len(calls) == consts.REAP_FENCE_AFTER
    assert pkg.registry.lease_fences.value(reason="reap-unreachable") \
        == before + 1


def test_reaper_keeps_backing_off_on_live_nodes(pkg):
    admission = pkg.mod("master.admission")
    broker = admission.AttachBroker(pkg.mod("k8s.client").FakeKubeClient(),
                                    admission.BrokerConfig(lease_ttl_s=0.001))
    broker.bind(lambda lease, cause, force: "ERROR")
    broker.bind_node_health(lambda node: "healthy")
    broker.leases.record("d", "p-live", "t", "normal", ["0"],
                         node="nh-live-node", ttl_s=0.001)
    time.sleep(0.01)
    for _ in range(pkg.consts.REAP_FENCE_AFTER + 2):
        lease = broker.leases.get("d", "p-live")
        assert lease is not None, \
            "lease on a LIVE node must never be fenced by the reaper"
        lease.expires_at = time.monotonic() - 1.0
        broker.tick()
    assert broker.leases.get("d", "p-live") is not None


# -- worker-directory negative cache -------------------------------------------

def _directory(pkg, node):
    kube = pkg.mod("k8s.client").FakeKubeClient()
    kube.put_pod(pkg.mod("testing.sim").worker_pod(node, "10.0.0.5"))
    return kube, pkg.mod("master.discovery").WorkerDirectory(kube,
                                                             ttl_s=3600)


def test_directory_negative_cache_fast_fails_after_failures(pkg):
    discovery = pkg.mod("master.discovery")
    _, directory = _directory(pkg, "nh-neg-node")
    assert directory.worker_target("nh-neg-node") == "10.0.0.5:1200"
    for _ in range(discovery.WorkerDirectory.NEGATIVE_AFTER_FAILURES - 1):
        directory.invalidate("nh-neg-node")
        assert directory.worker_target("nh-neg-node") == "10.0.0.5:1200"
    directory.invalidate("nh-neg-node")
    with pytest.raises(discovery.WorkerNotFoundError):
        directory.worker_target("nh-neg-node")


def test_directory_negative_cache_clears_on_replaced_worker(pkg):
    discovery = pkg.mod("master.discovery")
    kube, directory = _directory(pkg, "nh-neg2-node")
    directory.MISS_REFRESH_INTERVAL_S = 0.0
    directory.worker_target("nh-neg2-node")
    for _ in range(discovery.WorkerDirectory.NEGATIVE_AFTER_FAILURES):
        directory.invalidate("nh-neg2-node")
    with pytest.raises(discovery.WorkerNotFoundError):
        directory.worker_target("nh-neg2-node")
    kube.delete_pod(pkg.consts.WORKER_NAMESPACE, "w1")
    kube.put_pod(pkg.mod("testing.sim").worker_pod("nh-neg2-node",
                                                   "10.0.0.9"))
    assert directory.worker_target("nh-neg2-node") == "10.0.0.9:1200"


def test_directory_negative_window_expires_to_half_open(pkg):
    discovery = pkg.mod("master.discovery")
    _, directory = _directory(pkg, "nh-neg3-node")
    directory.NEGATIVE_TTL_BASE_S = 0.02
    directory.worker_target("nh-neg3-node")
    for _ in range(discovery.WorkerDirectory.NEGATIVE_AFTER_FAILURES):
        directory.invalidate("nh-neg3-node")
    with pytest.raises(discovery.WorkerNotFoundError):
        directory.worker_target("nh-neg3-node")
    time.sleep(0.03)
    assert directory.worker_target("nh-neg3-node") == "10.0.0.5:1200"


# -- the subsystem off / idle --------------------------------------------------

def _gateway(pkg):
    kube = pkg.mod("k8s.client").FakeKubeClient()
    return pkg.mod("master.gateway").MasterGateway(
        kube, pkg.mod("master.discovery").WorkerDirectory(kube))


def test_node_health_off_removes_tracker_and_fleetz_section(pkg,
                                                            monkeypatch):
    monkeypatch.setenv("TPU_NODE_HEALTH", "0")
    gateway = _gateway(pkg)
    assert gateway.nodehealth is None
    assert gateway.fleet.node_health is None
    assert "node_health" not in gateway.fleet.snapshot()
    assert gateway.broker._node_health_fn is None
    assert gateway.slices._candidates_fn is None
    assert "fenced" not in gateway.broker.snapshot()


def test_node_health_on_but_idle_keeps_payloads_byte_for_byte(pkg,
                                                              monkeypatch):
    """Default-on with nothing unhealthy: /fleetz gains its (empty)
    node_health section, /brokerz no key."""
    monkeypatch.delenv("TPU_NODE_HEALTH", raising=False)
    gateway = _gateway(pkg)
    assert gateway.nodehealth is not None
    assert gateway.fleet.snapshot()["node_health"] == {
        "enabled": True, "suspect_after_ticks": 2, "dead_after_ticks": 5,
        "recover_ticks": 2, "nodes": {}}
    monkeypatch.setenv("TPU_NODE_HEALTH", "0")
    gateway_off = _gateway(pkg)
    assert gateway.broker.snapshot() == gateway_off.broker.snapshot()


def test_idle_payloads_agree_across_the_packages(monkeypatch):
    """The port's idle /brokerz and /fleetz node_health section are the
    control plane's (brokerz' counters and config compare as they are:
    nothing ran)."""
    monkeypatch.delenv("TPU_NODE_HEALTH", raising=False)
    gateways = [_gateway(p) for p in BOTH]
    sections = [g.fleet.snapshot()["node_health"] for g in gateways]
    assert sections[0] == sections[1]
    keys = [sorted(g.broker.snapshot()) for g in gateways]
    assert keys[0] == keys[1] and "fenced" not in keys[1]
