"""The port's attach broker (master/admission.py, lease.py,
waiterindex.py) against the control plane's: the scenarios of
tests/test_broker.py, tests/test_waiter_index.py and the HTTP half of
tests/test_idempotency.py, each run through both packages (a WorkerRig, a
live gRPC worker and a MasterGateway over the rig's own fake cluster) with
the same requests and the same expected answers; result names by role
(``INSUFFICIENT_TPU``/``INSUFFICIENT_GPU``), audit reasons by device
(``TPUDetached``/``GPUDetached``), counters as deltas of each package's
own registry. Both gateways serve the reference's ``/addgpu`` and
``/removegpu`` routes. The slice route and its admission wait for the
slice subsystem (ROADMAP Queue 1 item 12a): the port answers 501."""

import json
import random
import threading
import time
import urllib.error
import urllib.request

import pytest

from tests.torch_control_plane import BOTH, IDS, JAX, TORCH, norm_result


@pytest.fixture(params=BOTH, ids=IDS)
def pkg(request):
    return request.param


class BrokerStack:
    """WorkerRig + live gRPC worker + gateway over the rig's OWN fake
    cluster (the broker's re-derivation and the preemption victim scan
    see the worker's slave pods)."""

    def __init__(self, pkg, root, config=None, n_chips=4, extra_pods=(),
                 **rig_kwargs):
        self.pkg = pkg
        self.rig = pkg.rig(root, n_chips=n_chips, **rig_kwargs)
        self.server, self.port = pkg.mod("worker.grpc_server").build_server(
            self.rig.service, port=0, address="127.0.0.1")
        self.server.start()
        self.kube = self.rig.sim.kube
        self.kube.put_pod(pkg.mod("testing.sim").worker_pod("node-a",
                                                            "127.0.0.1"))
        for name in extra_pods:
            pod = self.rig.sim.add_target_pod(name=name)
            self.rig.provision_container(pod)
        self.gateway = self.new_gateway(config)

    def config(self, **kwargs):
        return self.pkg.mod("master.admission").BrokerConfig(**kwargs)

    def new_gateway(self, config=None):
        """A fresh master over the same cluster — the "restart"."""
        admission = self.pkg.mod("master.admission")
        broker = admission.AttachBroker(self.kube,
                                        config or admission.BrokerConfig())
        return self.pkg.mod("master.gateway").MasterGateway(
            self.kube, self.pkg.mod("master.discovery").WorkerDirectory(
                self.kube, grpc_port=self.port), broker=broker)

    def close(self):
        self.server.stop(grace=0)
        self.rig.close()


@pytest.fixture
def stack_factory(pkg, tmp_path):
    stacks = []

    def make(config=None, **kwargs) -> BrokerStack:
        cfg = (pkg.mod("master.admission").BrokerConfig(**config)
               if config is not None else None)
        stack = BrokerStack(pkg, tmp_path / f"s{len(stacks)}", cfg, **kwargs)
        stacks.append(stack)
        return stack

    yield make
    for stack in stacks:
        stack.close()


def add(gw, pod, n=2, entire=False, tenant=None, priority=None, rid=None,
        ns="default"):
    params = []
    if tenant:
        params.append(f"tenant={tenant}")
    if priority:
        params.append(f"priority={priority}")
    path = (f"/addgpu/namespace/{ns}/pod/{pod}/gpu/{n}"
            f"/isEntireMount/{'true' if entire else 'false'}")
    if params:
        path += "?" + "&".join(params)
    headers = {"X-Request-Id": rid} if rid else None
    return gw.handle("GET", path, headers=headers)


def remove(gw, pod, uuids=None, force=False, ns="default"):
    body = json.dumps({"uuids": uuids or []}).encode()
    return gw.handle(
        "POST", f"/removegpu/namespace/{ns}/pod/{pod}"
                f"/force/{'true' if force else 'false'}", body)


def insufficient(pkg) -> str:
    return pkg.consts.AddResult(1).name


def events_drained(service, timeout_s: float = 5.0) -> None:
    """Block until the service's audit-event queue has flushed."""
    deadline = time.monotonic() + timeout_s
    stable = 0
    while time.monotonic() < deadline and stable < 2:
        stable = stable + 1 if not service._event_queue else 0
        time.sleep(0.03)


def detach_messages(pkg, stack) -> list[str]:
    events_drained(stack.rig.service)
    reason = f"{pkg.dev.upper()}Detached"
    return [e["message"] for e in stack.kube.events
            if e.get("reason") == reason]


def broker_invariants(pkg, broker, sim) -> None:
    """The lease table mirrors cluster ground truth (the chips each owner's
    non-warm slave pods hold in the kubelet's table) and no waiter is
    left parked (the control plane's ``assert_broker_invariants``)."""
    objects, c = pkg.mod("k8s.objects"), pkg.consts
    held: dict[tuple[str, str], int] = {}
    for pod in sim.slave_pods():
        labels = objects.labels(pod)
        if labels.get(c.WARM_POD_LABEL_KEY) == c.WARM_POD_LABEL_VALUE:
            continue
        owner = (labels.get(c.OWNER_NAMESPACE_LABEL_KEY),
                 labels.get(c.OWNER_POD_LABEL_KEY))
        chips = sum(len(ids) for containers in (
            sim.podresources.assignments.get(
                (objects.namespace(pod), objects.name(pod))) or {}).values()
            for ids in containers.values())
        if chips and all(owner):
            held[owner] = held.get(owner, 0) + chips
    assert {le.key: le.chips for le in broker.leases.leases()} == held
    with broker._lock:
        assert not list(broker._waiters)


def _wait_until(predicate, timeout_s=10.0, what="condition"):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(0.01)
    raise AssertionError(f"timed out waiting for {what}")


# -- admission: quotas ---------------------------------------------------------

def test_over_quota_attach_429_with_retry_hint(pkg, stack_factory):
    stack = stack_factory(config={"quotas": {"*": 2}}, extra_pods=("w2",))
    gw = stack.gateway
    status, body = add(gw, "workload", 2)
    assert status == 200 and body["result"] == "SUCCESS"
    assert body["tenant"] == "default"
    status, body = add(gw, "w2", 1)
    assert status == 429 and body["result"] == "QuotaExceeded"
    assert body["tenant"] == "default" and body["retry_after_s"] >= 0.1
    assert pkg.registry.admission_decisions.value(
        tenant="default", outcome="over_quota") >= 1
    status, body = add(gw, "w2", 1, tenant="teamB")
    assert status == 200 and body["tenant"] == "teamB"


def test_concurrent_same_tenant_attaches_cannot_stampede_quota(pkg):
    admission = pkg.mod("master.admission")
    broker = admission.AttachBroker(
        pkg.mod("k8s.client").FakeKubeClient(),
        admission.BrokerConfig(quotas={"T": 2}))
    broker.ensure_rederived()
    results = []
    guard = threading.Lock()

    def slow_attempt():
        time.sleep(0.2)
        return 200, {"result": "SUCCESS", "device_ids": ["a", "b"]}

    def run(pod):
        try:
            status, _ = broker.attach(
                tenant="T", priority="normal", namespace="d", pod=pod,
                chips=2, node="n", rid=pod, attempt_fn=slow_attempt)
        except pkg.errors.QuotaExceededError:
            status = 429
        with guard:
            results.append(status)

    threads = [threading.Thread(target=run, args=(f"p{i}",))
               for i in range(2)]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join(timeout=10)
    assert sorted(results) == [200, 429], results


def test_detach_refunds_the_tenant(stack_factory):
    gw = stack_factory(config={"quotas": {"*": 2}}).gateway
    assert add(gw, "workload", 2)[0] == 200
    assert add(gw, "workload", 1)[0] == 429
    assert remove(gw, "workload")[0] == 200
    assert gw.broker.leases.tenant_usage("default") == 0
    assert add(gw, "workload", 2)[0] == 200


def test_quota_burst_allows_borrowing_up_to_cap(stack_factory):
    gw = stack_factory(config={"quotas": {"hog": 2},
                               "quota_burst": 2.0}).gateway
    status, body = add(gw, "workload", 4, entire=True, tenant="hog")
    assert status == 200, body
    assert add(gw, "workload", 1, tenant="hog")[0] == 429


def test_http_surface_retry_after_header_and_allow(stack_factory):
    stack = stack_factory(config={"quotas": {"*": 0}})
    server = stack.gateway.serve(port=0, address="127.0.0.1")
    base = f"http://127.0.0.1:{server.server_port}"
    url = f"{base}/addgpu/namespace/default/pod/workload/gpu/1" \
          "/isEntireMount/false"
    try:
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(url)
        assert err.value.code == 429
        assert int(err.value.headers["Retry-After"]) >= 1
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(urllib.request.Request(
                url, data=b"", method="POST"))
        assert err.value.code == 405
        assert err.value.headers["Allow"] == "GET"
    finally:
        server.shutdown()


def test_tenant_resolution_precedence_and_validation(stack_factory):
    gw = stack_factory(config={"quotas": {"teamQ": 0}}).gateway
    path = "/addgpu/namespace/default/pod/workload/gpu/1/isEntireMount/false"
    status, body = gw.handle("GET", path, headers={"X-Tpu-Tenant": "teamQ"})
    assert status == 429 and body["tenant"] == "teamQ"
    status, body = gw.handle("GET", path + "?tenant=teamFree",
                             headers={"X-Tpu-Tenant": "teamQ"})
    assert status == 200 and body["tenant"] == "teamFree"
    remove(gw, "workload")
    status, body = add(gw, "workload", 1, tenant="bad/slash")
    assert status == 400 and body["result"] == "BadRequest"
    status, body = add(gw, "workload", 1, priority="urgent")
    assert status == 400 and body["result"] == "BadRequest"


# -- scheduling: queue + fairness + preemption ---------------------------------

def test_contended_attach_queues_then_completes(pkg, stack_factory):
    stack = stack_factory(config={"queue_timeout_s": 20.0},
                          extra_pods=("w2",))
    gw = stack.gateway
    reg = pkg.registry
    waits0 = reg.queue_wait.count(tenant="default")
    assert add(gw, "workload", 4, entire=True)[0] == 200
    done = {}
    thread = threading.Thread(target=lambda: done.update(
        res=add(gw, "w2", 2)))
    thread.start()
    _wait_until(lambda: len(gw.broker._waiters) == 1, what="enqueue")
    assert reg.queue_depth.value(priority="normal") == 1
    assert remove(gw, "workload")[0] == 200
    thread.join(timeout=20)
    assert not thread.is_alive()
    status, body = done["res"]
    assert status == 200 and body["result"] == "SUCCESS"
    assert body["queued_s"] >= 0.0
    assert reg.queue_wait.count(tenant="default") == waits0 + 1
    assert reg.admission_decisions.value(
        tenant="default", outcome="granted_queued") >= 1
    broker_invariants(pkg, gw.broker, stack.rig.sim)


def test_queue_timeout_returns_insufficient_with_wait(pkg, stack_factory):
    gw = stack_factory(config={"queue_timeout_s": 0.2},
                       extra_pods=("w2",)).gateway
    assert add(gw, "workload", 4, entire=True)[0] == 200
    t0 = time.monotonic()
    status, body = add(gw, "w2", 2)
    assert time.monotonic() - t0 >= 0.2
    assert status == 503 and body["result"] == insufficient(pkg)
    assert body["queue_timeout"] is True and body["queued_s"] >= 0.19
    assert pkg.registry.admission_decisions.value(
        tenant="default", outcome="queue_timeout") >= 1
    assert gw.broker._waiters == []


def test_queue_full_sheds_with_429(stack_factory):
    gw = stack_factory(config={"queue_timeout_s": 20.0, "queue_depth": 1},
                       extra_pods=("w2", "w3")).gateway
    assert add(gw, "workload", 4, entire=True)[0] == 200
    done = {}
    thread = threading.Thread(
        target=lambda: done.update(res=add(gw, "w2", 2)))
    thread.start()
    _wait_until(lambda: len(gw.broker._waiters) == 1, what="enqueue")
    status, body = add(gw, "w3", 2)
    assert status == 429 and body["result"] == "QueueFull"
    assert body["retry_after_s"] > 0
    assert remove(gw, "workload")[0] == 200
    thread.join(timeout=20)
    assert done["res"][0] == 200


def _dequeue_order(pkg) -> list[str]:
    admission = pkg.mod("master.admission")
    broker = admission.AttachBroker(
        pkg.mod("k8s.client").FakeKubeClient(),
        admission.BrokerConfig(quotas={"A": 4, "B": 4},
                               queue_timeout_s=30.0))
    broker.ensure_rederived()
    broker.leases.record("default", "pre", "A", "normal", ["p0", "p1"])
    capacity = {"free": 0}
    guard = threading.Lock()
    order: list[str] = []

    def make_attempt(name):
        def attempt():
            with guard:
                if capacity["free"] >= 1:
                    capacity["free"] -= 1
                    order.append(name)
                    return 200, {"result": "SUCCESS",
                                 "device_ids": [f"{name}-0"]}
            return 503, {"result": insufficient(pkg)}
        return attempt

    threads = [threading.Thread(
        target=lambda n=name, t=tenant, p=priority: broker.attach(
            tenant=t, priority=p, namespace="default", pod=n, chips=1,
            node="node-a", rid=n, attempt_fn=make_attempt(n)))
        for name, tenant, priority in (
            ("low-a", "A", "low"), ("norm-a", "A", "normal"),
            ("norm-b", "B", "normal"), ("high-b", "B", "high"))]
    for thread in threads:
        thread.start()
    _wait_until(lambda: len(broker._waiters) == 4, what="4 waiters parked")

    def settled():
        with broker._lock:
            return all(w.tried_gen >= broker._gen and not w.event.is_set()
                       for w in broker._waiters)

    for expected_len in range(1, 5):
        _wait_until(settled, what="baton chain settled")
        with guard:
            capacity["free"] += 1
        broker.signal_capacity()
        _wait_until(lambda: len(order) >= expected_len,
                    what=f"grant #{expected_len}")
    for thread in threads:
        thread.join(timeout=10)
    return order


def test_dequeue_order_priority_then_weighted_fair():
    orders = [_dequeue_order(p) for p in BOTH]
    assert orders[0] == orders[1] == ["high-b", "norm-b", "norm-a", "low-a"]


def test_high_priority_preempts_over_quota_victim(pkg, stack_factory):
    stack = stack_factory(
        config={"quotas": {"hog": 2, "*": 4}, "quota_burst": 2.0,
                "queue_timeout_s": 20.0},
        extra_pods=("hog-pod", "vip-pod"))
    gw = stack.gateway
    preempts0 = pkg.registry.preemptions.value()
    status, body = add(gw, "hog-pod", 4, entire=True, tenant="hog")
    assert status == 200, body
    status, body = add(gw, "vip-pod", 4, entire=True, tenant="vip",
                       priority="high", rid="vip-rid")
    assert status == 200 and body["result"] == "SUCCESS"
    assert len(body["device_ids"]) == 4
    assert pkg.registry.preemptions.value() - preempts0 == 1
    assert gw.broker.leases.get("default", "hog-pod") is None
    assert gw.broker.leases.get("default", "vip-pod").chips == 4
    assert any("cause=preempted:vip:vip-rid" in m
               for m in detach_messages(pkg, stack))
    detached = [r for r in stack.rig.journal.snapshot()["records"]
                if r["state"] == "detached"]
    assert any(r.get("cause", "").startswith("preempted:vip")
               for r in detached), detached
    broker_invariants(pkg, gw.broker, stack.rig.sim)


def test_no_preemption_without_over_quota_victims(pkg, stack_factory):
    gw = stack_factory(config={"quotas": {"*": 4}, "queue_timeout_s": 0.2},
                       extra_pods=("w2",)).gateway
    assert add(gw, "workload", 4, entire=True)[0] == 200
    preempts0 = pkg.registry.preemptions.value()
    status, body = add(gw, "w2", 2, tenant="other", priority="high")
    assert status == 503 and body.get("queue_timeout")
    assert pkg.registry.preemptions.value() == preempts0
    assert gw.broker.leases.get("default", "workload").chips == 4


# -- leases: expiry, renewal ---------------------------------------------------

def test_expired_lease_auto_detaches_and_frees_chips(pkg, stack_factory):
    stack = stack_factory(config={"lease_ttl_s": 0.3})
    gw = stack.gateway
    expirations0 = pkg.registry.lease_expirations.value()
    status, body = add(gw, "workload", 4, entire=True, rid="short-lease")
    assert status == 200 and 0 < body["lease_expires_in_s"] <= 0.4
    assert gw.broker.tick() == 0
    time.sleep(0.35)
    assert gw.broker.tick() == 1
    assert gw.broker.leases.leases() == []
    assert stack.rig.sim.slave_pods() == []
    assert pkg.registry.lease_expirations.value() - expirations0 == 1
    assert any("cause=lease-expired:short-lease" in m
               for m in detach_messages(pkg, stack))
    assert add(gw, "workload", 4, entire=True)[0] == 200
    broker_invariants(pkg, gw.broker, stack.rig.sim)


def test_renew_extends_the_lease(stack_factory):
    stack = stack_factory(config={"lease_ttl_s": 0.3})
    gw = stack.gateway
    assert add(gw, "workload", 2)[0] == 200
    status, body = gw.handle(
        "POST", "/renew/namespace/default/pod/workload?ttl=60")
    assert status == 200 and body["result"] == "SUCCESS"
    assert body["lease"]["expires_in_s"] > 50
    assert body["lease"]["renewals"] == 1
    time.sleep(0.35)
    assert gw.broker.tick() == 0
    assert len(stack.rig.sim.slave_pods()) == 2
    status, body = gw.handle("POST", "/renew/namespace/default/pod/ghost")
    assert status == 404 and body["result"] == "LeaseNotFound"
    status, body = gw.handle("GET", "/renew/namespace/default/pod/workload")
    assert status == 405 and body["allow"] == "POST"
    status, body = gw.handle(
        "POST", "/renew/namespace/default/pod/workload?ttl=-1")
    assert status == 400 and body["result"] == "BadRequest"


def test_expiry_reap_defers_on_busy_devices(stack_factory):
    stack = stack_factory(config={"lease_ttl_s": 0.3})
    gw = stack.gateway
    status, body = add(gw, "workload", 1)
    assert status == 200
    stack.rig.sim.enumerator.busy_pids = {body["device_paths"][0]:
                                          [stack.rig.pid]}
    time.sleep(0.35)
    assert gw.broker.tick() == 0
    lease = gw.broker.leases.get("default", "workload")
    assert lease is not None and lease.reap_failures == 1
    assert len(stack.rig.sim.slave_pods()) == 1
    stack.rig.sim.enumerator.busy_pids = {}
    time.sleep(2.1)
    assert gw.broker.tick() == 1
    assert stack.rig.sim.slave_pods() == []


# -- restart re-derivation -----------------------------------------------------

def test_master_restart_rederives_quotas_from_ground_truth(pkg,
                                                           stack_factory):
    stack = stack_factory(config={"quotas": {"*": 4}}, extra_pods=("w2",))
    assert add(stack.gateway, "workload", 4, entire=True,
               rid="original")[0] == 200
    gw2 = stack.new_gateway(stack.config(quotas={"*": 4}))
    status, body = gw2.handle("GET", "/brokerz")
    assert status == 200 and body["leases"]["count"] == 1
    (lease,) = body["leases"]["leases"]
    assert (lease["pod"], lease["chips"], lease["tenant"], lease["rid"]) == \
        ("workload", 4, "default", "original")
    assert lease["rederived"] is True
    status, body = add(gw2, "w2", 1)
    assert status == 429 and body["result"] == "QuotaExceeded"
    detaches0 = pkg.registry.detach_results.value(result="SUCCESS")
    assert gw2.broker.tick() == 0
    assert pkg.registry.detach_results.value(result="SUCCESS") == detaches0
    assert len(stack.rig.sim.slave_pods()) == 1
    assert remove(gw2, "workload")[0] == 200
    assert gw2.broker.leases.tenant_usage("default") == 0
    assert add(gw2, "w2", 1)[0] == 200
    broker_invariants(pkg, gw2.broker, stack.rig.sim)


def test_rederived_lease_gets_fresh_ttl_then_expires_once(pkg,
                                                          stack_factory):
    stack = stack_factory(config={"lease_ttl_s": 30.0})
    assert add(stack.gateway, "workload", 2)[0] == 200
    gw2 = stack.new_gateway(stack.config(lease_ttl_s=0.3))
    assert gw2.broker.tick() == 0
    assert len(stack.rig.sim.slave_pods()) == 2
    time.sleep(0.35)
    assert gw2.broker.tick() == 1
    assert stack.rig.sim.slave_pods() == []
    assert len(detach_messages(pkg, stack)) == 1


def test_queue_hints_derive_from_waiters_and_lease_horizon(pkg,
                                                           stack_factory):
    stack = stack_factory(config={"queue_timeout_s": 20.0, "queue_depth": 1,
                                  "lease_ttl_s": 45.0},
                          extra_pods=("w2", "w3"))
    gw = stack.gateway
    assert add(gw, "workload", 4, entire=True)[0] == 200
    done = {}
    thread = threading.Thread(
        target=lambda: done.update(res=add(gw, "w2", 2)))
    thread.start()
    _wait_until(lambda: len(gw.broker._waiters) == 1, what="enqueue")
    status, body = add(gw, "w3", 2)
    assert status == 429 and body["result"] == "QueueFull"
    assert 10.0 <= body["retry_after_s"] <= 20.0
    assert remove(gw, "workload")[0] == 200
    thread.join(timeout=30)
    assert done["res"][0] == 200
    assert remove(gw, "w2")[0] == 200
    assert add(gw, "workload", 4, entire=True)[0] == 200
    status, body = gw.broker.attach(
        tenant="default", priority="normal", namespace="default",
        pod="w3", chips=2, node="node-a", rid="hint-1",
        attempt_fn=lambda: (503, {"result": insufficient(pkg)}),
        timeout_s=0.2)
    assert status == 503 and body["queue_timeout"]
    assert 30.0 <= body["retry_after_s"] <= 45.0, body


def test_brokerz_transcripts_agree(tmp_path):
    """One admission sequence (grant, over-quota, queue timeout, renew,
    release) through both packages: the statuses, results and /brokerz
    views agree after the GPU mapping (times and request ids aside)."""
    out = []
    for p in BOTH:
        stack = BrokerStack(p, tmp_path / p.name, p.mod(
            "master.admission").BrokerConfig(
                quotas={"*": 4, "teamB": 1}, lease_ttl_s=60.0,
                queue_timeout_s=0.1), extra_pods=("w2",))
        try:
            gw = stack.gateway
            steps = []
            for call in (lambda: add(gw, "workload", 2, rid="r1"),
                         lambda: add(gw, "w2", 2, tenant="teamB"),
                         lambda: add(gw, "w2", 3),
                         lambda: gw.handle("POST", "/renew/namespace/"
                                           "default/pod/workload?ttl=30"),
                         lambda: gw.handle("GET", "/brokerz"),
                         lambda: remove(gw, "workload"),
                         lambda: gw.handle("GET", "/brokerz")):
                status, body = call()
                steps.append((status, _scrub(body)))
            out.append(steps)
        finally:
            stack.close()
    assert out[0] == out[1]


def _scrub(obj):
    """A payload with what differs by run (times, ids) and by device
    (result and uuid names) mapped away."""
    if isinstance(obj, dict):
        return {k: _scrub(v) for k, v in obj.items()
                if k not in ("request_id", "created_unix", "expires_in_s",
                             "lease_expires_in_s", "queued_s",
                             "retry_after_s", "device_ids", "device_paths",
                             "uuids", "rid", "message", "waiting_s",
                             "oldest_age_s")}
    if isinstance(obj, list):
        return [_scrub(v) for v in obj]
    if isinstance(obj, str):
        return norm_result(obj)
    return obj


# -- gateway method hygiene ----------------------------------------------------

@pytest.mark.parametrize("method,path,allow", [
    ("POST", "/healthz", "GET"), ("POST", "/version", "GET"),
    ("POST", "/addgpu/namespace/d/pod/p/gpu/1/isEntireMount/true", "GET"),
    ("GET", "/removegpu/namespace/d/pod/p/force/false", "POST"),
    ("POST", "/nodestatus/node/n", "GET"), ("POST", "/tracez", "GET"),
    ("POST", "/brokerz", "GET"), ("POST", "/eventz", "GET"),
    ("POST", "/fleetz", "GET")])
def test_known_routes_wrong_method_405_with_allow(stack_factory, method,
                                                  path, allow):
    status, body = stack_factory().gateway.handle(method, path)
    assert status == 405 and body["result"] == "MethodNotAllowed"
    assert body["allow"] == allow


def test_unknown_route_and_status_route_names(pkg, stack_factory):
    gw = stack_factory().gateway
    status, body = gw.handle("GET", "/nope")
    assert status == 404 and body["result"] == "NoSuchRoute"
    # the pod status route follows the device (/tpustatus, /gpustatus)
    path = f"/{pkg.dev}status/namespace/d/pod/p"
    status, body = gw.handle("POST", path)
    assert status == 405 and body["allow"] == "GET"


def test_version_route(pkg, stack_factory):
    import importlib
    status, body = stack_factory().gateway.handle("GET", "/version")
    assert status == 200
    assert body["version"] == importlib.import_module(pkg.root).__version__


def test_slice_attach_waits_for_the_slice_subsystem(tmp_path):
    """The control plane admits a slice through its quota gate; the port
    has no slice subsystem yet and answers 501 before any admission."""
    stack = BrokerStack(TORCH, tmp_path, TORCH.mod(
        "master.admission").BrokerConfig(quotas={"*": 2}))
    try:
        body = json.dumps({"pods": [{"namespace": "default",
                                     "pod": "workload"}],
                           "gpusPerHost": 4}).encode()
        status, payload = stack.gateway.handle("POST", "/addgpuslice", body)
        assert status == 501 and payload["result"] == "NotImplemented"
        assert "Queue 1 item 12a" in payload["message"]
        assert stack.gateway.broker.leases.leases() == []
    finally:
        stack.close()


# -- the waiter index ----------------------------------------------------------

class W:
    """The selection-relevant surface of admission._Waiter."""

    _counter = [0]

    def __init__(self, tenant="t0", priority="normal", chips=1,
                 node="node-a", gang=False):
        self.tenant, self.priority, self.chips = tenant, priority, chips
        self.node = "" if gang else node
        self.gang = gang
        W._counter[0] += 1
        self.enqueued_at = float(W._counter[0])
        self.tried_gen = 0
        self.event = threading.Event()


TENANTS = ("teamA", "teamB", "teamC", "hog")
NODES = ("node-a", "node-b", "node-c")


@pytest.mark.parametrize("indexed", [True, False])
def test_waiter_selection_equal_over_1k_interleavings(indexed):
    """The same randomized park / wake / timeout / usage / signal drive
    through both packages' queues (each waiter mirrored): every signal
    picks the same waiter."""
    rng = random.Random(0xA11CE)
    queues = [p.mod("master.waiterindex").WaiterQueue(indexed=indexed)
              for p in BOTH]
    ordered: list[tuple[W, W]] = []
    usage = {t: 0 for t in TENANTS}
    quotas = {"teamA": 8, "teamB": 4, "teamC": 2}
    gen = selects = 0
    for _ in range(1000):
        op = rng.random()
        if op < 0.45 or not ordered:
            kw = dict(tenant=rng.choice(TENANTS),
                      priority=rng.choice(JAX.consts.PRIORITIES),
                      chips=rng.randint(1, 8), node=rng.choice(NODES),
                      gang=rng.random() < 0.1)
            pair = (W(**kw), W(**kw))
            for w, q in zip(pair, queues):
                w.tried_gen = gen
                q.add(w)
            ordered.append(pair)
        elif op < 0.60:
            pair = ordered.pop(rng.randrange(len(ordered)))
            for w, q in zip(pair, queues):
                q.remove(w)
        elif op < 0.70:
            woken = [pair for pair in ordered if pair[0].event.is_set()]
            if woken:
                for w in rng.choice(woken):
                    w.event.clear()
        elif op < 0.80:
            usage[rng.choice(TENANTS)] = rng.randint(0, 10)
        else:
            gen += 1
            node = rng.choice((None,) + NODES) if indexed else None
            chips = rng.choice((0, 0, 1, 2, 4, 8)) if indexed else 0
            picks = [q.select(gen, node=node, chips=chips,
                              usage_fn=lambda: dict(usage),
                              quota_fn=quotas.get) for q in queues]
            index = [next((i for i, pair in enumerate(ordered)
                           if pair[k] is got), None)
                     for k, (got, _) in enumerate(picks)]
            assert index[0] == index[1]
            assert picks[0][1] == picks[1][1]      # waiters examined
            if index[0] is not None:
                for w in ordered[index[0]]:
                    w.tried_gen = gen
                    w.event.set()
            selects += 1
    assert selects > 100


def test_waiter_queue_surface_and_cost(pkg):
    queue = pkg.mod("master.waiterindex").WaiterQueue
    indexed, linear = queue(indexed=True), queue(indexed=False)
    for i in range(1000):
        w = W(tenant=TENANTS[i % 3], node="node-b", chips=1 + i % 4)
        indexed.add(w)
        linear.add(w)
    locals_ = [W(tenant=TENANTS[i % 2], node="node-a") for i in range(5)]
    gang = W(tenant="teamC", gang=True)
    for w in (*locals_, gang):
        indexed.add(w)
        linear.add(w)
    chosen, evaluated = indexed.select(1, node="node-a", chips=1)
    assert chosen in (*locals_, gang)
    assert evaluated <= 3 * len(TENANTS) * len(pkg.consts.PRIORITIES)
    assert linear.select(1)[1] == 1006
    q = queue()
    a, b = W(priority="high"), W(priority="low", gang=True)
    q.add(a)
    q.add(b)
    assert q == [a, b] and q.count("high") == 1
    q.remove(a)
    q.remove(a)
    assert q == [b] and q.count("high") == 0


def test_waiter_index_knob_plumbs_from_env(pkg):
    config = pkg.mod("utils.config")
    admission = pkg.mod("master.admission")
    off = admission.BrokerConfig.from_settings(
        config.Settings.from_env({"TPU_WAITER_INDEX": "0"}))
    assert off.waiter_index is False
    assert admission.BrokerConfig().waiter_index is True
    broker = admission.AttachBroker(pkg.mod("k8s.client").FakeKubeClient(),
                                    off)
    assert broker._waiters.indexed is False


def test_broker_config_from_settings_agree():
    env = {"TPU_QUOTAS": "teamA:16,*:4", "TPU_QUOTA_BURST": "1.5",
           "TPU_LEASE_TTL_S": "30", "TPU_QUEUE_TIMEOUT_S": "5",
           "TPU_QUEUE_DEPTH": "8", "TPU_IDLE_LEASE_S": "120"}
    configs = [p.mod("master.admission").BrokerConfig.from_settings(
        p.mod("utils.config").Settings.from_env(env)) for p in BOTH]
    keep = ("quotas", "quota_burst", "lease_ttl_s", "queue_timeout_s",
            "queue_depth", "idle_lease_s", "waiter_index",
            "tick_interval_s")
    assert [{k: getattr(c, k) for k in keep} for c in configs][0] == \
        {k: getattr(configs[1], k) for k in keep}
    assert configs[1].resource_name == "nvidia.com/gpu"
    assert configs[1].pool_namespace == "gpu-pool"


# -- client request ids over HTTP (tests/test_idempotency.py) ------------------

RID = "req-abc123"


@pytest.fixture
def live(pkg, tmp_path):
    rig = pkg.rig(tmp_path, n_chips=4)
    stack = pkg.mod("testing.sim").LiveStack(rig)
    yield stack
    stack.close()


def test_grpc_retry_same_request_id_is_idempotent(pkg, live):
    client = pkg.mod("worker.grpc_server").WorkerClient(
        f"127.0.0.1:{live.grpc_port}")
    with client:
        first, second = (getattr(client, f"add_{pkg.dev}")(
            "workload", "default", 4, True, request_id=RID)
            for _ in range(2))
    assert first.result == second.result == 0
    assert list(first.device_ids) == list(second.device_ids)
    assert len(live.rig.sim.slave_pods()) == 1


def test_http_retry_with_client_request_id_is_idempotent(live):
    url = (f"{live.base}/addgpu/namespace/default/pod/workload"
           "/gpu/1/isEntireMount/false")
    bodies = []
    for _ in range(2):
        req = urllib.request.Request(url, headers={"X-Request-Id": RID})
        with urllib.request.urlopen(req) as resp:
            assert resp.status == 200
            bodies.append(json.loads(resp.read()))
    assert bodies[0]["request_id"] == bodies[1]["request_id"] == RID
    assert bodies[0]["device_ids"] == bodies[1]["device_ids"]
    assert len(live.rig.sim.slave_pods()) == 1
    with urllib.request.urlopen(url) as resp:
        extra = json.loads(resp.read())
    assert extra["device_ids"] != bodies[0]["device_ids"]
    assert len(live.rig.sim.slave_pods()) == 2


def test_invalid_client_request_id_is_400(live):
    status, body = live.gateway.handle(
        "GET", "/addgpu/namespace/default/pod/workload/gpu/1"
               "/isEntireMount/false", headers={"X-Request-Id": "bad/slash!"})
    assert status == 400 and body["result"] == "BadRequestId"
    assert not live.rig.sim.slave_pods()
    status, _ = live.gateway.handle("GET", "/healthz",
                                    headers={"X-Request-Id": "a" * 64})
    assert status == 400


def test_generated_request_id_echoed_without_header(pkg, live):
    status, body = live.gateway.handle(
        "GET", "/addgpu/namespace/default/pod/workload/gpu/1"
               "/isEntireMount/false")
    assert status == 200 and body["request_id"]
    assert pkg.mod("master.gateway")._RID_RE.match(body["request_id"])
