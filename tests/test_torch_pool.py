"""The port's warm slave-pod pool (worker/pool.py) against the control
plane's: the scenarios of tests/test_pool.py, each run through both
packages on a fixture tree (device ``i`` of the TPU rig matched with GPU
``i``), with the same assertions on results, warm pods, pool counters
(deltas: each package has its own registry) and ``/poolz``. A warm GPU
pod requests ``nvidia.com/gpu`` (the allocator's GPU group rules)."""

import json
import threading
import time
import urllib.request

import pytest

from tests.torch_control_plane import BOTH, IDS, TORCH, norm_result


@pytest.fixture(params=BOTH, ids=IDS)
def pkg(request):
    return request.param


@pytest.fixture
def make_rig(pkg, tmp_path):
    rigs = []

    def make(**kwargs):
        rig = pkg.rig(tmp_path / f"rig{len(rigs)}", **kwargs)
        rigs.append(rig)
        return rig
    yield make
    for rig in rigs:
        rig.close()


def warm_pods(pkg, rig):
    c, objects = pkg.consts, pkg.mod("k8s.objects")
    return [p for p in rig.sim.slave_pods()
            if objects.labels(p).get(c.WARM_POD_LABEL_KEY)
            == c.WARM_POD_LABEL_VALUE]


def test_fill_creates_running_unowned_warm_pods(pkg, make_rig):
    rig = make_rig(warm_pool={"single:1": 2})
    rig.fill_warm_pool()
    c, objects = pkg.consts, pkg.mod("k8s.objects")
    pods = warm_pods(pkg, rig)
    assert len(pods) == 2
    for pod in pods:
        labels = objects.labels(pod)
        assert c.OWNER_POD_LABEL_KEY not in labels
        assert c.OWNER_UID_LABEL_KEY not in labels
        assert labels[c.MOUNT_TYPE_LABEL_KEY] == c.MountType.SINGLE.value
        assert objects.is_running(pod)
        assert objects.resource_limit(pod, pkg.resource) == 1
    assert len(rig.sim.podresources.assignments) == 2
    assert pkg.registry.warm_pool_size.value(key="single:1") == 2


def test_warm_gpu_pod_spec_names_the_gpu(tmp_path):
    rig = TORCH.rig(tmp_path, warm_pool={"entire:2": 1})
    rig.fill_warm_pool()
    (pod,) = warm_pods(TORCH, rig)
    rig.close()
    spec = pod["spec"]
    assert spec["containers"][0]["resources"]["limits"] == {
        "nvidia.com/gpu": "2"}
    assert spec["tolerations"] == [{"key": "nvidia.com/gpu",
                                    "operator": "Exists",
                                    "effect": "NoSchedule"}]
    assert pod["metadata"]["labels"]["app"] == "gpu-pool"


def test_pool_metrics_are_exported(pkg, make_rig):
    rig = make_rig(warm_pool={"single:1": 1})
    reg = pkg.registry
    before = reg.pool_refill_latency.count
    rig.fill_warm_pool()
    assert reg.pool_refill_latency.count > before
    text = reg.render_text()
    for family in ("tpumounter_pool_hits_total",
                   "tpumounter_pool_misses_total",
                   "tpumounter_warm_pool_size",
                   "tpumounter_pool_refill_seconds_bucket"):
        assert family in text, family


def test_pool_hit_adopts_without_wait_running(pkg, make_rig, monkeypatch):
    rig = make_rig(schedule_delay_s=0.5, warm_pool={"entire:4": 1})
    rig.fill_warm_pool()
    waits = []
    monkeypatch.setattr(rig.allocator, "_wait_running", waits.append)
    hits0 = pkg.registry.pool_hits.value()
    t0 = time.monotonic()
    out = pkg.add(rig.service, "workload", "default", 4, True)
    elapsed = time.monotonic() - t0
    assert norm_result(out.result) == "SUCCESS" and len(out.chips) == 4
    assert waits == [] and elapsed < 0.5
    assert (out.pool_hits, out.pool_misses) == (1, 0)
    assert pkg.registry.pool_hits.value() == hits0 + 1
    c, objects = pkg.consts, pkg.mod("k8s.objects")
    labels = objects.labels(rig.sim.slave_pods()[0])
    assert c.WARM_POD_LABEL_KEY not in labels
    assert labels[c.OWNER_POD_LABEL_KEY] == "workload"
    assert labels[c.OWNER_NAMESPACE_LABEL_KEY] == "default"
    assert labels[c.OWNER_UID_LABEL_KEY] == "uid-w"
    assert warm_pods(pkg, rig) == []


def test_adopted_pod_detaches_and_status_resolves(pkg, make_rig):
    rig = make_rig(warm_pool={"entire:2": 1})
    rig.fill_warm_pool()
    out = pkg.add(rig.service, "workload", "default", 2, True)
    assert norm_result(out.result) == "SUCCESS" and out.pool_hits == 1
    mount_type, chips = pkg.status(rig.service, "workload", "default")
    assert mount_type is pkg.consts.MountType.ENTIRE and len(chips) == 2
    assert all(c.slave_pod.startswith(pkg.consts.WARM_POD_NAME_PREFIX)
               for c in chips)
    removed = pkg.remove(rig.service, "workload", "default", [], False)
    assert norm_result(removed.result) == "SUCCESS"
    assert rig.sim.slave_pods() == []
    assert rig.sim.podresources.assignments == {}


@pytest.mark.parametrize("pool,n,entire,hits,misses,warm_left", [
    ({"entire:4": 1}, 4, True, 0, 1, 0),     # never filled: cold
    ({"entire:2": 1}, 2, False, 0, 2, 1),    # wrong key: cold, pool kept
    ({"single:1": 2}, 3, False, 2, 1, 0),    # partial hit tops up cold
])
def test_miss_and_partial_hit(pkg, make_rig, pool, n, entire, hits, misses,
                              warm_left):
    rig = make_rig(warm_pool=pool)
    if (hits, warm_left) != (0, 0):
        rig.fill_warm_pool()
    misses0 = pkg.registry.pool_misses.value()
    out = pkg.add(rig.service, "workload", "default", n, entire)
    assert norm_result(out.result) == "SUCCESS" and len(out.chips) == n
    assert (out.pool_hits, out.pool_misses) == (hits, misses)
    assert pkg.registry.pool_misses.value() == misses0 + misses
    assert len(warm_pods(pkg, rig)) == warm_left


def test_stale_resource_version_claim_loses(pkg, make_rig):
    rig = make_rig(warm_pool={"single:1": 1})
    rig.fill_warm_pool()
    c, objects = pkg.consts, pkg.mod("k8s.objects")
    pod = warm_pods(pkg, rig)[0]
    stale_rv = pod["metadata"]["resourceVersion"]
    assert rig.pool.claim(rig.pod, 1, False, 1) == [objects.name(pod)]
    with pytest.raises(pkg.errors.K8sApiError) as err:
        rig.sim.kube.patch_pod(
            rig.sim.settings.pool_namespace, objects.name(pod),
            {"metadata": {"labels": {c.OWNER_POD_LABEL_KEY: "other-pod"}}},
            resource_version=stale_rv)
    assert err.value.status == 409
    live = rig.sim.kube.get_pod(rig.sim.settings.pool_namespace,
                                objects.name(pod))
    assert objects.labels(live)[c.OWNER_POD_LABEL_KEY] == "workload"


def test_concurrent_attaches_one_warm_pod_exactly_one_wins(pkg, make_rig):
    rig = make_rig(n_chips=4, warm_pool={"single:1": 1})
    rig.fill_warm_pool()
    other = rig.sim.add_target_pod(name="workload-b", uid="uid-b")
    rig.provision_container(other)
    hits0 = pkg.registry.pool_hits.value()
    outcomes = {}

    def attach(name):
        outcomes[name] = pkg.add(rig.service, name, "default", 1, False)

    threads = [threading.Thread(target=attach, args=(n,))
               for n in ("workload", "workload-b")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert all(norm_result(o.result) == "SUCCESS"
               for o in outcomes.values()), outcomes
    assert sum(o.pool_hits for o in outcomes.values()) == 1
    assert sum(o.pool_misses for o in outcomes.values()) == 1
    assert pkg.registry.pool_hits.value() - hits0 == 1
    uuids = [c.uuid for o in outcomes.values() for c in o.chips]
    assert len(uuids) == len(set(uuids)) == 2


def test_refill_after_adoption(pkg, make_rig):
    rig = make_rig(n_chips=4, warm_pool={"single:1": 2})
    rig.fill_warm_pool()
    assert pkg.add(rig.service, "workload", "default", 1,
                   False).pool_hits == 1
    assert len(warm_pods(pkg, rig)) == 1
    assert len(rig.pool.scan_once()["created"]) == 1
    assert len(warm_pods(pkg, rig)) == 2
    assert pkg.registry.warm_pool_size.value(key="single:1") == 2


def test_adoption_kicks_background_refill(pkg, make_rig):
    rig = make_rig(n_chips=4, warm_pool={"single:1": 1})
    rig.fill_warm_pool()
    rig.pool.interval_s = 60.0          # only the kick can refill in time
    rig.pool.start()
    try:
        assert pkg.add(rig.service, "workload", "default", 1,
                       False).pool_hits == 1
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline and not warm_pods(pkg, rig):
            time.sleep(0.02)
        assert len(warm_pods(pkg, rig)) == 1
    finally:
        rig.pool.stop()


def test_pool_state_rederived_after_worker_restart(pkg, make_rig):
    rig = make_rig(warm_pool={"single:1": 2})
    rig.fill_warm_pool()
    fresh = pkg.mod("worker.pool").PoolManager(rig.allocator, rig.sim.kube,
                                               rig.sim.settings)
    result = fresh.scan_once()
    assert result["created"] == [] and result["deleted"] == []
    assert len(warm_pods(pkg, rig)) == 2


def test_resize_trims_excess_and_retargets_keys(pkg, make_rig):
    rig = make_rig(warm_pool={"single:1": 2})
    rig.fill_warm_pool()
    rig.sim.settings.warm_pool_sizes = {"single:1": 1}
    assert len(rig.pool.scan_once()["deleted"]) == 1
    assert len(warm_pods(pkg, rig)) == 1
    rig.sim.settings.warm_pool_sizes = {"entire:4": 1}
    rig.fill_warm_pool()
    pods = warm_pods(pkg, rig)
    assert len(pods) == 1
    c = pkg.consts
    assert pkg.mod("k8s.objects").labels(pods[0])[
        c.MOUNT_TYPE_LABEL_KEY] == c.MountType.ENTIRE.value
    # the old key reports 0, not its frozen last value
    assert pkg.registry.warm_pool_size.value(key="entire:4") == 1
    assert pkg.registry.warm_pool_size.value(key="single:1") == 0


def test_allocation_failure_returns_claimed_pod_by_deletion(pkg, make_rig):
    rig = make_rig(warm_pool={"single:1": 1})
    rig.fill_warm_pool()
    rig.sim.settings.kubelet_lag_timeout_s = 0.2
    name = pkg.mod("k8s.objects").name(warm_pods(pkg, rig)[0])
    rig.sim.podresources.unassign(rig.sim.settings.pool_namespace, name)
    out = pkg.add(rig.service, "workload", "default", 1, False)
    assert norm_result(out.result) == "INSUFFICIENT"
    assert rig.sim.slave_pods() == []


@pytest.mark.parametrize("change,deleted", [
    (None, 0), ("terminal", 1), ("disabled", 2)])
def test_reconciler_and_warm_pods(pkg, make_rig, change, deleted):
    rig = make_rig(warm_pool={"single:1": 2})
    rig.fill_warm_pool()
    objects = pkg.mod("k8s.objects")
    victim = objects.name(warm_pods(pkg, rig)[0])
    if change == "terminal":
        rig.sim.kube.set_pod_status(rig.sim.settings.pool_namespace, victim,
                                    phase="Failed")
    elif change == "disabled":
        rig.sim.settings.warm_pool_enabled = False
    out = pkg.mod("worker.reconciler").OrphanReconciler(
        rig.sim.kube, rig.sim.settings).scan_once()
    assert len(out) == deleted
    if change == "terminal":
        assert out == [victim]
    assert len(warm_pods(pkg, rig)) == 2 - deleted


def test_pool_disabled_is_todays_behavior(pkg, make_rig):
    rig = make_rig()
    assert rig.pool is None and rig.service.pool is None
    reg = pkg.registry
    hits0, misses0 = reg.pool_hits.value(), reg.pool_misses.value()
    out = pkg.add(rig.service, "workload", "default", 2, False)
    assert norm_result(out.result) == "SUCCESS"
    assert (out.pool_hits, out.pool_misses) == (0, 0)
    assert (reg.pool_hits.value(), reg.pool_misses.value()) == (hits0,
                                                                misses0)
    assert warm_pods(pkg, rig) == []
    assert norm_result(pkg.remove(rig.service, "workload", "default", [],
                                  False).result) == "SUCCESS"


def test_pool_key_partitioning(pkg):
    pool = pkg.mod("worker.pool")
    assert pool.pool_key(True, 4) == "entire:4"
    assert pool.pool_key(False, 1) == "single:1"
    assert pool.parse_pool_key("entire:4") == (True, 4)
    assert pool.parse_pool_key("single:1") == (False, 1)


@pytest.mark.parametrize("spec", [
    "entire:4=1,single:1=2", "", "entire:4=0", "entire=1", "entire:4",
    "weird:4=1", "single:2=1", "entire:x=1", "entire:4=x"])
def test_parse_warm_pool_sizes(spec):
    out = []
    for p in BOTH:
        try:
            out.append(p.mod("utils.config").parse_warm_pool_sizes(spec))
        except ValueError:
            out.append("ValueError")
    assert out[0] == out[1]
    if isinstance(out[1], dict):
        s = TORCH.mod("utils.config").Settings.from_env(
            {"TPU_WARM_POOL": spec})
        assert s.warm_pool_sizes == out[1]
        assert s.warm_pool_enabled == bool(out[1])


def test_pool_status_and_poolz_endpoint(pkg, make_rig):
    rig = make_rig(warm_pool={"single:1": 1})
    rig.fill_warm_pool()
    status = rig.pool.status()
    assert status["enabled"] is True
    assert status["keys"]["single:1"]["running"] == 1
    assert status["keys"]["single:1"]["target"] == 1
    server = pkg.mod("worker.main").start_health_server(0, pool=rig.pool)
    try:
        url = f"http://127.0.0.1:{server.server_port}/poolz"
        with urllib.request.urlopen(url, timeout=5) as resp:
            assert json.loads(resp.read()) == json.loads(
                json.dumps(rig.pool.status()))
    finally:
        server.shutdown()


def test_scan_trim_cannot_kill_concurrently_adopted_pod(pkg, make_rig,
                                                        monkeypatch):
    rig = make_rig(warm_pool={"single:1": 1})
    rig.fill_warm_pool()
    stale_view = rig.pool._list_warm()
    claimed = rig.pool.claim(rig.pod, 1, False, 1)
    assert claimed
    rig.sim.settings.warm_pool_sizes = {"single:1": 0}
    monkeypatch.setattr(rig.pool, "_list_warm", lambda: stale_view)
    assert rig.pool.scan_once()["deleted"] == []
    live = rig.sim.kube.get_pod(rig.sim.settings.pool_namespace, claimed[0])
    assert pkg.mod("k8s.objects").labels(live)[
        pkg.consts.OWNER_POD_LABEL_KEY] == "workload"


def test_claim_keeps_partial_wins_on_apiserver_error(pkg, make_rig,
                                                     monkeypatch):
    rig = make_rig(warm_pool={"single:1": 2})
    rig.fill_warm_pool()
    real_patch = rig.sim.kube.patch_pod
    calls = {"n": 0}

    def flaky_patch(*args, **kwargs):
        calls["n"] += 1
        if calls["n"] > 1:
            raise pkg.errors.K8sApiError(500, "apiserver on fire")
        return real_patch(*args, **kwargs)

    monkeypatch.setattr(rig.sim.kube, "patch_pod", flaky_patch)
    claimed = rig.pool.claim(rig.pod, 1, False, 2)
    assert len(claimed) == 1
    live = rig.sim.kube.get_pod(rig.sim.settings.pool_namespace, claimed[0])
    assert pkg.mod("k8s.objects").labels(live)[
        pkg.consts.OWNER_POD_LABEL_KEY] == "workload"


def test_claim_list_failure_degrades_to_counted_miss(pkg, make_rig,
                                                     monkeypatch):
    rig = make_rig(warm_pool={"single:1": 1})
    rig.fill_warm_pool()

    def boom():
        raise pkg.errors.K8sApiError(500, "LIST unavailable")

    monkeypatch.setattr(rig.pool, "_list_warm", boom)
    misses0 = pkg.registry.pool_misses.value()
    out = pkg.add(rig.service, "workload", "default", 1, False)
    assert norm_result(out.result) == "SUCCESS"
    assert (out.pool_hits, out.pool_misses) == (0, 1)
    assert pkg.registry.pool_misses.value() == misses0 + 1


def test_status_buckets_doomed_pods_as_stale(pkg, make_rig):
    rig = make_rig(warm_pool={"single:1": 2})
    rig.fill_warm_pool()
    victim = pkg.mod("k8s.objects").name(warm_pods(pkg, rig)[0])
    rig.sim.kube.set_pod_status(rig.sim.settings.pool_namespace, victim,
                                phase="Failed")
    assert rig.pool.status()["keys"]["single:1"] == {
        "target": 2, "running": 1, "pending": 0, "stale": 1}


def test_the_same_pool_transcript(tmp_path):
    """One fill, hit, miss, refill and trim through both packages: the
    scan results and status views agree after the GPU mapping."""
    out = []
    for p in BOTH:
        rig = p.rig(tmp_path / p.name, n_chips=4,
                    warm_pool={"single:1": 2, "entire:2": 0})
        try:
            steps = [len(rig.pool.scan_once()["created"])]
            rig.fill_warm_pool()
            steps.append(rig.pool.status()["keys"])
            a = p.add(rig.service, "workload", "default", 1, False)
            steps.append((norm_result(a.result), a.pool_hits, a.pool_misses))
            result = rig.pool.scan_once()
            steps.append((len(result["created"]), len(result["deleted"])))
            rig.sim.settings.warm_pool_sizes = {"single:1": 1}
            result = rig.pool.scan_once()
            steps.append((len(result["created"]), len(result["deleted"])))
            steps.append(rig.pool.status()["keys"])
            out.append(steps)
        finally:
            rig.close()
    assert out[0] == out[1]
