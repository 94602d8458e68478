"""GPU usage sampler and the fleet's utilization join, through both
packages: the cases of tests/test_usage.py, each run against the control
plane and the port with the same inputs and the same expected answers
(counters compared as deltas), plus the port's GPU probe — NVML
utilization by UUID (a fake NVML here), the open-fd fallback on the GPU's
own node, and one NVML init per sampler life. The doctor and
``tpumounterctl fleet`` lines of the e2e wait for the port's CLI (ROADMAP
Queue 1 item 13)."""

from __future__ import annotations

import ctypes
import importlib
import json
import os
import time
import urllib.request

import pytest

from tests.torch_control_plane import BOTH, IDS, TORCH, norm_path, norm_uuid


@pytest.fixture(params=BOTH, ids=IDS)
def pkg(request):
    return request.param


def _m(pkg, name):
    return importlib.import_module(f"{pkg.root}.{name}")


def _get_json(url, timeout=30):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return json.loads(resp.read())


def _add_url(pkg, base, pod, n, query=""):
    return (f"{base}/add{pkg.dev}/namespace/default/pod/{pod}/{pkg.dev}/{n}"
            f"/isEntireMount/true{query}")


# -- config knobs --------------------------------------------------------------

def test_usage_knobs_default_on_and_disable(pkg):
    Settings = pkg.mod("utils.config").Settings
    s = Settings.from_env({})
    assert s.usage_enabled is True
    assert s.usage_interval_s == 5.0
    assert s.idle_lease_s == 300.0
    assert Settings.from_env({"TPU_USAGE": "0"}).usage_enabled is False
    s = Settings.from_env({"TPU_USAGE_INTERVAL_S": "1.5",
                           "TPU_IDLE_LEASE_S": "60"})
    assert s.usage_interval_s == 1.5 and s.idle_lease_s == 60.0
    with pytest.raises(ValueError):
        Settings.from_env({"TPU_USAGE_INTERVAL_S": "0"})
    with pytest.raises(ValueError):
        Settings.from_env({"TPU_IDLE_LEASE_S": "-1"})


# -- the GPU probe (NVML by UUID, else open fds on the GPU's own node) ---------

class FakeNvml:
    """``libnvidia-ml.so.1`` as the probe calls it: utilization percent by
    UUID, counted inits and shutdowns."""

    def __init__(self, util: dict[str, int], init_rc: int = 0):
        self.util = dict(util)
        self.init_rc = init_rc
        self.inits = self.shutdowns = self.util_calls = 0
        self._uuids = list(util)

    def nvmlInit_v2(self):
        self.inits += 1
        return self.init_rc

    def nvmlShutdown(self):
        self.shutdowns += 1
        return 0

    def nvmlDeviceGetHandleByUUID(self, uuid, handle):
        uuid = uuid.decode()
        if uuid not in self._uuids:
            return 13                   # NVML_ERROR_NOT_FOUND
        handle._obj.value = self._uuids.index(uuid) + 1
        return 0

    def nvmlDeviceGetUtilizationRates(self, handle, util):
        self.util_calls += 1
        util._obj.gpu = self.util[self._uuids[handle.value - 1]]
        return 0


def _gpu_tree(host, n):
    """``n`` fake GPU nodes and the companions on a fixture tree, and the
    enumerator over it."""
    from gpumounter_tpu_torch.device.enumerator import PyEnumerator
    for i in range(n):
        with open(os.path.join(host.dev_root, f"nvidia{i}"), "w"):
            pass
    for name in ("nvidiactl", "nvidia-uvm"):
        with open(os.path.join(host.dev_root, name), "w"):
            pass
    return PyEnumerator(host, allow_fake=True,
                        nvml=lambda: {i: (f"GPU-{i:08x}", "")
                                      for i in range(n)})


def _hold(host, pid, path, fd=3):
    fd_dir = os.path.join(host.proc_root, str(pid), "fd")
    os.makedirs(fd_dir, exist_ok=True)
    os.symlink(path, os.path.join(fd_dir, str(fd)))


def test_gpu_probe_reads_nvml_utilization_by_uuid(tmp_path):
    from gpumounter_tpu_torch.collector.usage import GpuUsageProbe
    host = TORCH.host(tmp_path)
    enum = _gpu_tree(host, 2)
    gpus = enum.enumerate()
    nvml = FakeNvml({gpus[0].uuid: 42, gpus[1].uuid: 0})
    probe = GpuUsageProbe(host, enum, lib=nvml)
    probe.open()
    try:
        duties = probe.sample(gpus)
        assert duties == {gpus[0].uuid: pytest.approx(0.42),
                          gpus[1].uuid: 0.0}
        assert [probe.source(g.uuid) for g in gpus] == ["nvml", "nvml"]
        # an NVML reading wins over an open fd on the node
        _hold(host, 55, gpus[1].device_path)
        assert probe.sample(gpus)[gpus[1].uuid] == 0.0
    finally:
        probe.close()
    assert (nvml.inits, nvml.shutdowns) == (1, 1)


def test_gpu_probe_falls_back_to_open_fds_on_the_gpus_own_node(tmp_path):
    """Where NVML does not know a GPU (or does not load), duty is its own
    node's open fds; a process holding only ``nvidiactl`` and
    ``nvidia-uvm`` — as every CUDA process does — makes no GPU busy."""
    from gpumounter_tpu_torch.collector.usage import GpuUsageProbe
    host = TORCH.host(tmp_path)
    enum = _gpu_tree(host, 3)
    gpus = enum.enumerate()
    nvml = FakeNvml({gpus[0].uuid: 90})          # NVML knows GPU 0 only
    probe = GpuUsageProbe(host, enum, lib=nvml)
    probe.open()
    try:
        _hold(host, 70, os.path.join(host.dev_root, "nvidiactl"), 3)
        _hold(host, 70, os.path.join(host.dev_root, "nvidia-uvm"), 4)
        _hold(host, 71, gpus[2].device_path)
        duties = probe.sample(gpus)
        assert duties == {gpus[0].uuid: pytest.approx(0.9),
                          gpus[1].uuid: 0.0, gpus[2].uuid: 1.0}
        assert [probe.source(g.uuid) for g in gpus] == [
            "nvml", "open-fd", "open-fd"]
        os.unlink(os.path.join(host.proc_root, "71", "fd", "3"))
        assert probe.sample(gpus)[gpus[2].uuid] == 0.0
    finally:
        probe.close()


@pytest.mark.parametrize("nvml", ["absent", "init-fails"])
def test_gpu_probe_without_nvml_reads_open_fds(tmp_path, nvml):
    from gpumounter_tpu_torch.collector.usage import GpuUsageProbe
    host = TORCH.host(tmp_path)
    enum = _gpu_tree(host, 1)
    gpus = enum.enumerate()
    lib = FakeNvml({gpus[0].uuid: 99}, init_rc=999)
    probe = (GpuUsageProbe(host, enum, load=lambda: None)
             if nvml == "absent" else GpuUsageProbe(host, enum, lib=lib))
    probe.open()
    _hold(host, 80, gpus[0].device_path)
    assert probe.sample(gpus) == {gpus[0].uuid: 1.0}
    assert probe.source(gpus[0].uuid) == "open-fd"
    probe.close()
    # a failed init is never shut down, and never read
    assert (lib.shutdowns, lib.util_calls) == (0, 0)


def test_gpu_probe_with_neither_source_observes_nothing(tmp_path):
    """No NVML and an unreadable ``/proc``: the GPU is unobserved (no
    sample at all), never reported idle."""
    from gpumounter_tpu_torch.collector.usage import GpuUsageProbe
    host = TORCH.host(tmp_path)
    enum = _gpu_tree(host, 1)
    gpus = enum.enumerate()
    os.rmdir(host.proc_root)
    probe = GpuUsageProbe(host, enum, load=lambda: None)
    probe.open()
    assert probe.sample(gpus) == {}
    assert probe.source(gpus[0].uuid) == ""


def test_sampler_holds_one_nvml_init_for_its_life(tmp_path):
    """``start`` inits NVML once, every pass reuses it, ``stop`` shuts it
    down; /utilz reports each GPU's ``duty_source``."""
    from gpumounter_tpu_torch.collector.usage import GpuUsageProbe
    rig = TORCH.rig(tmp_path, n_chips=2, usage="fake")
    try:
        gpus = rig.sim.collector.chips
        nvml = FakeNvml({gpus[0].uuid: 60, gpus[1].uuid: 0})
        rig.usage.probe = GpuUsageProbe(rig.host, rig.sim.enumerator,
                                        lib=nvml)
        rig.usage.interval_s = 3600.0       # the loop never samples
        rig.usage.start()
        for _ in range(5):
            rig.usage.sample_once()
        assert (nvml.inits, nvml.shutdowns, nvml.util_calls) == (1, 0, 10)
        rows = {r["chip"]: r for r in rig.usage.snapshot()["chips"]}
        assert rows[gpus[0].uuid]["duty"] == 0.6
        assert {r["duty_source"] for r in rows.values()} == {"nvml"}
        rig.usage.stop()
        assert (nvml.inits, nvml.shutdowns) == (1, 1)
    finally:
        rig.close()


# -- sampler: attribution, edges, ring, gauges, /utilz -------------------------

@pytest.fixture
def usage_rig(pkg, tmp_path):
    rig = pkg.rig(tmp_path, n_chips=4, usage="fake")
    yield pkg, rig
    rig.close()


def test_sampler_attributes_chips_to_owner_and_counts_opens(usage_rig):
    pkg, rig = usage_rig
    reg = pkg.registry
    outcome = pkg.add(rig.service, "workload", "default", 2, True)
    assert outcome.result.name == "SUCCESS"
    uuids = [c.uuid for c in outcome.chips]
    attributed0 = reg.device_opens.value(tenant="default",
                                         outcome="attributed")
    entry = rig.usage.sample_once()
    for uuid in uuids:
        assert entry["chips"][uuid]["owner"] == "default/workload"
        assert entry["chips"][uuid]["busy"] is False
    for uuid in uuids:
        rig.usage_probe.set_duty(uuid, 0.8)
    rig.usage.sample_once()
    assert reg.device_opens.value(tenant="default",
                                  outcome="attributed") == attributed0 + 2
    rig.usage.sample_once()           # still busy: edges, not levels
    assert reg.device_opens.value(tenant="default",
                                  outcome="attributed") == attributed0 + 2
    for uuid in uuids:
        rig.usage_probe.set_duty(uuid, 0.0)
    rig.usage.sample_once()
    for uuid in uuids:
        rig.usage_probe.set_duty(uuid, 0.5)
    rig.usage.sample_once()
    assert reg.device_opens.value(tenant="default",
                                  outcome="attributed") == attributed0 + 4
    assert reg.chip_duty_cycle.value(chip=uuids[0]) == 0.5
    snap = rig.usage.snapshot()
    owner = snap["owners"]["default/workload"]
    assert owner["chips"] == 2 and owner["busy_chips"] == 2
    assert snap["opens"]["attributed"] >= 2
    by_uuid = {c["chip"]: c for c in snap["chips"]}
    assert by_uuid[uuids[0]]["opens"] == 2
    assert by_uuid[uuids[0]]["slave_pod"]


def test_unattributed_busy_chip_is_flagged_and_counted(usage_rig):
    pkg, rig = usage_rig
    before = pkg.registry.device_opens.value(tenant="",
                                             outcome="unattributed")
    free_uuid = rig.sim.collector.chips[0].uuid
    rig.usage_probe.set_duty(free_uuid, 1.0)
    rig.usage.sample_once()
    assert pkg.registry.device_opens.value(
        tenant="", outcome="unattributed") == before + 1
    snap = rig.usage.snapshot()
    assert snap["unattributed_busy"] == 1
    flagged = [c for c in snap["chips"] if c.get("unattributed_busy")]
    assert [c["chip"] for c in flagged] == [free_uuid]


def test_sampler_ring_is_bounded_and_averages_window(usage_rig):
    _, rig = usage_rig
    rig.usage._ring = type(rig.usage._ring)(maxlen=16)
    uuid = rig.sim.collector.chips[0].uuid
    for i in range(40):
        rig.usage_probe.set_duty(uuid, 1.0 if i % 2 else 0.0)
        rig.usage.sample_once()
    snap = rig.usage.snapshot()
    assert snap["window_samples"] == 16
    assert snap["samples"] == 40
    chip = next(c for c in snap["chips"] if c["chip"] == uuid)
    assert 0.3 <= chip["avg_duty"] <= 0.7


def test_utilz_endpoint_serves_snapshot_and_disabled_stub(usage_rig):
    pkg, rig = usage_rig
    start = pkg.mod("worker.main").start_health_server
    server = start(0, usage=rig.usage, ready=True)
    bare = start(0, ready=True)
    try:
        payload = _get_json(f"http://127.0.0.1:{server.server_port}/utilz")
        assert payload["enabled"] is True
        assert payload["interval_s"] == rig.usage.interval_s
        assert _get_json(f"http://127.0.0.1:{bare.server_port}/utilz") == {
            "enabled": False}
    finally:
        server.shutdown()
        bare.shutdown()


def _snapshot_roles(snap: dict) -> dict:
    """A /utilz snapshot with device names by role, the wall clock and the
    port's ``duty_source`` dropped: what both packages must agree on."""
    out = {k: v for k, v in snap.items() if k != "ts"}
    out["chips"] = [
        {k: (norm_uuid(v) if k == "chip" else norm_path(v)
             if k == "device_path" else v)
         for k, v in row.items()
         if k not in ("duty_source", "last_busy_unix", "slave_pod")}
        for row in snap["chips"]]
    out["owners"] = {o: {k: v for k, v in agg.items()
                         if k != "last_busy_unix"}
                     for o, agg in snap["owners"].items()}
    return out


def test_utilz_transcripts_agree(tmp_path):
    """One duty script through both packages' samplers gives the same
    /utilz (device names by role); the port adds ``duty_source`` to each
    row."""
    script = [{0: 0.8, 1: 0.8}, {0: 0.8, 1: 0.0, 3: 1.0}, {}, {2: 0.3}]
    snaps = {}
    for pkg in BOTH:
        rig = pkg.rig(tmp_path / pkg.name, n_chips=4, usage="fake")
        try:
            assert pkg.add(rig.service, "workload", "default", 2,
                           True).result.name == "SUCCESS"
            uuids = [c.uuid for c in rig.sim.collector.chips]
            for duties in script:
                for i, uuid in enumerate(uuids):
                    rig.usage_probe.set_duty(uuid, duties.get(i, 0.0))
                rig.usage.sample_once()
            snaps[pkg.name] = rig.usage.snapshot()
        finally:
            rig.close()
    assert {r["duty_source"] for r in snaps["torch"]["chips"]} == {"fake"}
    assert _snapshot_roles(snaps["torch"]) == _snapshot_roles(snaps["jax"])


# -- fleet join: per-node summary, activity map, idle list ---------------------

class _FakeLease:
    def __init__(self, tenant, priority="normal"):
        self.tenant = tenant
        self.priority = priority


def test_fleet_applies_utilz_and_lists_idle_leases(pkg):
    leases = {("default", "pod-a"): _FakeLease("teamA"),
              ("default", "pod-b"): _FakeLease("teamB")}
    fleet = pkg.mod("master.fleet").FleetAggregator(
        lambda: {}, lease_lookup=lambda ns, pod: leases.get((ns, pod)))
    record = type("R", (), {"node": "node-0", "utilz": None})()
    payload = {
        "enabled": True,
        "chips": [{"chip": "0", "duty": 0.9, "busy": True},
                  {"chip": "1", "duty": 0.9, "busy": True},
                  {"chip": "2", "duty": 0.0, "busy": False},
                  {"chip": "3", "duty": 0.0, "busy": False}],
        "unattributed_busy": 0,
        "owners": {
            "default/pod-a": {"chips": 2, "busy_chips": 2,
                              "avg_duty": 0.9,
                              "last_busy_unix": time.time()},
            "default/pod-b": {"chips": 2, "busy_chips": 0,
                              "avg_duty": 0.0, "last_busy_unix": None},
        },
    }
    fleet._apply_utilz(record, payload)
    assert record.utilz["chips_busy"] == 2
    assert record.utilz["chips_total"] == 4
    view = fleet._utilization_view()
    assert view["tenants"]["teamA"]["busy_chips"] == 2
    assert view["tenants"]["teamA"]["avg_duty"] == pytest.approx(0.9)
    assert view["tenants"]["teamB"]["idle_chips"] == 2
    idle = view["idle_leases"]
    assert len(idle) == 1 and idle[0]["pod"] == "pod-b"
    assert idle[0]["tenant"] == "teamB"
    activity = fleet.lease_activity()
    assert activity[("default", "pod-a")]["busy_chips"] == 2
    assert activity[("default", "pod-b")]["last_busy_unix"] is None
    record2 = type("R", (), {"node": "node-1", "utilz": None})()
    fleet._apply_utilz(record2, {"enabled": False})
    assert record2.utilz is None
    fleet._apply_utilz(record, {"enabled": False})
    assert record.utilz is None


# -- broker: idle marking + idle-aware victim preference -----------------------

def _activity(busy: bool, idle_for_s: float = 0.0):
    now = time.time()
    return {"busy_chips": 2 if busy else 0, "chips": 2,
            "duty": 0.9 if busy else 0.0,
            "first_seen_unix": now - idle_for_s,
            "last_busy_unix": now if busy else None,
            "last_seen_unix": now, "node": "node-a"}


def _broker(pkg, **config):
    admission = pkg.mod("master.admission")
    broker = admission.AttachBroker(pkg.mod("k8s.client").FakeKubeClient(),
                                    admission.BrokerConfig(**config))
    broker._rederived = True
    return broker


def test_broker_marks_idle_leases_and_prefers_idle_victims(pkg):
    reg = pkg.registry
    broker = _broker(pkg, quotas={"teamA": 1, "teamB": 1}, quota_burst=2.0,
                     idle_lease_s=5.0)
    seq0 = pkg.mod("utils.events").EVENTS.tail(1)
    seq0 = seq0[-1]["seq"] if seq0 else 0
    broker.leases.record("default", "pod-b", "teamB", "normal",
                         ["2", "3"], node="node-a")
    time.sleep(0.01)
    broker.leases.record("default", "pod-a", "teamA", "normal",
                         ["0", "1"], node="node-a")
    feed = {("default", "pod-a"): _activity(busy=True),
            ("default", "pod-b"): _activity(busy=False, idle_for_s=10.0)}
    broker.bind_utilization(lambda: feed)
    broker._mark_idle_leases()
    lease_a = broker.leases.get("default", "pod-a")
    lease_b = broker.leases.get("default", "pod-b")
    assert lease_a.idle_since_unix is None
    assert lease_b.idle_since_unix is not None
    assert reg.tenant_chips_idle.value(tenant="teamB") == 2
    assert reg.tenant_chips_idle.value(tenant="teamA") == 0
    assert lease_b.to_json()["idle"] is True
    assert lease_b.to_json()["idle_s"] >= 0
    assert "idle" not in lease_a.to_json()
    events = [e for e in pkg.mod("utils.events").EVENTS.tail(64)
              if e["kind"] == "idle_lease" and e["seq"] > seq0]
    assert [e.get("pod") for e in events] == ["pod-b"]
    snap = broker.snapshot()
    assert snap["tenants"]["teamB"]["idle_chips"] == 2
    assert "idle_chips" not in snap["tenants"]["teamA"]
    waiter = type("W", (), {"tenant": "vip", "priority": "high",
                            "namespace": "default", "pod": "vip-pod",
                            "node": "node-a", "rid": "r1"})()
    assert broker._pick_victim(waiter).pod == "pod-b"
    feed[("default", "pod-b")] = _activity(busy=True)
    broker._mark_idle_leases()
    assert broker.leases.get("default", "pod-b").idle_since_unix is None
    assert reg.tenant_chips_idle.value(tenant="teamB") == 0


def test_idle_mark_clears_on_burst_between_scrapes_and_lost_feed(pkg):
    broker = _broker(pkg, idle_lease_s=5.0)
    broker.leases.record("default", "pod-i", "teamI", "normal", ["0"])
    feed = {("default", "pod-i"): _activity(busy=False, idle_for_s=10.0)}
    broker.bind_utilization(lambda: feed)
    broker._mark_idle_leases()
    lease = broker.leases.get("default", "pod-i")
    assert lease.idle_since_unix is not None
    now = time.time()
    feed[("default", "pod-i")] = {
        "busy_chips": 0, "chips": 1, "duty": 0.0,
        "first_seen_unix": now - 60.0, "last_busy_unix": now - 1.0,
        "last_seen_unix": now, "node": "node-a"}
    broker._mark_idle_leases()
    assert lease.idle_since_unix is None
    feed[("default", "pod-i")] = _activity(busy=False, idle_for_s=10.0)
    broker._mark_idle_leases()
    assert lease.idle_since_unix is not None
    feed.clear()
    broker._mark_idle_leases()
    assert lease.idle_since_unix is None
    assert pkg.registry.tenant_chips_idle.value(tenant="teamI") == 0


def test_broker_ignores_unobserved_leases_and_short_idle(pkg):
    broker = _broker(pkg, idle_lease_s=60.0)
    broker.leases.record("default", "pod-x", "teamX", "normal", ["0"])
    broker.leases.record("default", "pod-y", "teamY", "normal", ["1"])
    broker.bind_utilization(lambda: {
        ("default", "pod-y"): _activity(busy=False, idle_for_s=1.0)})
    broker._mark_idle_leases()
    assert broker.leases.get("default", "pod-x").idle_since_unix is None
    assert broker.leases.get("default", "pod-y").idle_since_unix is None


def test_idle_lease_burst_triggers_one_flight_bundle(pkg, tmp_path):
    recorder = _m(pkg, "utils.flight").RECORDER
    recorder.configure(str(tmp_path), min_interval_s=0.0, settle_s=0.0)
    try:
        broker = _broker(pkg, idle_lease_s=1.0)
        feed = {}
        for i in range(3):
            broker.leases.record("default", f"pod-{i}", f"t{i}",
                                 "normal", [str(i)])
            feed[("default", f"pod-{i}")] = _activity(busy=False,
                                                      idle_for_s=5.0)
        broker.bind_utilization(lambda: feed)
        broker._mark_idle_leases()
        bundles = [n for n in os.listdir(tmp_path)
                   if "idle_lease_burst" in n]
        assert len(bundles) == 1
        with open(tmp_path / bundles[0]) as f:
            assert json.load(f)["trigger"] == "idle_lease_burst"
    finally:
        recorder.configure(None)


# -- acceptance e2e: idle tenant flagged fleet-wide and preempted first --------

def test_e2e_idle_lease_flagged_and_preempted_before_busy(pkg, tmp_path):
    """Two tenants hold live leases on one node; one goes idle. /utilz
    attributes per-lease utilization, /fleetz lists the idle lease within
    ONE fleet tick, and a high-priority waiter preempts the IDLE lease
    while the busy tenant's GPUs survive."""
    admission = pkg.mod("master.admission")
    config = admission.BrokerConfig(
        quotas={"teamA": 1, "teamB": 1, "vip": 8}, quota_burst=2.0,
        queue_timeout_s=30.0, idle_lease_s=0.3)
    rig = pkg.rig(tmp_path, n_chips=4, usage="fake")
    stack = pkg.mod("testing.sim").LiveStack(rig, broker_config=config,
                                             shared_kube=True)
    try:
        for name in ("pod-a", "pod-b", "vip-pod"):
            rig.provision_container(rig.sim.add_target_pod(name=name))

        def attach(pod, tenant, priority="normal"):
            return _get_json(_add_url(
                pkg, stack.base, pod, 2,
                f"?tenant={tenant}&priority={priority}"), timeout=60)

        body_b = attach("pod-b", "teamB")
        body_a = attach("pod-a", "teamA")
        assert body_a["result"] == "SUCCESS", body_a
        assert body_b["result"] == "SUCCESS", body_b
        for uuid in body_a["device_ids"]:
            rig.usage_probe.set_duty(uuid, 0.9)
        for uuid in body_b["device_ids"]:
            rig.usage_probe.set_duty(uuid, 0.0)
        rig.usage.sample_once()
        utilz = rig.usage.snapshot()
        assert utilz["owners"]["default/pod-a"]["busy_chips"] == 2
        assert utilz["owners"]["default/pod-b"]["busy_chips"] == 0

        assert stack.gateway.fleet.tick() == {"node-a": "fresh"}
        fleetz = _get_json(f"{stack.base}/fleetz")
        util = fleetz["utilization"]
        assert util["tenants"]["teamA"]["busy_chips"] == 2
        assert util["tenants"]["teamB"]["idle_chips"] == 2
        assert [i["pod"] for i in util["idle_leases"]] == ["pod-b"]
        node_util = fleetz["nodes"]["node-a"]["utilization"]
        assert (node_util["chips_busy"], node_util["chips_total"]) == (2, 4)

        time.sleep(0.4)
        rig.usage.sample_once()
        stack.gateway.fleet.tick()
        stack.gateway.broker.tick()
        brokerz = _get_json(f"{stack.base}/brokerz")
        by_pod = {lease["pod"]: lease
                  for lease in brokerz["leases"]["leases"]}
        assert by_pod["pod-b"].get("idle") is True
        assert "idle" not in by_pod["pod-a"]

        vip = attach("vip-pod", "vip", priority="high")
        assert vip["result"] == "SUCCESS", vip
        brokerz = _get_json(f"{stack.base}/brokerz")
        held = {lease["pod"] for lease in brokerz["leases"]["leases"]}
        assert held == {"pod-a", "vip-pod"}
    finally:
        stack.close()


def test_usage_off_restores_pre_sampler_payloads(pkg, tmp_path):
    """TPU_USAGE=0 semantics: no sampler wired — /utilz answers the
    disabled stub, /fleetz carries NO utilization section, and lease
    payloads carry no idle fields."""
    admission = pkg.mod("master.admission")
    rig = pkg.rig(tmp_path, n_chips=4)
    stack = pkg.mod("testing.sim").LiveStack(
        rig, broker_config=admission.BrokerConfig(), shared_kube=True)
    try:
        rig.provision_container(rig.sim.add_target_pod(name="pod-z"))
        body = _get_json(_add_url(pkg, stack.base, "pod-z", 2), timeout=60)
        assert body["result"] == "SUCCESS", body
        health = f"http://127.0.0.1:{stack.health_server.server_port}"
        assert _get_json(f"{health}/utilz") == {"enabled": False}
        stack.gateway.fleet.tick()
        fleetz = _get_json(f"{stack.base}/fleetz")
        assert "utilization" not in fleetz
        assert "utilization" not in fleetz["nodes"]["node-a"]
        brokerz = _get_json(f"{stack.base}/brokerz")
        for lease in brokerz["leases"]["leases"]:
            assert "idle" not in lease and "idle_s" not in lease
        for tenant in brokerz["tenants"].values():
            assert "idle_chips" not in tenant
    finally:
        stack.close()


def test_sampler_off_adds_no_series_and_no_thread(tmp_path):
    """The port's worker with TPU_USAGE=0 builds no sampler: no
    ``tpumounter-usage`` thread runs, and ``build_sampler`` wires the GPU
    probe only when asked."""
    import threading

    from gpumounter_tpu_torch.collector.usage import (GpuUsageProbe,
                                                      build_sampler)
    rig = TORCH.rig(tmp_path, n_chips=2)
    try:
        assert rig.usage is None
        assert not any(t.name == "tpumounter-usage"
                       for t in threading.enumerate())
        settings = rig.sim.settings
        settings.usage_interval_s = 3600.0
        sampler = build_sampler(rig.service, settings)
        assert isinstance(sampler.probe, GpuUsageProbe)
        assert sampler.refresh_inventory is True
        assert sampler.interval_s == 3600.0
    finally:
        rig.close()


def test_gpu_probe_binds_nvml_handles_by_uuid_only(tmp_path):
    """The probe asks NVML for a handle by the GPU's UUID and never by
    index: a GPU whose UUID NVML does not know reads from its node."""
    from gpumounter_tpu_torch.collector.usage import GpuUsageProbe
    host = TORCH.host(tmp_path)
    enum = _gpu_tree(host, 2)
    gpus = enum.enumerate()
    nvml = FakeNvml({"GPU-other": 100, gpus[1].uuid: 7})
    probe = GpuUsageProbe(host, enum, lib=nvml)
    probe.open()
    try:
        duties = probe.sample(gpus)
        assert duties == {gpus[0].uuid: 0.0,
                          gpus[1].uuid: pytest.approx(0.07)}
        assert probe.source(gpus[0].uuid) == "open-fd"
        assert isinstance(probe._handles[gpus[1].uuid], ctypes.c_void_p)
    finally:
        probe.close()
