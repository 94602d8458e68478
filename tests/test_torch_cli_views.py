"""The CLI cases of the control plane's other test files, held against
gpumounterctl: node health (tests/test_nodehealth.py), the HA plane
(test_ha.py), SLO burn and fleet staleness (test_slo.py), flight bundles
(test_flight.py), the trace waterfall (test_tracez.py), the stuck
re-federation barrier (test_federation.py) and the device gate
(test_gate.py). Each runs through both packages: over a stubbed fetch
both CLIs read the same payloads and their output is compared whole
(after the renames of tests/test_torch_cli.py); against live stacks each
package's CLI reads its own."""

import importlib
import json
import time
import urllib.request
import uuid

import pytest

from tests.test_torch_cli import (CLIS, FLAG, MISSING, TORCH, output,
                                  run_cli, stubbed)
from tests.torch_control_plane import BOTH, IDS

TORCH_CLI = CLIS["torch"]


@pytest.fixture(params=BOTH, ids=IDS)
def pkg(request):
    return request.param


def _routes(routes: dict, metrics=None):
    """A stubbed target: ``routes`` by path (a dict is served as JSON,
    ``MISSING`` answers 404), /metrics from ``metrics`` scrapes in turn,
    and every other route a 404."""
    def make(cli):
        scrapes = list(metrics or [""])

        def fetch(master, path, timeout):
            route = path.split("?")[0]
            if route == "/metrics":
                return scrapes.pop(0) if len(scrapes) > 1 else scrapes[0]
            value = routes.get(route, MISSING)
            if value is MISSING:
                raise cli.TransportError(f"GET {path}: 404")
            return value if isinstance(value, str) else json.dumps(value)
        return fetch
    return make


OK = '{"status": "ok"}'

# -- node health (tests/test_nodehealth.py:394-420) ----------------------------

_FLEETZ_DEAD = {
    "nodes": {"node-x": {"state": "stale", "missed_ticks": 9}},
    "node_health": {
        "enabled": True, "suspect_after_ticks": 2, "dead_after_ticks": 5,
        "nodes": {"node-x": {"state": "dead", "reason": "scrape-silence",
                             "missed_ticks": 9,
                             "since_unix": time.time() - 300}}},
}
_BROKERZ_DEAD = {
    "fenced": [{"namespace": "d", "pod": "p1", "tenant": "t",
                "chips": 2, "node": "node-x", "reason": "node-dead",
                "ts": 1.0}],
    "leases": {"leases": [{"namespace": "d", "pod": "p2",
                           "tenant": "t", "chips": 2,
                           "node": "node-x"}]},
    "queue": {"depth": {}, "oldest_age_s": 0.0, "waiters": []},
    "tenants": {},
}


def _health(fleetz, brokerz):
    return _routes({"/healthz": OK, "/fleetz": fleetz, "/brokerz": brokerz},
                   metrics=["{}"])


def test_cli_nodes_exits_nonzero_on_dead_with_leases(pkg, monkeypatch):
    rc, out = stubbed(monkeypatch, _health(_FLEETZ_DEAD, _BROKERZ_DEAD),
                      pkg, "nodes")
    assert rc == 1
    assert "node-x: DEAD" in out
    assert "DEAD WITH LIVE LEASES" in out
    assert "fenced: d/p1" in out


def test_cli_nodes_reports_disabled_subsystem(pkg, monkeypatch):
    rc, out = stubbed(monkeypatch, _health({"nodes": {}}, {}), pkg, "nodes")
    assert rc == 0
    assert "disabled" in out


def test_doctor_crits_dead_node_with_live_leases(pkg, monkeypatch):
    rc, out = stubbed(monkeypatch, _health(_FLEETZ_DEAD, _BROKERZ_DEAD),
                      pkg, "doctor")
    assert rc == CLIS[pkg.name].EXIT_DOCTOR_CRIT
    assert "DEAD node(s) still holding leases" in out


def test_doctor_warns_prolonged_suspect(pkg, monkeypatch):
    fleetz = {
        "nodes": {"node-y": {"state": "stale", "missed_ticks": 3}},
        "node_health": {
            "enabled": True,
            "nodes": {"node-y": {
                "state": "suspect", "reason": "scrape-silence",
                "missed_ticks": 3,
                "since_unix": time.time() - 300}}},
    }
    rc, out = stubbed(monkeypatch, _health(
        fleetz, {"queue": {"depth": {}}, "leases": {"leases": []}}),
        pkg, "doctor")
    assert rc == 1
    assert "suspect > 120s" in out


# -- the HA plane (tests/test_ha.py:351, 465, 483, 502, 597, 642) --------------

def test_cli_fleet_renders_master_roles_and_store_lag(pkg, tmp_path):
    """`fleet` shows the answering replica's role per shard and its store
    lag, against each package's own two masters."""
    stack = pkg.mod("testing.sim").MultiMasterStack(pkg.rig(tmp_path),
                                                    masters=2, shards=2)
    try:
        stack.wait_converged()
        leader = stack.leader_for("default")
        shard = stack.ring.shard_of("default")
        rc, out = run_cli(pkg, stack.bases[leader], "fleet")
        assert rc == 0, out
        assert f"master master-{leader}:" in out
        assert f"{shard}:LEADER" in out
        assert "store lag 0s" in out
        follower = [i for i in stack.live() if i != leader][0]
        _, out = run_cli(pkg, stack.bases[follower], "fleet")
        assert f"master master-{follower}:" in out
        assert "LEADER" in out or "follower(" in out
    finally:
        stack.close()


def _ha(masters, metrics=None):
    return _routes({"/healthz": OK,
                    "/fleetz": {"nodes": {}, "masters": masters}},
                   metrics=metrics)


def _one_shard(fence=1, lag=0.0, dirty=0):
    return {"enabled": True, "replica": "master-0", "shards": 1,
            "election": {"enabled": True, "shards": {
                "0": {"holder": "master-0", "fence": fence,
                      "expires_in_s": 5.0, "leader": True}}},
            "store": {"lag_s": lag, "dirty": dirty, "torn_records": 0}}


def test_doctor_crits_on_leaderless_shard(pkg, monkeypatch):
    rc, out = stubbed(monkeypatch, _ha({
        "enabled": True, "replica": "master-0", "shards": 2,
        "election": {"enabled": True, "shards": {
            "0": {"holder": "master-0", "fence": 3, "expires_in_s": 4.0,
                  "leader": True},
            "1": {"holder": "master-dead", "fence": 2,
                  "expires_in_s": -7.0, "leader": False}}},
        "store": {"lag_s": 0.0, "dirty": 0, "torn_records": 0}}),
        pkg, "doctor")
    assert rc == CLIS[pkg.name].EXIT_DOCTOR_CRIT, out
    assert "shard(s) 1 have NO live leader" in out


def test_doctor_healthy_ha_and_store_lag_warn(pkg, monkeypatch):
    rc, out = stubbed(monkeypatch, _ha(_one_shard()), pkg, "doctor")
    assert rc == 0, out
    assert "every shard has a live leader" in out
    rc, out = stubbed(monkeypatch, _ha(_one_shard(lag=12.5, dirty=3)), pkg,
                      "doctor")
    assert rc == 1, out
    assert "intent store lagging 12.5s" in out


_TRANSITIONS = "tpumounter_election_transitions_total"


def test_doctor_warns_on_leadership_flapping_in_window(pkg, monkeypatch):
    first = (f'{_TRANSITIONS}{{shard="0",outcome="acquired"}} 2\n'
             f'{_TRANSITIONS}{{shard="0",outcome="lost"}} 2\n')
    second = (f'{_TRANSITIONS}{{shard="0",outcome="acquired"}} 4\n'
              f'{_TRANSITIONS}{{shard="0",outcome="lost"}} 4\n')
    rc, out = stubbed(monkeypatch, _ha(_one_shard(fence=9), [first, second]),
                      pkg, "doctor", "--window", "5")
    assert rc == 1, out
    assert "leadership flapping on shard(s) 0" in out
    assert f"(> {CLIS[pkg.name].FLAP_WARN} transitions" in out
    rc, out = stubbed(monkeypatch, _ha(_one_shard(fence=9), [first]), pkg,
                      "doctor")
    assert rc == 0, out
    assert "leadership transitions: 4 — lifetime" in out


def test_doctor_clean_multishard_failover_is_not_flapping(pkg, monkeypatch):
    masters = {
        "enabled": True, "replica": "master-1", "shards": 4,
        "election": {"enabled": True, "shards": {
            str(s): {"holder": "master-1", "fence": 2,
                     "expires_in_s": 5.0, "leader": True}
            for s in range(4)}},
        "store": {"lag_s": 0.0, "dirty": 0, "torn_records": 0}}
    first = "".join(f'{_TRANSITIONS}{{shard="{s}",outcome="acquired"}} 0\n'
                    for s in range(4))
    second = "".join(f'{_TRANSITIONS}{{shard="{s}",outcome="acquired"}} 1\n'
                     for s in range(4))
    rc, out = stubbed(monkeypatch, _ha(masters, [first, second]), pkg,
                      "doctor", "--window", "5")
    assert rc == 0, out
    assert "flapping" not in out
    assert "leadership transitions: 4" in out


def test_cli_fleet_renders_store_only_masters_section(pkg, monkeypatch):
    _, out = stubbed(monkeypatch, _ha({
        "enabled": True, "replica": "m-solo", "shards": 1,
        "election": {"enabled": False, "shards": 1},
        "store": {"lag_s": 2.5, "dirty": 1, "torn_records": 0}}),
        pkg, "fleet")
    assert "master m-solo:" in out
    assert "store lag 2.5s (1 dirty)" in out


# -- SLO burn and fleet staleness (tests/test_slo.py:211-265) ------------------

def _slo(metrics, fleetz=None):
    routes = {"/healthz": OK}
    if fleetz is not None:
        routes["/fleetz"] = fleetz
    return _routes(routes, metrics=metrics)


def _burn(slo, tenant, window, value):
    return (f'tpumounter_slo_burn_rate{{slo="{slo}",tenant="{tenant}",'
            f'window="{window}"}} {value}')


def test_doctor_crits_on_fast_burn(pkg, monkeypatch):
    metrics = "\n".join([_burn("attach_success", "teamA", "5m", 20.5),
                         _burn("attach_success", "teamA", "1h", 8.0)])
    rc, out = stubbed(monkeypatch, _slo([metrics]), pkg, "doctor")
    assert rc == CLIS[pkg.name].EXIT_DOCTOR_CRIT, out
    assert "FAST SLO burn" in out
    assert "teamA/attach_success (20.5x)" in out


def test_doctor_warns_on_slow_burn_and_reports_top_otherwise(pkg,
                                                             monkeypatch):
    slow = "\n".join([_burn("queue_wait", "teamB", "5m", 2.0),
                      _burn("queue_wait", "teamB", "1h", 7.5)])
    rc, out = stubbed(monkeypatch, _slo([slow]), pkg, "doctor")
    assert rc == 1, out
    assert "slow SLO burn" in out and "teamB/queue_wait" in out
    calm = _burn("attach_success", "teamB", "5m", 0.4)
    rc, out = stubbed(monkeypatch, _slo([calm]), pkg, "doctor")
    assert rc == 0, out
    assert "SLO burn nominal" in out and "tenant teamB" in out


def test_doctor_warns_on_stale_fleet_nodes(pkg, monkeypatch):
    fleetz = {"nodes": {"node-a": {"state": "fresh", "missed_ticks": 0},
                        "node-b": {"state": "stale", "missed_ticks": 3}},
              "stale_ticks_warn": 2}
    rc, out = stubbed(monkeypatch, _slo([""], fleetz), pkg, "doctor")
    assert rc == 1, out
    assert "1/2 worker(s) stale" in out and "node-b" in out
    fleetz["nodes"]["node-b"] = {"state": "fresh", "missed_ticks": 0}
    rc, out = stubbed(monkeypatch, _slo([""], fleetz), pkg, "doctor")
    assert rc == 0, out
    assert "all 2 worker(s) fresh" in out


def test_doctor_reports_windowed_flight_dumps(pkg, monkeypatch):
    rc, out = stubbed(monkeypatch, _slo([
        'tpumounter_flight_dumps_total{trigger="fast_burn"} 3\n',
        'tpumounter_flight_dumps_total{trigger="fast_burn"} 4\n']),
        pkg, "doctor", "--window", "5")
    assert rc == 1, out
    assert "flight-recorder bundles: 1" in out
    assert "tpumounterctl flight list" in out


# -- flight bundles (tests/test_flight.py:93) ----------------------------------

class _Clock:
    def __call__(self):
        return 0.0


def test_list_bundles_newest_first_and_flight_cli(pkg, tmp_path):
    """Each CLI reads its own package's recorder: the same bundles, the
    same listing and the same clean miss."""
    flight = importlib.import_module(f"{pkg.root}.utils.flight")
    recorder = flight.FlightRecorder(
        str(tmp_path), min_interval_s=0.0, settle_s=0.0, clock=_Clock())
    first = recorder.note("circuit_open", target="a")
    second = recorder.note("journal_backlog", rid="rX")
    cli = CLIS[pkg.name]
    rc, out = output(pkg, "http://unused", "flight", "list", "--dir",
                     str(tmp_path))
    assert rc == 0
    assert out.index(second) < out.index(first)
    rc, out = output(pkg, "http://unused", "flight", "show", second,
                     "--dir", str(tmp_path))
    assert rc == 0
    assert "trigger=journal_backlog" in out and "rid=rX" in out
    assert cli.main(["flight", "show", "nope",
                     "--dir", str(tmp_path)]) == cli.EXIT_OTHER


# -- the trace waterfall (tests/test_tracez.py:103, 154) -----------------------

@pytest.fixture
def live_stack(pkg, tmp_path):
    stack = pkg.mod("testing.sim").LiveStack(
        pkg.rig(tmp_path, use_kubelet_socket=True))
    yield stack
    stack.close()


def _attach(pkg, base, rid):
    rc, out = run_cli(pkg, base, "--json", "add", "workload",
                      FLAG[pkg.name], "2", "--request-id", rid)
    assert rc == 0, out


def test_cli_trace_renders_stitched_waterfall(pkg, live_stack):
    base = live_stack.base
    rid = "e2e-cli-" + uuid.uuid4().hex[:8]
    _attach(pkg, base, rid)
    rc, out = output(pkg, base, "trace", rid)
    assert rc == 0, out
    assert f"trace {rid} op=addtpu result=SUCCESS" in out
    for name in ("resolve", "rpc", "worker:attach", "allocate", "actuate"):
        assert name in out, name
    assert "|" in out and "#" in out
    rc, out = run_cli(pkg, base, "trace", "nope-" + rid)
    assert rc == CLIS[pkg.name].EXIT_OTHER
    assert "no stored trace" in out


def test_cli_trace_degrades_when_worker_health_port_unreachable(
        pkg, live_stack):
    base = live_stack.base
    rid = "e2e-degraded-" + uuid.uuid4().hex[:8]
    _attach(pkg, base, rid)
    live_stack.health_server.shutdown()
    rc, out = output(pkg, base, "trace", rid)
    assert rc == 0, out
    assert f"trace {rid} op=addtpu result=SUCCESS" in out
    assert "resolve" in out and "rpc" in out
    assert "worker spans unavailable" in out
    assert "worker spans incomplete" in out


# -- the stuck re-federation barrier (tests/test_federation.py:195) ------------

def _post(url, obj):
    req = urllib.request.Request(url, data=json.dumps(obj).encode(),
                                 method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_stuck_barrier_surfaces_in_slicez_doctor_and_cli(pkg, tmp_path):
    config = pkg.mod("master.admission").BrokerConfig(
        resize_barrier_timeout_s=0.05)
    stack = pkg.mod("testing.sim").MultiNodeStack(
        [pkg.host(tmp_path / f"host{i}") for i in range(2)], n_chips=2,
        broker_config=config)
    try:
        rc, out = run_cli(pkg, stack.base, "--json", "slice", "add",
                          "-p", "default/workload-0", "-p",
                          "default/workload-1", "--" + pkg.dev
                          + "s-per-host", "2")
        assert rc == 0, out
        group = json.loads(out)["group"]
        status, _ = _post(f"{stack.base}/slice/barrier",
                          {"group": group, "generation": 1,
                           "member": "default/workload-0",
                           "address": "127.0.0.1:1"})
        assert status == 200
        time.sleep(0.1)
        rc, out = run_cli(pkg, stack.base, "doctor")
        assert rc == 1, out
        assert "barrier" in out and "default/workload-1" in out
        rc, out = run_cli(pkg, stack.base, "slice", "status")
        assert rc == 1
        assert "STUCK" in out and "default/workload-1" in out
    finally:
        stack.close()


# -- the device gate (tests/test_gate.py:421, 450) -----------------------------

@pytest.fixture
def gated_rig(pkg, tmp_path):
    rig = pkg.rig(tmp_path, n_chips=4, gate="fake")
    yield rig
    rig.close()


def _gate_attach(pkg, rig):
    out = pkg.add(rig.service, rig.pod_name, "default", 1, False,
                  request_id="r1")
    assert out.result.name == "SUCCESS", out.message


def _gate_key(rig):
    (key,) = rig.gate_backend.keys()
    return key


def test_gatez_endpoint_and_cli(pkg, gated_rig):
    start = pkg.mod("worker.main").start_health_server
    _gate_attach(pkg, gated_rig)
    key = _gate_key(gated_rig)
    pkg.remove(gated_rig.service, gated_rig.pod_name, "default", [], False,
               cause="lease-expired:t")
    device = pkg.mod("device.fake").make_chips(1)[0]
    assert not gated_rig.gate.try_open(key, device.major, device.minor)
    server = start(0, gate=gated_rig.gate, ready=True)
    try:
        base = f"http://127.0.0.1:{server.server_port}"
        with urllib.request.urlopen(f"{base}/gatez", timeout=5) as resp:
            payload = json.loads(resp.read())
        assert payload["enabled"] and payload["backend"] == "fake"
        assert payload["denials"]["total"] == 1
        assert payload["denials"]["recent"][-1]["reason"] == \
            "revoked:lease-expired"
        rc, out = run_cli(pkg, base, "gatez")
        assert rc != 0
        assert "revoked:lease-expired" in out
        rc, _ = run_cli(pkg, base, "gatez", "--json")
        assert rc != 0
    finally:
        server.shutdown()


def test_doctor_crits_on_gate_drift(pkg, gated_rig):
    start = pkg.mod("worker.main").start_health_server
    _gate_attach(pkg, gated_rig)
    server = start(0, gate=gated_rig.gate, ready=True)
    try:
        base = f"http://127.0.0.1:{server.server_port}"
        _, out = run_cli(pkg, base, "doctor")
        assert "device gate healthy" in out
        gated_rig.sim.kube.delete_pod("default", gated_rig.pod_name)
        pkg.mod("worker.reconciler").OrphanReconciler(
            gated_rig.sim.kube, gated_rig.sim.settings,
            gate=gated_rig.gate).scan_once()
        rc, out = output(pkg, base, "doctor")
        assert rc == CLIS[pkg.name].EXIT_DOCTOR_CRIT == 12
        assert "device gate drift" in out
        assert "granted chips with no live owner" in out
    finally:
        server.shutdown()


# -- the port's own views ------------------------------------------------------

def test_utilz_shows_the_duty_source_and_an_unobserved_gpu(monkeypatch):
    """utilz names where each GPU's duty came from, and shows a GPU with
    no duty reading as unobserved, never as 0%."""
    utilz = {"enabled": True, "node": "node-a", "interval_s": 5.0,
             "window_samples": 3, "opens": {"attributed": 1},
             "chips": [
                 {"chip": "GPU-a", "device_path": "/dev/nvidia0",
                  "duty": 0.97, "duty_source": "nvml", "avg_duty": 0.5,
                  "busy": True, "opens": 1, "owner": "default/w",
                  "slave_pod": "w-slave-pod-1"},
                 {"chip": "GPU-b", "device_path": "/dev/nvidia1",
                  "duty": None, "busy": False, "opens": 0}],
             "owners": {"default/w": {"chips": 1, "busy_chips": 1,
                                      "avg_duty": 0.5}}}
    monkeypatch.setattr(TORCH_CLI, "_fetch_text",
                        lambda master, path, timeout: json.dumps(utilz))
    rc, out = run_cli(TORCH, "http://unused", "utilz")
    assert rc == 0, out
    assert "GPU GPU-a  /dev/nvidia0  duty 97% (avg 50%) from nvml" in out
    assert "GPU GPU-b  /dev/nvidia1  duty unobserved" in out
    assert "0%" not in out.splitlines()[2]


def test_topo_draws_one_row_per_gpu_node_and_lists_uuids(pkg, tmp_path):
    """On a port fleet every node's mesh is [1, N]: topo draws one row per
    node and lists each GPU's UUID. Both packages' fleets exit 0 with
    nothing stranded and report the same occupancy."""
    kwargs = {"accelerator": None} if pkg is TORCH else {}
    stack = pkg.mod("testing.sim").MultiNodeStack(
        [pkg.host(tmp_path / f"host{i}") for i in range(2)], n_chips=2,
        health=True, topo=True, **kwargs)
    try:
        stack.add_workload(0, "one")
        rc, out = run_cli(pkg, stack.base, "add", "one", FLAG[pkg.name],
                          "1")
        assert rc == 0, out
        stack.gateway.fleet.tick()
        rc, out = run_cli(pkg, stack.base, "topo")
        assert rc == 0, out
        assert "node-0: 1 free / 1 leased on" in out
        assert "node-1: 2 free / 0 leased on" in out
        if pkg is TORCH:
            assert "1x2, 2 GPU(s) per node" in out
            rows = [line for line in out.splitlines()
                    if line.startswith("    ")
                    and not line.startswith("      ")]
            assert rows == ["    A .", "    . ."]
            assert f"[0, 0]  {TORCH.uuid(0)}  /dev/nvidia0  leased  " \
                   "default/one" in out
    finally:
        stack.close()
