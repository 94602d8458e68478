"""The slice subsystem through both packages: the same scenarios, with the
same hosts and bodies, through the JAX package's ``MultiNodeStack`` and
the port's, compared after the rename map (routes ``/add{tpu,gpu}slice``,
the body's ``{tpus,gpus}PerHost``, result names by role). Compared: HTTP
statuses, result strings, lease groups (membership and size),
generations, the mesh-generation annotations and the barrier payload's
keys. Each scenario ends on its package's ``assert_slice_invariants``.

Both packages run under ``TPU_NODE_HEALTH=0`` and ``TPU_TOPOLOGY=0`` (the
port runs no topology plane; slice self-healing is compared in
tests/test_torch_node_chaos.py); the control plane's nodes carry no
labels, the port's are GKE GPU nodes whose allocatable count equals the
slice's per-host count."""

import threading
import time
import urllib.request

import pytest

from tests.torch_control_plane import BOTH, norm_result
from tests.torch_slices import get, post


@pytest.fixture(autouse=True)
def planes_off(monkeypatch):
    monkeypatch.setenv("TPU_NODE_HEALTH", "0")
    monkeypatch.setenv("TPU_TOPOLOGY", "0")


class _Run:
    """One package's stack and its spelling of the slice surface."""

    def __init__(self, pkg, tmp_path, hosts, n_chips, broker_config=None):
        self.pkg = pkg
        self.dev = pkg.dev
        root = tmp_path / pkg.name
        config = (pkg.mod("master.admission").BrokerConfig(**broker_config)
                  if broker_config is not None else None)
        self.stack = pkg.mod("testing.sim").MultiNodeStack(
            [pkg.host(root / f"node{i}") for i in range(hosts)],
            n_chips=n_chips, broker_config=config)
        self.base = self.stack.base
        self.broker = self.stack.gateway.broker

    def body(self, members, per_host, **extra):
        out = {"pods": [{"namespace": "default", "pod": f"workload-{i}"}
                        for i in members], f"{self.dev}sPerHost": per_host}
        out.update(extra)
        return out

    def add(self, body):
        return post(f"{self.base}/add{self.dev}slice", body)

    def remove(self, body):
        return post(f"{self.base}/remove{self.dev}slice", body)

    def resize(self, body):
        return post(f"{self.base}/slice/resize", body)

    def block(self, i, n, name="blocker"):
        self.stack.add_workload(i, name)
        with urllib.request.urlopen(
                f"{self.base}/add{self.dev}/namespace/default/pod/{name}"
                f"/{self.dev}/{n}/isEntireMount/true") as resp:
            assert resp.status == 200

    def unblock(self, name="blocker"):
        status, _ = post(f"{self.base}/remove{self.dev}/namespace/default"
                         f"/pod/{name}/force/false", {})
        assert status == 200

    def busy(self, i, on=True):
        """Hold (or release) every device of node ``i`` open from its
        workload's container."""
        rig = self.stack.rigs[i]
        for device in rig.sim.enumerator.enumerate():
            rig.sim.enumerator.busy_pids[device.device_path] = \
                [rig.pid] if on else []

    def groups(self):
        return {g: sorted(le.pod for le in members)
                for g, members in self.broker.leases.groups().items()}

    def annotations(self, n):
        key = self.pkg.consts.MESH_GENERATION_ANNOTATION
        return [(self.stack.master_kube.get_pod("default", f"workload-{i}")
                 ["metadata"].get("annotations") or {}).get(key)
                for i in range(n)]

    def invariants(self):
        self.pkg.mod("testing.chaos").assert_slice_invariants(
            self.broker, [r.sim for r in self.stack.rigs],
            kube=self.stack.master_kube)

    def close(self):
        self.stack.close()


def _results(payload):
    return {p["pod"]: norm_result(p["result"])
            for p in payload.get("pods", [])}


def _sized(payload):
    """Per-pod results with the number of devices each got."""
    return {p["pod"]: (norm_result(p["result"]),
                       len(p.get("device_ids", [])))
            for p in payload.get("pods", [])}


def _attach(run):
    status, body = run.add(run.body(range(2), 4))
    group = body.get("group")
    _, slicez = get(f"{run.base}/slicez")
    view = slicez["groups"][group]
    bstatus, barrier = get(f"{run.base}/slice/barrier?group={group}")
    return {
        "status": status, "result": body["result"],
        "rolled_back": body["rolled_back"], "pods": _sized(body),
        "groups": sorted(run.groups().values()),
        "group_is_lease_group": list(run.groups()) == [group],
        "generation": view["generation"], "chips": view["chips"],
        "members": [(m["pod"], m["chips"]) for m in view["members"]],
        "barrier_status": bstatus,
        "barrier_keys": sorted(barrier),
        "barrier": {k: barrier[k] for k in ("generation", "expected",
                                            "members", "joined",
                                            "complete", "missing")},
        "slicez_keys": sorted(slicez), "txns": slicez["txns"]["pending"],
    }


def _busy_detach(run):
    out = {"attach": run.add(run.body(range(2), 4))[0]}
    run.busy(0)
    status, body = run.remove(run.body(range(2), 4))
    out["busy"] = (status, body["result"], _results(body))
    out["groups_after_busy"] = sorted(run.groups().values())
    run.busy(0, on=False)
    status, body = run.remove(run.body(range(2), 4))
    out["retry"] = (status, body["result"], _results(body))
    status, body = run.remove(run.body(range(2), 4))
    out["repeat"] = (status, body["result"], _results(body))
    out["groups"] = run.groups()
    return out


def _rollback(run):
    run.block(1, 4)
    status, body = run.add(run.body(range(2), 4))
    return {"status": status, "result": body["result"],
            "rolled_back": body["rolled_back"], "pods": _sized(body),
            "slaves": [len(r.sim.slave_pods()) for r in run.stack.rigs],
            "groups": run.groups()}


def _resize(run):
    status, body = run.add(run.body(range(2), 2))
    out = {"attach": (status, body["result"])}
    group = body["group"]
    for step, members in (("grow", range(4)), ("shrink", range(2))):
        status, body = run.resize(run.body(members, 2))
        _, barrier = get(f"{run.base}/slice/barrier?group={group}")
        _, slicez = get(f"{run.base}/slicez")
        out[step] = {
            "status": status, "result": body["result"],
            "same_group": body["group"] == group,
            "generation": body["generation"], "hosts": body["hosts"],
            "added": sorted(_results({"pods": body["added"]}).items()),
            "removed": sorted(_results({"pods": body["removed"]}).items()),
            "slicez_generation": slicez["groups"][group]["generation"],
            "chips": slicez["groups"][group]["chips"],
            "members": sorted(run.groups()[group]),
            "annotations": run.annotations(4),
            "barrier_keys": sorted(barrier),
            "barrier": (barrier["generation"], barrier["members"],
                        barrier["complete"]),
        }
    status, body = run.resize(run.body(range(2), 2))
    out["noop"] = (status, body["generation"], body.get("unchanged"))
    return out


def _gang(run):
    run.block(1, 4)
    box = {}
    thread = threading.Thread(
        target=lambda: box.update(r=run.add(run.body(range(2), 4))))
    thread.start()
    deadline = time.monotonic() + 10
    parked = 0
    while time.monotonic() < deadline:
        with run.broker._lock:
            parked = sum(1 for w in run.broker._waiters if w.gang)
        if parked and run.stack.rigs[0].sim.slave_pods():
            break
        time.sleep(0.02)
    _, slicez = get(f"{run.base}/slicez")
    out = {"parked": parked, "gang_queue_depth": slicez["gang_queue_depth"],
           "in_flight": [t["state"] for t in slicez["txns"]["in_flight"]],
           "reserved": len(run.stack.rigs[0].sim.slave_pods())}
    run.unblock()
    thread.join(timeout=20)
    assert not thread.is_alive()
    status, body = box["r"]
    out.update(status=status, result=body["result"],
               queued=body.get("queued_s", 0) > 0, pods=_sized(body),
               groups=sorted(run.groups().values()))
    return out


SCENARIOS = {
    "attach": (_attach, 2, 4, None),
    "busy_detach": (_busy_detach, 2, 4, None),
    "rollback": (_rollback, 2, 4, None),
    "resize_2_4_2": (_resize, 4, 2, None),
    "gang": (_gang, 2, 4, {"queue_timeout_s": 8.0, "gang_hold_s": 5.0,
                           "tick_interval_s": 0.1}),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_slice_scenario_matches_the_control_plane(tmp_path, name):
    scenario, hosts, n_chips, config = SCENARIOS[name]
    seen = {}
    for pkg in BOTH:
        run = _Run(pkg, tmp_path, hosts, n_chips, config)
        try:
            seen[pkg.name] = scenario(run)
            run.invariants()
        finally:
            run.close()
    assert seen["torch"] == seen["jax"]
    assert seen["torch"]       # the scenario observed something
