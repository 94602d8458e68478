"""A member host of a live slice dies, with one real host among four.

:func:`run_node_failure` puts :mod:`.slice_attach`'s four one-GPU GKE hosts
(an ``a3-highgpu-1g`` node pool) behind one master with node health on:

- host 0 is :mod:`.worker_attach`'s ``_Stack`` around whatever enumerator
  the caller passes (on a card machine, the real ``/dev`` and NVML); it
  holds ``spare-0``, a pod labelled ``tpumounter.io/slice-spare=true``;
- hosts 1-3 are :class:`~.sim.WorkerRig` s over fixture GPU nodes (the
  fake device gate, a ``DrainController``), each with a live gRPC worker;
- every host serves its worker's health sidecar, which the master's fleet
  loop scrapes once a second (a fleet interval of 1 s, as
  ``TPU_FLEET_INTERVAL_S=1`` sets it); the master is built as
  ``master/main.py`` builds it, with the node-health defaults
  (suspect after 2 missed scrapes, dead after 5, healthy again after 2
  clean ones). The fixture hosts keep their slave pods in clusters of
  their own, so the broker's fence cleanup is bridged to them, as
  ``MultiNodeStack`` does.

It then drives, over HTTP: ``/addgpuslice`` over the pods of hosts 1-3
and the generation-1 barrier; the death of host 2 (its Node set
``Ready=False`` on the facade, its gRPC server and sidecar stopped),
timed to ``suspect`` and to ``dead``, with a plain ``/addgpu`` to host 2
answered 503 ``NodeCordoned`` while it is cordoned; the fence of host 2's
lease (its slave pod deleted, ``tpumounter_lease_fences_total`` moved);
the group re-formed on hosts 1, 3 and the spare on host 0 at generation 2
in ``/slicez``, the barrier, ``MasterSliceSignal`` and the members'
annotations, with the facade requests of the repair; the in-pod proof on
host 0's GPU; a drain on host 3 (``/healthz`` answering ``draining``,
cordoned within one fleet tick, its migration deferred for want of a
spare and the group left whole); host 2's restart (the journal replay
converging on the fenced state, no grant resurrected, healthy again only
after the recover ticks); the invariant suites and the agent's
fallbacks. Every check is reported by name; the caller decides what
failing means.
"""

from __future__ import annotations

import copy
import json
import shutil
import subprocess
import time
from collections.abc import Callable

from gpumounter_tpu_torch.device.enumerator import Enumerator
from gpumounter_tpu_torch.device.model import GPUDevice
from gpumounter_tpu_torch.testing.ha_attach import _wait
from gpumounter_tpu_torch.testing.master_attach import _http
from gpumounter_tpu_torch.testing.slice_attach import (HOSTS, OneGPU,
                                                       _join_all,
                                                       _SliceStack)
from gpumounter_tpu_torch.testing.worker_attach import (IDLE, NODE, _delta,
                                                        _target_pod, spawn)
from gpumounter_tpu_torch.utils import consts

FLEET_INTERVAL_S = 1.0
KILLED = 2          # the member host that dies
DRAINED = 3         # the member host that drains
SPARE = "spare-0"   # the spare pod on host 0
BUDGET_S = 60.0
# Deadline of each wait on a state or a record.
WAIT_S = 20.0


def _event_ts(events, seq0: int, kind: str, **attrs) -> float | None:
    """Wall time of the first event of ``kind`` after ``seq0`` whose
    fields match ``attrs``: the transitions' own timestamps, so a timing
    does not depend on how often the rig polls."""
    for e in events.tail(500):
        if e["seq"] > seq0 and e["kind"] == kind and all(
                e.get(k, e.get("attrs", {}).get(k)) == v
                for k, v in attrs.items()):
            return e["ts"]
    return None


def _body(pods) -> bytes:
    return json.dumps({"pods": [{"namespace": "default", "pod": p}
                                for p in pods], "gpusPerHost": 1}).encode()


def _joined(base: str, group: str, generation: int, members) -> bool:
    """Every member joins the barrier and all read one plan over exactly
    ``members``."""
    joined = _join_all(base, group, generation, members)
    plans = list(joined["plans"].values())
    return (len(plans) == len(members) and not joined["errors"]
            and not joined["alive"] and all(p == plans[0] for p in plans)
            and plans[0].get("members") == list(members)
            and plans[0].get("num_processes") == len(members))


class _FailureStack(_SliceStack):
    """The slice rig with health sidecars, a spare pod on host 0 and the
    split clusters bridged for fencing."""

    def __init__(self, root: str, enumerator: Enumerator):
        super().__init__(root, enumerator, health=True)
        self.gateway.fleet.tick_interval_s = FLEET_INTERVAL_S
        self.gateway.broker.fence_cleanup = self._fence_cleanup

    def put_ready(self, i: int, ready: bool) -> None:
        """Host ``i``'s Node on the facade with its Ready condition."""
        node = copy.deepcopy(self.worker.kube.get_node(self.nodes[i]))
        node.setdefault("status", {})["conditions"] = [
            {"type": "Ready", "status": "True" if ready else "False"}]
        self.worker.kube.put_node(node)

    def slave_pods(self, i: int) -> list:
        return (self.worker.slave_pods() if i == 0
                else self.rigs[i - 1].sim.slave_pods())

    def _fence_cleanup(self, namespace: str, pod: str) -> None:
        from gpumounter_tpu_torch.testing.sim import delete_slave_pods
        delete_slave_pods(
            [(self.worker.kube, self.worker.settings.pool_namespace)]
            + [(rig.sim.kube, rig.sim.settings.pool_namespace)
               for rig in self.rigs], namespace, pod)

    def restart_host(self, i: int) -> dict:
        """A fresh worker process over fixture host ``i``'s state
        (``WorkerRig.restart_worker``), then fresh servers announced to
        the master (the scrape breaker of the dead incarnation dropped,
        as ``MultiNodeStack.restart_node`` does)."""
        outcomes = self.rigs[i - 1].restart_worker()
        self.start_host(i)
        self.gateway.directory.invalidate(self.nodes[i])
        self.gateway.directory._refresh()
        with self.gateway.fleet._lock:
            self.gateway.fleet._breakers.pop(self.nodes[i], None)
        return outcomes


def run_node_failure(root: str, enumerator: Enumerator,
                     spawn_proof: Callable[[GPUDevice], subprocess.Popen]
                     ) -> dict:
    """Drive the node failure domain over HTTP under ``root`` (removed
    first and afterwards), with host 0 on the first GPU ``enumerator``
    names. ``spawn_proof(gpu)`` starts the in-pod proof on host 0's GPU:
    a process that prints one JSON line (its ``ok``, ``launches`` and
    ``device_count``) and exits when its stdin closes. Returns the report
    with its ``checks`` and timings."""
    from gpumounter_tpu_torch.actuation.agent import _fallback_total
    from gpumounter_tpu_torch.testing.chaos import (
        assert_broker_invariants, assert_node_death_invariants,
        assert_slice_invariants)
    from gpumounter_tpu_torch.torchcheck.elastic import MasterSliceSignal
    from gpumounter_tpu_torch.utils.events import EVENTS
    from gpumounter_tpu_torch.utils.metrics import REGISTRY

    shutil.rmtree(root, ignore_errors=True)
    t_start = time.perf_counter()
    procs: list[subprocess.Popen] = []
    checks: dict[str, bool] = {}
    report: dict = {}
    timings: dict[str, float] = {}
    stack = None
    fallbacks_before = _fallback_total()
    try:
        enumerator = OneGPU(enumerator)
        stack = _FailureStack(root, enumerator)
        worker = stack.worker
        gateway = stack.gateway
        tracker = gateway.nodehealth
        checks["node_health_on"] = tracker is not None
        gpus = enumerator.enumerate()
        checks["node_has_a_gpu"] = bool(gpus)
        if tracker is None or not gpus:
            return report
        idle = spawn(IDLE)
        procs.append(idle)
        box = worker.node.container(SPARE, [idle.pid])
        spare = _target_pod(box)
        spare["metadata"]["labels"][consts.SLICE_SPARE_LABEL_KEY] = \
            consts.SLICE_SPARE_LABEL_VALUE
        worker.kube.put_pod(spare)
        stack.serve()
        members = [f"workload-{i}" for i in range(1, HOSTS)]
        killed, drained = stack.nodes[KILLED], stack.nodes[DRAINED]

        # 0. the fleet has seen every host alive
        checks["every_host_scraped_fresh"] = _wait(lambda: all(
            gateway.fleet.snapshot(events_limit=0)["nodes"].get(
                n, {}).get("state") == "fresh" for n in stack.nodes), WAIT_S)

        # 1. the slice over hosts 1-3 and its generation-1 barrier
        status, body = _http("POST", stack.base + "/addgpuslice",
                             _body(members))
        report["attach"] = body
        checks["addgpuslice_200_over_hosts_1_3"] = (
            status == 200 and body.get("result") == "SUCCESS"
            and [stack.slave_pods(i) != [] for i in range(HOSTS)]
            == [False, True, True, True])
        group = body.get("group") if isinstance(body, dict) else None
        if not group:
            return report
        report["group"] = group
        checks["generation_1_barrier_completes"] = _joined(
            stack.base, group, 1, [f"default/{p}" for p in members])

        # 2. host 2 dies: its Node NotReady, its servers gone
        # a member's fence is the repair's, under its reason
        fence_reason = "slice-repair:node-dead"
        fences_before = REGISTRY.lease_fences.value(reason=fence_reason)
        seq0 = EVENTS.tail(1)[-1]["seq"] if EVENTS.tail(1) else 0
        requests_before = worker.requests.snapshot()
        ticks_before = gateway.fleet.snapshot(events_limit=0)["ticks"]
        stack.put_ready(KILLED, False)
        t_kill = time.time()
        stack.stop_host(KILLED)

        # 3. suspect, the cordon, dead
        checks["suspect"] = _wait(lambda: tracker.state(killed)
                                  in ("suspect", "dead"), WAIT_S)
        status, cordon = _http(
            "GET", stack.base + f"/addgpu/namespace/default/pod/"
            f"workload-{KILLED}/gpu/1/isEntireMount/true")
        report["cordoned_attach"] = cordon
        checks["cordoned_attach_503_node_cordoned"] = (
            status == 503 and cordon.get("result") == "NodeCordoned"
            and cordon.get("node") == killed)
        checks["dead"] = _wait(lambda: tracker.state(killed) == "dead",
                               WAIT_S)
        report["ticks_kill_to_dead"] = (
            gateway.fleet.snapshot(events_limit=0)["ticks"] - ticks_before)
        report["dead_node"] = gateway.fleet.snapshot(events_limit=0)[
            "node_health"]["nodes"].get(killed)

        # 4. the dead host's lease is fenced
        broker = gateway.broker
        fenced = _wait(lambda: broker.leases.get(
            "default", f"workload-{KILLED}") is None
            and stack.slave_pods(KILLED) == [], WAIT_S)
        report["fences"] = (REGISTRY.lease_fences.value(reason=fence_reason)
                            - fences_before)
        checks["lease_fenced_slave_pod_deleted"] = (
            fenced and report["fences"] == 1
            and broker.fenced()[-1]["pod"] == f"workload-{KILLED}")

        # 5. the group re-forms on hosts 1, 3 and the spare
        repaired = _wait(lambda: gateway.slices.generation(group) == 2,
                         WAIT_S)
        gateway.slices.join_repairs()
        at = {"suspect": _event_ts(EVENTS, seq0, "node_suspect",
                                   node=killed),
              "dead": _event_ts(EVENTS, seq0, "node_dead", node=killed),
              "fenced": _event_ts(EVENTS, seq0, "lease_fenced",
                                  pod=f"workload-{KILLED}"),
              "repaired": _event_ts(EVENTS, seq0, "slice_repair",
                                    group=group, outcome="repaired")}
        if None not in at.values():
            timings.update(
                kill_to_suspect_s=at["suspect"] - t_kill,
                kill_to_dead_s=at["dead"] - t_kill,
                dead_to_fenced_s=at["fenced"] - at["dead"],
                dead_to_repaired_s=at["repaired"] - at["dead"])
        checks["transitions_evented"] = None not in at.values()
        report["repair_requests"] = _delta(requests_before,
                                           worker.requests.snapshot())
        target = ["workload-1", f"workload-{DRAINED}", SPARE]
        keys = [f"default/{p}" for p in target]
        view = _http("GET", stack.base + "/slicez")[1].get(
            "groups", {}).get(group, {})
        barrier = _http("GET", stack.base + "/slice/barrier?group="
                        + group)[1]
        signal = MasterSliceSignal(stack.base, group)
        annotations = [(stack.kube.get_pod("default", p)["metadata"]
                        .get("annotations") or {}).get(
                            consts.MESH_GENERATION_ANNOTATION)
                       for p in target]
        report["repaired_group"] = view
        report["repairs"] = [e["attrs"] for e in EVENTS.tail(300)
                             if e["seq"] > seq0
                             and e["kind"] == "slice_repair"]
        checks["group_repaired_generation_2"] = (
            repaired and view.get("generation") == 2
            and sorted((m["pod"], m["node"]) for m in view.get("members",
                                                               []))
            == sorted([("workload-1", stack.nodes[1]),
                       (f"workload-{DRAINED}", drained),
                       (SPARE, NODE)])
            and [r.get("outcome") for r in report["repairs"]]
            == ["repaired"])
        checks["barrier_signal_annotations_at_2"] = (
            barrier.get("generation") == 2
            and sorted(barrier.get("members", [])) == sorted(keys)
            and [signal.generation(), signal.chips()] == [2, 3]
            and annotations == ["2"] * 3)
        checks["generation_2_barrier_completes"] = _joined(
            stack.base, group, 2, barrier.get("members", keys))
        lease = broker.leases.get("default", SPARE)
        gpu = next((d for d in gpus if lease is not None
                    and sorted(lease.uuids) == [d.uuid]), None)
        checks["spare_holds_the_card"] = (
            gpu is not None and len(stack.slave_pods(0)) == 1)
        if gpu is None:
            return report

        # 6. the repaired member's in-pod proof on the card
        proof = spawn_proof(gpu)
        procs.append(proof)
        line = proof.stdout.readline()
        try:
            report["in_pod"] = json.loads(line)
        except ValueError:
            report["in_pod"] = {"ok": False, "output": line[-2000:]}
        in_pod = report["in_pod"]
        checks["in_pod_kernel_matches_plain"] = bool(in_pod.get("ok"))
        checks["in_pod_kernel_launched"] = in_pod.get("launches", 0) >= 1
        checks["in_pod_sees_one_gpu"] = in_pod.get("device_count") == 1
        proof.stdin.close()
        report["proof_rc"] = proof.wait(timeout=120)

        # 7. host 3 drains: cordoned within one tick, migration deferred
        rig3 = stack.rigs[DRAINED - 1]
        ticks0 = gateway.fleet.snapshot(events_limit=0)["ticks"]
        seq1 = EVENTS.tail(1)[-1]["seq"]
        rig3.drain.begin("maintenance")
        status, healthz = _http(
            "GET", f"http://127.0.0.1:{stack.sidecars[DRAINED].server_port}"
            "/healthz")
        checks["drained_healthz_answers_draining"] = (
            status == 200 and healthz == "draining")
        cordoned = _wait(lambda: tracker.state(drained) == "draining",
                         WAIT_S)
        report["drain_ticks"] = (gateway.fleet.snapshot(events_limit=0)[
            "ticks"] - ticks0)
        checks["drain_cordoned_within_one_tick"] = (
            cordoned and report["drain_ticks"] <= 2)
        deferred = _wait(lambda: any(
            e["kind"] == "slice_repair" and e["seq"] > seq1
            for e in EVENTS.tail(50)), WAIT_S)
        gateway.slices.join_repairs()
        outcomes = [e["attrs"] for e in EVENTS.tail(100)
                    if e["seq"] > seq1 and e["kind"] == "slice_repair"]
        report["drain_repairs"] = outcomes
        group_now = sorted(m.pod for m in broker.leases.groups().get(
            group, []))
        checks["drain_migration_deferred_no_teardown"] = (
            deferred and [(o.get("outcome"), o.get("deferred"))
                          for o in outcomes] == [("failed", True)]
            and group_now == sorted(target)
            and gateway.slices.generation(group) == 2
            and stack.slave_pods(DRAINED) != [])

        # 8. host 2 comes back: replay converges on the fenced state
        stack.put_ready(KILLED, True)
        ticks_restart = gateway.fleet.snapshot(events_limit=0)["ticks"]
        report["replay"] = stack.restart_host(KILLED)
        rig2 = stack.rigs[KILLED - 1]
        checks["restart_resurrects_no_grant"] = (
            rig2.gate.granted_uuids() == set()
            and stack.slave_pods(KILLED) == []
            and rig2.service.journal.backlog() == 0
            and broker.leases.get("default", f"workload-{KILLED}") is None)
        # a Node poll that read NotReady while the host was down holds
        # it suspect until the next poll, up to 15 s later
        healthy = _wait(lambda: tracker.state(killed) == "healthy",
                        2 * WAIT_S)
        report["recover_ticks"] = (gateway.fleet.snapshot(events_limit=0)[
            "ticks"] - ticks_restart)
        checks["healthy_after_the_recover_ticks"] = (
            healthy and report["recover_ticks"]
            >= consts.DEFAULT_NODE_RECOVER_TICKS)

        # 9. the invariant suites, then the slice detached
        try:
            assert_node_death_invariants(broker, tracker)
            assert_slice_invariants(broker, stack.sims(), kube=stack.kube,
                                    health=tracker)
            status, _ = _http("POST", stack.base + "/removegpuslice",
                              _body(target))
            assert status == 200, f"/removegpuslice answered {status}"
            assert_broker_invariants(broker, worker.sim, health=tracker)
            assert_slice_invariants(broker, stack.sims(), kube=stack.kube,
                                    health=tracker)
            checks["invariants_hold"] = True
        except AssertionError as e:
            report["invariants"] = str(e)[:2000]
            checks["invariants_hold"] = False
        checks["no_lease_left"] = broker.leases.leases() == []
        report["agent_fallbacks"] = _fallback_total() - fallbacks_before
        checks["agent_no_fallback"] = report["agent_fallbacks"] == 0
        report["card"] = {"uuid": gpu.uuid, "node": gpu.device_path}
        return report
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
            proc.wait(timeout=60)
        if stack is not None:
            stack.close()
        shutil.rmtree(root, ignore_errors=True)
        report["seconds"] = time.perf_counter() - t_start
        report["timings"] = timings
        checks[f"under_{int(BUDGET_S)}_s"] = report["seconds"] < BUDGET_S
        report["checks"] = checks
        report["ok"] = bool(checks) and all(checks.values())
