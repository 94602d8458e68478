"""Crash and replay of a worker that holds a GPU, over real sockets, on one
node: the chaos harness (:mod:`.chaos`) on a real device layer.

:func:`run_worker_chaos` wires the worker of :mod:`.worker_attach` (its
``_Stack``) around whatever enumerator the caller passes (a card machine's
real ``/dev`` and NVML, or fake GPUs on a CPU): the HTTP apiserver facade,
the scheduler with a real PodResources gRPC server, the resident agent over
the procroot actuator, the v1 device gate, the journal, and ``AddGPU`` /
``RemoveGPU`` over gRPC.

A crash is a worker process dying (``_Stack.stop_worker``) and a new one
booting (``_Stack.start_worker``). It rebuilds what a dead worker process
loses: the journal object, the ``DeviceGate``, the service and the gRPC
server with its client. The resident agent is on the process's side: it is
the worker's own thread, so it dies with it and a fresh one starts, with a
fresh actuator and mounter. What outlives the process stays: the cluster
(the facade and its ``FakeKubeClient``, the scheduler, the PodResources
server), the fixture cgroup with its v1 ``devices.*`` state, the
container's nodes and the journal file. The informer and the allocator
over them are kept too: they hold only the cluster's view.

The phase, in order:

1. ``pairs`` fault-free ``AddGPU`` + ``RemoveGPU`` pairs: the median the
   plans are held against;
2. each of :data:`~.chaos.CRASH_POINTS`: the attach dies there, the worker
   restarts, its replay completes the attach (the card's node in the
   container with the host node's ``st_rdev``, the gate granting exactly
   the card, one slave pod, no backlog, at most one ``GPUAttached``), and a
   ``RemoveGPU`` leaves the container no companion rule and no node. After
   the first replay the in-pod proof runs on the card the replay returned;
3. the owner's death after ``before_commit``: the replay reverts;
4. :data:`~.chaos.DETACH_CRASH_POINTS` on the v1 backend: the detach dies,
   the restart re-grants the card (the lease still stands), the retried
   detach revokes it;
5. :data:`PLANS` over the facade, one timed pair each: the faults are the
   facade's (a drop is a real socket close), the kubelet flap a real stop
   and restart of the PodResources server; then the in-pod proof again.

Every check is reported by name; the caller decides what failing means.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import threading
import time
import types
from collections.abc import Callable

from gpumounter_tpu_torch.device.enumerator import Enumerator
from gpumounter_tpu_torch.device.model import GPUDevice
from gpumounter_tpu_torch.testing import chaos
from gpumounter_tpu_torch.testing.worker_attach import (IDLE, _delta,
                                                        _host_majmin,
                                                        _Stack, _stats,
                                                        spawn)

PAIRS = 10
# The informer's watch requests end this often, so a plan's WATCH faults
# meet a fresh request within the phase.
WATCH_CHUNK_S = 0.5
# The transient plans of tests/test_chaos.py as the facade can make them
# real: (name, facade faults, kubelet flaps). A status-0 fault on an
# idempotent verb becomes a drop (the socket closes with no response);
# the facade cannot refuse a connection it accepted, so a create is
# throttled (429) instead; a kubelet flap is a real stop of the
# PodResources server during the attach, started again once the kubelet
# client has failed on it.
PLANS: tuple[tuple[str, list[dict], int], ...] = (
    ("throttled_create_with_retry_after",
     [dict(op="POST", resource="pods", status=429, retry_after_s=0.02,
           times=2)], 0),
    ("connection_drop_on_get",
     [dict(op="GET", resource="pods", drop=True, times=2)], 0),
    ("injected_latency_on_get",
     [dict(op="GET", resource="pods", latency_s=0.05, times=3)], 0),
    ("watch_hang",
     [dict(op="WATCH", resource="pods", latency_s=0.3, times=1)], 0),
    ("watch_midstream_death",
     [dict(op="WATCH", resource="pods", drop=True, times=2)], 0),
    ("kubelet_socket_flap", [], 2),
    ("event_post_500s",
     [dict(op="POST", resource="events", status=500, times=4)], 0),
    ("mixed_storm",
     [dict(op="POST", resource="pods", status=429, times=1),
      dict(op="GET", resource="pods", drop=True, times=1),
      dict(op="LIST", resource="pods", latency_s=0.02, times=2)], 1),
)
RETRY_TARGETS = ("apiserver", "kubelet", "watch")


class _Faults:
    """The facade's fault hook: it counts every request (the phase's
    request counter) and applies the current plan's injector."""

    def __init__(self, counter):
        self.counter = counter
        self.injector: chaos.FaultInjector | None = None

    def fire(self, verb: str, resource: str) -> None:
        self.counter.fire(verb, resource)
        injector = self.injector
        if injector is not None:
            injector.fire(verb, resource)


def _retries() -> dict[str, float]:
    from gpumounter_tpu_torch.utils.metrics import REGISTRY
    return {t: REGISTRY.retry_attempts.value(target=t)
            for t in RETRY_TARGETS}


def _rpc_error(call: Callable[[], object]) -> str | None:
    """The gRPC status name ``call`` failed with; None when it answered."""
    import grpc
    try:
        call()
    except grpc.RpcError as e:
        return e.code().name
    return None


def _flapping(stack: _Stack, call: Callable[[], object], flaps: int):
    """Run ``call`` through ``flaps`` kubelet restarts: the PodResources
    server stops, and starts again as soon as the kubelet client has
    failed once more (its retry counter moves; 5 s at most), ``flaps``
    times over. Returns ``call``'s answer (or the exception it raised)
    and the kubelet retries counted."""
    server = stack.sim.kubelet_server
    before = _retries()["kubelet"]
    out: dict = {}

    def run():
        try:
            out["answer"] = call()
        except Exception as e:                 # noqa: BLE001 — reported
            out["answer"] = e
    thread = threading.Thread(target=run, daemon=True)
    for flap in range(flaps):
        server.pause()
        if flap == 0:
            thread.start()
        deadline = time.monotonic() + 5.0
        while (thread.is_alive() and time.monotonic() < deadline
               and _retries()["kubelet"] < before + flap + 1):
            time.sleep(0.002)
        server.start()
    if not flaps:
        thread.start()
    thread.join(timeout=300)
    return out.get("answer"), _retries()["kubelet"] - before


def _proof(spawn_proof, gpu: GPUDevice, procs: list) -> dict:
    """The in-pod proof's report on ``gpu``: its child's one JSON line."""
    import json
    t0 = time.perf_counter()
    proof = spawn_proof(gpu)
    procs.append(proof)
    line = proof.stdout.readline()
    seconds = time.perf_counter() - t0
    try:
        report = json.loads(line)
    except ValueError:
        report = {"ok": False, "output": line[-2000:]}
    proof.stdin.close()
    report["rc"] = proof.wait(timeout=120)
    report["seconds_to_report"] = seconds
    return report


def run_worker_chaos(root: str, enumerator: Enumerator,
                     spawn_proof: Callable[[GPUDevice], subprocess.Popen],
                     pairs: int = PAIRS) -> dict:
    """Drive the phase under ``root`` (removed first and afterwards);
    ``spawn_proof(gpu)`` starts the in-pod proof, which prints one JSON
    line and holds the card until its stdin closes. Returns the report
    with its ``checks``."""
    from gpumounter_tpu_torch.actuation.agent import _fallback_total
    from gpumounter_tpu_torch.api import gpu_mount_pb2 as pb

    shutil.rmtree(root, ignore_errors=True)
    procs: list[subprocess.Popen] = []
    checks: dict[str, bool] = {}
    report: dict = {}
    stack = None
    fallbacks_before = _fallback_total()
    t_phase = time.perf_counter()
    ok_add, ok_remove = pb.AddGPUResponse.Success, pb.RemoveGPUResponse.Success
    try:
        stack = _Stack(root, enumerator, watch_chunk_s=WATCH_CHUNK_S)
        faults = _Faults(stack.requests)
        stack.facade.faults = faults
        gpus = [d for d in enumerator.enumerate() if d.uuid]
        checks["node_has_a_gpu"] = bool(gpus)
        idle, idle_b = spawn(IDLE), spawn(IDLE)
        procs += [idle, idle_b]
        box = stack.node.container("workload", [idle.pid],
                                   held=[("/dev/null", 1, 3)])
        pod = stack.add_target(box)
        key = stack.node.controller.container_dir(pod, box.container_id)
        attaches = 0        # logical attaches, each at most one GPUAttached
        steps: dict[str, float] = {}    # host seconds of each part
        report["steps_s"] = steps
        t_step = [time.perf_counter()]

        def step(name: str) -> None:
            now = time.perf_counter()
            steps[name] = now - t_step[0]
            t_step[0] = now

        def add(name="workload"):
            return stack.client.add_gpu(name, "default", 1)

        def remove(name="workload"):
            return stack.client.remove_gpu(name, "default")

        # 1. fault-free pairs: the plans' baseline
        times: dict[str, list[float]] = {"add_gpu": [], "remove_gpu": []}
        answers = []
        for _ in range(pairs):
            t0 = time.perf_counter()
            a = add()
            t1 = time.perf_counter()
            r = remove()
            t2 = time.perf_counter()
            answers.append((a, r))
            times["add_gpu"].append((t1 - t0) * 1e3)
            times["remove_gpu"].append((t2 - t1) * 1e3)
        attaches += pairs
        checks["fault_free_pairs"] = all(
            a.result == ok_add and r.result == ok_remove
            for a, r in answers)
        report["fault_free_ms"] = {k: _stats(v) for k, v in times.items()}
        step("fault_free")
        baseline_ms = report["fault_free_ms"]["add_gpu"]["median"]
        gpu = next((d for d in gpus
                    if list(answers[0][0].device_ids) == [d.uuid]), None)
        checks["device_ids_are_the_uuid"] = gpu is not None
        if gpu is None:
            report["device_ids"] = list(answers[0][0].device_ids)
            return report
        companions = {os.path.basename(c.host_path):
                      _host_majmin(c.host_path, c.major, c.minor)
                      for c in gpu.companions}
        own = _host_majmin(gpu.device_path, gpu.major, gpu.minor)
        granted = {own, *companions.values()}
        attached_nodes = {os.path.basename(gpu.device_path): own,
                          **companions, "null": (1, 3)}

        def gate_pairs() -> set:
            live, _opens, _denies = stack.gate.backend.read(key)
            return {(k[1], k[2]) for k in live}

        def invariants(uuids: set, max_attached: int) -> bool:
            rig = types.SimpleNamespace(
                sim=stack.sim, actuator=stack.mounter.actuator,
                host=stack.node.host, service=stack.service,
                gate=stack.gate)
            try:
                chaos.assert_invariants(rig, uuids,
                                        max_attached_events=max_attached,
                                        held={"/dev/null"})
            except AssertionError as e:
                report.setdefault("invariant_failures", []).append(
                    str(e)[:500])
                return False
            return True

        def reasons_since(n: int) -> list[str]:
            chaos.wait_events_drained(stack.service)
            return [e.get("reason") for e in stack.kube.events[n:]]

        def restart() -> dict:
            """The worker dies and a new one boots over the node: the
            replay's outcomes, the restart → replay-done time on the host
            clock (the boot's objects and the replay; ``boot_ms`` adds
            the gRPC server's start) and the facade requests of the
            recovery."""
            stack.stop_worker()
            before = stack.requests.snapshot()
            replay = stack.start_worker()
            return {"replay": replay,
                    "restart_to_replay_ms": stack.boot_ms["objects"]
                    + stack.boot_ms["replay"],
                    "boot_ms": stack.boot_ms,
                    "requests": _delta(before, stack.requests.snapshot())}

        def detached_clean(prefix: str) -> None:
            answer = remove()
            checks[f"{prefix}_detach_leaves_no_companion"] = (
                answer.result == ok_remove and gate_pairs() == set()
                and box.nodes() == {"null": (1, 3)}
                and stack.slave_pods() == []
                and stack.gate.granted_uuids() == set())
            checks[f"{prefix}_invariants_after_detach"] = invariants(
                set(), attaches)

        # 2. the attach dies at each crash point; the replay completes it
        report["crash_points"] = {}
        for point in chaos.CRASH_POINTS:
            fired: list[str] = []
            chaos.arm_crash(point, stack.mounter, stack.journal,
                            fired=fired)
            n_events = len(stack.kube.events)
            code = _rpc_error(add)
            row = {"rpc_error": code, "backlog_at_crash":
                   stack.journal.backlog(), **restart()}
            report["crash_points"][point] = row
            checks[f"{point}_crash_fired"] = (fired == [point]
                                              and code is not None)
            checks[f"{point}_replay_completed"] = \
                row["replay"].get("completed") == 1
            checks[f"{point}_node_matches_host_rdev"] = \
                box.nodes() == attached_nodes
            checks[f"{point}_gate_grants_the_card"] = (
                stack.gate.granted_uuids() == {gpu.uuid}
                and gate_pairs() == granted)
            checks[f"{point}_one_slave_pod"] = len(stack.slave_pods()) == 1
            checks[f"{point}_no_backlog"] = stack.journal.backlog() == 0
            reasons = reasons_since(n_events)
            checks[f"{point}_one_logical_attach"] = (
                reasons.count("GPUAttached") == 0
                and reasons.count("GPUAttachResumed") == 1)
            attaches += 1
            checks[f"{point}_invariants"] = invariants({gpu.uuid}, attaches)
            if point == chaos.CRASH_POINTS[0]:
                report["in_pod_after_replay"] = _proof(spawn_proof, gpu,
                                                       procs)
            detached_clean(point)

        step("crash_points")

        # 3. the owner dies while the worker is down: the replay reverts
        box_b = stack.node.container("workload-b", [idle_b.pid])
        stack.add_target(box_b)
        fired = []
        chaos.arm_crash("before_commit", stack.mounter, stack.journal,
                        fired=fired)
        code = _rpc_error(lambda: add("workload-b"))
        stack.stop_worker()
        stack.kube.delete_pod("default", "workload-b")
        for name in os.listdir(box_b.dev):     # its /dev died with it
            os.unlink(os.path.join(box_b.dev, name))
        before = stack.requests.snapshot()
        replay = stack.start_worker()
        report["owner_death"] = {
            "rpc_error": code, "replay": replay,
            "restart_to_replay_ms": stack.boot_ms["objects"]
            + stack.boot_ms["replay"], "boot_ms": stack.boot_ms,
            "requests": _delta(before, stack.requests.snapshot())}
        checks["owner_death_crash_fired"] = (fired == ["before_commit"]
                                             and code is not None)
        checks["owner_death_replay_reverts"] = (
            replay.get("reverted", 0) + replay.get("noop", 0) == 1
            and replay.get("completed", 0) == 0)
        checks["owner_death_leaves_nothing"] = (
            stack.slave_pods() == [] and stack.journal.backlog() == 0
            and stack.gate.granted_uuids() == set()
            and box_b.nodes() == {})

        step("owner_death")

        # 4. the detach dies mid-revoke / inside the v1 backend's sync
        report["detach_crash_points"] = {}
        for point in chaos.DETACH_CRASH_POINTS:
            a = add()
            attaches += 1
            fired = []
            chaos.arm_crash(point, stack.mounter, stack.journal,
                            backend=stack.gate.backend, fired=fired)
            code = _rpc_error(remove)
            pending = len(stack.journal.pending_gates())
            row = {"rpc_error": code, "gate_pending_at_crash": pending,
                   **restart()}
            report["detach_crash_points"][point] = row
            checks[f"{point}_crash_fired"] = (a.result == ok_add
                                              and fired == [point]
                                              and code is not None)
            if point == "mid_gate_sync":
                checks[f"{point}_left_a_pending_gate_record"] = pending >= 1
            checks[f"{point}_restart_regrants"] = (
                row["replay"].get("gate_restored", 0) >= 1
                and not stack.journal.pending_gates()
                and stack.gate.granted_uuids() == {gpu.uuid}
                and box.nodes() == attached_nodes)
            checks[f"{point}_invariants"] = invariants({gpu.uuid}, attaches)
            detached_clean(point)

        step("detach_crash_points")

        # 5. the transient plans, one timed pair each
        report["plans"] = {}
        for name, fault_specs, flaps in PLANS:
            injector = (chaos.FaultPlan(name, [chaos.Fault(**f)
                                               for f in fault_specs])
                        .injector() if fault_specs else None)
            retries = _retries()
            before = stack.requests.snapshot()
            faults.injector = injector
            waited = 0.0
            if any(f["op"] == "WATCH" for f in fault_specs):
                # the informer's next watch request meets the fault first
                t0 = time.perf_counter()
                deadline = time.monotonic() + 5 * WATCH_CHUNK_S
                while not injector.fired and time.monotonic() < deadline:
                    time.sleep(0.002)
                waited = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            a, kubelet_retries = _flapping(stack, add, flaps)
            t1 = time.perf_counter()
            r = remove()
            t2 = time.perf_counter()
            faults.injector = None
            attaches += 1
            after = _retries()
            row = {
                "attach_ms": (t1 - t0) * 1e3, "detach_ms": (t2 - t1) * 1e3,
                "attach_vs_fault_free_median": (t1 - t0) * 1e3 / baseline_ms,
                "waited_for_fault_ms": waited,
                "retries": {t: after[t] - retries[t] for t in RETRY_TARGETS},
                "fired": [list(f) for f in injector.fired] if injector
                else [], "kubelet_flaps": flaps,
                "kubelet_retries": kubelet_retries,
                "requests": _delta(before, stack.requests.snapshot())}
            report["plans"][name] = row
            converged = (getattr(a, "result", None) == ok_add
                         and list(a.device_ids) == [gpu.uuid]
                         and getattr(r, "result", None) == ok_remove)
            checks[f"plan_{name}_converges"] = (
                converged and box.nodes() == {"null": (1, 3)}
                and gate_pairs() == set() and stack.slave_pods() == []
                and stack.journal.backlog() == 0)
            checks[f"plan_{name}_bit"] = (
                (injector is None or bool(injector.fired))
                and kubelet_retries == flaps)
        step("plans")
        a = add()
        attaches += 1
        report["in_pod_after_plans"] = _proof(spawn_proof, gpu, procs)
        checks["attach_for_the_last_proof"] = a.result == ok_add
        for label in ("in_pod_after_replay", "in_pod_after_plans"):
            in_pod = report.get(label, {})
            checks[f"{label}_kernel_matches_plain"] = bool(in_pod.get("ok"))
            checks[f"{label}_kernel_launched"] = \
                in_pod.get("launches", 0) >= 1
            checks[f"{label}_sees_one_gpu"] = in_pod.get("device_count") == 1
        detached_clean("final")
        step("final_proof_and_detach")

        report["agent_fallbacks"] = _fallback_total() - fallbacks_before
        checks["agent_no_fallback"] = report["agent_fallbacks"] == 0
        report.update(card={"uuid": gpu.uuid, "node": gpu.device_path,
                            "majmin": list(own)},
                      companions=companions,
                      gate_backend=stack.gate.backend.name,
                      agent_mode=stack.agent.status()["mode"])
        return report
    finally:
        report["phase_s"] = time.perf_counter() - t_phase
        report["checks"] = checks
        report["ok"] = bool(checks) and all(checks.values())
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
            proc.wait(timeout=60)
        if stack is not None:
            stack.close()
        shutil.rmtree(root, ignore_errors=True)
