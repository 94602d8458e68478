"""A fragmented fleet consolidated onto one real host among four.

:func:`run_defrag` puts four hosts behind one master with the topology
plane on and the defragmenter acting (``TPU_DEFRAG_MODE=act``):

- host 0 is :mod:`.worker_attach`'s ``_Stack`` around whatever enumerator
  the caller passes (on a card machine, the real ``/dev`` and NVML), a GKE
  node of one GPU; its sidecar serves ``/utilz`` from a usage sampler over
  the real :class:`~gpumounter_tpu_torch.collector.usage.GpuUsageProbe`
  (NVML held open for the sampler's life) and ``/topoz`` from the
  topology view; it holds ``spare-0``, a pod labelled
  ``tpumounter.io/slice-spare=true``;
- hosts 1-3 are :class:`~.sim.WorkerRig` s with TWO fake GPUs each and
  :class:`~gpumounter_tpu_torch.collector.usage.FakeUsageProbe` samplers.
  Their nodes carry no accelerator label, as the control plane's test
  hosts carry none: a labelled GPU host takes a slice member only whole
  (ROADMAP Queue 3 item 34), so one-GPU groups on two-GPU hosts — the
  fragmentation a defragmenter undoes — exist only on label-less hosts;
- the master is built as ``master/main.py`` builds it with
  ``TPU_FLEET_INTERVAL_S=1`` and ``TPU_DEFRAG_MODE=act``, and the
  defragmenter's defaults: hysteresis 3 fleet ticks, idle duty at most
  0.05, one move in flight, a budget of 4. Its broker marks a lease idle
  after 1 s of zero duty (``TPU_IDLE_LEASE_S=1``) instead of 300 s, so
  the idleness the move needs comes from the usage telemetry within the
  phase.

It then checks, each check by name: (a) ``/topoz`` on every host — host 0
lists exactly its GPU, hosts 1-3 two each; (b) the usage proof on host 0's
GPU — ``/utilz`` reads it idle, a child then runs ``flash_fwd`` in a loop
for ~3 s and ``/utilz`` must read duty >= 0.5 from NVML with the open
counted once, and the duty falls back once the loop stops; (c) the fleet
fragmented by ``/addgpuslice`` into an idle one-GPU group on host 1 and
busy two-GPU gangs on hosts 2 and 3 — ``/fleetz`` ``topology.score``
0.5 (two free GPUs, a largest block of one) and exactly one candidate,
``workload-1``; (d) the defragmenter waits out hysteresis, plans,
journals and moves ``workload-1``'s group onto ``spare-0`` through
``migrate_member``: the score reads 0.0, the verify pass charges nothing,
the busy gangs never move, host 1 keeps no slave pod, the moved member's
in-pod child launches ``flash_fwd`` on host 0's GPU, the topology,
defrag and slice invariants hold and the agent never falls back. It times
20 ``/topoz`` and 20 ``/utilz`` GETs on host 0, ``sample_once`` with NVML
held open, ``nvml_identities`` with and without a held init (in this
process and in a fresh one without a CUDA context),
``FleetTopology.tick`` over the four hosts, candidate → planned →
migrated in fleet ticks and milliseconds, and the facade requests of the
move. The caller decides what failing means.
"""

from __future__ import annotations

import contextlib
import json
import os
import select
import shutil
import subprocess
import sys
import time
from collections.abc import Callable

from gpumounter_tpu_torch.device.enumerator import Enumerator
from gpumounter_tpu_torch.device.model import GPUDevice
from gpumounter_tpu_torch.testing.ha_attach import _wait
from gpumounter_tpu_torch.testing.master_attach import REPO, _http
from gpumounter_tpu_torch.testing.slice_attach import (HOSTS, OneGPU,
                                                       _SliceStack)
from gpumounter_tpu_torch.testing.worker_attach import (IDLE, NODE, _delta,
                                                        _stats, _target_pod,
                                                        spawn)
from gpumounter_tpu_torch.utils import consts

FLEET_INTERVAL_S = 1.0
USAGE_INTERVAL_S = 0.25
IDLE_LEASE_S = 1.0
IDLE_DUTY_MAX = consts.DEFAULT_DEFRAG_IDLE_DUTY_MAX
FRAGMENT = (0, 1, 2, 2)     # GPUs of workload-i's group on host i
IDLE_HOST = 1               # the idle group's host
SPARE = "spare-0"           # the spare pod on host 0
LOAD_S = 3.0
BUDGET_S = 60.0
WAIT_S = 20.0
POLL_S = 0.05
GETS = 20

# The usage proof's load: on the one card of CUDA_VISIBLE_DEVICES, the
# whole-K flash_fwd at a bf16 shape big enough to keep the card busy. It
# warms up (context, kernel library, one launch), says "ready", waits for
# a line on stdin, launches back to back for LOAD_S seconds, prints one
# JSON line, and holds its context until stdin closes.
LOAD = r"""
import json, sys, time, torch
from gpumounter_tpu_torch.torchcheck import kernels
gen = torch.Generator(device="cuda").manual_seed(0)
bh, t, d = 64, 1024, 128
q, k, v = (torch.randn((bh, t, d), generator=gen, device="cuda")
           .to(torch.bfloat16) for _ in range(3))
scale = d ** -0.5
kernels.flash_fwd(q, k, v, 0, 0, scale)
torch.cuda.synchronize()
print("ready", flush=True)
sys.stdin.readline()
t0, n = time.perf_counter(), 0
while time.perf_counter() - t0 < %(load_s)r:
    for _ in range(20):
        kernels.flash_fwd(q, k, v, 0, 0, scale)
    n += 20
    torch.cuda.synchronize()
print(json.dumps({"launches": n, "seconds": time.perf_counter() - t0,
                  "device": torch.cuda.get_device_name(0)}), flush=True)
sys.stdin.read()
"""


# NVML's init/shutdown pair that the enumerator's ``nvml_identities`` pays
# on every uncached scan, timed in a fresh process that holds no CUDA
# context (as a worker does): five calls alone, then five while one
# ``nvmlInit_v2`` is held, as the usage sampler holds it.
NVML_TIMING = r"""
import json, time
from gpumounter_tpu_torch.device.enumerator import load_nvml, nvml_identities
def times():
    out = []
    for _ in range(5):
        t0 = time.perf_counter()
        nvml_identities()
        out.append((time.perf_counter() - t0) * 1e3)
    return out
cold, held = times(), None
lib = load_nvml()
if lib is not None and lib.nvmlInit_v2() == 0:
    held = times()
    lib.nvmlShutdown()
print(json.dumps({"cold": cold, "held": held}))
"""


def _nvml_timing() -> dict:
    """``nvml_identities`` in a fresh process, alone and under a held
    init (:data:`NVML_TIMING`), as medians with min and max."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    proc = subprocess.run([sys.executable, "-c", NVML_TIMING], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    try:
        out = json.loads(proc.stdout.strip().splitlines()[-1])
    except (ValueError, IndexError):
        return {"error": proc.stderr[-1000:]}
    return {k: (_stats(v) if v else None) for k, v in out.items()}


def cuda_load(gpu: GPUDevice) -> subprocess.Popen:
    """The usage proof's load child, pinned to ``gpu`` by its UUID."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES=gpu.uuid,
               PYTHONPATH=os.pathsep.join(
                   [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    return subprocess.Popen([sys.executable, "-c",
                             LOAD % {"load_s": LOAD_S}], cwd=REPO,
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                            text=True, env=env)


@contextlib.contextmanager
def _environ(**values: str):
    """``os.environ`` with ``values`` set, restored afterwards: the master
    reads its planes' settings from the environment when it is built."""
    saved = {key: os.environ.get(key) for key in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for key, value in saved.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value


def _line(proc: subprocess.Popen, timeout_s: float) -> str:
    """The child's next stdout line, or "" if none comes in time."""
    if not select.select([proc.stdout], [], [], timeout_s)[0]:
        return ""
    return proc.stdout.readline()


def _ms(fn, n: int) -> dict:
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return _stats(times)


class _DefragStack(_SliceStack):
    """The slice rig's four hosts with two-GPU label-less fixture hosts,
    every host's sidecar serving /utilz and /topoz, host 0's sampler on
    the GPU probe (NVML library ``nvml``; None loads the real one), and
    the master built with the defragmenter acting."""

    def __init__(self, root: str, enumerator: Enumerator, nvml=None):
        self.nvml = nvml
        with _environ(TPU_DEFRAG_MODE="act",
                      TPU_FLEET_INTERVAL_S=str(FLEET_INTERVAL_S)):
            super().__init__(root, enumerator, health=True, fixture_gpus=2,
                             accelerator=None,
                             rig_options={"usage": "fake", "topo": True,
                                          "usage_interval_s":
                                              USAGE_INTERVAL_S})
        self.gateway.broker.config.idle_lease_s = IDLE_LEASE_S
        self._closers.append(self.sampler.stop)
        for rig in self.rigs:
            self._closers.append(rig.usage.stop)

    def _host0_state(self) -> dict:
        from gpumounter_tpu_torch.collector.topology import (
            NodeTopologyView, node_topology_source)
        from gpumounter_tpu_torch.collector.usage import (
            ChipUsageSampler, GpuUsageProbe, slave_owner_resolver)
        worker = self.worker
        pool = worker.settings.pool_namespace
        owners = slave_owner_resolver(worker.reads, pool,
                                      service=worker.service)
        self.sampler = ChipUsageSampler(
            worker.sim.collector,
            GpuUsageProbe(worker.settings.host, worker.sim.enumerator,
                          lib=self.nvml),
            interval_s=USAGE_INTERVAL_S,
            pool_namespace=pool, node_name=NODE, owners_fn=owners,
            refresh_inventory=True)
        self.view = NodeTopologyView(
            worker.sim.collector, node_name=NODE,
            topology_fn=node_topology_source(worker.rest, NODE),
            owners_fn=owners, pool_namespace=pool)
        return {"usage": self.sampler, "topo": self.view}

    def sidecar(self, i: int, route: str) -> tuple[int, dict | str]:
        return _http("GET", f"http://127.0.0.1:"
                     f"{self.sidecars[i].server_port}{route}")

    def slave_pods(self, i: int) -> list:
        return (self.worker.slave_pods() if i == 0
                else self.rigs[i - 1].sim.slave_pods())


def _card_row(stack: _DefragStack, uuid: str) -> dict:
    status, utilz = stack.sidecar(0, "/utilz")
    if status != 200 or not isinstance(utilz, dict):
        return {}
    return next((r for r in utilz.get("chips", []) if r["chip"] == uuid),
                {})


def _fresh_card_row(stack: _DefragStack, uuid: str) -> dict:
    """Host 0's row for the card from a sample taken after this call."""
    ts0 = time.time()
    row: dict = {}

    def fresh() -> bool:
        nonlocal row
        status, utilz = stack.sidecar(0, "/utilz")
        if status != 200 or (utilz.get("ts") or 0) <= ts0:
            return False
        row = next((r for r in utilz.get("chips", [])
                    if r["chip"] == uuid), {})
        return bool(row)

    _wait(fresh, WAIT_S, POLL_S)
    return row


def _usage_proof(stack: _DefragStack, gpu: GPUDevice,
                 spawn_load: Callable[[GPUDevice], subprocess.Popen],
                 procs: list, checks: dict, report: dict) -> None:
    """Part (b): the card idle, under the load child, and idle again."""
    idle = _fresh_card_row(stack, gpu.uuid)
    report["usage_idle"] = idle
    checks["utilz_card_idle_from_nvml"] = (
        idle.get("duty_source") == "nvml"
        and idle.get("duty", 1.0) <= IDLE_DUTY_MAX)
    load = spawn_load(gpu)
    procs.append(load)
    ready = _line(load, 300).strip() == "ready"
    checks["load_child_ready"] = ready
    if not ready:
        return
    # the warm-up's own launches settle before the baseline: the sampler
    # must see the card not busy (duty at most its idle epsilon, below
    # IDLE_DUTY_MAX), or the load's start makes no idle-to-busy edge for
    # the opens count
    settled = _wait(lambda: _fresh_card_row(stack, gpu.uuid).get(
        "busy") is False, WAIT_S, POLL_S)
    opens0 = _fresh_card_row(stack, gpu.uuid).get("opens", 0)
    load.stdin.write("go\n")
    load.stdin.flush()
    t_go = time.perf_counter()
    peak: dict = {}
    line = ""
    # read the card's duty until the load's loop ends (its JSON line)
    while not line and time.perf_counter() - t_go < LOAD_S + WAIT_S:
        row = _card_row(stack, gpu.uuid)
        if row.get("duty", 0.0) > peak.get("duty", -1.0):
            peak = row
        line = _line(load, POLL_S)
    t_done = time.perf_counter()
    try:
        report["load"] = json.loads(line or "{}")
    except ValueError:
        report["load"] = {}
    fell = _wait(lambda: _card_row(stack, gpu.uuid).get(
        "duty", 1.0) <= IDLE_DUTY_MAX, WAIT_S, POLL_S)
    report["duty_fall_s"] = time.perf_counter() - t_done
    report["duty_fall_intervals"] = report["duty_fall_s"] / USAGE_INTERVAL_S
    row = _fresh_card_row(stack, gpu.uuid)
    report["usage_peak"] = peak
    report["load_opens"] = row.get("opens", 0) - opens0
    checks["utilz_card_busy_from_nvml"] = (
        settled and peak.get("duty", 0.0) >= 0.5
        and peak.get("duty_source") == "nvml"
        and report["load"].get("launches", 0) > 0)
    checks["load_open_counted_once"] = report["load_opens"] == 1
    checks["duty_falls_back_after_the_load"] = (
        fell and report["duty_fall_s"] < 5.0)
    load.stdin.close()
    load.wait(timeout=120)


def _slice(stack: _DefragStack, i: int, gpus: int) -> tuple[int, dict]:
    body = json.dumps({"pods": [{"namespace": "default",
                                 "pod": f"workload-{i}"}],
                       "gpusPerHost": gpus}).encode()
    return _http("POST", stack.base + "/addgpuslice", body)


def run_defrag(root: str, enumerator: Enumerator,
               spawn_proof: Callable[[GPUDevice], subprocess.Popen],
               spawn_load: Callable[[GPUDevice], subprocess.Popen],
               nvml=None) -> dict:
    """Drive the topology plane and the defragmenter over HTTP under
    ``root`` (removed first and afterwards), with host 0 on the first GPU
    ``enumerator`` names. ``spawn_proof(gpu)`` starts the in-pod proof (a
    process printing one JSON line with its ``ok``, ``launches``,
    ``device_count`` and ``visible``, exiting when its stdin closes);
    ``spawn_load(gpu)`` starts the usage proof's load (:data:`LOAD`'s
    protocol); ``nvml`` is host 0's NVML library (None: the real one).
    Returns the report with its ``checks`` and timings."""
    from gpumounter_tpu_torch.actuation.agent import _fallback_total
    from gpumounter_tpu_torch.device.enumerator import nvml_identities
    from gpumounter_tpu_torch.testing.chaos import (assert_defrag_invariants,
                                                    assert_slice_invariants,
                                                    assert_topology_invariants)
    from gpumounter_tpu_torch.utils.events import EVENTS

    shutil.rmtree(root, ignore_errors=True)
    t_start = time.perf_counter()
    procs: list[subprocess.Popen] = []
    checks: dict[str, bool] = {}
    report: dict = {}
    timings: dict = {}
    stack = None
    fallbacks_before = _fallback_total()
    try:
        enumerator = OneGPU(enumerator)
        stack = _DefragStack(root, enumerator, nvml)
        gateway, worker = stack.gateway, stack.worker
        defrag, topology = gateway.defrag, gateway.topology
        checks["defrag_acting"] = (topology is not None
                                   and defrag is not None
                                   and defrag.mode == "act")
        gpus = enumerator.enumerate()
        checks["node_has_a_gpu"] = bool(gpus)
        if not checks["defrag_acting"] or not gpus:
            return report
        gpu = gpus[0]
        tick_ms: list[float] = []
        tick = topology.tick

        def timed_tick(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return tick(*args, **kwargs)
            finally:
                tick_ms.append((time.perf_counter() - t0) * 1e3)

        topology.tick = timed_tick
        # NVML's init/shutdown pair the enumerator pays per scan: in this
        # process before and while the sampler holds its init, and in a
        # fresh process without a CUDA context
        timings["nvml_identities_ms"] = {
            "this_process": _ms(nvml_identities, 5)}
        stack.sampler.start()
        timings["nvml_identities_ms"]["this_process_held"] = _ms(
            nvml_identities, 5)
        timings["nvml_identities_ms"]["fresh_process"] = _nvml_timing()
        for rig in stack.rigs:
            rig.usage.start()
        idle = spawn(IDLE)
        procs.append(idle)
        spare = _target_pod(worker.node.container(SPARE, [idle.pid]))
        spare["metadata"]["labels"][consts.SLICE_SPARE_LABEL_KEY] = \
            consts.SLICE_SPARE_LABEL_VALUE
        worker.kube.put_pod(spare)
        stack.serve()
        checks["every_host_scraped_fresh"] = _wait(lambda: all(
            gateway.fleet.snapshot(events_limit=0)["nodes"].get(
                n, {}).get("state") == "fresh" for n in stack.nodes),
            WAIT_S, POLL_S)

        # (a) /topoz on every host
        topoz = [stack.sidecar(i, "/topoz")[1] for i in range(HOSTS)]
        report["topoz_host0"] = topoz[0]
        checks["topoz_host0_lists_exactly_the_card"] = (
            [c["chip"] for c in topoz[0].get("chips", [])] == [gpu.uuid]
            and topoz[0].get("gpus_per_node") == 1)
        checks["topoz_fixture_hosts_list_two_gpus"] = all(
            len(t.get("chips", [])) == 2 and t.get("accelerator") == ""
            for t in topoz[1:])
        checks["master_topoz_has_every_host"] = _wait(lambda: set(
            _http("GET", stack.base + "/topoz")[1].get("nodes", {}))
            == set(stack.nodes), WAIT_S, POLL_S)
        timings["topoz_get_ms"] = _ms(lambda: stack.sidecar(0, "/topoz"),
                                      GETS)
        timings["utilz_get_ms"] = _ms(lambda: stack.sidecar(0, "/utilz"),
                                      GETS)

        # (b) the usage proof on the card
        _usage_proof(stack, gpu, spawn_load, procs, checks, report)
        timings["sample_once_ms"] = _ms(stack.sampler.sample_once, GETS)

        # (c) fragment: an idle one-GPU group on host 1, busy gangs on 2, 3
        seq0 = EVENTS.tail(1)[-1]["seq"] if EVENTS.tail(1) else 0
        groups = {}
        for i, n in enumerate(FRAGMENT):
            if n:
                status, body = _slice(stack, i, n)
                groups[i] = body.get("group") if status == 200 else None
                if i != IDLE_HOST:
                    stack.rigs[i - 1].usage_probe.default_duty = 1.0
        checks["fragment_groups_attached"] = all(groups.values())
        if not checks["fragment_groups_attached"]:
            report["groups"] = groups
            return report
        group = groups[IDLE_HOST]
        broker = gateway.broker
        busy_before = {i: sorted(broker.leases.get(
            "default", f"workload-{i}").uuids) for i in (2, 3)}
        requests0 = worker.requests.snapshot()
        fragmented: dict = {}

        def scored() -> bool:
            # the first scoring of the whole fragmented fleet
            nonlocal fragmented
            view = topology.fleetz_section() or {}
            if view.get("free") == 2:
                fragmented = view
                return True
            return False

        scored_in_time = _wait(scored, WAIT_S, POLL_S)
        tick_candidate = topology.snapshot()["ticks"]
        report["fragmented"] = {k: fragmented.get(k) for k in (
            "score", "free", "largest_free_block", "stranded",
            "defrag_candidates")}
        checks["score_0_5_fragmented"] = (
            scored_in_time and fragmented.get("score") == 0.5
            and fragmented.get("largest_free_block") == 1)
        checks["one_candidate_workload_1"] = [
            c["pod"] for c in fragmented.get("defrag_candidates", [])] \
            == [f"workload-{IDLE_HOST}"]
        checks["idle_group_marked_idle"] = _wait(lambda: broker.leases.get(
            "default", f"workload-{IDLE_HOST}") is None or broker.leases.get(
                "default", f"workload-{IDLE_HOST}").idle_since_unix
            is not None, WAIT_S, POLL_S)

        # (d) hysteresis, plan, journal, the move onto the card
        def event(kind: str, **attrs) -> dict | None:
            return next((e for e in EVENTS.tail(1000)
                         if e["seq"] > seq0 and e["kind"] == kind
                         and e.get("pod") == f"workload-{IDLE_HOST}"
                         and all(e["attrs"].get(k) == v
                                 for k, v in attrs.items())), None)

        moved = _wait(lambda: event("defrag_move", outcome="migrated")
                      is not None, 2 * WAIT_S, POLL_S)
        tick_moved = topology.snapshot()["ticks"]
        at = {"defrag_candidate": event("defrag_candidate"),
              "defrag_plan": event("defrag_plan", outcome="planned"),
              "defrag_move": event("defrag_move", outcome="migrated")}
        report["move_events"] = {k: e and e["attrs"] for k, e in at.items()}
        if None not in at.values():
            timings["candidate_to_planned_ms"] = (
                at["defrag_plan"]["ts"] - at["defrag_candidate"]["ts"]) * 1e3
            timings["planned_to_migrated_ms"] = (
                at["defrag_move"]["ts"] - at["defrag_plan"]["ts"]) * 1e3
        timings["candidate_to_migrated_ticks"] = tick_moved - tick_candidate
        report["move_requests"] = _delta(requests0,
                                         worker.requests.snapshot())
        checks["moved_through_migrate_member"] = (
            moved and at["defrag_move"] is not None
            and at["defrag_move"]["attrs"].get("group") == group)
        members = [(m.pod, m.node) for m in broker.leases.group_leases(group)]
        lease = broker.leases.get("default", SPARE)
        checks["group_now_on_the_card"] = (
            members == [(SPARE, NODE)] and lease is not None
            and sorted(lease.uuids) == [gpu.uuid]
            and len(stack.slave_pods(0)) == 1)
        checks["no_slave_pod_left_on_host_1"] = \
            stack.slave_pods(IDLE_HOST) == []
        checks["busy_gangs_never_moved"] = all(
            broker.leases.get("default", f"workload-{i}") is not None
            and sorted(broker.leases.get(
                "default", f"workload-{i}").uuids) == busy_before[i]
            for i in (2, 3))
        consolidated: dict = {}

        def verified() -> bool:
            nonlocal consolidated
            consolidated = _http("GET", stack.base + "/fleetz")[1]
            recent = consolidated.get("defrag", {}).get("recent", [])
            return (consolidated.get("topology", {}).get("score") == 0.0
                    and bool(recent) and "improved" in recent[0])

        checks["score_0_0_consolidated"] = _wait(verified, WAIT_S, POLL_S)
        section = consolidated.get("defrag", {})
        report["defrag"] = section
        report["consolidated"] = {k: consolidated.get("topology", {}).get(k)
                                  for k in ("score", "free",
                                            "largest_free_block")}
        checks["verify_pass_charges_no_budget"] = (
            section.get("recent", [{}])[0].get("improved") is True
            and section.get("budget", {}).get("used") == 1)

        # the moved member's in-pod proof on the card
        proof = spawn_proof(gpu)
        procs.append(proof)
        line = _line(proof, 300)
        try:
            report["in_pod"] = json.loads(line)
        except ValueError:
            report["in_pod"] = {"ok": False, "output": line[-2000:]}
        in_pod = report["in_pod"]
        checks["in_pod_kernel_matches_plain"] = bool(in_pod.get("ok"))
        checks["in_pod_kernel_launched"] = in_pod.get("launches", 0) >= 1
        checks["in_pod_sees_the_card"] = (
            in_pod.get("device_count") == 1
            and in_pod.get("visible") == gpu.uuid)
        proof.stdin.close()
        report["proof_rc"] = proof.wait(timeout=120)

        try:
            assert_topology_invariants(consolidated["topology"])
            assert_defrag_invariants(broker, actuator=defrag)
            assert_slice_invariants(broker, stack.sims(), kube=stack.kube)
            checks["invariants_hold"] = True
        except (AssertionError, KeyError) as e:
            report["invariants"] = str(e)[:2000]
            checks["invariants_hold"] = False
        report["agent_fallbacks"] = _fallback_total() - fallbacks_before
        checks["agent_no_fallback"] = report["agent_fallbacks"] == 0
        timings["topology_tick_ms"] = _stats(tick_ms) if tick_ms else None
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
