"""The control-plane half of an attach over HTTP, on one node, with its
proof inside the Pod.

:func:`run_master_attach` puts the port's master in front of the worker
that :mod:`.worker_attach` wires (its ``_Stack``: an HTTP apiserver facade,
a scripted scheduler with a PodResources gRPC server, the v1 device gate,
the resident agent, a fixture container, ``AddGPU``/``RemoveGPU`` over
gRPC), around whatever enumerator the caller passes:

- the worker's health sidecar (``worker/main.py``'s ``/healthz``,
  ``/metrics``, ``/eventz``, ``/tracez``, ...) on an ephemeral port;
- the master as ``master/main.py`` builds it: a ``MasterGateway`` with its
  ``AttachBroker`` and ``WorkerDirectory``, reading the cluster through
  its own REST client on the same facade (the worker's pod carries its
  gRPC port), served by the multiplexed HTTP front.

It then attaches one GPU with the reference's ``GET /addgpu/...``, checks
the grant and the nodes in the fixture container, starts ``spawn_proof``'s
process (on a card: a child pinned to the returned UUID by
``CUDA_VISIBLE_DEVICES`` that launches ``flash_fwd`` and holds its CUDA
context), which must make ``POST /removegpu/...`` answer the busy result,
detaches after it exits, times ``cycles`` attach/detach pairs over HTTP,
reads ``/fleetz`` and ``/metrics`` once, and counts the resident agent's
fallbacks. Every check is reported by name; the caller decides what
failing means.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time
import urllib.error
import urllib.request
from collections.abc import Callable

from gpumounter_tpu_torch.device.enumerator import Enumerator
from gpumounter_tpu_torch.device.model import GPUDevice
from gpumounter_tpu_torch.testing.worker_attach import (CYCLES, IDLE, NODE,
                                                        _delta,
                                                        _host_majmin,
                                                        _phase_medians,
                                                        _Stack, _stats,
                                                        spawn)

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
ADD = "/addgpu/namespace/default/pod/workload/gpu/1/isEntireMount/true"
REMOVE = "/removegpu/namespace/default/pod/workload/force/false"
# The in-pod proof: on the one card the attach returned (the child's
# CUDA_VISIBLE_DEVICES is its UUID), the whole-K flash_fwd kernel at a
# small bf16 shape held against its plain version at the parity phase's
# whole-K tolerances (1e-2 on the normalised output, 1e-3 on m and lse).
# It prints one JSON line, then holds its CUDA context until stdin closes.
PROOF = r"""
import json, os, sys, torch
from gpumounter_tpu_torch.torchcheck import kernels
from gpumounter_tpu_torch.torchcheck.flash_attention import _flash_fwd_plain
gen = torch.Generator(device="cuda").manual_seed(0)
bh, t, d = 8, 256, 128
q, k, v = (torch.randn((bh, t, d), generator=gen, device="cuda")
           .to(torch.bfloat16) for _ in range(3))
scale = d ** -0.5
got = kernels.flash_fwd(q, k, v, 0, 0, scale)
want = _flash_fwd_plain(q, k, v, 0, 0, scale)
torch.cuda.synchronize()
norm = lambda pv, l: pv / l.transpose(1, 2).clamp_min(1e-30)
err = {
    "out": (norm(got[0], got[2]) - norm(want[0], want[2])).abs().max().item(),
    "m": (got[1] - want[1]).abs().max().item(),
    "lse": ((got[1] + torch.log(got[2]))
            - (want[1] + torch.log(want[2]))).abs().max().item()}
tol = {"out": 1e-2, "m": 1e-3, "lse": 1e-3}
print(json.dumps({
    "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
    "device_count": torch.cuda.device_count(),
    "device": torch.cuda.get_device_name(0),
    "shape": [bh, t, d], "dtype": "bfloat16",
    "launches": kernels.LAUNCHES["flash_fwd_whole_k"],
    "max_abs_err": err, "tol": tol,
    "ok": all(err[n] <= tol[n] for n in err)}), flush=True)
sys.stdin.read()
"""


def cuda_proof(gpu: GPUDevice) -> subprocess.Popen:
    """The in-pod proof's child, pinned to ``gpu`` by its UUID."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES=gpu.uuid,
               PYTHONPATH=os.pathsep.join(
                   [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    return subprocess.Popen([sys.executable, "-c", PROOF], cwd=REPO,
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                            text=True, env=env)


def _http(method: str, url: str, body: bytes | None = None,
          headers: dict | None = None) -> tuple[int, dict | str]:
    """One request on a fresh connection, as ``curl`` sends it; a JSON
    body is decoded."""
    req = urllib.request.Request(url, data=body, method=method,
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=300) as resp:
            status, raw = resp.status, resp.read()
    except urllib.error.HTTPError as e:
        status, raw = e.code, e.read()
    text = raw.decode()
    try:
        return status, json.loads(text)
    except ValueError:
        return status, text


class _MasterStack:
    """The worker of :mod:`.worker_attach` with its health sidecar and the
    master in front; :meth:`close` stops every server and thread."""

    def __init__(self, root: str, enumerator: Enumerator):
        from gpumounter_tpu_torch.k8s.client import InClusterKubeClient
        from gpumounter_tpu_torch.master.admission import (AttachBroker,
                                                           BrokerConfig)
        from gpumounter_tpu_torch.master.discovery import WorkerDirectory
        from gpumounter_tpu_torch.master.gateway import MasterGateway
        from gpumounter_tpu_torch.testing.sim import worker_pod
        from gpumounter_tpu_torch.worker.main import start_health_server

        self.worker = _Stack(root, enumerator)
        self._closers: list[Callable[[], object]] = [self.worker.close]
        self.health = start_health_server(
            0, journal=self.worker.journal, cache=self.worker.reads,
            agent=self.worker.agent, gate=self.worker.gate, ready=True,
            **self._sidecar_state())
        self._closers.append(self.health.shutdown)
        health_base = f"http://127.0.0.1:{self.health.server_port}"
        self.worker.kube.put_pod(worker_pod(NODE, "127.0.0.1",
                                            grpc_port=self.worker.port))
        self.kube = InClusterKubeClient(host=self.worker.facade.base,
                                        sa_dir=self.worker.sa_dir)
        settings = self.worker.settings
        self.gateway = MasterGateway(
            self.kube, WorkerDirectory(self.kube),
            worker_tracez_base=lambda target: health_base,
            broker=AttachBroker(self.kube,
                                BrokerConfig.from_settings(settings)))
        self.http = self.gateway.serve(port=0, address="127.0.0.1")
        self._closers.append(self.http.shutdown)
        self.base = f"http://127.0.0.1:{self.http.server_port}"

    def _sidecar_state(self) -> dict:
        """Extra state for the worker's health sidecar (``usage``,
        ``topo``); none here."""
        return {}

    def close(self) -> None:
        for close in reversed(self._closers):
            close()


def _attach_total(result: str) -> float:
    from gpumounter_tpu_torch.utils.metrics import REGISTRY
    return REGISTRY.attach_results.value(result=result)


def run_master_attach(root: str, enumerator: Enumerator,
                      spawn_proof: Callable[[GPUDevice], subprocess.Popen],
                      cycles: int = CYCLES) -> dict:
    """Drive the control-plane half of an attach under ``root`` (removed
    first and afterwards). ``spawn_proof(gpu)`` starts the in-pod proof: a
    process that holds the GPU's node open, prints one JSON line (its
    ``ok``, ``launches`` and ``device_count``) and exits when its stdin
    closes. Returns the report with its ``checks``."""
    from gpumounter_tpu_torch.actuation.agent import _fallback_total
    from gpumounter_tpu_torch.utils.metrics import parse_exposition

    shutil.rmtree(root, ignore_errors=True)
    procs: list[subprocess.Popen] = []
    checks: dict[str, bool] = {}
    report: dict = {}
    stack = None
    fallbacks_before = _fallback_total()
    try:
        stack = _MasterStack(root, enumerator)
        worker = stack.worker
        gpus = [d for d in enumerator.enumerate() if d.uuid]
        checks["node_has_a_gpu"] = bool(gpus)
        idle = spawn(IDLE)
        procs.append(idle)
        box = worker.node.container("workload", [idle.pid])
        pod = worker.add_target(box)

        # 1. the reference's attach route over HTTP
        attached_before = {r: _attach_total(r)
                           for r in ("SUCCESS", "master_SUCCESS")}
        before = worker.requests.snapshot()
        t0 = time.perf_counter()
        status, body = _http("GET", stack.base + ADD)
        report["first_attach_ms"] = (time.perf_counter() - t0) * 1e3
        report["round_trips_first_attach"] = _delta(
            before, worker.requests.snapshot())
        report["first_attach"] = body
        checks["add_http_200_success"] = (
            status == 200 and isinstance(body, dict)
            and body.get("result") == "SUCCESS")
        ids = body.get("device_ids") if isinstance(body, dict) else None
        gpu = next((d for d in gpus if ids == [d.uuid]), None)
        checks["device_ids_are_the_uuid"] = gpu is not None
        if gpu is None:
            return report
        checks["device_paths_are_the_gpu_node"] = \
            body.get("device_paths") == [f"/dev/nvidia{gpu.minor}"]

        # 2. the grant and the nodes in the container
        companions = {os.path.basename(c.host_path):
                      _host_majmin(c.host_path, c.major, c.minor)
                      for c in gpu.companions}
        own = _host_majmin(gpu.device_path, gpu.major, gpu.minor)
        granted = {own, *companions.values()}
        expect = {os.path.basename(gpu.device_path): own, **companions}
        key = worker.node.controller.container_dir(pod, box.container_id)

        def gate_pairs() -> set:
            live, _opens, _denies = worker.gate.backend.read(key)
            return {(k[1], k[2]) for k in live}

        lines = sorted(f"c {a}:{b} rw" for a, b in granted)
        checks["gate_holds_gpu_and_companions"] = (
            gate_pairs() == granted
            and sorted(box.cgroup_lines("devices.allow")) == lines)
        checks["nodes_match_host_rdev"] = box.nodes() == expect
        brokerz = _http("GET", stack.base + "/brokerz")[1]
        checks["lease_recorded"] = [
            (le["pod"], le.get("uuids")) for le in brokerz["leases"]["leases"]
        ] == [("workload", [gpu.uuid])]

        # 3. the in-pod proof holds the card: the detach must be refused
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
        box.set_pids([idle.pid, proof.pid])
        status, busy = _http("POST", stack.base + REMOVE, b"")
        report["busy_detach"] = busy
        checks["busy_detach_409_gpu_busy"] = (
            status == 409 and isinstance(busy, dict)
            and busy.get("result") == "GPU_BUSY"
            and busy.get("busy_pids") == [proof.pid])
        checks["busy_detach_left_everything"] = (
            box.nodes() == expect and gate_pairs() == granted
            and len(worker.slave_pods()) == 1)
        proof.stdin.close()
        report["proof_rc"] = proof.wait(timeout=120)
        box.set_pids([idle.pid])
        before = worker.requests.snapshot()
        status, done = _http("POST", stack.base + REMOVE, b"")
        report["round_trips_detach"] = _delta(
            before, worker.requests.snapshot())
        checks["detach_completes_after_exit"] = (
            status == 200 and isinstance(done, dict)
            and done.get("result") == "SUCCESS"
            and worker.slave_pods() == [] and gate_pairs() == set()
            and box.nodes() == {}
            and sorted(box.cgroup_lines("devices.deny")) == lines)
        brokerz = _http("GET", stack.base + "/brokerz")[1]
        checks["lease_released"] = brokerz["leases"]["count"] == 0

        # 4. timing: attach/detach pairs over HTTP on the host clock
        times: dict[str, list[float]] = {"addgpu": [], "removegpu": []}
        ok = True
        before = worker.requests.snapshot()
        for _ in range(cycles):
            t0 = time.perf_counter()
            a = _http("GET", stack.base + ADD)
            t1 = time.perf_counter()
            r = _http("POST", stack.base + REMOVE, b"")
            t2 = time.perf_counter()
            ok = ok and a[0] == 200 and r[0] == 200
            times["addgpu"].append((t1 - t0) * 1e3)
            times["removegpu"].append((t2 - t1) * 1e3)
        checks["cycles_succeed"] = ok and box.nodes() == {}
        report["round_trips_per_cycle"] = _delta(
            before, worker.requests.snapshot(), per=cycles)
        report["ms"] = {k: _stats(v) for k, v in times.items()}
        # the master's spans (resolve, admission, dial, rpc, lease) and
        # the worker's (policy, allocate, resolve, actuate), by median
        report["phase_median_ms"] = {
            op: _phase_medians(op, cycles)
            for op in ("addgpu", "removegpu", "attach", "detach")}

        # 5. one fleet view and one metrics read
        stack.gateway.fleet.tick()
        fleetz = _http("GET", stack.base + "/fleetz")[1]
        node = fleetz.get("nodes", {}).get(NODE, {})
        report["fleetz_node"] = node
        checks["fleetz_worker_fresh"] = node.get("state") == "fresh"
        metrics = parse_exposition(_http("GET", stack.base + "/metrics")[1])
        attached = metrics.get("tpumounter_attach_total", {})
        deltas = {r: attached.get((("result", r),), 0.0) - v
                  for r, v in attached_before.items()}
        report["attach_total_delta"] = deltas
        # the first attach and the timed ones, counted once each by the
        # master and once by the worker
        checks["metrics_count_each_attach"] = (
            deltas == {"SUCCESS": 1 + cycles, "master_SUCCESS": 1 + cycles})

        # 6. the resident agent never fell back
        report["agent_fallbacks"] = _fallback_total() - fallbacks_before
        checks["agent_no_fallback"] = report["agent_fallbacks"] == 0
        report.update(card={"uuid": gpu.uuid, "node": gpu.device_path,
                            "majmin": list(own)},
                      companions=companions,
                      gate_backend=worker.gate.backend.name)
        return report
    finally:
        report["checks"] = checks
        report["ok"] = bool(checks) and all(checks.values())
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
            proc.wait(timeout=60)
        if stack is not None:
            stack.close()
        shutil.rmtree(root, ignore_errors=True)
