"""The operator's command line against the port's master, on one node.

:func:`run_operator` puts the master of :mod:`.master_attach` (its
``_MasterStack``: the worker of :mod:`.worker_attach` over an HTTP
apiserver facade, its health sidecar, the master with its broker) in
front of whatever enumerator the caller passes, with the worker's usage
sampler running (:class:`~gpumounter_tpu_torch.collector.usage.GpuUsageProbe`:
NVML utilization by UUID, held open for the sampler's life) and its
``/topoz`` view on the sidecar. It then drives ``gpumounterctl`` as an
operator does, one ``python3 -m gpumounter_tpu_torch.cli`` process per
command (a process with no CUDA context), and checks, each by name:

1. ``add workload --gpus 1 --json`` exits 0 with ``SUCCESS`` and the UUID
   of a GPU of the node;
2. ``status workload --json`` exits 0 and lists that UUID;
3. the in-pod proof (``spawn_proof``; on a card the whole-K ``flash_fwd``
   in a child pinned to the UUID) reports ok;
4. ``utilz`` against the worker's sidecar reads the GPU with the expected
   ``duty_source``;
5. ``trace <the add's request id>`` draws the master's and the worker's
   spans;
6. ``node`` and ``topo`` exit 0, and ``topo`` lists the UUID;
7. ``doctor --node --json`` exits 0, or 1 with only the warnings
   :data:`EXPECTED_WARNINGS` names;
8. ``remove workload --json`` exits 0 and leaves no slave pod;
9. ``--master http://127.0.0.1:1 health`` exits 10 (transport);
10. an ``add`` with a fixed ``--request-id`` whose first reply is lost (a
    proxy drops it after the master answered) is retried under the same
    id and adopted: one slave pod.

Between 8 and 9 it times ``cycles`` add/remove pairs, each command from
process start to exit, beside the request's own gateway span (the
master's trace), ``gpumounterctl --version`` (the interpreter's start and
the CLI's import, no request) and a bare ``python3 -c pass``. Host-clock
numbers only.

The report's ``checks`` say what held; the caller decides what failing
means. Run it in a fresh process (:func:`run_in_subprocess`, or ``python
-m gpumounter_tpu_torch.testing.operator``): doctor reads the master's
``/metrics``, and the registry is the process's, so counters and gauges
left by other work in the same process would be judged as this master's.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from collections.abc import Callable
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from gpumounter_tpu_torch.device.enumerator import Enumerator
from gpumounter_tpu_torch.device.model import GPUDevice
from gpumounter_tpu_torch.testing.master_attach import (REPO, _http,
                                                         _MasterStack)
from gpumounter_tpu_torch.testing.worker_attach import (IDLE, NODE, _stats,
                                                        spawn)

CYCLES = 10
VERSION_RUNS = 5
RETRY_RID = "operator-retry-1"
# The warnings doctor may give in this rig, each with why: the node's one
# GPU is attached while doctor runs, so its inventory reads 0 free.
EXPECTED_WARNINGS = {
    "node_gpus_all_attached": re.compile(r"node \S+: 0/\d+ GPUs free"),
}
WAIT_S = 30.0
# The in-pod proof on fake GPUs: reports ok without a kernel.
STUB_PROOF = ("import json, os, sys; print(json.dumps({'ok': True, "
              "'launches': 1, 'device_count': 1, 'visible': "
              "os.environ.get('CUDA_VISIBLE_DEVICES')}), flush=True); "
              "sys.stdin.read()")


def gpumounterctl(*argv: str, timeout: float = 120.0) -> dict:
    """One ``python3 -m gpumounter_tpu_torch.cli`` process: its exit
    code, output and wall time from start to exit (ms)."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "gpumounter_tpu_torch.cli", *argv],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=timeout)
    ms = (time.perf_counter() - t0) * 1e3
    return {"rc": proc.returncode, "stdout": proc.stdout,
            "stderr": proc.stderr, "ms": ms}


def _wall(argv: list[str]) -> float:
    """ms from the start of ``argv``'s process to its exit."""
    t0 = time.perf_counter()
    subprocess.run(argv, capture_output=True, timeout=120, check=True)
    return (time.perf_counter() - t0) * 1e3


def _json(run: dict) -> dict:
    try:
        payload = json.loads(run["stdout"])
    except ValueError:
        return {}
    return payload if isinstance(payload, dict) else {}


class _LossyProxy:
    """An HTTP proxy in front of the master that forwards every request
    and loses the reply of the first: the master has answered, the client
    sees its connection closed. Records each request's X-Request-Id."""

    def __init__(self, upstream: str):
        self.rids: list[str] = []
        proxy = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):
                rid = self.headers.get("X-Request-Id", "")
                proxy.rids.append(rid)
                status, body = _forward(upstream + self.path, rid)
                if len(proxy.rids) == 1:
                    self.close_connection = True     # the reply is lost
                    return
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):
                pass

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        threading.Thread(target=self.server.serve_forever,
                         daemon=True).start()
        self.base = f"http://127.0.0.1:{self.server.server_port}"

    def close(self) -> None:
        self.server.shutdown()
        self.server.server_close()


def _forward(url: str, rid: str) -> tuple[int, bytes]:
    req = urllib.request.Request(url, headers={"X-Request-Id": rid})
    try:
        with urllib.request.urlopen(req, timeout=300) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


class _OperatorStack(_MasterStack):
    """The master stack with the worker's usage sampler (the GPU probe)
    and topology view on its health sidecar."""

    def __init__(self, root: str, enumerator: Enumerator):
        super().__init__(root, enumerator)
        self._closers.append(self.usage.stop)
        self.health_base = f"http://127.0.0.1:{self.health.server_port}"

    def _sidecar_state(self) -> dict:
        from gpumounter_tpu_torch.collector.topology import (
            NodeTopologyView, node_topology_source)
        from gpumounter_tpu_torch.collector.usage import (
            ChipUsageSampler, GpuUsageProbe, slave_owner_resolver)
        worker = self.worker
        pool = worker.settings.pool_namespace
        owners = slave_owner_resolver(worker.reads, pool,
                                      service=worker.service)
        self.usage = ChipUsageSampler(
            worker.sim.collector,
            GpuUsageProbe(worker.settings.host, worker.sim.enumerator),
            interval_s=0.25, pool_namespace=pool, node_name=NODE,
            owners_fn=owners, refresh_inventory=True)
        view = NodeTopologyView(
            worker.sim.collector, node_name=NODE,
            topology_fn=node_topology_source(worker.rest, NODE),
            owners_fn=owners, pool_namespace=pool)
        return {"usage": self.usage, "topo": view}


def _gateway_ms(op: str, n: int) -> dict:
    """The master's own span (the gateway's root) of its last ``n``
    traces of ``op``, in ms."""
    from gpumounter_tpu_torch.utils.trace import STORE
    return _stats([t["total_ms"] for t in STORE.recent(op=op, limit=n)])


def _card_row(base: str, uuid: str) -> dict:
    status, utilz = _http("GET", base + "/utilz")
    if status != 200 or not isinstance(utilz, dict):
        return {}
    return next((r for r in utilz.get("chips", []) if r["chip"] == uuid),
                {})


def run_operator(root: str, enumerator: Enumerator,
                 spawn_proof: Callable[[GPUDevice], subprocess.Popen],
                 duty_source: str = "nvml", cycles: int = CYCLES) -> dict:
    """Drive gpumounterctl against the port's master under ``root``
    (removed first and afterwards); see the module docstring. The usage
    sampler must read the GPU from ``duty_source``. Returns the report
    with its ``checks``."""
    from gpumounter_tpu_torch.actuation.agent import _fallback_total

    shutil.rmtree(root, ignore_errors=True)
    procs: list[subprocess.Popen] = []
    checks: dict[str, bool] = {}
    report: dict = {}
    stack = proxy = None
    fallbacks_before = _fallback_total()
    try:
        stack = _OperatorStack(root, enumerator)
        worker, base = stack.worker, stack.base
        gpus = [d for d in enumerator.enumerate() if d.uuid]
        checks["node_has_a_gpu"] = bool(gpus)
        idle = spawn(IDLE)
        procs.append(idle)
        box = worker.node.container("workload", [idle.pid])
        worker.add_target(box)
        stack.usage.start()

        # 1. add
        run = gpumounterctl("--master", base, "--json", "add", "workload",
                            "-n", "default", "--gpus", "1")
        add = _json(run)
        report["add"] = add
        checks["add_exit_0_success"] = (run["rc"] == 0
                                        and add.get("result") == "SUCCESS")
        ids = add.get("device_ids") or []
        gpu = next((d for d in gpus if ids == [d.uuid]), None)
        checks["add_returns_a_gpu_uuid_of_the_node"] = gpu is not None
        if gpu is None:
            return report
        rid = add.get("request_id", "")

        # 2. status
        run = gpumounterctl("--master", base, "--json", "status",
                            "workload", "-n", "default")
        checks["status_exit_0_lists_the_uuid"] = (
            run["rc"] == 0 and [g.get("device_id") for g in
                                _json(run).get("gpus", [])] == [gpu.uuid])

        # 3. the in-pod proof on the attached GPU
        proof = spawn_proof(gpu)
        procs.append(proof)
        line = proof.stdout.readline()
        try:
            report["in_pod"] = json.loads(line)
        except ValueError:
            report["in_pod"] = {"ok": False, "output": line[-2000:]}
        checks["in_pod_kernel_ok"] = (
            bool(report["in_pod"].get("ok"))
            and report["in_pod"].get("launches", 0) >= 1
            and report["in_pod"].get("visible") == gpu.uuid)

        # 4. utilz from the worker's sidecar, once a sample covers the GPU
        deadline = time.monotonic() + WAIT_S
        while not _card_row(stack.health_base, gpu.uuid) \
                and time.monotonic() < deadline:
            time.sleep(0.1)
        run = gpumounterctl("--master", stack.health_base, "--json",
                            "utilz")
        row = next((r for r in _json(run).get("chips", [])
                    if r.get("chip") == gpu.uuid), {})
        report["utilz_row"] = row
        checks["utilz_exit_0_reads_the_gpu"] = (
            run["rc"] == 0 and row.get("duty_source") == duty_source
            and row.get("duty") is not None)
        proof.stdin.close()
        report["proof_rc"] = proof.wait(timeout=120)

        # 5. the add's stitched trace
        run = gpumounterctl("--master", base, "trace", rid)
        report["trace"] = run["stdout"]
        checks["trace_draws_master_and_worker_spans"] = (
            run["rc"] == 0
            and f"trace {rid} op=addgpu result=SUCCESS" in run["stdout"]
            and all(name in run["stdout"] for name in
                    ("resolve", "rpc", "worker:attach", "allocate",
                     "actuate")))

        # 6. node and topo (after one fleet scrape of the sidecar)
        stack.gateway.fleet.tick()
        run = gpumounterctl("--master", base, "node", NODE)
        checks["node_exit_0_names_the_uuid"] = (run["rc"] == 0
                                                and gpu.uuid in run["stdout"])
        run = gpumounterctl("--master", base, "topo")
        report["topo"] = run["stdout"]
        checks["topo_exit_0_lists_the_uuid"] = (run["rc"] == 0
                                                and gpu.uuid in run["stdout"])

        # 7. doctor
        run = gpumounterctl("--master", base, "--json", "doctor", "--node",
                            NODE)
        verdict = _json(run)
        report["doctor"] = verdict
        named: dict[str, str] = {}
        unexpected = []
        for check in verdict.get("checks", []):
            if check.get("level") == "ok":
                continue
            name = next((n for n, pattern in EXPECTED_WARNINGS.items()
                         if check.get("level") == "warn"
                         and pattern.fullmatch(check.get("message", ""))),
                        None)
            if name is None:
                unexpected.append(check)
            else:
                named[name] = check["message"]
        report["doctor_expected_warnings"] = named
        report["doctor_unexpected"] = unexpected
        checks["doctor_healthy_or_only_named_warnings"] = (
            bool(verdict.get("checks")) and not unexpected
            and run["rc"] == (1 if named else 0))

        # 8. remove
        run = gpumounterctl("--master", base, "--json", "remove",
                            "workload", "-n", "default")
        checks["remove_exit_0_no_slave_pod_left"] = (
            run["rc"] == 0 and _json(run).get("result") == "SUCCESS"
            and worker.slave_pods() == [])

        # timing: add/remove pairs, each process from start to exit
        times: dict[str, list[float]] = {"add": [], "remove": []}
        ok = True
        for _ in range(cycles):
            a = gpumounterctl("--master", base, "add", "workload",
                              "--gpus", "1")
            r = gpumounterctl("--master", base, "remove", "workload")
            ok = ok and a["rc"] == 0 and r["rc"] == 0
            times["add"].append(a["ms"])
            times["remove"].append(r["ms"])
        checks["cycles_succeed"] = ok and worker.slave_pods() == []
        report["cli_ms"] = {k: _stats(v) for k, v in times.items()}
        report["gateway_ms"] = {"add": _gateway_ms("addgpu", cycles),
                                "remove": _gateway_ms("removegpu", cycles)}
        report["version_ms"] = _stats([
            gpumounterctl("--version")["ms"] for _ in range(VERSION_RUNS)])
        report["interpreter_ms"] = _stats([
            _wall([sys.executable, "-c", "pass"])
            for _ in range(VERSION_RUNS)])

        # 9. transport failure
        run = gpumounterctl("--master", "http://127.0.0.1:1", "--timeout",
                            "5", "health")
        checks["unreachable_master_exit_10"] = run["rc"] == 10

        # 10. a lost reply, retried under the same request id
        proxy = _LossyProxy(base)
        run = gpumounterctl("--master", proxy.base, "--json", "add",
                            "workload", "--gpus", "1", "--request-id",
                            RETRY_RID, "--retries", "2")
        retried = _json(run)
        report["retry"] = {"rids": proxy.rids, "payload": retried,
                           "stderr": run["stderr"][-2000:]}
        checks["retry_same_request_id_one_slave_pod"] = (
            run["rc"] == 0 and retried.get("result") == "SUCCESS"
            and retried.get("device_ids") == [gpu.uuid]
            and proxy.rids == [RETRY_RID, RETRY_RID]
            and f"same request id {RETRY_RID}" in run["stderr"]
            and len(worker.slave_pods()) == 1)
        run = gpumounterctl("--master", base, "remove", "workload")
        checks["retried_attach_removed"] = (run["rc"] == 0
                                            and worker.slave_pods() == [])

        report["agent_fallbacks"] = _fallback_total() - fallbacks_before
        checks["agent_no_fallback"] = report["agent_fallbacks"] == 0
        report["card"] = {"uuid": gpu.uuid, "node": gpu.device_path}
        return report
    finally:
        report["checks"] = checks
        report["ok"] = bool(checks) and all(checks.values())
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
            proc.wait(timeout=60)
        if proxy is not None:
            proxy.close()
        if stack is not None:
            stack.close()
        shutil.rmtree(root, ignore_errors=True)


def _fake_rig(n: int):
    """Fake GPUs for a CPU rehearsal: the enumerator and a stub proof."""
    from gpumounter_tpu_torch.device.fake import FakeEnumerator, make_chips
    enumerator = FakeEnumerator(make_chips(n))

    def proof(gpu: GPUDevice) -> subprocess.Popen:
        env = dict(os.environ, CUDA_VISIBLE_DEVICES=gpu.uuid)
        return subprocess.Popen([sys.executable, "-c", STUB_PROOF],
                                stdin=subprocess.PIPE,
                                stdout=subprocess.PIPE, text=True, env=env)
    return enumerator, proof


def main(argv: list[str] | None = None) -> int:
    """Run :func:`run_operator` in this process and print its report as
    the last line: on this machine's GPUs (the in-pod ``flash_fwd``
    proof, NVML), or with ``--fake-gpus N`` on fake ones (a stub proof,
    NVML absent: the open-fd source)."""
    parser = argparse.ArgumentParser(
        prog="python -m gpumounter_tpu_torch.testing.operator")
    parser.add_argument("--root", required=True)
    parser.add_argument("--fake-gpus", type=int, default=0)
    parser.add_argument("--cycles", type=int, default=CYCLES)
    args = parser.parse_args(argv)
    if args.fake_gpus:
        enumerator, proof = _fake_rig(args.fake_gpus)
        report = run_operator(args.root, enumerator, proof,
                              duty_source="open-fd", cycles=args.cycles)
    else:
        from gpumounter_tpu_torch.device.enumerator import PyEnumerator
        from gpumounter_tpu_torch.testing.master_attach import cuda_proof
        from gpumounter_tpu_torch.utils.config import HostPaths
        report = run_operator(args.root, PyEnumerator(HostPaths()),
                              cuda_proof, cycles=args.cycles)
    print(json.dumps(report), flush=True)
    return 0 if report["ok"] else 1


def run_in_subprocess(root: str, fake_gpus: int = 0, cycles: int = CYCLES,
                      timeout: float = 600.0) -> dict:
    """:func:`main` in a fresh interpreter; its report (or the failure
    with the child's exit code and the end of its stderr)."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    argv = [sys.executable, "-m", "gpumounter_tpu_torch.testing.operator",
            "--root", root, "--cycles", str(cycles)]
    if fake_gpus:
        argv += ["--fake-gpus", str(fake_gpus)]
    proc = subprocess.run(argv, capture_output=True, text=True, cwd=REPO,
                          env=env, timeout=timeout)
    lines = proc.stdout.strip().splitlines()
    try:
        report = json.loads(lines[-1])
    except (IndexError, ValueError):
        return {"ok": False, "rc": proc.returncode, "checks": {},
                "error": proc.stderr[-4000:]}
    report["rc"] = proc.returncode
    return report


if __name__ == "__main__":
    sys.exit(main())
