"""The payloads and renders the GPU operator guide shows
(``docs/guide/gpu/``), produced by the port on one node.

:func:`run_guide_views` puts the operator rig's master and worker
(:mod:`.operator`'s stack: the worker over an HTTP apiserver facade, its
health sidecar with the usage sampler and the topology view, the master
with its broker) in front of whatever enumerator the caller passes. The
broker runs with a quota, a lease TTL and a queue. Then, as an operator
would:

1. ``gpumounterctl add`` one GPU to an idle workload pod (its tenant is
   its namespace, ``default``), and the in-pod proof loads that GPU;
2. while it computes: the worker's ``/utilz``, ``/topoz``, ``/gatez``,
   ``/agentz``, ``/cachez``, ``/journalz``, ``/eventz``; the master's
   ``/gpustatus``, ``/nodestatus``, ``/brokerz`` and, after one fleet
   tick, ``/fleetz`` and ``/topoz``; ``gpumounterctl status``, ``node``,
   ``utilz``, ``topo``, ``trace`` and ``fleet``;
3. a second pod asks for the same GPU and parks in the broker's queue
   (``/brokerz`` while it waits); ``gpumounterctl remove`` of the first
   hands the GPU over, and the parked attach returns with ``queued_s``.

Each view is written to ``<out>/<name>.json`` or ``<name>.txt``, and the
report (the names, the checks) is returned. Run it in a fresh process
(``python -m gpumounter_tpu_torch.testing.guide_views``): registries and
the event ring are the process's.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import threading
import time
from collections.abc import Callable

from gpumounter_tpu_torch.device.enumerator import Enumerator
from gpumounter_tpu_torch.device.model import GPUDevice
from gpumounter_tpu_torch.testing.master_attach import _http
from gpumounter_tpu_torch.testing.operator import (_fake_rig, _json,
                                                   _OperatorStack,
                                                   gpumounterctl)
from gpumounter_tpu_torch.testing.worker_attach import IDLE, NODE, spawn

QUOTAS = {"default": 2, "*": 1}
LEASE_TTL_S = 3600.0
QUEUE_TIMEOUT_S = 60.0
WAIT_S = 30.0


class _BrokeredStack(_OperatorStack):
    """The operator stack whose broker has a quota, a lease TTL and a
    queue (the worker's settings, read when the master is built)."""

    def _sidecar_state(self) -> dict:
        settings = self.worker.settings
        settings.tenant_quotas = dict(QUOTAS)
        settings.lease_ttl_s = LEASE_TTL_S
        settings.queue_timeout_s = QUEUE_TIMEOUT_S
        return super()._sidecar_state()


def _write(out: str, name: str, view) -> None:
    if isinstance(view, (dict, list)):
        path, text = os.path.join(out, name + ".json"), json.dumps(
            view, indent=1, sort_keys=True)
    else:
        path, text = os.path.join(out, name + ".txt"), str(view)
    with open(path, "w") as f:
        f.write(text + "\n")


def run_guide_views(out: str, root: str, enumerator: Enumerator,
                    spawn_proof: Callable[[GPUDevice], subprocess.Popen]
                    ) -> dict:
    """Write the guide's views to ``out`` (see the module docstring); the
    rig lives under ``root`` (removed first and afterwards)."""
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(out, exist_ok=True)
    procs: list[subprocess.Popen] = []
    checks: dict[str, bool] = {}
    stack = None
    try:
        stack = _BrokeredStack(root, enumerator)
        worker, base, side = stack.worker, stack.base, stack.health_base
        for name in ("workload", "second"):
            idle = spawn(IDLE)
            procs.append(idle)
            worker.add_target(worker.node.container(name, [idle.pid]))
        stack.usage.start()

        run = gpumounterctl("--master", base, "--json", "add", "workload",
                            "-n", "default", "--gpus", "1")
        add = _json(run)
        _write(out, "add", add)
        checks["add"] = add.get("result") == "SUCCESS"
        gpu = next((d for d in enumerator.enumerate()
                    if d.uuid in (add.get("device_ids") or [])), None)
        if gpu is None:
            return {"checks": checks}
        proof = spawn_proof(gpu)
        procs.append(proof)
        checks["proof"] = bool(json.loads(proof.stdout.readline()
                                          or "{}").get("ok"))
        deadline = time.monotonic() + WAIT_S
        while time.monotonic() < deadline:
            _, utilz = _http("GET", side + "/utilz")
            row = next((r for r in utilz.get("chips", [])
                        if r.get("chip") == gpu.uuid), {})
            if row.get("duty") is not None:
                break
            time.sleep(0.2)

        for path in ("/utilz", "/topoz", "/gatez", "/agentz", "/cachez",
                     "/journalz"):
            _write(out, "worker" + path.replace("/", "_"),
                   _http("GET", side + path)[1])
        _write(out, "worker_eventz",
               _http("GET", side + "/eventz?since=0&limit=8")[1])
        _write(out, "gpustatus", _http(
            "GET", base + "/gpustatus/namespace/default/pod/workload")[1])
        _write(out, "nodestatus",
               _http("GET", base + f"/nodestatus/node/{NODE}")[1])
        _write(out, "brokerz_leased", _http("GET", base + "/brokerz")[1])
        stack.gateway.fleet.tick()
        _write(out, "fleetz", _http("GET", base + "/fleetz?limit=4")[1])
        _write(out, "master_topoz", _http("GET", base + "/topoz")[1])
        for name, argv in (
                ("ctl_status", ["status", "workload", "-n", "default"]),
                ("ctl_node", ["node", NODE]), ("ctl_topo", ["topo"]),
                ("ctl_trace", ["trace", add.get("request_id", "")]),
                ("ctl_fleet", ["fleet", "--events", "4"])):
            _write(out, name, gpumounterctl("--master", base, *argv)
                   ["stdout"])
        _write(out, "ctl_utilz", gpumounterctl("--master", side, "utilz")
               ["stdout"])
        proof.stdin.close()
        proof.wait(timeout=120)

        # the same GPU asked for by a second pod: it parks
        parked: dict = {}

        def second() -> None:
            parked.update(_json(gpumounterctl(
                "--master", base, "--json", "add", "second", "-n",
                "default", "--gpus", "1")))
        thread = threading.Thread(target=second)
        thread.start()
        deadline = time.monotonic() + WAIT_S
        brokerz: dict = {}
        while time.monotonic() < deadline:
            brokerz = _http("GET", base + "/brokerz")[1]
            if brokerz.get("queue", {}).get("waiters"):
                break
            time.sleep(0.1)
        _write(out, "brokerz_queued", brokerz)
        checks["parked"] = bool(brokerz.get("queue", {}).get("waiters"))
        run = gpumounterctl("--master", base, "--json", "remove",
                            "workload", "-n", "default")
        checks["remove"] = _json(run).get("result") == "SUCCESS"
        thread.join(timeout=QUEUE_TIMEOUT_S + 30)
        _write(out, "add_after_queue", parked)
        checks["handed_over"] = (parked.get("result") == "SUCCESS"
                                 and parked.get("device_ids") == [gpu.uuid])
        _write(out, "master_eventz",
               _http("GET", base + "/eventz?since=0&limit=512")[1])
        gpumounterctl("--master", base, "remove", "second", "-n",
                      "default")
        return {"checks": checks, "card": {"uuid": gpu.uuid,
                                            "node": gpu.device_path}}
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
            proc.wait(timeout=60)
        if stack is not None:
            stack.close()
        shutil.rmtree(root, ignore_errors=True)


def main(argv: list[str] | None = None) -> int:
    """Run :func:`run_guide_views` on this machine's GPUs (the in-pod
    ``flash_fwd`` proof, NVML) or, with ``--fake-gpus N``, on fake ones;
    print the report as the last line."""
    parser = argparse.ArgumentParser(
        prog="python -m gpumounter_tpu_torch.testing.guide_views")
    parser.add_argument("--out", required=True)
    parser.add_argument("--root", required=True)
    parser.add_argument("--fake-gpus", type=int, default=0)
    args = parser.parse_args(argv)
    if args.fake_gpus:
        enumerator, proof = _fake_rig(args.fake_gpus)
    else:
        from gpumounter_tpu_torch.device.enumerator import PyEnumerator
        from gpumounter_tpu_torch.testing.master_attach import cuda_proof
        from gpumounter_tpu_torch.utils.config import HostPaths
        enumerator, proof = PyEnumerator(HostPaths()), cuda_proof
    report = run_guide_views(args.out, args.root, enumerator, proof)
    report["ok"] = bool(report["checks"]) and all(
        report["checks"].values())
    print(json.dumps(report), flush=True)
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
