"""Process-level boot of the port's master: ``python -m
gpumounter_tpu_torch.master.main`` as a subprocess against the port's HTTP
apiserver facade (through its kubeconfig client), in front of a live
in-process gRPC worker over a WorkerRig. It must answer ``/healthz``,
attach and detach over the reference's HTTP routes, log ONE WARNING
naming the planes the environment asks for that are not ported yet, and
stop on SIGINT. The mirror of tests/test_boot.py's master half."""

import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request

import pytest

from gpumounter_tpu_torch.master.main import unported_planes
from gpumounter_tpu_torch.testing.http_apiserver import (HttpApiserver,
                                                         write_kubeconfig)
from gpumounter_tpu_torch.testing.sim import WorkerRig, worker_pod
from gpumounter_tpu_torch.utils.config import HostPaths, Settings
from gpumounter_tpu_torch.worker.grpc_server import build_server

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _call(url, data=None):
    req = urllib.request.Request(url, data=data,
                                 method="POST" if data is not None
                                 else "GET")
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.fixture
def master(tmp_path):
    root = str(tmp_path)
    host = HostPaths(dev_root=f"{root}/dev", proc_root=f"{root}/proc",
                     sys_root=f"{root}/sys",
                     cgroup_root=f"{root}/sys/fs/cgroup",
                     kubelet_socket=f"{root}/kubelet.sock")
    for d in (host.dev_root, host.proc_root, host.cgroup_root):
        os.makedirs(d, exist_ok=True)
    rig = WorkerRig(host)
    server, grpc_port = build_server(rig.service, port=0,
                                     address="127.0.0.1")
    server.start()
    rig.sim.kube.put_pod(worker_pod("node-a", "127.0.0.1",
                                    grpc_port=grpc_port))
    api = HttpApiserver(rig.sim.kube)
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("KUBERNETES_SERVICE_HOST", "TPU_NODE_HEALTH",
                        "TPU_TOPOLOGY", "TPU_MASTER_SHARDS")}
    env.update({"KUBECONFIG": write_kubeconfig(f"{root}/kubeconfig",
                                               api.base),
                "PYTHONPATH": REPO, "TPU_MASTER_HTTP_PORT": str(port),
                "TPU_FLEET_INTERVAL_S": "3600"})
    proc = subprocess.Popen(
        [sys.executable, "-m", "gpumounter_tpu_torch.master.main"],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    yield proc, f"http://127.0.0.1:{port}", rig
    if proc.poll() is None:
        proc.kill()
    proc.wait(timeout=30)
    proc.stdout.close()
    api.close()
    server.stop(grace=0)
    rig.close()


def _wait_ready(base, proc, timeout_s=30.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        assert proc.poll() is None, proc.stdout.read()
        try:
            if _call(base + "/healthz")[0] == 200:
                return
        except OSError:
            pass
        time.sleep(0.1)
    raise AssertionError(f"{base} not ready in {timeout_s}s")


def test_master_boots_attaches_detaches_and_stops(master):
    proc, base, rig = master
    _wait_ready(base, proc)
    status, body = _call(base + "/addgpu/namespace/default/pod/workload"
                                "/gpu/2/isEntireMount/true")
    assert status == 200 and body["result"] == "SUCCESS", body
    assert body["device_paths"] == ["/dev/nvidia0", "/dev/nvidia1"]
    assert len(rig.sim.slave_pods()) == 1
    status, body = _call(base + "/brokerz")
    assert status == 200 and body["leases"]["count"] == 1
    assert _call(base + "/addgpuslice", b"{}")[0] == 501
    status, body = _call(base + "/removegpu/namespace/default/pod/workload"
                                "/force/false", b"")
    assert status == 200 and body["result"] == "SUCCESS"
    assert rig.sim.slave_pods() == []
    assert _call(base + "/version")[1]["version"] == "0.1.0"
    proc.send_signal(signal.SIGINT)
    assert proc.wait(timeout=30) == 0
    log = proc.stdout.read()
    warnings = [line for line in log.splitlines()
                if "WARNING" in line and "not ported yet" in line]
    assert len(warnings) == 1, log[-3000:]
    assert "Queue 1 item 12c" in warnings[0]     # node health
    assert "Queue 1 item 12d" in warnings[0]     # topology
    assert "item 12b" not in warnings[0]         # no HA asked for


@pytest.mark.parametrize("env,expect", [
    ({"TPU_NODE_HEALTH": "0", "TPU_TOPOLOGY": "0"}, []),
    ({"TPU_NODE_HEALTH": "0", "TPU_TOPOLOGY": "0",
      "TPU_MASTER_SHARDS": "2"}, ["12b"]),
    ({"TPU_NODE_HEALTH": "0", "TPU_TOPOLOGY": "0", "TPU_ELECTION": "1"},
     ["12b"]),
    ({"TPU_TOPOLOGY": "0"}, ["12c"]),
    ({"TPU_NODE_HEALTH": "0"}, ["12d"]),
    ({}, ["12c", "12d"]),
])
def test_unported_planes_are_named(env, expect):
    asked = unported_planes(Settings.from_env(env), env)
    assert [a.rsplit("item ", 1)[1].rstrip(")") for a in asked] == expect
