"""Process-level boot of the port's master: ``python -m
gpumounter_tpu_torch.master.main`` as a subprocess against the port's HTTP
apiserver facade (through its kubeconfig client), in front of a live
in-process gRPC worker over a WorkerRig. It must answer ``/healthz``,
attach and detach over the reference's HTTP routes, serve every plane the
environment asks for (the topology plane's ``/topoz`` and the
defragmenter's ``/fleetz`` section by default) with no "not ported yet"
WARNING, and stop on SIGINT; with the HA plane asked for, it leads its
shards and writes its leases through the intent store. The mirror of
tests/test_boot.py's master half."""

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


def _boot(tmp_path, extra_env=None):
    """The master as a subprocess against the facade, in front of a live
    worker; returns (proc, base, rig, closer)."""
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
    env.update(extra_env or {})
    proc = subprocess.Popen(
        [sys.executable, "-m", "gpumounter_tpu_torch.master.main"],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)

    def close():
        if proc.poll() is None:
            proc.kill()
        proc.wait(timeout=30)
        proc.stdout.close()
        api.close()
        server.stop(grace=0)
        rig.close()
    return proc, f"http://127.0.0.1:{port}", rig, close


@pytest.fixture
def master(tmp_path):
    proc, base, rig, close = _boot(tmp_path)
    yield proc, base, rig
    close()


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
    assert _call(base + "/addgpuslice", b"{}")[0] == 400
    status, body = _call(base + "/removegpu/namespace/default/pod/workload"
                                "/force/false", b"")
    assert status == 200 and body["result"] == "SUCCESS"
    assert rig.sim.slave_pods() == []
    assert _call(base + "/version")[1]["version"] == "0.1.0"
    status, topoz = _call(base + "/topoz")
    assert status == 200 and topoz["enabled"] is True
    assert _call(base + "/fleetz")[1]["defrag"]["mode"] == "plan"
    proc.send_signal(signal.SIGINT)
    assert proc.wait(timeout=30) == 0
    log = proc.stdout.read()
    assert "not ported yet" not in log, log[-3000:]
    assert "Queue 1 item 12" not in log, log[-3000:]


@pytest.mark.parametrize("env,expect", [
    ({"TPU_NODE_HEALTH": "0", "TPU_TOPOLOGY": "0"}, []),
    ({"TPU_NODE_HEALTH": "0", "TPU_TOPOLOGY": "0",
      "TPU_MASTER_SHARDS": "2"}, []),
    ({"TPU_NODE_HEALTH": "0", "TPU_TOPOLOGY": "0", "TPU_ELECTION": "1"},
     []),
    ({"TPU_TOPOLOGY": "0"}, ["nodehealth"]),
    ({"TPU_NODE_HEALTH": "0"}, ["topology", "defrag"]),
    ({"TPU_DEFRAG_MODE": "0"}, ["nodehealth", "topology"]),
    ({}, ["nodehealth", "topology", "defrag"]),
])
def test_unported_planes_are_named(env, expect, monkeypatch):
    """No plane is left unported: the master the entry point builds for
    each environment runs exactly the planes it asks for (node health,
    the topology plane, the defragmenter), and the entry point has no
    list of planes it would have to name as missing."""
    from gpumounter_tpu_torch.k8s.client import FakeKubeClient
    from gpumounter_tpu_torch.master import main as main_mod
    from gpumounter_tpu_torch.master.discovery import WorkerDirectory
    from gpumounter_tpu_torch.master.gateway import MasterGateway
    from gpumounter_tpu_torch.master.shardring import HAConfig
    for key in ("TPU_NODE_HEALTH", "TPU_TOPOLOGY", "TPU_DEFRAG_MODE",
                "TPU_MASTER_SHARDS", "TPU_ELECTION"):
        monkeypatch.delenv(key, raising=False)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    assert not hasattr(main_mod, "unported_planes")
    kube = FakeKubeClient()
    gateway = MasterGateway(kube, WorkerDirectory(kube),
                            ha=HAConfig.from_settings(
                                Settings.from_env(env)))
    built = [name for name in ("nodehealth", "topology", "defrag")
             if getattr(gateway, name) is not None]
    assert built == expect


def test_master_boots_with_the_ha_plane(tmp_path):
    """``TPU_MASTER_SHARDS=2 TPU_ELECTION=1 TPU_INTENT_STORE=1``: the
    entry point builds ``HAConfig.from_settings``; the replica leads both
    shards, its attach lands a lease record in the shard's state
    ConfigMap, and no plane is reported missing."""
    from gpumounter_tpu_torch.master.shardring import ShardRing
    from gpumounter_tpu_torch.utils import consts
    from gpumounter_tpu_torch.utils.errors import K8sApiError
    proc, base, rig, close = _boot(tmp_path, {
        "TPU_NODE_HEALTH": "0", "TPU_TOPOLOGY": "0",
        "TPU_MASTER_SHARDS": "2", "TPU_ELECTION": "1",
        "TPU_INTENT_STORE": "1", "TPU_ELECTION_RENEW_S": "0.2",
        "TPU_ELECTION_TTL_S": "0.6", "TPU_REPLICA_ID": "m-boot"})
    try:
        _wait_ready(base, proc)
        deadline = time.monotonic() + 15
        while True:
            masters = _call(base + "/fleetz")[1]["masters"]
            shards = masters["election"]["shards"]
            if all(v["leader"] for v in shards.values()):
                break
            assert time.monotonic() < deadline, masters
            time.sleep(0.1)
        assert masters["replica"] == "m-boot" and len(shards) == 2
        status, body = _call(base + "/addgpu/namespace/default/pod/workload"
                                    "/gpu/2/isEntireMount/true")
        assert status == 200 and body["result"] == "SUCCESS", body
        assert _call(base + "/brokerz")[1]["ha"]["shards"] == 2
        name = (consts.STORE_CONFIGMAP_PREFIX
                + str(ShardRing(2).shard_of("default")))

        def lease_records():
            # group commit (on by default) lands the write within 10 ms
            try:
                cm = rig.sim.kube.get_config_map(Settings().pool_namespace,
                                                 name)
            except K8sApiError:       # not written yet
                return []
            return [k for k in cm["metadata"].get("annotations") or {}
                    if k.startswith(consts.STORE_LEASE_ANNOTATION_PREFIX)]
        deadline = time.monotonic() + 10
        while not lease_records():
            assert time.monotonic() < deadline, "no lease record"
            time.sleep(0.05)
        status, body = _call(base + "/removegpu/namespace/default/pod/"
                                    "workload/force/false", b"")
        assert status == 200 and body["result"] == "SUCCESS"
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=30) == 0
        log = proc.stdout.read()
        assert "not ported yet" not in log
        assert "shards=2 election=on store=on replica=m-boot" in log
    finally:
        close()
