"""Process-level boot of the port's worker: ``python -m
gpumounter_tpu_torch.worker.main`` as a subprocess against the port's HTTP
apiserver facade (through its kubeconfig client) and its PodResources
server on a unix socket, over a fixture node of four fake GPUs whose
driver proc tree names their UUIDs. It must answer ``/readyz``, attach and
detach over gRPC with REAL char nodes made in the fixture container (the
test runs as root, on tmpfs), serve its introspection routes — /utilz
from its usage sampler (open-fd detection here: no NVML) and /topoz from
its topology view, with no "not ported yet" WARNING — and stop on SIGTERM.
The mirror of tests/test_boot.py's worker half."""

import json
import os
import shutil
import signal
import socket
import stat
import subprocess
import sys
import tempfile
import time
import urllib.request

import pytest

from gpumounter_tpu_torch.actuation.cgroup import CgroupDeviceController
from gpumounter_tpu_torch.device.fake import FAKE_UVM_MAJOR, fake_uuid
from gpumounter_tpu_torch.k8s import objects
from gpumounter_tpu_torch.testing.http_apiserver import (HttpApiserver,
                                                         write_kubeconfig)
from gpumounter_tpu_torch.testing.sim import ClusterSim, make_gpu_node
from gpumounter_tpu_torch.utils.config import HostPaths
from gpumounter_tpu_torch.worker.grpc_server import WorkerClient

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PID = 4242


def _free_port_pair() -> int:
    """A port p with p + 1 (the health port) free too."""
    for _ in range(50):
        a, b = socket.socket(), socket.socket()
        try:
            a.bind(("127.0.0.1", 0))
            port = a.getsockname()[1]
            b.bind(("127.0.0.1", port + 1))
            return port
        except OSError:
            continue
        finally:
            a.close()
            b.close()
    raise RuntimeError("no free port pair")


def _get(url: str):
    with urllib.request.urlopen(url, timeout=5) as resp:
        return resp.status, resp.read().decode()


def _wait_ready(url: str, proc, timeout_s: float = 30.0) -> None:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        assert proc.poll() is None, proc.stdout.read()
        try:
            if _get(url)[0] == 200:
                return
        except OSError:
            pass
        time.sleep(0.1)
    raise AssertionError(f"{url} not ready in {timeout_s}s")


def _gpu_tree(host: HostPaths, n: int) -> None:
    """Fake nvidiaN nodes with sidecars, the companions, /proc/devices and
    the driver's information file of each GPU (its UUID)."""
    for i in range(n):
        path = os.path.join(host.dev_root, f"nvidia{i}")
        open(path, "w").close()
        with open(path + ".majmin", "w") as f:
            f.write(f"195:{i}")
        pci = f"0000:{0x18 + i:02x}:00.0"
        info = os.path.join(host.proc_root, "driver", "nvidia", "gpus", pci)
        os.makedirs(info)
        with open(os.path.join(info, "information"), "w") as f:
            f.write(f"GPU UUID: \t {fake_uuid(i)}\n"
                    f"Bus Location: \t {pci}\nDevice Minor: \t {i}\n")
    for name, majmin in (("nvidiactl", "195:255"),
                         ("nvidia-uvm", f"{FAKE_UVM_MAJOR}:0"),
                         ("nvidia-uvm-tools", f"{FAKE_UVM_MAJOR}:1")):
        path = os.path.join(host.dev_root, name)
        open(path, "w").close()
        with open(path + ".majmin", "w") as f:
            f.write(majmin)
    with open(os.path.join(host.proc_root, "devices"), "w") as f:
        f.write(f"Character devices:\n195 nvidia\n195 nvidiactl\n"
                f"{FAKE_UVM_MAJOR} nvidia-uvm\n\nBlock devices:\n")


@pytest.fixture
def node(request):
    """A fixture node on tmpfs (real mknod needs a filesystem that takes
    char nodes), a facade, a kubelet socket and one target container; an
    indirect parameter adds to the worker's environment."""
    if os.geteuid() != 0:
        pytest.skip("the worker makes real char nodes: needs root")
    base = "/dev/shm" if os.access("/dev/shm", os.W_OK) else None
    root = tempfile.mkdtemp(prefix="gpumounter-boot-", dir=base)
    host = HostPaths(dev_root=os.path.join(root, "dev"),
                     proc_root=os.path.join(root, "proc"),
                     sys_root=os.path.join(root, "sys"),
                     cgroup_root=os.path.join(root, "sys", "fs", "cgroup"),
                     kubelet_socket=os.path.join(root, "kubelet.sock"))
    for d in (host.dev_root, host.proc_root, host.cgroup_root):
        os.makedirs(d)
    _gpu_tree(host, 4)
    sim = ClusterSim(n_chips=4, kubelet_socket_path=host.kubelet_socket)
    sim.kube.put_node(make_gpu_node("node-a", gpus=4))
    api = HttpApiserver(sim.kube)
    pod = sim.add_target_pod(name="workload")
    cgroups = CgroupDeviceController(host, driver="cgroupfs", version=1)
    cgroup_dir = cgroups.container_dir(pod, objects.container_ids(pod)[0])
    os.makedirs(cgroup_dir)
    with open(os.path.join(cgroup_dir, "cgroup.procs"), "w") as f:
        f.write(f"{PID}\n")
    os.makedirs(os.path.join(host.proc_root, str(PID), "root", "dev"))
    port = _free_port_pair()
    env = {k: v for k, v in os.environ.items()
           if k not in ("KUBERNETES_SERVICE_HOST", "TPU_USAGE",
                        "TPU_TOPOLOGY", "TPU_WARM_POOL")}
    env.update({
        "KUBECONFIG": write_kubeconfig(os.path.join(root, "kubeconfig"),
                                       api.base),
        "PYTHONPATH": REPO, "TPU_ALLOW_FAKE_DEVICES": "1",
        "CGROUP_DRIVER": "cgroupfs", "NODE_NAME": "node-a",
        "TPU_DEV_ROOT": host.dev_root, "TPU_PROC_ROOT": host.proc_root,
        "TPU_SYS_ROOT": host.sys_root, "TPU_CGROUP_ROOT": host.cgroup_root,
        "TPU_KUBELET_SOCKET": host.kubelet_socket,
        "TPU_WORKER_GRPC_PORT": str(port),
        "TPU_JOURNAL_PATH": os.path.join(root, "journal.jsonl"),
        "TPU_ALLOCATION_TIMEOUT_S": "20", "TPU_USAGE_INTERVAL_S": "0.2"})
    env.update(getattr(request, "param", {}))
    proc = subprocess.Popen(
        [sys.executable, "-m", "gpumounter_tpu_torch.worker.main"],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    yield {"proc": proc, "port": port, "host": host, "sim": sim,
           "cgroup_dir": cgroup_dir}
    if proc.poll() is None:
        proc.kill()
    proc.wait(timeout=30)
    proc.stdout.close()
    api.close()
    sim.close()
    shutil.rmtree(root, ignore_errors=True)


def _container_nodes(host: HostPaths) -> dict[str, tuple[int, int]]:
    dev = os.path.join(host.proc_root, str(PID), "root", "dev")
    out = {}
    for name in sorted(os.listdir(dev)):
        st = os.lstat(os.path.join(dev, name))
        assert stat.S_ISCHR(st.st_mode), name     # a real char node
        out[name] = (os.major(st.st_rdev), os.minor(st.st_rdev))
    return out


def test_worker_boots_attaches_and_detaches(node):
    proc, port, host = node["proc"], node["port"], node["host"]
    health = f"http://127.0.0.1:{port + 1}"
    _wait_ready(f"{health}/readyz", proc)
    assert _get(f"{health}/healthz") == (200, "ok")
    client = WorkerClient(f"127.0.0.1:{port}", timeout_s=30)
    try:
        resp = client.add_gpu("workload", "default", 2, request_id="boot-1")
        assert resp.result == 0, resp
        assert list(resp.device_ids) == [fake_uuid(0), fake_uuid(1)]
        assert list(resp.device_paths) == ["/dev/nvidia0", "/dev/nvidia1"]
        assert _container_nodes(host) == {
            "nvidia0": (195, 0), "nvidia1": (195, 1),
            "nvidiactl": (195, 255), "nvidia-uvm": (FAKE_UVM_MAJOR, 0),
            "nvidia-uvm-tools": (FAKE_UVM_MAJOR, 1)}
        with open(os.path.join(node["cgroup_dir"], "devices.allow")) as f:
            assert "c 195:0 rw" in f.read().splitlines()
        slaves = node["sim"].slave_pods()        # single mount: one each
        assert len(slaves) == 2
        for slave in slaves:
            assert slave["spec"]["tolerations"][0]["key"] == \
                "nvidia.com/gpu"
            assert slave["metadata"]["labels"][
                "tpumounter.io/gpu-accelerator"] == "nvidia-h100-80gb"

        agentz = json.loads(_get(f"{health}/agentz")[1])
        assert agentz["enabled"] and agentz["counters"]["fallbacks"] == 0
        gatez = json.loads(_get(f"{health}/gatez")[1])
        assert gatez["backend"] == "cgroup-v1"
        assert json.loads(_get(f"{health}/journalz")[1])["backlog"] == 0
        assert json.loads(_get(f"{health}/cachez")[1])["enabled"]
        assert json.loads(_get(f"{health}/poolz")[1]) == {"enabled": False}
        topoz = json.loads(_get(f"{health}/topoz")[1])
        assert (topoz["node"], topoz["accelerator"], topoz["gpus_per_node"],
                topoz["mesh"]) == ("node-a", "nvidia-h100-80gb", 4, [1, 4])
        assert [(c["chip"], c["state"], c.get("owner")) for c in
                topoz["chips"]] == [
            (fake_uuid(0), "leased", "default/workload"),
            (fake_uuid(1), "leased", "default/workload"),
            (fake_uuid(2), "free", None), (fake_uuid(3), "free", None)]
        deadline = time.monotonic() + 20
        while True:
            utilz = json.loads(_get(f"{health}/utilz")[1])
            if len(utilz["chips"]) == 4 or time.monotonic() > deadline:
                break
            time.sleep(0.1)
        assert utilz["enabled"] and utilz["node"] == "node-a"
        assert {(c["duty_source"], c["busy"]) for c in utilz["chips"]} == \
            {("open-fd", False)}
        metrics = _get(f"{health}/metrics")[1]
        assert 'tpumounter_attach_total{result="SUCCESS"} 1' in metrics

        out = client.remove_gpu("workload", "default")
        assert out.result == 0
        assert _container_nodes(host) == {}
        assert node["sim"].slave_pods() == []
    finally:
        client.close()
    proc.send_signal(signal.SIGTERM)
    assert proc.wait(timeout=30) in (0, -signal.SIGTERM)
    log = proc.stdout.read()
    assert "not ported yet" not in log, log[-3000:]
    assert "Queue 1 item 12" not in log, log[-3000:]


@pytest.mark.parametrize("node", [{"TPU_WARM_POOL": "single:1=1",
                                   "TPU_WARM_POOL_INTERVAL_S": "0.2"}],
                         indirect=True)
def test_worker_boots_with_a_warm_pool(node):
    """``TPU_WARM_POOL`` builds the pool as the control plane's worker
    does: ``/poolz`` reports it, a fitting attach adopts the warm pod, and
    the pool refills."""
    proc, port = node["proc"], node["port"]
    health = f"http://127.0.0.1:{port + 1}"
    _wait_ready(f"{health}/readyz", proc)

    def poolz():
        return json.loads(_get(f"{health}/poolz")[1])

    deadline = time.monotonic() + 30
    while poolz()["keys"]["single:1"]["running"] < 1:
        assert time.monotonic() < deadline, poolz()
        time.sleep(0.1)
    assert poolz()["enabled"] is True
    client = WorkerClient(f"127.0.0.1:{port}", timeout_s=30)
    try:
        resp = client.add_gpu("workload", "default", 1, request_id="warm-1")
        assert resp.result == 0, resp
        metrics = _get(f"{health}/metrics")[1]
        assert "tpumounter_pool_hits_total 1" in metrics
        deadline = time.monotonic() + 30
        while poolz()["keys"]["single:1"]["running"] < 1:
            assert time.monotonic() < deadline, poolz()
            time.sleep(0.1)
        assert client.remove_gpu("workload", "default").result == 0
    finally:
        client.close()
    proc.send_signal(signal.SIGTERM)
    assert proc.wait(timeout=30) in (0, -signal.SIGTERM)
