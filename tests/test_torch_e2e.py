"""End to end over HTTP through the port (the mirror of tests/test_e2e.py):
a curl-equivalent ``GET /addgpu/...`` to the port's master, real gRPC to
its worker, the allocator against a scripted scheduler whose PodResources
listing the collector reads over a real unix-socket kubelet, the device
gate (fake backend, playing the kernel) and device nodes made in a
fixture container root. The same flow through the control plane's
``LiveStack`` (``/addgpu`` is its alias of ``/addtpu``) gives the same
answers after the GPU mapping."""

import json
import os
import urllib.error
import urllib.request

import pytest

from gpumounter_tpu_torch.actuation.bpf import CONTAINER_DEFAULT_RULES
from tests.torch_control_plane import (BOTH, IDS, TORCH, norm_path,
                                       norm_result)

ADD4 = "/addgpu/namespace/default/pod/workload/gpu/4/isEntireMount/true"
ADD1 = "/addgpu/namespace/default/pod/workload/gpu/1/isEntireMount/false"
REMOVE = "/removegpu/namespace/default/pod/workload/force/false"
UVM = TORCH.mod("device.fake").FAKE_UVM_MAJOR


@pytest.fixture(params=BOTH, ids=IDS)
def pkg(request):
    return request.param


@pytest.fixture
def live(pkg, tmp_path):
    """Everything live on localhost: HTTP master + gRPC worker, with the
    collector reading a real unix-socket kubelet."""
    stack = pkg.mod("testing.sim").LiveStack(pkg.rig(
        tmp_path, actuator="procroot", gate="fake", use_kubelet_socket=True))
    yield stack
    stack.close()


def _call(url, data: bytes | None = None):
    req = urllib.request.Request(url, data=data,
                                 method="POST" if data is not None
                                 else "GET")
    try:
        with urllib.request.urlopen(req) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _container_dev(rig) -> str:
    return os.path.join(rig.host.proc_root, str(rig.pid), "root", "dev")


# the fake gate's map holds the container defaults (/dev/null, ptys, ...)
# beside the grants
DEFAULTS = {(r.major, r.minor) for r in CONTAINER_DEFAULT_RULES}


def _gate_pairs(rig) -> set:
    """The (major, minor) pairs the gate grants the container beyond the
    container defaults."""
    key = rig.cgroups.container_dir(rig.pod, rig.pod["status"][
        "containerStatuses"][0]["containerID"].split("//", 1)[1])
    live, _opens, _denies = rig.gate_backend.read(key)
    return {(k[1], k[2]) for k in live} - DEFAULTS


def _flow(pkg, live) -> list:
    """The QuickStart flow: attach 4 as an entire mount, detach them,
    attach 1 again; returns a device-mapped transcript."""
    rig, base = live.rig, live.base
    out = []
    status, body = _call(base + ADD4)
    out.append((status, body["result"],
                sorted(norm_path(p) for p in body["device_paths"])))
    out.append(("slave_pods", len(rig.sim.slave_pods())))
    out.append(("created", sorted(norm_path(p) for p in os.listdir(
        _container_dev(rig)) if not p.endswith(".majmin"))))
    out.append(("gate", len(_gate_pairs(rig))))
    status, body = _call(base + REMOVE,
                         json.dumps({"uuids": body["device_ids"]}).encode())
    out.append((status, body["result"], len(rig.sim.slave_pods()),
                len(rig.sim.podresources.assignments),
                len(_gate_pairs(rig)), os.listdir(_container_dev(rig))))
    status, body = _call(base + ADD1)
    out.append((status, norm_result(body["result"])))
    return out


def test_full_attach_detach_over_http(live):
    rig, base = live.rig, live.base
    status, body = _call(base + ADD4)
    assert status == 200 and body["result"] == "SUCCESS"
    assert sorted(norm_path(p) for p in body["device_paths"]) == [
        "dev0", "dev1", "dev2", "dev3"]
    assert len(rig.sim.slave_pods()) == 1
    status, body = _call(base + REMOVE,
                         json.dumps({"uuids": body["device_ids"]}).encode())
    assert status == 200 and body["result"] == "SUCCESS"
    assert rig.sim.slave_pods() == []
    assert rig.sim.podresources.assignments == {}
    assert os.listdir(_container_dev(rig)) == []
    assert _call(base + ADD1)[0] == 200


def test_the_gate_and_the_nodes_hold_the_gpus_and_companions(tmp_path):
    """The port's half: ``c 195:N`` for each GPU plus the companions
    (nvidiactl 195:255, the uvm pair) in the gate; ``nvidiaN`` and the
    companion nodes under ``<root>/proc/<pid>/root/dev/``; all of it gone
    after the detach."""
    stack = TORCH.mod("testing.sim").LiveStack(TORCH.rig(
        tmp_path, actuator="procroot", gate="fake", use_kubelet_socket=True))
    try:
        rig = stack.rig
        status, body = _call(stack.base + ADD4)
        assert status == 200 and body["device_paths"] == [
            f"/dev/nvidia{i}" for i in range(4)]
        assert body["device_ids"] == [
            TORCH.mod("device.fake").fake_uuid(i) for i in range(4)]
        assert _gate_pairs(rig) == {(195, i) for i in range(4)} | {
            (195, 255), (UVM, 0), (UVM, 1)}
        dev = _container_dev(rig)
        names = ([f"nvidia{i}" for i in range(4)]
                 + ["nvidiactl", "nvidia-uvm", "nvidia-uvm-tools"])
        assert sorted(os.listdir(dev)) == sorted(
            names + [n + ".majmin" for n in names])
        with open(os.path.join(dev, "nvidia2.majmin")) as f:
            assert f.read().strip() == "195:2"
        with open(os.path.join(dev, "nvidiactl.majmin")) as f:
            assert f.read().strip() == "195:255"
        status, body = _call(stack.base + REMOVE, b"")
        assert status == 200 and body["result"] == "SUCCESS"
        assert _gate_pairs(rig) == set() and os.listdir(dev) == []
    finally:
        stack.close()


def test_both_packages_answer_the_flow_alike(tmp_path):
    out = []
    for p in BOTH:
        stack = p.mod("testing.sim").LiveStack(p.rig(
            tmp_path / p.name, actuator="procroot", gate="fake",
            use_kubelet_socket=True))
        try:
            out.append(_flow(p, stack))
        finally:
            stack.close()
    jax_side, torch_side = out
    # the GPU also carries the companions every GPU shares: 3 more nodes
    # and 3 more gate rules than the TPU's 4 chips
    assert torch_side[2] == ("created", sorted(
        ["dev0", "dev1", "dev2", "dev3", "ctl", "uvm", "uvm-tools"]))
    assert torch_side[3] == ("gate", 7)
    assert jax_side[2] == ("created", ["dev0", "dev1", "dev2", "dev3"])
    assert jax_side[3] == ("gate", 4)
    for i in (0, 1, 4, 5):
        assert jax_side[i] == torch_side[i]


def test_metrics_exposed_over_http(live):
    _call(live.base + ADD1)
    with urllib.request.urlopen(f"{live.base}/metrics") as resp:
        text = resp.read().decode()
    assert "tpumounter_attach_seconds_bucket" in text
    assert 'tpumounter_attach_total{result="master_SUCCESS"}' in text


def test_healthz(live):
    status, body = _call(live.base + "/healthz")
    assert status == 200 and body["status"] == "ok"
