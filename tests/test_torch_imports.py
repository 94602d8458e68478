"""The port stands alone: no module of gpumounter_tpu_torch, and not
chip_smoke.py, imports jax, optax or the JAX package; and its entry points
run on the GPU or raise, unless the caller asks for the CPU."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "gpumounter_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "optax", "gpumounter_tpu")


def _forbidden(module: str) -> bool:
    return module.split(".")[0] in FORBIDDEN


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_forbidden_import_in_source(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path.name}:{node.lineno} imports {bad}"


def test_no_forbidden_module_loaded_at_run_time():
    """Import every port module and chip_smoke in a fresh interpreter, then
    check what actually landed in sys.modules."""
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        .removesuffix(".__init__")
        for p in PORT_FILES if p.name != "chip_smoke.py")
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        # the native loader and the NVML reader run, not only import
        "from gpumounter_tpu_torch.device import enumerator, "
        "native_enumerator\n"
        "native_enumerator.load_library()\n"
        "enumerator.gpu_identities('/proc')\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=REPO, env=env, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-2000:]


@pytest.mark.parametrize("module", [
    "gpumounter_tpu_torch/device/model.py",
    "gpumounter_tpu_torch/device/enumerator.py",
    "gpumounter_tpu_torch/device/native_enumerator.py",
    "gpumounter_tpu_torch/device/fake.py",
    "gpumounter_tpu_torch/device/plan.py",
    "gpumounter_tpu_torch/utils/config.py",
    "gpumounter_tpu_torch/utils/log.py",
    "gpumounter_tpu_torch/torchcheck/gpu_selftest.py"])
def test_device_layer_and_selftest_are_checked(module):
    assert REPO / module in PORT_FILES


NODE_MODULES = sorted(
    ".".join(p.relative_to(REPO).with_suffix("").parts)
    for sub in ("actuation", "collector") for p in
    (REPO / "gpumounter_tpu_torch" / sub).glob("*.py")
    if p.name != "__init__.py")


def test_node_modules_import_without_grpc_or_protobuf():
    """The collector, the fake PodResources client, the fake kubelet
    (import only) and every actuation module import in an interpreter
    where ``grpc`` and ``google.protobuf`` cannot be imported, and the
    fake client lists: the node half runs where neither package is."""
    assert "gpumounter_tpu_torch.actuation.gate" in NODE_MODULES
    assert "gpumounter_tpu_torch.collector.fake_kubelet" in NODE_MODULES
    code = (
        "import importlib, importlib.abc, sys\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name == 'grpc' or name.startswith('grpc.') or \\\n"
        "                name.startswith('google.protobuf'):\n"
        "            raise ImportError(f'blocked: {name}')\n"
        "        return None\n"
        "sys.meta_path.insert(0, Block())\n"
        "try:\n"
        "    import grpc\n"
        "    sys.exit('grpc was not blocked')\n"
        "except ImportError:\n"
        "    pass\n"
        f"for m in {NODE_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "from gpumounter_tpu_torch.collector.podresources import "
        "FakePodResourcesClient\n"
        "c = FakePodResourcesClient()\n"
        "c.assign('default', 'p', ['GPU-1'])\n"
        "pod = c.list_pods().pod_resources[0]\n"
        "assert (pod.name, pod.containers[0].devices[0].device_ids) == "
        "('p', ['GPU-1'])\n"
        "bad = [m for m in sys.modules if m == 'grpc' or "
        "m.startswith(('grpc.', 'google.protobuf'))]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=REPO, env=env, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-2000:]


WORKER_MODULES = sorted(
    ".".join(p.relative_to(REPO).with_suffix("").parts)
    for sub in ("k8s", "allocator") for p in
    (REPO / "gpumounter_tpu_torch" / sub).glob("*.py")
    if p.name != "__init__.py") + [
    "gpumounter_tpu_torch.allocator",
    "gpumounter_tpu_torch.utils.config",
    "gpumounter_tpu_torch.utils.parking",
    "gpumounter_tpu_torch.worker.drain",
    "gpumounter_tpu_torch.worker.journal",
    "gpumounter_tpu_torch.worker.reconciler",
    "gpumounter_tpu_torch.worker.service",
    "gpumounter_tpu_torch.testing.http_apiserver",
    "gpumounter_tpu_torch.testing.sim"]


def _run_blocked(blocked: tuple[str, ...], body: str):
    """Run ``body`` in a fresh interpreter where importing any module whose
    name starts with one of ``blocked`` raises ImportError; it exits 1 if
    any of them was loaded all the same."""
    code = (
        "import importlib, importlib.abc, sys\n"
        f"BLOCKED = {blocked!r}\n"
        "def hit(name):\n"
        "    return any(name == b or name.startswith(b + '.')\n"
        "               for b in BLOCKED)\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if hit(name):\n"
        "            raise ModuleNotFoundError(f'blocked: {name}')\n"
        "        return None\n"
        "sys.meta_path.insert(0, Block())\n"
        + body +
        "bad = [m for m in sys.modules if hit(m)]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=REPO, env=env, timeout=300)


def test_worker_modules_import_without_grpc_or_protobuf():
    """The Kubernetes layer, the allocator, the service and the rest of the
    worker below its gRPC adapter import, and a rig attaches and detaches,
    where ``grpc`` and ``google.protobuf`` (and so the ``_pb2`` modules)
    cannot be imported: only ``worker/grpc_server.py`` and what serves it
    speak the wire."""
    assert "gpumounter_tpu_torch.k8s.informer" in WORKER_MODULES
    assert "gpumounter_tpu_torch.allocator.topology" in WORKER_MODULES
    body = (
        f"for m in {WORKER_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "import tempfile\n"
        "from gpumounter_tpu_torch.testing.sim import WorkerRig\n"
        "from gpumounter_tpu_torch.utils.config import HostPaths\n"
        "root = tempfile.mkdtemp()\n"
        "import os\n"
        "for d in ('dev', 'proc', 'sys/fs/cgroup'):\n"
        "    os.makedirs(os.path.join(root, d))\n"
        "host = HostPaths(dev_root=root + '/dev', proc_root=root + '/proc',\n"
        "                 sys_root=root + '/sys',\n"
        "                 cgroup_root=root + '/sys/fs/cgroup')\n"
        "rig = WorkerRig(host, informer=True)\n"
        "assert rig.service.add_gpu('workload', 'default', 2, False)"
        ".result == 0\n"
        "assert rig.service.remove_gpu('workload', 'default', [], False)"
        ".result == 0\n"
        "rig.close()\n")
    proc = _run_blocked(("grpc", "google.protobuf",
                         "gpumounter_tpu_torch.api.gpu_mount_pb2"), body)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-2000:]


def test_yaml_only_on_the_kubeconfig_path():
    """No port module imports PyYAML when it is imported; the kubeconfig
    client is the one path that needs it, and says so when it is missing."""
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        .removesuffix(".__init__")
        for p in PORT_FILES if p.name != "chip_smoke.py")
    body = (
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "from gpumounter_tpu_torch.k8s.client import KubeconfigKubeClient\n"
        "from gpumounter_tpu_torch.utils.errors import K8sApiError\n"
        "import tempfile, os\n"
        "path = os.path.join(tempfile.mkdtemp(), 'kubeconfig')\n"
        "open(path, 'w').write('apiVersion: v1')\n"
        "try:\n"
        "    KubeconfigKubeClient(path)\n"
        "    sys.exit('kubeconfig parsed without PyYAML')\n"
        "except K8sApiError as e:\n"
        "    assert 'PyYAML' in str(e), e\n")
    proc = _run_blocked(("yaml",), body)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-2000:]


def test_parallel_entry_points_raise_without_a_gpu(monkeypatch):
    """The entry points of the parallel schemes, the distributed bring-up,
    the elastic harness and the federation member default to the GPU and
    never fall back to the CPU (``device="cpu"`` runs them in gloo
    worlds: tests/test_torch_parallel.py, test_torch_moe_pipeline.py)."""
    import torch

    from gpumounter_tpu_torch import bench, entry
    from gpumounter_tpu_torch.torchcheck import dist, model, moe, pipeline
    from gpumounter_tpu_torch.torchcheck import elastic, federation, perf
    from gpumounter_tpu_torch.torchcheck import probe

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = {
        "entry": lambda: entry.entry(),
        "dryrun_multichip": lambda: entry.dryrun_multichip(2),
        "run_world": lambda: dist.run_world(2, _never_called),
        "make_mesh": lambda: model.make_mesh(),
        "init_moe_params": lambda: moe.init_moe_params(moe.MoEConfig()),
        "make_mlp_layers": lambda: pipeline.make_mlp_layers(2, 8),
        "validate_training": lambda: probe.validate_training(n_devices=2),
        "initialize_distributed": lambda: probe.initialize_distributed(
            "127.0.0.1:1", 1, 0),
        "elastic_harness": lambda: elastic.ElasticHarness(
            model.ModelConfig(), lambda: 1, lambda: 1,
            checkpoint_path="/nonexistent/never-written"),
        "refederator": lambda: federation.Refederator(None),
        "member": lambda: federation.MemberRunner(
            "http://127.0.0.1:1", "g", "default/p", "/nonexistent"),
        "measure_both": lambda: perf.measure_both(),
        "measure_attention_kernels": lambda: perf.measure_attention_kernels(),
        "measure_long_context": lambda: perf.measure_long_context(),
        "measure_roofline": lambda: perf.measure_roofline(),
        "validate_training_timed": lambda: probe.validate_training(
            timed_steps=2),
        "bench_main": lambda: bench.main([]),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    fn, (net, tokens) = entry.entry(device="cpu")
    assert fn(net, tokens).shape == (2, 32, 64)
    assert moe.init_moe_params(moe.MoEConfig(), device="cpu")["w1"].shape \
        == (4, 64, 128)
    assert len(pipeline.make_mlp_layers(2, 8, device="cpu")) == 2


def _never_called(device):
    raise AssertionError("a world started without a GPU")
