"""The node half of an attach on a machine with a card (the card's side of
tests/test_torch_collector.py and test_torch_actuation.py; this file
imports no jax): the collector maps a kubelet listing of the card's UUID to
its node at 195:N, the mounter grants the card and its three companions
through the cgroup-v1 device gate of a fixture container and makes their
nodes there, a child holding a CUDA context on the card makes the detach
refuse, and the detach completes once it has exited."""

import os
import subprocess
import sys

import pytest
import torch

from gpumounter_tpu_torch.collector.collector import GPUCollector
from gpumounter_tpu_torch.collector.podresources import \
    FakePodResourcesClient
from gpumounter_tpu_torch.device.enumerator import PyEnumerator
from gpumounter_tpu_torch.testing.node_fixture import FixtureNode
from gpumounter_tpu_torch.utils import consts
from gpumounter_tpu_torch.utils.config import HostPaths
from gpumounter_tpu_torch.utils.errors import DeviceBusyError

SLAVE = "workload-slave-pod-gpu-test"
HOLDER = ("import sys, torch; torch.zeros(1, device='cuda'); "
          "torch.cuda.synchronize(); print('ready', flush=True); "
          "sys.stdin.read()")


@pytest.fixture
def card():
    """The card's node as the real enumerator reads it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=uuid",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.split()
    enum = PyEnumerator(HostPaths())
    cards = [d for d in enum.enumerate() if d.uuid and d.uuid in smi]
    assert cards, "no /dev/nvidiaN node carries a UUID nvidia-smi lists"
    return enum, cards[0]


@pytest.fixture
def processes():
    procs = []

    def spawn(code):
        proc = subprocess.Popen([sys.executable, "-c", code],
                                stdin=subprocess.PIPE,
                                stdout=subprocess.PIPE, text=True)
        procs.append(proc)
        return proc
    yield spawn
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
        proc.wait(timeout=60)
        assert proc.poll() is not None


@pytest.mark.gpu
def test_attach_busy_refusal_and_detach_on_the_card(card, processes,
                                                     tmp_path):
    enum, gpu = card
    kubelet = FakePodResourcesClient()
    kubelet.assign(consts.DEFAULT_POOL_NAMESPACE, SLAVE,
                   [gpu.uuid, "GPU-00000000-0000-0000-0000-000000000000"])
    collector = GPUCollector(enum, kubelet)
    gpus = collector.get_pod_gpu_resources_exact("workload", "default",
                                                 {SLAVE})
    assert [(g.uuid, g.major, g.minor) for g in gpus] == [
        (gpu.uuid, consts.NVIDIA_MAJOR, gpu.minor)]
    assert sorted(os.path.basename(c.host_path) for c in gpu.companions) \
        == sorted(consts.NVIDIA_COMPANION_NAMES)

    idle = processes("import sys; sys.stdin.read()")
    node = FixtureNode(str(tmp_path / "node"))
    box = node.container("workload", [idle.pid])
    mounter = node.mounter(enum, collector.plans)
    assert mounter.mount_chips(box.pod, gpus, gpus) == 4
    expect = {}
    for path in [gpu.device_path] + [c.host_path for c in gpu.companions]:
        st = os.stat(path)
        expect[os.path.basename(path)] = (os.major(st.st_rdev),
                                          os.minor(st.st_rdev))
    assert box.nodes() == expect
    granted = sorted(f"c {a}:{b} rw" for a, b in expect.values())
    assert sorted(box.cgroup_lines("devices.allow")) == granted

    holder = processes(HOLDER)
    assert holder.stdout.readline().strip() == "ready"
    box.set_pids([idle.pid, holder.pid])
    with pytest.raises(DeviceBusyError) as exc:
        mounter.unmount_chips(box.pod, gpus, [])
    assert exc.value.pids == [holder.pid]
    assert box.nodes() == expect
    assert box.cgroup_lines("devices.deny") == []

    holder.stdin.close()
    assert holder.wait(timeout=120) == 0
    mounter.unmount_chips(box.pod, gpus, [])
    assert box.nodes() == {}
    assert sorted(box.cgroup_lines("devices.deny")) == granted
