"""A four-host slice through the port's master on a machine with a card
(the card's side of tests/test_torch_slicetxn.py; this file imports no
jax): host 0 on the card, hosts 1-3 fixture GKE GPU nodes; the slice
attaches with host 0's nvidia-smi UUID, its barrier completes, it resizes
4 → 2 → 4 with the generation moving everywhere, the in-pod proof on host
0's card makes the slice detach answer 409 ``GPU_BUSY`` for host 0, a gang
parks and completes, and the slice invariants hold."""

import subprocess

import pytest
import torch

from gpumounter_tpu_torch.device.enumerator import PyEnumerator
from gpumounter_tpu_torch.testing.master_attach import cuda_proof
from gpumounter_tpu_torch.testing.slice_attach import run_slice_attach
from gpumounter_tpu_torch.utils.config import HostPaths


@pytest.fixture
def smi_uuids():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return subprocess.run(["nvidia-smi", "--query-gpu=uuid",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.split()


@pytest.mark.gpu
def test_slice_attach_through_the_master_on_the_card(smi_uuids, tmp_path):
    report = run_slice_attach(str(tmp_path / "slice"),
                              PyEnumerator(HostPaths()), cuda_proof,
                              cycles=3)
    assert report["card"]["uuid"] in smi_uuids
    assert report["checks"] and all(report["checks"].values()), \
        report["checks"]
    assert report["in_pod"]["visible"] == report["card"]["uuid"]
    assert report["barrier_plan"]["num_processes"] == 4
    assert [r["generation"] for r in report["resizes"]] == [2, 3]
    assert report["agent_fallbacks"] == 0


STUB_PROOF = ('import json, sys; print(json.dumps({"ok": True, '
              '"launches": 1, "device_count": 1}), flush=True); '
              'sys.stdin.read()')


def test_slice_attach_rig_on_fake_gpus(tmp_path):
    """The same rig on the CPU: fake GPUs for host 0 and a stub child for
    the proof (it holds host 0's GPU through the fake enumerator)."""
    from gpumounter_tpu_torch.device.fake import FakeEnumerator, make_chips
    from gpumounter_tpu_torch.testing.worker_attach import spawn
    enumerator = FakeEnumerator(make_chips(2))

    def proof(gpu):
        child = spawn(STUB_PROOF)
        enumerator.busy_pids[gpu.device_path] = [child.pid]
        return child

    report = run_slice_attach(str(tmp_path / "slice"), enumerator, proof,
                              cycles=3)
    assert report["checks"] and all(report["checks"].values()), \
        report["checks"]
    # host 0 is the a3-highgpu-1g view: the first of the machine's GPUs
    assert report["card"]["uuid"] == make_chips(1)[0].uuid
    assert report["ms"]["addgpuslice"]["n"] == 3
    assert set(report["host_attach_median_ms"]) == {"host0",
                                                    "fixture_hosts"}
    assert {"fanout", "validate"} <= set(
        report["phase_median_ms"]["slice_attach"])
