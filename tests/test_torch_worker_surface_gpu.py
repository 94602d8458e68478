"""The worker's surface on the card: mTLS dialed by IP, a Pod of two
containers, a CUDA holder in the sidecar named by ``GPUStatus`` and the
master's ``/gpustatus``, the forced detach, the in-pod ``flash_fwd`` from
the sidecar, and a storm within the leak thresholds and request budgets
(the card's side of tests/test_torch_tls_status.py,
tests/test_torch_multicontainer.py, tests/test_torch_stress.py and
tests/test_torch_round_trip_budget.py; this file imports no jax)."""

import os
import subprocess

import pytest
import torch

from gpumounter_tpu_torch.device.enumerator import PyEnumerator
from gpumounter_tpu_torch.testing.master_attach import cuda_proof
from gpumounter_tpu_torch.testing.worker_attach import cuda_holder, spawn
from gpumounter_tpu_torch.testing.worker_surface import run_worker_surface
from gpumounter_tpu_torch.utils.config import HostPaths


@pytest.fixture
def smi_uuids():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return subprocess.run(["nvidia-smi", "--query-gpu=uuid",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.split()


@pytest.mark.gpu
def test_worker_surface_on_the_card(smi_uuids, tmp_path):
    report = run_worker_surface(str(tmp_path / "ws"),
                                PyEnumerator(HostPaths()), cuda_holder,
                                cuda_proof)
    assert report["card"]["uuid"] in smi_uuids
    assert report["checks"] and all(report["checks"].values()), \
        {k: v for k, v in report["checks"].items() if not v}
    assert report["in_pod"]["visible"] == report["card"]["uuid"]
    assert report["phase_s"] < 60


STUB_PROOF = ('import json, sys; print(json.dumps({"ok": True, '
              '"launches": 1, "device_count": 1}), flush=True); '
              'sys.stdin.read()')
IDLE = "import sys; sys.stdin.read()"


def test_worker_surface_rig_on_fake_gpus(tmp_path):
    """The same rig on the CPU: fake GPUs, a holder the fake enumerator
    reports busy on the GPU's node, and a stub child for the proof. The
    companions are named apart from a card machine's own, whose host nodes
    the rig would otherwise read for the expected (major, minor)."""
    from gpumounter_tpu_torch.device.fake import FakeEnumerator, make_chips
    from gpumounter_tpu_torch.device.model import CompanionNode
    enumerator = FakeEnumerator(make_chips(1, companions=(
        CompanionNode("/dev/fixture-nvidiactl", 195, 255),
        CompanionNode("/dev/fixture-nvidia-uvm", 511, 0))))

    def holder(gpu):
        proc = spawn(IDLE)
        enumerator.busy_pids = {gpu.device_path: [proc.pid]}
        return proc

    report = run_worker_surface(str(tmp_path / "ws"), enumerator, holder,
                                lambda gpu: spawn(STUB_PROOF),
                                storm_cycles=10, timed_pairs=3)
    assert report["checks"] and all(report["checks"].values()), (
        {k: v for k, v in report["checks"].items() if not v},
        report.get("storm"))
    assert report["card"]["uuid"] == make_chips(1)[0].uuid
    assert report["holder_rc"] == -9
    assert report["tls"]["server_name"] == "gpu-mounter-worker"
    assert set(report["timed_pairs"]) == {"mtls", "plaintext"}
    assert not os.path.exists(tmp_path / "ws")


@pytest.mark.parametrize("deletes", [1000])
def test_facade_answers_a_delete_storm_without_a_retry(tmp_path, deletes):
    """The phase's apiserver facade answers every DELETE, each with its
    DeleteOptions body, on the first try: the retry layer sends none
    again, so the phase's budget can count every DELETE exactly. (In the
    gVisor sandbox of an H100 machine, a facade that replied over the
    unread body had 39 and 45 of 5000 such DELETEs reset; ROADMAP Queue 3
    item 49.)"""
    from gpumounter_tpu_torch.k8s.client import (FakeKubeClient,
                                                 InClusterKubeClient)
    from gpumounter_tpu_torch.testing.http_apiserver import HttpApiserver
    from gpumounter_tpu_torch.testing.worker_surface import retry_causes
    server = HttpApiserver(FakeKubeClient())
    (tmp_path / "token").write_text("t")
    client = InClusterKubeClient(host=server.base, sa_dir=str(tmp_path))
    try:
        with retry_causes() as causes:
            for i in range(deletes):
                client.delete_pod("default", f"gone-{i}")
    finally:
        server.close()
    assert causes == [], causes
