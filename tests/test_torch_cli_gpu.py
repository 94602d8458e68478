"""Phase ``operator`` of chip_smoke.py as a test (this file imports no
jax): gpumounterctl, one process per command, against the port's master
in front of the worker on this machine's card. On the card the attach
returns an nvidia-smi UUID, the in-pod ``flash_fwd`` proof runs on it,
``utilz`` reads the card from NVML, ``trace``, ``node``, ``topo`` and
``doctor`` answer, the detach leaves no slave pod, an unreachable master
exits 10 and a retried attach under one request id makes one slave pod.
The same rig on fake GPUs (a stub proof, the open-fd duty source) runs
here on the CPU."""

import subprocess

import pytest
import torch

from gpumounter_tpu_torch.testing.operator import run_in_subprocess


@pytest.fixture
def smi_uuids():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return subprocess.run(["nvidia-smi", "--query-gpu=uuid",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.split()


@pytest.mark.gpu
def test_operator_drives_an_attach_of_the_card(smi_uuids, tmp_path):
    report = run_in_subprocess(str(tmp_path / "operator"), cycles=3)
    assert report["checks"] and all(report["checks"].values()), \
        report["checks"]
    assert report["card"]["uuid"] in smi_uuids
    assert report["utilz_row"]["duty_source"] == "nvml"
    assert report["in_pod"]["visible"] == report["card"]["uuid"]
    assert report["agent_fallbacks"] == 0
    assert report["rc"] == 0


def test_operator_rig_on_fake_gpus(tmp_path):
    report = run_in_subprocess(str(tmp_path / "operator"), fake_gpus=1,
                               cycles=2)
    assert report["checks"] and all(report["checks"].values()), \
        (report["checks"], report.get("error"))
    assert report["rc"] == 0
    assert report["utilz_row"]["duty_source"] == "open-fd"
    assert report["doctor_expected_warnings"] == {
        "node_gpus_all_attached": "node gpu-node-0: 0/1 GPUs free"}
    assert report["retry"]["rids"] == ["operator-retry-1"] * 2
    assert report["cli_ms"]["add"]["n"] == 2
