"""The control-plane half of an attach on a machine with a card (the card's
side of tests/test_torch_master.py and tests/test_torch_e2e.py; this file
imports no jax): ``GET /addgpu/...`` to the port's master over HTTP reaches
the worker over gRPC, the card's UUID comes back with its ``/dev/nvidiaN``,
the gate and the container hold the card and its companions, a child
pinned to that UUID launches the whole-K ``flash_fwd`` kernel on it and
agrees with the plain version, ``POST /removegpu/...`` answers 409
``GPU_BUSY`` while the child holds the card and succeeds after, and the
resident agent never falls back."""

import subprocess

import pytest
import torch

from gpumounter_tpu_torch.device.enumerator import PyEnumerator
from gpumounter_tpu_torch.testing.master_attach import (cuda_proof,
                                                         run_master_attach)
from gpumounter_tpu_torch.utils.config import HostPaths


@pytest.fixture
def smi_uuids():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return subprocess.run(["nvidia-smi", "--query-gpu=uuid",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.split()


@pytest.mark.gpu
def test_master_attach_in_pod_kernel_busy_and_detach_on_the_card(
        smi_uuids, tmp_path):
    report = run_master_attach(str(tmp_path / "master"),
                               PyEnumerator(HostPaths()), cuda_proof,
                               cycles=3)
    assert report["card"]["uuid"] in smi_uuids
    assert report["checks"] and all(report["checks"].values()), \
        report["checks"]
    assert report["in_pod"]["launches"] >= 1
    assert report["in_pod"]["visible"] == report["card"]["uuid"]
    assert report["agent_fallbacks"] == 0
    assert report["round_trips_per_cycle"] == {
        "DELETE/pods": 1.0, "GET/pods": 4.0, "POST/pods": 1.0}
