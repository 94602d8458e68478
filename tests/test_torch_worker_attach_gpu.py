"""The worker half of an attach on a machine with a card (the card's side
of tests/test_torch_worker.py; this file imports no jax): ``AddGPU`` over
gRPC schedules a slave pod in an HTTP apiserver facade, the PodResources
listing of the card's UUID maps to its node, the v1 gate grants it and
its companions, a child holding a CUDA context makes ``RemoveGPU`` answer
``GPUBusy``, the detach completes once it has exited, and the resident
agent never falls back."""

import subprocess

import pytest
import torch

from gpumounter_tpu_torch.device.enumerator import PyEnumerator
from gpumounter_tpu_torch.testing.worker_attach import (cuda_holder,
                                                         run_worker_attach)
from gpumounter_tpu_torch.utils.config import HostPaths


@pytest.fixture
def smi_uuids():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return subprocess.run(["nvidia-smi", "--query-gpu=uuid",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.split()


@pytest.mark.gpu
def test_worker_attach_busy_refusal_and_detach_on_the_card(smi_uuids,
                                                           tmp_path):
    report = run_worker_attach(str(tmp_path / "worker"),
                               PyEnumerator(HostPaths()), cuda_holder,
                               cycles=3)
    assert report["card"]["uuid"] in smi_uuids
    assert report["checks"] and all(report["checks"].values()), \
        report["checks"]
    assert report["agent_fallbacks"] == 0
    assert report["round_trips_per_cycle"] == {
        "DELETE/pods": 1.0, "GET/pods": 2.0, "POST/pods": 1.0}
