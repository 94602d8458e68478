"""A worker that holds a GPU is crashed and replayed at every crash point,
its detach is crashed mid-revoke and inside the v1 gate's sync, and the
transient plans run over the HTTP apiserver facade, with the in-pod proof
on the card after the first replay and after the plans (the card's side of
tests/test_torch_chaos.py and tests/test_torch_gate_chaos.py; this file
imports no jax)."""

import subprocess

import pytest
import torch

from gpumounter_tpu_torch.device.enumerator import PyEnumerator
from gpumounter_tpu_torch.testing.master_attach import cuda_proof
from gpumounter_tpu_torch.testing.worker_chaos import (PLANS,
                                                       run_worker_chaos)
from gpumounter_tpu_torch.utils.config import HostPaths


@pytest.fixture
def smi_uuids():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return subprocess.run(["nvidia-smi", "--query-gpu=uuid",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.split()


@pytest.mark.gpu
def test_worker_crash_and_replay_on_the_card(smi_uuids, tmp_path):
    report = run_worker_chaos(str(tmp_path / "wc"),
                              PyEnumerator(HostPaths()), cuda_proof)
    assert report["card"]["uuid"] in smi_uuids
    assert report["checks"] and all(report["checks"].values()), \
        report["checks"]
    for label in ("in_pod_after_replay", "in_pod_after_plans"):
        assert report[label]["visible"] == report["card"]["uuid"]
    assert report["agent_fallbacks"] == 0
    assert report["phase_s"] < 60


STUB_PROOF = ('import json, sys; print(json.dumps({"ok": True, '
              '"launches": 1, "device_count": 1}), flush=True); '
              'sys.stdin.read()')


def test_worker_chaos_rig_on_fake_gpus(tmp_path):
    """The same rig on the CPU: fake GPUs and a stub child for the
    proof."""
    from gpumounter_tpu_torch.device.fake import FakeEnumerator, make_chips
    from gpumounter_tpu_torch.testing.worker_attach import spawn
    enumerator = FakeEnumerator(make_chips(1))

    def proof(gpu):
        return spawn(STUB_PROOF)

    report = run_worker_chaos(str(tmp_path / "wc"), enumerator, proof,
                              pairs=3)
    assert report["checks"] and all(report["checks"].values()), \
        {k: v for k, v in report["checks"].items() if not v}
    assert report["card"]["uuid"] == make_chips(1)[0].uuid
    assert set(report["plans"]) == {name for name, _, _ in PLANS}
    for point, row in report["crash_points"].items():
        assert row["replay"].get("completed") == 1, point
    assert report["agent_fallbacks"] == 0
