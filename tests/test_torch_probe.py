"""The port's in-pod probe on the CPU: gloo collectives over worker
processes, the toy training check (one process, and sharded over a world
of gloo processes), and the CLI's exit codes."""

import json
import os
import subprocess
import sys

import pytest
import torch

from gpumounter_tpu_torch.torchcheck import probe

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_validate_collectives_over_two_gloo_processes():
    r = probe.validate_collectives(2, device="cpu")
    assert r == {"n_devices": 2, "backend": "gloo", "allreduce_ok": True,
                 "ring_ok": True, "degenerate_single_device": False,
                 "ok": True}


def test_single_device_collectives_are_marked_degenerate():
    r = probe.validate_collectives(1, device="cpu")
    assert r["ok"] and r["degenerate_single_device"]


def test_validate_training_on_cpu():
    r = probe.validate_training(device="cpu")
    assert r["ok"] and r["final_loss"] < r["first_loss"]
    assert r["mesh"] is None


def test_validate_training_over_four_gloo_processes_reports_mesh():
    """With more than one device the toy step is sharded over make_mesh():
    the seq dim takes all four, T = 16 x 4."""
    r = probe.validate_training(device="cpu", n_devices=4)
    assert r["mesh"] == {"data": 1, "seq": 4, "model": 1}
    assert r["ok"] and r["final_loss"] < r["first_loss"], r


def test_run_probe_on_cpu():
    r = probe.run_probe(expected=2, timeout_s=0, device="cpu",
                        cpu_devices=2)
    assert r["ok"], r
    assert r["devices"]["device_count"] == 2
    assert r["collectives"]["n_devices"] == 2


def test_device_count_is_polled_in_a_child_process():
    """CUDA fixes a process's device set at its first CUDA call, so the
    count comes from a fresh child each poll. This host has no GPU: the
    child sees 0 and the wait times out without this process touching
    CUDA."""
    assert probe._child_device_count() == 0
    with pytest.raises(TimeoutError, match="expected 1 devices, have 0"):
        probe.wait_for_devices(1, timeout_s=0, device="cuda")


def _cli(*args):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run(
        [sys.executable, "-m", "gpumounter_tpu_torch.torchcheck.probe",
         *args], capture_output=True, text=True, cwd=REPO, env=env,
        timeout=300)


def test_cli_exit_codes():
    ok = _cli("--cpu-devices", "4", "--expect", "4")
    assert ok.returncode == 0, ok.stderr[-2000:]
    report = json.loads(ok.stdout.strip().splitlines()[-1])
    assert report["ok"] is True
    assert report["training"]["mesh"] == {"data": 1, "seq": 4, "model": 1}
    timeout = _cli("--cpu-devices", "2", "--expect", "4", "--timeout", "0")
    assert timeout.returncode == 2
    assert "expected 4 devices" in json.loads(
        timeout.stdout.strip().splitlines()[-1])["error"]


@pytest.mark.gpu
def test_run_probe_on_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    r = probe.run_probe()
    assert r["ok"], r
    assert r["devices"]["backend"] == "cuda"
