"""A CUDA-free pod process drives rank processes on the card (the card's
side of tests/test_torch_elastic.py and test_torch_multihost.py; this
file imports no jax).

- ``ElasticSupervisor`` with one local rank rides a bump of its pod's
  generation file: the rank drains and exits, a fresh rank on the same
  card restores and continues, every leaf bitwise, the first loss after
  the respawn within 1e-3 of the old rank's uninterrupted step, and the
  pod process never initialises CUDA;
- the probe's pod process (``run_local_probe``) drives every GPU its
  device nodes show, one rank each, without a CUDA call of its own.
"""

import json
import multiprocessing
import os
import socket
import subprocess
import sys

import pytest

import torch_worlds
from gpumounter_tpu_torch.torchcheck import probe

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def gpus():
    """The GPUs this container's device nodes show (no CUDA call)."""
    devices = probe.pod_gpus()
    if not devices:
        pytest.skip("needs a CUDA card (no nvidiaN node under /dev)")
    return devices


def _uuid(text):
    return str(text).strip().lower().removeprefix("gpu-")


@pytest.mark.gpu
def test_a_cuda_free_pod_process_respawns_its_rank_on_the_card(gpus,
                                                               tmp_path):
    result = tmp_path / "result.json"
    pod = multiprocessing.get_context("spawn").Process(
        target=torch_worlds.pod_ride,
        args=(str(tmp_path), str(tmp_path / "gen.json"), [gpus[0].uuid],
              str(result)))
    pod.start()
    pod.join(timeout=600)
    assert pod.exitcode == 0, pod.exitcode
    got = json.loads(result.read_text())
    assert got["rc"] == 0 and got["cuda_initialized"] is False, got
    by_phase = {}
    for record in got["records"]:
        by_phase.setdefault(record["phase"], []).append(record)
    assert [r["step"] for r in by_phase["step"]] == [1, 2, 3, 4]
    started, begin = by_phase["started"][0], by_phase["reshape_begin"][0]
    done = by_phase["reshape_done"][0]
    assert done["step"] == begin["step"] == 2
    assert done["fingerprint"] == begin["fingerprint"]
    assert begin["digests"] and done["digests"] == begin["digests"]
    resumed = by_phase["step"][2]["loss"]
    assert abs(resumed - done["reference_loss"]) <= 1e-3
    assert started["pid"] != done["pid"]
    for record in (started, done):
        assert not os.path.exists(f"/proc/{record['pid']}")
        if gpus[0].uuid:
            assert _uuid(record["uuid"]) == _uuid(gpus[0].uuid)
    assert all(v >= 0 for v in done["downtime_s"].values()), done


@pytest.mark.gpu
def test_the_probe_pod_process_drives_every_gpu_it_holds(gpus):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    code = ("import json, torch\n"
            "from gpumounter_tpu_torch.torchcheck import probe\n"
            f"r = probe.run_local_probe('127.0.0.1:{port}', 1, 0)\n"
            "print(json.dumps([r, torch.cuda.is_initialized()]))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=REPO, timeout=600,
                          env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stderr[-3000:]
    report, initialised = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["ok"], report
    assert initialised is False
    n = len(gpus)
    assert report["devices"]["local_device_count"] == n
    assert report["devices"]["device_count"] == n
    assert report["devices"]["process_count"] == 1
    assert report["local_ranks_ok"] == [True] * n
    assert report["collectives"]["degenerate_single_device"] == (n == 1)
