"""A member host of a live slice dies, with the card as the spare's host
(the card's side of tests/test_torch_node_chaos.py; this file imports no
jax): hosts 1-3 hold the slice, host 2 dies and turns suspect then dead,
its lease is fenced, the group re-forms onto the spare pod on host 0 with
one generation bump, the repaired member's in-pod proof launches
``flash_fwd`` on the card's nvidia-smi UUID, a drain on host 3 cordons it
and defers its migration, host 2's restart resurrects no grant, and the
invariants hold."""

import subprocess

import pytest
import torch

from gpumounter_tpu_torch.device.enumerator import PyEnumerator
from gpumounter_tpu_torch.testing.master_attach import cuda_proof
from gpumounter_tpu_torch.testing.node_failure import run_node_failure
from gpumounter_tpu_torch.utils.config import HostPaths


@pytest.fixture
def smi_uuids():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return subprocess.run(["nvidia-smi", "--query-gpu=uuid",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.split()


@pytest.mark.gpu
def test_slice_repairs_onto_the_card_after_a_host_dies(smi_uuids, tmp_path):
    report = run_node_failure(str(tmp_path / "nf"),
                              PyEnumerator(HostPaths()), cuda_proof)
    assert report["card"]["uuid"] in smi_uuids
    assert report["checks"] and all(report["checks"].values()), \
        report["checks"]
    assert report["in_pod"]["visible"] == report["card"]["uuid"]
    assert report["timings"]["kill_to_suspect_s"] \
        < report["timings"]["kill_to_dead_s"]
    assert report["agent_fallbacks"] == 0


STUB_PROOF = ('import json, sys; print(json.dumps({"ok": True, '
              '"launches": 1, "device_count": 1}), flush=True); '
              'sys.stdin.read()')


def test_node_failure_rig_on_fake_gpus(tmp_path):
    """The same rig on the CPU: fake GPUs for host 0 and a stub child for
    the proof."""
    from gpumounter_tpu_torch.device.fake import FakeEnumerator, make_chips
    from gpumounter_tpu_torch.testing.worker_attach import spawn
    enumerator = FakeEnumerator(make_chips(2))

    def proof(gpu):
        child = spawn(STUB_PROOF)
        enumerator.busy_pids[gpu.device_path] = [child.pid]
        return child

    report = run_node_failure(str(tmp_path / "nf"), enumerator, proof)
    assert report["checks"] and all(report["checks"].values()), \
        report["checks"]
    assert report["card"]["uuid"] == make_chips(1)[0].uuid
    timings = report["timings"]
    # 2 and 5 missed scrapes of a 1 s fleet loop
    assert 1.0 <= timings["kill_to_suspect_s"] < timings["kill_to_dead_s"]
    assert timings["kill_to_dead_s"] < 10.0
    assert [r["outcome"] for r in report["repairs"]] == ["repaired"]
    assert report["replay"].get("gate_orphans_revoked") == 1
