"""The topology plane and the defragmenter with the card as one host of
four (the card's side of tests/test_torch_defrag.py; this file imports no
jax): /topoz names the card's nvidia-smi UUID, /utilz reads the card idle,
busy under a ``flash_fwd`` loop (from NVML) and idle again, the fleet
fragments to a score of 0.5 with one candidate, and the defragmenter moves
the idle group onto the card, after which the score is 0.0 and the moved
member's in-pod proof launches ``flash_fwd`` on the card's UUID."""

import json
import os
import subprocess

import pytest
import torch

from gpumounter_tpu_torch.device.enumerator import PyEnumerator
from gpumounter_tpu_torch.testing.defrag import cuda_load, run_defrag
from gpumounter_tpu_torch.testing.master_attach import cuda_proof
from gpumounter_tpu_torch.utils.config import HostPaths


@pytest.fixture
def smi_uuids():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return subprocess.run(["nvidia-smi", "--query-gpu=uuid",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.split()


@pytest.mark.gpu
def test_idle_group_moves_onto_the_card(smi_uuids, tmp_path):
    report = run_defrag(str(tmp_path / "defrag"),
                        PyEnumerator(HostPaths()), cuda_proof, cuda_load)
    assert report["card"]["uuid"] in smi_uuids
    assert report["checks"] and all(report["checks"].values()), \
        report["checks"]
    assert report["usage_peak"]["duty_source"] == "nvml"
    assert report["in_pod"]["visible"] == report["card"]["uuid"]
    assert report["agent_fallbacks"] == 0


class _MarkerNvml:
    """NVML as the usage probe calls it, for one GPU: 100 % utilization
    while ``marker`` exists (the stub load's loop), 0 otherwise."""

    def __init__(self, uuid: str, marker: str):
        self.uuid, self.marker = uuid, marker
        self.inits = self.shutdowns = 0

    def nvmlInit_v2(self):
        self.inits += 1
        return 0

    def nvmlShutdown(self):
        self.shutdowns += 1
        return 0

    def nvmlDeviceGetHandleByUUID(self, uuid, handle):
        if uuid.decode() != self.uuid:
            return 13
        handle._obj.value = 1
        return 0

    def nvmlDeviceGetUtilizationRates(self, handle, util):
        util._obj.gpu = 100 if os.path.exists(self.marker) else 0
        return 0


STUB_LOAD = '''
import json, os, sys, time
marker = sys.argv[1]
print("ready", flush=True)
sys.stdin.readline()
open(marker, "w").close()
time.sleep(3.0)
os.unlink(marker)
print(json.dumps({"launches": 1, "seconds": 3.0}), flush=True)
sys.stdin.read()
'''

STUB_PROOF = ('import json, sys; print(json.dumps({"ok": True, '
              '"launches": 1, "device_count": 1, "visible": sys.argv[1]}), '
              'flush=True); sys.stdin.read()')


def test_defrag_rig_on_fake_gpus(tmp_path):
    """The same rig on the CPU: fake GPUs for host 0, an NVML double that
    reads the stub load's loop, and stub children for the proofs."""
    import sys

    from gpumounter_tpu_torch.device.fake import FakeEnumerator, make_chips
    enumerator = FakeEnumerator(make_chips(2))
    card = make_chips(1)[0].uuid
    marker = str(tmp_path / "busy")
    nvml = _MarkerNvml(card, marker)

    def child(code, *argv):
        return subprocess.Popen([sys.executable, "-c", code, *argv],
                                stdin=subprocess.PIPE,
                                stdout=subprocess.PIPE, text=True)

    report = run_defrag(str(tmp_path / "defrag"), enumerator,
                        lambda gpu: child(STUB_PROOF, gpu.uuid),
                        lambda gpu: child(STUB_LOAD, marker), nvml=nvml)
    assert report["checks"] and all(report["checks"].values()), \
        json.dumps({k: report.get(k) for k in (
            "checks", "fragmented", "defrag", "usage_peak", "usage_idle",
            "load_opens", "invariants", "move_events")}, default=str)[:4000]
    assert report["card"]["uuid"] == card
    assert (nvml.inits, nvml.shutdowns) == (1, 1)
    assert report["fragmented"]["defrag_candidates"][0]["gain"] == 1
    timings = report["timings"]
    assert timings["candidate_to_migrated_ticks"] >= 2
    assert timings["topology_tick_ms"]["n"] >= 3
