"""A leader fail-over through two of the port's masters on a machine with
a card (the card's side of tests/test_torch_ha.py; this file imports no
jax): the proxied attach answers with the card's nvidia-smi UUID, the
in-pod proof holds it while the owner is killed, the peer takes the shard
over with a bumped fence, merges the lease and adopts the parked waiter,
which completes on the same card; the restarted replica does not take the
shard back, and the invariants hold."""

import subprocess

import pytest
import torch

from gpumounter_tpu_torch.device.enumerator import PyEnumerator
from gpumounter_tpu_torch.testing.ha_attach import run_ha_attach
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
def test_ha_attach_fails_a_leader_over_on_the_card(smi_uuids, tmp_path):
    report = run_ha_attach(str(tmp_path / "ha"), PyEnumerator(HostPaths()),
                           cuda_proof, cycles=3)
    assert report["card"]["uuid"] in smi_uuids
    assert report["checks"] and all(report["checks"].values()), \
        report["checks"]
    assert report["in_pod"]["visible"] == report["card"]["uuid"]
    assert report["fence_after"] > report["fence_before"]
    assert report["agent_fallbacks"] == 0


STUB_PROOF = ('import json, sys; print(json.dumps({"ok": True, '
              '"launches": 1, "device_count": 1}), flush=True); '
              'sys.stdin.read()')


def test_ha_attach_rig_on_fake_gpus(tmp_path):
    """The same rig on the CPU: fake GPUs and a stub child for the proof
    (it holds the GPU through the fake enumerator)."""
    from gpumounter_tpu_torch.device.fake import FakeEnumerator, make_chips
    from gpumounter_tpu_torch.testing.worker_attach import spawn
    enumerator = FakeEnumerator(make_chips(2))

    def proof(gpu):
        child = spawn(STUB_PROOF)
        enumerator.busy_pids[gpu.device_path] = [child.pid]
        return child

    report = run_ha_attach(str(tmp_path / "ha"), enumerator, proof,
                           cycles=3)
    assert report["checks"] and all(report["checks"].values()), \
        report["checks"]
    # the node is the a3-highgpu-1g view: the first of the machine's GPUs
    assert report["card"]["uuid"] == make_chips(1)[0].uuid
    assert report["fence_after"] == report["fence_before"] + 1
    # bounded by the TTL plus one renew interval (6 s + 2 s), with one
    # more interval of slack for a loaded host
    assert report["failover_s"] < 6.0 + 2.0 + 2.0
    assert report["ms"]["owner"]["addgpu"]["n"] == 3
    assert report["shard_forwards_delta"]["ok"] == 2 + 2 * 3
    assert {"rpc", "resolve", "lease"} <= set(
        report["phase_median_ms"]["owner"]["addgpu"])
