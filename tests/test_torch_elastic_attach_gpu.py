"""A pod's own ride through the port's master (``testing/elastic_attach.py``;
this file imports no jax): a CUDA-free pod process waits for its first GPU,
``GET /addgpu`` through the port's master starts its first world from the
worker's own mesh-generation stamp, ``POST /removegpu`` is refused while
its rank holds the GPU, a bump (a second GPU attached, or the same GPU
stamped anew by the worker) respawns the world, which restores every leaf
bitwise, and the detach after the stop leaves no slave pod and no node.

On the CPU the rig runs over fake GPUs with gloo ranks at the tiny width
(the ranks made the GPUs' holders through the fake enumerator); on a
machine with cards, at the flagship width with the flash step."""

import functools
import subprocess

import pytest
import torch

from gpumounter_tpu_torch.testing.elastic_attach import (Ride,
                                                          run_elastic_attach)
from gpumounter_tpu_torch.torchcheck import model as model_lib

TINY = model_lib.ModelConfig(vocab=64, d_model=32, n_heads=4, n_layers=1,
                             d_ff=64)
CARD_ONLY = ("rank_on_the_attached_uuid", "new_ranks_on_the_attached_uuids")


def _hold(enumerator, gpus, pids):
    for gpu in gpus:
        enumerator.busy_pids[gpu.device_path] = list(pids)


@pytest.mark.parametrize("grow", [False, True], ids=["same_gpu", "grow"])
def test_elastic_attach_rig_on_fake_gpus(tmp_path, grow):
    from gpumounter_tpu_torch.device.fake import FakeEnumerator, make_chips
    enumerator = FakeEnumerator(make_chips(2))
    report = run_elastic_attach(
        str(tmp_path / "ride"), enumerator,
        Ride("cpu", TINY, batch=4, seq_len=48, lr=1e-2), grow=grow,
        hold=functools.partial(_hold, enumerator))
    checks = report["checks"]
    assert checks and all(checks.values()), checks
    assert not set(CARD_ONLY) & set(checks)
    assert len(report["uuids"]) == (2 if grow else 1)
    assert set(report["attach_to_first_step_s"]) == {
        "addgpu_return_to_stamp_seen", "stamp_seen_to_spawn",
        "spawn_to_interpreter", "interpreter_to_device",
        "init_process_group", "fresh_state_built", "first_step"}
    assert report["leaves"] > 10


@pytest.fixture
def smi_uuids():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return subprocess.run(["nvidia-smi", "--query-gpu=uuid",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.split()


@pytest.mark.gpu
def test_elastic_attach_on_the_card(smi_uuids, tmp_path):
    from gpumounter_tpu_torch.device.enumerator import PyEnumerator
    from gpumounter_tpu_torch.torchcheck import perf
    from gpumounter_tpu_torch.utils.config import HostPaths
    report = run_elastic_attach(
        str(tmp_path / "ride"), PyEnumerator(HostPaths()),
        Ride("cuda", perf.mxu_config(), batch=8, seq_len=1024,
             attn_impl="flash"))
    assert report["checks"] and all(report["checks"].values()), \
        report["checks"]
    assert report["uuids"][0] in smi_uuids
