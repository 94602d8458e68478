"""The port's members ride a live slice resize against the port's own master.

The rides of ``tests/test_torch_federation_e2e.py`` (member processes of
N = 1 and 2 gloo ranks each), with the port's ``MultiNodeStack`` in place
of the JAX package's: its ``/addgpuslice``, ``/slicez``,
``/slice/barrier`` and ``POST /slice/resize``, over GKE GPU hosts whose
allocatable ``nvidia.com/gpu`` is the member's N (the GPU slice rule:
``gpusPerHost`` is the whole host).

- ``/slice/resize`` 2 → 4 → 2 hosts: worlds of 2N, 4N, 2N devices, the
  step counter and the loss trajectory intact, members resized out exit 0;
- the coordinator SIGKILLed mid-resize: the barrier sticks, the port's
  master moves the generation past the dead member, and the survivors
  re-form a world of 3N, restoring the last good generation.

The slice invariants are the port's (``testing/chaos.py``). A file of its
own, so that a run with several workers gives it a worker of its own.
"""

import pytest

import test_torch_federation_e2e as e2e
from torch_control_plane import TORCH


@pytest.mark.parametrize("n", e2e.LOCAL_DEVICES, ids=e2e.IDS)
def test_multiprocess_resize_2_4_2_against_the_ports_master(tmp_path, n):
    e2e.ride_resize_2_4_2(tmp_path, n, TORCH, n_chips=n)


@pytest.mark.parametrize("n", e2e.LOCAL_DEVICES, ids=e2e.IDS)
def test_member_sigkill_mid_resize_against_the_ports_master(tmp_path, n):
    e2e.ride_sigkill_mid_resize(tmp_path, n, TORCH, n_chips=n)
