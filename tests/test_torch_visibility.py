"""The port's partial-host visibility contract (tests/test_visibility.py,
case for case, for CUDA_VISIBLE_DEVICES).

After a single mount of 1 of a node's GPUs, the pod's /dev holds only the
mounted GPU's node. The probe pins CUDA_VISIBLE_DEVICES to the UUIDs of
exactly the present nodes (minor -> UUID from the driver) before the first
CUDA call. Whole-host attaches pin every GPU, operator-set values win, and
the pin is re-derived before every poll of the child-process device count,
so widening attaches widen it."""

import os

import pytest

from gpumounter_tpu_torch.device.fake import fake_uuid
from gpumounter_tpu_torch.torchcheck import probe
from gpumounter_tpu_torch.torchcheck.probe import (configure_visible_chips,
                                                   visible_chip_indices)


@pytest.fixture
def roots(tmp_path):
    """(dev root, proc root) of a fixture tree; ``add(i)`` makes GPU i's
    node and its driver information file appear."""
    dev, proc = tmp_path / "dev", tmp_path / "proc"
    dev.mkdir()
    proc.mkdir()

    def add(i, identity=True):
        (dev / f"nvidia{i}").touch()
        if identity:
            info = proc / "driver" / "nvidia" / "gpus" / f"0000:{i + 16:02x}:00.0"
            info.mkdir(parents=True)
            (info / "information").write_text(
                f"GPU UUID: \t {fake_uuid(i)}\nDevice Minor: \t {i}\n")

    return str(dev), str(proc), add


def test_indices_from_present_nodes(roots):
    dev, _, add = roots
    add(2)
    add(0)
    for name in ("nvidiactl", "nvidia-uvm", "nvidia-weird"):
        open(os.path.join(dev, name), "w").close()
    os.mkdir(os.path.join(dev, "vfio"))     # companions don't count as GPUs
    assert visible_chip_indices(dev) == [0, 2]


def test_no_nodes_means_none(roots):
    assert visible_chip_indices(roots[0]) is None


def test_configure_sets_env_from_nodes(roots):
    dev, proc, add = roots
    add(1)
    env = {}
    assert configure_visible_chips(dev, env, proc) == fake_uuid(1)
    assert env["CUDA_VISIBLE_DEVICES"] == fake_uuid(1)


def test_configure_respects_operator_pin(roots):
    dev, proc, add = roots
    add(1)
    env = {"CUDA_VISIBLE_DEVICES": "0,1,2,3"}
    assert configure_visible_chips(dev, env, proc) == "0,1,2,3"
    assert env["CUDA_VISIBLE_DEVICES"] == "0,1,2,3"


def test_configure_noop_without_nodes(roots):
    dev, proc, _ = roots
    env = {}
    assert configure_visible_chips(dev, env, proc) is None
    assert "CUDA_VISIBLE_DEVICES" not in env


def test_whole_host_pin_lists_all_chips(roots):
    dev, proc, add = roots
    for i in (3, 1, 0, 2):
        add(i)
    env = {}
    assert configure_visible_chips(dev, env, proc) == ",".join(
        fake_uuid(i) for i in range(4))


def test_a_node_without_uuid_is_left_out(roots):
    """A node neither the driver's proc tree nor NVML knows has no UUID to
    pin; it is left out, never pinned by an index."""
    dev, proc, add = roots
    add(0)
    add(5, identity=False)
    env = {}
    assert configure_visible_chips(dev, env, proc) == fake_uuid(0)


def test_wait_for_devices_widens_pin_between_polls(roots, monkeypatch):
    """A widening attach widens the pin: before every child poll the pin is
    re-derived from the (now larger) node set, even though the probe's OWN
    earlier pin sits in the environment (it must not be taken for an
    operator's)."""
    dev, proc, add = roots
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    add(0)
    counts = iter([1, 1, 2])        # below `expected` until the 3rd poll
    seen = []

    def child_count():
        # the child inherits this process's environment: record its pin;
        # the hot-attach lands while the probe is polling
        seen.append(os.environ.get("CUDA_VISIBLE_DEVICES"))
        if len(seen) == 1:
            add(1)
        return next(counts)

    monkeypatch.setattr(probe, "_child_device_count", child_count)
    monkeypatch.setattr(probe, "device_summary",
                        lambda device, cpu_devices: {"device_count": 2})
    probe.configure_visible_chips(dev, proc_root=proc)  # run_probe's pin
    assert os.environ["CUDA_VISIBLE_DEVICES"] == fake_uuid(0)
    probe.wait_for_devices(2, timeout_s=10, poll_s=0.01, device="cuda",
                           dev_root=dev, proc_root=proc, auto_visible=True)
    both = f"{fake_uuid(0)},{fake_uuid(1)}"
    assert seen == [fake_uuid(0), both, both]
    assert os.environ["CUDA_VISIBLE_DEVICES"] == both
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)


def test_wait_for_devices_keeps_an_operator_pin(roots, monkeypatch):
    dev, proc, add = roots
    add(0)
    add(1)
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "GPU-operator")
    seen = []

    def child_count():
        seen.append(os.environ.get("CUDA_VISIBLE_DEVICES"))
        return 1

    monkeypatch.setattr(probe, "_child_device_count", child_count)
    monkeypatch.setattr(probe, "device_summary",
                        lambda device, cpu_devices: {"device_count": 1})
    probe.wait_for_devices(1, timeout_s=10, poll_s=0.01, device="cuda",
                           dev_root=dev, proc_root=proc)
    assert seen == ["GPU-operator"]


def test_probe_reports_visible_chips(roots, monkeypatch):
    """run_probe surfaces the pin it applied (the single-mount scenario:
    the report is the operator's evidence of what CUDA was allowed to
    see)."""
    dev, proc, add = roots
    add(3)
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    report = probe.run_probe(device="cpu", dev_root=dev, proc_root=proc)
    assert report["cuda_visible_devices"] == fake_uuid(3)
    assert os.environ.get("CUDA_VISIBLE_DEVICES") == fake_uuid(3)
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
