"""The port's GPU device layer on fixture trees (no hardware): the device
model, the Python enumerator (nvidiaN nodes with ``.majmin`` sidecars,
``proc/devices``, the driver's ``proc/driver/nvidia/gpus/*/information``
and NVML through a fake library), busy PIDs through ``/proc/<pid>/fd``
links, the fake enumerator and the actuation plans with their shared
companions. The scenarios of tests/test_device.py, for NVIDIA nodes, and
one tree holding both device families read by both packages."""

import ctypes
import json
import os

import pytest

from gpumounter_tpu_torch.actuation import bpf
from gpumounter_tpu_torch.device import enumerator as en
from gpumounter_tpu_torch.device import plan
from gpumounter_tpu_torch.device.enumerator import (PyEnumerator,
                                                    read_proc_devices)
from gpumounter_tpu_torch.device.fake import (FakeEnumerator, fake_uuid,
                                              make_chips)
from gpumounter_tpu_torch.device.model import DeviceState, GPUDevice
from gpumounter_tpu_torch.utils.config import HostPaths

UVM_MAJOR = 510


@pytest.fixture
def gpu_host(tmp_path):
    """HostPaths of a fixture tree with empty dev, proc and sys roots."""
    for d in ("dev", "proc", "sys"):
        (tmp_path / d).mkdir()
    return HostPaths(dev_root=str(tmp_path / "dev"),
                     proc_root=str(tmp_path / "proc"),
                     sys_root=str(tmp_path / "sys"))


def pci_of(minor: int) -> str:
    return f"0000:{0x18 + minor:02x}:00.0"


def make_gpu_tree(host: HostPaths, minors, identities=True,
                  companions=True) -> None:
    """Fake nvidiaN nodes (regular files, 195:N sidecars), the shared
    companions, /proc/devices and, with ``identities``, the driver's
    information file of each GPU."""
    for i in minors:
        path = os.path.join(host.dev_root, f"nvidia{i}")
        open(path, "w").close()
        with open(path + ".majmin", "w") as f:
            f.write(f"195:{i}")
        if identities:
            info = os.path.join(host.proc_root, "driver", "nvidia", "gpus",
                                pci_of(i))
            os.makedirs(info, exist_ok=True)
            with open(os.path.join(info, "information"), "w") as f:
                f.write(f"Model: \t\t NVIDIA H100 80GB HBM3\n"
                        f"GPU UUID: \t {fake_uuid(i)}\n"
                        f"Bus Location: \t {pci_of(i).upper()}\n"
                        f"Device Minor: \t {i}\n")
    if companions:
        for name, majmin in (("nvidiactl", "195:255"),
                             ("nvidia-uvm", f"{UVM_MAJOR}:0"),
                             ("nvidia-uvm-tools", f"{UVM_MAJOR}:1")):
            path = os.path.join(host.dev_root, name)
            open(path, "w").close()
            with open(path + ".majmin", "w") as f:
                f.write(majmin)
    with open(os.path.join(host.proc_root, "devices"), "w") as f:
        f.write(f"Character devices:\n  1 mem\n195 nvidia\n195 nvidiactl\n"
                f"{UVM_MAJOR} nvidia-uvm\n\nBlock devices:\n  8 sd\n")


def link_fd(host: HostPaths, pid: int, fd: int, target: str) -> None:
    fd_dir = os.path.join(host.proc_root, str(pid), "fd")
    os.makedirs(fd_dir, exist_ok=True)
    os.symlink(target, os.path.join(fd_dir, str(fd)))


def test_device_reset_state():
    dev = GPUDevice(index=0, device_path="/dev/nvidia0", major=195, minor=0,
                    uuid=fake_uuid(0), state=DeviceState.ALLOCATED,
                    pod_name="p", namespace="ns")
    dev.reset_state()
    assert dev.state is DeviceState.FREE
    assert dev.pod_name == "" and dev.namespace == ""


def test_device_str_is_json():
    parsed = json.loads(str(make_chips(1)[0]))
    assert parsed["device_path"] == "/dev/nvidia0"
    assert parsed["major"] == 195
    assert parsed["uuid"].startswith("GPU-")


def test_py_enumerator_fixture_nodes(gpu_host):
    make_gpu_tree(gpu_host, range(4))
    # distractors: not GPU nodes
    for name in ("null", "nvidia-modeset", "nvidia-caps", "nvidia+1",
                 "nvidia01x"):
        open(os.path.join(gpu_host.dev_root, name), "w").close()
    os.mkdir(os.path.join(gpu_host.dev_root, "nvidiadir"))
    enum = PyEnumerator(gpu_host, allow_fake=True)
    devices = enum.enumerate()
    assert [d.index for d in devices] == [0, 1, 2, 3]
    assert all(d.major == 195 for d in devices)
    assert [d.minor for d in devices] == [0, 1, 2, 3]
    assert devices[0].device_path.endswith("/nvidia0")
    assert devices[0].container_path == "/dev/nvidia0"
    assert [d.uuid for d in devices] == [fake_uuid(i) for i in range(4)]
    assert [d.pci_address for d in devices] == [pci_of(i) for i in range(4)]
    assert enum.uuid_source == "proc"


def test_minor_uuid_pci_map_follows_the_minor(gpu_host):
    """The identity of a node is its minor's, whatever its index order:
    nvidia3 holding minor 7 gets minor 7's UUID."""
    make_gpu_tree(gpu_host, [7], companions=False)
    os.rename(os.path.join(gpu_host.dev_root, "nvidia7"),
              os.path.join(gpu_host.dev_root, "nvidia3"))
    with open(os.path.join(gpu_host.dev_root, "nvidia3.majmin"), "w") as f:
        f.write("195:7")
    (dev,) = PyEnumerator(gpu_host, allow_fake=True).enumerate()
    assert (dev.index, dev.minor, dev.uuid, dev.pci_address) == (
        3, 7, fake_uuid(7), pci_of(7))


def test_requires_char_device_without_fake_flag(gpu_host):
    make_gpu_tree(gpu_host, [0])
    assert PyEnumerator(gpu_host, allow_fake=False).enumerate() == []


def test_a_node_of_another_major_is_not_a_gpu(gpu_host):
    make_gpu_tree(gpu_host, [0, 1])
    with open(os.path.join(gpu_host.dev_root, "nvidia1.majmin"), "w") as f:
        f.write("120:1")
    assert [d.index for d in
            PyEnumerator(gpu_host, allow_fake=True).enumerate()] == [0]


def test_companions_are_shared_and_carry_their_majors(gpu_host):
    make_gpu_tree(gpu_host, range(2))
    devices = PyEnumerator(gpu_host, allow_fake=True).enumerate()
    assert devices[0].companions == devices[1].companions
    assert [(os.path.basename(c.host_path), c.major, c.minor,
             c.container_path) for c in devices[0].companions] == [
        ("nvidiactl", 195, 255, "/dev/nvidiactl"),
        ("nvidia-uvm", UVM_MAJOR, 0, "/dev/nvidia-uvm"),
        ("nvidia-uvm-tools", UVM_MAJOR, 1, "/dev/nvidia-uvm-tools")]


def test_companion_without_sidecar_takes_the_proc_devices_uvm_major(
        gpu_host):
    make_gpu_tree(gpu_host, [0], companions=False)
    for name in ("nvidiactl", "nvidia-uvm"):
        open(os.path.join(gpu_host.dev_root, name), "w").close()
    (dev,) = PyEnumerator(gpu_host, allow_fake=True).enumerate()
    assert [(os.path.basename(c.host_path), c.major, c.minor)
            for c in dev.companions] == [("nvidiactl", 195, 255),
                                         ("nvidia-uvm", UVM_MAJOR, 0)]


def test_read_proc_devices(gpu_host):
    make_gpu_tree(gpu_host, [])
    majors = read_proc_devices(gpu_host.proc_root)
    assert majors["nvidia"] == 195 and majors["nvidiactl"] == 195
    assert majors["nvidia-uvm"] == UVM_MAJOR
    assert "sd" not in majors


class FakeNvml:
    """libnvidia-ml's calls the enumerator makes, over a list of
    (minor, uuid, bus id) devices, writing results through the ctypes
    pointers as the library does."""

    def __init__(self, devices, init_rc=0):
        self.devices, self.init_rc = devices, init_rc
        self.shutdowns = 0

    def nvmlInit_v2(self):
        return self.init_rc

    def nvmlShutdown(self):
        self.shutdowns += 1
        return 0

    def nvmlDeviceGetCount_v2(self, count):
        count._obj.value = len(self.devices)
        return 0

    def nvmlDeviceGetHandleByIndex_v2(self, index, handle):
        handle._obj.value = index.value + 1
        return 0

    def nvmlDeviceGetMinorNumber(self, handle, minor):
        minor._obj.value = self.devices[handle.value - 1][0]
        return 0

    def nvmlDeviceGetUUID(self, handle, buf, length):
        buf.value = self.devices[handle.value - 1][1].encode()
        return 0

    def nvmlDeviceGetPciInfo_v3(self, handle, info):
        info._obj.busId = self.devices[handle.value - 1][2].encode()
        return 0


def test_uuids_from_nvml_where_the_proc_tree_is_absent(gpu_host):
    """A container runtime may hide /proc/driver/nvidia/gpus: the same
    facts then come from NVML, and the enumerator says so."""
    make_gpu_tree(gpu_host, [0, 5], identities=False)
    nvml = FakeNvml([(5, fake_uuid(5), "00000000:2A:00.0")])
    enum = PyEnumerator(gpu_host, allow_fake=True,
                        nvml=lambda: en.nvml_identities(nvml))
    devices = enum.enumerate()
    assert enum.uuid_source == "nvml" and nvml.shutdowns == 1
    # minor 0 is a node NVML does not report: its UUID is not made up
    assert [(d.minor, d.uuid, d.pci_address) for d in devices] == [
        (0, "", ""), (5, fake_uuid(5), "0000:2a:00.0")]


def test_no_source_no_uuid(gpu_host):
    make_gpu_tree(gpu_host, [0], identities=False)
    enum = PyEnumerator(gpu_host, allow_fake=True, nvml=lambda: None)
    (dev,) = enum.enumerate()
    assert dev.uuid == "" and enum.uuid_source == "none"
    assert en.nvml_identities(FakeNvml([], init_rc=9)) is None


def test_nvml_structure_matches_the_library_layout():
    # nvmlPciInfo_t: busIdLegacy[16], five unsigned ints, busId[32]
    assert ctypes.sizeof(en._NvmlPciInfo) == 16 + 5 * 4 + 32
    assert en._NvmlPciInfo.busId.offset == 36


@pytest.mark.parametrize("bus_id,want", [
    ("00000000:18:00.0", "0000:18:00.0"),
    ("0000:2A:00.0", "0000:2a:00.0"),
    ("00000001:C1:00.1", "0001:c1:00.1")])
def test_normalize_pci_address(bus_id, want):
    assert en.normalize_pci_address(bus_id) == want


def test_busy_detection_proc_fd_scan(gpu_host):
    make_gpu_tree(gpu_host, [0])
    node = os.path.join(gpu_host.dev_root, "nvidia0")
    # pid 100 holds the node; 200 holds nvidiactl only; 300 is gone
    link_fd(gpu_host, 100, 3, node)
    link_fd(gpu_host, 200, 4, os.path.join(gpu_host.dev_root, "nvidiactl"))
    enum = PyEnumerator(gpu_host, allow_fake=True)
    assert enum.device_open_pids([100, 200, 300], [node]) == [100]


def test_inventory_cache_serves_copies_until_a_node_changes(gpu_host):
    make_gpu_tree(gpu_host, [0])
    enum = PyEnumerator(gpu_host, allow_fake=True, cache_ttl_s=60.0)
    first = enum.enumerate()
    first[0].state = DeviceState.ALLOCATED
    assert enum.enumerate()[0].state is DeviceState.FREE
    make_gpu_tree(gpu_host, [1])          # hot-plug bumps the /dev mtime
    assert [d.index for d in enum.enumerate()] == [0, 1]


def test_numeric_order_10_plus(gpu_host):
    make_gpu_tree(gpu_host, range(12), identities=False)
    devices = PyEnumerator(gpu_host, allow_fake=True,
                           nvml=lambda: None).enumerate()
    assert [d.index for d in devices] == list(range(12))


def test_fake_enumerator_busy():
    fake = FakeEnumerator(busy_pids={"/dev/nvidia1": [42]})
    assert fake.device_open_pids([41, 42], ["/dev/nvidia1"]) == [42]
    assert fake.device_open_pids([41, 42], ["/dev/nvidia0"]) == []
    devices = fake.enumerate()
    assert [(d.device_path, d.major, d.minor) for d in devices] == [
        (f"/dev/nvidia{i}", 195, i) for i in range(4)]
    assert all(d.uuid == fake_uuid(d.index) for d in devices)


def test_plan_dedups_shared_companions():
    chips = make_chips(2)
    plans = [plan.ChipPlan.for_chip(c) for c in chips]
    assert plans[0].v1_rules == ("c 195:0 rw", "c 195:255 rw",
                                 "c 510:0 rw", "c 510:1 rw")
    creates = plan.batch_creates(plans)
    assert [op[0] for op in creates] == [
        "/dev/nvidia0", "/dev/nvidiactl", "/dev/nvidia-uvm",
        "/dev/nvidia-uvm-tools", "/dev/nvidia1"]
    assert bpf.chip_majmins(chips) == [(195, 0), (195, 255), (510, 0),
                                       (510, 1), (195, 1)]


def test_one_gpu_detach_keeps_the_shared_companions():
    """Detaching GPU 1 while GPU 0 stays revokes only GPU 1's own node;
    the last GPU out takes the companions with it (the rule the mounter
    unlinks nodes by, tests/test_torch_actuation.py)."""
    g0, g1 = make_chips(2)
    assert bpf.revoked_majmins([g1], [g0]) == [(195, 1)]
    assert bpf.revoked_majmins([g0], []) == [
        (195, 0), (195, 255), (510, 0), (510, 1)]


def test_plan_cache_recomputes_a_stale_entry():
    cache = plan.NodePlanCache()
    chips = make_chips(2)
    cache.rebuild(chips)
    assert len(cache) == 2 and cache.builds == 1
    assert cache.plan_for(chips[0]) is cache.plan_for(chips[0])
    moved = GPUDevice(**{**chips[0].__dict__, "minor": 9})
    assert cache.plan_for(moved).creates[0] == ("/dev/nvidia0", 195, 9)


def test_one_tree_two_families_same_shape_and_busy_pids(gpu_host):
    """One fixture tree with accelN (120:N) and nvidiaN (195:N) nodes and
    the same /proc/<pid>/fd links: each package enumerates its own family,
    with the same (path, major, minor) shape, and finds the same busy
    PIDs."""
    from gpumounter_tpu.device.enumerator import PyEnumerator as TpuEnumerator
    from gpumounter_tpu.device.native_enumerator import \
        NativeEnumerator as TpuNative
    from gpumounter_tpu.utils.config import HostPaths as TpuHostPaths
    from gpumounter_tpu_torch.device.native_enumerator import \
        NativeEnumerator, load_library

    make_gpu_tree(gpu_host, range(3))
    for i in range(3):
        path = os.path.join(gpu_host.dev_root, f"accel{i}")
        open(path, "w").close()
        with open(path + ".majmin", "w") as f:
            f.write(f"120:{i}")
    dev = gpu_host.dev_root
    for pid, targets in ((100, ("accel0", "nvidia0")),
                         (200, ("accel2", "nvidia2", "nvidiactl")),
                         (300, ("null",))):
        for fd, name in enumerate(targets, 3):
            link_fd(gpu_host, pid, fd, os.path.join(dev, name))
    tpu_host = TpuHostPaths(dev_root=gpu_host.dev_root,
                            proc_root=gpu_host.proc_root,
                            sys_root=gpu_host.sys_root)
    ours = [PyEnumerator(gpu_host, allow_fake=True)]
    if load_library() is not None:
        ours.append(NativeEnumerator(gpu_host, allow_fake=True))
    theirs = [TpuEnumerator(tpu_host, allow_fake=True),
              TpuNative(tpu_host, allow_fake=True)]

    def shape(devices, family):
        return [(os.path.dirname(d.device_path),
                 os.path.basename(d.device_path).removeprefix(family),
                 d.index, d.minor) for d in devices]

    pids = [100, 200, 300, 400]
    for enum in theirs:
        chips = enum.enumerate()
        assert {c.major for c in chips} == {120}
        assert shape(chips, "accel") == [(dev, str(i), i, i)
                                         for i in range(3)]
        assert enum.device_open_pids(
            pids, [c.device_path for c in chips]) == [100, 200]
        assert enum.device_open_pids(pids, [chips[2].device_path]) == [200]
    for enum in ours:
        devices = enum.enumerate()
        assert {d.major for d in devices} == {195}
        assert shape(devices, "nvidia") == [(dev, str(i), i, i)
                                            for i in range(3)]
        assert enum.device_open_pids(
            pids, [d.device_path for d in devices]) == [100, 200]
        assert enum.device_open_pids(pids, [devices[2].device_path]) == [200]


def test_shared_constants_and_host_paths_match_the_control_plane():
    import dataclasses

    from gpumounter_tpu.utils import config as tpu_config
    from gpumounter_tpu.utils import consts as tpu_consts
    from gpumounter_tpu_torch.utils import consts
    assert consts.GPU_RESOURCE_NAME == tpu_consts.GPU_RESOURCE_NAME
    assert consts.DEVICE_CGROUP_PERMISSIONS == \
        tpu_consts.DEVICE_CGROUP_PERMISSIONS
    assert consts.DEVICE_FILE_MODE == tpu_consts.DEVICE_FILE_MODE == 0o666
    assert dataclasses.asdict(HostPaths()) == dataclasses.asdict(
        tpu_config.HostPaths())


def test_json_log_lines_match_the_control_plane():
    import logging

    from gpumounter_tpu.utils import log as tpu_log
    from gpumounter_tpu_torch.utils import log
    record = logging.LogRecord("tpumounter.device.enumerator", logging.INFO,
                               __file__, 1, "found %d GPUs", (2,), None)
    assert json.loads(log.JsonFormatter().format(record)) == json.loads(
        tpu_log.JsonFormatter().format(record))
    assert log.get_logger("device").name == tpu_log.get_logger(
        "device").name == "tpumounter.device"


def test_init_logger_writes_json_lines_once(monkeypatch, capsys):
    """``LOG_FORMAT=json`` gives one JSON object per record on stdout, at
    the level asked for; a second call adds no handler."""
    import logging

    from gpumounter_tpu_torch.utils import log
    monkeypatch.setenv("LOG_FORMAT", "json")
    monkeypatch.setattr(log, "_configured", False)
    root = logging.getLogger("tpumounter")
    handlers, level = list(root.handlers), root.level
    try:
        log.init_logger(level=logging.INFO)
        log.init_logger()
        assert len(root.handlers) == len(handlers) + 1
        logger = log.get_logger("device.enumerator")
        logger.debug("not shown")
        logger.info("found %d GPUs", 2)
    finally:
        for h in root.handlers[len(handlers):]:
            root.removeHandler(h)
        root.setLevel(level)
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()
             if line.startswith("{")]
    assert [(r["level"], r["logger"], r["message"]) for r in lines] == [
        ("INFO", "tpumounter.device.enumerator", "found 2 GPUs")]
