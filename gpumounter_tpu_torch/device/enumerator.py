"""GPU enumeration and device busy-detection.

Counterpart of :mod:`gpumounter_tpu.device.enumerator` for NVIDIA GPUs,
in the place of the reference's NVML binding
(``pkg/util/gpu/collector/nvml/nvml.go``: device count, handle by index,
minor number, UUID). It reads:

- ``/dev/nvidia[0-9]+`` char nodes, major 195 (a node of another major is
  not a GPU and is skipped), and ``stat(2)`` for the major:minor;
- the companions every GPU shares (``nvidiactl``, ``nvidia-uvm``,
  ``nvidia-uvm-tools``), where present;
- ``/proc/devices`` for the driver majors, the uvm module's being dynamic;
- the minor -> UUID / PCI address map from the driver's
  ``/proc/driver/nvidia/gpus/<pci>/information`` (``Device Minor:``,
  ``GPU UUID:``, ``Bus Location:``). Where that tree is absent (a container
  runtime may not expose it) and ``libnvidia-ml.so.1`` loads, the same
  facts come from NVML through ``ctypes`` (``nvmlDeviceGetMinorNumber``,
  ``nvmlDeviceGetUUID``, ``nvmlDeviceGetPciInfo``), as the reference's
  ``nvml_dl.go`` dlopens it. The enumerator reports which source it read
  (``uuid_source``); a node neither source knows keeps ``uuid=""``.

Two implementations share the :class:`Enumerator` interface:
:class:`PyEnumerator` (this module, also the harness for fixture trees)
and ``NativeEnumerator`` (:mod:`.native_enumerator`, backed by
``libgpuprobe.so``).

Busy detection: given candidate PIDs (a container's cgroup PIDs), scan
``/proc/<pid>/fd`` for open fds on the devices' nodes (the reference asks
NVML for per-GPU processes; this works without it, in any container).
"""

from __future__ import annotations

import abc
import ctypes
import dataclasses
import os
import re
import stat as stat_mod
import time
from typing import Callable

from gpumounter_tpu_torch.device.model import (CompanionNode, DeviceState,
                                               GPUDevice)
from gpumounter_tpu_torch.utils import consts
from gpumounter_tpu_torch.utils.config import HostPaths
from gpumounter_tpu_torch.utils.log import get_logger

logger = get_logger("device.enumerator")

_NVIDIA_RE = re.compile(r"^nvidia(\d+)$")
NVML_LIB = "libnvidia-ml.so.1"
_UUID_BUFFER = 96           # NVML_DEVICE_UUID_V2_BUFFER_SIZE

# minor -> (uuid, pci address)
Identities = dict[int, tuple[str, str]]


class Enumerator(abc.ABC):
    """Enumerate attachable GPUs on this node and probe device usage."""

    @abc.abstractmethod
    def enumerate(self) -> list[GPUDevice]:
        """Return all GPUs whose nodes are present on the node."""

    @abc.abstractmethod
    def device_open_pids(self, pids: list[int],
                         device_paths: list[str]) -> list[int]:
        """Subset of ``pids`` holding an open fd on any of ``device_paths``."""


def read_proc_devices(proc_root: str) -> dict[str, int]:
    """Parse the char section of ``/proc/devices`` into {driver: major}."""
    majors: dict[str, int] = {}
    path = os.path.join(proc_root, "devices")
    try:
        with open(path) as f:
            in_char = False
            for line in f:
                line = line.strip()
                if line.startswith("Character devices"):
                    in_char = True
                    continue
                if line.startswith("Block devices"):
                    break
                if in_char and line:
                    parts = line.split(None, 1)
                    if len(parts) == 2 and parts[0].isdigit():
                        majors[parts[1]] = int(parts[0])
    except OSError:
        logger.warning("cannot read %s; majors will come from stat only", path)
    return majors


def _stat_majmin(path: str) -> tuple[int, int] | None:
    try:
        st = os.stat(path)
    except OSError:
        return None
    if stat_mod.S_ISCHR(st.st_mode):
        return os.major(st.st_rdev), os.minor(st.st_rdev)
    return None


def resolve_majmin(path: str, allow_fake: bool = False,
                   fallback: tuple[int, int] = (0, 0)
                   ) -> tuple[int, int] | None:
    """major:minor of a device node: stat(2) for real char devices; with
    ``allow_fake``, a regular file's ``<path>.majmin`` sidecar
    (``"<major>:<minor>"``), or ``fallback`` without one. The one home of
    the fixture format."""
    majmin = _stat_majmin(path)
    if majmin is not None:
        return majmin
    if not allow_fake or not os.path.isfile(path):
        return None
    try:
        with open(path + ".majmin") as f:
            major_s, minor_s = f.read().strip().split(":")
            return int(major_s), int(minor_s)
    except (OSError, ValueError):
        return fallback


def normalize_pci_address(bus_id: str) -> str:
    """``domain:bus:device.function`` with a 4-digit domain, lower case:
    NVML and nvidia-smi print an 8-digit domain (``00000000:18:00.0``),
    the driver's proc tree a 4-digit one (``0000:18:00.0``)."""
    parts = bus_id.strip().lower().split(":")
    if len(parts) != 3:
        return bus_id.strip().lower()
    try:
        domain = int(parts[0], 16)
    except ValueError:
        return bus_id.strip().lower()
    return f"{domain:04x}:{parts[1]}:{parts[2]}"


def proc_gpus_dir(proc_root: str) -> str:
    return os.path.join(proc_root, "driver", "nvidia", "gpus")


def read_proc_identities(proc_root: str) -> Identities | None:
    """minor -> (uuid, pci address) from the driver's
    ``<proc>/driver/nvidia/gpus/<pci>/information`` files, or None when
    the tree is absent."""
    gpus = proc_gpus_dir(proc_root)
    try:
        entries = sorted(os.listdir(gpus))
    except OSError:
        return None
    out: Identities = {}
    for pci in entries:
        fields: dict[str, str] = {}
        try:
            with open(os.path.join(gpus, pci, "information")) as f:
                for line in f:
                    key, sep, value = line.partition(":")
                    if sep:
                        fields[key.strip()] = value.strip()
        except OSError:
            continue
        minor, uuid = fields.get("Device Minor", ""), fields.get("GPU UUID")
        if not minor.isdigit() or not uuid:
            continue
        out[int(minor)] = (uuid, normalize_pci_address(
            fields.get("Bus Location") or pci))
    return out


class _NvmlPciInfo(ctypes.Structure):
    """``nvmlPciInfo_t`` (the ``nvmlDeviceGetPciInfo_v3`` layout)."""

    _fields_ = [("busIdLegacy", ctypes.c_char * 16),
                ("domain", ctypes.c_uint),
                ("bus", ctypes.c_uint),
                ("device", ctypes.c_uint),
                ("pciDeviceId", ctypes.c_uint),
                ("pciSubSystemId", ctypes.c_uint),
                ("busId", ctypes.c_char * 32)]


def load_nvml():
    """``libnvidia-ml.so.1`` with the signatures the enumerator calls, or
    None where it does not load."""
    try:
        lib = ctypes.CDLL(NVML_LIB)
    except OSError:
        return None
    c_uint_p, handle_p = (ctypes.POINTER(ctypes.c_uint),
                          ctypes.POINTER(ctypes.c_void_p))
    for name, argtypes in (
            ("nvmlInit_v2", []), ("nvmlShutdown", []),
            ("nvmlDeviceGetCount_v2", [c_uint_p]),
            ("nvmlDeviceGetHandleByIndex_v2", [ctypes.c_uint, handle_p]),
            ("nvmlDeviceGetMinorNumber", [ctypes.c_void_p, c_uint_p]),
            ("nvmlDeviceGetUUID", [ctypes.c_void_p, ctypes.c_char_p,
                                   ctypes.c_uint]),
            ("nvmlDeviceGetPciInfo_v3", [ctypes.c_void_p,
                                         ctypes.POINTER(_NvmlPciInfo)])):
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def nvml_identities(lib=None) -> Identities | None:
    """minor -> (uuid, pci address) of every device NVML reports, or None
    when NVML is not there (no library, or its init fails). ``lib`` is
    :func:`load_nvml`'s by default."""
    lib = load_nvml() if lib is None else lib
    if lib is None or lib.nvmlInit_v2() != 0:
        return None
    try:
        count = ctypes.c_uint(0)
        if lib.nvmlDeviceGetCount_v2(ctypes.byref(count)) != 0:
            return None
        out: Identities = {}
        for i in range(count.value):
            handle = ctypes.c_void_p()
            minor = ctypes.c_uint(0)
            uuid = ctypes.create_string_buffer(_UUID_BUFFER)
            pci = _NvmlPciInfo()
            if (lib.nvmlDeviceGetHandleByIndex_v2(ctypes.c_uint(i),
                                                  ctypes.byref(handle))
                    or lib.nvmlDeviceGetMinorNumber(handle,
                                                    ctypes.byref(minor))
                    or lib.nvmlDeviceGetUUID(handle, uuid,
                                             ctypes.c_uint(_UUID_BUFFER))):
                continue
            bus = (pci.busId.decode() if lib.nvmlDeviceGetPciInfo_v3(
                handle, ctypes.byref(pci)) == 0 else "")
            out[minor.value] = (uuid.value.decode(),
                                normalize_pci_address(bus) if bus else "")
        return out
    finally:
        lib.nvmlShutdown()


def gpu_identities(proc_root: str,
                   nvml: Callable[[], Identities | None] = nvml_identities
                   ) -> tuple[str, Identities]:
    """(source, minor -> (uuid, pci)): the driver's proc tree where it is
    present ("proc"), else NVML where it loads ("nvml"), else ("none",
    {}) — a UUID is never made up."""
    ids = read_proc_identities(proc_root)
    if ids is not None:
        return "proc", ids
    ids = nvml()
    if ids is not None:
        return "nvml", ids
    return "none", {}


def companion_nodes(host: HostPaths,
                    allow_fake: bool = False) -> tuple[CompanionNode, ...]:
    """The shared nodes present under ``host.dev_root``, each with its own
    major:minor. A fixture file without a sidecar takes nvidiactl's
    195:255, or the uvm major from ``/proc/devices`` (minor 0 for
    ``nvidia-uvm``, 1 for the tools node)."""
    uvm_major = read_proc_devices(host.proc_root).get(
        consts.NVIDIA_UVM_PROC_DEVICES_NAME, 0)
    defaults = {consts.NVIDIA_CTL_NAME: (consts.NVIDIA_MAJOR,
                                         consts.NVIDIA_CTL_MINOR),
                consts.NVIDIA_UVM_NAME: (uvm_major, 0),
                consts.NVIDIA_UVM_TOOLS_NAME: (uvm_major, 1)}
    nodes = []
    for name in consts.NVIDIA_COMPANION_NAMES:
        path = os.path.join(host.dev_root, name)
        majmin = resolve_majmin(path, allow_fake, defaults[name])
        if majmin is not None:
            nodes.append(CompanionNode(path, *majmin))
    return tuple(nodes)


def make_devices(nodes: list[tuple[int, str, int, int]], ids: Identities,
                 companions: tuple[CompanionNode, ...]) -> list[GPUDevice]:
    """GPUDevices from (index, path, major, minor) nodes, each named by
    its minor's identity ("" where no source knew it)."""
    return [GPUDevice(index=index, device_path=path, major=major,
                      minor=minor, uuid=ids.get(minor, ("", ""))[0],
                      pci_address=ids.get(minor, ("", ""))[1],
                      companions=companions)
            for index, path, major, minor in nodes]


def _pristine_copy(dev: GPUDevice) -> GPUDevice:
    """A fresh-scan-equivalent copy of a cached device (allocation state
    and label stamps are per snapshot, not per device)."""
    return dataclasses.replace(dev, state=DeviceState.FREE, pod_name="",
                               namespace="", accelerator="", topology="")


class PyEnumerator(Enumerator):
    """Pure-Python node scan; also drives fixture trees in tests.

    ``allow_fake=True`` accepts regular files named ``nvidiaN`` (and the
    companions' names) as fake nodes, their major:minor from a
    ``<name>.majmin`` sidecar or 195:N. ``cache_ttl_s`` > 0 serves the last
    scan while the ``/dev`` directory's mtime is unchanged (nodes change
    only on hot-plug, which bumps it). ``nvml`` is the NVML reader (a test
    passes a fake). After :meth:`enumerate`, ``uuid_source`` says where the
    UUIDs came from: "proc", "nvml" or "none"."""

    def __init__(self, host: HostPaths | None = None, allow_fake: bool = False,
                 cache_ttl_s: float = 0.0,
                 nvml: Callable[[], Identities | None] = nvml_identities):
        self.host = host or HostPaths()
        self.allow_fake = allow_fake
        self.cache_ttl_s = cache_ttl_s
        self.nvml = nvml
        self.uuid_source: str | None = None
        self._cache: list[GPUDevice] | None = None
        self._cache_at = 0.0
        self._cache_sig: tuple | None = None

    def _dir_signature(self) -> tuple | None:
        try:
            st = os.stat(self.host.dev_root)
        except OSError:
            return None
        return st.st_mtime_ns, st.st_ino

    def enumerate(self) -> list[GPUDevice]:
        if self.cache_ttl_s > 0 and self._cache is not None:
            if (time.monotonic() - self._cache_at < self.cache_ttl_s
                    and self._dir_signature() == self._cache_sig):
                return [_pristine_copy(d) for d in self._cache]
        nodes = self._scan()
        self.uuid_source, ids = (gpu_identities(self.host.proc_root,
                                                self.nvml)
                                 if nodes else ("none", {}))
        devices = make_devices(nodes, ids,
                               companion_nodes(self.host, self.allow_fake))
        if self.cache_ttl_s > 0:
            self._cache = devices
            self._cache_at = time.monotonic()
            self._cache_sig = self._dir_signature()
            # callers mutate returned devices (allocation state, label
            # stamps): hand out copies, keep the cache pristine
            return [_pristine_copy(d) for d in devices]
        return devices

    def _scan(self) -> list[tuple[int, str, int, int]]:
        try:
            entries = os.listdir(self.host.dev_root)
        except OSError:
            return []
        nodes = []
        for index in sorted(int(m.group(1)) for name in entries
                            if (m := _NVIDIA_RE.match(name))):
            path = os.path.join(self.host.dev_root, f"nvidia{index}")
            majmin = resolve_majmin(path, self.allow_fake,
                                    (consts.NVIDIA_MAJOR, index))
            if majmin is None:
                continue
            if majmin[0] != consts.NVIDIA_MAJOR:
                logger.debug("%s has major %d, not a GPU node", path,
                             majmin[0])
                continue
            nodes.append((index, path, *majmin))
        return nodes

    def device_open_pids(self, pids: list[int],
                         device_paths: list[str]) -> list[int]:
        targets = set(device_paths)
        busy: list[int] = []
        for pid in pids:
            fd_dir = os.path.join(self.host.proc_root, str(pid), "fd")
            try:
                fds = os.listdir(fd_dir)
            except OSError:
                continue  # process exited, or no permission
            for fd in fds:
                try:
                    target = os.readlink(os.path.join(fd_dir, fd))
                except OSError:
                    continue
                if target in targets:
                    busy.append(pid)
                    break
        return busy
