"""ctypes binding to the native GPU enumerator (``libgpuprobe.so``).

Counterpart of :mod:`gpumounter_tpu.device.native_enumerator`: the node
scan, the driver's proc-tree identities and the busy probe are native,
behind a narrow C ABI (``gpumounter_tpu_torch/native/gpuprobe.cc``).
Where the proc tree is absent, the UUIDs come from NVML in Python, as in
:class:`~.enumerator.PyEnumerator`. :func:`best_enumerator` falls back to
:class:`~.enumerator.PyEnumerator` when the library is not built; the two
behave alike (the tests pin it).
"""

from __future__ import annotations

import ctypes
import os
from typing import Callable

from gpumounter_tpu_torch.device.enumerator import (Enumerator, Identities,
                                                    PyEnumerator,
                                                    companion_nodes,
                                                    gpu_identities,
                                                    make_devices,
                                                    normalize_pci_address,
                                                    nvml_identities,
                                                    proc_gpus_dir)
from gpumounter_tpu_torch.device.model import GPUDevice
from gpumounter_tpu_torch.utils.config import HostPaths
from gpumounter_tpu_torch.utils.log import get_logger

logger = get_logger("device.native")

_LIB_NAME = "libgpuprobe.so"
_MAX_GPUS = 256
_ABI_VERSION = 1


class _GpuInfo(ctypes.Structure):
    _fields_ = [
        ("index", ctypes.c_int32),
        ("major", ctypes.c_int32),
        ("minor", ctypes.c_int32),
        ("device_path", ctypes.c_char * 256),
        ("pci_address", ctypes.c_char * 64),
        ("uuid", ctypes.c_char * 96),
    ]


def default_lib_path() -> str:
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.join(here, "..", "native", "build", _LIB_NAME)


def load_library(path: str | None = None) -> ctypes.CDLL | None:
    candidates = [path] if path else [
        default_lib_path(),
        os.path.join("/usr/local/lib", _LIB_NAME),
        _LIB_NAME,
    ]
    for cand in candidates:
        try:
            lib = ctypes.CDLL(cand)
        except OSError:
            continue
        lib.gpuprobe_enumerate.restype = ctypes.c_int
        lib.gpuprobe_enumerate.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int,
            ctypes.POINTER(_GpuInfo), ctypes.c_int]
        lib.gpuprobe_driver_major.restype = ctypes.c_int
        lib.gpuprobe_driver_major.argtypes = [ctypes.c_char_p,
                                              ctypes.c_char_p]
        lib.gpuprobe_open_pids.restype = ctypes.c_int
        lib.gpuprobe_open_pids.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int]
        lib.gpuprobe_abi_version.restype = ctypes.c_int
        lib.gpuprobe_abi_version.argtypes = []
        if lib.gpuprobe_abi_version() != _ABI_VERSION:
            logger.warning("%s has ABI %d, want %d — ignoring", cand,
                           lib.gpuprobe_abi_version(), _ABI_VERSION)
            continue
        return lib
    return None


class NativeEnumerator(Enumerator):
    """Enumerator backed by libgpuprobe.so. ``uuid_source`` as
    :class:`~.enumerator.PyEnumerator`'s."""

    def __init__(self, host: HostPaths | None = None, allow_fake: bool = False,
                 lib_path: str | None = None,
                 nvml: Callable[[], Identities | None] = nvml_identities):
        self.host = host or HostPaths()
        self.allow_fake = allow_fake
        self.nvml = nvml
        self.uuid_source: str | None = None
        self._lib = load_library(lib_path)
        if self._lib is None:
            raise OSError(f"{_LIB_NAME} not found; build "
                          "gpumounter_tpu_torch/native or use PyEnumerator")

    def enumerate(self) -> list[GPUDevice]:
        buf = (_GpuInfo * _MAX_GPUS)()
        n = self._lib.gpuprobe_enumerate(
            self.host.dev_root.encode(), self.host.proc_root.encode(),
            1 if self.allow_fake else 0, buf, _MAX_GPUS)
        if n < 0:
            raise OSError(f"gpuprobe_enumerate failed: {n}")
        nodes = [(buf[i].index, buf[i].device_path.decode(), buf[i].major,
                  buf[i].minor) for i in range(n)]
        if not nodes:
            self.uuid_source, ids = "none", {}
        elif os.path.isdir(proc_gpus_dir(self.host.proc_root)):
            self.uuid_source = "proc"
            ids = {buf[i].minor: (buf[i].uuid.decode(), normalize_pci_address(
                buf[i].pci_address.decode())) for i in range(n)
                if buf[i].uuid}
        else:
            # no proc tree: NVML, as the Python enumerator reads it
            self.uuid_source, ids = gpu_identities(self.host.proc_root,
                                                   self.nvml)
        return make_devices(nodes, ids,
                            companion_nodes(self.host, self.allow_fake))

    def device_open_pids(self, pids: list[int],
                         device_paths: list[str]) -> list[int]:
        if not pids or not device_paths:
            return []
        pid_arr = (ctypes.c_int32 * len(pids))(*pids)
        path_arr = (ctypes.c_char_p * len(device_paths))(
            *[p.encode() for p in device_paths])
        out = (ctypes.c_int32 * len(pids))()
        n = self._lib.gpuprobe_open_pids(
            self.host.proc_root.encode(), pid_arr, len(pids),
            path_arr, len(device_paths), out, len(pids))
        if n < 0:
            raise OSError(f"gpuprobe_open_pids failed: {n}")
        return [out[i] for i in range(n)]

    def driver_major(self, name: str) -> int | None:
        major = self._lib.gpuprobe_driver_major(
            self.host.proc_root.encode(), name.encode())
        return None if major < 0 else major


def best_enumerator(host: HostPaths | None = None,
                    allow_fake: bool = False,
                    cache_ttl_s: float = 0.0) -> Enumerator:
    """Native if built, Python otherwise — the same observable behaviour.
    ``cache_ttl_s`` enables the Python scanner's inventory cache (the
    native scan is one library call)."""
    try:
        return NativeEnumerator(host, allow_fake)
    except OSError:
        logger.info("native gpuprobe unavailable; using PyEnumerator")
        return PyEnumerator(host, allow_fake, cache_ttl_s=cache_ttl_s)
