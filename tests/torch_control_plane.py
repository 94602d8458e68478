"""Both packages' control planes side by side, for the worker's parity tests.

A :class:`Pkg` names one package's modules and the few names that follow
the device (``add_tpu``/``add_gpu``, ``InsufficientTPU``/
``InsufficientGPU``, ``google.com/tpu``/``nvidia.com/gpu``, ...), so one
scenario runs through either package unchanged. The ``norm_*`` helpers map
what differs by device onto roles, so results compare across packages:
chip or GPU ``i`` (``accelN`` / ``nvidiaN``, uuid ``"i"`` / ``GPU-...``)
becomes ``devN``, a companion node its name, a result enum its role.
"""

from __future__ import annotations

import importlib
import os
import re
import types

PACKAGES = {"jax": "gpumounter_tpu", "torch": "gpumounter_tpu_torch"}
MODULES = ("actuation.agent", "actuation.cgroup", "actuation.gate",
           "actuation.nsenter", "allocator", "allocator.allocator",
           "allocator.topology", "device.fake", "k8s.client", "k8s.informer",
           "k8s.objects", "testing.chaos", "testing.http_apiserver",
           "master.admission", "master.discovery", "master.fleet",
           "master.gateway", "master.httpfront", "master.lease",
           "master.shardring", "master.waiterindex", "testing.sim",
           "utils.config", "utils.consts", "utils.errors", "utils.events",
           "utils.metrics", "utils.parking", "utils.retry", "utils.slo",
           "utils.trace", "worker.drain", "worker.grpc_server",
           "worker.journal", "worker.main", "worker.pool",
           "worker.reconciler", "worker.service")


class Pkg(types.SimpleNamespace):
    """One package's modules (``pkg.mod("worker.service")``) and its
    device-named members."""

    def mod(self, name: str):
        return self.modules[name]

    @property
    def consts(self):
        return self.mod("utils.consts")

    @property
    def errors(self):
        return self.mod("utils.errors")

    @property
    def registry(self):
        return self.mod("utils.metrics").REGISTRY

    def host(self, root) -> object:
        """This package's ``HostPaths`` over a fixture tree under ``root``."""
        root = str(root)
        for sub in ("dev", "proc", "sys/fs/cgroup"):
            os.makedirs(os.path.join(root, sub), exist_ok=True)
        return self.mod("utils.config").HostPaths(
            dev_root=os.path.join(root, "dev"),
            proc_root=os.path.join(root, "proc"),
            sys_root=os.path.join(root, "sys"),
            cgroup_root=os.path.join(root, "sys", "fs", "cgroup"),
            kubelet_socket=os.path.join(root, "pod-resources",
                                        "kubelet.sock"))

    def rig(self, root, **kwargs):
        """A ``WorkerRig`` over a fixture tree under ``root``."""
        return self.mod("testing.sim").WorkerRig(self.host(root), **kwargs)

    # -- the worker's calls, by role -------------------------------------------

    def add(self, service, pod, namespace, n, entire, **kw):
        return getattr(service, f"add_{self.dev}")(pod, namespace, n, entire,
                                                   **kw)

    def remove(self, service, pod, namespace, uuids, force, **kw):
        return getattr(service, f"remove_{self.dev}")(pod, namespace, uuids,
                                                      force, **kw)

    def status(self, service, pod, namespace):
        return getattr(service, f"{self.dev}_status")(pod, namespace)

    def uuid(self, i: int) -> str:
        """The fake enumerator's uuid of device ``i``."""
        return self.mod("device.fake").make_chips(i + 1)[i].uuid


def _load(name: str) -> Pkg:
    root = PACKAGES[name]
    modules = {m: importlib.import_module(f"{root}.{m}") for m in MODULES}
    torch = name == "torch"
    dev = "gpu" if torch else "tpu"
    return Pkg(
        name=name, root=root, modules=modules, dev=dev,
        Allocator=getattr(modules["allocator"],
                          "GPUAllocator" if torch else "TPUAllocator"),
        Service=getattr(modules["worker.service"],
                        "GPUMountService" if torch else "TPUMountService"),
        Insufficient=getattr(modules["utils.errors"],
                             "InsufficientGPUError" if torch
                             else "InsufficientTPUError"),
        resource=modules["utils.consts"].GPU_RESOURCE_NAME if torch
        else modules["utils.consts"].TPU_RESOURCE_NAME)


JAX, TORCH = _load("jax"), _load("torch")
BOTH = (JAX, TORCH)
IDS = [p.name for p in BOTH]

# Result enum members by role: the port's names follow the GPU.
RESULT_ROLES = {"INSUFFICIENT_TPU": "INSUFFICIENT", "INSUFFICIENT_GPU":
                "INSUFFICIENT", "TPU_BUSY": "BUSY", "GPU_BUSY": "BUSY",
                "TPU_NOT_FOUND": "NOT_FOUND", "GPU_NOT_FOUND": "NOT_FOUND"}


def norm_result(result) -> str:
    """An AddResult/RemoveResult (or its name) by role."""
    name = getattr(result, "name", str(result))
    return RESULT_ROLES.get(name, name)


def norm_uuid(uuid: str) -> str:
    """``devN`` for a fake device's uuid of either package."""
    m = re.fullmatch(r"GPU-([0-9a-f]{8})-.*", uuid)
    return f"dev{int(m.group(1), 16)}" if m else f"dev{uuid}"


COMPANION_ROLES = {"nvidiactl": "ctl", "nvidia-uvm": "uvm",
                   "nvidia-uvm-tools": "uvm-tools"}


def norm_path(path: str) -> str:
    """``devN`` for a device node of either package, a companion's role."""
    base = os.path.basename(path)
    m = re.fullmatch(r"(?:accel|nvidia)(\d+)", base)
    return f"dev{m.group(1)}" if m else COMPANION_ROLES.get(base, base)


def norm_text(text: str) -> str:
    """Device words of either package replaced by roles, for messages and
    pod specs compared as text."""
    for a, b in (("google.com/tpu", "<resource>"),
                 ("nvidia.com/gpu", "<resource>"),
                 ("tpu-pool", "<pool>"), ("gpu-pool", "<pool>"),
                 ("tpu-holder", "<holder>"), ("gpu-holder", "<holder>")):
        text = text.replace(a, b)
    text = re.sub(r"GPU-([0-9a-f]{8})-[0-9a-f-]+",
                  lambda m: f"dev{int(m.group(1), 16)}", text)
    return re.sub(r"\b(TPU|GPU)(?=[A-Z][a-z])", "<DEV>", text)
