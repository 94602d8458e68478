"""GPU device model.

Counterpart of :mod:`gpumounter_tpu.device.model` for NVIDIA GPUs, the
device world of the reference's ``pkg/device/nvidia.go`` (``NvidiaGPU``,
FREE/ALLOCATED, the device-file constants):

- a GPU is the char node ``/dev/nvidiaN`` at the fixed major 195, minor N
  (``TPUChip``'s major is dynamic);
- ``uuid`` is the driver's ``GPU-...`` string, the id by which the kubelet
  reports an allocated ``nvidia.com/gpu``; it comes from the driver
  (``/proc/driver/nvidia/gpus`` or NVML), never from the index;
- the companion nodes ``/dev/nvidiactl``, ``/dev/nvidia-uvm`` and
  ``/dev/nvidia-uvm-tools`` are shared by every GPU of a node.
"""

from __future__ import annotations

import dataclasses
import enum
import json
import os


class DeviceState(str, enum.Enum):
    FREE = "FREE"
    ALLOCATED = "ALLOCATED"


def container_device_path(host_path: str) -> str:
    """Canonical in-container node path for a host device path: vfio nodes
    live at ``/dev/vfio/<name>``, everything else at ``/dev/<name>``."""
    base = os.path.basename(host_path)
    parent = os.path.basename(os.path.dirname(host_path))
    if parent == "vfio":
        return f"/dev/vfio/{base}"
    return f"/dev/{base}"


@dataclasses.dataclass(frozen=True)
class CompanionNode:
    """A device node exposed alongside a GPU for the runtime to work
    (``nvidiactl``, ``nvidia-uvm``, ``nvidia-uvm-tools``), with its own
    major:minor so cgroup permissioning can cover it."""

    host_path: str
    major: int
    minor: int

    @property
    def container_path(self) -> str:
        return container_device_path(self.host_path)


@dataclasses.dataclass
class GPUDevice:
    """One attachable GPU on this node."""

    index: int                  # N of /dev/nvidiaN (the minor)
    device_path: str            # e.g. /dev/nvidia0
    major: int                  # 195 (nvidia.go:37)
    minor: int
    uuid: str                   # driver UUID "GPU-...", "" if no source had it
    pci_address: str = ""       # e.g. 0000:18:00.0, "" if unknown
    companions: tuple[CompanionNode, ...] = ()
    state: DeviceState = DeviceState.FREE
    pod_name: str = ""          # set when ALLOCATED
    namespace: str = ""
    # the node's accelerator label, stamped by the allocator at allocation
    # time ("" when the node advertises none)
    accelerator: str = ""       # e.g. nvidia-h100-80gb
    topology: str = ""

    @property
    def container_path(self) -> str:
        """Device-node path inside the target container, independent of
        the host ``dev_root`` the GPU was enumerated under."""
        return container_device_path(self.device_path)

    def reset_state(self) -> None:
        """Back to FREE with no pod binding."""
        self.state = DeviceState.FREE
        self.pod_name = ""
        self.namespace = ""

    def __str__(self) -> str:
        return json.dumps(dataclasses.asdict(self), default=str,
                          sort_keys=True)
