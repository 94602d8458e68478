"""In-memory fake enumerator for unit tests (the port of
:mod:`gpumounter_tpu.device.fake`)."""

from __future__ import annotations

import copy

from gpumounter_tpu_torch.device.enumerator import Enumerator
from gpumounter_tpu_torch.device.model import CompanionNode, GPUDevice
from gpumounter_tpu_torch.utils import consts

# the shared nodes of a fake node: nvidiactl, and the uvm pair at a uvm
# major a host might register
FAKE_UVM_MAJOR = 510
FAKE_COMPANIONS = (
    CompanionNode("/dev/nvidiactl", consts.NVIDIA_MAJOR,
                  consts.NVIDIA_CTL_MINOR),
    CompanionNode("/dev/nvidia-uvm", FAKE_UVM_MAJOR, 0),
    CompanionNode("/dev/nvidia-uvm-tools", FAKE_UVM_MAJOR, 1),
)


def fake_uuid(i: int) -> str:
    """A driver-shaped UUID for fake GPU ``i``."""
    return f"GPU-{i:08x}-0000-4000-8000-{i:012x}"


def make_chips(n: int, companions: tuple[CompanionNode, ...] = FAKE_COMPANIONS
               ) -> list[GPUDevice]:
    """``n`` fake GPUs: ``/dev/nvidiaN`` at 195:N with ``GPU-...`` UUIDs,
    every one sharing ``companions``."""
    return [
        GPUDevice(index=i, device_path=f"/dev/nvidia{i}",
                  major=consts.NVIDIA_MAJOR, minor=i, uuid=fake_uuid(i),
                  pci_address=f"0000:{0x18 + i:02x}:00.0",
                  companions=companions)
        for i in range(n)
    ]


class FakeEnumerator(Enumerator):
    def __init__(self, chips: list[GPUDevice] | None = None,
                 busy_pids: dict[str, list[int]] | None = None):
        self.chips = chips if chips is not None else make_chips(4)
        # device_path -> pids that "hold it open"
        self.busy_pids = busy_pids or {}

    def enumerate(self) -> list[GPUDevice]:
        return copy.deepcopy(self.chips)

    def device_open_pids(self, pids: list[int],
                         device_paths: list[str]) -> list[int]:
        out: list[int] = []
        for pid in pids:
            for path in device_paths:
                if pid in self.busy_pids.get(path, []):
                    out.append(pid)
                    break
        return out
