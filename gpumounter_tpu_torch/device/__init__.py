"""The GPU device layer: the device model, the node enumerator (Python and
native) and the per-chip actuation plans — the port of
:mod:`gpumounter_tpu.device` for NVIDIA GPUs."""

from gpumounter_tpu_torch.device.model import DeviceState, GPUDevice

__all__ = ["DeviceState", "GPUDevice"]
