"""Slave-pod allocation layer (scheduler integration) for NVIDIA GPUs."""

from gpumounter_tpu_torch.allocator.allocator import (AllocationStats,
                                                      GPUAllocator)

__all__ = ["AllocationStats", "GPUAllocator"]
