"""Device discovery and cluster-state reconciliation for NVIDIA GPUs (the
port of :mod:`gpumounter_tpu.collector`; ref ``pkg/util/gpu/collector``)."""

from gpumounter_tpu_torch.collector.collector import GPUCollector

__all__ = ["GPUCollector"]
