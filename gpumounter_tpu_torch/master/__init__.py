"""Cluster-facing master: REST gateway + worker discovery (the port of
:mod:`gpumounter_tpu.master`, single-master path)."""

from gpumounter_tpu_torch.master.discovery import WorkerDirectory
from gpumounter_tpu_torch.master.gateway import MasterGateway

__all__ = ["MasterGateway", "WorkerDirectory"]
