"""Per-node worker: mount orchestration service + gRPC server."""

from gpumounter_tpu_torch.worker.service import (AddOutcome, GPUMountService,
                                                 RemoveOutcome)

__all__ = ["GPUMountService", "AddOutcome", "RemoveOutcome"]
