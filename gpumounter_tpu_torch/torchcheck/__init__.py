"""PyTorch-side validation harness.

After an attach, a process inside the Pod should see the GPUs and be able
to run real computation on them. This package is that in-pod probe plus
the workload it runs: the flagship decoder LM's train step, with causal
flash attention on hand-written Hopper kernels (:mod:`.kernels`).

Every entry point takes ``device`` (default ``"cuda"``) and raises when no
GPU is present, unless the caller asked for the CPU: a measurement or a
probe that quietly fell back to the CPU would report the wrong device.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises when it names CUDA and no
    GPU is visible (never falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but no CUDA device is visible; "
            "pass device='cpu' to run on the CPU")
    return dev
