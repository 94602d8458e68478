"""GPU group rules for entire-mount (the port of
:mod:`gpumounter_tpu.allocator.topology`).

The TPU control plane validates an entire mount against the node's ICI mesh:
a power-of-two divisor of the host, or the whole host on a multi-host
slice. An NVIDIA node's GPUs sit behind NVSwitch, where any group of them
talks at full bandwidth, and GKE's GPU machines carry 1, 2, 4 or 8 GPUs.
So the rule is the reference's count-only ``isEntireMount``
(``pkg/server/gpu-mount/server.go:62-66``): any count from 1 to the node's
GPU count forms a valid group. There is no multi-host case.

- The accelerator comes from the GKE node-pool label
  ``cloud.google.com/gke-accelerator`` (e.g. ``nvidia-h100-80gb``).
- ``gpus_per_node`` comes from the node's allocatable ``nvidia.com/gpu``:
  ground truth from the device plugin, not a machine-type table.
- A node without the label (non-GKE, test nodes) is unconstrained.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from gpumounter_tpu_torch.utils import consts
from gpumounter_tpu_torch.utils.errors import TopologyError
from gpumounter_tpu_torch.utils.log import get_logger

logger = get_logger("allocator.topology")

Node = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class NodeTopology:
    """What one node advertises about its GPUs."""

    accelerator: str        # e.g. nvidia-h100-80gb
    gpus_per_node: int      # allocatable nvidia.com/gpu on this node

    # One node is the whole NVSwitch domain: no mesh string, no hosts.
    topology: str = ""

    @property
    def num_hosts(self) -> int:
        return 1 if self.gpus_per_node > 0 else 0

    @property
    def multi_host(self) -> bool:
        return False

    def slave_pod_labels(self) -> dict[str, str]:
        """Labels stamped on slave pods so a mount's accelerator is readable
        from the pool namespace without a node round trip."""
        return {consts.GPU_ACCELERATOR_LABEL_KEY: self.accelerator}


def node_topology(node: Node | None) -> NodeTopology | None:
    """The node's advertised GPUs, or None when the node carries no GKE
    accelerator label (no group rule applies)."""
    if not node:
        return None
    labels = node.get("metadata", {}).get("labels", {}) or {}
    accelerator = labels.get(consts.LABEL_GPU_ACCELERATOR, "")
    if not accelerator:
        return None
    status = node.get("status", {}) or {}
    alloc = (status.get("allocatable") or status.get("capacity") or {})
    try:
        gpus = int(alloc.get(consts.GPU_RESOURCE_NAME, 0))
    except (TypeError, ValueError):
        gpus = 0
    return NodeTopology(accelerator=accelerator, gpus_per_node=gpus)


def aligned_group_sizes(topo: NodeTopology) -> list[int]:
    """Entire-mount sizes this node can serve: every count up to its GPUs."""
    return list(range(1, max(topo.gpus_per_node, 0) + 1))


def validate_entire_mount(topo: NodeTopology | None, gpu_num: int) -> None:
    """Raises :class:`TopologyError` when an entire mount of ``gpu_num``
    GPUs exceeds what the node has. No-op for nodes without the label or
    without a readable GPU count."""
    if topo is None or topo.gpus_per_node <= 0:
        return
    if 1 <= gpu_num <= topo.gpus_per_node:
        return
    raise TopologyError(
        f"entire-mount of {gpu_num} GPUs does not fit this "
        f"{topo.gpus_per_node}-GPU node, accelerator={topo.accelerator}; "
        f"valid sizes: 1-{topo.gpus_per_node}")
