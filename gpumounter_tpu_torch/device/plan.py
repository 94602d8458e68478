"""Precomputed per-node actuation plans (the port of
:mod:`gpumounter_tpu.device.plan`).

The facts actuation needs about a GPU — which container paths to mknod,
which (major, minor) pairs the cgroup rules need, which companion nodes
are shared and must be deduplicated — change only on hot-plug, so they are
frozen per enumeration into an immutable :class:`ChipPlan`. On an NVIDIA
node every GPU shares ``nvidiactl`` and the uvm pair: :func:`batch_creates`
makes each shared node once per container. What a detach may revoke and
unlink is the device gate's decision
(:func:`gpumounter_tpu_torch.actuation.bpf.revoked_majmins`): never a
shared node a GPU that stays still needs.
"""

from __future__ import annotations

import dataclasses
import threading

from gpumounter_tpu_torch.device.model import GPUDevice
from gpumounter_tpu_torch.utils import consts

# One device-node operation: (container_path, major, minor).
PlanOp = tuple[str, int, int]


@dataclasses.dataclass(frozen=True)
class ChipPlan:
    """Everything actuation needs to know about one GPU, precomputed: node
    creates (GPU + companions), node paths for removal, the deduplicated
    (major, minor) set, and the rendered cgroup-v1 rule strings."""

    uuid: str
    creates: tuple[PlanOp, ...]
    removes: tuple[str, ...]
    majmins: tuple[tuple[int, int], ...]
    v1_rules: tuple[str, ...]
    companion_host_paths: tuple[str, ...]

    @classmethod
    def for_chip(cls, chip: GPUDevice) -> "ChipPlan":
        creates: list[PlanOp] = [(chip.container_path, chip.major,
                                  chip.minor)]
        majmins: list[tuple[int, int]] = [(chip.major, chip.minor)]
        companions: list[str] = []
        for companion in chip.companions:
            creates.append((companion.container_path, companion.major,
                            companion.minor))
            if (companion.major, companion.minor) not in majmins:
                majmins.append((companion.major, companion.minor))
            companions.append(companion.host_path)
        return cls(
            uuid=chip.uuid,
            creates=tuple(creates),
            removes=tuple(op[0] for op in creates),
            majmins=tuple(majmins),
            v1_rules=tuple(
                f"c {major}:{minor} {consts.DEVICE_CGROUP_PERMISSIONS}"
                for major, minor in majmins),
            companion_host_paths=tuple(companions),
        )


class NodePlanCache:
    """uuid -> :class:`ChipPlan` for the node's current inventory.
    ``rebuild`` swaps in a whole new mapping, so a reader racing a hot-plug
    sees the old or the new inventory, never a mix; an unknown or stale
    entry is computed from the device instead."""

    def __init__(self):
        self._plans: dict[str, ChipPlan] = {}
        self._lock = threading.Lock()
        self.builds = 0

    def rebuild(self, chips: list[GPUDevice]) -> None:
        plans = {chip.uuid: ChipPlan.for_chip(chip) for chip in chips}
        with self._lock:
            self._plans = plans
            self.builds += 1

    def plan_for(self, chip: GPUDevice) -> ChipPlan:
        plan = self._plans.get(chip.uuid)        # immutable dict: no lock
        if plan is None or plan.creates[0][1:] != (chip.major, chip.minor):
            return ChipPlan.for_chip(chip)
        return plan

    def __len__(self) -> int:
        return len(self._plans)


def batch_creates(plans: list[ChipPlan]) -> list[PlanOp]:
    """Fused create list for one container: every GPU's nodes, shared
    companions deduplicated to exactly one op."""
    seen: set[PlanOp] = set()
    out: list[PlanOp] = []
    for plan in plans:
        for op in plan.creates:
            if op not in seen:
                seen.add(op)
                out.append(op)
    return out
