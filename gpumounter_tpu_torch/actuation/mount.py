"""Mount/unmount façade: the one place that composes cgroup permissioning,
device-node lifecycle, busy detection, and mount policy (the port of
:mod:`gpumounter_tpu.actuation.mount`).

Ref ``pkg/util/util.go``: ``MountGPU`` (:17-71), ``UnmountGPU`` (:73-150),
``GetPodGPUProcesses`` (:152-196), ``CanMount`` (:207-226). Deliberate fixes:

- The reference blindly uses ``pids[0]`` as the representative container PID
  (util.go:50,118); we pick the first PID that still exists in /proc.
- Busy state is a typed :class:`DeviceBusyError` carrying the PIDs, not the
  string ``"GPUBusy"`` (util.go:108). A GPU is busy when a process of the
  pod holds its own node open; the shared companions do not count.
- Device access + node creation cover the companion nodes every GPU
  shares (``nvidiactl``, ``nvidia-uvm``, ``nvidia-uvm-tools``), which must
  ride along for the GPU to be usable. A detach unlinks a companion only
  when the device gate revokes it: no remaining GPU needs it and the
  container did not hold it before any attach.
"""

from __future__ import annotations

import concurrent.futures
import os

from gpumounter_tpu_torch.actuation.cgroup import CgroupDeviceController
from gpumounter_tpu_torch.actuation.gate import DeviceGate
from gpumounter_tpu_torch.actuation.nsenter import ContainerNsActuator
from gpumounter_tpu_torch.device.enumerator import Enumerator
from gpumounter_tpu_torch.device.model import GPUDevice
from gpumounter_tpu_torch.device.plan import NodePlanCache, batch_creates
from gpumounter_tpu_torch.k8s import objects
from gpumounter_tpu_torch.utils import consts
from gpumounter_tpu_torch.utils.config import HostPaths
from gpumounter_tpu_torch.utils.errors import (ActuationError, CgroupError,
                                               DeviceBusyError)
from gpumounter_tpu_torch.utils.log import get_logger
from gpumounter_tpu_torch.utils.metrics import REGISTRY

logger = get_logger("actuation.mount")

# Bound on concurrent per-container actuation threads (mirrors the slice
# coordinator's fan-out, master/slice.py).
_FAN_OUT_WORKERS = 8


def _observe_batch(op: str, size: int) -> None:
    REGISTRY.actuation_batches.inc(op=op)
    REGISTRY.actuation_batch_ops.inc(size, op=op)
    REGISTRY.actuation_batch_size.set(size, op=op)


def can_mount(current: consts.MountType, requested_entire: bool) -> bool:
    """Mount policy, ref util.go:207-226 CanMount:
    Unknown => deny; already mounted + entire request => deny;
    already entire-mounted => deny (only repeated single-mounts compose)."""
    if current is consts.MountType.UNKNOWN:
        return False
    if current is consts.MountType.NONE:
        return True
    if requested_entire:
        return False          # pod already has chips; entire must be atomic
    return current is consts.MountType.SINGLE


class GPUMounter:
    """Actuates attach/detach of GPUs for one target container."""

    def __init__(self, cgroups: CgroupDeviceController,
                 actuator: ContainerNsActuator, enumerator: Enumerator,
                 host: HostPaths | None = None,
                 plans: NodePlanCache | None = None,
                 gate: DeviceGate | None = None):
        self.cgroups = cgroups
        self.actuator = actuator
        self.enumerator = enumerator
        self.host = host or HostPaths()
        # Precomputed per-chip actuation plans (device/plan.py), rebuilt
        # by the collector on every enumeration. A fresh cache with no
        # builds behaves identically: plan_for computes from the chip.
        self.plans = plans if plans is not None else NodePlanCache()
        # The device-gate seam (actuation/gate.py): EVERY grant/revoke of
        # device permissions crosses it (tests/test_gate_lint.py pins no
        # path reaches the cgroup controller around it). None wires a
        # legacy passthrough — direct controller calls, byte-for-byte the
        # pre-gate behavior for rigs that predate it.
        self.gate = gate if gate is not None \
            else DeviceGate(cgroups, None, mode="legacy")

    # -- helpers ---------------------------------------------------------------

    def _target_container_ids(self, pod: objects.Pod) -> list[str]:
        """ALL running containers. The reference actuated and busy-checked
        only the first container (util.go:50) — in a multi-container pod a
        device holder in the second container was invisible to the busy
        pre-check, so detach could yank a device in use (SURVEY.md §8 says
        don't replicate)."""
        ids = objects.container_ids(pod)
        if not ids:
            raise ActuationError(
                f"pod {objects.name(pod)} has no running containers")
        return ids

    def _live_pid(self, pod: objects.Pod, container_id: str) -> int:
        """First PID of the container cgroup that is still alive
        (fixes util.go:50 pids[0] assumption)."""
        pids = self.cgroups.get_pids(pod, container_id)
        for pid in pids:
            if os.path.isdir(os.path.join(self.host.proc_root, str(pid))):
                return pid
        raise ActuationError(
            f"no live process in container {container_id} of pod "
            f"{objects.name(pod)}")

    @staticmethod
    def _node_paths(chip: GPUDevice) -> list[str]:
        """Paths a holder's fd on this GPU may resolve to: the host-side
        and container-side names of its own node. Not the companions:
        every CUDA process holds ``nvidiactl`` and ``nvidia-uvm`` open,
        whichever GPUs it uses, so a holder of them alone does not hold
        this GPU (the reference asks NVML for the GPU's own processes,
        util.go:152-196)."""
        return list(dict.fromkeys([chip.device_path, chip.container_path]))

    def _all_container_pids(self, pod: objects.Pod) -> list[int]:
        """Union of every container's cgroup PIDs (a holder may live in any
        container of the pod). Containers whose cgroup is gone (terminated
        sidecar) are skipped."""
        pids: list[int] = []
        for container_id in self._target_container_ids(pod):
            try:
                pids.extend(self.cgroups.get_pids(pod, container_id))
            except CgroupError:
                continue
        return sorted(set(pids))

    def _actuatable_containers(self, pod: objects.Pod) -> list[tuple[str, int]]:
        """(container_id, live_pid) for every container that can be
        actuated. Terminated containers keep their containerID in pod
        status but have no cgroup/processes — they are skipped, and only
        if NO container is actuatable does this raise (a completed sidecar
        must not block attach/detach for the main container)."""
        out: list[tuple[str, int]] = []
        for container_id in self._target_container_ids(pod):
            try:
                out.append((container_id,
                            self._live_pid(pod, container_id)))
            except (CgroupError, ActuationError):
                logger.debug("container %s of %s has no live cgroup/PID; "
                             "skipping actuation for it", container_id,
                             objects.name(pod))
        if not out:
            raise ActuationError(
                f"no actuatable container in pod {objects.name(pod)}: all "
                "containers' cgroups/processes are gone")
        return out

    def pod_device_processes(self, pod: objects.Pod,
                             chip: GPUDevice) -> list[int]:
        """PIDs inside ANY of the pod's containers holding this chip open
        (ref util.go:152-196: cgroup PIDs ∩ device holders — but across all
        containers, not just the first)."""
        try:
            pids = self._all_container_pids(pod)
        except ActuationError:
            return []
        return self.enumerator.device_open_pids(pids,
                                                self._node_paths(chip))

    def _busy_map(self, pod: objects.Pod,
                  chips: list[GPUDevice]) -> dict[str, list[int]]:
        """uuid -> holder PIDs, reading every container's cgroup.procs once."""
        pids = self._all_container_pids(pod)
        busy: dict[str, list[int]] = {}
        for chip in chips:
            holders = self.enumerator.device_open_pids(
                pids, self._node_paths(chip))
            if holders:
                busy[chip.uuid] = holders
        return busy

    def _fan_out_containers(self, containers: list[tuple[str, int]],
                            fn) -> list:
        """Run ``fn(container_id, pid)`` for every actuatable container —
        inline for the common single-container pod (no thread overhead,
        exact legacy semantics), bounded ThreadPoolExecutor otherwise
        (mirrors the slice coordinator's ``_fan_out``). Every container is
        attempted before the first error is re-raised, so a failing
        sidecar cannot leave the main container silently untouched —
        rollback then sees uniform state."""
        if len(containers) == 1:
            container_id, pid = containers[0]
            return [fn(container_id, pid)]
        with concurrent.futures.ThreadPoolExecutor(
                max_workers=min(_FAN_OUT_WORKERS, len(containers))) as ex:
            futures = [ex.submit(fn, container_id, pid)
                       for container_id, pid in containers]
            results, errors = [], []
            for future in futures:
                try:
                    results.append(future.result())
                except Exception as e:          # noqa: BLE001 — re-raised
                    errors.append(e)
            if errors:
                raise errors[0]
            return results

    # -- attach ----------------------------------------------------------------

    def mount_chips(self, pod: objects.Pod, new_chips: list[GPUDevice],
                    all_chips_after: list[GPUDevice]) -> int:
        """Expose ``new_chips`` inside the pod's containers.

        ``all_chips_after`` is the pod's complete chip set including the new
        ones — required because cgroup-v2 device programs are replaced whole
        (defaults ∪ all GPUs), not incremented.

        Ref util.go:17-71 MountGPU — but fused: ALL mknods for a container
        (GPUs + companions) go through ONE ``apply_device_nodes`` batch
        (:mod:`gpumounter_tpu_torch.actuation.nsenter`), so an entire-node
        attach costs one namespace crossing per container instead of one
        per node; containers fan out in parallel.

        Returns the number of device nodes newly created (0 when every node
        already existed — i.e. this call resumed an attach that a prior
        attempt had fully actuated).
        """
        # Creates come from the precomputed plan cache (device/plan.py):
        # GPU + companion ops with shared companions (nvidiactl and the uvm
        # pair ride with every GPU) deduped to one node per container.
        creates = batch_creates([self.plans.plan_for(c)
                                 for c in new_chips])

        def actuate(container_id: str, pid: int) -> int:
            self.gate.grant(pod, container_id, all_chips_after)
            made = self.actuator.apply_device_nodes(pid, creates, [])
            _observe_batch("create", len(creates))
            return made

        created = sum(self._fan_out_containers(
            self._actuatable_containers(pod), actuate))
        logger.debug("mounted %d chips (%d new nodes) into %s/%s",
                    len(new_chips), created, objects.namespace(pod),
                    objects.name(pod))
        return created

    # -- detach ----------------------------------------------------------------

    def unmount_chips(self, pod: objects.Pod, chips: list[GPUDevice],
                      remaining_chips: list[GPUDevice],
                      force: bool = False, cause: str = "") -> None:
        """Remove ``chips`` from the pod's containers.

        Ref util.go:73-150 UnmountGPU: busy re-check -> GATE revoke ->
        rm device file -> (force) kill holders. Busy without force raises
        :class:`DeviceBusyError` with the holder PIDs. Unlinks are fused
        into one batch per container, same as :meth:`mount_chips`.

        Revocation crosses the device gate FIRST — an in-place policy-map
        update, instant deny, zero fork — and nodes are unlinked only
        after. With a broker ``cause`` (lease expiry / preemption) a BUSY
        device still gets its gate access cut before the busy error goes
        back: the holder's open fd survives (the kernel gates open(2),
        not existing fds), but every re-open is denied-with-reason from
        that instant even while node cleanup defers and retries — the
        "holder keeps the chip after its lease is gone" hole this gate
        exists to close.
        """
        busy = self._busy_map(pod, chips)
        if busy and not force:
            if cause and self.gate.live:
                # best-effort by contract: the busy verdict MUST reach
                # the caller (broker backoff/retry) even when the early
                # revoke itself fails — a revoke error here may not
                # replace DeviceBusyError
                try:
                    for container_id, _pid in \
                            self._actuatable_containers(pod):
                        self.gate.revoke(pod, container_id, chips,
                                         remaining_chips, cause=cause)
                except (ActuationError, OSError) as e:
                    logger.warning(
                        "busy-path gate revoke for %s/%s failed (%s); "
                        "busy verdict returned, node cleanup will retry",
                        objects.namespace(pod), objects.name(pod), e)
            uuid, pids = next(iter(busy.items()))
            raise DeviceBusyError(uuid, pids)

        # Unlinks from the plan cache: the detached GPUs' nodes whose
        # (major, minor) the gate revokes in that container — never a
        # shared companion a remaining GPU needs, or one the container
        # held before any attach.
        nodes = batch_creates([self.plans.plan_for(c) for c in chips])

        def actuate(container_id: str, pid: int) -> None:
            revoked = set(self.gate.revoked(pod, container_id, chips,
                                            remaining_chips))
            removes = [path for path, major, minor in nodes
                       if (major, minor) in revoked]
            self.gate.revoke(pod, container_id, chips, remaining_chips,
                             cause=cause)
            self.actuator.apply_device_nodes(pid, [], removes)
            _observe_batch("remove", len(removes))

        self._fan_out_containers(self._actuatable_containers(pod), actuate)
        if force and busy:
            all_pids = sorted({p for pids in busy.values() for p in pids})
            self.actuator.kill_processes(all_pids)
            logger.warning("force-killed device holders: %s", all_pids)
        logger.debug("unmounted %d chips from %s/%s",
                    len(chips), objects.namespace(pod), objects.name(pod))
