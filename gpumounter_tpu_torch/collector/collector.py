"""GPUCollector: node GPU inventory + allocation map.

The port of :mod:`gpumounter_tpu.collector.collector`. Ref
``pkg/util/gpu/collector/collector.go``: enumerate devices (``GetGPUInfo``,
:23-38), refresh the allocation map from the kubelet PodResources API
before every decision (``UpdateGPUStatus``, :90-138), and aggregate a
pod's GPUs *including its slave pods* (``GetPodGPUResources``, :149-163).

The kubelet names an allocated ``nvidia.com/gpu`` by the driver's
``GPU-...`` UUID; the collector maps it to the enumerated
:class:`~gpumounter_tpu_torch.device.model.GPUDevice` of that UUID, as the
reference does (collector.go:114-135).

A GPU node no driver source names (``uuid == ""``: a node NVML does not
report, no proc-tree entry) is *unidentified*. The kubelet can never name
it, so it never matches a listed id, never counts as free and gets no
actuation plan; it is kept apart (:attr:`GPUCollector.unidentified`) and
counted under ``tpumounter_node_chips{state="unidentified"}``.

Deliberate fixes over the reference (SURVEY.md §8 "bugs to NOT replicate"):

- **Re-enumeration**: the reference reads the NVML device list once at
  startup and never again (collector.go:23-38); we re-enumerate on every
  ``update_status`` so hot-plugged GPUs appear.
- **Locking**: the reference mutates shared ``GPUList`` from a concurrent
  gRPC server with no mutex (collector.go:19-21,113-135); all state here is
  guarded by an RLock.
- Slave pods are resolved by exact name (the allocator reads them from
  owner labels), never by the reference's name prefix.
"""

from __future__ import annotations

import threading

from gpumounter_tpu_torch.collector.podresources import PodResourcesClient
from gpumounter_tpu_torch.device.enumerator import Enumerator
from gpumounter_tpu_torch.device.model import DeviceState, GPUDevice
from gpumounter_tpu_torch.device.plan import NodePlanCache
from gpumounter_tpu_torch.utils import consts
from gpumounter_tpu_torch.utils.log import get_logger
from gpumounter_tpu_torch.utils.metrics import REGISTRY

logger = get_logger("collector")


class GPUCollector:
    def __init__(self, enumerator: Enumerator,
                 podresources: PodResourcesClient,
                 resource_name: str = consts.GPU_RESOURCE_NAME,
                 pool_namespace: str = consts.DEFAULT_POOL_NAMESPACE):
        self.enumerator = enumerator
        self.podresources = podresources
        self.resource_name = resource_name
        self.pool_namespace = pool_namespace
        self._lock = threading.RLock()
        self._chips: dict[str, GPUDevice] = {}      # uuid -> GPU
        self._unidentified: list[GPUDevice] = []    # uuid == ""
        self._allocatable: set[str] | None = None   # last kubelet view
        # Precomputed actuation plans (device/plan.py), rebuilt whenever
        # the enumerated inventory actually changes (hot-plug) — the
        # mounter holds this object, so attach/detach actuation reads
        # frozen per-GPU plans instead of re-deriving node lists.
        self.plans = NodePlanCache()
        self._plan_sig: tuple = ()
        self.update_status()
        logger.info("collector initialised with %d GPUs (%d unidentified)",
                    len(self._chips), len(self._unidentified))

    # -- inventory -------------------------------------------------------------

    @property
    def chips(self) -> list[GPUDevice]:
        """The identified GPUs (each with its driver UUID)."""
        with self._lock:
            return list(self._chips.values())

    @property
    def unidentified(self) -> list[GPUDevice]:
        """GPU nodes with no UUID: never allocatable, never free."""
        with self._lock:
            return list(self._unidentified)

    def get_chip_by_uuid(self, uuid: str) -> GPUDevice | None:
        """Ref collector.go:81-88 GetGPUByUUID."""
        with self._lock:
            return self._chips.get(uuid)

    # -- reconciliation --------------------------------------------------------

    def update_status(self) -> None:
        """Refresh inventory + allocation map (ref UpdateGPUStatus,
        collector.go:90-138): re-enumerate GPUs, reset all to FREE, then
        mark GPUs listed by the kubelet as ALLOCATED with their pod
        binding."""
        listing = self.podresources.list_pods()
        # v1 kubelets report what they will actually schedule; an
        # enumerated GPU the kubelet excludes (unhealthy / not
        # plugin-registered) must not be advertised as free. None =
        # v1alpha1, the enumerator is the view.
        allocatable = self.podresources.allocatable_gpu_ids(
            self.resource_name)
        with self._lock:
            # freshly enumerated GPUs start FREE; allocation state is fully
            # re-derived from the kubelet listing every refresh
            prev = self._chips
            devices = self.enumerator.enumerate()
            self._chips = {d.uuid: d for d in devices if d.uuid}
            self._unidentified = [d for d in devices if not d.uuid]
            # full identity incl. each companion's path+majmin: a re-plug
            # that renumbers a companion with an unchanged count must
            # still invalidate the plans
            sig = tuple(sorted(
                (c.uuid, c.major, c.minor,
                 tuple((x.host_path, x.major, x.minor)
                       for x in c.companions))
                for c in self._chips.values()))
            if sig != self._plan_sig:
                self.plans.rebuild(list(self._chips.values()))
                self._plan_sig = sig
            # topology stamps (set by the allocator from node labels) are
            # static per node — carry them across refreshes so they aren't
            # lost when the inventory is rebuilt
            for uuid, chip in self._chips.items():
                old = prev.get(uuid)
                if old is not None:
                    chip.accelerator = chip.accelerator or old.accelerator
                    chip.topology = chip.topology or old.topology
            for pod in listing.pod_resources:
                for container in pod.containers:
                    for dev in container.devices:
                        if dev.resource_name != self.resource_name:
                            continue
                        for device_id in dev.device_ids:
                            chip = (self._chips.get(device_id)
                                    if device_id else None)
                            if chip is None:
                                logger.warning(
                                    "kubelet reports unknown device %r for "
                                    "pod %s/%s", device_id, pod.namespace,
                                    pod.name)
                                continue
                            chip.state = DeviceState.ALLOCATED
                            chip.pod_name = pod.name
                            chip.namespace = pod.namespace
            self._allocatable = allocatable
            self._set_chip_gauges()

    def mark_released(self, uuids: list[str]) -> None:
        """Write a completed detach through to the cached inventory.

        The slave pods holding these GPUs are already deleted, so the GPUs
        must read FREE to snapshot-only consumers immediately — not at the
        next attach's refresh. Deliberately NO kubelet round trip: detach
        resolution stays zero-LIST, and the next ``update_status``
        re-derives ground truth anyway."""
        with self._lock:
            for uuid in uuids:
                chip = self._chips.get(uuid)
                if chip is not None and chip.state is DeviceState.ALLOCATED:
                    chip.reset_state()
            self._set_chip_gauges()

    def _set_chip_gauges(self) -> None:
        # caller holds the lock
        allocatable = self._allocatable
        allocated = sum(1 for c in self._chips.values()
                        if c.state is DeviceState.ALLOCATED)
        free = sum(1 for c in self._chips.values()
                   if c.state is DeviceState.FREE
                   and (allocatable is None or c.uuid in allocatable))
        REGISTRY.chips.set(free, state="free")
        REGISTRY.chips.set(allocated, state="allocated")
        REGISTRY.chips.set(len(self._unidentified), state="unidentified")

    # -- aggregation -----------------------------------------------------------

    def get_pod_chips(self, pod_name: str, namespace: str,
                      refresh: bool = True) -> list[GPUDevice]:
        """GPUs allocated to exactly this pod (after a fresh update).
        ``refresh=False`` reads the last snapshot instead of re-LISTing the
        kubelet, so one attach or detach costs O(1) kubelet LISTs."""
        if refresh:
            self.update_status()
        with self._lock:
            return [c for c in self._chips.values()
                    if c.state is DeviceState.ALLOCATED
                    and c.pod_name == pod_name and c.namespace == namespace]

    # The reference's name-PREFIX slave matching (GetPodGPUResources,
    # collector.go:149-163: ``<pod>-slave-pod-``) is deliberately NOT
    # offered: it conflates same-named owners across namespaces, and
    # adopted warm-pool pods keep their warm-* names. Resolution goes
    # through owner labels (the allocator) into the exact-name method.

    def get_pod_gpu_resources_exact(
            self, pod_name: str, namespace: str,
            slave_names: set[str], refresh: bool = True) -> list[GPUDevice]:
        """GPUs of the pod PLUS its slave pods, the latter given by exact
        name (resolved from owner labels by the allocator)."""
        if refresh:
            self.update_status()
        with self._lock:
            return [c for c in self._chips.values()
                    if c.state is DeviceState.ALLOCATED
                    and ((c.pod_name == pod_name
                          and c.namespace == namespace)
                         or (c.namespace == self.pool_namespace
                             and c.pod_name in slave_names))]
