"""GPUAllocator: GPU allocation through the Kubernetes scheduler (the port
of :mod:`gpumounter_tpu.allocator.allocator`).

Ref ``pkg/util/gpu/allocator/allocator.go``. The core trick is unchanged: to
allocate GPUs *without bypassing the scheduler*, create placeholder "slave
pods" that request ``nvidia.com/gpu`` through the normal scheduling path
(allocator.go:190-235); the kubelet device plugin then assigns real GPUs,
which keeps node allocatable accounting consistent. The kubelet PodResources
API tells us which GPUs (by driver UUID) each slave pod received.

Deliberate deltas from the reference (SURVEY.md §7/§8):

- **Watch-based state machines.** ``checkCreateState``/``checkDeleteState``
  busy-poll the apiserver with no sleep and no timeout
  (allocator.go:247-282,296-317). We use watch streams with a deadline
  (:class:`AllocationTimeoutError`).
- **All conditions scanned.** The reference reads ``Conditions[0].Reason``
  only (allocator.go:267); we look for the ``PodScheduled`` condition
  wherever it sits.
- **Mount type is stored, not inferred.** The reference counts slave pods to
  guess entire-mount (allocator.go:181-187, acknowledged TODO); we label each
  slave pod with its mount type and the owner pod at creation.
- **Subset removal.** ``GetRemoveGPU`` requires the uuid list to exactly match
  all removable GPUs (allocator.go:122-124); we accept any subset and report
  precisely which ids are not removable.
- **Pause image.** Slave pods run ``pause`` rather than an alpine shell loop
  (allocator.go:216-228) — no shell, no restarts, minimal footprint.
"""

from __future__ import annotations

import dataclasses
import math
import secrets
import threading
import time
from collections.abc import Iterable

from gpumounter_tpu_torch.allocator import topology
from gpumounter_tpu_torch.collector.collector import GPUCollector
from gpumounter_tpu_torch.device.model import GPUDevice
from gpumounter_tpu_torch.k8s import objects
from gpumounter_tpu_torch.k8s.client import KubeClient
from gpumounter_tpu_torch.k8s.informer import PodCacheReads
from gpumounter_tpu_torch.utils import consts
from gpumounter_tpu_torch.utils.config import Settings
from gpumounter_tpu_torch.utils.parking import parked
from gpumounter_tpu_torch.utils.errors import (AllocationTimeoutError,
                                               DeviceNotFoundError,
                                               InsufficientGPUError,
                                               K8sApiError)
from gpumounter_tpu_torch.utils.log import get_logger
from gpumounter_tpu_torch.utils.trace import annotate, span as trace_span

logger = get_logger("allocator")


def _scheduled_condition(pod: objects.Pod) -> dict | None:
    """The PodScheduled condition, wherever it is in the list (the reference
    only consulted Conditions[0], allocator.go:267)."""
    for cond in pod.get("status", {}).get("conditions", []) or []:
        if cond.get("type") == "PodScheduled":
            return cond
    return None


def is_unschedulable(pod: objects.Pod) -> bool:
    cond = _scheduled_condition(pod)
    return bool(cond and cond.get("status") == "False"
                and cond.get("reason") == "Unschedulable")


@dataclasses.dataclass
class AllocationStats:
    """Out-param of :meth:`GPUAllocator.get_available_gpus`: where each
    slave pod came from, so the service can surface warm-pool hit/miss
    without the allocator changing its return contract."""

    warm_adopted: int = 0       # claimed pre-scheduled from the warm pool
    cold_created: int = 0       # created + waited through the scheduler
    resumed: int = 0            # re-adopted from a prior same-request try


class GPUAllocator:
    """Owns slave-pod lifecycle for one node's worker.

    Embedding in the reference (``GPUAllocator`` embeds ``*GPUCollector``,
    allocator.go:24-26) becomes plain composition here.
    """

    def __init__(self, collector: GPUCollector, kube: KubeClient,
                 settings: Settings | None = None,
                 reads: PodCacheReads | None = None):
        self.collector = collector
        self.kube = kube
        # Pod READS go through the informer handle (k8s/informer.py): with
        # a shared informer wired in, the steady-state attach path costs
        # zero apiserver LISTs; without one the handle is a passthrough and
        # behavior is identical to calling the client directly.
        self.reads = reads if reads is not None else PodCacheReads(kube)
        self.settings = settings or Settings()
        # Node topology labels change only on node recreation: cache the
        # per-node answer so the hot path doesn't pay a node GET per attach.
        self._topo_cache: dict[str, tuple[float,
                                          "topology.NodeTopology | None"]] = {}
        self._topo_cache_lock = threading.Lock()

    # -- slave pod spec (ref allocator.go:190-235 newGPUSlavePod) --------------

    def new_slave_pod(self, owner: objects.Pod, gpu_num: int,
                      entire: bool, txn_id: str = "",
                      extra_labels: dict[str, str] | None = None
                      ) -> objects.Pod:
        owner_name = objects.name(owner)
        pod_name = (owner_name + consts.SLAVE_POD_INFIX
                    + secrets.token_hex(3))
        mount_type = (consts.MountType.ENTIRE if entire
                      else consts.MountType.SINGLE)
        labels = {
            consts.SLAVE_POD_LABEL_KEY: consts.SLAVE_POD_LABEL_VALUE,
            consts.OWNER_POD_LABEL_KEY: owner_name,
            consts.OWNER_NAMESPACE_LABEL_KEY: objects.namespace(owner),
            consts.OWNER_UID_LABEL_KEY: objects.uid(owner),
            consts.MOUNT_TYPE_LABEL_KEY: mount_type.value,
        }
        labels.update(extra_labels or {})
        if txn_id:
            labels[consts.TXN_LABEL_KEY] = txn_id
        return self._slave_pod_spec(pod_name, objects.node_name(owner),
                                    gpu_num, labels,
                                    self.owner_references(owner))

    def owner_references(self, owner: objects.Pod) -> list[dict]:
        """ownerReferences stamping a slave pod as GC'd with its owner
        (ref allocator.go:204-213) — single source for the cold create
        path AND warm-pod adoption, so the policy cannot diverge.
        Cross-namespace ownerRefs are not honoured by the k8s GC, so this
        only takes effect when the pool namespace equals the owner's; the
        explicit delete path is the primary cleanup either way."""
        if objects.namespace(owner) != self.settings.pool_namespace:
            return []
        return [{
            "apiVersion": "v1",
            "kind": "Pod",
            "name": objects.name(owner),
            "uid": objects.uid(owner),
            "blockOwnerDeletion": False,
            "controller": False,
        }]

    def new_warm_slave_pod(self, node_name: str, gpu_num: int,
                           entire: bool) -> objects.Pod:
        """An UNOWNED slave pod for the warm pool: same scheduler path and
        chip request as an owned slave pod (accounting stays honest), but
        no owner labels and no ownerReference — adoption patches those in
        later (worker/pool.py)."""
        mount_type = (consts.MountType.ENTIRE if entire
                      else consts.MountType.SINGLE)
        pod_name = (consts.WARM_POD_NAME_PREFIX + consts.SLAVE_POD_INFIX
                    + secrets.token_hex(3))
        labels = {
            consts.SLAVE_POD_LABEL_KEY: consts.SLAVE_POD_LABEL_VALUE,
            consts.WARM_POD_LABEL_KEY: consts.WARM_POD_LABEL_VALUE,
            consts.MOUNT_TYPE_LABEL_KEY: mount_type.value,
        }
        if node_name:
            # node as a LABEL too (nodeSelector can't be label-selected):
            # lets the pool LIST only its own node's warm pods server-side
            labels[consts.WARM_POD_NODE_LABEL_KEY] = node_name
        return self._slave_pod_spec(pod_name, node_name, gpu_num, labels, [])

    def _slave_pod_spec(self, pod_name: str, node_name: str, gpu_num: int,
                        labels: dict[str, str],
                        owner_refs: list[dict]) -> objects.Pod:
        return {
            "apiVersion": "v1",
            "kind": "Pod",
            "metadata": {
                "name": pod_name,
                "namespace": self.settings.pool_namespace,
                "labels": labels,
                "ownerReferences": owner_refs,
            },
            "spec": {
                # Pin to the target node (ref allocator.go:229-231).
                "nodeSelector": {
                    "kubernetes.io/hostname": node_name,
                },
                "restartPolicy": "Never",
                "tolerations": [{
                    # GKE GPU node pools taint nodes with nvidia.com/gpu.
                    "key": self.settings.resource_name,
                    "operator": "Exists",
                    "effect": "NoSchedule",
                }],
                "containers": [{
                    "name": "gpu-holder",
                    "image": consts.SLAVE_POD_IMAGE,
                    "resources": {
                        "limits": {self.settings.resource_name: str(gpu_num)},
                        "requests": {
                            self.settings.resource_name: str(gpu_num)},
                    },
                }],
            },
        }

    # -- allocation (ref allocator.go:41-100 GetAvailableGPU) ------------------

    def get_available_gpus(
            self, owner: objects.Pod, total_gpus: int,
            gpus_per_pod: int,
            txn_id: str = "",
            request_id: str = "",
            adopt: set[str] | None = None,
            pool=None,
            stats: AllocationStats | None = None
    ) -> tuple[list[GPUDevice], list[str]]:
        """Allocate ``total_gpus`` chips on the owner's node via slave pods of
        ``gpus_per_pod`` chips each. Returns (chips, slave_pod_names).

        ``request_id`` makes the call idempotent: slave pods are stamped
        with it, and a repeat call with the same id *adopts* the surviving
        pods of the prior attempt (creating only the shortfall) instead of
        allocating a second set — the retry-after-UNAVAILABLE path cannot
        double-allocate. ``adopt`` is the already-LISTed adoption set (the
        service resolves it once for its resume decision; passing it here
        avoids a second identical apiserver LIST).

        Raises :class:`InsufficientGPUError` if the scheduler reports
        Unschedulable, :class:`AllocationTimeoutError` on deadline; both
        paths clean up the slave pods *this call created* (ref
        allocator.go:66-74). Adopted pods are deliberately left standing: a
        prior attempt may have fully mounted them into the workload (reply
        lost), and deleting that reservation would free chips that are
        still in use — the reconciler owns genuinely-orphaned pods.

        ``pool`` (a :class:`~gpumounter_tpu_torch.worker.pool.PoolManager`) lets
        the shortfall be satisfied by *adopting* pre-scheduled warm pods
        before falling back to create+wait: a full pool hit skips the
        scheduler wait entirely (no ``_wait_running``) because claimed
        pods were verified Running at claim time by the label patch's
        resourceVersion precondition. Warm-claimed pods ARE this call's to
        clean up on failure — unlike request-id-adopted ones, nothing
        mounted them yet. ``stats`` is filled with the warm/cold/resumed
        split when provided.
        """
        entire = gpus_per_pod > 1
        # Group validation (allocator/topology.py): an entire mount must
        # fit the owner's node. Raises TopologyError (→
        # FAILED_PRECONDITION → 412) BEFORE any slave pod exists; nodes
        # without the GKE accelerator label are unconstrained.
        topo = self.node_topology_of(owner)
        if entire:
            topology.validate_entire_mount(topo, gpus_per_pod)
        extra_labels = topo.slave_pod_labels() if topo else {}
        if request_id:
            extra_labels[consts.REQUEST_ID_LABEL_KEY] = request_id
        num_pods = math.ceil(total_gpus / gpus_per_pod)
        # Adopt survivors of a prior attempt with the same request id (the
        # worker may have died between create and reply); create only the
        # shortfall.
        adopted: list[str] = sorted(adopt) if adopt else []
        if adopted:
            logger.info("request %s: adopting %d existing slave pods %s",
                        request_id, len(adopted), adopted)
        warm: list[str] = []
        fresh: list[str] = []
        created = list(adopted)
        try:
            shortfall = max(0, num_pods - len(adopted))
            if pool is not None and shortfall:
                warm = pool.claim(owner, gpus_per_pod, entire, shortfall,
                                  txn_id=txn_id, request_id=request_id,
                                  extra_labels=extra_labels)
                created.extend(warm)
                shortfall -= len(warm)
            if shortfall:
                with trace_span("slave_pods.create", pods=shortfall):
                    for _ in range(shortfall):
                        spec = self.new_slave_pod(owner, gpus_per_pod,
                                                  entire, txn_id=txn_id,
                                                  extra_labels=extra_labels)
                        resp = self.kube.create_pod(
                            self.settings.pool_namespace, spec)
                        # fence the cache: a same-request retry's adoption
                        # read must see this pod (read-your-writes)
                        self.reads.observe_write(resp)
                        fresh.append(objects.name(spec))
                        created.append(objects.name(spec))
            # Warm pods were Running when claimed (the rv-guarded patch
            # proved the observed state was current); only resumed and
            # cold-created pods still need the scheduler state machine.
            if adopted or fresh:
                with trace_span("scheduler.wait",
                                pods=len(adopted) + len(fresh)):
                    self._wait_running(adopted + fresh)
        except (InsufficientGPUError, AllocationTimeoutError, K8sApiError):
            logger.warning("allocation failed; cleaning up slave pods %s "
                           "(adopted pods %s left for the reconciler/retry)",
                           fresh + warm, adopted)
            self.delete_slave_pods(fresh + warm, wait=False)
            raise
        if stats is not None:
            stats.warm_adopted = len(warm)
            stats.cold_created = len(fresh)
            stats.resumed = len(adopted)

        # Which chips did each slave pod actually get? Ground truth is the
        # kubelet PodResources API (ref allocator.go:84-97 → collector).
        with trace_span("kubelet.resolve", pods=len(created)):
            per_pod_chips, lagging = self._pods_chips_with_lag_retry(created)
        if lagging:
            self.delete_slave_pods(fresh + warm, wait=False)
            raise InsufficientGPUError(
                f"slave pod(s) {sorted(lagging)} are Running but kubelet "
                f"reports no {self.settings.resource_name} devices for them "
                f"after {self.settings.kubelet_lag_timeout_s}s")
        chips: list[GPUDevice] = []
        for name in created:
            chips.extend(per_pod_chips[name])
        if topo:
            for chip in chips:
                chip.accelerator = topo.accelerator
        logger.debug("allocated %d chips via %d slave pods: %s",
                    len(chips), len(created),
                    [c.uuid for c in chips])
        annotate(chips=len(chips), slave_pods=len(created),
                 warm_adopted=len(warm), cold_created=len(fresh),
                 resumed=len(adopted))
        return chips, created

    def _pods_chips_with_lag_retry(
            self, names: list[str]
    ) -> tuple[dict[str, list[GPUDevice]], set[str]]:
        """Chips per slave pod, with lag tolerance. The kubelet's
        PodResources listing can lag the pods' Running transitions
        (device-plugin assignment is asynchronous); retry with short sleeps
        within ``kubelet_lag_timeout_s`` before giving up, rather than
        raise InsufficientGPU on the first empty read.

        One kubelet LIST (``update_status``) per retry round covers ALL
        pods — re-LISTing per pod would cost O(slave pods) LISTs per
        attach. Returns
        ({name: chips}, still_empty_names)."""
        # The deadline is extended whenever a round makes progress, so a
        # kubelet resolving pods serially still gets a full
        # kubelet_lag_timeout_s window per stall. Total wall time is hard-
        # capped at N*T (the serial worst case) so an attach can never block
        # longer than len(names) * kubelet_lag_timeout_s, regardless of
        # progress pattern.
        start = time.monotonic()
        hard_deadline = start + len(names) * self.settings.kubelet_lag_timeout_s
        deadline = start + self.settings.kubelet_lag_timeout_s
        poll_s = 0.2
        out: dict[str, list[GPUDevice]] = {name: [] for name in names}
        pending = set(names)
        while True:
            self.collector.update_status()
            progressed = False
            for name in list(pending):
                got = self.collector.get_pod_chips(
                    name, self.settings.pool_namespace, refresh=False)
                if got:
                    out[name] = got
                    pending.discard(name)
                    progressed = True
            if progressed:
                deadline = min(
                    time.monotonic() + self.settings.kubelet_lag_timeout_s,
                    hard_deadline)
            if not pending or time.monotonic() >= deadline:
                return out, pending
            logger.info("kubelet lists no devices yet for %s; retrying",
                        sorted(pending))
            # parked (utils/parking.py): kubelet device-plugin lag is a
            # pure wait — the handler thread's executor slot goes back
            with parked("kubelet-lag"):
                time.sleep(poll_s)
            poll_s = min(poll_s * 2, 2.0)

    # Node topology labels are set at nodepool creation and effectively
    # immutable for a node's lifetime; re-reading them on every attach was
    # one apiserver GET per request for a constant answer.
    _NODE_TOPO_TTL_S = 300.0

    def node_topology_of(self, owner: objects.Pod
                         ) -> "topology.NodeTopology | None":
        """The owner's node's advertised GPUs; None when the node has no
        accelerator label or cannot be read (a node GET failure must not
        take down allocation on non-GKE/test clusters — it only disables
        topology enforcement, and says so in the log). Answers are cached
        per node for :data:`_NODE_TOPO_TTL_S` to keep the node GET off the
        attach hot path."""
        node_name = objects.node_name(owner)
        if not node_name:
            return None
        now = time.monotonic()
        with self._topo_cache_lock:
            cached = self._topo_cache.get(node_name)
            if cached is not None and cached[0] > now:
                return cached[1]
        ttl = self._NODE_TOPO_TTL_S
        try:
            node = self.kube.get_node(node_name)
            topo = topology.node_topology(node)
        except K8sApiError as e:
            logger.info("node %s unreadable (%s); topology enforcement off",
                        node_name, e)
            # short TTL: a transient apiserver blip must not disable
            # topology enforcement for the full cache lifetime
            topo, ttl = None, 15.0
        with self._topo_cache_lock:
            self._topo_cache[node_name] = (now + ttl, topo)
        return topo

    # How long a silently-dead ad-hoc watch stream goes unnoticed in the
    # legacy (informer-less) wait path; informer-backed waits ride the ONE
    # shared stream instead of opening their own.
    _WATCH_CHUNK_S = 30.0

    _SLAVE_SELECTOR = (f"{consts.SLAVE_POD_LABEL_KEY}="
                       f"{consts.SLAVE_POD_LABEL_VALUE}")

    @staticmethod
    def _pod_rv(pod: objects.Pod) -> str:
        return pod.get("metadata", {}).get("resourceVersion", "")

    def _wait_running(self, names: list[str]) -> None:
        """Until every named pod is Running, any is Unschedulable, or the
        deadline passes (replaces checkCreateState, allocator.go:237-283).
        Event-driven either way: informer-backed scopes re-evaluate on the
        shared stream's events, others run the legacy LIST-seeded watch."""
        pending = set(names)

        def step(pods: dict[str, objects.Pod]) -> bool:
            for name in list(pending):
                pod = pods.get(name)
                if pod is not None:
                    self._note_pod_state(pod, pending)
            return not pending

        done = self.reads.wait_pods(
            self.settings.pool_namespace, self._SLAVE_SELECTOR, step,
            self.settings.allocation_timeout_s,
            watch_chunk_s=self._WATCH_CHUNK_S)
        if not done:
            raise AllocationTimeoutError(
                f"slave pods not Running after "
                f"{self.settings.allocation_timeout_s}s: "
                f"{sorted(pending)}")

    @staticmethod
    def _note_pod_state(pod: objects.Pod | None, pending: set[str]) -> None:
        if not pod:
            return
        if is_unschedulable(pod):
            raise InsufficientGPUError(
                f"slave pod {objects.name(pod)} unschedulable: "
                "insufficient GPU on node")
        if objects.is_running(pod):
            pending.discard(objects.name(pod))
        elif objects.phase(pod) in ("Failed", "Succeeded"):
            raise InsufficientGPUError(
                f"slave pod {objects.name(pod)} reached terminal phase "
                f"{objects.phase(pod)} before Running")

    # -- slave pod resolution --------------------------------------------------

    @staticmethod
    def _owner_selector(owner_name: str, owner_namespace: str) -> str:
        """The ownership label selector — single source so resolution and
        removal can never drift apart on the label scheme."""
        return (f"{consts.OWNER_POD_LABEL_KEY}={owner_name},"
                f"{consts.OWNER_NAMESPACE_LABEL_KEY}={owner_namespace}")

    def request_slave_pods(self, owner_name: str, owner_namespace: str,
                           request_id: str) -> set[str]:
        """Slave pods stamped with this request id (surviving pods of a
        prior attempt of the same logical request)."""
        selector = (self._owner_selector(owner_name, owner_namespace)
                    + f",{consts.REQUEST_ID_LABEL_KEY}={request_id}")
        return {objects.name(p)
                for p in self.reads.list_pods(self.settings.pool_namespace,
                                              label_selector=selector)}

    def slave_pod_names(self, owner_name: str, owner_namespace: str,
                        txn_id: str | None = None) -> set[str]:
        """Names of slave pods owned by exactly (namespace, name), via the
        labels stamped at creation. The reference matched by name *prefix*
        only (collector.go:155-159), which conflates same-named owners in
        different namespaces on one node. ``txn_id`` narrows to one slice
        transaction's pods."""
        selector = self._owner_selector(owner_name, owner_namespace)
        if txn_id:
            selector += f",{consts.TXN_LABEL_KEY}={txn_id}"
        return {objects.name(p)
                for p in self.reads.list_pods(self.settings.pool_namespace,
                                              label_selector=selector)}

    # -- removal resolution (ref allocator.go:102-127 GetRemoveGPU) ------------

    def get_removable_gpus(
            self, owner_name: str, uuids: Iterable[str],
            owner_namespace: str = "default",
            txn_id: str | None = None
    ) -> tuple[list[GPUDevice], list[str], set[str]]:
        """Resolve which chips may be detached. Only chips held by this pod's
        slave pods are removable (allocator.go:113-120) — chips the pod got
        through its own spec came from kubelet and must not be touched.

        ``uuids`` may be any subset; empty means "all removable". Unknown or
        non-removable ids raise :class:`DeviceNotFoundError` (the reference
        silently returned nothing on any count mismatch,
        allocator.go:122-124). ``txn_id`` restricts to chips attached by one
        slice transaction — filtered locally on the txn label so the owner's
        full slave set comes from the same single apiserver LIST. Returns
        (chips, slave_pod_names_holding_them, all_owner_slave_names) — the
        last lets callers reuse this LIST instead of re-issuing it.
        """
        slaves = self.reads.list_pods(
            self.settings.pool_namespace,
            label_selector=self._owner_selector(owner_name,
                                                owner_namespace))
        all_slave_names = {objects.name(p) for p in slaves}
        in_scope = {objects.name(p) for p in slaves
                    if not txn_id
                    or objects.labels(p).get(consts.TXN_LABEL_KEY) == txn_id}
        # Exact-name resolution via the owner labels, never the
        # <owner>-slave-pod- name-prefix convention: adopted warm-pool
        # pods keep their warm-* name, so prefix matching would silently
        # make their chips non-removable.
        removable = {
            c.uuid: c
            for c in self.collector.get_pod_gpu_resources_exact(
                owner_name, "", in_scope)
            if c.namespace == self.settings.pool_namespace
            and c.pod_name in in_scope}
        wanted = list(uuids) or list(removable)
        missing = [u for u in wanted if u not in removable]
        if missing:
            raise DeviceNotFoundError(",".join(missing))
        chips = [removable[u] for u in wanted]
        holders = sorted({c.pod_name for c in chips})
        return chips, holders, all_slave_names

    # -- slave pod deletion (ref allocator.go:129-157 DeleteSlavePods) ---------

    def delete_slave_pods(self, names: Iterable[str],
                          wait: bool = True) -> list[str]:
        """Delete the named slave pods; returns the names whose delete
        FAILED (apiserver error beyond the client's retries) so rollback
        paths can journal the leftover instead of assuming clean state.
        404s count as success — the pod being gone is the goal."""
        names = list(names)
        failed: list[str] = []
        for name in names:
            try:
                self.kube.delete_pod(self.settings.pool_namespace, name)
            except K8sApiError as e:
                logger.warning("delete slave pod %s: %s", name, e)
                failed.append(name)
        if wait:
            self._wait_deleted([n for n in names if n not in failed])
        return failed

    def _wait_deleted(self, names: list[str]) -> None:
        """Until every named pod is gone (replaces checkDeleteState,
        allocator.go:285-318). Presence-based: a pod absent from the
        scope's current view IS deleted, so a DELETED event lost to a
        broken stream cannot wedge the wait."""
        pending = set(names)

        def step(pods: dict[str, objects.Pod]) -> bool:
            pending.intersection_update(pods.keys())
            return not pending

        done = self.reads.wait_pods(
            self.settings.pool_namespace, self._SLAVE_SELECTOR, step,
            self.settings.allocation_timeout_s,
            watch_chunk_s=self._WATCH_CHUNK_S)
        if not done:
            raise AllocationTimeoutError(
                f"slave pods not deleted after "
                f"{self.settings.allocation_timeout_s}s: "
                f"{sorted(pending)}")

    # -- mount type (ref allocator.go:159-187 GetMountType) --------------------

    def get_mount_type(self, owner_name: str,
                       owner_namespace: str = "default") -> consts.MountType:
        """What kind of mount does this pod currently have? Read from the
        mount-type label stamped on its slave pods at creation (the reference
        guessed by comparing slave-pod count to chip count,
        allocator.go:181-187 — racy and wrong for multi-chip single mounts).
        """
        try:
            slaves = self.reads.list_pods(
                self.settings.pool_namespace,
                label_selector=self._owner_selector(owner_name,
                                                    owner_namespace))
        except K8sApiError:
            return consts.MountType.UNKNOWN
        if not slaves:
            # No slave pods: the pod may still have chips from its own spec,
            # but none that *we* mounted — nothing blocks a future mount.
            return consts.MountType.NONE
        types = {objects.labels(p).get(consts.MOUNT_TYPE_LABEL_KEY)
                 for p in slaves}
        if consts.MountType.ENTIRE.value in types:
            return consts.MountType.ENTIRE
        if types == {consts.MountType.SINGLE.value}:
            return consts.MountType.SINGLE
        return consts.MountType.UNKNOWN
