"""Mount orchestration: the worker's AddGPU / RemoveGPU business logic (the
port of :mod:`gpumounter_tpu.worker.service`).

Ref ``pkg/server/gpu-mount/server.go`` (``GPUMountImpl.AddGPU`` :35-100,
``.RemoveGPU`` :102-180), decoupled from the wire: this module returns typed
outcomes; the gRPC adapter maps them onto the proto enums. Deliberate deltas:

- Rollback on mount failure deletes slave pods *and* reverts any partially
  actuated chips (the reference only deleted slave pods, server.go:87-92,
  leaving half-written cgroup rules behind).
- Detach enforces **whole-slave-pod granularity**: a slave pod's chips must be
  removed together, because the scheduler accounts chips per pod — deleting a
  slave pod while keeping some of its chips mounted would desync allocatable
  accounting. The reference sidestepped this with its exact-uuid-list quirk
  (allocator.go:122-124); we give a precise error instead.
- Busy pre-check returns the holder PIDs to the caller (new field on the
  response) so operators know *what* to kill before forcing.
- Attach/detach latencies are recorded in the metrics registry.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
import time

from gpumounter_tpu_torch.actuation.mount import GPUMounter, can_mount
from gpumounter_tpu_torch.allocator import AllocationStats, GPUAllocator
from gpumounter_tpu_torch.device.model import GPUDevice
from gpumounter_tpu_torch.k8s import objects
from gpumounter_tpu_torch.k8s.client import KubeClient
from gpumounter_tpu_torch.utils import consts
from gpumounter_tpu_torch.utils.config import Settings
from gpumounter_tpu_torch.utils.errors import (AllocationTimeoutError,
                                               DeviceBusyError,
                                               DeviceNotFoundError,
                                               InsufficientGPUError,
                                               MountPolicyError,
                                               PodNotFoundError,
                                               TPUMounterError)
from gpumounter_tpu_torch.utils.events import EVENTS
from gpumounter_tpu_torch.utils.flight import RECORDER
from gpumounter_tpu_torch.utils.log import get_logger
from gpumounter_tpu_torch.utils.metrics import REGISTRY
from gpumounter_tpu_torch.utils.trace import Trace, annotate

logger = get_logger("worker.service")


@dataclasses.dataclass
class AddOutcome:
    result: consts.AddResult
    chips: list[GPUDevice] = dataclasses.field(default_factory=list)
    message: str = ""
    # Warm-pool outcome: how many slave pods were adopted warm vs
    # cold-created (both 0 when the pool is disabled — today's behavior).
    pool_hits: int = 0
    pool_misses: int = 0


@dataclasses.dataclass
class RemoveOutcome:
    result: consts.RemoveResult
    busy_pids: list[int] = dataclasses.field(default_factory=list)
    message: str = ""


@dataclasses.dataclass
class _AttachmentRecord:
    """What an attach resolved, remembered so the detach of the same
    attachment doesn't re-resolve it (one kubelet LIST + inventory
    re-scan on a pod this worker just attached to). Trust is bounded: the record
    is keyed to the pod's UID, aged out after a TTL, and only used when
    the shared informer's (cache-served) view of the owner's slave pods
    still matches ``slaves`` exactly — any external mutation (reconciler
    GC, operator delete) flunks that check and detach falls back to the
    full kubelet re-resolution."""

    uid: str
    all_chips: list[GPUDevice]     # the pod's complete chip set at attach
    slaves: set[str]             # ALL owner slave-pod names at attach
    recorded_at: float


@dataclasses.dataclass
class ChipStatus:
    device_id: str
    device_path: str
    slave_pod: str            # "" when the chip came from the pod's own spec
    busy_pids: list[int]


class KeyedLocks:
    """Refcounted per-key mutexes: an entry lives exactly while >=1 caller
    is inside :meth:`hold`, so a held (or awaited) lock can never be
    dropped — an LRU that evicts oldest-inserted unconditionally would,
    silently voiding the serialisation guarantee at 1024 live ids — and the
    table is bounded by in-flight holders."""

    def __init__(self):
        self._entries: dict = {}     # key -> [Lock, holder_count]
        self._guard = threading.Lock()

    @contextlib.contextmanager
    def hold(self, key):
        from gpumounter_tpu_torch.utils.parking import parked
        with self._guard:
            entry = self._entries.get(key)
            if entry is None:
                entry = self._entries[key] = [threading.Lock(), 0]
            entry[1] += 1
        try:
            # The ACQUISITION is a parked wait (utils/parking.py): a
            # thread blocked on a key another request holds must not
            # charge the executor's active budget — the holder may
            # itself be parked, and charging its waiters could consume
            # every slot and deadlock the holder's un-park. No-op
            # outside the parking executor.
            with parked("keyed-lock"):
                entry[0].acquire()
            try:
                yield
            finally:
                entry[0].release()
        finally:
            with self._guard:
                entry[1] -= 1
                if entry[1] == 0 and self._entries.get(key) is entry:
                    del self._entries[key]


class GPUMountService:
    """One per worker; owns the node-local orchestration."""

    def __init__(self, allocator: GPUAllocator, mounter: GPUMounter,
                 kube: KubeClient, settings: Settings | None = None,
                 pool=None, journal=None, drain=None):
        self.allocator = allocator
        self.mounter = mounter
        self.kube = kube
        # Read-side informer handle shared with the allocator: pod reads
        # on the request path are served from the shared list-watch cache
        # when one is wired (k8s/informer.py), and fall through to the
        # real client otherwise.
        self.reads = allocator.reads
        self.settings = settings or Settings()
        # Optional PoolManager (worker/pool.py): when set, AddGPU adopts
        # pre-scheduled warm slave pods before falling back to the cold
        # create+wait path. None ⇒ exactly the historical behavior.
        self.pool = pool
        # Optional AttachJournal (worker/journal.py): intent before
        # actuation, commit after — a worker crash mid-attach is replayed
        # at the next boot (replay_journal) instead of leaking device
        # access. None ⇒ no journaling (unit rigs that predate it).
        self.journal = journal
        # Optional DrainController (worker/drain.py): a draining worker
        # refuses NEW attaches (typed 503 Draining at the gateway) and
        # every RPC holds an in-flight token the drain sequence settles
        # on. None ⇒ no drain semantics — byte-for-byte pre-drain
        # behavior (unit rigs, and production with the subsystem off).
        self.drain = drain
        # Per-request fencing: a gateway retry can arrive while the original
        # handler is still executing in this process (UNAVAILABLE from a
        # connection blip, not a worker death). Serialising same-request_id
        # AddGPUs makes the retry's adoption LIST see the COMPLETE slave-pod
        # set of the original instead of a mid-create subset.
        self._request_locks = KeyedLocks()
        # Per-pod mutation fencing: Add and Remove on the same pod mutate
        # shared state (cgroup device program, slave pods, device nodes);
        # interleaving them can re-grant a chip mid-detach — the detach-time
        # /dev scan exclusion only protects the revoke's OWN sync, not a
        # concurrent mount's scan of the not-yet-unlinked chip node.
        self._pod_locks = KeyedLocks()
        # (namespace, pod) -> _AttachmentRecord: detach resolution served
        # from attach-time knowledge (validated against the informer's
        # slave-pod view) instead of a fresh kubelet round trip. Bounded
        # by the node's attachable pods; entries age out via the TTL.
        self._attach_records: dict[tuple[str, str], _AttachmentRecord] = {}
        self._attach_records_lock = threading.Lock()
        # (namespace, pod, reason) -> last emit time for event suppression
        self._event_times: dict = {}
        self._event_times_lock = threading.Lock()
        # Event POSTs drain through ONE worker thread over a bounded
        # drop-oldest queue: thread-per-event against a slow apiserver
        # (30s timeout x call rate) would pile up unbounded threads.
        self._event_queue: collections.deque = collections.deque(maxlen=64)
        self._event_cond = threading.Condition()
        self._event_thread: threading.Thread | None = None

    def _request_lock(self, namespace: str, pod_name: str, request_id: str):
        return self._request_locks.hold((namespace, pod_name, request_id))

    def _pod_lock(self, namespace: str, pod_name: str):
        return self._pod_locks.hold((namespace, pod_name))

    # -- AddGPU (ref server.go:35-100) ----------------------------------------

    def add_gpu(self, pod_name: str, namespace: str, gpu_num: int,
                is_entire_mount: bool, txn_id: str = "",
                request_id: str = "") -> AddOutcome:
        # Drain gate BEFORE any tracing/accounting: a refused attach is
        # a routine typed answer (503 Draining at the gateway), not a
        # request this worker worked on. Raises WorkerDrainingError.
        if self.drain is not None:
            drain_token = self.drain.inflight("attach")
        else:
            drain_token = contextlib.nullcontext()
        with drain_token:
            return self._add_gpu_traced(pod_name, namespace, gpu_num,
                                        is_entire_mount, txn_id,
                                        request_id)

    def _add_gpu_traced(self, pod_name: str, namespace: str,
                        gpu_num: int, is_entire_mount: bool,
                        txn_id: str = "",
                        request_id: str = "") -> AddOutcome:
        trace = Trace("attach", request_id or txn_id)
        trace.root.attrs.update(pod=f"{namespace}/{pod_name}",
                                gpus=gpu_num, entire=is_entire_mount)
        rid = request_id or txn_id
        result_name = "EXCEPTION"
        chips_granted = 0
        t0 = time.monotonic()
        try:
            # lock order: request fence, then pod mutation lock
            if request_id:
                with self._request_lock(namespace, pod_name,
                                        request_id), \
                        self._pod_lock(namespace, pod_name):
                    outcome = self._add_gpu(pod_name, namespace, gpu_num,
                                            is_entire_mount, txn_id,
                                            request_id, trace=trace)
            else:
                with self._pod_lock(namespace, pod_name):
                    outcome = self._add_gpu(pod_name, namespace, gpu_num,
                                            is_entire_mount, txn_id,
                                            request_id, trace=trace)
            result_name = outcome.result.name
            chips_granted = len(outcome.chips)
            trace.root.attrs.update(chips=len(outcome.chips),
                                    pool_hits=outcome.pool_hits,
                                    pool_misses=outcome.pool_misses)
        except MountPolicyError:
            # a routine, expected denial (gRPC FAILED_PRECONDITION) — not
            # the "worker blew up" signal EXCEPTION must keep meaning
            result_name = "POLICY_DENIED"
            raise
        finally:
            # the rid exemplar links a bad latency bucket straight to its
            # /tracez entry
            REGISTRY.attach_latency.observe(
                time.monotonic() - t0,
                exemplar={"rid": rid} if rid else None)
            # emitted on failure too — the phase breakdown of an attach
            # that threw is when the decomposition matters most; the result
            # counter rides the same path so counters, trace lines and
            # phase histograms agree on request volume
            trace.finish(result_name, REGISTRY.attach_phase)
            REGISTRY.attach_results.inc(result=result_name)
            EVENTS.emit("attach", rid=rid, namespace=namespace,
                        pod=pod_name, node=self.settings.node_name,
                        chips=chips_granted, result=result_name,
                        entire=is_entire_mount)
        return outcome

    def _add_gpu(self, pod_name: str, namespace: str, gpu_num: int,
                 is_entire_mount: bool, txn_id: str = "",
                 request_id: str = "", *, trace: Trace) -> AddOutcome:
        if gpu_num <= 0:
            raise MountPolicyError(f"gpu_num must be >= 1, got {gpu_num}")
        with trace.span("policy"):
            try:
                pod = self.reads.get_pod(namespace, pod_name)
            except PodNotFoundError:
                return AddOutcome(
                    consts.AddResult.POD_NOT_FOUND,
                    message=f"pod {namespace}/{pod_name} not found")
            if not objects.is_running(pod):
                # ref server.go:44-56: only Running pods are mountable
                return AddOutcome(
                    consts.AddResult.POD_NOT_FOUND,
                    message=f"pod {namespace}/{pod_name} is "
                            f"{objects.phase(pod) or 'unknown'}, not Running")

            # Idempotent retry: when a prior attempt of this exact request
            # already created slave pods (worker died / reply lost before the
            # caller saw it), this call is a RESUME — the policy check
            # already passed for the original attempt, and re-running it
            # would self-deny (the prior attempt's pods make the pod look
            # entire-mounted).
            adopt = (self.allocator.request_slave_pods(pod_name, namespace,
                                                       request_id)
                     if request_id else set())
            if adopt:
                logger.info("AddGPU resume of request %s for %s/%s",
                            request_id, namespace, pod_name)
            else:
                current = self.allocator.get_mount_type(pod_name, namespace)
                if not can_mount(current, is_entire_mount):
                    raise MountPolicyError(
                        f"pod {namespace}/{pod_name} has mount type "
                        f"{current.value}; "
                        f"{'entire' if is_entire_mount else 'single'}-mount "
                        "denied (ref util.go:207-226)")

        # entire ⇒ one slave pod holding all N chips (atomic, topology-aligned
        # on GKE whole-host granularity); single ⇒ N one-chip slave pods
        # (ref server.go:62-66).
        per_pod = gpu_num if is_entire_mount else 1
        alloc_stats = AllocationStats()
        try:
            with trace.span("allocate"):
                chips, slaves = self.allocator.get_available_gpus(
                    pod, gpu_num, per_pod, txn_id=txn_id,
                    request_id=request_id, adopt=adopt,
                    pool=self.pool, stats=alloc_stats)
        except InsufficientGPUError as e:
            self._record_event(pod, "GPUAttachFailed", str(e), warning=True)
            return AddOutcome(consts.AddResult.INSUFFICIENT_GPU,
                              message=str(e))
        except AllocationTimeoutError as e:
            self._record_event(pod, "GPUAttachFailed",
                               f"allocation timed out: {e}", warning=True)
            return AddOutcome(consts.AddResult.INSUFFICIENT_GPU,
                              message=f"allocation timed out: {e}")

        # refresh=False: get_available_gpus's lag-retry loop ended on a fresh
        # kubelet snapshot that already listed every allocated chip — one
        # AddGPU costs O(1) kubelet LISTs.
        with trace.span("resolve"):
            all_slave_names = self.allocator.slave_pod_names(pod_name,
                                                             namespace)
            all_after = self.allocator.collector.get_pod_gpu_resources_exact(
                pod_name, namespace, all_slave_names, refresh=False)
        # Write-ahead intent BEFORE any cgroup/mknod actuation: if the
        # worker dies anywhere past this point, startup replay re-derives
        # ground truth and completes or reverts — partial device grants
        # cannot outlive a crash (worker/journal.py).
        jid = None
        if self.journal is not None:
            jid = self.journal.begin(
                request_id or txn_id, namespace, pod_name,
                objects.uid(pod), [c.uuid for c in chips], list(slaves),
                is_entire_mount)
        try:
            with trace.span("actuate"):
                # (no explicit warm call: the resident agent opens+caches
                # the container's ns handle on its first batch — an extra
                # per-attach warm pass would re-enumerate containers and
                # re-validate the handle for nothing)
                created_nodes = self.mounter.mount_chips(pod, chips,
                                                         all_after)
        except TPUMounterError as e:
            # rollback (ref server.go:87-92) + revert partial actuation
            logger.error("mount failed, rolling back %d slave pods: %s",
                         len(slaves), e)
            remaining = [c for c in all_after
                         if c.uuid not in {x.uuid for x in chips}]
            rollback_clean = True
            with trace.span("rollback"):
                try:
                    self.mounter.unmount_chips(pod, chips, remaining,
                                               force=False)
                except TPUMounterError as cleanup_err:
                    rollback_clean = False
                    logger.warning("rollback unmount incomplete: %s",
                                   cleanup_err)
                if self.allocator.delete_slave_pods(slaves, wait=False):
                    rollback_clean = False
            if jid is not None:
                # a clean rollback closes the record; an interrupted one
                # (apiserver died mid-revert, busy device) journals the
                # leftover so the next boot finishes the revert
                if rollback_clean:
                    self.journal.revert(jid)
                else:
                    self.journal.revert_pending(jid)
                    # incomplete actuation state is now parked on the
                    # node: a flight-recorder trigger (the bundle carries
                    # this rid's events, traces and the journal tail)
                    RECORDER.note("journal_backlog",
                                  rid=request_id or txn_id,
                                  backlog=self.journal.backlog())
            self._forget_attachment(namespace, pod_name)
            self._record_event(pod, "GPUAttachFailed",
                               f"actuation failed, rolled back: {e}",
                               warning=True)
            raise
        logger.debug("AddGPU ok: %d chips -> %s/%s (%s, warm=%d cold=%d)",
                    len(chips), namespace, pod_name,
                    "entire" if is_entire_mount else "single",
                    alloc_stats.warm_adopted, alloc_stats.cold_created)
        # A retry that adopted a fully-mounted prior attempt is the SAME
        # logical attach — record it under a distinct reason so the audit
        # trail shows one GPUAttached per attach, not one per retry. "Fully
        # mounted" means actuation found nothing left to do: a retry that
        # adopted the slave pods but still created device nodes (worker died
        # between allocate and mount) is the completing attempt and records
        # the real GPUAttached.
        resumed = bool(adopt) and set(slaves) <= adopt and created_nodes == 0
        if jid is not None:
            self.journal.commit(jid)
        self._remember_attachment(namespace, pod_name, objects.uid(pod),
                                  all_after, all_slave_names)
        # mesh-generation notification file (torchcheck/elastic.py): the
        # pod's chip set just changed — stamp the signal an elastic
        # job polls, AFTER actuation (the nodes exist when it reads this)
        self._stamp_mesh_generation(namespace, pod_name,
                                    [c.uuid for c in all_after])
        self._record_event(
            pod, "GPUAttachResumed" if resumed else "GPUAttached",
            f"attached {len(chips)} GPU(s) "
            f"({'entire' if is_entire_mount else 'single'}-mount): "
            f"{[c.uuid for c in chips]}")
        return AddOutcome(consts.AddResult.SUCCESS, chips=chips,
                          pool_hits=alloc_stats.warm_adopted,
                          pool_misses=(alloc_stats.cold_created
                                       if self.pool is not None else 0))

    # -- RemoveGPU (ref server.go:102-180) ------------------------------------

    def remove_gpu(self, pod_name: str, namespace: str, uuids: list[str],
                   force: bool, txn_id: str = "",
                   request_id: str = "", cause: str = "") -> RemoveOutcome:
        """``cause`` (broker-initiated detaches: ``preempted:...``,
        ``lease-expired:...``) is propagated into the trace, the
        GPUDetached audit event and the journal's detach record, so "who
        took my chips away and why" is answerable from every surface."""
        # detaches hold an in-flight token but are NEVER refused by a
        # drain: freeing capacity is what a drain is for
        if self.drain is not None:
            drain_token = self.drain.inflight("detach")
        else:
            drain_token = contextlib.nullcontext()
        with drain_token:
            return self._remove_gpu_traced(pod_name, namespace, uuids,
                                           force, txn_id, request_id,
                                           cause)

    def _remove_gpu_traced(self, pod_name: str, namespace: str,
                           uuids: list[str], force: bool,
                           txn_id: str = "", request_id: str = "",
                           cause: str = "") -> RemoveOutcome:
        trace = Trace("detach", request_id or txn_id)
        trace.root.attrs.update(pod=f"{namespace}/{pod_name}",
                                uuids=len(uuids), force=force)
        if cause:
            trace.root.attrs["cause"] = cause
        rid = request_id or txn_id
        result_name = "EXCEPTION"
        t0 = time.monotonic()
        try:
            with self._pod_lock(namespace, pod_name):
                outcome = self._remove_gpu(pod_name, namespace, uuids,
                                           force, txn_id, trace=trace,
                                           request_id=request_id,
                                           cause=cause)
            result_name = outcome.result.name
        finally:
            REGISTRY.detach_latency.observe(
                time.monotonic() - t0,
                exemplar={"rid": rid} if rid else None)
            trace.finish(result_name, REGISTRY.detach_phase)
            REGISTRY.detach_results.inc(result=result_name)
            EVENTS.emit("detach", rid=rid, namespace=namespace,
                        pod=pod_name, node=self.settings.node_name,
                        result=result_name, cause=cause, force=force)
        return outcome

    def _remove_gpu(self, pod_name: str, namespace: str, uuids: list[str],
                    force: bool, txn_id: str = "", *,
                    trace: Trace, request_id: str = "",
                    cause: str = "") -> RemoveOutcome:
        with trace.span("resolve"):
            try:
                pod = self.reads.get_pod(namespace, pod_name)
            except PodNotFoundError:
                return RemoveOutcome(
                    consts.RemoveResult.POD_NOT_FOUND,
                    message=f"pod {namespace}/{pod_name} not found")

            # Attachment-record fast path: a detach of chips THIS worker
            # attached resolves from the record cached at attach time
            # (validated against the informer's slave-pod view) — zero
            # kubelet round trips, zero inventory re-scans.
            cached = self._resolve_detach_cached(pod, pod_name, namespace,
                                                 uuids, txn_id)
            if cached is not None:
                chips, holders, all_chips = cached
                annotate(cached_resolve=True)
            else:
                try:
                    chips, holders, all_slaves = \
                        self.allocator.get_removable_gpus(
                            pod_name, uuids, owner_namespace=namespace,
                            txn_id=txn_id or None)
                except DeviceNotFoundError as e:
                    return RemoveOutcome(consts.RemoveResult.GPU_NOT_FOUND,
                                         message=str(e))
                if not chips:
                    return RemoveOutcome(
                        consts.RemoveResult.GPU_NOT_FOUND,
                        message="no removable chips on "
                                f"{namespace}/{pod_name}")

                # refresh=False + all_slaves: get_removable_gpus above
                # already took both the kubelet snapshot and the
                # apiserver slave LIST.
                all_chips = \
                    self.allocator.collector.get_pod_gpu_resources_exact(
                        pod_name, namespace, all_slaves, refresh=False)

        # Whole-slave-pod granularity: removing part of a slave pod's chips
        # would desync scheduler accounting (see module docstring).
        partial = self._partially_covered_holders(chips, holders, all_chips)
        if partial:
            return RemoveOutcome(
                consts.RemoveResult.GPU_NOT_FOUND,
                message="refusing partial removal from slave pod(s) "
                        f"{partial}: include all of their chip ids or none")

        remaining = [c for c in all_chips
                     if c.uuid not in {x.uuid for x in chips}]
        try:
            with trace.span("actuate"):
                # cause rides into the gate revoke: a broker-initiated
                # detach (lease expiry / preemption) of a BUSY device
                # still cuts gate access instantly before the busy error
                # returns — re-opens deny-with-reason from here on
                self.mounter.unmount_chips(pod, chips, remaining,
                                           force=force, cause=cause)
        except DeviceBusyError as e:
            # ref server.go:148-153 GPUBusy; holder PIDs surfaced to caller
            self._record_event(
                pod, "GPUBusy",
                f"detach refused: chips held by PIDs {e.pids}",
                warning=True)
            return RemoveOutcome(consts.RemoveResult.GPU_BUSY,
                                 busy_pids=e.pids, message=str(e))
        with trace.span("cleanup"):
            self.allocator.delete_slave_pods(holders)
            # the freed chips must read FREE to snapshot consumers
            # (/topoz, node_status) NOW, not at the next kubelet refresh
            self.allocator.collector.mark_released(
                [c.uuid for c in chips])
        # the record described the pre-detach attachment; whatever remains
        # (partial detach) is re-resolved and re-recorded by the next
        # attach, never served stale
        self._forget_attachment(namespace, pod_name)
        logger.debug("RemoveGPU ok: %d chips off %s/%s (force=%s%s)",
                    len(chips), namespace, pod_name, force,
                    f", cause={cause}" if cause else "")
        # Journal the detach (terminal record, replay ignores it): the
        # node-local audit of WHO released these devices and why — a
        # preempted/expired attachment must be explainable from the node
        # alone, same as a crash-replayed one.
        if self.journal is not None:
            self.journal.record_detach(
                request_id or txn_id, namespace, pod_name,
                [c.uuid for c in chips], cause=cause, force=force)
        self._stamp_mesh_generation(namespace, pod_name,
                                    [c.uuid for c in remaining])
        self._record_event(
            pod, "GPUDetached",
            f"detached {len(chips)} GPU(s) (force={force}"
            + (f", cause={cause}" if cause else "") + "): "
            f"{[c.uuid for c in chips]}")
        return RemoveOutcome(consts.RemoveResult.SUCCESS)

    # -- mesh-generation notification (torchcheck/elastic.py file signal) --

    def _stamp_mesh_generation(self, namespace: str, pod_name: str,
                               chips: list[str]) -> None:
        """Write the per-owner-pod mesh-generation file an elastic
        job polls (``TPU_MESH_GEN_DIR``; mounted into the workload via
        hostPath): {"generation": <unix>, "chips": [...]}. Written
        atomically and best-effort — a full disk must not fail a mount
        that already succeeded. Disabled (the default) = zero writes."""
        directory = self.settings.mesh_gen_dir
        if not directory:
            return
        import json as json_mod
        import os
        import tempfile
        try:
            os.makedirs(directory, exist_ok=True)
            path = os.path.join(directory,
                                f"{namespace}--{pod_name}.json")
            fd, tmp = tempfile.mkstemp(dir=directory, suffix=".gen")
            with os.fdopen(fd, "w") as f:
                json_mod.dump({"generation": round(time.time(), 6),
                               "chips": sorted(chips)}, f)
                f.flush()
                # fsync'd like a checkpoint shard: the elastic job's
                # reshape decision rides this file — a worker crash
                # right after an actuation must not leave a stale (or
                # torn) generation behind the chips' new reality
                os.fsync(f.fileno())
            os.replace(tmp, path)
            # the rename itself is only crash-durable once the DIRECTORY
            # entry is synced — same discipline as the checkpoint
            # writer's (torchcheck/drain.py)
            dir_fd = os.open(directory, os.O_RDONLY)
            try:
                os.fsync(dir_fd)
            finally:
                os.close(dir_fd)
        except OSError as e:
            logger.warning("mesh-generation stamp for %s/%s failed: %s",
                           namespace, pod_name, e)

    def flush_mesh_generation(self) -> None:
        """Drain-time flush hook (worker/drain.py): fsync the
        notification directory so every stamped generation file's name
        is durable before the process exits — the settle-before-detach
        contract includes the signal files elastic jobs steer by."""
        directory = self.settings.mesh_gen_dir
        if not directory:
            return
        import os
        try:
            fd = os.open(directory, os.O_RDONLY)
        except OSError:
            return
        try:
            os.fsync(fd)
        finally:
            os.close(fd)

    # -- attachment-record cache (detach resolution fast path) ----------------

    def _remember_attachment(self, namespace: str, pod_name: str, uid: str,
                             all_chips: list[GPUDevice],
                             slaves: set[str]) -> None:
        with self._attach_records_lock:
            self._attach_records[(namespace, pod_name)] = _AttachmentRecord(
                uid=uid, all_chips=list(all_chips), slaves=set(slaves),
                recorded_at=time.monotonic())

    def _forget_attachment(self, namespace: str, pod_name: str) -> None:
        with self._attach_records_lock:
            self._attach_records.pop((namespace, pod_name), None)

    def attachment_owners(self) -> dict[str, tuple[str, str]]:
        """{slave pod name: (owner namespace, owner pod)} from the
        attachment records — the usage sampler's (collector/usage.py)
        cheap ownership source for chips THIS process attached. Read-only
        snapshot under the records lock; called from the sampler thread,
        never the request path."""
        with self._attach_records_lock:
            return {slave: key
                    for key, record in self._attach_records.items()
                    for slave in record.slaves}

    def _resolve_detach_cached(
            self, pod: objects.Pod, pod_name: str, namespace: str,
            uuids: list[str], txn_id: str = ""
    ) -> tuple[list[GPUDevice], list[str], list[GPUDevice]] | None:
        """(chips, holders, all_chips) from the attach-time record, or
        None when the full re-resolution must run. None is always safe —
        this is strictly a latency fast path; every validation failure
        (unknown pod, recreated pod, aged record, slave set drifted,
        uuids outside the record, txn-scoped detach, no informer to
        validate against) falls back."""
        if txn_id:
            return None
        with self._attach_records_lock:
            record = self._attach_records.get((namespace, pod_name))
        if record is None:
            return None
        pool_ns = self.settings.pool_namespace
        if record.uid != objects.uid(pod) \
                or time.monotonic() - record.recorded_at \
                > self.settings.attach_cache_ttl_s \
                or not self.reads.covers(pool_ns):
            self._forget_attachment(namespace, pod_name)
            return None
        # ground truth check, served from the informer cache (zero
        # apiserver round trips): the owner's slave set must be exactly
        # what the attach recorded — reconciler GC or an operator delete
        # in between flunks this and forces the full path
        try:
            live = {objects.name(p) for p in self.reads.list_pods(
                pool_ns,
                label_selector=self.allocator._owner_selector(
                    pod_name, namespace))}
        except TPUMounterError:
            return None
        if live != record.slaves:
            self._forget_attachment(namespace, pod_name)
            return None
        removable = {c.uuid: c for c in record.all_chips
                     if c.namespace == pool_ns
                     and c.pod_name in record.slaves}
        if not removable:
            return None
        wanted = list(uuids) or list(removable)
        if any(u not in removable for u in wanted):
            # unknown / non-removable ids: the full path re-resolves with
            # fresh data and raises the precise DeviceNotFoundError
            return None
        chips = [removable[u] for u in wanted]
        holders = sorted({c.pod_name for c in chips})
        return chips, holders, list(record.all_chips)

    # -- GPUStatus (observability; no reference analog — their check was a
    # human running nvidia-smi, docs/guide/QuickStart.md:42-97) ---------------

    def gpu_status(self, pod_name: str,
                   namespace: str) -> tuple[consts.MountType,
                                            list[ChipStatus]]:
        """Raises PodNotFoundError for unknown pods (gRPC NOT_FOUND)."""
        pod = self.reads.get_pod(namespace, pod_name)
        mount_type = self.allocator.get_mount_type(pod_name, namespace)
        slave_names = self.allocator.slave_pod_names(pod_name, namespace)
        chips = self.allocator.collector.get_pod_gpu_resources_exact(
            pod_name, namespace, slave_names)
        out = []
        for chip in chips:
            held_by_slave = (chip.namespace == self.settings.pool_namespace
                             and chip.pod_name in slave_names)
            out.append(ChipStatus(
                device_id=chip.uuid,
                device_path=chip.container_path,
                slave_pod=chip.pod_name if held_by_slave else "",
                busy_pids=self.mounter.pod_device_processes(pod, chip)))
        return mount_type, out

    # -- k8s Events audit trail (kubectl describe visibility; no reference
    # analog — their only audit was worker logs) ---------------------------

    # Minimum seconds between identical (pod, reason) events — poor man's
    # EventRecorder aggregation (our minimal client has no PATCH, so
    # suppress repeats instead of bumping count): a 1 Hz retry loop against
    # a full node emits ~2 events/min, not thousands/hour.
    _EVENT_SUPPRESS_S = 30.0

    def _record_event(self, pod: objects.Pod, reason: str, message: str,
                      warning: bool = False) -> None:
        """Best-effort core/v1 Event on the target pod; never fails or
        delays the RPC — the POST runs in a fire-and-forget thread (a
        degraded apiserver must not stall a mount that already succeeded),
        and a cluster that denies events create just loses the audit
        trail, not the mount."""
        import datetime
        import secrets
        name, namespace = objects.name(pod), objects.namespace(pod)
        if warning:
            # Suppress only failure events: those are what retry loops spam
            # (1 Hz against a full node). Success events are operator-
            # initiated and rare — every one belongs in the audit trail.
            now_mono = time.monotonic()
            key = (namespace, name, reason)
            with self._event_times_lock:
                last = self._event_times.get(key, -1e18)
                if now_mono - last < self._EVENT_SUPPRESS_S:
                    return
                self._event_times[key] = now_mono
                if len(self._event_times) > 4096:   # bound the dedupe table
                    cutoff = now_mono - self._EVENT_SUPPRESS_S
                    self._event_times = {
                        k: t for k, t in self._event_times.items()
                        if t > cutoff}
        now = datetime.datetime.now(datetime.timezone.utc).strftime(
            "%Y-%m-%dT%H:%M:%SZ")
        # object names cap at 253 chars; keep the 22-char suffix, trim the
        # pod part and re-trim to a valid RFC1123 label end
        event_name = (f"{name[:231].rstrip('-.')}"
                      f".gpumounter.{secrets.token_hex(5)}")
        event = {
            "apiVersion": "v1",
            "kind": "Event",
            "metadata": {"name": event_name, "namespace": namespace},
            "involvedObject": {"apiVersion": "v1", "kind": "Pod",
                               "name": name, "namespace": namespace,
                               "uid": objects.uid(pod)},
            "reason": reason,
            "message": message[:1024],
            "type": "Warning" if warning else "Normal",
            "source": {"component": "gpu-mounter-worker",
                       "host": self.settings.node_name},
            "firstTimestamp": now,
            "lastTimestamp": now,
            "count": 1,
        }

        def post():
            try:
                self.kube.create_event(namespace, event)
            except Exception as e:
                logger.warning("event %s for %s/%s not recorded: %s",
                               reason, namespace, name, e)

        with self._event_cond:
            if self._event_thread is None:
                self._event_thread = threading.Thread(
                    target=self._drain_events, daemon=True,
                    name="tpumounter-events")
                self._event_thread.start()
            if len(self._event_queue) == self._event_queue.maxlen:
                # The audit trail is about to lose its oldest entry — say so,
                # or operators can't tell the trail is incomplete.
                logger.warning(
                    "event queue full (%d); dropping oldest audit event",
                    self._event_queue.maxlen)
            self._event_queue.append(post)   # deque(maxlen): drops oldest
            self._event_cond.notify()

    def _drain_events(self) -> None:
        while True:
            with self._event_cond:
                while not self._event_queue:
                    timed_out = not self._event_cond.wait(timeout=60.0)
                    if timed_out and not self._event_queue:
                        # Idle: exit rather than pin the service object
                        # graph alive forever; _record_event restarts us.
                        self._event_thread = None
                        return
                post = self._event_queue.popleft()
            post()

    def node_status(self) -> list[GPUDevice]:
        """Node-wide GPU inventory with allocation state (one fresh kubelet
        snapshot) — the "what's free on this node?" view. No reference
        analog beyond ssh + nvidia-smi. The accelerator comes from the
        node's GKE label (authoritative, present even for FREE GPUs);
        unlabelled nodes report it empty."""
        from gpumounter_tpu_torch.allocator import topology as topology_lib
        from gpumounter_tpu_torch.utils.errors import K8sApiError
        self.allocator.collector.update_status()
        chips = self.allocator.collector.chips
        topo = None
        if self.settings.node_name:
            try:
                node = self.kube.get_node(self.settings.node_name)
                topo = topology_lib.node_topology(node)
            except K8sApiError:
                pass        # unlabelled/unreadable node: fields stay empty
        if topo:
            # Stamp copies, not the collector's live objects: mutating shared
            # GPUs here would race a concurrent update_status inventory
            # rebuild and could serialise a torn view.
            chips = [dataclasses.replace(c, accelerator=topo.accelerator)
                     for c in chips]
        return chips

    # -- crash recovery: attach-journal replay (worker/journal.py) ------------

    def replay_journal(self) -> dict[str, int]:
        """Resolve every incomplete journal record at worker startup.

        Ground truth is re-derived from the cluster per record (owner pod
        liveness + surviving slave pods + the kubelet's device map), never
        trusted from the journal alone — the cluster moved on while this
        worker was down. Returns {outcome: count}; each outcome also feeds
        ``tpumounter_journal_replays_total``."""
        outcomes: collections.Counter = collections.Counter()
        if self.journal is None:
            # no journal (disabled / unwritable dir): attach replay has
            # nothing to work from, but GATE convergence must still run
            # — it derives desired state from cluster ground truth, not
            # the journal, and a crash-orphaned kernel grant would
            # otherwise never be reclaimed in this supported config
            gate_stats = self._converge_gate()
            for outcome, count in gate_stats.items():
                if count:
                    outcomes[f"gate_{outcome}"] += count
            return dict(outcomes)
        for record in self.journal.incomplete():
            try:
                outcome = self._replay_record(record)
            except TPUMounterError:
                # a record that cannot be resolved now stays incomplete
                # (retried next boot); a broken record must not block boot
                logger.exception("journal replay of %s failed",
                                 record.get("jid"))
                outcome = "failed"
            outcomes[outcome] += 1
            REGISTRY.journal_replays.inc(outcome=outcome)
            EVENTS.emit("journal_replay", rid=record.get("rid", ""),
                        namespace=record.get("namespace", ""),
                        pod=record.get("pod", ""),
                        node=self.settings.node_name,
                        jid=record.get("jid"), outcome=outcome)
            logger.info("journal replay %s (%s/%s devices=%s): %s",
                        record.get("jid"), record.get("namespace"),
                        record.get("pod"), record.get("devices"), outcome)
        # Gate convergence: re-derive desired policy-map contents from
        # attachment ground truth and make the live maps match — orphan
        # entries revoked, missing grants restored, pending gate records
        # resolved. Runs AFTER the per-record replay so the cluster state
        # it derives from is post-repair.
        gate_stats = self._converge_gate()
        for outcome, count in gate_stats.items():
            if count:
                outcomes[f"gate_{outcome}"] += count
        if gate_stats:
            logger.info("gate convergence: %s", gate_stats)
        self.journal.compact()
        if self.journal.backlog():
            # replay could not resolve everything (busy devices, apiserver
            # trouble): incomplete actuation state remains — capture it
            RECORDER.note("journal_backlog",
                          backlog=self.journal.backlog())
        return dict(outcomes)

    def _converge_gate(self) -> dict:
        """Re-grant every live attachment through the gate and sweep
        orphan gate state (worker/journal.py gate records + the backend's
        own enumeration). The desired map contents come from CLUSTER
        ground truth — slave-pod owner labels + the kubelet's device
        assignments — never from the dead process's memory."""
        gate = self.mounter.gate
        if not gate.live:
            return {}
        pending = self.journal.pending_gates() \
            if self.journal is not None else []
        desired: list[tuple] = []
        try:
            self.allocator.collector.update_status()
            owners: dict[tuple[str, str], list[str]] = {}
            selector = (f"{consts.SLAVE_POD_LABEL_KEY}="
                        f"{consts.SLAVE_POD_LABEL_VALUE}")
            for slave in self.reads.list_pods(
                    self.settings.pool_namespace,
                    label_selector=selector):
                labels = objects.labels(slave)
                owner = labels.get(consts.OWNER_POD_LABEL_KEY)
                owner_ns = labels.get(consts.OWNER_NAMESPACE_LABEL_KEY)
                if owner and owner_ns:
                    owners.setdefault((owner_ns, owner), []).append(
                        objects.name(slave))
            for (owner_ns, owner), slaves in sorted(owners.items()):
                try:
                    pod = self.reads.get_pod(owner_ns, owner)
                except PodNotFoundError:
                    continue        # reconciler GCs the slaves
                if not objects.is_running(pod):
                    continue
                chips = \
                    self.allocator.collector.get_pod_gpu_resources_exact(
                        owner, owner_ns, slaves, refresh=False)
                if not chips:
                    continue
                try:
                    containers = self.mounter._actuatable_containers(pod)
                except TPUMounterError:
                    continue
                for container_id, _pid in containers:
                    desired.append((pod, container_id, chips))
        except TPUMounterError as e:
            logger.warning("gate convergence could not derive ground "
                           "truth: %s (retried next boot)", e)
            return {}
        from gpumounter_tpu_torch.actuation.bpf import chip_majmins
        majmins = set(chip_majmins(self.allocator.collector.chips))
        stats = gate.converge(desired, all_chip_majmins=majmins)
        # Pending gate mutations are subsumed by a CLEAN convergence;
        # any failure (unreadable container, backend trouble) keeps the
        # records incomplete so the next boot retries — resolving them
        # over a divergent map would drop the crash evidence.
        if self.journal is not None and not stats.get("failed"):
            for record in pending:
                self.journal.gate_commit(record["jid"])
        return stats

    def _replay_record(self, record: dict) -> str:
        namespace, pod_name = record["namespace"], record["pod"]
        devices = set(record.get("devices") or [])
        slaves = set(record.get("slaves") or [])
        try:
            pod = self.reads.get_pod(namespace, pod_name)
        except PodNotFoundError:
            pod = None
        # A same-named recreated pod is NOT the pod this attach targeted.
        owner_alive = (pod is not None and objects.is_running(pod)
                       and (not record.get("uid")
                            or objects.uid(pod) == record["uid"]))
        live_slaves = {name for name in slaves
                       if self._slave_pod_exists(name)}

        if record["state"] == "intent" and owner_alive \
                and live_slaves == slaves:
            # Crash was mid-attach and everything still stands: COMPLETE
            # it. Actuation is idempotent (existing nodes short-circuit,
            # cgroup sync is whole-set), so re-running is safe whether the
            # crash hit before, during, or after the original actuation.
            self.allocator.collector.update_status()
            all_names = self.allocator.slave_pod_names(pod_name, namespace)
            all_chips = self.allocator.collector.get_pod_gpu_resources_exact(
                pod_name, namespace, all_names, refresh=False)
            chips = [c for c in all_chips if c.uuid in devices]
            if {c.uuid for c in chips} == devices:
                self.mounter.mount_chips(pod, chips, all_chips)
                self.journal.commit(record["jid"])
                # GPUAttachResumed, not GPUAttached: the original attempt's
                # event (if it got that far) plus this one must not read as
                # two logical attaches
                self._record_event(
                    pod, "GPUAttachResumed",
                    f"journal replay completed attach of {sorted(devices)}")
                return "completed"
            # kubelet no longer maps those devices to these pods: the
            # reservation is gone — fall through to revert

        if not owner_alive and not live_slaves:
            self.journal.revert(record["jid"])
            return "noop"

        # REVERT: undo whatever was partially actuated, then release the
        # slave-pod reservations. Owner gone ⇒ its cgroup/mount ns died
        # with it, only the reservations remain.
        if owner_alive:
            self.allocator.collector.update_status()
            all_names = self.allocator.slave_pod_names(pod_name, namespace)
            all_chips = self.allocator.collector.get_pod_gpu_resources_exact(
                pod_name, namespace, all_names, refresh=False)
            doomed = [c for c in all_chips if c.uuid in devices]
            remaining = [c for c in all_chips if c.uuid not in devices]
            try:
                self.mounter.unmount_chips(pod, doomed, remaining,
                                           force=False)
            except DeviceBusyError:
                # the pod IS using a device from an uncommitted attach:
                # yanking it would kill the workload. Leave the record
                # incomplete (next boot retries) and surface the conflict.
                self._record_event(
                    pod, "GPUAttachFailed",
                    "journal replay found uncommitted devices in use; "
                    "revert deferred", warning=True)
                return "failed"
        if self.allocator.delete_slave_pods(sorted(live_slaves),
                                            wait=False):
            # apiserver trouble mid-revert AGAIN: keep the record pending
            self.journal.revert_pending(record["jid"])
            return "failed"
        self.journal.revert(record["jid"])
        if pod is not None:
            self._record_event(
                pod, "GPUAttachReverted",
                f"journal replay reverted uncommitted attach of "
                f"{sorted(devices)}", warning=True)
        return "reverted"

    def _slave_pod_exists(self, name: str) -> bool:
        try:
            self.reads.get_pod(self.settings.pool_namespace, name)
            return True
        except PodNotFoundError:
            return False

    @staticmethod
    def _partially_covered_holders(chips: list[GPUDevice], holders: list[str],
                                   all_chips: list[GPUDevice]) -> list[str]:
        """Holder slave pods whose chip set is not fully covered by the
        requested removal (derived from the already-fetched chip listing —
        no extra kubelet round-trips)."""
        requested = {c.uuid for c in chips}
        return [holder for holder in holders
                if any(c.pod_name == holder and c.uuid not in requested
                       for c in all_chips)]
