"""Slice transactions, gang admission, slice-group leases, live resize and
the re-federation barrier (the port of
:mod:`gpumounter_tpu.master.slicetxn` on the single-master path).

1. **Crash safety.** Every slice attach writes a transaction intent
   record (:class:`~gpumounter_tpu_torch.master.store.SliceTxnRecord`:
   txn id, member pods, GPUs per host, tenant, deadline) to the
   per-shard intent store BEFORE any host is touched, appends a per-host
   commit marker as each host lands, and deletes the record only at
   terminal commit or abort. A record found at rehydration is therefore
   exactly a transaction its writer never resolved: the adopting leader
   re-runs the fan-out under the ORIGINAL request id while the deadline
   holds (worker per-rid idempotency turns re-runs of landed hosts into
   adoptions) or rolls every member back through the txn-targeted detach
   once it has passed. Without the store (``broker.store`` None) the
   records are built and nothing is written.

2. **Gang admission.** With ``TPU_QUEUE_TIMEOUT_S`` > 0 a slice that
   meets InsufficientGPU parks as a **gang waiter** that reserves
   per-node capacity incrementally — hosts that attached stay attached
   (they ARE the reservation) while the gang waits for the rest.
   Reservations carry a hold deadline (``TPU_GANG_HOLD_S``): a gang that
   cannot complete hands its hosts back and keeps waiting, so two gangs
   competing for overlapping nodes cannot deadlock. Timing out returns
   503 with ``queued_s``.

3. **Slice-group leases + live reshaping.** A committed slice records one
   lease per member pod, all stamped with the slice's ``group`` id, and
   the broker treats the group as ONE lease (renewal, expiry and
   preemption take the whole slice). ``POST /slice/resize`` computes the
   host delta against the group's membership, runs the grow half as a
   slice txn and the shrink half through the normal detach path, and
   bumps the slice's **mesh generation** (an annotation on every member
   pod plus the /slicez view) only once the new device set is fully
   actuated.

4. **The re-federation barrier.** Each generation (a fresh slice's 1 and
   every bump) arms a barrier the members join over ``/slice/barrier``
   (``torchcheck/federation.py`` is the member side); the join that
   completes it freezes the federation plan every member receives. Every
   barrier state change crosses :meth:`SliceTxnManager._barrier_transition`.

5. **Self-healing** (the node failure domain, master/nodehealth.py): a
   group whose member's node is judged dead is repaired onto a spare pod
   (``tpumounter.io/slice-spare=true``) under the SAME group lease with
   one generation bump, or torn down as a unit when no spare (or no
   repair budget) is left; a member on a draining node is migrated
   grow-first, and deferred — never torn down — when no spare exists.

Without a queue timeout gangs never park and without a lease TTL groups
never expire: the plain all-or-nothing fan-out with rollback.
"""

from __future__ import annotations

import threading
import time
import uuid as uuid_mod

from gpumounter_tpu_torch.k8s import objects
from gpumounter_tpu_torch.master.slice import (ROLLBACK_CLEAN, PodResult,
                                               SliceCoordinator)
from gpumounter_tpu_torch.master.store import (SliceBarrierRecord,
                                               SliceTxnRecord)
from gpumounter_tpu_torch.utils import consts
from gpumounter_tpu_torch.utils.errors import (QueueFullError,
                                               QuotaExceededError,
                                               StoreFencedError,
                                               TopologyError)
from gpumounter_tpu_torch.utils.events import EVENTS
from gpumounter_tpu_torch.utils.log import get_logger
from gpumounter_tpu_torch.utils.metrics import REGISTRY
from gpumounter_tpu_torch.utils.trace import Trace

logger = get_logger("master.slicetxn")

# The result an attach answers when the host lacks free GPUs: the one
# failure a gang parks on instead of failing fast.
_INSUFFICIENT = consts.AddResult.INSUFFICIENT_GPU.name
_ATTACHED = consts.AddResult.SUCCESS.name

# The slice-repair budget counts within a sliding window, not over the
# group's lifetime: the budget exists to stop a crash-LOOPING node from
# grinding the spare pool, and a long-lived gang that legitimately
# survived N spot deaths over weeks must not be torn down on the Nth.
REPAIR_BUDGET_WINDOW_S = 1800.0


def _pod_key(namespace: str, pod: str) -> str:
    return f"{namespace}/{pod}"


class _LiveTxn:
    """One in-flight transaction, as this replica drives it."""

    __slots__ = ("record", "started", "state", "adopted")

    def __init__(self, record: SliceTxnRecord, adopted: bool = False):
        self.record = record
        self.started = time.monotonic()
        self.state = "fanout"            # "fanout" | "parked"
        self.adopted = adopted


class _Barrier:
    """One slice group's re-federation barrier: the set of members that
    must re-federate at ``generation`` before ANY member may restore.
    Membership order IS the federation plan's process-id assignment."""

    __slots__ = ("group", "generation", "members", "joined",
                 "armed_unix", "completed_unix", "plan")

    def __init__(self, group: str, generation: int, members: list[str]):
        self.group = group
        self.generation = int(generation)
        self.members = list(members)          # ordered "ns/pod" keys
        self.joined: dict[str, str] = {}      # member -> proposed address
        self.armed_unix = time.time()
        self.completed_unix: float | None = None
        self.plan: dict | None = None


class SliceTxnManager:
    """Owns every slice transaction a gateway runs (attach, resize,
    adoption, group detach). One per gateway; the broker binds it
    (``bind_slice``) for group-lease expiry/preemption and failover
    adoption."""

    def __init__(self, gateway):
        self.gateway = gateway
        self.broker = gateway.broker
        self._lock = threading.Lock()
        self._txns: dict[str, _LiveTxn] = {}
        # txn ids an adoption thread currently drives (pre-registration:
        # the window between "decided to adopt" and "txn registered")
        self._adopting: set[str] = set()
        # group id -> {"generation", "gpus_per_host"} — the mesh
        # generation the resize route bumps; membership itself lives in
        # the lease table (a detached member leaves its group with no
        # bookkeeping to desync)
        self._groups: dict[str, dict] = {}
        # group id -> _Barrier: armed on every generation bump (and on a
        # fresh group's commit). Persisted to the intent store so a
        # failed-over leader re-arms it; every state change crosses
        # _barrier_transition (lint-pinned).
        self._barriers: dict[str, _Barrier] = {}
        # test seam: a hook between hosts of one fan-out
        self.before_host_attach = None
        # Slice self-healing (node failure domain): spare-pod discovery
        # bound by the gateway (candidates_fn(namespace, count, exclude)
        # -> [(ns, pod), ...] on healthy nodes), per-group in-flight
        # guard, per-group consumed repair budget, and the live repair
        # threads (join_repairs drains them in tests).
        self._candidates_fn = None
        self._repairing: set[str] = set()
        # group -> (repairs consumed, window start monotonic); the
        # window resets after REPAIR_BUDGET_WINDOW_S of quiet and the
        # key is deleted at teardown (a reused group name must not
        # inherit an exhausted budget)
        self._repair_counts: dict[str, tuple[int, float]] = {}
        self._repair_threads: list[threading.Thread] = []

    # -- plumbing --------------------------------------------------------------

    def _coordinator(self, txn: _LiveTxn | None = None) -> SliceCoordinator:
        on_host_done = self._marker_callback(txn) if txn is not None \
            else None
        return SliceCoordinator(self.gateway, on_host_done=on_host_done,
                                before_host_attach=self.before_host_attach)

    def _marker_callback(self, txn: _LiveTxn):
        def mark(result: PodResult) -> None:
            if result.result != _ATTACHED:
                return
            key = _pod_key(result.namespace, result.pod)
            with self._lock:
                if key not in txn.record.committed:
                    txn.record.committed.append(key)
            # the marker is the crash-recovery breadcrumb: persisted the
            # moment the host lands, from the fan-out thread itself
            self._persist_txn(txn.record)
        return mark

    def _persist_txn(self, record: SliceTxnRecord) -> None:
        store = self.broker.store
        if store is None:
            return
        try:
            store.put_slice_txn(record)
        except StoreFencedError as e:
            self.broker._on_fenced(e)

    def _unpersist_txn(self, record: SliceTxnRecord) -> None:
        store = self.broker.store
        if store is None:
            return
        try:
            store.delete_slice_txn(record.namespace, record.txn_id)
        except StoreFencedError as e:
            self.broker._on_fenced(e)

    def _rollback(self, pods, txn_id: str, rid: str):
        """Txn-targeted rollback with its own trace: the span feeds
        phase="rollback" into the shared attach_phase family."""
        trace = Trace("slice_rollback", rid or "-")
        result = "EXCEPTION"
        try:
            with trace.span("rollback"):
                clean, results = self._coordinator().rollback(
                    pods, txn_id, rid)
            result = "CLEAN" if clean else "PARTIAL"
        finally:
            trace.finish(result, REGISTRY.attach_phase)
        return clean, results

    def _register(self, txn: _LiveTxn) -> None:
        with self._lock:
            self._txns[txn.record.txn_id] = txn
        self.export_gauges()

    def _unregister(self, txn: _LiveTxn) -> None:
        with self._lock:
            self._txns.pop(txn.record.txn_id, None)
        self.export_gauges()

    # -- attach (the crash-safe transaction) ------------------------------------

    def attach(self, pods: list[tuple[str, str]], gpus_per_host: int, *,
               tenant: str, priority: str, rid: str,
               strict: bool = False, txn_id: str | None = None,
               lease_group: str | None = None,
               timeout_s: float | None = None,
               adopted: bool = False,
               committed: list[str] | None = None) -> tuple[int, dict]:
        """The whole slice attach: admission (reservation-scoped for the
        full GPU count), intent record, fan-out with per-host commit
        markers, gang parking on contention, terminal commit/abort.
        Raises :class:`TopologyError` pre-fan-out (→ 412) and the
        broker's admission errors (→ 429). ``timeout_s`` overrides the
        configured queue deadline (adopted transactions park for their
        REMAINING time)."""
        total = gpus_per_host * len(pods)
        txn_id = txn_id or ("txn-" + uuid_mod.uuid4().hex[:12])
        lease_group = lease_group or txn_id
        timeout = (self.broker.config.queue_timeout_s
                   if timeout_s is None else timeout_s)
        with self.broker.admission(tenant, total, rid):
            record = SliceTxnRecord(
                txn_id=txn_id, rid=rid, tenant=tenant, priority=priority,
                pods=[_pod_key(ns, pod) for ns, pod in pods],
                gpus_per_host=gpus_per_host,
                committed=list(committed or []),
                created_unix=round(time.time(), 3),
                deadline_unix=round(time.time() + max(timeout, 0.0), 3),
                group="" if lease_group == txn_id else lease_group)
            txn = _LiveTxn(record, adopted=adopted)
            self._register(txn)
            # intent BEFORE fan-out: a crash from here on leaves a record
            # a surviving leader resolves — never a silent half-slice
            self._persist_txn(record)
            try:
                return self._run(txn, pods, gpus_per_host, tenant,
                                 priority, rid, timeout, lease_group,
                                 strict=strict)
            except TopologyError:
                # pre-fan-out rejection: no host was touched — the
                # intent record must not outlive the refusal
                self._unpersist_txn(record)
                raise
            finally:
                self._unregister(txn)

    def _run(self, txn: _LiveTxn, pods, gpus_per_host, tenant, priority,
             rid, timeout, lease_group,
             strict: bool = False) -> tuple[int, dict]:
        coordinator = self._coordinator(txn)
        config = self.broker.config
        deadline = time.monotonic() + max(timeout, 0.0)
        attached: dict[str, PodResult] = {}
        waiter = None
        hold_deadline: float | None = None
        enqueued_at: float | None = None
        # validate inside the FIRST fan-out's trace only (adopted re-runs
        # passed validation when the original request arrived; the
        # cluster may have drifted, but the per-host attach then reports
        # precisely) — a TopologyError propagates before any host RPC
        first = not txn.adopted
        try:
            while True:
                # capacity generation BEFORE the attempt: a signal that
                # fires during the fan-out must not be lost if we park
                gen_before = self.broker.current_gen()
                missing = [(ns, pod) for ns, pod in pods
                           if _pod_key(ns, pod) not in attached]
                _, results, _ = coordinator.attach(
                    missing, gpus_per_host, request_id=rid,
                    txn_id=txn.record.txn_id, validate=first,
                    strict=strict, rollback=False)
                first = False
                for result in results:
                    if result.result == _ATTACHED:
                        attached[_pod_key(result.namespace,
                                          result.pod)] = result
                failures = [r for r in results if r.result != _ATTACHED]
                if not failures:
                    return self._commit(txn, pods, attached, tenant,
                                        priority, rid, gpus_per_host,
                                        lease_group, waiter, enqueued_at)
                hard = [r for r in failures if r.result != _INSUFFICIENT]
                if hard or timeout <= 0:
                    # a host that can never join (pod gone, policy
                    # denial, worker down) — or gang queueing disabled:
                    # fail fast
                    return self._abort(txn, pods, attached, failures,
                                       tenant, rid, waiter, enqueued_at)
                # every failure is InsufficientGPU and queueing is on:
                # park as a gang — successes stay attached as the
                # incremental reservation, protected by a hold deadline
                if waiter is None:
                    try:
                        waiter = self.broker.park_gang(
                            tenant=tenant, priority=priority,
                            chips=gpus_per_host * len(pods), rid=rid,
                            namespace=pods[0][0],
                            label=f"slice:{txn.record.txn_id}",
                            timeout_s=max(deadline - time.monotonic(),
                                          0.0),
                            gen0=gen_before)
                    except QueueFullError:
                        # the queue refused the gang: resolve the txn
                        # NOW (roll back any landed hosts) before the 429
                        # reaches the client — reserved GPUs must not
                        # outlive the refusal
                        self._abort(txn, pods, attached, failures,
                                    tenant, rid, None, None)
                        raise
                    enqueued_at = time.monotonic()
                    txn.state = "parked"
                    EVENTS.emit("gang_enqueue", rid=rid, tenant=tenant,
                                txn=txn.record.txn_id, hosts=len(pods),
                                held=len(attached), priority=priority)
                    logger.info(
                        "[rid=%s] slice %s parked as gang: %d/%d hosts "
                        "reserved", rid, txn.record.txn_id, len(attached),
                        len(pods))
                else:
                    # still contended after a wakeup: hand the baton on
                    self.broker.gang_baton(waiter)
                if attached and hold_deadline is None:
                    hold_deadline = time.monotonic() + config.gang_hold_s
                if not attached:
                    hold_deadline = None
                while True:
                    if waiter.priority == "high":
                        self.broker.try_preempt_for(waiter)
                    now = time.monotonic()
                    if now >= deadline:
                        waited = now - (enqueued_at or now)
                        REGISTRY.queue_wait.observe(waited, tenant=tenant)
                        REGISTRY.admission_decisions.inc(
                            tenant=tenant, outcome="queue_timeout")
                        EVENTS.emit("queue_timeout", rid=rid,
                                    tenant=tenant, gang=True,
                                    waited_s=round(waited, 3))
                        status, payload = self._abort(
                            txn, pods, attached, failures, tenant, rid,
                            waiter, enqueued_at, timed_out=True)
                        payload["queued_s"] = round(waited, 3)
                        payload["queue_timeout"] = True
                        payload["retry_after_s"] = round(
                            self.broker._capacity_hint(), 1)
                        return status, payload
                    if hold_deadline is not None and now >= hold_deadline:
                        # anti-deadlock hand-back: return the partial
                        # reservation so a competing gang can complete;
                        # keep waiting for our own deadline
                        self._hand_back(txn, attached, rid)
                        attached.clear()
                        hold_deadline = None
                    wait_for = deadline - now
                    if hold_deadline is not None:
                        wait_for = min(wait_for, hold_deadline - now)
                    if waiter.event.wait(max(wait_for, 0.01)):
                        waiter.event.clear()
                        if waiter.outcome == "moved":
                            # shard hand-off mid-wait: the record (and
                            # any reserved hosts) now belong to the new
                            # leader's adoption — resolve NOTHING here
                            EVENTS.emit("queue_moved", rid=rid,
                                        tenant=tenant, gang=True)
                            return 503, {
                                "result": "ShardMoved",
                                "message": "admission shard moved to "
                                           "another replica mid-gang; "
                                           "retry",
                                "retry_after_s": 1.0}
                        break           # capacity signal: retry missing
        finally:
            if waiter is not None:
                self.broker.unpark_gang(waiter)

    def _hand_back(self, txn: _LiveTxn, attached: dict, rid: str) -> None:
        pods = [tuple(key.split("/", 1)) for key in attached]
        logger.info("[rid=%s] gang hold deadline passed: handing back "
                    "%d reserved host(s)", rid, len(pods))
        clean, _ = self._rollback(pods, txn.record.txn_id, rid)
        with self._lock:
            txn.record.committed = [] if clean else list(
                txn.record.committed)
        if clean:
            self._persist_txn(txn.record)
        REGISTRY.slice_txns.inc(outcome="handback")
        EVENTS.emit("gang_handback", rid=rid, txn=txn.record.txn_id,
                    hosts=len(pods), clean=clean)
        # the freed GPUs are what some OTHER waiter is sleeping on
        self.broker.signal_capacity()
        self.broker.poke_peers()

    def _commit(self, txn: _LiveTxn, pods, attached, tenant, priority,
                rid, gpus_per_host, lease_group, waiter,
                enqueued_at) -> tuple[int, dict]:
        for result in attached.values():
            # stamp the member's node like the single-attach path does:
            # node-scoped consumers (preemption victim filtering) need it
            try:
                node = objects.node_name(self.gateway.kube.get_pod(
                    result.namespace, result.pod)) or ""
            except Exception:  # noqa: BLE001 — best-effort stamp
                node = ""
            self.broker.leases.record(
                result.namespace, result.pod, tenant, priority,
                list(result.device_ids), chips=len(result.device_ids),
                rid=rid, ttl_s=self.broker.config.lease_ttl_s,
                group=lease_group, node=node)
        if lease_group != txn.record.txn_id or txn.adopted:
            # the group may predate this process (resize delta, adopted
            # txn after failover): recover its generation from the
            # member annotations before touching the registry
            self._ensure_group_info(
                lease_group, self.broker.leases.group_leases(lease_group))
        with self._lock:
            created = lease_group not in self._groups
            group = self._groups.setdefault(
                lease_group, {"generation": 1,
                              "gpus_per_host": gpus_per_host})
            group["gpus_per_host"] = gpus_per_host
            generation = group["generation"]
        if created:
            # a brand-new slice: arm the generation-1 barrier so the
            # members' INITIAL federation rides the same protocol as
            # every later resize (membership order = the txn's pod list)
            self._arm_barrier(lease_group, pods, generation)
        self._unpersist_txn(txn.record)
        outcome = "adopted_commit" if txn.adopted else "commit"
        REGISTRY.slice_txns.inc(outcome=outcome)
        EVENTS.emit("slice_commit", rid=rid, txn=txn.record.txn_id,
                    tenant=tenant, hosts=len(pods),
                    chips=gpus_per_host * len(pods),
                    group=lease_group, adopted=txn.adopted)
        payload: dict = {
            "result": "SUCCESS",
            "rolled_back": False,
            "tenant": tenant,
            "group": lease_group,
            "pods": [attached[_pod_key(ns, pod)].to_json()
                     for ns, pod in pods],
        }
        if waiter is not None and enqueued_at is not None:
            waited = time.monotonic() - enqueued_at
            REGISTRY.queue_wait.observe(waited, tenant=tenant)
            REGISTRY.admission_decisions.inc(tenant=tenant,
                                             outcome="granted_queued")
            EVENTS.emit("queue_granted", rid=rid, tenant=tenant,
                        gang=True, waited_s=round(waited, 3))
            payload["queued_s"] = round(waited, 3)
        self.broker.signal_capacity()
        return 200, payload

    def _abort(self, txn: _LiveTxn, pods, attached, failures, tenant,
               rid, waiter, enqueued_at,
               timed_out: bool = False) -> tuple[int, dict]:
        clean, _ = self._rollback(pods, txn.record.txn_id, rid)
        if clean:
            self._unpersist_txn(txn.record)
        else:
            # an unclean rollback IS a stranded condition: keep the
            # record so the tick (or a failed-over peer) re-aborts it
            self._persist_txn(txn.record)
        outcome = "adopted_abort" if txn.adopted else "abort"
        REGISTRY.slice_txns.inc(outcome=outcome)
        EVENTS.emit("slice_abort", rid=rid, txn=txn.record.txn_id,
                    tenant=tenant, hosts=len(pods),
                    rolled_back=clean, timed_out=timed_out,
                    adopted=txn.adopted)
        if attached or any(r.result != _INSUFFICIENT for r in failures):
            self.broker.signal_capacity()
            self.broker.poke_peers()
        by_key = {_pod_key(r.namespace, r.pod): r for r in failures}
        by_key.update(attached)
        results = [by_key.get(_pod_key(ns, pod),
                              PodResult(ns, pod, _INSUFFICIENT))
                   for ns, pod in pods]
        return 503, {
            "result": "SliceAttachFailed",
            "rolled_back": clean,
            "tenant": tenant,
            "pods": [r.to_json() for r in results],
        }

    # -- failover adoption -----------------------------------------------------

    def txn_inflight(self, rid: str) -> bool:
        """True while a live slice txn carries ``rid`` or ANY adoption
        is still resolving (the defragmenter polls it before judging a
        move against a group's final membership)."""
        with self._lock:
            if self._adopting:
                return True
            return any(t.record.rid == rid for t in self._txns.values())

    def adopt(self, records) -> int:
        """Resolve slice txn records a dead (or deposed) leader left
        behind: complete the fan-out under the original rid while the
        deadline holds, roll back once it has passed. Each record runs in
        its own thread — adoption must not block the election callback."""
        adopted = 0
        for record in records:
            with self._lock:
                if record.txn_id in self._txns \
                        or record.txn_id in self._adopting:
                    continue
                self._adopting.add(record.txn_id)
            adopted += 1
            threading.Thread(
                target=self._run_adopted, args=(record,), daemon=True,
                name=f"tpumounter-slice-adopt-{record.txn_id}").start()
        return adopted

    def _run_adopted(self, record: SliceTxnRecord) -> None:
        remaining = record.deadline_unix - time.time()
        EVENTS.emit("slice_adopted", rid=record.rid, txn=record.txn_id,
                    tenant=record.tenant, hosts=len(record.pods),
                    committed=len(record.committed),
                    remaining_s=round(max(0.0, remaining), 3))
        try:
            if remaining <= 0:
                # its client's deadline passed while nobody owned the
                # shard: abort — txn-targeted detach of EVERY member is
                # exact whatever subset actually landed
                clean, _ = self._rollback(record.members(),
                                          record.txn_id, record.rid)
                if clean:
                    self._unpersist_txn(record)
                REGISTRY.slice_txns.inc(outcome="adopted_abort")
                EVENTS.emit("slice_abort", rid=record.rid,
                            txn=record.txn_id, tenant=record.tenant,
                            hosts=len(record.pods), rolled_back=clean,
                            timed_out=True, adopted=True)
                self.broker.signal_capacity()
                return
            status, payload = self.attach(
                record.members(), record.gpus_per_host,
                tenant=record.tenant, priority=record.priority,
                rid=record.rid, txn_id=record.txn_id,
                lease_group=record.group or record.txn_id,
                timeout_s=remaining, adopted=True,
                committed=record.committed)
            logger.info("[rid=%s] adopted slice txn %s resolved: %s / %s",
                        record.rid, record.txn_id, status,
                        payload.get("result", "-"))
        except Exception as e:     # noqa: BLE001 — a dead adoption
            # thread would strand the record; the tick re-adopts it
            logger.warning("[rid=%s] adopted slice txn %s failed: %s",
                           record.rid, record.txn_id, e)
        finally:
            with self._lock:
                self._adopting.discard(record.txn_id)

    # -- group detach (expiry / preemption / resize shrink) --------------------

    def _ensure_group_info(self, group: str, members) -> dict:
        """The group's registry entry, recovering the mesh generation
        from the member pods' ``tpumounter.io/mesh-generation``
        annotations when this process has none (restart/failover — the
        annotation is the persisted half of the signal; max across
        members survives a partial patch). Cached after the first
        recovery."""
        with self._lock:
            info = self._groups.get(group)
        if info is not None:
            return dict(info)
        generation = 1
        gpus = None
        for lease in members:
            gpus = gpus or lease.chips or None
            try:
                pod = self.gateway.kube.get_pod(lease.namespace,
                                                lease.pod)
            except Exception:  # noqa: BLE001 — best-effort recovery
                continue
            raw = (pod.get("metadata", {}).get("annotations") or {}).get(
                consts.MESH_GENERATION_ANNOTATION)
            try:
                generation = max(generation, int(raw))
            except (TypeError, ValueError):
                continue
        with self._lock:
            info = self._groups.setdefault(
                group, {"generation": generation, "gpus_per_host": gpus})
        return dict(info)

    def detach_members(self, pods: list[tuple[str, str]], cause: str,
                       force: bool = False,
                       rid: str | None = None
                       ) -> tuple[bool, list[PodResult]]:
        """Detach every member pod through the coordinator's normal
        per-host path (traced, breaker-guarded, journaled worker-side)
        with the cause stamped into each worker's audit trail."""
        coordinator = self._coordinator()
        return coordinator.detach(pods, force=force, request_id=rid,
                                  cause=cause)

    # -- slice self-healing (node failure domain, master/nodehealth.py) --------

    def bind_repair_candidates(self, fn) -> None:
        """``fn(namespace, count, exclude) -> [(ns, pod), ...]`` — spare
        pods (Running, labelled ``tpumounter.io/slice-spare=true``, on
        non-cordoned nodes) the repair txn may grow the gang onto."""
        self._candidates_fn = fn

    def request_repair(self, group: str, down_members:
                       list[tuple[str, str]], dead: bool,
                       reason: str) -> bool:
        """Queue a self-healing repair for ``group`` whose
        ``down_members`` sit on a dead (``dead=True``, fenced) or
        draining (``dead=False``, cleanly migrated) node. Runs on its
        own thread — the caller is the fleet tick, which must not block
        on worker RPC fan-outs. One repair per group at a time; the
        per-group budget (``slice_repair_budget``) turns a
        crash-looping node into a teardown instead of an infinite
        spare-pool grind. Returns False when a repair for the group is
        already in flight."""
        with self._lock:
            if group in self._repairing:
                return False
            self._repairing.add(group)
        thread = threading.Thread(
            target=self._run_repair, args=(group, down_members, dead,
                                           reason),
            daemon=True, name=f"tpumounter-slice-repair-{group}")
        thread.start()
        with self._lock:
            # registered AFTER start: join_repairs must never see a
            # not-yet-started thread (join would raise)
            self._repair_threads.append(thread)
            self._repair_threads = [t for t in self._repair_threads
                                    if t.is_alive() or t is thread]
        return True

    def join_repairs(self, timeout_s: float = 30.0) -> None:
        """Test helper: block until every queued repair resolved."""
        deadline = time.monotonic() + timeout_s
        with self._lock:
            threads = list(self._repair_threads)
        for thread in threads:
            thread.join(timeout=max(0.0, deadline - time.monotonic()))

    def _run_repair(self, group: str, down_members:
                    list[tuple[str, str]], dead: bool,
                    reason: str) -> None:
        try:
            self.repair_group(group, down_members, dead=dead,
                              reason=reason)
        except Exception:    # noqa: BLE001 — a dead repair thread must
            # not strand the in-flight guard (the next health tick may
            # re-request); the group stays visibly broken for doctor
            logger.exception("slice repair of group %s failed", group)
            REGISTRY.slice_repairs.inc(outcome="failed")
            EVENTS.emit("slice_repair", group=group, outcome="failed",
                        reason=reason, dead=dead)
        finally:
            with self._lock:
                self._repairing.discard(group)

    def repair_group(self, group: str, down_members:
                     list[tuple[str, str]], dead: bool = True,
                     reason: str = "node-dead",
                     rid: str | None = None) -> dict:
        """Repair the gang, don't restart the job: replace the down
        members with spare hosts UNDER THE SAME group lease, as one
        repair transaction riding the crash-safe slice-txn machinery —
        the mesh generation bumps exactly once, on full actuation, so
        the elastic job (torchcheck/elastic.py) drains → re-forms instead
        of dying. Dead members are fenced through the broker's one-way
        eviction seam; draining members are detached cleanly (their
        worker still answers — proactive migration). With no spare
        capacity (or the repair budget exhausted) the group is torn
        down AS A UNIT — never left half-alive."""
        rid = rid or ("repair-" + uuid_mod.uuid4().hex[:8])
        down = set(down_members)
        members = self.broker.leases.group_leases(group)
        if not members:
            return {"outcome": "gone", "group": group}
        info = self._ensure_group_info(group, members)
        gpus = int(info.get("gpus_per_host") or members[0].chips or 1)
        tenant = members[0].tenant
        priority = members[0].priority
        down_leases = [m for m in members if (m.namespace, m.pod) in down]
        survivors = [(m.namespace, m.pod) for m in members
                     if (m.namespace, m.pod) not in down]
        if not dead:
            # proactive migration off a still-answering node: grow-
            # first (the group never drops below strength), NO budget
            # and NO teardown — routine maintenance draining every
            # member host in sequence must never destroy a healthy gang
            return self._migrate(group, down_leases, survivors, gpus,
                                 tenant, priority, reason, rid)
        # DEAD-node repair consumes the per-group budget (a crash-
        # looping node must not grind the spare pool); the window
        # resets after a quiet period so a long-lived gang is not
        # punished for surviving unrelated deaths weeks apart
        now = time.monotonic()
        with self._lock:
            spent, window_start = self._repair_counts.get(group,
                                                          (0, now))
            if now - window_start > REPAIR_BUDGET_WINDOW_S:
                spent, window_start = 0, now      # quiet period passed
            self._repair_counts[group] = (spent + 1, window_start)
        budget = self.broker.config.slice_repair_budget
        # 1. fence the dead members (no worker to dial; cluster-side
        # revocation + zombie-rejoin convergence) — also frees their
        # quota for the grow txn below
        for lease in down_leases:
            self.broker.fence_lease(lease,
                                    reason=f"slice-repair:{reason}")
        # 2. over budget → teardown
        if spent >= budget:
            return self._teardown_group(
                group, survivors, rid,
                cause=f"slice-repair-budget:{reason}", reason=reason)
        # 3. pick spares on healthy nodes
        spares = self._pick_spares(group, members, len(down_leases))
        if len(spares) < len(down_leases):
            # no capacity to re-form the gang: tear it down as a unit —
            # n-1 hosts hold GPUs a broken world can't use
            return self._teardown_group(
                group, survivors, rid,
                cause=f"slice-repair-nocapacity:{reason}", reason=reason)
        # 4. the repair transaction: grow delta onto the spares, joining
        # the SAME group — crash-safe (intent record + commit markers),
        # adopted by a surviving leader like any slice txn
        status, payload = self.attach(
            spares, gpus, tenant=tenant, priority=priority, rid=rid,
            lease_group=group)
        if status != 200:
            # the grow txn rolled itself back; the gang cannot re-form —
            # teardown, never half-alive
            logger.warning("slice repair of group %s could not grow "
                           "onto %s (%s); tearing the group down",
                           group, spares, payload.get("result"))
            return self._teardown_group(
                group, survivors, rid,
                cause=f"slice-repair-failed:{reason}", reason=reason)
        target = survivors + list(spares)
        generation = self._bump_generation(group, target, gpus, rid)
        REGISTRY.slice_repairs.inc(outcome="repaired")
        EVENTS.emit("slice_repair", rid=rid, group=group,
                    outcome="repaired", reason=reason, dead=True,
                    replaced=len(down_leases), hosts=len(target),
                    generation=generation)
        logger.info("[rid=%s] slice group %s repaired: %d member(s) "
                    "replaced by %s, generation -> %d", rid, group,
                    len(down_leases), spares, generation)
        return {"outcome": "repaired", "group": group,
                "generation": generation, "added": list(spares)}

    def _pick_spares(self, group: str, members,
                     count: int) -> list[tuple[str, str]]:
        if self._candidates_fn is None or count <= 0:
            return []
        exclude = {(m.namespace, m.pod) for m in members}
        try:
            return list(self._candidates_fn(members[0].namespace, count,
                                            exclude))
        except Exception:    # noqa: BLE001 — discovery trouble reads
            logger.exception(   # as no capacity, judged by the caller
                "spare discovery for group %s failed", group)
            return []

    def _migrate(self, group: str, down_leases, survivors, gpus: int,
                 tenant: str, priority: str, reason: str,
                 rid: str) -> dict:
        """Proactive migration (draining node / termination taint):
        GROW-first so the group never drops below strength, then a
        clean (force=False) detach of the leaving members. Every
        obstacle — no spare, grow rolled back, member busy — DEFERS:
        the node still answers and the gang still works, so doing
        nothing is strictly better than tearing anything down (if the
        node later actually dies, the dead path takes over)."""
        def defer(why: str) -> dict:
            REGISTRY.slice_repairs.inc(outcome="failed")
            EVENTS.emit("slice_repair", rid=rid, group=group,
                        outcome="failed", reason=reason, dead=False,
                        deferred=True, why=why)
            logger.info("[rid=%s] migration of group %s deferred: %s",
                        rid, group, why)
            return {"outcome": "deferred", "group": group, "why": why}

        members = self.broker.leases.group_leases(group)
        spares = self._pick_spares(group, members, len(down_leases))
        if len(spares) < len(down_leases):
            return defer("no spare capacity")
        try:
            status, payload = self.attach(
                spares, gpus, tenant=tenant, priority=priority, rid=rid,
                lease_group=group)
        except (QuotaExceededError, QueueFullError, TopologyError) as e:
            # grow-first temporarily needs +spare GPUs of quota
            # headroom; a capped tenant defers (the dead path, which
            # fences first, does not pay this)
            return defer(f"grow refused: {e.__class__.__name__}")
        if status != 200:
            return defer(f"grow refused: {payload.get('result')}")
        pods = [(m.namespace, m.pod) for m in down_leases]
        ok, results = self.detach_members(
            pods, cause=f"slice-migrate:{rid}", force=False, rid=rid)
        for result in results:
            if result.result in ROLLBACK_CLEAN:
                self.broker.release(result.namespace, result.pod)
        # membership = whatever the lease table now holds (spares in;
        # leavers out unless their devices were busy — those stay until
        # the drain finishes them or the dead path fences them)
        target = [(m.namespace, m.pod)
                  for m in self.broker.leases.group_leases(group)]
        generation = self._bump_generation(group, target, gpus, rid)
        REGISTRY.slice_repairs.inc(outcome="migrated")
        EVENTS.emit("slice_repair", rid=rid, group=group,
                    outcome="migrated", reason=reason, dead=False,
                    replaced=len(down_leases), hosts=len(target),
                    generation=generation, shrink_deferred=not ok)
        logger.info("[rid=%s] slice group %s migrated onto %s, "
                    "generation -> %d%s", rid, group, spares, generation,
                    "" if ok else " (shrink deferred: busy member)")
        return {"outcome": "migrated", "group": group,
                "generation": generation, "added": list(spares),
                "shrink_deferred": not ok}

    # -- fleet defragmentation (master/defrag.py is the planner) ---------------

    def migrate_member(self, group: str, member: tuple[str, str],
                       rid: str) -> dict:
        """The defragmenter's ONE entry into actuation
        (tests/test_torch_defrag_lint.py pins that every move crosses
        here): relocate a single idle member onto a spare host as a
        grow-first migration riding the repair machinery — the same
        crash-safe slice txn, the same defer-never-degrade semantics, and
        the same per-group exclusivity guard as ``repair_group`` (a repair
        in flight wins; defrag yields and re-plans later)."""
        member = tuple(member)
        with self._lock:
            if group in self._repairing:
                return {"outcome": "deferred", "group": group,
                        "why": "repair in flight"}
            self._repairing.add(group)
        try:
            members = self.broker.leases.group_leases(group)
            moving = [m for m in members
                      if (m.namespace, m.pod) == member]
            if not moving:
                return {"outcome": "gone", "group": group}
            survivors = [(m.namespace, m.pod) for m in members
                         if (m.namespace, m.pod) != member]
            info = self._ensure_group_info(group, members)
            gpus = int(info.get("gpus_per_host")
                       or members[0].chips or 1)
            return self._migrate(group, moving, survivors, gpus,
                                 members[0].tenant,
                                 members[0].priority, "defrag", rid)
        finally:
            with self._lock:
                self._repairing.discard(group)

    def finish_member_detach(self, group: str, member: tuple[str, str],
                             rid: str) -> bool:
        """Complete an ADOPTED defrag move whose grow already landed: a
        clean detach of the superseded member plus the generation bump
        — the tail ``_migrate`` would have run had its master survived.
        Returns False when the member could not leave yet (busy device,
        or a repair holds the group); the group stays at full strength
        either way and a later tick re-judges it."""
        member = tuple(member)
        with self._lock:
            if group in self._repairing:
                return False
            self._repairing.add(group)
        try:
            members = self.broker.leases.group_leases(group)
            if member not in [(m.namespace, m.pod) for m in members]:
                return True     # already gone — nothing left to finish
            info = self._ensure_group_info(group, members)
            gpus = int(info.get("gpus_per_host")
                       or members[0].chips or 1)
            ok, results = self.detach_members(
                [member], cause=f"defrag-adopt:{rid}", force=False,
                rid=rid)
            for result in results:
                if result.result in ROLLBACK_CLEAN:
                    self.broker.release(result.namespace, result.pod)
            target = [(m.namespace, m.pod)
                      for m in self.broker.leases.group_leases(group)]
            self._bump_generation(group, target, gpus, rid)
            return ok
        finally:
            with self._lock:
                self._repairing.discard(group)

    def _teardown_group(self, group: str, survivors:
                        list[tuple[str, str]], rid: str, cause: str,
                        reason: str) -> dict:
        """Tear the group down as a unit: surviving members detach
        through the normal worker path; any lease left behind (its
        worker died mid-teardown) is fenced — the group must not
        outlive the decision half-alive."""
        if survivors:
            _, results = self.detach_members(survivors, cause=cause,
                                             force=True, rid=rid)
            for result in results:
                if result.result in ROLLBACK_CLEAN:
                    self.broker.release(result.namespace, result.pod)
        for lease in self.broker.leases.group_leases(group):
            self.broker.fence_lease(lease, reason="slice-teardown")
        self._drop_barrier(group, reason="torn-down")
        with self._lock:
            self._repair_counts.pop(group, None)
        REGISTRY.slice_repairs.inc(outcome="torn_down")
        EVENTS.emit("slice_repair", rid=rid, group=group,
                    outcome="torn_down", reason=reason,
                    hosts=len(survivors))
        logger.warning("[rid=%s] slice group %s torn down as a unit "
                       "(%s): %d surviving member(s) detached", rid,
                       group, cause, len(survivors))
        self.broker.signal_capacity()
        self.broker.poke_peers()
        return {"outcome": "torn_down", "group": group}

    # -- re-federation barrier (torchcheck/federation.py is the member side) ---

    def _barrier_transition(self, transition: str, group: str,
                            generation: int, **fields) -> None:
        """THE barrier observability seam (lint-pinned): every barrier
        state change crosses here, emitting its paired metric + event."""
        REGISTRY.slice_barriers.inc(transition=transition)
        EVENTS.emit("slice_barrier", transition=transition, group=group,
                    generation=generation, **fields)

    def _persist_barrier(self, barrier: _Barrier) -> None:
        store = self.broker.store
        if store is None:
            return
        try:
            store.put_barrier(SliceBarrierRecord(
                group=barrier.group, generation=barrier.generation,
                members=list(barrier.members),
                created_unix=round(barrier.armed_unix, 3),
                plan=dict(barrier.plan or {}),
                completed_unix=(round(barrier.completed_unix, 3)
                                if barrier.completed_unix else 0.0)))
        except StoreFencedError as e:
            self.broker._on_fenced(e)

    def _unpersist_barrier(self, group: str, namespace: str) -> None:
        store = self.broker.store
        if store is None or not namespace:
            return
        try:
            store.delete_barrier(namespace, group)
        except StoreFencedError as e:
            self.broker._on_fenced(e)

    def _arm_barrier(self, group: str, members, generation: int,
                     rearmed: bool = False) -> None:
        """Open (or replace) the group's barrier for ``generation``.
        ``members`` is the ORDERED new membership — [(ns, pod), ...] or
        "ns/pod" keys; the order becomes the federation plan's process
        ids. An incomplete older barrier is superseded — exactly how a
        dead member's stuck barrier resolves once the control plane
        moves the generation again."""
        keys = [m if isinstance(m, str) else _pod_key(*m)
                for m in members]
        barrier = _Barrier(group, generation, keys)
        with self._lock:
            old = self._barriers.get(group)
            if old is not None and old.generation > barrier.generation:
                # generations are monotone: never let a stale arm (an
                # adopted record racing a concurrent resize's bump)
                # regress the barrier — members joining the newer
                # generation would be refused indefinitely
                return
            self._barriers[group] = barrier
        if old is not None and old.completed_unix is None \
                and old.generation != barrier.generation:
            self._barrier_transition(
                "superseded", group, old.generation,
                superseded_by=barrier.generation,
                joined=len(old.joined), expected=len(old.members))
        self._barrier_transition(
            "rearmed" if rearmed else "armed", group,
            barrier.generation, expected=len(keys))
        if not rearmed:
            # a re-arm came FROM the store record; re-putting it would
            # spend a CAS to write what is already there
            self._persist_barrier(barrier)
        self.export_gauges()

    def _drop_barrier(self, group: str, reason: str) -> None:
        """Retire a group's barrier (full detach): the group is gone, so
        nobody can ever complete it."""
        with self._lock:
            barrier = self._barriers.pop(group, None)
        if barrier is None:
            return
        if barrier.completed_unix is None:
            self._barrier_transition(
                "superseded", group, barrier.generation, reason=reason,
                joined=len(barrier.joined),
                expected=len(barrier.members))
        namespace = barrier.members[0].split("/", 1)[0] \
            if barrier.members else ""
        self._unpersist_barrier(group, namespace)

    def adopt_barriers(self, records) -> int:
        """Re-arm barriers a dead (or deposed) leader persisted. An
        INCOMPLETE barrier re-arms with the joined set empty — members
        re-join idempotently, which is cheap next to a lost barrier
        (members would wait forever on a coordinator that no longer
        answers). A COMPLETED record restores its frozen plan verbatim:
        members still polling (or blocked in initialization waiting on
        one that is) must receive the same plan, never a fresh barrier
        nobody can complete."""
        adopted = 0
        for record in records:
            with self._lock:
                current = self._barriers.get(record.group)
                if current is not None \
                        and current.generation >= record.generation:
                    continue
            self._arm_barrier(record.group, list(record.members),
                              int(record.generation), rearmed=True)
            if record.completed_unix and record.plan:
                with self._lock:
                    barrier = self._barriers.get(record.group)
                    if barrier is not None and \
                            barrier.generation == record.generation:
                        barrier.joined = {m: "" for m in
                                          barrier.members}
                        barrier.plan = dict(record.plan)
                        barrier.completed_unix = record.completed_unix
            adopted += 1
        return adopted

    def barrier_join(self, group: str, generation: int, member: str,
                     address: str = "") -> tuple[int, dict]:
        """A member announces it has drained, torn down its old backend,
        and stands ready to federate at ``generation``. Stale (or
        future) generations and non-members are REFUSED — a stale
        process must never corrupt the new world. The join completing
        the barrier computes the federation plan every poller receives:
        ordered membership (= process ids), world size, coordinator =
        member 0's proposed address."""
        generation = int(generation)
        with self._lock:
            barrier = self._barriers.get(group)
        if barrier is None:
            # group alive but no armed barrier (master restarted with no
            # store, or the group predates the protocol): lazily re-arm
            # at the group's CURRENT generation from the lease table —
            # the control plane stays the source of truth
            members = self.broker.leases.group_leases(group)
            if not members:
                return 404, {"result": "SliceNotFound", "group": group}
            info = self._ensure_group_info(group, members)
            self._arm_barrier(
                group,
                sorted(_pod_key(m.namespace, m.pod) for m in members),
                int(info.get("generation", 1)), rearmed=True)
        # validation AND mutation under ONE lock acquisition, against a
        # RE-FETCHED barrier: a generation bump may have swapped the map
        # entry since the read above — mutating the superseded object
        # would hand this member a stale federation plan
        completed = False
        with self._lock:
            barrier = self._barriers.get(group)
            if barrier is None:
                refusal = ("gone", None)
            elif generation != barrier.generation:
                refusal = ("generation", barrier.generation)
            elif member not in barrier.members:
                refusal = ("member", barrier.generation)
            else:
                refusal = None
                if barrier.completed_unix is None:
                    barrier.joined[member] = address or ""
                    if len(barrier.joined) == len(barrier.members):
                        barrier.completed_unix = time.time()
                        barrier.plan = {
                            "coordinator":
                                barrier.joined[barrier.members[0]],
                            "num_processes": len(barrier.members),
                            "members": list(barrier.members),
                        }
                        completed = True
                joined = len(barrier.joined)
                expected = len(barrier.members)
                armed_unix = barrier.armed_unix
        if refusal is not None and refusal[0] == "gone":
            return 404, {"result": "SliceNotFound", "group": group}
        if refusal is not None and refusal[0] == "generation":
            current = refusal[1]
            stale = generation < current
            self._barrier_transition(
                "refused", group, generation, member=member,
                reason="stale-generation" if stale
                else "unknown-generation", current=current)
            return 409, {
                "result": "StaleGeneration" if stale
                          else "UnknownGeneration",
                "current": current,
                "message": f"barrier is at generation "
                           f"{current}, not {generation}"
                           + (" — drain and rejoin at the current "
                              "generation" if stale else "")}
        if refusal is not None:
            self._barrier_transition(
                "refused", group, generation, member=member,
                reason="not-a-member")
            return 403, {"result": "NotAMember",
                         "generation": refusal[1],
                         "members": list(barrier.members),
                         "message": f"{member} is not in generation "
                                    f"{generation}'s membership"}
        self._barrier_transition(
            "join", group, generation, member=member,
            joined=joined, expected=expected)
        if completed:
            self._barrier_transition(
                "complete", group, generation,
                waited_s=round(time.time() - armed_unix, 3))
            self._persist_barrier(barrier)
            self.export_gauges()
        return 200, self._barrier_payload(barrier)

    def barrier_status(self, group: str) -> tuple[int, dict]:
        with self._lock:
            barrier = self._barriers.get(group)
        if barrier is None:
            return 404, {"result": "BarrierNotFound", "group": group}
        return 200, self._barrier_payload(barrier)

    def _barrier_payload(self, barrier: _Barrier) -> dict:
        with self._lock:
            # field snapshot under the lock: a concurrent join mutates
            # the joined dict — iterating it unlocked can crash a
            # /slicez scrape mid-resize
            members = list(barrier.members)
            joined = dict(barrier.joined)
            completed_unix = barrier.completed_unix
            plan = dict(barrier.plan or {})
            generation = barrier.generation
            armed_unix = barrier.armed_unix
        age = time.time() - armed_unix
        payload = {
            "group": barrier.group,
            "generation": generation,
            "expected": len(members),
            "members": members,
            "joined": sorted(joined),
            "complete": completed_unix is not None,
            "age_s": round(age, 3),
        }
        if completed_unix is None:
            payload["missing"] = [m for m in members
                                  if m not in joined]
            payload["stuck"] = bool(
                age > self.broker.config.resize_barrier_timeout_s)
        else:
            payload["plan"] = plan
        return payload

    # -- live mesh reshaping (POST /slice/resize) ------------------------------

    def resize(self, target: list[tuple[str, str]],
               gpus_per_host: int | None, *,
               rid: str, tenant: str | None = None,
               priority: str | None = None, group: str | None = None,
               strict: bool = False,
               force: bool = False) -> tuple[int, dict]:
        """Reshape a live slice to exactly ``target`` membership: attach
        the delta hosts as a slice txn joining the existing group, detach
        the removed hosts through the normal path, and bump the mesh
        generation only when the new device set is fully actuated. The
        group is found from any target pod's lease (or named
        explicitly)."""
        t0 = time.monotonic()
        groups = self.broker.leases.groups()
        if group is None:
            hit = {lease.group
                   for members in groups.values() for lease in members
                   if (lease.namespace, lease.pod) in target}
            if len(hit) > 1:
                return 400, {
                    "result": "BadRequest",
                    "message": f"target pods span {len(hit)} slice "
                               f"groups {sorted(hit)}: resize one slice "
                               "at a time (or name ?group= explicitly)"}
            group = next(iter(hit), None)
        members = groups.get(group or "", [])
        if not group or not members:
            return 404, {
                "result": "SliceNotFound",
                "message": "no slice-group lease covers the target pods "
                           "— attach the slice first (/addgpuslice)"}
        current = [(lease.namespace, lease.pod) for lease in members]
        tenant = tenant or members[0].tenant
        priority = priority or members[0].priority
        info = self._ensure_group_info(group, members)
        if gpus_per_host is None:
            # inherit the group's recorded per-host size; a re-derived
            # group (master restart) falls back to a member's GPU count
            gpus_per_host = (info.get("gpus_per_host")
                             or members[0].chips or 4)
        delta_add = [p for p in target if p not in current]
        delta_remove = [p for p in current if p not in target]
        if not delta_add and not delta_remove:
            # idempotent re-post of the current membership: nothing to
            # actuate, and the generation must NOT move — a bump would
            # send every elastic job through a drain/restore for nothing
            return 200, {
                "result": "SUCCESS", "group": group,
                "generation": info["generation"], "tenant": tenant,
                "hosts": len(target), "added": [], "removed": [],
                "unchanged": True}
        if strict:
            # strict judges the RESULTING membership, not the grow delta
            self._coordinator().validate_slice_topology(
                target, gpus_per_host, strict=True)
        added: list[PodResult] = []
        if delta_add:
            status, payload = self.attach(
                delta_add, gpus_per_host, tenant=tenant,
                priority=priority, rid=rid, lease_group=group)
            if status != 200:
                # the delta txn rolled itself back: the slice is exactly
                # what it was, and the generation does not move
                payload.setdefault("result", "SliceResizeFailed")
                payload["group"] = group
                return status, payload
            added = payload.get("pods", [])
        removed: list[dict] = []
        if delta_remove:
            ok, results = self.detach_members(
                delta_remove, cause=f"slice-resize:{rid}", force=force,
                rid=rid)
            for result in results:
                if result.result in ROLLBACK_CLEAN:
                    self.broker.release(result.namespace, result.pod)
            removed = [r.to_json() for r in results]
            if not ok:
                # shrink half incomplete (busy devices): the old GPUs
                # are still actuated, so the NEW set is not — the
                # generation must not claim it is
                return 409, {
                    "result": "SliceResizeIncomplete",
                    "message": "some hosts refused detach (busy "
                               "devices?); resize again or force",
                    "group": group,
                    "added": added, "removed": removed}
        generation = self._bump_generation(group, target, gpus_per_host,
                                           rid)
        REGISTRY.slice_resize.observe(time.monotonic() - t0,
                                      exemplar={"rid": rid})
        EVENTS.emit("slice_resize", rid=rid, group=group, tenant=tenant,
                    hosts=len(target), added=len(delta_add),
                    removed=len(delta_remove), generation=generation)
        return 200, {
            "result": "SUCCESS",
            "group": group,
            "generation": generation,
            "tenant": tenant,
            "hosts": len(target),
            "added": added,
            "removed": removed,
        }

    def _bump_generation(self, group: str, members, gpus_per_host: int,
                         rid: str) -> int:
        with self._lock:
            info = self._groups.setdefault(
                group, {"generation": 1, "gpus_per_host": gpus_per_host})
            info["generation"] += 1
            info["gpus_per_host"] = gpus_per_host
            generation = info["generation"]
        # arm the re-federation barrier BEFORE the generation becomes
        # visible anywhere (annotations, /slicez): a member that reads
        # the new generation must find a barrier to join
        self._arm_barrier(group, members, generation)
        # the informer-path signal: every member pod's annotation moves
        # only AFTER the new device set is fully actuated
        for namespace, pod in members:
            try:
                self.gateway.kube.patch_pod(
                    namespace, pod,
                    {"metadata": {"annotations": {
                        consts.MESH_GENERATION_ANNOTATION:
                            str(generation)}}})
            except Exception as e:  # noqa: BLE001 — best-effort: /slicez
                # still serves the generation
                logger.warning("[rid=%s] mesh-generation annotation on "
                               "%s/%s failed: %s", rid, namespace, pod, e)
        return generation

    def generation(self, group: str) -> int:
        with self._lock:
            return (self._groups.get(group) or {}).get("generation", 1)

    # -- maintenance (driven by the broker tick) -------------------------------

    def tick(self) -> None:
        """Adopt any stranded record the store's cached view shows that
        nothing on this replica is driving (a deferred adoption, an
        unclean abort), then refresh the gauges."""
        store = self.broker.store
        if store is not None:
            for shard in self._store_shards(store):
                records = self._cached_records(store, shard)
                stale = [r for r in records if not self._driving(r.txn_id)]
                if stale:
                    self.adopt(stale)
        self.export_gauges()

    def _store_shards(self, store):
        election = self.broker.election
        return (election.owned() if election is not None
                else range(store.ring.shards))

    def _driving(self, txn_id: str) -> bool:
        with self._lock:
            return txn_id in self._txns or txn_id in self._adopting

    @staticmethod
    def _cached_records(store, shard) -> list[SliceTxnRecord]:
        """Slice txn records from the store's OBSERVED annotations —
        zero apiserver calls; the cache is refreshed by every CAS and by
        the poke check, which is exactly the cadence stranded-record
        detection needs."""
        lock = getattr(store, "_lock", None)
        cache = getattr(store, "_observed", None)
        if lock is None or cache is None:
            return []           # store test doubles carry no cache
        with lock:
            observed = cache.get(shard)
        if observed is None:
            return []
        _, annotations = observed
        out = []
        for key, value in annotations.items():
            if not key.startswith(consts.STORE_SLICE_ANNOTATION_PREFIX):
                continue
            try:
                out.append(SliceTxnRecord.from_json(value))
            except (ValueError, TypeError):
                continue            # torn: rehydrate counts these
        return out

    def export_gauges(self) -> None:
        now = time.monotonic()
        wall = time.time()
        # prune generation entries for groups with no leases AND no
        # in-flight txn — membership lives in the lease table, so a
        # fully detached slice must not pin its registry entry forever
        live = set(self.broker.leases.groups())
        with self._lock:
            in_flight = {txn.record.group or txn.record.txn_id
                         for txn in self._txns.values()}
            gone = [group for group in self._groups
                    if group not in live and group not in in_flight]
            for group in gone:
                del self._groups[group]
            pending = len(self._txns)
            oldest = min((txn.started for txn in self._txns.values()),
                         default=None)
            orphaned = [group for group in self._barriers
                        if group not in live and group not in in_flight]
        # a fully-detached group's barrier can never complete — retire it.
        # Swept from the BARRIER map, not just pruned _groups entries: an
        # adopted barrier whose group was torn down before the failover
        # has no registry entry at all, and must not page the stuck alert
        # (or re-adopt its store record) forever
        for group in orphaned:
            self._drop_barrier(group, reason="group-gone")
        with self._lock:
            incomplete = sum(
                1 for barrier in self._barriers.values()
                if barrier.completed_unix is None)
        REGISTRY.slice_barriers_incomplete.set(incomplete)
        REGISTRY.slice_txns_pending.set(pending)
        REGISTRY.slice_txn_oldest_age.set(
            0.0 if oldest is None else round(now - oldest, 3))
        # stranded = persisted records past their deadline that NOTHING
        # drives (no live txn, no adoption thread)
        stranded = 0
        store = self.broker.store
        if store is not None:
            for shard in self._store_shards(store):
                for record in self._cached_records(store, shard):
                    if record.deadline_unix and \
                            wall > record.deadline_unix \
                            and not self._driving(record.txn_id):
                        stranded += 1
        REGISTRY.slice_txns_stranded.set(stranded)

    # -- introspection (/slicez) -----------------------------------------------

    def snapshot(self) -> dict:
        now = time.monotonic()
        groups_out: dict[str, dict] = {}
        stuck_barriers = 0
        for group, members in sorted(self.broker.leases.groups().items()):
            # recovering lookup: after a restart/failover the generation
            # comes back from the member annotations (cached after the first
            # call, so steady-state snapshots stay GET-free)
            info = self._ensure_group_info(group, members)
            groups_out[group] = {
                "tenant": members[0].tenant,
                "generation": info.get("generation", 1),
                "gpus_per_host": info.get("gpus_per_host"),
                "chips": sum(lease.chips for lease in members),
                "members": [{
                    "namespace": lease.namespace, "pod": lease.pod,
                    "chips": lease.chips, "node": lease.node,
                    "expires_in_s": (None if (r := lease.expires_in_s())
                                     is None else round(r, 1)),
                } for lease in members],
            }
            with self._lock:
                barrier = self._barriers.get(group)
            if barrier is not None and barrier.completed_unix is None:
                # only WAITING barriers render (a completed barrier is
                # history) — the stuck flag and missing member names are
                # what operators read
                payload = self._barrier_payload(barrier)
                groups_out[group]["barrier"] = payload
                if payload.get("stuck"):
                    stuck_barriers += 1
        with self._lock:
            txns = [{
                "txn_id": txn.record.txn_id, "rid": txn.record.rid,
                "tenant": txn.record.tenant,
                "pods": list(txn.record.pods),
                "committed": list(txn.record.committed),
                "state": txn.state,
                "adopted": txn.adopted,
                "age_s": round(now - txn.started, 3),
            } for txn in self._txns.values()]
        return {
            "groups": groups_out,
            "txns": {
                "pending": len(txns),
                "in_flight": sorted(txns, key=lambda t: -t["age_s"]),
                "stranded": int(REGISTRY.slice_txns_stranded.value()),
            },
            "gang_queue_depth": int(REGISTRY.gang_queue_depth.value()),
            "stuck_barriers": stuck_barriers,
        }
