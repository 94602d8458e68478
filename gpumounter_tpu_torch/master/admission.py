"""Attach broker: tenant quota admission + contention queue + preemption.

The reference treated ``/addgpu`` as an
unmanaged imperative RPC: first caller wins the chips, forever. Under
many contending tenants that is exactly wrong — FlexNPU (PAPERS.md) shows
dynamic accelerator co-location hinges on an admission/arbitration layer
ABOVE raw device attach, and the Kubernetes Network Driver Model argues
for declarative lifecycles over fire-and-forget mutations. This module is
that layer, master-side, in front of the existing worker path:

1. **Admission** — every attach names a tenant (``X-Tpu-Tenant`` header /
   ``?tenant=`` param, defaulting to the pod's namespace) and is checked
   against per-tenant chip quotas (``TPU_QUOTAS="teamA:16,teamB:8,*:4"``)
   computed from LIVE attachment state (the lease table), never request
   history. Over the admission cap (``quota * TPU_QUOTA_BURST``) the
   request is rejected 429 + Retry-After. Burst > 1 makes quotas
   work-conserving: idle chips may be borrowed, and usage above the bare
   quota is the preemptible band.
2. **Scheduling** — when chips are exhausted (the worker answered
   InsufficientGPU), requests park in a bounded per-priority FIFO
   (``?priority=low|normal|high``) and are woken in priority-then-
   weighted-fair order (within a priority, the tenant with the smallest
   quota-share of live usage goes first) as capacity frees. A ``high``
   waiter may **preempt** the lowest-priority live attachment of an
   over-quota tenant — a traced, journaled RemoveGPU through the
   existing worker path, so every rollback/chaos invariant keeps holding.
3. **Leases** — successful attaches are recorded in the
   :class:`~gpumounter_tpu_torch.master.lease.LeaseTable`; with
   ``TPU_LEASE_TTL_S`` set the broker's tick loop auto-detaches expired
   attachments (renewable via ``POST /renew``), draining chips back to
   the warm pool instead of leaking them to dead experiments.

State discipline: broker state is re-derived from cluster ground truth
(slave-pod owner labels) lazily after every master (re)start — the same
rule the worker reconciler and the attach journal follow — so a restart
can never double-actuate. Introspection: ``GET /brokerz``; exported
families: ``admission_decisions_total{tenant,outcome}``,
``queue_depth{priority}``, ``queue_wait_seconds``, ``preemptions_total``,
``lease_expirations_total``, ``active_leases{tenant}`` and the
``tenant_chips_in_use``/``tenant_quota_chips`` pair.

4. **Slices** — a whole-slice attach (``master/slicetxn.py``) parks as
   a node-less **gang waiter** on the same queue; a slice group's leases
   renew, expire and are preempted as one.

5. **HA** — with the HA plane bound (``bind_ha``: the intent store,
   the shard ring and this replica's election view) every lease and
   parked waiter is persisted, admission follows shard ownership, a
   fenced write demotes the shard, and an acquired shard's persisted
   intent is rehydrated: leases merged, waiters adopted and re-run under
   their original request ids.

6. **Node failure domain** — with the master's node-health tracker bound
   (``bind_node_health``) a lease whose node is judged dead is fenced
   (``fence_lease``: its slave pods are deleted cluster-side, no worker
   detach), slice groups with members there go to self-healing
   (``request_repair``), the tick re-notifies dead nodes that still
   anchor leases, and the reaper fences an expired lease on a dead node
   instead of retrying its worker forever.

7. **Defragmentation** — with the fleet defragmenter bound
   (``bind_defrag``), shard rehydration hands it the dead leader's
   journaled defrag moves to adopt or abort.

This is the port of :mod:`gpumounter_tpu.master.admission`.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
import time

from gpumounter_tpu_torch.k8s import objects
from gpumounter_tpu_torch.master.lease import Lease, LeaseTable
from gpumounter_tpu_torch.master.waiterindex import WaiterQueue, _rank
from gpumounter_tpu_torch.utils import consts
from gpumounter_tpu_torch.utils.errors import (K8sApiError, QueueFullError,
                                               QuotaExceededError,
                                               StoreFencedError)
from gpumounter_tpu_torch.utils.events import EVENTS
from gpumounter_tpu_torch.utils.flight import RECORDER
from gpumounter_tpu_torch.utils.log import get_logger
from gpumounter_tpu_torch.utils.metrics import REGISTRY
from gpumounter_tpu_torch.utils.trace import span

logger = get_logger("master.admission")

# Detach results that mean "the attachment is gone" — whether this call
# removed it or someone (owner detach, reconciler) beat us to it. The
# distinction matters for counters, not for lease bookkeeping.
_DETACH_GONE = ("SUCCESS", "GPU_NOT_FOUND", "POD_NOT_FOUND")


@dataclasses.dataclass
class BrokerConfig:
    """Broker knobs; defaults preserve the historical behavior exactly
    (no quotas, no queueing, leases never expire)."""

    quotas: dict[str, int] = dataclasses.field(default_factory=dict)
    quota_burst: float = 1.0
    lease_ttl_s: float = 0.0
    queue_timeout_s: float = 0.0
    queue_depth: int = 64
    # Gang (whole-slice) waiters: how long partially reserved hosts may
    # be held before hand-back (master/slicetxn.py anti-deadlock).
    gang_hold_s: float = consts.DEFAULT_GANG_HOLD_S
    # Idle-lease threshold: zero observed duty for this long marks the
    # lease idle (event + doctor WARN + preferred preemption victim).
    # Only acts while worker utilization telemetry is flowing
    # (bind_utilization + TPU_USAGE on), so the default is inert
    # without the sampler.
    idle_lease_s: float = consts.DEFAULT_IDLE_LEASE_S
    # Slice self-healing budget (master/slicetxn.py repair_group):
    # repair txns one group may consume before teardown-as-a-unit.
    slice_repair_budget: int = consts.DEFAULT_SLICE_REPAIR_BUDGET
    # Re-federation barrier (master/slicetxn.py): a barrier incomplete
    # past this window is STUCK — surfaced in /slicez with the missing
    # member names.
    resize_barrier_timeout_s: float = \
        consts.DEFAULT_RESIZE_BARRIER_TIMEOUT_S
    # Indexed waiter wakeup (master/waiterindex.py): capacity signals
    # examine only candidates the freed capacity could satisfy instead
    # of rescanning the whole queue. Selection order is pinned
    # equivalent; False (TPU_WAITER_INDEX=0) reverts to the linear scan.
    waiter_index: bool = True
    tick_interval_s: float = 1.0
    pool_namespace: str = consts.DEFAULT_POOL_NAMESPACE
    resource_name: str = consts.GPU_RESOURCE_NAME

    @classmethod
    def from_settings(cls, settings) -> "BrokerConfig":
        return cls(quotas=dict(settings.tenant_quotas),
                   quota_burst=settings.quota_burst,
                   lease_ttl_s=settings.lease_ttl_s,
                   queue_timeout_s=settings.queue_timeout_s,
                   queue_depth=settings.queue_depth,
                   gang_hold_s=settings.gang_hold_s,
                   idle_lease_s=settings.idle_lease_s,
                   slice_repair_budget=settings.slice_repair_budget,
                   resize_barrier_timeout_s=(
                       settings.resize_barrier_timeout_s),
                   waiter_index=settings.waiter_index,
                   pool_namespace=settings.pool_namespace,
                   resource_name=settings.resource_name)


class _Waiter:
    """One parked attach request. ``tried_gen`` is the last capacity
    generation this waiter already retried at — the baton-passing that
    lets a wrong-node waiter hand the wakeup to the next in line instead
    of swallowing it. ``deadline`` is its absolute give-up time;
    ``entire`` rides along so the persisted intent record can re-run the
    exact attach; ``outcome`` is set ("moved") when shard hand-off wakes
    the waiter to re-route instead of retrying here."""

    __slots__ = ("tenant", "priority", "chips", "node", "rid",
                 "namespace", "pod", "enqueued_at", "event", "tried_gen",
                 "preempted", "entire", "deadline", "outcome", "gang")

    def __init__(self, tenant: str, priority: str, chips: int, node: str,
                 rid: str, namespace: str, pod: str, gen: int,
                 entire: bool = False, timeout_s: float = 0.0):
        self.tenant = tenant
        self.priority = priority
        self.chips = chips
        self.node = node
        self.rid = rid
        self.namespace = namespace
        self.pod = pod
        self.enqueued_at = time.monotonic()
        self.event = threading.Event()
        self.tried_gen = gen
        self.preempted = 0     # victims already detached for this waiter
        self.entire = entire
        self.deadline = self.enqueued_at + timeout_s
        self.outcome: str | None = None
        # Gang waiter (a parked whole-slice attach, master/slicetxn.py):
        # node-less (any host freeing GPUs may complete it) and persisted
        # as a slice txn record instead of a waiter record.
        self.gang = False


class AttachBroker:
    """Master-side admission/arbitration in front of the worker path.

    The gateway hands every attach through :meth:`attach` with an
    ``attempt_fn`` that performs the actual worker RPC and returns the
    ``(http_status, payload)`` pair; detaches for preemption/expiry go
    back out through the ``detach_fn`` the gateway binds — the broker
    itself never dials a worker, so tracing, retries, breakers and the
    journal all apply unchanged.
    """

    def __init__(self, kube, config: BrokerConfig | None = None):
        self.kube = kube
        self.config = config or BrokerConfig()
        self.leases = LeaseTable()
        self._lock = threading.Lock()
        # Parked waiters: insertion-ordered membership + the bucketed
        # wakeup index (master/waiterindex.py). All access under _lock.
        self._waiters = WaiterQueue(indexed=self.config.waiter_index)
        # Capacity generation: bumped whenever chips may have freed (or
        # preemption candidates appeared). Waiters retry at most once per
        # generation, so one freed slave pod wakes one chain of retries,
        # not a thundering herd.
        self._gen = 0
        # In-flight admission reservations per tenant: chips admitted but
        # not yet recorded as leases (attempt running or queued). Counted
        # as usage by admit(), so two same-tenant requests racing through
        # the quota check cannot both slip under the cap.
        self._inflight: dict[str, int] = {}
        self._detach_fn = None
        self._rederive_lock = threading.Lock()
        self._rederived = False
        self._loop: threading.Thread | None = None
        self._stop = threading.Event()
        # HA plane (bind_ha): the declarative intent store, the shard
        # ring, and this replica's election view. All None = single-
        # master semantics, zero ConfigMap traffic.
        self.store = None
        self.ring = None
        self.election = None
        # attempt_factory(namespace, pod, chips, entire, rid, node) ->
        # attempt_fn: how an ADOPTED waiter (rehydrated from a dead
        # peer's store records) re-runs its attach through the gateway's
        # worker path. rids already adopted (or currently parked here)
        # are never adopted twice.
        self._attempt_factory = None
        # rid -> shard of every adoption in flight: membership prevents
        # double-adoption; the shard lets a lost shard's entries be
        # pruned (a reacquire must re-adopt records a dead peer never
        # resolved). _adopt_lock serializes every check-then-act on BOTH
        # structures — rehydration races between the election thread
        # (acquire), the tick loop (deferred retry) and request threads
        # (lazy boot) must not adopt one intent twice.
        self._adopt_lock = threading.Lock()
        self._adopted_rids: dict[str, int] = {}
        self._rehydrated_shards: set[int] = set()
        # Slice transaction manager (bind_slice): group-lease expiry and
        # preemption detach whole slices through it; rehydration hands
        # it stranded txn records. None = single-host semantics only.
        self._slice = None
        # A release/expiry/hand-back freed GPUs since the last tick: the
        # tick stamps the peer shards' capacity poke (request threads
        # never pay the ConfigMap round trip).
        self._poke_pending = False
        # Utilization feed (bind_utilization): zero-arg callable →
        # {(namespace, pod): activity dict} from the fleet aggregator's
        # /utilz scrapes. None = no telemetry, no idle marking — the
        # pre-sampler behavior exactly.
        self._activity_fn = None
        # tenants ever exported on tenant_chips_idle, so a tenant whose
        # idle leases resolved resets to 0 instead of freezing
        self._idle_tenants: set[str] = set()
        # Fleet defragmenter (bind_defrag): shard rehydration hands it
        # journaled defrag-move records to adopt or abort. None = no
        # actuator (TPU_DEFRAG_MODE=0).
        self._defrag = None
        # Node failure domain (master/nodehealth.py, bind_node_health):
        # node -> state ("healthy"/"draining"/"suspect"/"dead"). None =
        # subsystem off — no fencing.
        self._node_health_fn = None
        # Override seam for fence-time cluster cleanup (delete the
        # fenced owner's slave pods). Default = this broker's kube;
        # split-view test stacks (MultiNodeStack) bind the per-node fake
        # clusters here so fencing reaches the "one apiserver" the
        # production deployment has.
        self.fence_cleanup = None
        # Recent fences for /brokerz and the chaos invariants (bounded;
        # key present in snapshots only when non-empty, so the idle
        # subsystem's payload is the one without it).
        self._fenced: collections.deque = collections.deque(maxlen=64)
        # nodes with a re-notify handler currently in flight (the tick
        # must neither stall on apiserver fencing nor stack threads)
        self._renotify_inflight: set[str] = set()

    def bind_node_health(self, state_fn) -> None:
        """``state_fn(node) -> "healthy"|"draining"|"suspect"|"dead"``
        (NodeHealthTracker.state): lets the reaper fence leases whose
        worker is judged dead instead of retrying it forever."""
        self._node_health_fn = state_fn

    def node_state(self, node: str) -> str:
        if self._node_health_fn is None or not node:
            return "healthy"
        try:
            return self._node_health_fn(node)
        except Exception:    # noqa: BLE001 — health telemetry must not
            logger.exception("node health lookup failed")  # break reaping
            return "healthy"

    def bind(self, detach_fn) -> None:
        """``detach_fn(lease, cause, force) -> result name`` — the
        gateway's worker-path detach, used for preemption and expiry."""
        self._detach_fn = detach_fn

    def bind_ha(self, store, ring, election) -> None:
        """Wire the HA plane: lease mutations write through ``store``
        (master/store.py), admission ownership follows ``election`` over
        ``ring``'s shards, and a fenced store write demotes this replica's
        shard immediately."""
        self.store = store
        self.ring = ring
        self.election = election
        self.leases.store = store
        self.leases.on_fenced = self._on_fenced
        if store is not None:
            # the group-commit coalescer's fence surface: a fused batch
            # bounced off a higher fence demotes this replica's shard
            # exactly like a per-record write raising StoreFencedError
            store.on_fenced = self._on_fenced

    def bind_attempt_factory(self, factory) -> None:
        self._attempt_factory = factory

    def bind_slice(self, manager) -> None:
        """Wire the slice transaction manager (master/slicetxn.py):
        group-lease expiry and preemption detach whole slices through
        it, and shard rehydration hands it stranded txn records."""
        self._slice = manager

    def bind_defrag(self, actuator) -> None:
        """Wire the fleet defragmenter (master/defrag.py): shard
        rehydration hands it the dead leader's journaled defrag moves,
        so every in-flight migration is adopted (grow landed — finish
        the detach) or aborted (group intact at the old placement)."""
        self._defrag = actuator

    def bind_utilization(self, activity_fn) -> None:
        """Wire the fleet aggregator's per-lease activity feed
        (``FleetAggregator.lease_activity``): the broker tick joins it
        to the lease table to mark leases idle past
        ``TPU_IDLE_LEASE_S`` — the reclaim signal and the preemption
        victim preference."""
        self._activity_fn = activity_fn

    # -- sharding / ownership --------------------------------------------------

    def shard_of(self, namespace: str) -> int:
        return self.ring.shard_of(namespace) if self.ring else 0

    def _owns(self, namespace: str) -> bool:
        if self.election is None:
            return True
        return self.election.is_leader(self.shard_of(namespace))

    def _on_fenced(self, err) -> None:
        """A store write bounced off a higher fence: a peer leads that
        shard now — demote locally instead of fighting the token. The
        refused fence is recorded so a later acquisition (e.g. after
        the lock object was deleted, restarting lock fences at 1) must
        clear it instead of livelocking acquire→fenced→demote."""
        if self.election is not None:
            self.election.note_fence(err.shard, err.fence)
            self.election.demote(err.shard, str(err))

    def on_shard_acquired(self, shard: int) -> None:
        """Election hand-off: this replica now owns the shard — load its
        persisted intent (exact leases AND parked waiters) and drain the
        recovered waiters as if their clients were still connected (the
        original request ids make the re-runs idempotent)."""
        if self.store is not None:
            # force a fresh read even for a shard this replica held
            # before: an acquire can be a RESUME after decayed validity,
            # and the shard map may have moved while we were not acting
            with self._adopt_lock:
                self._rehydrated_shards.discard(shard)
            self._rehydrate_shard(shard)
        # The store may predate some leases (attaches that only exist as
        # slave-pod labels) — and with no store at all, the slave-pod
        # derivation is the ONLY source of the dead leader's leases:
        # either way the next decision must re-derive cluster ground
        # truth, same lazy discipline as boot.
        self._rederived = False
        self.signal_capacity()

    def on_shard_lost(self, shard: int) -> None:
        """Deposed: evict the shard's in-memory leases (WITHOUT store
        deletes — the records belong to the new leader now), drop its
        parked store mutations, and wake its waiters to re-route."""
        if self.ring is None:
            return
        self.leases.evict_where(
            lambda lease: self.ring.shard_of(lease.namespace) == shard)
        if self.store is not None:
            self.store.forget_shard(shard)
        with self._adopt_lock:
            self._rehydrated_shards.discard(shard)
            # adoption history belongs to the shard: keeping it would
            # make a later reacquire skip records the interim leader
            # never resolved, stranding their intent forever
            for rid in [r for r, s in self._adopted_rids.items()
                        if s == shard]:
                del self._adopted_rids[rid]
        with self._lock:
            for waiter in self._waiters:
                if self.ring.shard_of(waiter.namespace) == shard:
                    waiter.outcome = "moved"
                    waiter.event.set()

    def _rehydrate_shard(self, shard: int) -> None:
        if self.store is None:
            return
        with self._adopt_lock:
            if shard in self._rehydrated_shards:
                return
            self._rehydrated_shards.add(shard)
        try:
            leases, waiters, torn = self.store.rehydrate(shard)
        except K8sApiError as e:
            with self._adopt_lock:
                self._rehydrated_shards.discard(shard)
            logger.warning("shard %d store rehydration deferred: %s",
                           shard, e)
            return
        merged = self.leases.merge_records(leases)
        if merged or waiters or torn:
            logger.info("shard %d rehydrated: %d lease(s) merged, %d "
                        "waiter(s) to adopt, %d torn record(s)", shard,
                        merged, len(waiters), torn)
        self._adopt_waiters(waiters)
        if self._slice is not None:
            # unresolved slice transactions (a dead leader's mid-fan-out
            # state): the manager completes or rolls each back under its
            # original rid/txn — the zero-half-attached-slices guarantee
            try:
                slice_records, _ = self.store.rehydrate_slice_txns(shard)
            except K8sApiError as e:
                logger.warning("shard %d slice-txn rehydration deferred: "
                               "%s (tick retries)", shard, e)
                slice_records = []
            if slice_records:
                adopted = self._slice.adopt(slice_records)
                logger.info("shard %d: adopted %d stranded slice txn(s)",
                            shard, adopted)
            # re-federation barriers the dead leader armed: re-arm them
            # (joined set restarts empty; members re-join idempotently)
            # so waiting members keep a coordinator of record
            try:
                barrier_records, _ = self.store.rehydrate_barriers(shard)
            except K8sApiError as e:
                logger.warning("shard %d barrier rehydration deferred: "
                               "%s (tick retries)", shard, e)
                barrier_records = []
            if barrier_records:
                rearmed = self._slice.adopt_barriers(barrier_records)
                logger.info("shard %d: re-armed %d re-federation "
                            "barrier(s)", shard, rearmed)
        if self._defrag is not None:
            # journaled defrag moves the dead leader never resolved:
            # the actuator adopts each against the group's ACTUAL
            # membership — old placement or new, never half-moved
            try:
                defrag_records, _ = \
                    self.store.rehydrate_defrag_moves(shard)
            except K8sApiError as e:
                logger.warning("shard %d defrag rehydration deferred: "
                               "%s (tick retries)", shard, e)
                defrag_records = []
            if defrag_records:
                adopted = self._defrag.adopt(defrag_records)
                logger.info("shard %d: adopted %d stranded defrag "
                            "move(s)", shard, adopted)

    # -- recovered-waiter adoption ---------------------------------------------

    def _adopt_waiters(self, records) -> int:
        """Re-run persisted queue intent from a dead (or restarted)
        leader. Each record becomes a server-side attach under its
        ORIGINAL rid and remaining deadline — the worker's per-rid
        idempotent adoption makes a re-run of an attach that actually
        landed return the same GPUs instead of double-actuating."""
        if self._attempt_factory is None:
            return 0
        adopted = 0
        with self._lock:
            live = {w.rid for w in self._waiters}
        for record in records:
            with self._adopt_lock:
                if record.rid in self._adopted_rids or record.rid in live:
                    continue
                self._adopted_rids[record.rid] = \
                    self.shard_of(record.namespace)
            adopted += 1
            threading.Thread(target=self._run_adopted, args=(record,),
                             daemon=True,
                             name=f"tpumounter-adopt-{record.rid}").start()
        return adopted

    def _run_adopted(self, record) -> None:
        remaining = record.deadline_unix - time.time()
        EVENTS.emit("waiter_adopted", rid=record.rid,
                    tenant=record.tenant, namespace=record.namespace,
                    pod=record.pod, chips=record.chips,
                    remaining_s=round(max(0.0, remaining), 3))
        if remaining <= 0:
            # its client's deadline passed while nobody owned the shard:
            # resolve as a clean timeout — delete the intent so it never
            # resurrects, and account the outcome
            REGISTRY.admission_decisions.inc(tenant=record.tenant,
                                             outcome="queue_timeout")
            EVENTS.emit("queue_timeout", rid=record.rid,
                        tenant=record.tenant, chips=record.chips,
                        priority=record.priority, adopted=True)
            self._unpersist_rid(record.namespace, record.rid)
            with self._adopt_lock:
                self._adopted_rids.pop(record.rid, None)
            return
        attempt_fn = self._attempt_factory(
            record.namespace, record.pod, record.chips, record.entire,
            record.rid, record.node)
        try:
            status, payload = self.attach(
                tenant=record.tenant, priority=record.priority,
                namespace=record.namespace, pod=record.pod,
                chips=record.chips, node=record.node, rid=record.rid,
                attempt_fn=attempt_fn, entire=record.entire,
                timeout_s=remaining)
            logger.info("[rid=%s] adopted waiter resolved: %s / %s",
                        record.rid, status,
                        payload.get("result", "-"))
        except Exception as e:     # noqa: BLE001 — a drain thread dying
            # would strand the intent record forever; resolve it below
            logger.warning("[rid=%s] adopted waiter failed: %s",
                           record.rid, e)
        finally:
            # resolved either way (an immediate 200 never parks, so the
            # queue path's own cleanup may not have run): the intent
            # record must not outlive its resolution, and neither must
            # the adoption entry (the record is gone — nothing left to
            # double-adopt)
            self._unpersist_rid(record.namespace, record.rid)
            with self._adopt_lock:
                self._adopted_rids.pop(record.rid, None)

    # -- waiter persistence (master/store.py write-through) --------------------

    def _persist_waiter(self, waiter: _Waiter, timeout_s: float) -> None:
        if self.store is None:
            return
        from gpumounter_tpu_torch.master.store import WaiterRecord
        record = WaiterRecord(
            rid=waiter.rid, namespace=waiter.namespace, pod=waiter.pod,
            tenant=waiter.tenant, priority=waiter.priority,
            chips=waiter.chips, node=waiter.node, entire=waiter.entire,
            enqueued_unix=round(time.time(), 3),
            deadline_unix=round(time.time() + timeout_s, 3))
        try:
            self.store.put_waiter(record)
        except StoreFencedError as e:
            self._on_fenced(e)

    def _unpersist_waiter(self, waiter: _Waiter) -> None:
        self._unpersist_rid(waiter.namespace, waiter.rid)

    def _unpersist_rid(self, namespace: str, rid: str) -> None:
        if self.store is None:
            return
        try:
            self.store.delete_waiter(namespace, rid)
        except StoreFencedError as e:
            self._on_fenced(e)

    # -- restart re-derivation -------------------------------------------------

    def ensure_rederived(self) -> None:
        """Re-derive the lease table from cluster ground truth once per
        process, lazily before the first decision that needs usage. An
        unreachable apiserver defers (and is retried on the next call)
        rather than crashing the boot."""
        if self._rederived:
            return
        with self._rederive_lock:
            if self._rederived:
                return
            # Persisted intent first: the store's records carry what the
            # cluster derivation cannot (exact tenant/priority/uuids AND
            # the parked waiters); the slave-pod derivation below then
            # fills whatever the store doesn't know — including records
            # torn by a crash mid-write.
            if self.store is not None and self.election is not None:
                for shard in self.election.owned():
                    self._rehydrate_shard(shard)
            try:
                self.leases.rederive(self.kube, self.config.pool_namespace,
                                     self.config.resource_name,
                                     self.config.lease_ttl_s)
            except K8sApiError as e:
                logger.warning("lease re-derivation deferred (apiserver "
                               "unreachable): %s", e)
                return
            if self.election is not None and self.election.enabled:
                # cluster derivation sees EVERY owner pod; foreign
                # shards' leases belong to their leaders (holding them
                # here would only pollute /brokerz and the reaper)
                self.leases.evict_where(
                    lambda lease: not self._owns(lease.namespace))
            self._rederived = True

    # -- admission -------------------------------------------------------------

    def quota(self, tenant: str) -> int | None:
        """The tenant's guaranteed share; None = unlimited."""
        quota = self.config.quotas.get(tenant)
        if quota is None:
            quota = self.config.quotas.get("*")
        return quota

    def cap(self, tenant: str) -> int | None:
        """Admission ceiling: quota * burst (usage between quota and cap
        is borrowed capacity, preemptible by high-priority requests)."""
        quota = self.quota(tenant)
        if quota is None:
            return None
        return int(quota * self.config.quota_burst)

    def admit(self, tenant: str, chips: int, rid: str = "-") -> None:
        """Quota gate for one attach. Raises
        :class:`QuotaExceededError` (→ 429 + Retry-After) when the
        tenant's live usage plus this request exceeds its cap."""
        self.ensure_rederived()
        cap = self.cap(tenant)
        if cap is not None:
            usage = (self.leases.tenant_usage(tenant)
                     + self._inflight.get(tenant, 0))
            if usage + chips > cap:
                REGISTRY.admission_decisions.inc(tenant=tenant,
                                                 outcome="over_quota")
                EVENTS.emit("admit_denied", rid=rid, tenant=tenant,
                            chips=chips, outcome="over_quota",
                            usage=usage, cap=cap)
                logger.info("[rid=%s] admission DENIED: tenant=%s "
                            "usage=%d + %d > cap %d", rid, tenant, usage,
                            chips, cap)
                raise QuotaExceededError(tenant, usage, chips, cap,
                                         self._retry_after_hint(tenant))
        REGISTRY.admission_decisions.inc(tenant=tenant, outcome="granted")
        EVENTS.emit("admit_granted", rid=rid, tenant=tenant, chips=chips)

    @contextlib.contextmanager
    def admission(self, tenant: str, chips: int, rid: str = "-"):
        """Admission with an in-flight reservation held for the scope:
        the quota check and the reservation are one atomic step, so
        concurrent same-tenant arrivals cannot both slip under the cap
        between check and lease record.
        On a request's trace the check is the ``admission`` span."""
        with span("admission", tenant=tenant):
            self.ensure_rederived()
            with self._lock:
                self.admit(tenant, chips, rid)
                self._inflight[tenant] = (self._inflight.get(tenant, 0)
                                          + chips)
        try:
            yield
        finally:
            with self._lock:
                left = self._inflight.get(tenant, 0) - chips
                if left > 0:
                    self._inflight[tenant] = left
                else:
                    self._inflight.pop(tenant, None)

    def _retry_after_hint(self, tenant: str | None = None) -> float:
        """When might capacity free? The soonest expiry among the
        tenant's own leases (quota 429s), or across ALL leases when
        ``tenant`` is None — the lease horizon, for queue-timeout 503s.
        Clamped [1, 60]; 5s when nothing expires (a detach could happen
        any time, but the client should not hammer)."""
        soonest = None
        for lease in self.leases.leases():
            if tenant is not None and lease.tenant != tenant:
                continue
            remaining = lease.expires_in_s()
            if remaining is not None and (soonest is None
                                          or remaining < soonest):
                soonest = remaining
        if soonest is None:
            return 5.0
        return min(max(soonest, 1.0), 60.0)

    def _capacity_hint(self) -> float:
        return self._retry_after_hint(tenant=None)

    def _queue_full_hint_locked(self, priority: str) -> float:
        """Queue-full Retry-After: a slot frees no later than when the
        OLDEST same-priority waiter hits its deadline (it may grant and
        leave sooner) — that remaining time, floored by the lease
        horizon when the queue math says "now", clamped [1, 60]."""
        now = time.monotonic()
        soonest = min((w.deadline - now for w in self._waiters
                       if w.priority == priority), default=None)
        if soonest is None or soonest <= 0:
            return min(self._capacity_hint(), 60.0)
        return min(max(soonest, 1.0), 60.0)

    # -- attach orchestration --------------------------------------------------

    @staticmethod
    def _is_insufficient(status: int, payload: dict) -> bool:
        return status == 503 and payload.get("result") == \
            consts.AddResult.INSUFFICIENT_GPU.name

    def attach(self, *, tenant: str, priority: str, namespace: str,
               pod: str, chips: int, node: str, rid: str,
               attempt_fn, entire: bool = False,
               timeout_s: float | None = None) -> tuple[int, dict]:
        """Admission-gated attach: quota check, one attempt, then (when
        queueing is enabled) park in the contention queue until capacity
        frees, the deadline passes, or — for ``high`` — a preemption
        makes room. Successful attaches are recorded as leases. The
        admitted chips are held as an in-flight reservation until this
        call returns, so concurrent same-tenant arrivals see them.
        ``timeout_s`` overrides the configured queue deadline (adopted
        waiters park for their REMAINING time, not a fresh window)."""
        with self.admission(tenant, chips, rid):
            gen0 = self._gen
            status, payload = attempt_fn()
            if status == 200:
                self._record_success(namespace, pod, tenant, priority,
                                     payload, node, rid)
                return status, payload
            timeout = (self.config.queue_timeout_s if timeout_s is None
                       else timeout_s)
            if not self._is_insufficient(status, payload) or timeout <= 0:
                return status, payload
            return self._attach_queued(tenant, priority, namespace, pod,
                                       chips, node, rid, attempt_fn,
                                       status, payload, gen0, entire,
                                       timeout)

    def _record_success(self, namespace: str, pod: str, tenant: str,
                        priority: str, payload: dict, node: str,
                        rid: str) -> None:
        uuids = [str(u) for u in payload.get("device_ids") or []]
        # the ``lease`` span on a request's trace
        with span("lease"):
            lease = self.leases.record(namespace, pod, tenant, priority,
                                       uuids, chips=len(uuids), node=node,
                                       rid=rid,
                                       ttl_s=self.config.lease_ttl_s)
        remaining = lease.expires_in_s()
        if remaining is not None:
            payload["lease_expires_in_s"] = round(remaining, 1)
        payload["tenant"] = tenant
        # a recorded lease is ALSO a new preemption candidate: give any
        # parked high-priority waiter a chance to act on it — on THIS
        # node; nothing freed anywhere else
        self.signal_capacity(node=node)

    def _attach_queued(self, tenant: str, priority: str, namespace: str,
                       pod: str, chips: int, node: str, rid: str,
                       attempt_fn, status: int, payload: dict,
                       gen0: int, entire: bool,
                       timeout: float) -> tuple[int, dict]:
        # ``timeout`` was resolved (and gated > 0) by attach() — a second
        # default-resolution here could silently diverge from that gate
        with self._lock:
            depth = self._check_queue_full_locked(tenant, priority,
                                                  chips, rid, gang=False)
            waiter = _Waiter(tenant, priority, chips, node, rid,
                             namespace, pod, gen=gen0, entire=entire,
                             timeout_s=timeout)
            self._waiters.add(waiter)
            if self._gen != gen0:
                # capacity freed between the failed attempt and the
                # enqueue — that wakeup is gone; self-arm instead of
                # sleeping the full deadline next to free chips
                waiter.tried_gen = self._gen
                waiter.event.set()
            self._refresh_queue_gauges_locked()
        # persisted intent (master/store.py): the parked request now
        # survives this process — a failed-over peer adopts and drains it
        self._persist_waiter(waiter, timeout)
        deadline = waiter.deadline
        EVENTS.emit("queue_enqueue", rid=rid, tenant=tenant, chips=chips,
                    node=node, namespace=namespace, pod=pod,
                    priority=priority, depth=depth + 1)
        logger.info("[rid=%s] attach queued: tenant=%s priority=%s "
                    "chips=%d node=%s depth=%d", rid, tenant, priority,
                    chips, node, depth + 1)
        try:
            while True:
                if waiter.priority == "high":
                    self._try_preempt(waiter)
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not waiter.event.wait(remaining):
                    waited = time.monotonic() - waiter.enqueued_at
                    REGISTRY.queue_wait.observe(waited, tenant=tenant)
                    REGISTRY.admission_decisions.inc(
                        tenant=tenant, outcome="queue_timeout")
                    EVENTS.emit("queue_timeout", rid=rid, tenant=tenant,
                                chips=chips, priority=priority,
                                waited_s=round(waited, 3))
                    payload = dict(payload)
                    payload["queued_s"] = round(waited, 3)
                    payload["queue_timeout"] = True
                    # derived hint: the lease horizon says when chips can
                    # actually free — a constant would either hammer a
                    # full node or sit out a fresh detach
                    payload["retry_after_s"] = round(
                        self._capacity_hint(), 1)
                    return status, payload
                if waiter.outcome == "moved":
                    # shard hand-off mid-wait: this replica no longer
                    # owns the keyspace — tell the client to re-route
                    # (the retry lands anywhere and is forwarded to the
                    # new leader; same rid keeps it idempotent)
                    EVENTS.emit("queue_moved", rid=rid, tenant=tenant,
                                chips=chips, priority=priority)
                    return 503, {
                        "result": "ShardMoved",
                        "message": "admission shard moved to another "
                                   "replica mid-queue; retry",
                        "retry_after_s": 1.0}
                waiter.event.clear()
                status, payload = attempt_fn()
                if status == 200:
                    # leave the queue BEFORE signalling: the success's
                    # capacity signal must not be swallowed by this
                    # departing (still-listed) waiter
                    with self._lock:
                        if waiter in self._waiters:
                            self._waiters.remove(waiter)
                    waited = time.monotonic() - waiter.enqueued_at
                    REGISTRY.queue_wait.observe(waited, tenant=tenant)
                    REGISTRY.admission_decisions.inc(
                        tenant=tenant, outcome="granted_queued")
                    EVENTS.emit("queue_granted", rid=rid, tenant=tenant,
                                chips=chips, priority=priority,
                                waited_s=round(waited, 3))
                    self._record_success(namespace, pod, tenant, priority,
                                         payload, node, rid)
                    payload["queued_s"] = round(waited, 3)
                    return status, payload
                if not self._is_insufficient(status, payload):
                    return status, payload
                # still contended (e.g. the freed chips were on another
                # node): pass the baton to the next untried waiter
                self._signal_next(exclude=waiter)
        finally:
            with self._lock:
                if waiter in self._waiters:
                    self._waiters.remove(waiter)
                # A departing non-winner may hold an unconsumed (or
                # consumed-but-unresolved) wakeup — timed out right as it
                # was chosen, or exited on an RPC error after waking. Hand
                # the baton on; if no generation signal is outstanding
                # this is a no-op, and a spurious wake just retries, fails
                # and settles. Without it, freed chips can sit idle while
                # every remaining waiter sleeps to its deadline.
                self._signal_next_locked()
                self._refresh_queue_gauges_locked()
            # the parked intent is resolved (grant, timeout, error or
            # hand-off): remove its store record — crash is the ONLY
            # path that leaves one behind, which is exactly the intent
            # a surviving replica must adopt
            self._unpersist_waiter(waiter)

    # -- gang waiters (whole-slice attaches, master/slicetxn.py) ---------------

    def current_gen(self) -> int:
        """The capacity generation right now — callers snapshot it
        before an attempt so an enqueue can self-arm against a signal
        that fired in between (``_attach_queued`` and ``park_gang``)."""
        with self._lock:
            return self._gen

    def _check_queue_full_locked(self, tenant: str, priority: str,
                                 chips: int, rid: str,
                                 gang: bool) -> int:
        """The one queue-full gate (single waiters and gangs share it):
        returns the current same-priority depth, or raises
        :class:`QueueFullError` with the derived hint."""
        depth = self._waiters.count(priority)
        if depth >= self.config.queue_depth:
            REGISTRY.admission_decisions.inc(tenant=tenant,
                                             outcome="queue_full")
            EVENTS.emit("queue_full", rid=rid, tenant=tenant,
                        chips=chips, priority=priority, depth=depth,
                        gang=gang)
            raise QueueFullError(
                priority, depth,
                retry_after_s=self._queue_full_hint_locked(priority))
        return depth

    def park_gang(self, *, tenant: str, priority: str, chips: int,
                  rid: str, namespace: str, label: str,
                  timeout_s: float, gen0: int | None = None) -> _Waiter:
        """Park a whole-slice attach in the contention queue. The gang
        rides the SAME priority-then-weighted-fair wakeup as single
        waiters (its GPUs weigh its tenant's fair share), but is
        node-less — any host freeing GPUs may complete some member — and
        its durable intent is the slice txn record the manager persists,
        not a waiter record. ``gen0`` is the capacity generation sampled BEFORE the failed
        attempt: a signal that fired in between already went to someone
        else (or nobody), so the gang self-arms instead of sleeping next
        to free GPUs. Raises :class:`QueueFullError` at the per-priority
        bound like any other enqueue."""
        with self._lock:
            depth = self._check_queue_full_locked(tenant, priority,
                                                  chips, rid, gang=True)
            waiter = _Waiter(tenant, priority, chips, node="", rid=rid,
                             namespace=namespace, pod=label,
                             gen=self._gen if gen0 is None else gen0,
                             entire=True, timeout_s=timeout_s)
            waiter.gang = True
            self._waiters.add(waiter)
            if gen0 is not None and self._gen != gen0:
                waiter.tried_gen = self._gen
                waiter.event.set()
            self._refresh_queue_gauges_locked()
        EVENTS.emit("queue_enqueue", rid=rid, tenant=tenant, chips=chips,
                    namespace=namespace, pod=label, priority=priority,
                    depth=depth + 1, gang=True)
        return waiter

    def unpark_gang(self, waiter: _Waiter) -> None:
        """Remove a resolved gang from the queue and hand any
        outstanding wakeup on (the departing-waiter baton discipline of
        ``_attach_queued``'s finally block)."""
        with self._lock:
            if waiter in self._waiters:
                self._waiters.remove(waiter)
            self._signal_next_locked()
            self._refresh_queue_gauges_locked()

    def poke_peers(self) -> bool:
        """Cross-shard capacity nudge: GPUs freed on this replica's
        shards may be what a PEER shard's parked waiters (gangs
        especially — multi-node demand) are sleeping on. The request
        thread only MARKS the nudge; the broker tick sends it — a peer
        ConfigMap patch is an apiserver round trip that must never ride
        (or stall) the detach hot path, and batching to tick cadence
        caps poke traffic regardless of release rate. No-op outside the
        sharded-store configuration."""
        if self.store is None or self.ring is None \
                or self.ring.shards < 2 or self.election is None \
                or not self.election.enabled:
            return False
        self._poke_pending = True
        return True

    def gang_baton(self, waiter: _Waiter) -> None:
        """A woken gang retried and is still short: mark its generation
        consumed and wake the next untried waiter."""
        self._signal_next(exclude=waiter)

    def try_preempt_for(self, waiter: _Waiter) -> bool:
        """Preemption entry for gang waiters (the single-attach queue
        loop calls ``_try_preempt`` directly)."""
        return self._try_preempt(waiter)

    # -- capacity signalling / fair dequeue ------------------------------------

    def signal_capacity(self, node: str | None = None,
                        chips: int = 0) -> None:
        """Chips may have freed (detach / expiry / preemption) or the
        preemption candidate set changed: open a new retry generation and
        wake the first waiter in priority-then-fair order. ``node`` and
        ``chips`` are locality hints — where capacity freed and how much
        — that let the waiter index (master/waiterindex.py) examine only
        candidates the capacity could actually satisfy; with no hints
        (or the index off) every waiter is a candidate, the historical
        behavior."""
        with self._lock:
            self._gen += 1
            self._signal_next_locked(node=node, chips=chips)

    def _signal_next(self, exclude: _Waiter | None = None) -> None:
        with self._lock:
            if exclude is not None:
                exclude.tried_gen = self._gen
            self._signal_next_locked()

    def _signal_next_locked(self, node: str | None = None,
                            chips: int = 0) -> None:
        if not self._waiters:
            return
        chosen, evaluated = self._waiters.select(
            self._gen, node=node or None, chips=chips,
            usage_fn=self.leases.usage, quota_fn=self.quota)
        REGISTRY.wakeup_signals.inc()
        if evaluated:
            REGISTRY.wakeup_evaluations.inc(float(evaluated))
        if chosen is None:
            return
        chosen.tried_gen = self._gen
        chosen.event.set()

    def _refresh_queue_gauges_locked(self) -> None:
        now = time.monotonic()
        for priority in consts.PRIORITIES:
            REGISTRY.queue_depth.set(self._waiters.count(priority),
                                     priority=priority)
        REGISTRY.gang_queue_depth.set(self._waiters.gang_count())
        oldest = self._waiters.oldest_enqueued_at()
        REGISTRY.queue_oldest_age.set(
            0.0 if oldest is None else round(now - oldest, 3))

    # -- preemption ------------------------------------------------------------

    def _try_preempt(self, waiter: _Waiter) -> bool:
        """Detach the lowest-priority live attachment of an over-quota
        tenant (same node as the waiter's target) to make room for a
        ``high`` request. Goes through the gateway's normal detach path:
        traced, breaker-guarded, cause-stamped into the worker's audit
        event and journal."""
        if self._detach_fn is None or not self.config.quotas:
            return False
        if waiter.preempted >= waiter.chips:
            # damping: each victim frees >=1 chip, so `chips` victims
            # always suffice — without this bound, a kubelet whose freed
            # chips are slow to become attachable would let ONE high
            # request serially drain every over-quota lease on the node
            return False
        victim = self._pick_victim(waiter)
        if victim is None:
            return False
        cause = f"preempted:{waiter.tenant}:{waiter.rid or '-'}"
        if victim.group and self._slice is not None:
            return self._preempt_group(victim, waiter, cause)
        logger.warning("preempting %s/%s (tenant=%s priority=%s chips=%d)"
                       " for high-priority rid=%s of tenant=%s",
                       victim.namespace, victim.pod, victim.tenant,
                       victim.priority, victim.chips, waiter.rid,
                       waiter.tenant)
        result = self._detach_fn(victim, cause, True)
        if result in _DETACH_GONE:
            # count toward the damping bound whether or not the drop
            # lands — this waiter consumed a preemption attempt (the
            # bound was documented but never incremented before: one
            # high-priority waiter could serially drain every over-quota
            # lease on a node whose freed chips were slow to attach)
            waiter.preempted += 1
            if self.leases.drop(victim.namespace, victim.pod) is not None:
                REGISTRY.preemptions.inc()
                # emitted only when the drop landed: a lease released
                # concurrently (pod detached on its own) is not a
                # preemption, and the event stream must agree with
                # tpumounter_preemptions_total on volume
                EVENTS.emit("preempt", rid=waiter.rid, tenant=waiter.tenant,
                            namespace=victim.namespace, pod=victim.pod,
                            chips=victim.chips, victim_tenant=victim.tenant,
                            victim_priority=victim.priority, result=result)
            self.signal_capacity(node=victim.node, chips=victim.chips)
            return True
        logger.warning("preemption of %s/%s did not free chips: %s",
                       victim.namespace, victim.pod, result)
        return False

    def _preempt_group(self, victim: Lease, waiter: _Waiter,
                       cause: str) -> bool:
        """Preempt a slice group as a unit: detaching one member would
        leave the victim's world broken AND keep most of its GPUs — the
        group goes together, through the coordinator's fan-out."""
        members = self.leases.group_leases(victim.group)
        pods = [(member.namespace, member.pod) for member in members]
        logger.warning("preempting slice group %s (%d hosts, tenant=%s) "
                       "for high-priority rid=%s of tenant=%s",
                       victim.group, len(pods), victim.tenant,
                       waiter.rid, waiter.tenant)
        ok, results = self._slice.detach_members(
            pods, cause=f"{cause}:group:{victim.group}", force=True)
        freed_chips = 0
        freed_members = 0
        for result in results:
            if result.result in _DETACH_GONE:
                dropped = self.leases.drop(result.namespace, result.pod)
                if dropped is not None:
                    freed_chips += dropped.chips
                    freed_members += 1
        if freed_members:
            REGISTRY.preemptions.inc()
            EVENTS.emit("preempt", rid=waiter.rid, tenant=waiter.tenant,
                        namespace=victim.namespace, pod=victim.pod,
                        chips=freed_chips, victim_tenant=victim.tenant,
                        victim_priority=victim.priority,
                        group=victim.group,
                        result="SUCCESS" if ok else "PARTIAL")
            waiter.preempted += freed_members
            self.signal_capacity()
            self.poke_peers()
            return True
        return False

    def _pick_victim(self, waiter: _Waiter) -> Lease | None:
        usage = self.leases.usage()
        candidates = []
        for lease in self.leases.leases():
            quota = self.quota(lease.tenant)
            if quota is None or usage.get(lease.tenant, 0) <= quota:
                continue                      # only over-quota tenants
            if lease.priority_rank() >= _rank(waiter.priority):
                continue                      # strictly lower priority
            if (lease.namespace, lease.pod) == (waiter.namespace,
                                                waiter.pod):
                continue                      # never preempt the requester
            if waiter.node and not lease.node:
                self._resolve_lease_node(lease)
            if waiter.node and lease.node and lease.node != waiter.node:
                continue                      # chips must free on OUR node
            candidates.append(lease)
        if not candidates:
            return None
        # lowest priority first; within a priority IDLE leases go before
        # busy ones (reclaiming a chip nobody is computing on costs the
        # victim nothing — the whole point of measuring utilization);
        # among equals the NEWEST over-quota grant is returned first
        # (the most recently borrowed capacity)
        return min(candidates,
                   key=lambda le: (le.priority_rank(),
                                   0 if le.idle_since_unix is not None
                                   else 1,
                                   -le.created_unix))

    def _resolve_lease_node(self, lease: Lease) -> None:
        """Re-derived leases carry no node until asked; one GET fills it
        in (preemption is rare and off the fast path)."""
        try:
            pod = self.kube.get_pod(lease.namespace, lease.pod)
            lease.node = objects.node_name(pod) or lease.node
        except Exception as e:         # noqa: BLE001 — best-effort fill
            logger.debug("node resolve for lease %s/%s failed: %s",
                         lease.namespace, lease.pod, e)

    # -- lease lifecycle -------------------------------------------------------

    def renew(self, namespace: str, pod: str,
              ttl_s: float | None = None) -> Lease:
        """Extend a lease (``POST /renew``). Raises KeyError for unknown
        leases — a renew can't resurrect an expired-and-reaped attach.
        A slice-group member renews the WHOLE group: the slice lives and
        dies as a unit, so one member's heartbeat is the slice's."""
        self.ensure_rederived()
        ttl = self.config.lease_ttl_s if ttl_s is None else ttl_s
        lease = self.leases.renew(namespace, pod, ttl)
        if lease.group:
            for member in self.leases.group_leases(lease.group):
                if member.key != lease.key:
                    self.leases.renew(member.namespace, member.pod, ttl)
        return lease

    def release(self, namespace: str, pod: str,
                uuids: list[str] | None = None) -> None:
        """Account an owner-initiated detach and wake the queue — even
        without a lease on record (pre-broker attach), freed GPUs are
        freed GPUs. Peer shards get a capacity poke too: their parked
        gangs may span the node these GPUs just freed on."""
        lease = self.leases.get(namespace, pod)
        released = self.leases.release(namespace, pod, uuids)
        # locality hints from the lease the detach resolved against; a
        # pre-broker attach (no lease) signals globally as before
        self.signal_capacity(
            node=lease.node if lease is not None else None,
            chips=released)
        self.poke_peers()

    # -- node failure domain: lease fencing (master/nodehealth.py) -------------

    def fence_lease(self, lease: Lease, reason: str) -> bool:
        """THE one-way eviction seam for health-driven lease removal
        (tests/test_torch_nodehealth_lint.py pins that no health code
        evicts the lease table any other way). Unlike a detach, fencing
        never dials the worker — it is unreachable; that is the point.
        Instead the grant is revoked CLUSTER-side: the owner's slave pods
        are deleted through the apiserver (ground truth then says "no
        grant"), the lease is dropped (quota frees, capacity signals
        fire), and the fence is evented + counted. A zombie worker
        rejoining replays its journal and converges its device gate
        against that ground truth — the fenced grant cannot resurrect."""
        current = self.leases.get(lease.namespace, lease.pod)
        if current is not lease:
            return False        # released/renewed since the caller saw it
        self._fence_cleanup(lease.namespace, lease.pod)
        # compare-and-pop: the cleanup above is seconds of apiserver
        # work under retries — a lease RE-GRANTED in that window is a
        # live attachment and must not be evicted by this stale fence
        dropped = self.leases.drop(lease.namespace, lease.pod,
                                   expected=lease)
        if dropped is None:
            return False
        REGISTRY.lease_fences.inc(reason=reason)
        EVENTS.emit("lease_fenced", rid=lease.rid, tenant=lease.tenant,
                    namespace=lease.namespace, pod=lease.pod,
                    chips=lease.chips, node=lease.node, reason=reason,
                    group=lease.group)
        self._fenced.append({
            "namespace": lease.namespace, "pod": lease.pod,
            "tenant": lease.tenant, "chips": lease.chips,
            "node": lease.node, "reason": reason, "group": lease.group,
            "ts": round(time.time(), 3)})
        logger.warning("lease %s/%s FENCED (%s): %d GPU(s) on node %s "
                       "reclaimed without a worker detach",
                       lease.namespace, lease.pod, reason, lease.chips,
                       lease.node or "?")
        self.signal_capacity(node=lease.node, chips=lease.chips)
        self.poke_peers()
        return True

    def _fence_cleanup(self, namespace: str, pod: str) -> None:
        """Delete the fenced owner's slave pods cluster-side (the
        apiserver outlives the node): releases the scheduler
        reservations and makes ground truth agree with the fence. Best
        effort — a flaky apiserver defers to the reconciler/next
        re-derivation, both of which run against the same truth."""
        if self.fence_cleanup is not None:
            try:
                self.fence_cleanup(namespace, pod)
            except Exception:    # noqa: BLE001 — cleanup is best-effort
                logger.exception("bound fence cleanup for %s/%s failed",
                                 namespace, pod)
            return
        selector = (f"{consts.OWNER_POD_LABEL_KEY}={pod},"
                    f"{consts.OWNER_NAMESPACE_LABEL_KEY}={namespace}")
        try:
            slaves = self.kube.list_pods(self.config.pool_namespace,
                                         label_selector=selector)
            for slave in slaves:
                self.kube.delete_pod(self.config.pool_namespace,
                                     objects.name(slave))
        except K8sApiError as e:
            logger.warning("fence cleanup for %s/%s deferred "
                           "(apiserver: %s) — the reconciler finishes "
                           "it", namespace, pod, e)

    def handle_node_down(self, node: str, dead: bool = True,
                         reason: str = "node-dead") -> None:
        """A node left service (nodehealth ``on_dead``/``on_drain``):
        single leases on it are fenced (dead only — a draining node
        detaches its own leases through the normal path), slice groups
        with members there go to self-healing (repair onto a spare
        host, or teardown-as-a-unit) whether dead or draining — the
        gang must re-form either way."""
        groups_hit: dict[str, list[Lease]] = {}
        for lease in self.leases.leases():
            if not self._owns(lease.namespace):
                continue
            if not lease.node:
                self._resolve_lease_node(lease)
            if lease.node != node:
                continue
            if lease.group:
                groups_hit.setdefault(lease.group, []).append(lease)
            elif dead:
                self.fence_lease(lease, reason=reason)
        for group, members in sorted(groups_hit.items()):
            pods = [(m.namespace, m.pod) for m in members]
            if self._slice is not None:
                self._slice.request_repair(group, pods, dead=dead,
                                           reason=reason)
            elif dead:
                # no slice subsystem bound (bare-broker rigs): fence the
                # members — stranding them would be worse than a broken
                # group, and the group dies with its node either way
                for member in members:
                    self.fence_lease(member, reason=reason)

    def fenced(self) -> list[dict]:
        """Recent fences, oldest first (bounded)."""
        return list(self._fenced)

    def _renotify_dead_nodes(self) -> None:
        """Tick-driven convergence for the node failure domain: any
        node judged dead that still anchors leases gets its node-down
        handling re-run (the on_dead callback fires once per death; a
        repair thread that died on a transient error would otherwise
        strand the group in the dead-with-leases state, with nothing
        left to retry it)."""
        if self._node_health_fn is None:
            return
        nodes = {lease.node for lease in self.leases.leases()
                 if lease.node}
        for node in sorted(nodes):
            if self.node_state(node) != "dead":
                continue
            with self._lock:
                if node in self._renotify_inflight:
                    continue        # previous handler still working
                self._renotify_inflight.add(node)

            def _run(node=node):
                try:
                    self.handle_node_down(node, dead=True,
                                          reason="node-dead")
                finally:
                    with self._lock:
                        self._renotify_inflight.discard(node)

            # its OWN thread: fencing is apiserver LIST+DELETE work
            # under retry deadlines — the 1s maintenance tick (expiry,
            # queue promotion, idle marking) must not stall on it
            threading.Thread(target=_run, daemon=True,
                             name=f"tpumounter-renotify-{node}").start()

    # -- expiry loop -----------------------------------------------------------

    def start(self) -> "AttachBroker":
        """Start the background tick loop (lease expiry + gauge
        refresh). Idempotent; tests drive :meth:`tick` directly."""
        if self._loop is None:
            self._stop.clear()
            self._loop = threading.Thread(target=self._run, daemon=True,
                                          name="tpumounter-broker")
            self._loop.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._loop is not None:
            self._loop.join(timeout=2.0)
            self._loop = None
        if self.store is not None:
            # stops the group-commit coalescer thread; deliberately no
            # final flush — stop() is also the crash path (kill()
            # semantics in the multi-master stack), and unflushed pending
            # is exactly the documented best-effort durability window
            self.store.stop()

    def _run(self) -> None:
        while not self._stop.wait(self.config.tick_interval_s):
            try:
                self.tick()
            except Exception:        # noqa: BLE001 — loop must survive
                logger.exception("broker tick failed")

    def tick(self, now: float | None = None) -> int:
        """One maintenance pass: reap expired leases (auto-detach through
        the worker path — OWNED shards only, a peer's leases are its
        leader's to reap), flush dirty store writes, mark idle leases,
        refresh gauges. Returns leases reaped."""
        self.ensure_rederived()
        if self.store is not None and self.election is not None:
            # a rehydration deferred by apiserver trouble (boot or
            # acquisition) is retried here — a dead leader's persisted
            # waiters must not stay stranded just because the first
            # read failed
            for shard in self.election.owned():
                with self._adopt_lock:
                    hydrated = shard in self._rehydrated_shards
                if not hydrated:
                    self._rehydrate_shard(shard)
        reaped = 0
        for lease in self.leases.expired(now):
            if not self._owns(lease.namespace):
                continue
            if self._reap(lease, now):
                reaped += 1
        if self.store is not None:
            # group-commit backstop: the coalescer thread normally
            # flushes within its bounded delay; the tick re-drives it so
            # a wedged/dead flusher degrades to tick-cadence durability
            # instead of never-durable (flush_pending never raises — the
            # fence surface is the on_fenced callback bound in bind_ha)
            self.store.flush_pending()
            try:
                self.store.flush_dirty()
                # batched heartbeat persistence (lease.py renew(): one
                # CAS per shard instead of one per renewal)
                self.leases.flush_renewals()
            except StoreFencedError as e:
                # a dirty replay bounced off the fence: same recovery as
                # a direct write — note the refused fence and demote,
                # and DON'T abort the tick (gauge refresh must still run)
                self._on_fenced(e)
            # cross-shard capacity pokes: send any nudge the request
            # paths marked pending (one stamp per tick regardless of
            # release rate), then one fresh read per owned shard for
            # INBOUND nudges — edge-triggered on the stamp
            if self.ring is not None and self.ring.shards > 1 \
                    and self.election is not None \
                    and self.election.enabled:
                if self._poke_pending:
                    self._poke_pending = False
                    self.store.poke_peers(set(self.election.owned()))
                # inbound check only while someone is actually parked:
                # with an empty queue the signal would be a no-op, and
                # one GET per owned shard per tick is real idle-state
                # apiserver load on a many-shard replica
                with self._lock:
                    parked = bool(self._waiters)
                if parked:
                    for shard in self.election.owned():
                        if self.store.check_poke(shard):
                            self.signal_capacity()
        if self._slice is not None:
            # stranded slice-txn adoption + slice gauges
            self._slice.tick()
        # idle-lease marking from the utilization feed (collector/
        # usage.py → fleet scrapes → here): leases whose chips showed
        # zero duty past the threshold become reclaim candidates
        self._mark_idle_leases()
        # dead-node re-notify: a fence or slice repair that failed on a
        # transient error (and any lease recorded after the death) must
        # not strand until the node recovers — every downstream path is
        # idempotent (fence currency-checks, repair guards in-flight +
        # budget), so re-running node-down handling per tick converges
        self._renotify_dead_nodes()
        with self._lock:
            self._refresh_queue_gauges_locked()
        self.leases.export_gauges()
        self._export_quota_gauges()
        return reaped

    def _mark_idle_leases(self) -> None:
        """Join the fleet's observed per-lease activity to the lease
        table: a lease whose chips have shown zero duty for
        ``idle_lease_s`` is marked idle (ONE ``idle_lease`` event per
        transition + a flight-recorder note; a burst of them dumps a
        bundle), cleared the moment its chips go busy again, and
        exported as ``tenant_chips_idle{tenant}``. Leases the feed has
        never observed are left alone — absence of telemetry must never
        read as idleness."""
        if self._activity_fn is None or self.config.idle_lease_s <= 0:
            return
        try:
            activity = self._activity_fn() or {}
        except Exception:    # noqa: BLE001 — telemetry must not kill
            logger.exception("utilization feed failed")     # the tick
            return
        idle_chips: dict[str, int] = {}
        for lease in self.leases.leases():
            if not self._owns(lease.namespace):
                continue
            act = activity.get((lease.namespace, lease.pod))
            if act is None:
                # telemetry gone (worker dead, sampler disabled, entry
                # aged out): a mark with no current evidence must not
                # keep steering preemption — clear it; never MARK on
                # absence either (absence of data is not idleness)
                lease.idle_since_unix = None
                continue
            if act.get("busy_chips", 0) > 0:
                lease.idle_since_unix = None
                continue
            ref = (act.get("last_busy_unix")
                   or act.get("first_seen_unix"))
            last_seen = act.get("last_seen_unix")
            if ref is None or last_seen is None:
                continue
            idle_for = last_seen - ref
            if idle_for < self.config.idle_lease_s:
                # under the threshold — including a chip that burst busy
                # BETWEEN scrapes (last_busy_unix advanced while the
                # instantaneous busy_chips read 0): a previously-idle
                # lease is active again, un-mark it
                lease.idle_since_unix = None
                continue
            if lease.idle_since_unix is None:
                # transition: the event names the reclaimable grant;
                # the flight note turns a BURST of tenants going idle
                # at once into one correlated bundle
                lease.idle_since_unix = ref
                EVENTS.emit("idle_lease", rid=lease.rid,
                            tenant=lease.tenant,
                            namespace=lease.namespace, pod=lease.pod,
                            chips=lease.chips, node=lease.node,
                            idle_s=round(idle_for, 1))
                RECORDER.note("idle_lease_burst", rid=lease.rid,
                              tenant=lease.tenant,
                              pod=f"{lease.namespace}/{lease.pod}",
                              idle_s=round(idle_for, 1))
                logger.warning(
                    "lease %s/%s (tenant=%s, %d chip(s)) idle for "
                    "%.0fs — reclaim candidate", lease.namespace,
                    lease.pod, lease.tenant, lease.chips, idle_for)
            idle_chips[lease.tenant] = (idle_chips.get(lease.tenant, 0)
                                        + lease.chips)
        # current tenants re-exported every pass (gauge = current
        # state); a tenant whose idle leases all resolved is zeroed
        # ONCE and then forgotten — not re-zeroed forever
        for tenant in set(self._idle_tenants) | set(idle_chips):
            REGISTRY.tenant_chips_idle.set(idle_chips.get(tenant, 0),
                                           tenant=tenant)
        self._idle_tenants = set(idle_chips)

    def _export_quota_gauges(self) -> None:
        """Per-tenant quota gauge (the usage side lives on the lease
        table): the pair lets dashboards and doctor compute quota
        pressure without knowing TPU_QUOTAS."""
        tenants = ({t for t in self.config.quotas if t != "*"}
                   | set(self.leases.usage()))
        for tenant in tenants:
            quota = self.quota(tenant)
            if quota is not None:
                REGISTRY.tenant_quota_chips.set(quota, tenant=tenant)

    def _reap(self, lease: Lease, now: float | None = None) -> bool:
        if self._detach_fn is None:
            return False
        current = self.leases.get(lease.namespace, lease.pod)
        if current is not lease:
            return False       # renewed/released since we sampled
        # same clock as tick()'s expired() scan — a simulated `now` must
        # not be second-guessed against the real one
        remaining = lease.expires_in_s(now)
        if remaining is None or remaining > 0:
            return False
        if lease.group and self._slice is not None:
            # slice-group expiry: the WHOLE slice detaches as a unit —
            # one expired member means the group's heartbeat stopped,
            # and a partial slice is useless to the world over it
            return self._reap_group(lease)
        cause = f"lease-expired:{lease.rid or '-'}"
        result = self._detach_fn(lease, cause, False)
        if result in _DETACH_GONE:
            if self.leases.drop(lease.namespace, lease.pod) is not None \
                    and result == "SUCCESS":
                REGISTRY.lease_expirations.inc()
                logger.info("lease expired: detached %s/%s (%d chips, "
                            "tenant=%s)", lease.namespace, lease.pod,
                            lease.chips, lease.tenant)
            EVENTS.emit("lease_expired", rid=lease.rid,
                        tenant=lease.tenant, namespace=lease.namespace,
                        pod=lease.pod, chips=lease.chips, result=result)
            self.signal_capacity(node=lease.node, chips=lease.chips)
            return True
        # busy devices / transport trouble: back off linearly, keep the
        # lease visible in /brokerz as stuck rather than silently immortal
        lease.reap_failures += 1
        if not lease.node:
            self._resolve_lease_node(lease)
        if lease.reap_failures >= consts.REAP_FENCE_AFTER \
                and self.node_state(lease.node) == "dead":
            # the worker is judged DEAD: "busy devices defer with
            # backoff" would retry it forever while the expired lease
            # holds tenant quota — fence instead (one-way eviction; the
            # zombie-rejoin convergence reclaims the node side)
            return self.fence_lease(lease, reason="reap-unreachable")
        lease.expires_at = time.monotonic() + min(
            30.0, 2.0 * lease.reap_failures)
        logger.warning("lease-expiry detach of %s/%s deferred (%s), "
                       "attempt %d", lease.namespace, lease.pod, result,
                       lease.reap_failures)
        return False

    def _reap_group(self, lease: Lease) -> bool:
        """Expire a whole slice group through the coordinator's fan-out
        (master/slicetxn.py ``detach_members``) — every member host, the
        cause stamped into each worker's audit trail."""
        members = self.leases.group_leases(lease.group)
        if not members:
            return False
        cause = f"lease-expired:{lease.rid or '-'}:group:{lease.group}"
        pods = [(member.namespace, member.pod) for member in members]
        ok, results = self._slice.detach_members(pods, cause=cause)
        gone = [r for r in results if r.result in _DETACH_GONE]
        dropped = 0
        for result in gone:
            if self.leases.drop(result.namespace,
                                result.pod) is not None:
                dropped += 1
        if dropped:
            REGISTRY.lease_expirations.inc(float(dropped))
            logger.info("slice group %s expired: detached %d member "
                        "host(s)", lease.group, dropped)
        EVENTS.emit("lease_expired", rid=lease.rid, tenant=lease.tenant,
                    namespace=lease.namespace, pod=lease.pod,
                    chips=sum(member.chips for member in members),
                    group=lease.group,
                    result="SUCCESS" if ok else "PARTIAL")
        if dropped:
            self.signal_capacity()
            self.poke_peers()
        if ok:
            return True
        # some member deferred (busy devices): back EVERY surviving
        # member off and retry next tick — the dropped ones are gone for
        # real, so the group shrinks toward resolved instead of
        # hammering the busy host once per member per tick
        for member in self.leases.group_leases(lease.group):
            member.reap_failures += 1
            member.expires_at = time.monotonic() + min(
                30.0, 2.0 * member.reap_failures)
        return False

    # -- introspection (/brokerz) ----------------------------------------------

    def snapshot(self) -> dict:
        self.ensure_rederived()
        now = time.monotonic()
        with self._lock:
            waiters = [{
                "tenant": w.tenant, "priority": w.priority,
                "chips": w.chips, "node": w.node, "rid": w.rid,
                "pod": f"{w.namespace}/{w.pod}",
                "waiting_s": round(now - w.enqueued_at, 3),
            } for w in sorted(self._waiters,
                              key=lambda w: w.enqueued_at)]
            depth = {priority: sum(1 for w in self._waiters
                                   if w.priority == priority)
                     for priority in consts.PRIORITIES}
        usage = self.leases.usage()
        idle_by_tenant: dict[str, int] = {}
        for lease in self.leases.leases():
            if lease.idle_since_unix is not None:
                idle_by_tenant[lease.tenant] = \
                    idle_by_tenant.get(lease.tenant, 0) + lease.chips
        tenants = {}
        for tenant in sorted(set(usage)
                             | {t for t in self.config.quotas
                                if t != "*"}):
            quota = self.quota(tenant)
            in_use = usage.get(tenant, 0)
            tenants[tenant] = {
                "in_use": in_use,
                "quota": quota,
                "cap": self.cap(tenant),
                "pct_of_quota": (round(100.0 * in_use / quota, 1)
                                 if quota else None),
            }
            if idle_by_tenant.get(tenant):
                # key present only when chips ARE idle — TPU_USAGE=0
                # (no idle marking) keeps the payload byte-for-byte
                tenants[tenant]["idle_chips"] = idle_by_tenant[tenant]
        oldest = max((w["waiting_s"] for w in waiters), default=0.0)
        ha: dict = {"enabled": False}
        if self.ring is not None or self.store is not None:
            ha = {
                "enabled": True,
                "shards": self.ring.shards if self.ring else 1,
                "election": (self.election.snapshot()
                             if self.election is not None
                             else {"enabled": False}),
                "store": (self.store.snapshot()
                          if self.store is not None else None),
            }
        fenced = self.fenced()
        return {
            "enabled": bool(self.config.quotas
                            or self.config.lease_ttl_s > 0
                            or self.config.queue_timeout_s > 0),
            # key present only once a fence actually happened — with the
            # node-failure subsystem idle (or off) the payload has no
            # such key
            **({"fenced": fenced} if fenced else {}),
            "ha": ha,
            "config": {
                "quotas": dict(self.config.quotas),
                "quota_burst": self.config.quota_burst,
                "lease_ttl_s": self.config.lease_ttl_s,
                "queue_timeout_s": self.config.queue_timeout_s,
                "queue_depth": self.config.queue_depth,
            },
            "tenants": tenants,
            "queue": {"depth": depth, "oldest_age_s": oldest,
                      "waiters": waiters},
            "leases": self.leases.snapshot(),
            "counters": {
                "preemptions": int(REGISTRY.preemptions.value()),
                "lease_expirations": int(
                    REGISTRY.lease_expirations.value()),
            },
        }
