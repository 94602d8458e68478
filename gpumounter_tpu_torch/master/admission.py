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

This is the port of :mod:`gpumounter_tpu.master.admission` on the
single-master path, with every plane the port does not run yet in the
off state the control plane defines for it: no HA binding (no intent
store, shard ring or election, so no waiter persistence or adoption), no
slice groups or gang waiters (``master/slicetxn.py``), no node-health
fencing (``TPU_NODE_HEALTH=0``) and no defragmenter. Those hooks arrive
with their planes (ROADMAP Queue 1 item 12).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time

from gpumounter_tpu_torch.k8s import objects
from gpumounter_tpu_torch.master.lease import Lease, LeaseTable
from gpumounter_tpu_torch.master.waiterindex import WaiterQueue, _rank
from gpumounter_tpu_torch.utils import consts
from gpumounter_tpu_torch.utils.errors import (K8sApiError, QueueFullError,
                                               QuotaExceededError)
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
    # Idle-lease threshold: zero observed duty for this long marks the
    # lease idle (event + doctor WARN + preferred preemption victim).
    # Only acts while worker utilization telemetry is flowing
    # (bind_utilization + TPU_USAGE on), so the default is inert
    # without the sampler.
    idle_lease_s: float = consts.DEFAULT_IDLE_LEASE_S
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
                   idle_lease_s=settings.idle_lease_s,
                   waiter_index=settings.waiter_index,
                   pool_namespace=settings.pool_namespace,
                   resource_name=settings.resource_name)


class _Waiter:
    """One parked attach request. ``tried_gen`` is the last capacity
    generation this waiter already retried at — the baton-passing that
    lets a wrong-node waiter hand the wakeup to the next in line instead
    of swallowing it. ``deadline`` is its absolute give-up time."""

    __slots__ = ("tenant", "priority", "chips", "node", "rid",
                 "namespace", "pod", "enqueued_at", "event", "tried_gen",
                 "preempted", "deadline")

    def __init__(self, tenant: str, priority: str, chips: int, node: str,
                 rid: str, namespace: str, pod: str, gen: int,
                 timeout_s: float = 0.0):
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
        self.deadline = self.enqueued_at + timeout_s


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
        # Utilization feed (bind_utilization): zero-arg callable →
        # {(namespace, pod): activity dict} from the fleet aggregator's
        # /utilz scrapes. None = no telemetry, no idle marking — the
        # pre-sampler behavior exactly.
        self._activity_fn = None
        # tenants ever exported on tenant_chips_idle, so a tenant whose
        # idle leases resolved resets to 0 instead of freezing
        self._idle_tenants: set[str] = set()

    def bind(self, detach_fn) -> None:
        """``detach_fn(lease, cause, force) -> result name`` — the
        gateway's worker-path detach, used for preemption and expiry."""
        self._detach_fn = detach_fn

    def bind_utilization(self, activity_fn) -> None:
        """Wire the fleet aggregator's per-lease activity feed
        (``FleetAggregator.lease_activity``): the broker tick joins it
        to the lease table to mark leases idle past
        ``TPU_IDLE_LEASE_S`` — the reclaim signal and the preemption
        victim preference."""
        self._activity_fn = activity_fn

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
            try:
                self.leases.rederive(self.kube, self.config.pool_namespace,
                                     self.config.resource_name,
                                     self.config.lease_ttl_s)
            except K8sApiError as e:
                logger.warning("lease re-derivation deferred (apiserver "
                               "unreachable): %s", e)
                return
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
               attempt_fn,
               timeout_s: float | None = None) -> tuple[int, dict]:
        """Admission-gated attach: quota check, one attempt, then (when
        queueing is enabled) park in the contention queue until capacity
        frees, the deadline passes, or — for ``high`` — a preemption
        makes room. Successful attaches are recorded as leases. The
        admitted chips are held as an in-flight reservation until this
        call returns, so concurrent same-tenant arrivals see them.
        ``timeout_s`` overrides the configured queue deadline."""
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
                                       status, payload, gen0, timeout)

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
                       gen0: int, timeout: float) -> tuple[int, dict]:
        # ``timeout`` was resolved (and gated > 0) by attach() — a second
        # default-resolution here could silently diverge from that gate
        with self._lock:
            depth = self._check_queue_full_locked(tenant, priority,
                                                  chips, rid)
            waiter = _Waiter(tenant, priority, chips, node, rid,
                             namespace, pod, gen=gen0, timeout_s=timeout)
            self._waiters.add(waiter)
            if self._gen != gen0:
                # capacity freed between the failed attempt and the
                # enqueue — that wakeup is gone; self-arm instead of
                # sleeping the full deadline next to free chips
                waiter.tried_gen = self._gen
                waiter.event.set()
            self._refresh_queue_gauges_locked()
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

    def _check_queue_full_locked(self, tenant: str, priority: str,
                                 chips: int, rid: str) -> int:
        """The queue-full gate: returns the current same-priority depth, or raises
        :class:`QueueFullError` with the derived hint."""
        depth = self._waiters.count(priority)
        if depth >= self.config.queue_depth:
            REGISTRY.admission_decisions.inc(tenant=tenant,
                                             outcome="queue_full")
            EVENTS.emit("queue_full", rid=rid, tenant=tenant,
                        chips=chips, priority=priority, depth=depth)
            raise QueueFullError(
                priority, depth,
                retry_after_s=self._queue_full_hint_locked(priority))
        return depth

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
        """
        self.ensure_rederived()
        ttl = self.config.lease_ttl_s if ttl_s is None else ttl_s
        return self.leases.renew(namespace, pod, ttl)

    def release(self, namespace: str, pod: str,
                uuids: list[str] | None = None) -> None:
        """Account an owner-initiated detach and wake the queue — even
        without a lease on record (pre-broker attach), freed chips are
        freed chips."""
        lease = self.leases.get(namespace, pod)
        released = self.leases.release(namespace, pod, uuids)
        # locality hints from the lease the detach resolved against; a
        # pre-broker attach (no lease) signals globally as before
        self.signal_capacity(
            node=lease.node if lease is not None else None,
            chips=released)

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

    def _run(self) -> None:
        while not self._stop.wait(self.config.tick_interval_s):
            try:
                self.tick()
            except Exception:        # noqa: BLE001 — loop must survive
                logger.exception("broker tick failed")

    def tick(self, now: float | None = None) -> int:
        """One maintenance pass: reap expired leases (auto-detach through
        the worker path), mark idle leases, refresh gauges. Returns
        leases reaped."""
        self.ensure_rederived()
        reaped = 0
        for lease in self.leases.expired(now):
            if self._reap(lease, now):
                reaped += 1
        # idle-lease marking from the utilization feed (collector/
        # usage.py → fleet scrapes → here): leases whose chips showed
        # zero duty past the threshold become reclaim candidates
        self._mark_idle_leases()
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
        lease.expires_at = time.monotonic() + min(
            30.0, 2.0 * lease.reap_failures)
        logger.warning("lease-expiry detach of %s/%s deferred (%s), "
                       "attempt %d", lease.namespace, lease.pod, result,
                       lease.reap_failures)
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
        return {
            "enabled": bool(self.config.quotas
                            or self.config.lease_ttl_s > 0
                            or self.config.queue_timeout_s > 0),
            "ha": {"enabled": False},
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
