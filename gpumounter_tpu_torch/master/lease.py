"""Lease-based attachment lifecycle (the broker's ownership ledger).

The reference treats an attach as a permanent grant: whoever called
``/addgpu`` first holds the chips until an explicit detach, so chips leak
to dead experiments forever (SURVEY.md §3: no lifecycle management). The
broker instead records every successful attach as a **lease**:

- the lease names the tenant, priority, chip count (and, when known, the
  exact device uuids), target node and request id;
- with ``TPU_LEASE_TTL_S`` set, the lease expires unless renewed
  (``POST /renew`` / ``tpumounterctl renew``), and the master's expiry
  loop auto-detaches the attachment — chips drain back to the warm pool
  instead of outliving their experiment;
- quota admission (master/admission.py) computes per-tenant usage from
  this table, so quotas track LIVE attachment state, not request history.

Master restart discipline mirrors ``worker/reconciler.py`` and the
journal replay: the table is **re-derived from cluster ground truth**
(the slave pods' owner labels + resource limits), never trusted from
memory or a sidecar file. Ground truth carries the owner namespace but
not the request-time tenant/priority headers, so re-derived leases
collapse to the namespace-default tenant and ``normal`` priority with a
fresh TTL — and crucially, a restart can never double-actuate: the
re-derived lease simply resumes the countdown.

With the HA plane bound (``LeaseTable.store``, ``master/store.py``)
every mutation of the table writes through to the intent store, so a
restarted or failed-over replica rehydrates exact leases (tenant,
priority, uuids) and needs the slave-pod derivation only for what the
store does not know.

This is the port of :mod:`gpumounter_tpu.master.lease`, with slice-group
membership (``Lease.group``, ``master/slicetxn.py``).
"""

from __future__ import annotations

import dataclasses
import threading
import time

from gpumounter_tpu_torch.k8s import objects
from gpumounter_tpu_torch.utils import consts
from gpumounter_tpu_torch.utils.errors import StoreFencedError
from gpumounter_tpu_torch.utils.events import EVENTS
from gpumounter_tpu_torch.utils.log import get_logger
from gpumounter_tpu_torch.utils.metrics import REGISTRY

logger = get_logger("master.lease")


@dataclasses.dataclass
class Lease:
    """One owner pod's live attachment, as the broker accounts it."""

    namespace: str
    pod: str
    tenant: str
    priority: str = consts.DEFAULT_PRIORITY
    chips: int = 0
    # Exact device uuids when the attach response carried them; empty for
    # re-derived leases (device ids are node-local kubelet knowledge).
    uuids: set[str] = dataclasses.field(default_factory=set)
    node: str = ""                  # "" until resolved (re-derived leases)
    rid: str = ""
    created_unix: float = dataclasses.field(default_factory=time.time)
    # Monotonic deadline; None = never expires (TTL 0).
    expires_at: float | None = None
    renewals: int = 0
    # Consecutive failed reap attempts (busy devices / transport trouble):
    # the expiry loop backs off instead of hammering, and /brokerz shows
    # the lease as stuck rather than silently immortal.
    reap_failures: int = 0
    rederived: bool = False
    # Slice-group membership (master/slicetxn.py): leases sharing a group
    # id form ONE multi-host slice and renew/expire/preempt as a unit —
    # a half-expired slice is useless to the world spanning it.
    # "" = a plain single-host attachment.
    group: str = ""
    # Idle marking (the utilization plane: collector/usage.py →
    # master/fleet.py → broker tick): wall-clock time the broker
    # deemed this lease idle — its chips showed zero observed duty for
    # TPU_IDLE_LEASE_S. None = busy, or no utilization telemetry
    # flowing. Idle leases are preferred preemption victims and doctor
    # WARNs on them.
    idle_since_unix: float | None = None

    @property
    def key(self) -> tuple[str, str]:
        return (self.namespace, self.pod)

    def expires_in_s(self, now: float | None = None) -> float | None:
        if self.expires_at is None:
            return None
        return self.expires_at - (time.monotonic() if now is None else now)

    def priority_rank(self) -> int:
        try:
            return consts.PRIORITIES.index(self.priority)
        except ValueError:
            return consts.PRIORITIES.index(consts.DEFAULT_PRIORITY)

    def to_json(self) -> dict:
        out = {
            "namespace": self.namespace, "pod": self.pod,
            "tenant": self.tenant, "priority": self.priority,
            "chips": self.chips, "node": self.node, "rid": self.rid,
            "created_unix": round(self.created_unix, 3),
            "renewals": self.renewals,
        }
        remaining = self.expires_in_s()
        out["expires_in_s"] = (None if remaining is None
                               else round(remaining, 1))
        if self.uuids:
            out["uuids"] = sorted(self.uuids)
        if self.reap_failures:
            out["reap_failures"] = self.reap_failures
        if self.group:
            out["group"] = self.group
        if self.rederived:
            out["rederived"] = True
        if self.idle_since_unix is not None:
            # absent entirely while busy (or with no utilization
            # telemetry), so TPU_USAGE=0 keeps /brokerz byte-for-byte
            out["idle"] = True
            out["idle_s"] = round(time.time() - self.idle_since_unix, 1)
        return out


class LeaseTable:
    """Thread-safe ledger of live leases, keyed by (namespace, pod).

    A pod accumulating several attaches (single-mount increments) keeps
    ONE lease whose chip set is the union — preemption and expiry operate
    at attachment granularity, and the worker detaches per owner pod.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._leases: dict[tuple[str, str], Lease] = {}
        # every tenant ever exported, so vanished tenants' gauges reset
        # to 0 instead of freezing at their last value
        self._known_tenants: set[str] = set()
        # Declarative intent store (master/store.py): when bound, EVERY
        # mutation of this table writes through (the store lint pins
        # that no mutation site escapes), so a restarted or failed-over
        # replica rehydrates exact leases instead of the collapsed
        # slave-pod derivation. None = process-resident semantics.
        self.store = None
        # Called with the StoreFencedError when a write proves this
        # replica was deposed (the broker binds election demotion).
        self.on_fenced = None
        # lease keys renewed since the last flush_renewals: heartbeat
        # persistence is batched through the broker tick, not written
        # synchronously per renew (see renew())
        self._renew_dirty: set[tuple[str, str]] = set()

    # -- store write-through ---------------------------------------------------

    def _store_put(self, lease: Lease) -> None:
        if self.store is None:
            return
        from gpumounter_tpu_torch.master.store import LeaseRecord
        try:
            self.store.put_lease(LeaseRecord.from_lease(lease))
        except StoreFencedError as e:
            logger.warning("lease write fenced: %s", e)
            if self.on_fenced is not None:
                self.on_fenced(e)

    def _store_del(self, namespace: str, pod: str) -> None:
        if self.store is None:
            return
        try:
            self.store.delete_lease(namespace, pod)
        except StoreFencedError as e:
            logger.warning("lease delete fenced: %s", e)
            if self.on_fenced is not None:
                self.on_fenced(e)

    # -- write side ------------------------------------------------------------

    def record(self, namespace: str, pod: str, tenant: str, priority: str,
               uuids: list[str], chips: int = 0, node: str = "",
               rid: str = "", ttl_s: float = 0.0,
               group: str = "") -> Lease:
        """Record a successful attach; merges into the pod's existing
        lease (chips union, refreshed expiry, the NEW tenant/priority win
        — the latest grant is who the pod answers to now). ``group``
        stamps slice-group membership (master/slicetxn.py)."""
        deadline = (time.monotonic() + ttl_s) if ttl_s > 0 else None
        with self._lock:
            lease = self._leases.get((namespace, pod))
            if lease is None:
                lease = Lease(namespace, pod, tenant, priority,
                              chips=chips or len(uuids), uuids=set(uuids),
                              node=node, rid=rid, expires_at=deadline,
                              group=group)
                self._leases[(namespace, pod)] = lease
            else:
                lease.tenant = tenant
                lease.priority = priority
                # Grow by the chips NOT already accounted: a gateway retry
                # that resumed a prior attempt returns the same uuids and
                # must not double-count them; an attach layered on a
                # re-derived lease (uuids unknown) adds its full set.
                added = set(uuids) - lease.uuids
                lease.uuids |= set(uuids)
                lease.chips += len(added) if uuids else chips
                lease.node = node or lease.node
                lease.rid = rid or lease.rid
                lease.expires_at = deadline
                lease.rederived = False
                lease.group = group or lease.group
            self._known_tenants.add(tenant)
        self._store_put(lease)
        self.export_gauges()
        EVENTS.emit("lease_record", rid=rid, tenant=tenant,
                    namespace=namespace, pod=pod, chips=lease.chips,
                    node=node, ttl_s=ttl_s)
        return lease

    def renew(self, namespace: str, pod: str, ttl_s: float) -> Lease:
        """Push the lease's expiry ``ttl_s`` from now. Raises KeyError for
        pods the broker holds no lease for."""
        with self._lock:
            lease = self._leases[(namespace, pod)]
            lease.expires_at = ((time.monotonic() + ttl_s)
                                if ttl_s > 0 else None)
            lease.renewals += 1
            lease.reap_failures = 0
            first = lease.renewals == 1
            # Heartbeats are the highest-frequency mutation: a
            # synchronous CAS per renew would serialize EVERY lease in a
            # shard on one ConfigMap's write stream. Batched instead: the
            # broker tick flushes pending renewals as ONE CAS per shard
            # (flush_renewals); a failover inside that window rehydrates
            # an expiry stale by at most one tick + the renew cadence.
            self._renew_dirty.add((namespace, pod))
        # renewals are heartbeats: emitting every one would cycle the
        # bounded event ring in minutes and evict the admit/preempt
        # evidence it exists to hold (same reason the gateway keeps
        # /renew out of the trace ring). The FIRST renewal proves the
        # heartbeat path works; the running count lives in /brokerz.
        if first:
            EVENTS.emit("lease_renew", rid=lease.rid, tenant=lease.tenant,
                        namespace=namespace, pod=pod, chips=lease.chips,
                        ttl_s=ttl_s, renewals=lease.renewals)
        return lease

    def release(self, namespace: str, pod: str,
                uuids: list[str] | None = None) -> int:
        """Account a successful detach. ``uuids=None`` / empty = the whole
        attachment; a subset shrinks the lease (whole-slave-pod
        granularity is the worker's job — on SUCCESS the requested uuids
        were removed exactly). Returns the chips released."""
        with self._lock:
            lease = self._leases.get((namespace, pod))
            if lease is None:
                return 0
            gone = False
            if not uuids:
                released = lease.chips
                del self._leases[(namespace, pod)]
                gone = True
            else:
                requested = set(uuids)
                if lease.uuids:
                    released = len(lease.uuids & requested)
                else:
                    # re-derived lease: uuids unknown, trust the count
                    released = min(len(requested), lease.chips)
                lease.uuids -= requested
                lease.chips = max(lease.chips - released, len(lease.uuids))
                if lease.chips <= 0:
                    del self._leases[(namespace, pod)]
                    gone = True
        if gone:
            self._store_del(namespace, pod)
        elif released:
            self._store_put(lease)
        self.export_gauges()
        if released:
            EVENTS.emit("lease_release", rid=lease.rid,
                        tenant=lease.tenant, namespace=namespace,
                        pod=pod, chips=released)
        return released

    def drop(self, namespace: str, pod: str,
             expected: Lease | None = None) -> Lease | None:
        """Remove the key's lease (preemption, expiry, fencing).
        ``expected`` makes it a compare-and-pop: the eviction lands only
        if the table still holds THAT lease object — a caller that
        decided on a snapshot (fencing, after its slow apiserver cleanup)
        must not evict a lease re-granted in between."""
        with self._lock:
            if expected is not None \
                    and self._leases.get((namespace, pod)) is not expected:
                return None
            lease = self._leases.pop((namespace, pod), None)
        if lease is not None:
            self._store_del(namespace, pod)
        self.export_gauges()
        if lease is not None:
            EVENTS.emit("lease_drop", rid=lease.rid, tenant=lease.tenant,
                        namespace=namespace, pod=pod, chips=lease.chips)
        return lease

    # -- read side -------------------------------------------------------------

    def get(self, namespace: str, pod: str) -> Lease | None:
        with self._lock:
            return self._leases.get((namespace, pod))

    def leases(self) -> list[Lease]:
        with self._lock:
            return list(self._leases.values())

    def group_leases(self, group: str) -> list[Lease]:
        """Every member lease of a slice group — the unit renewal,
        expiry and preemption operate on (ordered for stable output)."""
        if not group:
            return []
        with self._lock:
            return sorted((lease for lease in self._leases.values()
                           if lease.group == group),
                          key=lambda le: (le.namespace, le.pod))

    def groups(self) -> dict[str, list[Lease]]:
        """{group id: member leases} across the table (the /slicez
        view's source of truth — membership IS the lease table, so a
        detached member leaves its group with no bookkeeping to desync)."""
        with self._lock:
            out: dict[str, list[Lease]] = {}
            for lease in self._leases.values():
                if lease.group:
                    out.setdefault(lease.group, []).append(lease)
        for members in out.values():
            members.sort(key=lambda le: (le.namespace, le.pod))
        return out

    def usage(self) -> dict[str, int]:
        """Live chips per tenant — the quantity quotas are checked
        against."""
        with self._lock:
            out: dict[str, int] = {}
            for lease in self._leases.values():
                out[lease.tenant] = out.get(lease.tenant, 0) + lease.chips
            return out

    def tenant_usage(self, tenant: str) -> int:
        return self.usage().get(tenant, 0)

    def expired(self, now: float | None = None) -> list[Lease]:
        now = time.monotonic() if now is None else now
        with self._lock:
            return [lease for lease in self._leases.values()
                    if lease.expires_at is not None
                    and lease.expires_at <= now]

    def export_gauges(self) -> None:
        usage = self.usage()
        counts: dict[str, int] = {}
        with self._lock:
            for lease in self._leases.values():
                counts[lease.tenant] = counts.get(lease.tenant, 0) + 1
            self._known_tenants |= set(usage)
            known = set(self._known_tenants)
        for tenant in known:
            REGISTRY.active_leases.set(counts.get(tenant, 0), tenant=tenant)
            REGISTRY.tenant_chips_in_use.set(usage.get(tenant, 0),
                                             tenant=tenant)

    # -- restart re-derivation -------------------------------------------------

    def rederive(self, kube, pool_namespace: str, resource_name: str,
                 ttl_s: float = 0.0) -> int:
        """Rebuild the table from cluster ground truth: the owner-labelled
        slave pods in the pool namespace (warm pods are unowned by design
        and carry no grant). Chip counts come from each slave pod's
        resource limit; the tenant collapses to the owner namespace and
        priority to ``normal`` (the cluster does not record request-time
        headers); re-derived leases get a fresh TTL — resuming the
        countdown, never insta-expiring into a surprise detach."""
        selector = (f"{consts.SLAVE_POD_LABEL_KEY}="
                    f"{consts.SLAVE_POD_LABEL_VALUE}")
        pods = kube.list_pods(pool_namespace, label_selector=selector)
        derived: dict[tuple[str, str], Lease] = {}
        for pod in pods:
            labels = objects.labels(pod)
            if labels.get(consts.WARM_POD_LABEL_KEY) == \
                    consts.WARM_POD_LABEL_VALUE:
                continue
            owner = labels.get(consts.OWNER_POD_LABEL_KEY)
            owner_ns = labels.get(consts.OWNER_NAMESPACE_LABEL_KEY)
            if not owner or not owner_ns:
                continue
            chips = objects.resource_limit(pod, resource_name)
            if chips <= 0:
                continue
            node = (pod.get("spec", {}).get("nodeSelector", {})
                    or {}).get("kubernetes.io/hostname", "")
            lease = derived.get((owner_ns, owner))
            if lease is None:
                lease = derived[(owner_ns, owner)] = Lease(
                    owner_ns, owner, tenant=owner_ns,
                    rid=labels.get(consts.REQUEST_ID_LABEL_KEY, ""),
                    node=node, rederived=True,
                    expires_at=((time.monotonic() + ttl_s)
                                if ttl_s > 0 else None))
            lease.chips += chips
            lease.node = lease.node or node
        with self._lock:
            # Leases recorded in THIS process are fresher than the derived
            # view (exact uuids, request-time tenant/priority) and must
            # survive a deferred re-derivation that finally succeeded —
            # derivation only fills what memory doesn't know.
            derived.update(self._leases)
            self._leases = derived
            self._known_tenants |= {le.tenant for le in derived.values()}
        self._store_sync()
        self.export_gauges()
        if derived:
            logger.info("lease table re-derived from cluster ground "
                        "truth: %d lease(s), %d chip(s)", len(derived),
                        sum(le.chips for le in derived.values()))
        return len(derived)

    def evict_where(self, pred) -> int:
        """In-memory eviction WITHOUT store deletes — shard hand-off:
        the evicted leases' records belong to the shard's new leader, so
        deleting them from the store would destroy the state it is about
        to rehydrate."""
        with self._lock:
            doomed = [key for key, lease in self._leases.items()
                      if pred(lease)]
            for key in doomed:
                del self._leases[key]
        self.export_gauges()
        return len(doomed)

    def merge_records(self, records) -> int:
        """Rehydrate persisted lease records (master/store.py) into the
        table; in-process leases win the merge — the store is the ground
        truth for a FRESH replica, not newer than live memory. No store
        write-back: the records came from there."""
        added = 0
        with self._lock:
            for record in records:
                if record.key not in self._leases:
                    self._leases[record.key] = record.to_lease()
                    self._known_tenants.add(record.tenant)
                    added += 1
        self.export_gauges()
        return added

    def flush_renewals(self) -> int:
        """Persist every lease renewed since the last flush, batched to
        ONE CAS per shard (the broker tick drives this). A key whose
        lease vanished since the renewal (released/dropped — both wrote
        their own delete) is simply skipped. Returns records flushed."""
        if self.store is None:
            return 0
        from gpumounter_tpu_torch.master.store import LeaseRecord
        with self._lock:
            keys = list(self._renew_dirty)
            self._renew_dirty.clear()
            leases = [self._leases[key] for key in keys
                      if key in self._leases]
        if not leases:
            return 0
        records = [LeaseRecord.from_lease(lease) for lease in leases]
        try:
            self.store.put_leases(records)
        except StoreFencedError as e:
            logger.warning("renewal flush fenced: %s", e)
            if self.on_fenced is not None:
                self.on_fenced(e)
            return 0
        return len(records)

    def _store_sync(self) -> None:
        """Write every held lease through to the store (owned shards
        only — the store skips foreign shards itself), batched to ONE
        CAS per shard: re-derivation may have discovered leases that
        predate the store. Each lease is re-checked to still be the
        table's CURRENT entry right before serialization — a concurrent
        release/drop between the snapshot and here must not be
        resurrected by a stale put."""
        if self.store is None:
            return
        from gpumounter_tpu_torch.master.store import LeaseRecord
        records = []
        for lease in self.leases():
            with self._lock:
                current = self._leases.get((lease.namespace, lease.pod))
            if current is not lease:
                continue
            records.append(LeaseRecord.from_lease(lease))
        if not records:
            return
        try:
            self.store.put_leases(records)
        except StoreFencedError as e:
            logger.warning("lease sync fenced: %s", e)
            if self.on_fenced is not None:
                self.on_fenced(e)

    def snapshot(self) -> dict:
        leases = sorted(self.leases(),
                        key=lambda le: (le.namespace, le.pod))
        return {
            "count": len(leases),
            "usage": self.usage(),
            "leases": [lease.to_json() for lease in leases],
        }
