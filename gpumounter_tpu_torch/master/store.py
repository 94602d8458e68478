"""Declarative intent store: broker state as cluster ground truth (the
port of :mod:`gpumounter_tpu.master.store`).

Lifecycle state belonging to a controller must be *declaratively
persisted* so any replica can re-derive it, not resident in one process's
memory: leases can be re-derived from slave-pod labels after a restart,
but a parked queue entry (the *intent* to attach once capacity frees)
dies with the master unless it is written down.

This store persists both as annotation records on per-shard state
ConfigMaps (``tpu-mounter-broker-state-<shard>`` in the pool namespace),
written through :class:`~gpumounter_tpu_torch.k8s.client.KubeClient`
(REST and fake alike) with resourceVersion compare-and-swap:

- every record is one annotation — key ``tpumounter.io/l-<digest>`` /
  ``tpumounter.io/w-<digest>`` (identity lives IN the record; annotation
  names are length-capped), value the record's canonical JSON;
- a write reads the shard map, checks the **fencing token**
  (``tpumounter.io/fence``), and merge-patches with the observed
  resourceVersion as precondition. A concurrent writer makes the CAS
  409; we re-read and retry. A *deposed* leader (its token below the
  recorded fence) gets :class:`StoreFencedError` and must demote — the
  split-brain impossibility argument in docs/guide/HA.md;
- a failed write (apiserver unreachable) parks the mutation in a dirty
  queue retried by the broker tick; ``tpumounter_store_lag`` is the age
  of the oldest unflushed mutation, and a torn record (crash mid-write)
  fails JSON-parse on rehydrate and degrades to slave-pod re-derivation
  instead of poisoning the table.

Rehydration (:meth:`IntentStore.rehydrate`) returns the shard's lease
and waiter records; the broker merges leases (in-process state wins) and
adopts waiters — re-running each parked attach under its original
request id, so the worker's per-rid idempotent adoption guarantees zero
double-actuation even when the dead leader's attempt had already landed.

The records, the ConfigMap and annotation names and the fence discipline
are the control plane's, so either package's replica rehydrates what the
other wrote. The one field named for the device is the slice and defrag
records' ``gpus_per_host`` (the control plane's ``tpus_per_host``); the
defrag record is a codec only here, for the defragmenter is not ported.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import threading
import time
from typing import Any

from gpumounter_tpu_torch.utils import consts
from gpumounter_tpu_torch.utils.errors import K8sApiError, StoreFencedError
from gpumounter_tpu_torch.utils.log import get_logger
from gpumounter_tpu_torch.utils.metrics import REGISTRY

logger = get_logger("master.store")

# CAS attempts per write before the mutation parks in the dirty queue: a
# conflict means another replica just wrote, so the retry re-reads and
# almost always lands; more than a handful losing streaks means the
# apiserver is the problem, not the race.
CAS_ATTEMPTS = 6


def _digest(identity: str) -> str:
    return hashlib.sha256(identity.encode()).hexdigest()[:16]


def _canonical(obj: dict) -> str:
    """One byte-stable serialization (sorted keys, no whitespace): the
    round-trip tests pin serialize→CAS-write→rehydrate byte-identity."""
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


@dataclasses.dataclass
class LeaseRecord:
    """A lease as persisted: wall-clock expiry (monotonic deadlines are
    process-local and meaningless to the replica that rehydrates)."""

    namespace: str
    pod: str
    tenant: str
    priority: str = consts.DEFAULT_PRIORITY
    chips: int = 0
    uuids: list[str] = dataclasses.field(default_factory=list)
    node: str = ""
    rid: str = ""
    created_unix: float = 0.0
    expires_unix: float | None = None   # None = never expires
    renewals: int = 0
    # Slice-group membership (master/slicetxn.py); "" = single-host.
    group: str = ""

    @property
    def key(self) -> tuple[str, str]:
        return (self.namespace, self.pod)

    @property
    def annotation_key(self) -> str:
        return (consts.STORE_LEASE_ANNOTATION_PREFIX
                + _digest(f"{self.namespace}/{self.pod}"))

    def to_json(self) -> str:
        return _canonical(dataclasses.asdict(self))

    @classmethod
    def from_json(cls, text: str) -> "LeaseRecord":
        obj = json.loads(text)
        record = cls(**obj)
        if not record.namespace or not record.pod:
            raise ValueError(f"lease record missing identity: {text!r}")
        return record

    @classmethod
    def from_lease(cls, lease) -> "LeaseRecord":
        remaining = lease.expires_in_s()
        return cls(namespace=lease.namespace, pod=lease.pod,
                   tenant=lease.tenant, priority=lease.priority,
                   chips=lease.chips, uuids=sorted(lease.uuids),
                   node=lease.node, rid=lease.rid,
                   created_unix=round(lease.created_unix, 3),
                   expires_unix=(None if remaining is None
                                 else round(time.time() + remaining, 3)),
                   renewals=lease.renewals, group=lease.group)

    def to_lease(self):
        from gpumounter_tpu_torch.master.lease import Lease
        expires_at = None
        if self.expires_unix is not None:
            expires_at = time.monotonic() + (self.expires_unix
                                             - time.time())
        return Lease(self.namespace, self.pod, self.tenant, self.priority,
                     chips=self.chips, uuids=set(self.uuids),
                     node=self.node, rid=self.rid,
                     created_unix=self.created_unix,
                     expires_at=expires_at, renewals=self.renewals,
                     group=self.group)


@dataclasses.dataclass
class WaiterRecord:
    """A parked queue entry as persisted: everything a surviving replica
    needs to re-run the attach — target pod, chip count, the entire-mount
    flag, and the ORIGINAL request id (the idempotency key that makes the
    re-run adopt rather than double-attach)."""

    rid: str
    namespace: str
    pod: str
    tenant: str
    priority: str = consts.DEFAULT_PRIORITY
    chips: int = 0
    node: str = ""
    entire: bool = False
    enqueued_unix: float = 0.0
    deadline_unix: float = 0.0

    @property
    def annotation_key(self) -> str:
        return consts.STORE_WAITER_ANNOTATION_PREFIX + _digest(self.rid)

    def to_json(self) -> str:
        return _canonical(dataclasses.asdict(self))

    @classmethod
    def from_json(cls, text: str) -> "WaiterRecord":
        obj = json.loads(text)
        record = cls(**obj)
        if not record.rid or not record.pod:
            raise ValueError(f"waiter record missing identity: {text!r}")
        return record


@dataclasses.dataclass
class SliceTxnRecord:
    """A multi-host slice transaction's intent, written BEFORE the
    fan-out touches any host (master/slicetxn.py). ``committed`` lists
    the "namespace/pod" members whose hosts already hold GPUs under the
    txn — the per-host commit markers. A record still present at
    rehydration is a transaction its writer never resolved."""

    txn_id: str
    rid: str
    tenant: str
    priority: str = consts.DEFAULT_PRIORITY
    # ["namespace/pod", ...] — flat strings so the record's canonical
    # JSON stays list-of-strings (annotation values are plain text).
    pods: list[str] = dataclasses.field(default_factory=list)
    gpus_per_host: int = 0
    committed: list[str] = dataclasses.field(default_factory=list)
    created_unix: float = 0.0
    deadline_unix: float = 0.0
    # Lease group the commit joins ("" = the txn id itself — a fresh
    # slice; a resize delta txn names the EXISTING group here).
    group: str = ""

    @property
    def namespace(self) -> str:
        return self.pods[0].split("/", 1)[0] if self.pods else ""

    def members(self) -> list[tuple[str, str]]:
        return [tuple(p.split("/", 1)) for p in self.pods if "/" in p]

    @property
    def annotation_key(self) -> str:
        return consts.STORE_SLICE_ANNOTATION_PREFIX + _digest(self.txn_id)

    def to_json(self) -> str:
        return _canonical(dataclasses.asdict(self))

    @classmethod
    def from_json(cls, text: str) -> "SliceTxnRecord":
        obj = json.loads(text)
        record = cls(**obj)
        if not record.txn_id or not record.pods:
            raise ValueError(f"slice txn record missing identity: {text!r}")
        return record


@dataclasses.dataclass
class SliceBarrierRecord:
    """A slice group's re-federation barrier (master/slicetxn.py), armed
    when the mesh generation bumps and updated with the frozen plan when
    every member of the NEW generation has re-federated."""

    group: str
    generation: int
    # ordered "namespace/pod" membership of the NEW generation — the
    # order IS the federation plan's process-id assignment
    members: list[str] = dataclasses.field(default_factory=list)
    created_unix: float = 0.0
    # set once the barrier COMPLETED: the federation plan members poll for
    plan: dict = dataclasses.field(default_factory=dict)
    completed_unix: float = 0.0

    @property
    def namespace(self) -> str:
        return self.members[0].split("/", 1)[0] if self.members else ""

    @property
    def annotation_key(self) -> str:
        return consts.STORE_BARRIER_ANNOTATION_PREFIX + _digest(self.group)

    def to_json(self) -> str:
        return _canonical(dataclasses.asdict(self))

    @classmethod
    def from_json(cls, text: str) -> "SliceBarrierRecord":
        obj = json.loads(text)
        record = cls(**obj)
        if not record.group or not record.members:
            raise ValueError(f"barrier record missing identity: {text!r}")
        return record


@dataclasses.dataclass
class DefragMoveRecord:
    """One planned defrag migration (master/defrag.py), journaled BEFORE
    the actuator touches anything. ``state`` says how far it got:
    "planned" = computed only (plan mode, or act mode pre-actuation —
    safe to drop, the next tick re-plans); "acting" = a grow-first slice
    txn was (or was about to be) issued under ``rid``. A record still
    present at rehydration is a move whose writer died mid-flight: the
    adopting leader compares the group's membership against ``hosts``
    (the pre-move member count) and either finishes the detach of the
    old member (grow landed — the new placement) or drops the record
    with the group intact (grow never landed / rolled back — the old
    placement). Either way no group is ever left half-moved."""

    group: str
    namespace: str
    pod: str                 # the member being moved off src_node
    rid: str = ""
    tenant: str = ""
    priority: str = consts.DEFAULT_PRIORITY
    gpus_per_host: int = 0
    hosts: int = 0           # member count BEFORE the move (adopt key)
    src_node: str = ""
    gain: int = 0
    created_unix: float = 0.0
    state: str = "planned"   # "planned" | "acting"

    @property
    def annotation_key(self) -> str:
        return (consts.STORE_DEFRAG_ANNOTATION_PREFIX
                + _digest(f"{self.group}/{self.namespace}/{self.pod}"))

    def to_json(self) -> str:
        return _canonical(dataclasses.asdict(self))

    @classmethod
    def from_json(cls, text: str) -> "DefragMoveRecord":
        obj = json.loads(text)
        record = cls(**obj)
        if not record.group or not record.pod:
            raise ValueError(f"defrag record missing identity: {text!r}")
        return record


class IntentStore:
    """Write-through persistence of broker intent, sharded by namespace.

    ``token_fn(shard) -> int | None`` supplies the election fencing token
    (None = election off, fence checks skipped). All writes are
    best-effort durable: an apiserver outage parks mutations in a dirty
    queue (flushed by the broker tick) rather than failing admissions —
    losing a store write degrades to single-master semantics for that
    record, never to a refused attach.
    """

    def __init__(self, kube, ring, namespace: str | None = None,
                 election=None, group_commit_delay_s: float = 0.0,
                 group_commit_max_keys: int =
                 consts.STORE_GROUP_COMMIT_MAX_KEYS):
        from gpumounter_tpu_torch.master.election import NullElection
        self.kube = kube
        self.ring = ring
        self.namespace = namespace or consts.DEFAULT_POOL_NAMESPACE
        # Election supplies ownership + fencing tokens. NullElection
        # (election off) owns everything with token None — fence checks
        # are skipped, the single-master configuration.
        self.election = election or NullElection(ring.shards)
        self._lock = threading.Lock()
        # last observed (resourceVersion, annotations) per shard map —
        # the CAS fast path patches against this without a fresh GET
        self._observed: dict[int, tuple[str, dict[str, str]]] = {}
        # (shard, key, value-or-None, parked_monotonic): mutations that
        # could not reach the apiserver, replayed oldest-first
        self._dirty: list[tuple[int, str, str | None, float]] = []
        self.torn_records = 0
        # cross-shard capacity pokes: last stamp sent per peer shard
        # (rate limit) and last stamp observed per owned shard (edge
        # detection — only a MOVED stamp is a nudge)
        self._poke_sent: dict[int, float] = {}
        self._poke_seen: dict[int, str] = {}
        # Group commit (the 10k admission path, GPUOS-style operation
        # fusion): with delay > 0, per-record mutations coalesce in a
        # per-shard pending map (last-writer-wins per key) and land as
        # ONE fenced CAS per shard — flushed by the coalescer thread
        # within the bounded delay, at the size threshold, and by the
        # broker tick as the backstop. 0 (the default; the
        # TPU_STORE_GROUP_COMMIT=0 revert) keeps the per-record CAS
        # path byte-for-byte.
        self.group_commit_delay_s = group_commit_delay_s
        self.group_commit_max_keys = group_commit_max_keys
        self._pending: dict[int, dict[str, str | None]] = {}
        self._pending_count = 0          # distinct queued keys, O(1)
        self._pending_first: float | None = None
        self._flush_cond = threading.Condition(self._lock)
        # serializes whole flushes (swap + CAS): two concurrent flushes
        # could otherwise land one key's batches out of order and
        # resurrect a superseded value
        self._flush_mutex = threading.Lock()
        self._flusher: threading.Thread | None = None
        self._stop_flag = False
        # bound by the broker (bind_ha): a batch bounced off a higher
        # fence demotes the shard exactly like a per-record write would
        # — the coalescer surfaces it through this callback instead of
        # raising on its own thread.
        self.on_fenced = None
        self.group_commits = 0
        if self.group_commit_delay_s > 0:
            self._flusher = threading.Thread(
                target=self._flusher_run, daemon=True,
                name="tpumounter-store-coalescer")
            self._flusher.start()

    # -- naming ----------------------------------------------------------------

    def cm_name(self, shard: int) -> str:
        return f"{consts.STORE_CONFIGMAP_PREFIX}{shard}"

    def shard_of(self, namespace: str) -> int:
        return self.ring.shard_of(namespace)

    # -- write-through ---------------------------------------------------------

    def put_lease(self, record: LeaseRecord) -> bool:
        return self._mutate(self.shard_of(record.namespace),
                            record.annotation_key, record.to_json())

    def delete_lease(self, namespace: str, pod: str) -> bool:
        key = (consts.STORE_LEASE_ANNOTATION_PREFIX
               + _digest(f"{namespace}/{pod}"))
        return self._mutate(self.shard_of(namespace), key, None)

    def put_leases(self, records: list[LeaseRecord]) -> None:
        """Batched write-through: all of one shard's records land in ONE
        CAS merge-patch (re-derivation syncs N leases at once; N
        sequential round-trips against the same ConfigMap would be
        O(N) for what is one annotation merge). Falls back to per-record
        writes — with their dirty-parking — when a batch cannot land."""
        by_shard: dict[int, list[LeaseRecord]] = {}
        for record in records:
            by_shard.setdefault(self.shard_of(record.namespace),
                                []).append(record)
        # Serialized against the coalescer's whole flush cycle: a flush
        # that already SWAPPED its batches out (and is mid-CAS) holds
        # keys the purge below can no longer see — landing this fresh
        # sync concurrently would let that stale batch overwrite it.
        with self._flush_mutex:
            self._put_leases_locked(by_shard)
        self._export_lag_locked_free()

    def _put_leases_locked(self,
                           by_shard: dict[int, list[LeaseRecord]]) -> None:
        for shard, group in by_shard.items():
            if self.election.enabled and self.election.token(shard) is None:
                continue
            changes = {r.annotation_key: r.to_json() for r in group}
            try:
                self._cas(shard, changes)
            except StoreFencedError:
                raise
            except K8sApiError:
                for record in group:
                    self._write(shard, record.annotation_key,
                                record.to_json())
                continue
            REGISTRY.store_cas.inc(op="put", outcome="ok")
            with self._lock:
                # the batch supersedes any parked mutation for its keys
                # — dirty AND coalescer-pending alike (a stale pending
                # put flushing after this fresh sync would regress the
                # records it just wrote)
                self._dirty = [d for d in self._dirty
                               if not (d[0] == shard and d[1] in changes)]
                shard_pending = self._pending.get(shard)
                if shard_pending:
                    for key in changes:
                        # membership check, not pop-default: a queued
                        # DELETE's value is None too
                        if key in shard_pending:
                            del shard_pending[key]
                            self._pending_count -= 1
                    if not shard_pending:
                        self._pending.pop(shard, None)
                    if not self._pending:
                        self._pending_first = None   # see forget_shard
            self._export_records(shard)

    def put_waiter(self, record: WaiterRecord) -> bool:
        return self._mutate(self.shard_of(record.namespace),
                            record.annotation_key, record.to_json())

    def delete_waiter(self, namespace: str, rid: str) -> bool:
        key = consts.STORE_WAITER_ANNOTATION_PREFIX + _digest(rid)
        return self._mutate(self.shard_of(namespace), key, None)

    def put_slice_txn(self, record: SliceTxnRecord) -> bool:
        return self._mutate(self.shard_of(record.namespace),
                            record.annotation_key, record.to_json())

    def delete_slice_txn(self, namespace: str, txn_id: str) -> bool:
        key = consts.STORE_SLICE_ANNOTATION_PREFIX + _digest(txn_id)
        return self._mutate(self.shard_of(namespace), key, None)

    def put_barrier(self, record: SliceBarrierRecord) -> bool:
        return self._mutate(self.shard_of(record.namespace),
                            record.annotation_key, record.to_json())

    def delete_barrier(self, namespace: str, group: str) -> bool:
        key = consts.STORE_BARRIER_ANNOTATION_PREFIX + _digest(group)
        return self._mutate(self.shard_of(namespace), key, None)

    def put_defrag_move(self, record: DefragMoveRecord) -> bool:
        return self._mutate(self.shard_of(record.namespace),
                            record.annotation_key, record.to_json())

    def delete_defrag_move(self, namespace: str, group: str,
                           pod: str) -> bool:
        key = (consts.STORE_DEFRAG_ANNOTATION_PREFIX
               + _digest(f"{group}/{namespace}/{pod}"))
        return self._mutate(self.shard_of(namespace), key, None)

    # -- group commit (the coalescer seam) -------------------------------------

    def _mutate(self, shard: int, key: str, value: str | None) -> bool:
        """THE per-record mutation seam (tests/test_store_lint.py pins
        that every record write crosses it): group commit queues the
        mutation for the next fused per-shard CAS; with the coalescer
        off this is the legacy synchronous per-record write —
        sanctioned direct ``_write``, the TPU_STORE_GROUP_COMMIT=0
        byte-for-byte path."""
        if self.group_commit_delay_s > 0:
            self._enqueue(shard, key, value)
            return True
        return self._write(shard, key, value)

    def _enqueue(self, shard: int, key: str, value: str | None) -> None:
        """Queue one mutation for the coalescer, last-writer-wins per
        key — the SAME discipline the dirty queue applies, extended
        across both structures: a newer pending value supersedes any
        parked dirty mutation for its key, so the two can never replay
        out of order against each other."""
        with self._flush_cond:
            batch = self._pending.setdefault(shard, {})
            if key not in batch:
                self._pending_count += 1
            batch[key] = value
            first = self._pending_first is None
            if first:
                self._pending_first = time.monotonic()
            self._dirty = [d for d in self._dirty
                           if not (d[0] == shard and d[1] == key)]
            # wake the flusher only when its wait condition changed:
            # the empty→nonempty transition (arms the delay window) or
            # the size threshold (flushes early) — NOT once per record,
            # which would be a spurious wakeup per mutation at exactly
            # the rates the coalescer exists to absorb
            if first or self._pending_count >= self.group_commit_max_keys:
                self._flush_cond.notify_all()

    def _flusher_run(self) -> None:
        while True:
            with self._flush_cond:
                while not self._pending and not self._stop_flag:
                    self._flush_cond.wait(timeout=0.5)
                if self._stop_flag:
                    return
                # bounded delay from the OLDEST queued mutation; the
                # size threshold (or stop) flushes early
                while True:
                    first = self._pending_first
                    if first is None or self._stop_flag \
                            or self._pending_count \
                            >= self.group_commit_max_keys:
                        break
                    remaining = (first + self.group_commit_delay_s
                                 - time.monotonic())
                    if remaining <= 0:
                        break
                    self._flush_cond.wait(timeout=remaining)
                    if not self._pending:
                        break
                if self._stop_flag:
                    return
                if not self._pending:
                    continue
            self.flush_pending()

    def flush_pending(self) -> int:
        """Land every coalesced mutation: ONE fenced CAS per shard
        carrying the shard's whole pending batch. Driven by the
        coalescer thread (bounded delay / size threshold) and by the
        broker tick as the backstop; callable directly by tests.
        Never raises — a batch refused by the fence parks dirty and
        surfaces through ``on_fenced`` (demotion), exactly the
        per-record discipline; apiserver trouble parks dirty for
        ``flush_dirty``. Returns mutations landed."""
        with self._flush_mutex:
            with self._lock:
                batches = self._pending
                self._pending = {}
                self._pending_count = 0
                self._pending_first = None
            landed = 0
            for shard, changes in sorted(batches.items()):
                if self.election.enabled \
                        and self.election.token(shard) is None:
                    # no live token: leadership decayed (or the shard
                    # moved) — writing would be unfenced. Park; the
                    # dirty flush keeps decayed-shard entries for the
                    # resume and drops them only on a REAL hand-off.
                    for key, value in changes.items():
                        self._park(shard, key, value)
                    continue
                try:
                    self._cas(shard, changes)
                except StoreFencedError as e:
                    REGISTRY.store_cas.inc(op="batch", outcome="fenced")
                    for key, value in changes.items():
                        self._park(shard, key, value)
                    if e.token != -1 and self.on_fenced is not None:
                        # genuinely deposed (a peer's higher fence):
                        # demote — which forgets the shard and with it
                        # the mutations just parked
                        self.on_fenced(e)
                    continue
                except K8sApiError as e:
                    REGISTRY.store_cas.inc(op="batch", outcome="error")
                    logger.warning("group commit for shard %d parked "
                                   "dirty (%d key(s)): %s", shard,
                                   len(changes), e)
                    for key, value in changes.items():
                        self._park(shard, key, value)
                    continue
                REGISTRY.store_cas.inc(op="batch", outcome="ok")
                self.group_commits += 1
                landed += len(changes)
                with self._lock:
                    # the batch supersedes any parked mutation for its
                    # keys (same rule as a landed per-record write)
                    self._dirty = [d for d in self._dirty
                                   if not (d[0] == shard
                                           and d[1] in changes)]
                self._export_records(shard)
            self._export_lag_locked_free()
            return landed

    def stop(self) -> None:
        """Stop the coalescer thread WITHOUT flushing: pending
        mutations die with the process exactly as a crash would lose
        them — kill() test semantics and the documented best-effort
        durability window (docs/guide/Performance.md). Tests wanting
        determinism call :meth:`flush_pending` first."""
        with self._flush_cond:
            self._stop_flag = True
            self._flush_cond.notify_all()
        if self._flusher is not None:
            self._flusher.join(timeout=2.0)
            self._flusher = None

    # -- cross-shard capacity pokes --------------------------------------------

    # Minimum seconds between pokes to one shard: a burst of detaches is
    # one "look again", not N ConfigMap patches — and each poke costs a
    # write on the PEER leader's CAS stream, so the hint stays far
    # cheaper than the capacity it advertises (a parked waiter losing a
    # few seconds to the rate limit still beats sleeping to its
    # deadline).
    POKE_MIN_INTERVAL_S = 5.0

    def poke_peers(self, own_shards: set[int]) -> int:
        """Stamp the capacity-poke annotation on every shard map this
        replica does NOT own: GPUs just freed here, and a peer leader's
        parked waiters (gangs especially) should re-attempt now instead
        of sleeping to their deadline. Best-effort and fence-exempt (the
        stamp carries no state — see consts); an unreachable apiserver
        just means peers fall back to their timeout. Returns shards
        poked."""
        now = time.monotonic()
        poked = 0
        for shard in range(self.ring.shards):
            if shard in own_shards:
                continue
            with self._lock:
                last = self._poke_sent.get(shard, -1e18)
                if now - last < self.POKE_MIN_INTERVAL_S:
                    continue
                self._poke_sent[shard] = now
            try:
                self._cas(shard,
                          {consts.STORE_CAPACITY_POKE_ANNOTATION:
                           f"{time.time():.3f}"},
                          unfenced=True)
            except K8sApiError as e:
                logger.debug("capacity poke to shard %d failed: %s",
                             shard, e)
                continue
            REGISTRY.capacity_pokes.inc(direction="sent")
            poked += 1
        return poked

    def check_poke(self, shard: int) -> bool:
        """True when the shard map's poke stamp moved since last checked
        (a peer freed GPUs our waiters may want). One fresh GET — driven
        from the broker tick, never a request path; the read also
        refreshes the CAS cache, so it is not pure overhead."""
        try:
            cm = self.kube.get_config_map(self.namespace,
                                          self.cm_name(shard))
        except K8sApiError:
            return False
        self._remember(shard, cm)
        stamp = (cm.get("metadata", {}).get("annotations") or {}).get(
            consts.STORE_CAPACITY_POKE_ANNOTATION, "")
        with self._lock:
            seen = self._poke_seen.get(shard)
            self._poke_seen[shard] = stamp
        if seen is None or seen == stamp or not stamp:
            # first observation is a baseline, not a nudge
            return False
        REGISTRY.capacity_pokes.inc(direction="received")
        return True

    def _write(self, shard: int, key: str, value: str | None,
               _from_dirty: bool = False) -> bool:
        """CAS the annotation in (value=None deletes). True = landed;
        False = parked dirty (apiserver trouble). Raises
        :class:`StoreFencedError` when this replica's token is below the
        shard's recorded fence — the caller has been deposed."""
        op = "put" if value is not None else "delete"
        if self.election.enabled and self.election.token(shard) is None:
            # No live token: either the shard is a peer's (its leader
            # owns persistence) or OUR leadership transiently decayed
            # (renewals stalled past TTL). Writing would be unfenced, so
            # don't — but PARK the mutation: a resumed leadership must
            # replay it (flush_dirty keeps decayed-shard entries and
            # drops them only on a REAL hand-off), or the store would
            # silently disagree with memory forever.
            logger.debug("store write %s %s parked: no live token for "
                         "shard %d", op, key, shard)
            if not _from_dirty:
                self._park(shard, key, value)
            self._export_lag_locked_free()
            return False
        try:
            self._cas(shard, {key: value})
        except StoreFencedError as e:
            if e.token == -1 and not _from_dirty:
                # the decay guard inside _cas (leadership lapsed between
                # the precheck and the CAS): same treatment as above
                self._park(shard, key, value)
                self._export_lag_locked_free()
                return False
            raise
        except K8sApiError as e:
            REGISTRY.store_cas.inc(op=op, outcome="error")
            if not _from_dirty:
                self._park(shard, key, value)
            self._export_lag_locked_free()
            logger.warning("store write %s %s parked dirty: %s", op, key,
                           e)
            return False
        REGISTRY.store_cas.inc(op=op, outcome="ok")
        with self._lock:
            # a LIVE write that landed supersedes any older parked
            # mutation for the key — replaying it would resurrect a
            # deleted record (or delete a re-recorded one)
            self._dirty = [d for d in self._dirty
                           if not (d[0] == shard and d[1] == key)]
        self._export_records(shard)
        self._export_lag_locked_free()
        return True

    def _park(self, shard: int, key: str, value: str | None) -> None:
        """Queue a mutation for the dirty-flush, last-writer-wins per
        key: a newer failed mutation REPLACES an older parked one
        (keeping the older timestamp — lag measures the oldest
        unpersisted state change); two parked mutations for one key
        would replay the stale one over the fresh one."""
        with self._lock:
            for i, parked in enumerate(self._dirty):
                if parked[0] == shard and parked[1] == key:
                    self._dirty[i] = (shard, key, value, parked[3])
                    return
            self._dirty.append((shard, key, value, time.monotonic()))

    def _cas(self, shard: int, changes: dict[str, str | None],
             unfenced: bool = False) -> None:
        """One annotation merge under resourceVersion CAS + fence check,
        retried on conflict with a fresh read. The fence bump rides in
        the same patch, so "check the token" and "write the record" are
        one atomic step — a deposed leader cannot interleave.

        ``unfenced=True`` skips the token discipline entirely — reserved
        for the capacity-poke annotation, which carries no broker state
        (any replica may stamp any shard; the fence exists to protect
        records, and a poke writes none)."""
        name = self.cm_name(shard)
        token = None if unfenced else self.election.token(shard)
        if not unfenced and self.election.enabled and token is None:
            # Leadership decayed between the caller's ownership check
            # and here (paused process, missed renewals): writing now
            # would be UNFENCED — the one hole in the split-brain
            # argument. Refuse; the caller demotes and the shard's new
            # leader owns the record. (token -1 = "no live token".)
            raise StoreFencedError(shard, -1, 0)
        last: K8sApiError | None = None
        for _ in range(CAS_ATTEMPTS):
            observed = self._observe(shard)
            if observed is None:
                # shard map does not exist yet: create IS the CAS
                annotations = {k: v for k, v in changes.items()
                               if v is not None}
                if token is not None:
                    annotations[consts.STORE_FENCE_ANNOTATION] = str(token)
                try:
                    created = self.kube.create_config_map(
                        self.namespace,
                        {"apiVersion": "v1", "kind": "ConfigMap",
                         "metadata": {
                             "name": name,
                             "labels": {"app": "tpu-mounter-broker-state"},
                             "annotations": annotations}})
                except K8sApiError as e:
                    if e.status == 409:     # lost the create race
                        last = e
                        REGISTRY.store_cas.inc(op="put",
                                               outcome="conflict")
                        continue
                    raise
                self._remember(shard, created)
                return
            rv, annotations = observed
            fence = int(annotations.get(consts.STORE_FENCE_ANNOTATION)
                        or 0)
            if token is not None and token < fence:
                raise StoreFencedError(shard, token, fence)
            patch_ann: dict[str, Any] = dict(changes)
            if token is not None and token > fence:
                patch_ann[consts.STORE_FENCE_ANNOTATION] = str(token)
            try:
                updated = self.kube.patch_config_map(
                    self.namespace, name,
                    {"metadata": {"annotations": patch_ann}},
                    resource_version=rv)
            except K8sApiError as e:
                if e.status in (404, 409):
                    # 409: another replica wrote first; 404: deleted under
                    # us — both mean "re-observe and retry"
                    last = e
                    REGISTRY.store_cas.inc(
                        op="put" if any(v is not None
                                        for v in changes.values())
                        else "delete", outcome="conflict")
                    with self._lock:
                        self._observed.pop(shard, None)
                    continue
                raise
            self._remember(shard, updated)
            return
        raise last or K8sApiError(409, "store CAS retries exhausted")

    def _observe(self, shard: int) -> tuple[str, dict[str, str]] | None:
        with self._lock:
            cached = self._observed.get(shard)
        if cached is not None:
            return cached
        try:
            cm = self.kube.get_config_map(self.namespace,
                                          self.cm_name(shard))
        except K8sApiError as e:
            if e.status == 404:
                return None
            raise
        return self._remember(shard, cm)

    def _remember(self, shard: int,
                  cm: dict[str, Any]) -> tuple[str, dict[str, str]]:
        meta = cm.get("metadata", {})
        observed = (meta.get("resourceVersion", ""),
                    dict(meta.get("annotations") or {}))
        with self._lock:
            self._observed[shard] = observed
        return observed

    # -- dirty-queue flush (driven by the broker tick) -------------------------

    def flush_dirty(self) -> int:
        """Replay parked mutations oldest-first; stops at the first one
        that still fails (ordering matters: a delete must not land before
        the put it supersedes). Returns mutations flushed."""
        flushed = 0
        while True:
            with self._lock:
                if not self._dirty:
                    break
                shard, key, value, _ = self._dirty[0]
            if self.election.enabled \
                    and self.election.token(shard) is None:
                holder = (self.election.leaders().get(shard)
                          or {}).get("holder", "")
                replica = getattr(self.election, "replica", "")
                if holder and replica and holder != replica:
                    # REAL hand-off (the lock names a peer): the new
                    # leader's rehydration owns the state — drop
                    with self._lock:
                        self._dirty.pop(0)
                    continue
                # leadership merely decayed (lock still names us, or
                # unobserved): keep the mutation parked for the resume
                break
            if not self._write(shard, key, value, _from_dirty=True):
                break
            with self._lock:
                # the success path already dropped every parked
                # mutation for the key; this is a belt-and-braces guard
                # against the head surviving (it must not loop forever)
                if self._dirty and self._dirty[0][:2] == (shard, key):
                    self._dirty.pop(0)
            flushed += 1
        self._export_lag_locked_free()
        return flushed

    def forget_shard(self, shard: int) -> None:
        """Drop a lost shard's cached view and its parked mutations: the
        new leader owns that state now, and replaying our stale writes
        would only bounce off the fence."""
        with self._lock:
            self._observed.pop(shard, None)
            self._dirty = [d for d in self._dirty if d[0] != shard]
            # coalescer-pending mutations are the new leader's problem
            # now too — flushing ours would only bounce off the fence
            self._pending_count -= len(self._pending.pop(shard, {}) or {})
            if not self._pending:
                # the delay window re-arms from the NEXT enqueue; a
                # stale stamp would both skip its notify and collapse
                # the next batch's coalescing window
                self._pending_first = None
            # stale poke baseline would mis-read the new leader's first
            # stamp as "unchanged" on a later reacquire
            self._poke_seen.pop(shard, None)
        # the records belong to the new leader now — freezing our last
        # counts would double-count them in any cross-replica sum (same
        # vanished-series discipline as lease.py's _known_tenants)
        for kind in ("lease", "waiter", "slice", "defrag"):
            REGISTRY.store_records.set(0, kind=kind, shard=str(shard))
        self._export_lag_locked_free()

    def lag_s(self) -> float:
        with self._lock:
            if not self._dirty:
                return 0.0
            return time.monotonic() - self._dirty[0][3]

    def _export_lag_locked_free(self) -> None:
        REGISTRY.store_lag.set(round(self.lag_s(), 3))

    def _export_records(self, shard: int) -> None:
        with self._lock:
            observed = self._observed.get(shard)
        if observed is None:
            return
        _, annotations = observed
        leases = sum(1 for k in annotations
                     if k.startswith(consts.STORE_LEASE_ANNOTATION_PREFIX))
        waiters = sum(
            1 for k in annotations
            if k.startswith(consts.STORE_WAITER_ANNOTATION_PREFIX))
        slices = sum(
            1 for k in annotations
            if k.startswith(consts.STORE_SLICE_ANNOTATION_PREFIX))
        # per-shard series: a replica owning several shards must not
        # have the last-written shard's counts overwrite the others'
        REGISTRY.store_records.set(leases, kind="lease", shard=str(shard))
        REGISTRY.store_records.set(waiters, kind="waiter",
                                   shard=str(shard))
        REGISTRY.store_records.set(slices, kind="slice", shard=str(shard))
        barriers = sum(
            1 for k in annotations
            if k.startswith(consts.STORE_BARRIER_ANNOTATION_PREFIX))
        REGISTRY.store_records.set(barriers, kind="barrier",
                                   shard=str(shard))
        defrag = sum(
            1 for k in annotations
            if k.startswith(consts.STORE_DEFRAG_ANNOTATION_PREFIX))
        REGISTRY.store_records.set(defrag, kind="defrag",
                                   shard=str(shard))

    # -- rehydration -----------------------------------------------------------

    def rehydrate(self, shard: int
                  ) -> tuple[list[LeaseRecord], list[WaiterRecord], int]:
        """The shard's persisted intent: (leases, waiters, torn). A torn
        record — a crash mid-annotation-write left unparseable JSON — is
        counted, logged and dropped; the caller degrades that record to
        slave-pod re-derivation (leases) or loses the intent (waiters),
        never a poisoned table."""
        try:
            cm = self.kube.get_config_map(self.namespace,
                                          self.cm_name(shard))
        except K8sApiError as e:
            if e.status == 404:
                return [], [], 0
            raise
        self._remember(shard, cm)
        annotations = dict(cm.get("metadata", {}).get("annotations") or {})
        leases: list[LeaseRecord] = []
        waiters: list[WaiterRecord] = []
        torn = 0
        for key, value in annotations.items():
            try:
                if key.startswith(consts.STORE_LEASE_ANNOTATION_PREFIX):
                    leases.append(LeaseRecord.from_json(value))
                elif key.startswith(
                        consts.STORE_WAITER_ANNOTATION_PREFIX):
                    waiters.append(WaiterRecord.from_json(value))
            except (ValueError, TypeError) as e:
                torn += 1
                logger.warning(
                    "torn store record %s dropped (%s); degrading to "
                    "cluster re-derivation", key, e)
        if torn:
            self.torn_records += torn
        self._export_records(shard)
        return leases, waiters, torn

    def rehydrate_slice_txns(self, shard: int
                             ) -> tuple[list[SliceTxnRecord], int]:
        """The shard's unresolved slice transactions: (records, torn).
        A record here means its writer crashed (or was deposed) mid-
        transaction — the adopting leader must complete or roll it back
        (master/slicetxn.py adopt). Torn records are counted and dropped
        like rehydrate()'s: the txn-targeted detach of the next attach
        attempt (same rid) reconciles whatever they described."""
        try:
            cm = self.kube.get_config_map(self.namespace,
                                          self.cm_name(shard))
        except K8sApiError as e:
            if e.status == 404:
                return [], 0
            raise
        self._remember(shard, cm)
        annotations = dict(cm.get("metadata", {}).get("annotations") or {})
        records: list[SliceTxnRecord] = []
        torn = 0
        for key, value in annotations.items():
            if not key.startswith(consts.STORE_SLICE_ANNOTATION_PREFIX):
                continue
            try:
                records.append(SliceTxnRecord.from_json(value))
            except (ValueError, TypeError) as e:
                torn += 1
                logger.warning("torn slice txn record %s dropped (%s)",
                               key, e)
        if torn:
            self.torn_records += torn
        self._export_records(shard)
        return records, torn

    def rehydrate_barriers(self, shard: int
                           ) -> tuple[list[SliceBarrierRecord], int]:
        """The shard's persisted re-federation barriers: (records,
        torn). A record here after a failover is a barrier whose arming
        leader died — the adopting leader re-arms it
        (master/slicetxn.py adopt_barriers) so waiting members keep a
        source of truth; torn records are counted and dropped (the next
        generation bump re-creates the barrier)."""
        try:
            cm = self.kube.get_config_map(self.namespace,
                                          self.cm_name(shard))
        except K8sApiError as e:
            if e.status == 404:
                return [], 0
            raise
        self._remember(shard, cm)
        annotations = dict(cm.get("metadata", {}).get("annotations") or {})
        records: list[SliceBarrierRecord] = []
        torn = 0
        for key, value in annotations.items():
            if not key.startswith(consts.STORE_BARRIER_ANNOTATION_PREFIX):
                continue
            try:
                records.append(SliceBarrierRecord.from_json(value))
            except (ValueError, TypeError) as e:
                torn += 1
                logger.warning("torn barrier record %s dropped (%s)",
                               key, e)
        if torn:
            self.torn_records += torn
        return records, torn

    def rehydrate_defrag_moves(self, shard: int
                               ) -> tuple[list[DefragMoveRecord], int]:
        """The shard's journaled defrag moves: (records, torn). A record
        here after a failover is a migration whose planning leader died
        — the adopting actuator (master/defrag.py adopt) finishes or
        aborts it against the group's actual membership. Torn records
        are counted and dropped (the next optimizer tick re-plans)."""
        try:
            cm = self.kube.get_config_map(self.namespace,
                                          self.cm_name(shard))
        except K8sApiError as e:
            if e.status == 404:
                return [], 0
            raise
        self._remember(shard, cm)
        annotations = dict(cm.get("metadata", {}).get("annotations") or {})
        records: list[DefragMoveRecord] = []
        torn = 0
        for key, value in annotations.items():
            if not key.startswith(consts.STORE_DEFRAG_ANNOTATION_PREFIX):
                continue
            try:
                records.append(DefragMoveRecord.from_json(value))
            except (ValueError, TypeError) as e:
                torn += 1
                logger.warning("torn defrag record %s dropped (%s)",
                               key, e)
        if torn:
            self.torn_records += torn
        return records, torn

    # -- introspection ---------------------------------------------------------

    def snapshot(self) -> dict:
        with self._lock:
            dirty = len(self._dirty)
            pending = self._pending_count
        out = {
            "namespace": self.namespace,
            "shards": self.ring.shards,
            "dirty": dirty,
            "lag_s": round(self.lag_s(), 3),
            "torn_records": self.torn_records,
        }
        if self.group_commit_delay_s > 0:
            # keys present only with the coalescer ON, so the
            # TPU_STORE_GROUP_COMMIT=0 payload stays byte-for-byte
            out["group_commit"] = {
                "delay_s": self.group_commit_delay_s,
                "pending": pending,
                "commits": self.group_commits,
            }
        return out
