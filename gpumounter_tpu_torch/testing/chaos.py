"""Deterministic fault injection for the port's fake control plane (the
port of :mod:`gpumounter_tpu.testing.chaos`).

Transient faults are rare in test rigs, so resilience code rots unless
failures can be scripted: this module is the chaos harness that keeps the
retry layer, the circuit breakers, the watch-resume machinery, the attach
journal and the device gate's convergence honest. It threads through the
fake stack at the SAME seams production faults hit:

- :class:`FaultInjector` plugs into ``FakeKubeClient.faults`` and
  ``FakePodResourcesClient.faults``: every verb consults it inside the
  retry layer, so an injected 500 burst exercises the identical backoff
  path a real apiserver hiccup would. ``HttpApiserver`` consults it at
  the HTTP layer, where :class:`ConnectionDropped` becomes a torn TCP
  connection.
- :class:`FaultPlan` is a named, ordered set of :class:`Fault` rules —
  error bursts, added latency, connection drops, watch hangs and
  mid-stream watch death, kubelet socket flaps.
- :class:`ChaosRig` wraps a :class:`~.sim.WorkerRig` with crash points
  (:data:`CRASH_POINTS`, :data:`DETACH_CRASH_POINTS`): a simulated worker
  death before / in the middle of / right after actuation, or inside a
  detach's revoke, followed by :meth:`ChaosRig.restart_worker`, which
  boots a fresh service over the same cluster, journal file and gate
  backend and runs the startup replay.

:func:`assert_invariants` states the contract every fault plan must
preserve: attaches converge or roll back cleanly — no leaked slave-pod
reservations, no partial device grants, no journal backlog, at most one
logical ``GPUAttached`` per attach, and gate grants equal to ground
truth. The broker, slice, node-death, topology and defragmenter
contracts (:func:`assert_broker_invariants`,
:func:`assert_slice_invariants`, :func:`assert_node_death_invariants`,
:func:`assert_topology_invariants`, :func:`assert_defrag_invariants`)
ride on top of it.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time

from gpumounter_tpu_torch.k8s import objects
from gpumounter_tpu_torch.utils import consts
from gpumounter_tpu_torch.utils.errors import (K8sApiError,
                                               KubeletUnavailableError,
                                               PodNotFoundError)


class ConnectionDropped(K8sApiError):
    """Injected connection drop. Subclasses the status-0 "reset" apiserver
    error so the in-process fake treats it exactly like a torn TCP
    stream; the HTTP facade catches it and actually closes the socket."""

    def __init__(self):
        super().__init__(0, "injected connection drop", cause="reset")


class WorkerCrash(Exception):
    """Simulated worker death at a crash point. Deliberately NOT a
    TPUMounterError: a crash runs no rollback handler, no journal commit
    — exactly the state a SIGKILL'd worker leaves behind."""


@dataclasses.dataclass
class Fault:
    """One injection rule, applied to calls matching (op, resource).

    ``op`` is the instrumentation verb (GET/LIST/POST/DELETE/PATCH/WATCH)
    or ``*``; ``resource`` is pods/nodes/events/podresources or ``*``.
    The first ``after`` matching calls pass untouched, then ``times``
    calls are affected: sleep ``latency_s`` (a watch hang when op=WATCH),
    then raise — ``status``+``cause`` as a :class:`K8sApiError`,
    ``kubelet=True`` as :class:`KubeletUnavailableError`, ``drop=True``
    as :class:`ConnectionDropped`. Latency-only faults just delay.
    """

    op: str = "*"
    resource: str = "*"
    times: int = 1
    after: int = 0
    latency_s: float = 0.0
    status: int | None = None
    cause: str = ""
    retry_after_s: float | None = None
    kubelet: bool = False
    drop: bool = False

    def matches(self, op: str, resource: str) -> bool:
        return (self.op in ("*", op)
                and self.resource in ("*", resource))


class FaultInjector:
    """Stateful executor of a plan's rules; one per installed plan.

    ``fired`` logs every applied fault as (op, resource, description) so
    tests can assert the plan actually bit — a chaos test whose fault
    never fired proves nothing.
    """

    def __init__(self, faults: list[Fault]):
        self._faults = [dataclasses.replace(f) for f in faults]
        self._lock = threading.Lock()
        self.fired: list[tuple[str, str, str]] = []

    def fire(self, op: str, resource: str) -> None:
        fault = None
        with self._lock:
            for candidate in self._faults:
                if not candidate.matches(op, resource):
                    continue
                if candidate.after > 0:
                    candidate.after -= 1
                    continue
                if candidate.times <= 0:
                    continue
                candidate.times -= 1
                fault = candidate
                self.fired.append((op, resource, self._describe(fault)))
                break
        if fault is None:
            return
        if fault.latency_s > 0:
            time.sleep(fault.latency_s)
        if fault.drop:
            raise ConnectionDropped()
        if fault.kubelet:
            raise KubeletUnavailableError(
                "injected kubelet socket flap")
        if fault.status is not None:
            raise K8sApiError(fault.status,
                              "injected fault", cause=fault.cause,
                              retry_after_s=fault.retry_after_s)

    @staticmethod
    def _describe(fault: Fault) -> str:
        if fault.drop:
            return "drop"
        if fault.kubelet:
            return "kubelet-flap"
        if fault.status is not None:
            return f"error-{fault.status}" + (f"-{fault.cause}"
                                              if fault.cause else "")
        return f"latency-{fault.latency_s:g}s"

    @property
    def remaining(self) -> int:
        with self._lock:
            return sum(max(0, f.times) for f in self._faults)


@dataclasses.dataclass
class FaultPlan:
    """A named chaos scenario: the unit of the test matrix."""

    name: str
    faults: list[Fault]
    description: str = ""

    def injector(self) -> FaultInjector:
        return FaultInjector(self.faults)


# Where a simulated worker death can be armed, relative to actuation —
# the window the attach journal exists to cover:
#   before_actuate: intent journaled, slave pods reserved, nothing granted
#   mid_actuate:    gate granted + first device node created, rest missing
#   before_commit:  actuation complete, commit record never written
CRASH_POINTS = ("before_actuate", "mid_actuate", "before_commit")
# Detach-window crash points the device gate's convergence covers
# (gated rigs only for mid_gate_sync):
#   mid_revoke:     died AFTER the gate revoked device access but BEFORE
#                   the nodes were unlinked / slaves released
#   mid_gate_sync:  died INSIDE the gate backend mutation — the gate
#                   journal record is written, its commit never is (the
#                   pending-record window convergence must resolve)
DETACH_CRASH_POINTS = ("mid_revoke", "mid_gate_sync")


def arm_crash(point: str, mounter, journal, backend=None,
              fired: list | None = None) -> list:
    """Plant a :class:`WorkerCrash` at ``point`` on the objects a worker's
    attach or detach actually reaches: ``mounter.mount_chips``, the
    mounter's actuator's ``apply_device_nodes`` (the one batch call every
    actuator — recording, procroot, the resident agent's — answers),
    ``journal.commit`` or the gate ``backend``'s ``sync``/``attach``.
    Each crash appends ``point`` to ``fired`` as it raises: a crash armed
    where the path never goes passes silently, so callers assert it
    fired. Returns the undo callables."""
    assert point in CRASH_POINTS + DETACH_CRASH_POINTS, point

    def crash():
        if fired is not None:
            fired.append(point)
        return WorkerCrash(point)

    if point == "before_actuate":
        orig_mount = mounter.mount_chips

        def crash_mount(*args, **kwargs):
            raise crash()
        mounter.mount_chips = crash_mount
        return [lambda: setattr(mounter, "mount_chips", orig_mount)]
    if point in ("mid_actuate", "mid_revoke"):
        actuator = mounter.actuator
        orig_apply = actuator.apply_device_nodes
        landed: list = []       # mid_actuate: the one node let through

        def crash_in_batch(pid, creates=(), removes=(), *args, **kwargs):
            if point == "mid_actuate":
                # the first device node lands, the rest never do
                if len(landed) + len(creates) > 1:
                    if not landed:
                        orig_apply(pid, list(creates)[:1], [], *args,
                                   **kwargs)
                    raise crash()
                landed.extend(creates)
            elif removes:
                # die on the first node unlink: the gate revoke (which
                # runs FIRST on the detach path) has landed
                raise crash()
            return orig_apply(pid, creates, removes, *args, **kwargs)
        actuator.apply_device_nodes = crash_in_batch
        return [lambda: setattr(actuator, "apply_device_nodes", orig_apply)]
    if point == "before_commit":
        orig_commit = journal.commit

        def crash_commit(jid):
            raise crash()
        journal.commit = crash_commit
        return [lambda: setattr(journal, "commit", orig_commit)]
    assert backend is not None, "mid_gate_sync needs a gate backend " \
        "(a rig built with gate=)"
    orig_sync, orig_attach = backend.sync, backend.attach

    def crash_sync(*args, **kwargs):
        raise crash()
    backend.sync = crash_sync
    backend.attach = crash_sync
    return [lambda: (setattr(backend, "sync", orig_sync),
                     setattr(backend, "attach", orig_attach))]


class ChaosRig:
    """A WorkerRig under a fault plan, with worker crash-restart.

    ``crash`` semantics: :meth:`arm_crash` plants a :class:`WorkerCrash`
    at the named point; the attach raises it without running rollback
    (like a real SIGKILL). :meth:`restart_worker` then "boots a new
    worker process" (:meth:`~.sim.WorkerRig.restart_worker`): fresh
    journal object over the same journal file, fresh DeviceGate over the
    SAME gate backend (the fake backend plays the kernel, whose maps
    survive a worker crash), fresh service, startup replay.
    """

    def __init__(self, fake_host, n_chips: int = 4,
                 plan: FaultPlan | None = None, **rig_kwargs):
        from gpumounter_tpu_torch.testing.sim import WorkerRig
        self.rig = WorkerRig(fake_host, n_chips=n_chips, **rig_kwargs)
        self.injector: FaultInjector | None = None
        self.fired: list[str] = []     # crash points that went off
        self._unwind: list = []
        if plan is not None:
            self.install(plan)

    def install(self, plan: FaultPlan) -> FaultInjector:
        self.injector = plan.injector()
        self.rig.sim.kube.faults = self.injector
        self.rig.sim.podresources.faults = self.injector
        return self.injector

    # -- crash points ----------------------------------------------------------

    def arm_crash(self, point: str) -> None:
        self._unwind += arm_crash(point, self.rig.mounter,
                                  self.rig.service.journal,
                                  self.rig.gate_backend, fired=self.fired)

    def disarm(self) -> None:
        while self._unwind:
            self._unwind.pop()()

    # -- lifecycle -------------------------------------------------------------

    def restart_worker(self) -> dict[str, int]:
        """Disarm, then boot a fresh worker over the same node state;
        returns the replay outcome counts."""
        self.disarm()
        return self.rig.restart_worker()

    def close(self) -> None:
        self.disarm()
        self.rig.close()


def wait_events_drained(service, timeout_s: float = 5.0) -> None:
    """Block until the service's async audit-event queue has flushed (two
    consecutive empty observations — the worker thread may be mid-POST on
    the first)."""
    deadline = time.monotonic() + timeout_s
    stable = 0
    while time.monotonic() < deadline:
        if not service._event_queue:
            stable += 1
            if stable >= 2:
                return
        else:
            stable = 0
        time.sleep(0.03)


def _fixture_device_nodes(rig) -> set[str]:
    """Container-side device-node paths present under every provisioned
    container root of the fixture tree (procroot/agent rigs write real
    files there; ``.majmin`` sidecars are the fixture format's metadata,
    not nodes)."""
    nodes: set[str] = set()
    proc_root = rig.host.proc_root
    for pid in os.listdir(proc_root):
        root = os.path.join(proc_root, pid, "root")
        if not os.path.isdir(root):
            continue
        for dirpath, _dirnames, filenames in os.walk(root):
            for name in filenames:
                if name.endswith(".majmin"):
                    continue
                full = os.path.join(dirpath, name)
                nodes.add("/" + os.path.relpath(full, root))
    return nodes


def _held_by_owner(sim) -> dict[tuple[str, str], int]:
    """GPUs each owner pod's (non-warm) slave pods hold in the node's
    kubelet assignment table: cluster ground truth."""
    held: dict[tuple[str, str], int] = {}
    for pod in sim.slave_pods():
        labels = objects.labels(pod)
        if labels.get(consts.WARM_POD_LABEL_KEY) == \
                consts.WARM_POD_LABEL_VALUE:
            continue
        owner_ns = labels.get(consts.OWNER_NAMESPACE_LABEL_KEY)
        owner = labels.get(consts.OWNER_POD_LABEL_KEY)
        if not owner or not owner_ns:
            continue
        pkey = (objects.namespace(pod), objects.name(pod))
        gpus = sum(
            len(ids)
            for containers in (sim.podresources.assignments.get(pkey)
                               or {}).values()
            for ids in containers.values())
        if gpus:
            held[(owner_ns, owner)] = held.get((owner_ns, owner), 0) + gpus
    return held


def _store_view(store):
    """Every shard's persisted records: ({owner: GPUs} of the lease
    records, waiter records, slice txn records). Torn records fail."""
    stored: dict[tuple[str, str], int] = {}
    waiters, slices = [], []
    for shard in range(store.ring.shards):
        lease_records, shard_waiters, torn = store.rehydrate(shard)
        assert torn == 0, f"shard {shard}: {torn} torn record(s)"
        for record in lease_records:
            stored[record.key] = stored.get(record.key, 0) + record.chips
        waiters.extend(shard_waiters)
        shard_slices, slice_torn = store.rehydrate_slice_txns(shard)
        assert slice_torn == 0, \
            f"shard {shard}: {slice_torn} torn slice txn record(s)"
        slices.extend(shard_slices)
    return stored, waiters, slices


def assert_node_death_invariants(broker, health) -> None:
    """The node-failure-domain clauses (shared by the broker and slice
    invariant suites; ``health`` = the master's NodeHealthTracker):

    1. **No lease outlives its node's death**: once a node is judged
       ``dead``, every lease on it must have been fenced (single) or
       repaired/torn down (group) — a lease still naming a dead node
       is exactly the stranded state the fencing deadline exists to
       bound.
    2. **No group mixes fenced and live members**: a slice either
       re-formed whole (every member on a non-dead node) or went down
       as a unit — a group with some members fenced and others still
       leased is a half-alive slice, the state self-healing must never
       leave behind.
    """
    stranded = [f"{lease.namespace}/{lease.pod}@{lease.node}"
                for lease in broker.leases.leases()
                if lease.node and health.state(lease.node) == "dead"]
    assert not stranded, \
        f"lease(s) survive on DEAD node(s) past the fencing deadline: " \
        f"{stranded}"
    fenced_groups = {entry["group"] for entry in broker.fenced()
                     if entry.get("group")}
    for group, members in sorted(broker.leases.groups().items()):
        dead_members = [f"{m.namespace}/{m.pod}@{m.node}"
                        for m in members
                        if m.node and health.state(m.node) == "dead"]
        assert not dead_members, \
            f"group {group} mixes live members with dead-node " \
            f"members {dead_members} (half-alive slice)"
        if group in fenced_groups:
            # a group that had members fenced must have re-formed to
            # its full strength on live nodes (the repair txn) — its
            # remaining members holding on is the mixed state
            assert all(m.node == "" or health.state(m.node) == "healthy"
                       or health.state(m.node) == "draining"
                       for m in members), \
                f"group {group} had fenced members but still holds " \
                f"leases on unhealthy nodes"


def assert_topology_invariants(topology_section: dict) -> None:
    """Internal-consistency contract of a /fleetz ``topology`` section
    (any plan that reads one can call this on every observation):

    1. **Score arithmetic holds**: the fleet score is exactly
       1 − largest/free (0 with no free chips), and the fleet
       largest/free/stranded figures are the max/sum of the per-node
       figures — the section is one tick's coherent computation, not a
       mix of ticks.
    2. **Per-node sanity**: largest schedulable block never exceeds the
       node's free count; stranded never exceeds free; a node's free
       components sum to its free count.
    3. **Actionable candidates only**: every defrag candidate's gain is
       positive — a report naming a move that merges nothing is noise
       the future optimizer would chase.
    """
    nodes = topology_section.get("nodes") or {}
    free = sum(n["free"] for n in nodes.values())
    largest = max((n["largest_free_block"] for n in nodes.values()),
                  default=0)
    stranded = sum(n["stranded"] for n in nodes.values())
    assert topology_section["free"] == free, topology_section
    assert topology_section["largest_free_block"] == largest, \
        topology_section
    assert topology_section["stranded"] == stranded, topology_section
    expected = round(1.0 - largest / free, 4) if free else 0.0
    assert abs(topology_section["score"] - expected) < 1e-6, \
        f"score {topology_section['score']} != {expected} " \
        f"(largest {largest} / free {free})"
    for node, n in sorted(nodes.items()):
        assert 0 <= n["largest_free_block"] <= n["free"], (node, n)
        assert 0 <= n["stranded"] <= n["free"], (node, n)
        assert sum(n.get("free_components") or []) == n["free"], (node, n)
    for cand in topology_section.get("defrag_candidates") or []:
        assert cand["gain"] > 0, cand
        assert cand["node"] in nodes, cand


def assert_defrag_invariants(broker, store=None, actuator=None) -> None:
    """The defragmenter's safety contract (master/defrag.py), checkable
    at ANY settled instant of a chaos plan:

    1. **No move on a busy lease**: every lease the defragmenter names —
       a journaled record or a standing plan — is idle (the broker's
       ``idle_since_unix`` signal every interlock gates on). A busy
       lease in the plan set means an interlock was skipped.
    2. **No group below strength mid-move**: a group named by any defrag
       record holds AT LEAST its recorded membership — grow-first means
       the old member leaves only after the new one landed, so a
       shrunken group under an open record is a degrading move.
    3. **No orphaned journal records**: ``planned`` records correspond
       to standing plans in the live actuator; ``acting`` records exist
       only while a move (or its failover adoption) is genuinely in
       flight. With no actuator (``TPU_DEFRAG_MODE=0`` or a plan that
       never enabled one), the journal must be empty — a record nobody
       will ever adopt is leaked intent. No record is torn.
    """
    records = []
    if store is not None:
        for shard in range(store.ring.shards):
            shard_records, torn = store.rehydrate_defrag_moves(shard)
            assert torn == 0, \
                f"shard {shard}: {torn} torn defrag record(s)"
            records.extend(shard_records)
    if actuator is None:
        assert not records, \
            f"{len(records)} defrag record(s) journaled with no " \
            f"actuator to ever adopt them: " \
            f"{[(r.group, r.pod, r.state) for r in records]}"
        return
    with actuator._lock:
        plans = {(p["namespace"], p["group"], p["pod"])
                 for p in actuator._plans.values()}
        inflight = actuator._inflight
        adopting = set(actuator._adopting)
    named = [(r.namespace, r.pod, r.group, r.hosts) for r in records]
    for record in records:
        key = (record.namespace, record.group, record.pod)
        if record.state == "planned":
            assert key in plans, \
                f"ORPHANED defrag record: planned move {key} has no " \
                f"standing plan in the actuator"
        else:
            assert inflight > 0 or adopting, \
                f"ORPHANED defrag record: acting move {key} with no " \
                f"move in flight and no adoption running"
    groups = broker.leases.groups()
    for namespace, pod, group, hosts in named:
        members = groups.get(group) or []
        if members and hosts:
            assert len(members) >= hosts, \
                f"group {group} BELOW STRENGTH mid-move: " \
                f"{len(members)} member(s), record says {hosts}"
    with actuator._lock:
        standing = [dict(p) for p in actuator._plans.values()]
    for plan in standing + [
            {"namespace": r.namespace, "pod": r.pod} for r in records]:
        lease = broker.leases.get(plan["namespace"], plan["pod"])
        if lease is None:
            continue    # already moved or released — nothing to judge
        assert lease.idle_since_unix is not None, \
            f"defrag names BUSY lease {plan['namespace']}/" \
            f"{plan['pod']} (no idle signal): an interlock was skipped"


def assert_broker_invariants(broker, sim, store=None,
                             health=None) -> None:
    """The broker-layer contract after any contention, lease-race,
    restart or failover scenario:

    1. **Lease table mirrors cluster ground truth**: the GPUs the broker
       accounts per owner pod are exactly the GPUs that owner's
       (non-warm) slave pods hold in the kubelet's assignment table.
    2. **No queue residue**: every waiter has returned.
    3. **Store mirrors the same truth** (``store`` given — the HA
       cross-replica view): the persisted lease records across ALL
       shards account exactly the ground-truth GPUs, and no waiter or
       slice txn record outlives its resolution — what a failed-over
       peer would rehydrate is the truth.
    4. **Node-death clauses** (``health`` given — the master's
       NodeHealthTracker): see :func:`assert_node_death_invariants`.

    (The control plane's defrag clause comes with that plane.)
    """
    if health is not None:
        assert_node_death_invariants(broker, health)
    held = _held_by_owner(sim)
    leased = {lease.key: lease.chips for lease in broker.leases.leases()}
    assert leased == held, \
        f"broker lease table {leased} != cluster ground truth {held} " \
        "(leaked reservation or double-release)"
    with broker._lock:
        residue = list(broker._waiters)
    assert not residue, \
        f"{len(residue)} waiter(s) still parked in the broker queue"
    if store is not None:
        stored, waiter_records, slice_records = _store_view(store)
        assert stored == held, \
            f"intent-store lease records {stored} != cluster ground " \
            f"truth {held} (a failed-over peer would rehydrate a lie)"
        assert not waiter_records, \
            f"{len(waiter_records)} waiter record(s) outlived their " \
            f"resolution: {[w.rid for w in waiter_records]}"
        assert not slice_records, \
            f"{len(slice_records)} slice txn record(s) outlived their " \
            f"resolution: {[r.txn_id for r in slice_records]}"


def assert_slice_invariants(broker, sims, kube=None, store=None,
                            health=None) -> None:
    """The multi-host slice contract after any slice scenario (competing
    gangs, resizes, rollbacks): **zero half-attached slices**, judged
    against cluster ground truth across EVERY simulated node.

    1. The broker's lease table accounts exactly the GPUs held across
       all nodes.
    2. Every slave pod stamped with a slice txn id that still holds GPUs
       is backed by a slice-GROUP lease — a txn either committed
       everywhere or rolled back everywhere.
    3. No gang waiter is still parked.
    4. ``store`` given: no slice txn record outlives its resolution and
       none is torn; persisted lease records match ground truth — what a
       failed-over peer would rehydrate is the truth.
    5. ``health`` given: the node-death clauses
       (:func:`assert_node_death_invariants`) — no lease on a dead node,
       no group mixing fenced and live members.
    6. Re-federation barrier sanity: joined ⊆ membership, and a COMPLETE
       barrier has every member joined.
    7. ``kube`` given (the master's apiserver view): no mixed-generation
       world — every member pod of a group carries the same
       ``tpumounter.io/mesh-generation`` annotation (where stamped).
    """
    if health is not None:
        assert_node_death_invariants(broker, health)
    held: dict[tuple[str, str], int] = {}
    txn_holders: dict[str, set[tuple[str, str]]] = {}
    for sim in sims:
        for pod in sim.slave_pods():
            labels = objects.labels(pod)
            if labels.get(consts.WARM_POD_LABEL_KEY) == \
                    consts.WARM_POD_LABEL_VALUE:
                continue
            owner_ns = labels.get(consts.OWNER_NAMESPACE_LABEL_KEY)
            owner = labels.get(consts.OWNER_POD_LABEL_KEY)
            if not owner or not owner_ns:
                continue
            pkey = (objects.namespace(pod), objects.name(pod))
            gpus = sum(
                len(ids)
                for containers in (sim.podresources.assignments.get(pkey)
                                   or {}).values()
                for ids in containers.values())
            if not gpus:
                continue
            held[(owner_ns, owner)] = held.get((owner_ns, owner), 0) \
                + gpus
            txn = labels.get(consts.TXN_LABEL_KEY)
            if txn:
                txn_holders.setdefault(txn, set()).add((owner_ns, owner))
    leased = {lease.key: lease.chips for lease in broker.leases.leases()}
    assert leased == held, \
        f"broker lease table {leased} != multi-node cluster ground " \
        f"truth {held} (leaked slice reservation or double-release)"
    for txn, owners in sorted(txn_holders.items()):
        for owner in sorted(owners):
            lease = broker.leases.get(*owner)
            assert lease is not None and lease.group, \
                f"HALF-ATTACHED SLICE: txn {txn} holder {owner[0]}/" \
                f"{owner[1]} holds GPUs without a slice-group lease"
    with broker._lock:
        gangs = [w for w in broker._waiters if w.gang]
    assert not gangs, \
        f"{len(gangs)} gang waiter(s) still parked: " \
        f"{[w.rid for w in gangs]}"
    manager = getattr(broker, "_slice", None)
    if manager is not None:
        with manager._lock:
            barriers = {group: (set(b.joined), set(b.members),
                                b.completed_unix is not None,
                                b.generation)
                        for group, b in manager._barriers.items()}
        for group, (joined, members, complete, gen) in \
                sorted(barriers.items()):
            assert joined <= members, \
                f"barrier for group {group} gen {gen} counts joins " \
                f"from non-members: {sorted(joined - members)}"
            if complete:
                assert joined == members, \
                    f"MIXED-GENERATION WORLD: barrier for group " \
                    f"{group} gen {gen} answered complete with only " \
                    f"{sorted(joined)} of {sorted(members)} joined"
    if kube is not None:
        for group, members in sorted(broker.leases.groups().items()):
            generations: set[str] = set()
            for lease in members:
                try:
                    pod = kube.get_pod(lease.namespace, lease.pod)
                except (PodNotFoundError, K8sApiError):
                    continue    # an absent pod has no annotation
                raw = (pod.get("metadata", {}).get("annotations")
                       or {}).get(consts.MESH_GENERATION_ANNOTATION)
                if raw is not None:
                    generations.add(raw)
            assert len(generations) <= 1, \
                f"MIXED-GENERATION WORLD: group {group} members " \
                f"carry mesh generations {sorted(generations)}"
    if store is not None:
        stored, _, leftovers = _store_view(store)
        assert stored == held, \
            f"intent-store lease records {stored} != cluster ground " \
            f"truth {held} (a failed-over peer would rehydrate a lie)"
        assert not leftovers, \
            f"slice txn record(s) outlived resolution: " \
            f"{[r.txn_id for r in leftovers]}"


def assert_checkpoint_invariants(root: str) -> None:
    """The sharded-checkpoint durability contract of
    ``torchcheck/drain.py``, checkable at any instant of a transition:

    1. If anything ever committed, ``LATEST`` names a generation directory
       that still exists: no checkpoint is deleted while it is the sole
       surviving copy (pruning runs only in the commit path, after the
       successor is durable).
    2. The committed generation validates end to end: its manifest is
       present and well formed, and every shard it names is present with
       its size and checksum, so what a crashed member would restore at
       its next boot is whole.
    """
    from gpumounter_tpu_torch.torchcheck import drain as drain_lib
    latest = drain_lib.latest_generation(root)
    if latest is None:
        return                    # nothing ever committed: vacuous
    gens = drain_lib.list_generations(root)
    assert latest in gens, \
        f"LATEST names gen-{latest} but only {gens} exist under " \
        f"{root}: the sole surviving copy was deleted"
    manifest = drain_lib._load_manifest(root, latest)
    drain_lib._verify_shards(root, latest, manifest)


def assert_invariants(rig, expected_uuids: set[str],
                      owner: str = "workload",
                      namespace: str = "default",
                      max_attached_events: int | None = None,
                      held: set[str] = frozenset()) -> None:
    """The post-plan contract every chaos scenario must uphold.

    ``expected_uuids``: GPUs the surviving state should grant the owner
    (empty set = the attach must have rolled back / reverted completely).
    ``held``: container paths of the nodes the runtime gave the
    container before any attach (they stay through every plan).

    1. **No leaked reservations**: the slave pods holding GPUs are
       exactly the ones backing ``expected_uuids`` — a failed attach left
       none behind, a converged one leaked no extras.
    2. **No partial device grants**: the device nodes present in the
       owner's container are exactly the expected GPUs' nodes, their
       companions (``nvidiactl`` and the uvm pair ride with any GPU) and
       ``held`` — a detach that left a companion behind fails here.
    3. **No journal backlog**: every journaled intent reached a terminal
       state (committed/reverted).
    4. **Idempotency**: across every retry/replay, at most ONE logical
       GPUAttached event per logical attach (resumes record
       GPUAttachResumed instead).
    5. **Gate == ground truth** (gated rigs): the GPUs the device gate
       grants are exactly ``expected_uuids`` — no GPU is accessible
       (gate-granted) without a live attachment backing it, and no live
       attachment lost its grant.
    """
    sim = rig.sim
    # 1. reservations: GPUs assigned to live non-warm slave pods
    granted_slaves: set[str] = set()
    for pod in sim.slave_pods():
        labels = objects.labels(pod)
        if labels.get(consts.WARM_POD_LABEL_KEY) == \
                consts.WARM_POD_LABEL_VALUE:
            continue
        key = (objects.namespace(pod), objects.name(pod))
        for containers in (sim.podresources.assignments.get(key) or {}
                           ).values():
            for ids in containers.values():
                granted_slaves.update(ids)
    assert granted_slaves == expected_uuids, \
        f"slave-pod reservations {sorted(granted_slaves)} != expected " \
        f"{sorted(expected_uuids)} (leak or lost grant)"

    # 2. device nodes actually present in the owner's container. A
    # recording rig is asked directly; a procroot (or agent-over-procroot)
    # rig is audited from the fixture tree itself — the files under
    # <proc>/<pid>/root are the ground truth the agent/fallback wrote.
    gpus_by_uuid = {g.uuid: g for g in sim.enumerator.enumerate()}
    expected_paths = set(held)
    for uuid in expected_uuids:
        gpu = gpus_by_uuid[uuid]
        expected_paths.add(gpu.container_path)
        expected_paths.update(c.container_path for c in gpu.companions)
    if hasattr(rig.actuator, "created"):
        created_paths = {path for _, path, _, _ in rig.actuator.created}
        created_paths |= set(held)
    else:
        created_paths = _fixture_device_nodes(rig)
    assert created_paths == expected_paths, \
        f"device nodes {sorted(created_paths)} != expected " \
        f"{sorted(expected_paths)} (partial grant)"

    # 3. journal fully resolved
    backlog = rig.service.journal.backlog() \
        if rig.service.journal is not None else 0
    assert backlog == 0, \
        f"journal still holds {backlog} incomplete record(s)"

    # 5. gate state mirrors ground truth, audited from the rig's LIVE
    # gate (post-restart rigs carry the rebuilt one)
    gate = getattr(rig, "gate", None)
    if gate is not None and gate.live:
        granted = gate.granted_uuids()
        assert granted == expected_uuids, \
            f"gate grants {sorted(granted)} != expected " \
            f"{sorted(expected_uuids)} (a GPU is accessible without a " \
            "live lease/attachment, or a lease lost its grant)"

    # 4. <= one logical GPUAttached per attach. Default: one when GPUs are
    # expected, zero when the plan should have reverted everything; a test
    # that legitimately attached then detached passes its own bound.
    if max_attached_events is None:
        max_attached_events = 1 if expected_uuids else 0
    wait_events_drained(rig.service)
    attached = [e for e in sim.kube.events
                if e.get("reason") == "GPUAttached"]
    assert len(attached) <= max_attached_events, \
        f"double GPUAttached: {[e['message'] for e in attached]}"
