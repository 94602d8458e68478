"""Master-side node health state machine: the node failure domain (the
port of :mod:`gpumounter_tpu.master.nodehealth`).

Without it a WORKER or NODE dying in steady state is unhandled: leases on
a vanished node strand in the table, a slice keeps limping on n-1 hosts
with no repair, and the expired-lease reaper retries a dead worker
forever. This module is the detection half of that failure domain — it
folds two independent signal sources into one per-node
``healthy → suspect → dead`` state machine:

- **fleet scrape staleness** (master/fleet.py): every tick the
  aggregator reports which workers answered their health port and which
  missed; consecutive misses escalate suspect → dead. Suspicion
  requires PRIOR liveness evidence — a node whose health port was never
  reachable is a deploy problem, not a death, and absence of telemetry
  must never fence a lease.
- **k8s Node conditions and taints** (polled through the normal
  KubeClient, throttled per node): a NotReady condition corroborates
  the silence (NotReady + missed scrapes ⇒ dead without waiting the
  full dead-tick window), ``spec.unschedulable`` and termination taints
  (spot/preemption notices, autoscaler scale-down) cordon the node, and
  a worker answering ``draining`` on its healthz (worker/drain.py)
  moves it to the ``draining`` state within one fleet tick.

State semantics:

- ``healthy`` — full service.
- ``draining`` — the worker announced a graceful drain: cordoned from
  NEW grants, live leases untouched (they detach through the normal
  path); slices with members here are proactively migrated.
- ``suspect`` — cordoned from NEW grants (broker admission and slice
  repair placement skip it) without touching live leases: a transient
  network blip must not cost anyone their GPUs.
- ``dead`` — the leases are fenced through the broker's one-way
  eviction seam (``fence_lease``) and slice groups with members here
  self-heal (master/slicetxn.py ``repair_group``). Ground truth (slave
  pods) is cleaned cluster-side, so a zombie worker rejoining converges
  its gate/journal against the fenced state and cannot resurrect a
  grant.

Hysteresis both ways: escalation needs the configured consecutive
misses, recovery needs ``recover_ticks`` consecutive clean scrapes — a
flapping health port cannot cycle cordon state per tick. Every
transition goes through ONE seam (``_set_state``) that emits the paired
lifecycle event and moves ``node_health_state{node}``
(tests/test_torch_nodehealth_lint.py pins both).

``TPU_NODE_HEALTH=0`` removes the tracker entirely — no /fleetz
section, no series, no fencing.
"""

from __future__ import annotations

import threading
import time

from gpumounter_tpu_torch.utils import consts
from gpumounter_tpu_torch.utils.errors import K8sApiError
from gpumounter_tpu_torch.utils.events import EVENTS
from gpumounter_tpu_torch.utils.log import get_logger
from gpumounter_tpu_torch.utils.metrics import REGISTRY

logger = get_logger("master.nodehealth")

# Gauge encoding of the state machine (tpumounter_node_health_state).
STATES = ("healthy", "draining", "suspect", "dead")
# How many consecutive ingest passes may omit a node before its record
# is forgotten (the worker pod was deleted — nothing left to judge).
FORGET_AFTER_TICKS = 120
# Ready-node veto: how long a RECENT k8s Ready=True observation holds
# scrape silence at suspect instead of dead. A crash-looping WORKER
# image (every health port silent fleet-wide, every Node Ready) must
# cordon, not fence the fleet's leases; a truly dead node stops
# heartbeating and Ready goes False/Unknown within the kubelet's
# node-monitor grace (~40s), after which the veto lapses and the dead
# window applies.
READY_VETO_S = 60.0


def enabled(env: dict | None = None) -> bool:
    """Is the node-failure subsystem on? Default ON; TPU_NODE_HEALTH=0
    reverts to byte-for-byte pre-subsystem behavior."""
    import os
    env = os.environ if env is None else env
    return env.get(consts.ENV_NODE_HEALTH, "1") != "0"


class _NodeHealth:
    __slots__ = ("node", "state", "reason", "since_unix", "missed_ticks",
                 "fresh_streak", "observed_ever", "absent_ticks",
                 "last_node_poll", "k8s_reason", "last_ready_mono",
                 "dead_handled", "drain_handled")

    def __init__(self, node: str):
        self.node = node
        self.state = "healthy"
        self.reason = ""
        self.since_unix = time.time()
        self.missed_ticks = 0
        self.fresh_streak = 0
        # suspicion needs prior liveness evidence: set on the first
        # successful scrape, never cleared
        self.observed_ever = False
        self.absent_ticks = 0
        self.last_node_poll = 0.0
        self.k8s_reason = ""        # "" | notready | unschedulable |
        #                             termination-taint
        # monotonic time of the last k8s poll that saw Ready=True —
        # the Ready-node veto's evidence (0 = never confirmed)
        self.last_ready_mono = 0.0
        self.dead_handled = False   # on_dead fired for this death
        self.drain_handled = False  # on_drain fired for this cordon

    def to_json(self) -> dict:
        out = {
            "state": self.state,
            "since_unix": round(self.since_unix, 3),
            "missed_ticks": self.missed_ticks,
        }
        if self.reason:
            out["reason"] = self.reason
        if self.k8s_reason:
            out["k8s"] = self.k8s_reason
        return out


class NodeHealthTracker:
    """One per master gateway; fed by the fleet aggregator's tick.

    ``on_dead(node)`` fires exactly once per transition into ``dead``
    (the broker fences the node's leases and kicks slice self-healing);
    ``on_drain(node)`` fires once per transition into ``draining`` or
    termination-taint ``suspect`` (proactive slice migration). Both run
    on the fleet tick thread — they must hand real work to threads.
    """

    def __init__(self, kube=None, on_dead=None, on_drain=None,
                 suspect_after_ticks: int =
                 consts.DEFAULT_NODE_SUSPECT_TICKS,
                 dead_after_ticks: int = consts.DEFAULT_NODE_DEAD_TICKS,
                 recover_ticks: int = consts.DEFAULT_NODE_RECOVER_TICKS,
                 node_poll_interval_s: float =
                 consts.DEFAULT_NODE_POLL_INTERVAL_S):
        self.kube = kube
        self.on_dead = on_dead
        self.on_drain = on_drain
        self.suspect_after_ticks = max(1, int(suspect_after_ticks))
        self.dead_after_ticks = max(self.suspect_after_ticks + 1,
                                    int(dead_after_ticks))
        self.recover_ticks = max(1, int(recover_ticks))
        self.node_poll_interval_s = node_poll_interval_s
        self._lock = threading.Lock()
        self._nodes: dict[str, _NodeHealth] = {}

    # -- reads (the cordon surface) --------------------------------------------

    def state(self, node: str) -> str:
        """The node's judged state; nodes never observed are healthy —
        absence of data is not suspicion."""
        with self._lock:
            record = self._nodes.get(node)
            return record.state if record is not None else "healthy"

    def cordoned(self, node: str) -> bool:
        """Should NEW grants skip this node? True for every non-healthy
        state — suspect/draining cordon without touching live leases."""
        return self.state(node) != "healthy"

    def snapshot(self) -> dict:
        with self._lock:
            nodes = {name: record.to_json()
                     for name, record in sorted(self._nodes.items())}
        return {
            "enabled": True,
            "suspect_after_ticks": self.suspect_after_ticks,
            "dead_after_ticks": self.dead_after_ticks,
            "recover_ticks": self.recover_ticks,
            "nodes": nodes,
        }

    # -- the state machine (driven by the fleet tick) --------------------------

    def ingest(self, scrapes: dict[str, dict]) -> None:
        """One fleet tick's per-node scrape outcome:
        ``{node: {"fresh": bool, "missed_ticks": int, "healthz": str}}``.
        Folds in throttled k8s Node condition/taint polls and advances
        every node's state. Nodes absent from ``scrapes`` long enough
        are forgotten (their worker pod is gone)."""
        # k8s Node polls run OUTSIDE the tracker lock: state()/cordoned()
        # sit on the attach admission hot path, and a slow apiserver
        # (exactly the degraded condition this subsystem exists for)
        # must not serialize attaches behind its GETs
        due: list[str] = []
        now = time.monotonic()
        with self._lock:
            for node in scrapes:
                record = self._nodes.get(node)
                if record is None:
                    record = self._nodes[node] = _NodeHealth(node)
                if self.kube is not None and now - record.last_node_poll \
                        >= self.node_poll_interval_s:
                    record.last_node_poll = now
                    due.append(node)
        polled = {node: self._poll_node_conditions(node) for node in due}
        callbacks: list[tuple] = []
        with self._lock:
            for node, info in scrapes.items():
                record = self._nodes.get(node)
                if record is None:
                    continue
                record.absent_ticks = 0
                verdict = polled.get(node)
                if verdict is not None:
                    record.k8s_reason = verdict[0]
                    if verdict[1]:
                        record.last_ready_mono = time.monotonic()
                self._advance_locked(record, info, callbacks)
            for node in list(self._nodes):
                if node not in scrapes:
                    record = self._nodes[node]
                    record.absent_ticks += 1
                    if record.absent_ticks >= FORGET_AFTER_TICKS:
                        # zeroed ONCE then forgotten (the repo's
                        # vanished-series discipline): a decommissioned
                        # dead node must not page TPUMounterNodeDead
                        # for the master's lifetime
                        REGISTRY.node_health_state.set(0.0, node=node)
                        del self._nodes[node]
        # callbacks OUTSIDE the lock: fencing/repair read broker state
        # that may call back into state()
        for kind, node in callbacks:
            try:
                if kind == "dead" and self.on_dead is not None:
                    self.on_dead(node)
                elif kind == "drain" and self.on_drain is not None:
                    self.on_drain(node)
            except Exception:    # noqa: BLE001 — a failed handler must
                logger.exception(  # not kill the fleet tick loop
                    "node %s %s handler failed", node, kind)

    def _advance_locked(self, record: _NodeHealth, info: dict,
                        callbacks: list) -> None:
        fresh = bool(info.get("fresh"))
        healthz = str(info.get("healthz") or "")
        if fresh:
            record.observed_ever = True
            record.missed_ticks = 0
        else:
            record.missed_ticks = int(info.get("missed_ticks")
                                      or (record.missed_ticks + 1))
        draining = fresh and "draining" in healthz
        target, reason = self._target_locked(record, fresh, draining)
        # the recovery streak counts CLEAN SCRAPES only: a missed tick
        # below the suspect threshold still targets "healthy", but it
        # is not evidence of recovery — a flapping port alternating
        # hit/miss must never complete the streak on a miss
        if fresh and target == "healthy":
            record.fresh_streak += 1
        else:
            record.fresh_streak = 0
        if target == "healthy" and record.state != "healthy" \
                and record.fresh_streak < self.recover_ticks:
            return              # hysteresis: not enough consecutive evidence
        if target != record.state:
            self._set_state(record, target, reason)
            if target == "dead" and not record.dead_handled:
                record.dead_handled = True
                callbacks.append(("dead", record.node))
            elif target == "draining" and not record.drain_handled:
                record.drain_handled = True
                callbacks.append(("drain", record.node))
            elif target == "suspect" \
                    and reason == "termination-taint" \
                    and not record.drain_handled:
                # imminent involuntary termination: migrate proactively
                # while the worker still answers
                record.drain_handled = True
                callbacks.append(("drain", record.node))
            if target == "healthy":
                record.dead_handled = False
                record.drain_handled = False

    def _target_locked(self, record: _NodeHealth, fresh: bool,
                       draining: bool) -> tuple[str, str]:
        """The state the evidence supports right now (hysteresis is
        applied by the caller)."""
        if draining:
            return "draining", "healthz"
        missed = record.missed_ticks if record.observed_ever else 0
        if record.k8s_reason == "notready" \
                and missed >= self.suspect_after_ticks:
            # the apiserver corroborates the silence: no need to wait
            # out the full dead window
            return "dead", "notready+scrape-silence"
        if missed >= self.dead_after_ticks:
            if time.monotonic() - record.last_ready_mono < READY_VETO_S \
                    and record.last_ready_mono > 0:
                # Ready-node veto: k8s saw the NODE alive moments ago —
                # the silence is the WORKER's (crash-looping image,
                # blocked health port), and fencing healthy workloads'
                # leases over a mounter-only outage would be the cure
                # being worse than the disease. Cordon and wait: a truly
                # dead node's Ready lapses within the kubelet grace.
                return "suspect", "worker-silent-node-ready"
            return "dead", "scrape-silence"
        if missed >= self.suspect_after_ticks:
            return "suspect", "scrape-silence"
        if record.k8s_reason == "termination-taint":
            return "suspect", "termination-taint"
        if record.k8s_reason:
            return "suspect", record.k8s_reason
        return "healthy", ""

    def _poll_node_conditions(self, node_name: str
                              ) -> tuple[str, bool] | None:
        """One k8s Node read (called OUTSIDE the tracker lock): returns
        ``(k8s_reason, ready_confirmed)`` or None when no new evidence
        was obtainable (unknown/unreadable node — the last observation
        stands and scrape evidence still rules)."""
        try:
            node = self.kube.get_node(node_name)
        except K8sApiError:
            return None       # unknown/unreadable node: no new evidence
        except Exception:     # noqa: BLE001 — never kill the tick
            logger.exception("node %s condition poll failed", node_name)
            return None
        spec = node.get("spec") or {}
        ready = False
        ready_known = False
        for cond in (node.get("status") or {}).get("conditions") or []:
            if cond.get("type") == "Ready":
                ready_known = True
                ready = cond.get("status") == "True"
        taints = {t.get("key") for t in spec.get("taints") or []}
        if taints & set(consts.TERMINATION_TAINT_KEYS):
            return "termination-taint", ready
        if spec.get("unschedulable"):
            return "unschedulable", ready
        if not ready_known:
            # a Node object with no Ready condition (minimal/test
            # objects) is no evidence either way
            return "", False
        return ("" if ready else "notready"), ready

    def _set_state(self, record: _NodeHealth, state: str,
                   reason: str) -> None:
        """THE one transition seam: every state change emits its paired
        lifecycle event and moves the gauge — the nodehealth lint pins
        that no other site writes ``record.state``."""
        prior = record.state
        record.state = state
        record.reason = reason
        record.since_unix = time.time()
        REGISTRY.node_health_state.set(float(STATES.index(state)),
                                       node=record.node)
        EVENTS.emit(f"node_{state}", node=record.node, prior=prior,
                    reason=reason, missed_ticks=record.missed_ticks)
        log = logger.warning if state in ("suspect", "dead") \
            else logger.info
        log("node %s: %s -> %s (%s, %d missed tick(s))", record.node,
            prior, state, reason or "-", record.missed_ticks)
