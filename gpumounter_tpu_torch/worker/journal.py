"""Crash-safe attach journal: write-ahead intent records for actuation.

The port's own copy of :mod:`gpumounter_tpu.worker.journal`.

The worker mutates state the Kubernetes control plane cannot see — cgroup
device programs and device nodes inside the target container. A worker
crash between "slave pods allocated" and "actuation finished" used to
leave that half-written state invisible to every repair loop: the
reconciler (worker/reconciler.py) only reasons about slave pods whose
OWNER died, and the request-id adoption machinery only helps if the
caller retries. A pod could keep device access nobody accounted for.

This journal closes the window with the classic write-ahead pattern:

1. ``begin()`` appends an **intent** record (request id, owner pod,
   device uuids, slave pods) to a node-local JSONL file *before* any
   cgroup/mknod actuation;
2. ``commit()`` marks it done after actuation + audit events succeed;
3. ``revert()`` marks it undone after a clean rollback, and
   ``revert_pending()`` records a rollback that was itself interrupted
   (e.g. the apiserver died mid-revert) so the remainder is not lost.

On startup the worker replays every record that is not terminal
(worker/service.py ``replay_journal``): it re-derives ground truth from
the cluster — owner pod liveness, surviving slave pods, the kubelet's
device assignments — then either *completes* the attach (actuation is
idempotent: existing device nodes short-circuit, cgroup sync is
whole-set) or *reverts* it (unmount + release the slave pods). Either
way, a crash mid-attach can no longer leak device access.

Every line is one JSON object (append-only; a torn final line from the
crash itself is detected and dropped). ``compact()`` rewrites the file
to just the still-incomplete records after replay, so the journal stays
small across restarts. Durability note: appends are flushed to the OS on
every event, which survives any process crash; ``fsync=True`` adds
power-loss durability at ~ms write cost.

Served as ``GET /journalz`` on the worker health port alongside
``/poolz`` and ``/tracez``; replay outcomes feed
``tpumounter_journal_replays_total{outcome}``.
"""

from __future__ import annotations

import json
import os
import secrets
import threading
import time

from gpumounter_tpu_torch.utils.events import EVENTS
from gpumounter_tpu_torch.utils.log import get_logger

logger = get_logger("worker.journal")

# Record lifecycle: intent -> committed | reverted, with revert_pending as
# the "rollback started but did not finish" intermediate. intent and
# revert_pending are the INCOMPLETE states startup replay must resolve.
INCOMPLETE_STATES = ("intent", "revert_pending")
# Device-gate mutations (actuation/gate.py) journal around actuation the
# same way: a ``gate`` record before the backend sync, ``gate_commit``
# after. gate_pending records are resolved by the startup gate
# CONVERGENCE (desired map contents re-derived from attachment ground
# truth), not by the per-record attach replay — they get their own
# incomplete state so ``incomplete()``/``backlog()`` keep their
# attach-record semantics (alerts, /journalz) unchanged.
GATE_PENDING_STATE = "gate_pending"
# A container's companion baseline (actuation/gate.py ``DeviceGate.held``):
# the char nodes its /dev held before its first grant. ``baseline``
# records live apart from the attach records (no jid, no state): they
# never enter ``incomplete()``, ``backlog()`` or /journalz, survive
# ``compact()`` while the container's cgroup dir exists, and a
# ``baseline_drop`` record forgets one.


class AttachJournal:
    """Append-only JSONL journal of attach actuations on one node."""

    def __init__(self, path: str, fsync: bool = False):
        self.path = path
        self.fsync = fsync
        self._lock = threading.Lock()
        # jid -> {"state": ..., **intent payload}; insertion order is
        # journal order (Python dicts preserve it), so replay handles
        # crashes in the order the attaches happened.
        self._records: dict[str, dict] = {}
        # container key (cgroup dir) -> its held (major, minor) pairs, or
        # None where the baseline could not be read
        self._baselines: dict[str, set[tuple[int, int]] | None] = {}
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._load()

    # -- persistence -----------------------------------------------------------

    def _load(self) -> None:
        if not os.path.exists(self.path):
            return
        dropped = 0
        with open(self.path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    event = json.loads(line)
                except json.JSONDecodeError:
                    # a torn final line IS the crash signature — the event
                    # it described never fully happened; drop it
                    dropped += 1
                    continue
                self._apply(event)
        if dropped:
            logger.warning("journal %s: dropped %d torn line(s)",
                           self.path, dropped)
        backlog = len(self.incomplete())
        if backlog:
            logger.warning("journal %s: %d incomplete attach record(s) "
                           "await replay", self.path, backlog)

    def _apply(self, event: dict) -> None:
        kind = event.get("event")
        if kind == "baseline":
            held = event.get("held")
            self._baselines[event["key"]] = (
                None if held is None else {tuple(mm) for mm in held})
            return
        if kind == "baseline_drop":
            self._baselines.pop(event["key"], None)
            return
        jid = event.get("jid")
        if not jid:
            return
        if kind == "intent":
            record = dict(event)
            record.pop("event", None)
            record["state"] = "intent"
            self._records[jid] = record
        elif kind == "detach":
            # Terminal audit record (never replayed): who released these
            # devices and why — preemptions / lease expiries are
            # explainable from the node alone.
            record = dict(event)
            record.pop("event", None)
            record["state"] = "detached"
            self._records[jid] = record
        elif kind == "gate":
            record = dict(event)
            record.pop("event", None)
            record["state"] = GATE_PENDING_STATE
            self._records[jid] = record
        elif jid in self._records and kind in ("commit", "revert",
                                               "revert_pending",
                                               "gate_commit"):
            self._records[jid]["state"] = {
                "commit": "committed", "revert": "reverted",
                "revert_pending": "revert_pending",
                "gate_commit": "gate_done"}[kind]

    def _append(self, event: dict) -> None:
        line = json.dumps(event, sort_keys=True)
        with open(self.path, "a") as f:
            f.write(line + "\n")
            f.flush()
            if self.fsync:
                os.fsync(f.fileno())

    # -- write side (the attach path) ------------------------------------------

    def begin(self, rid: str, namespace: str, pod: str, uid: str,
              devices: list[str], slaves: list[str],
              entire: bool) -> str:
        """Append the intent record BEFORE actuation; returns the journal
        id the later commit/revert cites."""
        jid = f"{rid or 'txn'}-{secrets.token_hex(4)}"
        event = {"jid": jid, "event": "intent", "rid": rid,
                 "namespace": namespace, "pod": pod, "uid": uid,
                 "devices": sorted(devices), "slaves": sorted(slaves),
                 "entire": entire, "ts": round(time.time(), 3)}
        with self._lock:
            self._append(event)
            self._apply(event)
        # every journal record is a lifecycle transition: paired event
        # emission (tests/test_events_lint.py pins the pairing)
        EVENTS.emit("journal_intent", rid=rid, namespace=namespace,
                    pod=pod, chips=len(devices), jid=jid)
        return jid

    def _mark(self, jid: str, kind: str) -> None:
        with self._lock:
            if jid not in self._records:
                logger.warning("journal %s: %s for unknown jid %s",
                               self.path, kind, jid)
                return
            event = {"jid": jid, "event": kind,
                     "ts": round(time.time(), 3)}
            self._append(event)
            self._apply(event)
            record = self._records.get(jid, {})
        EVENTS.emit(f"journal_{kind}", rid=record.get("rid", ""),
                    namespace=record.get("namespace", ""),
                    pod=record.get("pod", ""), jid=jid)

    def record_detach(self, rid: str, namespace: str, pod: str,
                      devices: list[str], cause: str = "",
                      force: bool = False) -> str:
        """Append a terminal detach record AFTER a successful detach —
        pure audit (nothing to replay: the cluster is already consistent),
        carrying the caller's cause (``preempted:...``,
        ``lease-expired:...``, empty for owner-initiated)."""
        jid = f"detach-{rid or 'manual'}-{secrets.token_hex(4)}"
        event = {"jid": jid, "event": "detach", "rid": rid,
                 "namespace": namespace, "pod": pod,
                 "devices": sorted(devices), "cause": cause,
                 "force": force, "ts": round(time.time(), 3)}
        with self._lock:
            self._append(event)
            self._apply(event)
        EVENTS.emit("journal_detach", rid=rid, namespace=namespace,
                    pod=pod, chips=len(devices), jid=jid, cause=cause,
                    force=force)
        return jid

    def record_gate(self, rid: str, namespace: str, pod: str, op: str,
                    devices: list[str], key: str = "",
                    cause: str = "") -> str:
        """Append a device-gate mutation intent BEFORE the backend sync
        (``op`` grant|revoke; ``key`` = container cgroup dir; ``cause``
        rides broker revocations). A crash between this record and its
        ``gate_commit`` leaves a gate_pending record the startup gate
        convergence resolves — a gate grant can no more outlive a crash
        unaccounted than a mknod can."""
        jid = f"gate-{rid or 'local'}-{secrets.token_hex(4)}"
        event = {"jid": jid, "event": "gate", "rid": rid,
                 "namespace": namespace, "pod": pod, "op": op,
                 "devices": sorted(devices), "key": key, "cause": cause,
                 "ts": round(time.time(), 3)}
        with self._lock:
            self._append(event)
            self._apply(event)
        EVENTS.emit("journal_gate", rid=rid, namespace=namespace, pod=pod,
                    op=op, chips=len(devices), jid=jid, cause=cause)
        return jid

    def record_baseline(self, key: str,
                        held: set[tuple[int, int]] | None) -> None:
        """Persist a container's companion baseline, observed before its
        first grant (``key`` = container cgroup dir; ``held`` None = not
        readable then). A restarted worker's gate reads it back through
        :meth:`baselines`: after an attach, /dev no longer tells a
        companion the runtime gave from one the attach added."""
        event = {"event": "baseline", "key": key,
                 "held": None if held is None else sorted(held),
                 "ts": round(time.time(), 3)}
        with self._lock:
            self._append(event)
            self._apply(event)
        EVENTS.emit("journal_baseline", key=key,
                    held=None if held is None else len(held))

    def drop_baseline(self, key: str) -> None:
        """Forget a container's baseline (its gate state was reclaimed)."""
        event = {"event": "baseline_drop", "key": key,
                 "ts": round(time.time(), 3)}
        with self._lock:
            if key not in self._baselines:
                return
            self._append(event)
            self._apply(event)
        EVENTS.emit("journal_baseline_drop", key=key)

    def baselines(self) -> dict[str, set[tuple[int, int]] | None]:
        """Every persisted companion baseline, by container key."""
        with self._lock:
            return {key: None if held is None else set(held)
                    for key, held in self._baselines.items()}

    def gate_commit(self, jid: str) -> None:
        self._mark(jid, "gate_commit")

    def pending_gates(self) -> list[dict]:
        """Gate mutations whose commit never landed (crash mid-sync), in
        journal order — what startup convergence resolves."""
        with self._lock:
            return [dict(r) for r in self._records.values()
                    if r["state"] == GATE_PENDING_STATE]

    def commit(self, jid: str) -> None:
        self._mark(jid, "commit")

    def revert(self, jid: str) -> None:
        self._mark(jid, "revert")

    def revert_pending(self, jid: str) -> None:
        self._mark(jid, "revert_pending")

    # -- read side (replay + /journalz) ----------------------------------------

    def incomplete(self) -> list[dict]:
        """Records startup replay must resolve, in journal order."""
        with self._lock:
            return [dict(r) for r in self._records.values()
                    if r["state"] in INCOMPLETE_STATES]

    def backlog(self) -> int:
        return len(self.incomplete())

    def compact(self) -> None:
        """Rewrite the file keeping only incomplete records (terminal ones
        are history the trace/event stores already tell better) and the
        baselines of containers whose cgroup dir still exists."""
        with self._lock:
            keep = [r for r in self._records.values()
                    if r["state"] in INCOMPLETE_STATES
                    or r["state"] == GATE_PENDING_STATE]
            self._baselines = {key: held for key, held
                               in self._baselines.items()
                               if os.path.isdir(key)}
            tmp = self.path + ".tmp"
            with open(tmp, "w") as f:
                for key, held in sorted(self._baselines.items()):
                    f.write(json.dumps(
                        {"event": "baseline", "key": key,
                         "held": None if held is None else sorted(held)},
                        sort_keys=True) + "\n")
                for record in keep:
                    intent = {k: v for k, v in record.items()
                              if k != "state"}
                    intent["event"] = ("gate" if record["state"]
                                       == GATE_PENDING_STATE else "intent")
                    f.write(json.dumps(intent, sort_keys=True) + "\n")
                    if record["state"] == "revert_pending":
                        f.write(json.dumps(
                            {"jid": record["jid"],
                             "event": "revert_pending",
                             "ts": round(time.time(), 3)}) + "\n")
                f.flush()
                if self.fsync:
                    os.fsync(f.fileno())
            os.replace(tmp, self.path)
            self._records = {r["jid"]: r for r in keep}

    def snapshot(self) -> dict:
        """The /journalz payload: backlog + recent record states."""
        from gpumounter_tpu_torch.utils.metrics import REGISTRY
        with self._lock:
            records = [dict(r) for r in self._records.values()]
        incomplete = [r for r in records
                      if r["state"] in INCOMPLETE_STATES]
        payload_gate = len([r for r in records
                            if r["state"] == GATE_PENDING_STATE])
        return {
            "path": self.path,
            "backlog": len(incomplete),
            "incomplete": incomplete,
            # key present only when gate records exist: a legacy-mode
            # worker's /journalz stays byte-for-byte the pre-gate payload
            **({"gate_pending": payload_gate} if payload_gate else {}),
            "records": records[-64:],
            "replays": {outcome: int(REGISTRY.journal_replays.value(
                outcome=outcome))
                for outcome in ("completed", "reverted", "noop", "failed")},
        }
