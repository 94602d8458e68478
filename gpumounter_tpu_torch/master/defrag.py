"""Fleet defragmenter: the optimizer half of the topology plane (the port
of :mod:`gpumounter_tpu.master.defrag`).

master/topology.py measures fragmentation and reports defrag candidates;
this module ACTS on that report, and acting is the dangerous part: a live
migration is a resize the scheduler chose, and an unsafe actuator can
tear down healthy gangs faster than any node failure. The design rule is
that the actuator must be unable to make the fleet worse than doing
nothing:

- **Interlocks** — a candidate must persist ``TPU_DEFRAG_HYSTERESIS_TICKS``
  consecutive fleet ticks before it is eligible; only idle leases (duty
  at most ``TPU_DEFRAG_IDLE_DUTY_MAX``, zero busy GPUs) ever move;
  cordoned/draining/suspect nodes are excluded as source (here and in
  the topology report) and destination (the spare discovery is
  cordon-aware); at most one in-flight move per group (the guard is
  SHARED with ``repair_group`` — a repair always wins) and
  ``TPU_DEFRAG_MAX_INFLIGHT`` fleet-wide; a sliding-window budget
  (``TPU_DEFRAG_BUDGET`` per 30 min) halts the actuator rather than
  letting it thrash.
- **Abort, never degrade** — every move is grow-first through the ONE
  existing actuation path, ``SliceTxnManager.migrate_member`` (the
  repair seam; tests/test_torch_defrag_lint.py pins that this module
  never fences, tears down, or touches the lease table itself). A busy
  refusal, quota cap, or mid-move failure DEFERS with the group intact;
  a post-move check whose score did not improve charges the budget and
  re-arms hysteresis for the group.
- **Crash consistency** — each move is journaled in the intent store
  (``tpumounter.io/defrag-`` records) BEFORE actuation; a failed-over
  leader rehydrates the records and adopts each against the group's
  actual membership: grow landed → finish the detach (new placement);
  grow never landed → drop the record (old placement). Never half-moved.
- **Staged enablement** — ``TPU_DEFRAG_MODE=plan`` (the default)
  computes and journals plans, emits ``defrag_plan`` events and the
  ``/fleetz`` ``defrag.plans`` section, but actuates nothing; ``act``
  executes; ``0`` removes every payload and series.

All telemetry crosses one seam (``_note_move``):
``tpumounter_defrag_moves_total{outcome}`` paired 1:1 with
``defrag_plan``/``defrag_move`` events, plus the ``defrag_inflight``
gauge and the ``/fleetz`` ``defrag`` section.
"""

from __future__ import annotations

import collections
import os
import threading
import time
import uuid as uuid_mod

from gpumounter_tpu_torch.utils import consts
from gpumounter_tpu_torch.utils.errors import StoreFencedError
from gpumounter_tpu_torch.utils.events import EVENTS
from gpumounter_tpu_torch.utils.log import get_logger
from gpumounter_tpu_torch.utils.metrics import REGISTRY

logger = get_logger("master.defrag")

# recent-moves ring served on /fleetz
RECENT_MOVES = 32
# how long an adopted move may poll for its slice txn to resolve before
# the adoption gives up for this rehydration (the record survives; a
# later rehydration retries)
ADOPT_POLL_TIMEOUT_S = 60.0


def mode(env=None) -> str:
    """TPU_DEFRAG_MODE: "0" | "plan" | "act", default "plan"
    (tests/test_torch_defrag_lint.py pins the default)."""
    env = os.environ if env is None else env
    return env.get(consts.ENV_DEFRAG_MODE, "plan")


def enabled(env=None) -> bool:
    return mode(env) != "0"


class DefragActuator:
    """The optimizer tick over the topology plane's candidate report.

    Runs on its OWN thread off the fleet tick (like ``repair_group`` —
    a worker RPC fan-out must never block fleet scraping); tests drive
    :meth:`tick` directly. ``view_fn`` is the master FleetTopology's
    ``snapshot`` (already-computed state: the scored fleet view plus its
    tick counter, which gates hysteresis counting to REAL fleet ticks);
    ``activity_fn`` the aggregator's per-lease activity feed;
    ``node_excluded_fn`` the node-health tracker's cordon judgment;
    ``slices`` the SliceTxnManager whose repair seam executes every
    move; ``store`` the intent store journaling them (None = no
    persistence, plan-only crash semantics)."""

    def __init__(self, *, slices, view_fn, activity_fn=None,
                 node_excluded_fn=None, store=None, mode: str = "plan",
                 hysteresis_ticks: int =
                 consts.DEFAULT_DEFRAG_HYSTERESIS_TICKS,
                 idle_duty_max: float =
                 consts.DEFAULT_DEFRAG_IDLE_DUTY_MAX,
                 max_inflight: int = consts.DEFAULT_DEFRAG_MAX_INFLIGHT,
                 budget: int = consts.DEFAULT_DEFRAG_BUDGET,
                 tick_interval_s: float = 5.0):
        self.slices = slices
        self.view_fn = view_fn
        self.activity_fn = activity_fn
        self.node_excluded_fn = node_excluded_fn
        self.store = store
        self.mode = mode
        self.hysteresis_ticks = hysteresis_ticks
        self.idle_duty_max = idle_duty_max
        self.max_inflight = max_inflight
        self.budget = budget
        self.tick_interval_s = tick_interval_s
        self._lock = threading.Lock()
        # consecutive-tick presence per candidate key
        # (namespace, pod, node, group) — the hysteresis counter
        self._streak: dict[tuple[str, str, str, str], int] = {}
        # journaled plans by key (the /fleetz defrag.plans section)
        self._plans: dict[tuple[str, str, str, str], dict] = {}
        # resolved-move ring, newest first
        self._recent: collections.deque = collections.deque(
            maxlen=RECENT_MOVES)
        # monotonic stamps of budget-charged moves (sliding window)
        self._move_stamps: list[float] = []
        self._budget_exhausted = False
        self._inflight = 0
        # groups awaiting the post-move score check: group -> {pre,
        # ticks} (judged on a LATER fleet tick — the score the move
        # preceded proves nothing)
        self._verify: dict[str, dict] = {}
        self._last_ticks = -1
        self._adopting: set = set()
        self._adopt_threads: list[threading.Thread] = []
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- lifecycle -------------------------------------------------------------

    def start(self) -> "DefragActuator":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="tpumounter-defrag")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=5.0)
        self.withdraw()

    def _run(self) -> None:
        while not self._stop.wait(self.tick_interval_s):
            try:
                self.tick()
            except Exception:    # noqa: BLE001 — one bad pass must not
                logger.exception("defrag tick failed")   # kill the loop

    def withdraw(self) -> None:
        """Zero the exported gauge (stop — the vanished-series hygiene
        every plane applies, so a stopped actuator doesn't freeze a
        stale in-flight count on /metrics)."""
        REGISTRY.defrag_inflight.set(0)

    def join_adoptions(self, timeout_s: float = 30.0) -> None:
        """Test helper: block until every adopted move resolved."""
        deadline = time.monotonic() + timeout_s
        with self._lock:
            threads = list(self._adopt_threads)
        for thread in threads:
            thread.join(timeout=max(0.0, deadline - time.monotonic()))

    # -- the optimizer tick ----------------------------------------------------

    def tick(self) -> None:
        """One optimizer pass: refresh hysteresis from the latest fleet
        scoring, judge pending post-move checks, (re)build the plan set,
        and — in act mode — execute up to the in-flight cap within the
        sliding budget. A pass against an unchanged fleet tick is a
        no-op (hysteresis counts FLEET ticks, not actuator wakeups)."""
        viewed = self._view()
        if viewed is None:
            return
        view, ticks = viewed
        if ticks == self._last_ticks:
            return
        self._last_ticks = ticks
        activity = self._activity()
        self._verify_pass(view, ticks)
        self._plan(view, activity)
        if self.mode != "act":
            return
        self._actuate(float(view.get("score") or 0.0), ticks)

    def _view(self) -> tuple[dict, int] | None:
        try:
            snap = self.view_fn() or {}
        except Exception:    # noqa: BLE001 — no view, no work
            logger.exception("topology view failed")
            return None
        view = snap.get("fleet")
        if view is None or not view.get("nodes"):
            return None
        return view, int(snap.get("ticks") or 0)

    def _activity(self) -> dict:
        if self.activity_fn is None:
            return {}
        try:
            return dict(self.activity_fn() or {})
        except Exception:    # noqa: BLE001 — missing telemetry reads
            return {}        # as "no evidence of idleness"

    @staticmethod
    def _key(cand: dict) -> tuple[str, str, str, str]:
        return (cand["namespace"], cand["pod"], cand["node"],
                cand.get("group") or "")

    def _eligible(self, key: tuple, cand: dict,
                  activity: dict) -> str | None:
        """Why the candidate may NOT move yet (None = eligible). Every
        interlock lives here, hysteresis first — the lint pins that
        planning consults this before anything reaches actuation."""
        if not cand.get("group"):
            return "not a slice-group lease"
        if self._streak.get(key, 0) < self.hysteresis_ticks:
            return "hysteresis"         # not persistent enough yet
        if not cand.get("idle"):
            return "lease not idle"
        act = activity.get((cand["namespace"], cand["pod"]))
        if act is not None:
            if float(act.get("duty") or 0.0) > self.idle_duty_max:
                return "duty above threshold"
            if int(act.get("busy_chips") or 0):
                return "busy chips"
        if self.node_excluded_fn is not None:
            try:
                if self.node_excluded_fn(cand["node"]):
                    return "source node excluded"
            except Exception:    # noqa: BLE001 — guard degrades open
                pass
        return None

    def _plan(self, view: dict, activity: dict) -> None:
        """Refresh hysteresis streaks and the journaled plan set from
        this tick's candidate report. New eligible candidates are
        journaled (state=planned) and noted; keys that left eligibility
        retire quietly (the next report re-plans them from scratch)."""
        candidates = view.get("defrag_candidates") or []
        keys_now = set()
        for cand in candidates:
            key = self._key(cand)
            keys_now.add(key)
            self._streak[key] = self._streak.get(key, 0) + 1
        for key in set(self._streak) - keys_now:
            del self._streak[key]
        eligible: dict[tuple, dict] = {}
        for cand in candidates:
            key = self._key(cand)
            if self._eligible(key, cand, activity) is None:
                eligible[key] = cand
        with self._lock:
            current = dict(self._plans)
        for key, cand in eligible.items():
            if key in current:
                continue
            plan = {
                "namespace": cand["namespace"],
                "pod": cand["pod"],
                "tenant": cand.get("tenant", ""),
                "node": cand["node"],
                "chips": int(cand.get("chips") or 0),
                "gain": int(cand.get("gain") or 0),
                "group": cand.get("group") or "",
                "rid": "defrag-" + uuid_mod.uuid4().hex[:8],
                "created_unix": round(time.time(), 3),
            }
            self._journal(plan, state="planned")
            with self._lock:
                self._plans[key] = plan
            self._note_move("planned", group=plan["group"],
                            namespace=plan["namespace"], pod=plan["pod"],
                            tenant=plan["tenant"], node=plan["node"],
                            chips=plan["chips"], gain=plan["gain"],
                            rid=plan["rid"])
        for key in set(current) - set(eligible):
            self._retire(key, current[key])

    def _actuate(self, pre_score: float, ticks: int) -> None:
        """Execute the highest-gain plans, bounded by the fleet-wide
        in-flight cap AND the sliding-window budget; exhausting the
        budget halts the actuator (one transition event) until the
        window slides."""
        now = time.monotonic()
        with self._lock:
            self._move_stamps = [
                s for s in self._move_stamps
                if now - s < consts.DEFRAG_BUDGET_WINDOW_S]
            used = len(self._move_stamps)
            plans = sorted(self._plans.items(),
                           key=lambda kv: -kv[1]["gain"])
        if used >= self.budget:
            if not self._budget_exhausted:
                self._budget_exhausted = True
                self._note_move("budget_exhausted", used=used,
                                limit=self.budget)
                logger.warning(
                    "defrag budget exhausted (%d moves in the last "
                    "%.0fs): actuator halted until the window slides",
                    used, consts.DEFRAG_BUDGET_WINDOW_S)
            return
        self._budget_exhausted = False
        cap = min(self.max_inflight, self.budget - used)
        for key, plan in plans[:cap]:
            self._execute(key, plan, pre_score, ticks)

    def _execute(self, key: tuple, plan: dict, pre_score: float,
                 ticks: int) -> None:
        """One move: journal state=acting BEFORE actuation (the crash
        seam — a master killed past this point leaves a record a
        failed-over leader adopts), then the grow-first migration
        through the repair seam. Every resolution retires the plan and
        its record; only a crash leaves the record behind."""
        group = plan["group"]
        members = self.slices.broker.leases.group_leases(group)
        if not members:
            self._retire(key, plan)
            self._note_move("aborted", group=group, rid=plan["rid"],
                            namespace=plan["namespace"],
                            pod=plan["pod"], why="group gone")
            return
        self._journal(plan, state="acting", hosts=len(members))
        with self._lock:
            self._inflight += 1
            self._move_stamps.append(time.monotonic())
            REGISTRY.defrag_inflight.set(self._inflight)
        try:
            result = self.slices.migrate_member(
                group, (plan["namespace"], plan["pod"]), plan["rid"])
        except Exception as e:    # noqa: BLE001 — the slice txn rolled
            # itself back (attach aborts are self-cleaning); the group
            # is intact, so this resolves as a deferral
            logger.exception("[rid=%s] defrag move of group %s errored",
                             plan["rid"], group)
            result = {"outcome": "deferred",
                      "why": e.__class__.__name__}
        finally:
            with self._lock:
                self._inflight -= 1
                REGISTRY.defrag_inflight.set(self._inflight)
        outcome = result.get("outcome")
        self._retire(key, plan)
        fields = dict(group=group, rid=plan["rid"],
                      namespace=plan["namespace"], pod=plan["pod"],
                      node=plan["node"])
        if outcome == "migrated":
            with self._lock:
                self._verify[group] = {"pre": pre_score, "ticks": ticks}
                self._streak.pop(key, None)
            self._note_move(
                "migrated", generation=result.get("generation"),
                shrink_deferred=bool(result.get("shrink_deferred")),
                **fields)
            logger.info("[rid=%s] defrag migrated %s/%s off %s "
                        "(group %s)", plan["rid"], plan["namespace"],
                        plan["pod"], plan["node"], group)
        elif outcome == "deferred":
            self._note_move("deferred", why=result.get("why", ""),
                            **fields)
        else:
            # "gone" (or an unknown outcome): nothing moved, the plan
            # was computed against a world that no longer exists
            self._note_move("aborted", why=str(outcome or "unknown"),
                            **fields)

    def _verify_pass(self, view: dict, ticks: int) -> None:
        """Post-move contiguity check, judged against a LATER fleet
        scoring than the move's own: a move that did not improve the
        score charges the budget and re-arms hysteresis for its group
        — placement churn that buys nothing is treated as thrash."""
        with self._lock:
            pending = dict(self._verify)
        score = float(view.get("score") or 0.0)
        for group, info in pending.items():
            if ticks <= info["ticks"]:
                continue    # the move's own scoring: wait one more
            improved = score < info["pre"] - 1e-9
            with self._lock:
                self._verify.pop(group, None)
                if not improved:
                    self._move_stamps.append(time.monotonic())
                    for key in [k for k in self._streak
                                if k[3] == group]:
                        del self._streak[key]
                for entry in self._recent:
                    if entry.get("group") == group \
                            and entry.get("outcome") == "migrated" \
                            and "improved" not in entry:
                        entry["improved"] = improved
                        break
            if not improved:
                logger.warning(
                    "defrag move of group %s did not improve the fleet "
                    "score (%.4f -> %.4f): budget charged, hysteresis "
                    "re-armed", group, info["pre"], score)

    # -- failover adoption -----------------------------------------------------

    def adopt(self, records) -> int:
        """Resolve journaled moves a dead (or deposed) leader left
        behind. ``planned`` records drop quietly (the next tick
        re-plans from the fresh fleet view); ``acting`` records are
        judged against the group's ACTUAL membership once the slice
        txn machinery settles — each ends at the old placement or the
        new one, never between. Threaded: the election callback must
        not block on worker RPC fan-outs."""
        adopted = 0
        for record in records:
            if record.state != "acting":
                self._unjournal(record.namespace, record.group,
                                record.pod)
                continue
            key = (record.namespace, record.pod, record.src_node,
                   record.group)
            with self._lock:
                if key in self._adopting:
                    continue
                self._adopting.add(key)
            adopted += 1
            thread = threading.Thread(
                target=self._run_adopt, args=(record, key), daemon=True,
                name=f"tpumounter-defrag-adopt-{record.pod}")
            thread.start()
            with self._lock:
                self._adopt_threads.append(thread)
                self._adopt_threads = [t for t in self._adopt_threads
                                       if t.is_alive() or t is thread]
        return adopted

    def _run_adopt(self, record, key: tuple) -> None:
        try:
            deadline = time.monotonic() + ADOPT_POLL_TIMEOUT_S
            while self.slices.txn_inflight(record.rid):
                if time.monotonic() >= deadline:
                    # keep the record: a later rehydration retries
                    logger.warning(
                        "[rid=%s] adopted defrag move of group %s "
                        "still waiting on its slice txn; deferring to "
                        "the next rehydration", record.rid,
                        record.group)
                    return
                time.sleep(0.05)
            members = [(m.namespace, m.pod) for m in
                       self.slices.broker.leases.group_leases(
                           record.group)]
            old = (record.namespace, record.pod)
            if not members:
                outcome, why = "aborted", "group gone"
            elif old not in members:
                outcome, why = "migrated", "move had completed"
            elif record.hosts and len(members) > record.hosts:
                # the grow landed but the shrink never ran: finish the
                # detach through the repair seam (the tail _migrate
                # would have run had its master survived)
                done = self.slices.finish_member_detach(
                    record.group, old, record.rid)
                outcome = "migrated" if done else "deferred"
                why = ("adopted grow finished" if done
                       else "member busy after adopted grow")
            else:
                outcome, why = "aborted", "grow never landed"
            self._unjournal(record.namespace, record.group, record.pod)
            self._note_move(outcome, group=record.group,
                            namespace=record.namespace, pod=record.pod,
                            rid=record.rid, adopted=True, why=why)
            logger.info("[rid=%s] adopted defrag move of group %s "
                        "resolved: %s (%s)", record.rid, record.group,
                        outcome, why)
        except Exception:    # noqa: BLE001 — a dead adoption thread
            # must not strand the guard; the record survives for the
            # next rehydration
            logger.exception("adopted defrag move of group %s failed",
                             record.group)
        finally:
            with self._lock:
                self._adopting.discard(key)

    # -- journal (the crash seam) ----------------------------------------------

    def _journal(self, plan: dict, state: str, hosts: int = 0) -> None:
        if self.store is None:
            return
        from gpumounter_tpu_torch.master.store import DefragMoveRecord
        try:
            self.store.put_defrag_move(DefragMoveRecord(
                group=plan["group"], namespace=plan["namespace"],
                pod=plan["pod"], rid=plan["rid"],
                tenant=plan.get("tenant", ""),
                gpus_per_host=int(plan.get("chips") or 0),
                hosts=hosts, src_node=plan.get("node", ""),
                gain=int(plan.get("gain") or 0),
                created_unix=plan.get("created_unix", 0.0),
                state=state))
        except StoreFencedError as e:
            self.slices.broker._on_fenced(e)

    def _unjournal(self, namespace: str, group: str, pod: str) -> None:
        if self.store is None:
            return
        try:
            self.store.delete_defrag_move(namespace, group, pod)
        except StoreFencedError as e:
            self.slices.broker._on_fenced(e)

    def _retire(self, key: tuple, plan: dict) -> None:
        with self._lock:
            self._plans.pop(key, None)
        self._unjournal(plan["namespace"], plan["group"], plan["pod"])

    # -- telemetry (the observability seam) ------------------------------------

    def _note_move(self, outcome: str, **fields) -> None:
        """THE move observability seam (tests/test_torch_defrag_lint.py pins
        it): every transition crosses here, so the counter, the event
        and the /fleetz recent ring can never drift apart."""
        REGISTRY.defrag_moves.inc(outcome=outcome)
        EVENTS.emit("defrag_plan" if outcome == "planned"
                    else "defrag_move", outcome=outcome, **fields)
        if outcome != "planned":
            entry = {"outcome": outcome, "unix": round(time.time(), 3),
                     **fields}
            with self._lock:
                self._recent.appendleft(entry)

    # -- read side (request threads: already-computed state only) --------------

    def fleetz_section(self) -> dict:
        """The /fleetz ``defrag`` section. Present whenever the
        actuator exists (TPU_DEFRAG_MODE=plan|act); mode 0 never
        constructs one, keeping /fleetz byte-identical to the
        pre-defrag payload."""
        now = time.monotonic()
        with self._lock:
            plans = sorted((dict(p) for p in self._plans.values()),
                           key=lambda p: (-p["gain"], p["namespace"],
                                          p["pod"]))
            recent = [dict(e) for e in self._recent]
            inflight = self._inflight
            used = len([s for s in self._move_stamps
                        if now - s < consts.DEFRAG_BUDGET_WINDOW_S])
            exhausted = self._budget_exhausted
        return {
            "mode": self.mode,
            "plans": plans,
            "recent": recent,
            "inflight": inflight,
            "budget": {
                "limit": self.budget,
                "window_s": consts.DEFRAG_BUDGET_WINDOW_S,
                "used": used,
                "exhausted": exhausted,
            },
        }
