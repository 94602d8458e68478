"""Master-side fleet aggregator: one cluster view over every worker (the
port of :mod:`gpumounter_tpu.master.fleet`, without the topology,
defragmenter and node-health hooks: those planes are not ported yet, and
the view is the control plane's with ``TPU_TOPOLOGY=0`` and
``TPU_NODE_HEALTH=0``).

The paper's master/worker split leaves the only ground truth about
actuation in per-node processes: the workers' ``/tracez``/``/agentz``/
``/journalz`` endpoints answer questions, but the operator must already
know WHICH worker to ask — after something broke. This module inverts
that: a master tick loop scrapes every worker's health port (metrics
exposition, ``/eventz`` deltas, journal backlog, informer staleness) and
merges the results into one ``GET /fleetz`` cluster view:

- **per-node health state**: ``fresh`` (scraped this tick), ``stale``
  (scrape failed / breaker open — the node's numbers are the last good
  ones), with the age of the last successful scrape and the consecutive
  missed-tick count doctor WARNs on;
- **per-tenant chips in use** from the broker's lease table (the
  master's authority on grants);
- **the merged lifecycle event tail**: each worker's ``/eventz`` ring is
  tailed from a per-node cursor, stamped with its node, and interleaved
  with the master's own events — the fleet-wide decision stream;
- the SLO engine's burn-rate snapshot (utils/slo.py), which the fleet
  loop also ticks.

Resilience discipline: each worker is scraped in its own thread under a
per-worker :class:`~gpumounter_tpu_torch.utils.retry.CircuitBreaker` with a
short timeout — a dead node degrades to ``stale`` within ONE tick and
cannot wedge the loop or delay the scrape of healthy nodes (pinned by
the chaos test). ``tpumounterctl fleet`` renders the view.
"""

from __future__ import annotations

import collections
import json
import threading
import time
import urllib.error
import urllib.request

from gpumounter_tpu_torch.utils.errors import CircuitOpenError
from gpumounter_tpu_torch.utils.log import get_logger
from gpumounter_tpu_torch.utils.metrics import REGISTRY
from gpumounter_tpu_torch.utils.retry import CircuitBreaker

logger = get_logger("master.fleet")

DEFAULT_TICK_INTERVAL_S = 5.0
SCRAPE_TIMEOUT_S = 3.0
# Consecutive missed ticks before doctor escalates a node to WARN.
STALE_TICKS_WARN = 2


class _ScrapeBreaker(CircuitBreaker):
    """A scrape breaker failing fast is the NODE's health signal, already
    reported as ``fleet_nodes{state="stale"}`` + the per-node record —
    exporting it to ``circuit_state`` would page doctor CRIT (that gauge
    means 'a worker RPC target is failing fast') for a telemetry miss.
    Same for the ``circuit_open`` lifecycle event + flight trigger: a
    dead health sidecar must not write an anomaly bundle (or consume the
    rate-limit slot a real incident needs) on every re-open probe."""

    def _export(self) -> None:
        pass

    def _announce_open(self) -> None:
        pass


class _NodeRecord:
    __slots__ = ("node", "base", "state", "last_ok_unix", "missed_ticks",
                 "error", "healthz", "chips", "journal_backlog",
                 "cache_staleness_s", "events_seq", "events_boot",
                 "events_dropped", "version", "inflight", "utilz")

    def __init__(self, node: str, base: str):
        self.node = node
        self.base = base
        self.state = "unscraped"
        self.last_ok_unix: float | None = None
        self.missed_ticks = 0
        self.error = ""
        self.healthz = ""
        self.chips: dict[str, int] = {}
        self.journal_backlog: int | None = None
        self.cache_staleness_s: float | None = None
        self.events_seq = 0          # per-node /eventz cursor
        self.events_boot = ""        # worker incarnation the cursor is for
        self.events_dropped = 0
        self.version = ""
        # chip-utilization summary from the node's /utilz (None until the
        # first successful scrape of a sampler-enabled worker)
        self.utilz: dict | None = None
        # single-flight guard: at most ONE scrape thread per node, ever —
        # a wedged scrape (connectable but dripping bytes) must not stack
        # a new thread per tick racing the record's cursor/state
        self.inflight = False

    def to_json(self) -> dict:
        out = {
            "base": self.base,
            "state": self.state,
            "missed_ticks": self.missed_ticks,
            "last_scrape_age_s": (
                None if self.last_ok_unix is None
                else round(time.time() - self.last_ok_unix, 1)),
            "chips": dict(self.chips),
            "journal_backlog": self.journal_backlog,
            "cache_staleness_s": self.cache_staleness_s,
            "events_seq": self.events_seq,
        }
        if self.version:
            out["version"] = self.version
        if self.utilz is not None:
            out["utilization"] = dict(self.utilz)
        if self.error:
            out["error"] = self.error
        if self.events_dropped:
            out["events_dropped"] = self.events_dropped
        return out


class FleetAggregator:
    """Scrape loop + merged cluster view.

    ``targets_fn``: zero-arg callable returning ``{node: health base
    URL}`` (the gateway adapts its worker directory); ``usage_fn``: the
    per-tenant chip usage (the broker's lease table); ``slo``: a
    :class:`~gpumounter_tpu_torch.utils.slo.SloEngine` ticked with the loop.
    """

    def __init__(self, targets_fn, usage_fn=None, slo=None,
                 tick_interval_s: float = DEFAULT_TICK_INTERVAL_S,
                 scrape_timeout_s: float = SCRAPE_TIMEOUT_S,
                 ha_fn=None, lease_lookup=None):
        self.targets_fn = targets_fn
        self.usage_fn = usage_fn or (lambda: {})
        self.slo = slo
        # lease_lookup(namespace, pod) -> Lease | None (the broker's
        # table): joins scraped chip utilization to the tenant that
        # holds the grant. None = owner-namespace fallback.
        self.lease_lookup = lease_lookup
        # ha_fn() -> this master replica's HA posture (role per shard,
        # peers from the election lock records, store lag) — the /fleetz
        # section that makes a stuck failover visible in one command.
        self.ha_fn = ha_fn
        self.tick_interval_s = tick_interval_s
        self.scrape_timeout_s = scrape_timeout_s
        # wall budget for ONE node's whole scrape (several sequential
        # GETs, each individually bounded by scrape_timeout_s): the
        # optional phases self-bound against it inside _scrape, so a
        # healthy-but-slow worker finishes the mandatory phases and
        # stays fresh instead of being joined out every tick
        self.scrape_budget_s = max(scrape_timeout_s + 1.0,
                                   scrape_timeout_s * 4.0)
        self._lock = threading.Lock()
        self._nodes: dict[str, _NodeRecord] = {}
        self._breakers: dict[str, CircuitBreaker] = {}
        self._tail: collections.deque = collections.deque(maxlen=512)
        self._ticks = 0
        # (namespace, pod) -> per-owner activity derived from /utilz
        # scrapes: first/last seen, last observed busy, current duty —
        # what the broker's idle-lease marking consumes (lease_activity)
        # and the /fleetz utilization section renders.
        self._activity: dict[tuple[str, str], dict] = {}
        self._util_tenants: set[str] = set()
        self._loop: threading.Thread | None = None
        self._stop = threading.Event()

    # -- lifecycle -------------------------------------------------------------

    def start(self) -> "FleetAggregator":
        if self._loop is None or not self._loop.is_alive():
            self._stop.clear()
            self._loop = threading.Thread(target=self._run, daemon=True,
                                          name="tpumounter-fleet")
            self._loop.start()
        return self

    def stop(self) -> None:
        from gpumounter_tpu_torch.utils.metrics import REGISTRY
        self._stop.set()
        if self._loop is not None:
            # worst-case tick: the scrape join deadline plus slack — a
            # shorter join would let the in-flight tick re-export burns
            # AFTER the reset below, latching stale slo_burn_rate values
            self._loop.join(timeout=self.scrape_budget_s
                            + self.scrape_timeout_s + 3.0)
            if self._loop.is_alive():
                logger.warning("fleet loop still mid-tick at stop; its "
                               "gauge/SLO exports are suppressed by the "
                               "stop flag")
            self._loop = None
        # withdraw this master's exports: a stopped aggregator's last
        # values are not CURRENT state (doctor reads the gauges on the
        # process-global registry)
        REGISTRY.fleet_nodes.set(0, state="fresh")
        REGISTRY.fleet_nodes.set(0, state="stale")
        with self._lock:
            util_tenants = set(self._util_tenants)
        for tenant in util_tenants:
            REGISTRY.lease_utilization.set(0.0, tenant=tenant)
        if self.slo is not None:
            self.slo.reset()

    def _run(self) -> None:
        while not self._stop.wait(self.tick_interval_s):
            try:
                self.tick()
            except Exception:        # noqa: BLE001 — loop must survive
                logger.exception("fleet tick failed")

    # -- scraping --------------------------------------------------------------

    def _breaker(self, node: str) -> CircuitBreaker:
        with self._lock:
            breaker = self._breakers.get(node)
            if breaker is None:
                breaker = self._breakers[node] = _ScrapeBreaker(
                    f"fleet:{node}", failure_threshold=3,
                    reset_timeout_s=max(10.0, 2 * self.tick_interval_s))
            return breaker

    def tick(self) -> dict:
        """One scrape pass over every known worker, concurrently; a node
        whose scrape fails (or whose breaker is open) is marked ``stale``
        THIS tick while the rest proceed. Returns {node: state}."""
        try:
            targets = dict(self.targets_fn())
        except Exception as e:       # noqa: BLE001 — directory trouble
            logger.warning("fleet: worker discovery failed: %s", e)
            targets = {}
        with self._lock:
            for node, base in targets.items():
                record = self._nodes.get(node)
                if record is None or record.base != base:
                    self._nodes[node] = _NodeRecord(node, base)
            # vanished workers age out of the view after enough silence
            # (kept while stale so the operator SEES the dead node)
            records = [r for node, r in self._nodes.items()
                       if node in targets or r.missed_ticks < 60]
            self._nodes = {r.node: r for r in records}

        threads = []
        for record in records:
            with self._lock:
                stuck = record.inflight
                if not stuck:
                    record.inflight = True
            if stuck:
                # the previous scrape never returned: the node is
                # wedged-but-connectable — stale, and NOT re-scraped
                # (single flight; the old thread still owns the record)
                self._mark_missed(record, "previous scrape still in "
                                          "flight (wedged health port?)")
                continue
            thread = threading.Thread(target=self._scrape_one,
                                      args=(record,), daemon=True)
            thread.start()
            threads.append((thread, record))
        # join slightly past the per-scrape budget: a scrape that self-
        # bounded may still have one request in flight when it checks
        deadline = (time.monotonic() + self.scrape_budget_s
                    + self.scrape_timeout_s + 1.0)
        for thread, record in threads:
            thread.join(timeout=max(0.0, deadline - time.monotonic()))
            if thread.is_alive():
                # past the join deadline: a miss for THIS tick (the
                # thread finishes or dies on its own socket timeout and
                # clears the single-flight guard; the loop moves on)
                self._mark_missed(record, "scrape exceeded deadline")
        with self._lock:
            self._ticks += 1
            states = {r.node: r.state for r in self._nodes.values()}
        fresh = sum(1 for s in states.values() if s == "fresh")
        # stop-guarded like the SLO tick below: a tick outliving stop()
        # (wedged scrape past stop's join timeout) must not re-export
        # node gauges on the process-global registry after stop() zeroed
        # them — a later doctor in the same process would see a phantom
        # stale node
        if not self._stop.is_set():
            REGISTRY.fleet_nodes.set(fresh, state="fresh")
            REGISTRY.fleet_nodes.set(len(states) - fresh, state="stale")
            self._export_utilization_gauges()
        # a tick outliving stop() must not re-export burns after
        # stop()'s slo.reset() zeroed them (manual tick()s run with the
        # flag clear, so rigs without the loop still get SLO exports)
        if self.slo is not None and not self._stop.is_set():
            self.slo.tick()
        return states

    def _scrape_one(self, record: _NodeRecord) -> None:
        try:
            breaker = self._breaker(record.node)
            try:
                breaker.allow()
            except CircuitOpenError as e:
                self._mark_missed(record, f"breaker open: {e}")
                return
            try:
                self._scrape(record)
            except (urllib.error.URLError, OSError, ValueError) as e:
                breaker.record_failure()
                self._mark_missed(record, str(e))
                return
            breaker.record_success()
            with self._lock:
                record.state = "fresh"
                record.missed_ticks = 0
                record.error = ""
                record.last_ok_unix = time.time()
        finally:
            with self._lock:
                record.inflight = False

    def _mark_missed(self, record: _NodeRecord, error: str) -> None:
        with self._lock:
            record.state = "stale"
            record.missed_ticks += 1
            record.error = error[:200]
        logger.warning("fleet: worker %s unscraped (%s)", record.node,
                       error)

    def _get(self, record: _NodeRecord, path: str) -> bytes:
        url = record.base.rstrip("/") + path
        with urllib.request.urlopen(
                url, timeout=self.scrape_timeout_s) as resp:
            return resp.read()

    def _scrape(self, record: _NodeRecord) -> None:
        budget = time.monotonic() + self.scrape_budget_s
        # liveness first: a hung process fails here and costs one timeout
        record.healthz = self._get(record, "/healthz").decode()[:40]
        # metrics: chip inventory + build version for the fleet table
        from gpumounter_tpu_torch.utils.metrics import parse_exposition
        metrics = parse_exposition(self._get(record, "/metrics").decode())
        record.chips = {
            dict(labels).get("state", "?"): int(value)
            for labels, value in
            metrics.get("tpumounter_node_chips", {}).items()}
        versions = sorted({dict(labels).get("version", "") for labels in
                           metrics.get("tpumounter_build_info", {})}
                          - {""})
        record.version = ",".join(versions)
        # event tail delta from this node's cursor, stamped + merged.
        # Pages truncate OLDEST-first, so the cursor advances to the last
        # RETURNED seq and the loop drains page after page until caught
        # up — a burst bigger than one page is ingested in order, never
        # skipped. The page cap bounds one scrape against a node emitting
        # faster than we read; the remainder carries to the next tick.
        for _ in range(8):
            if time.monotonic() >= budget:
                break               # cursor carries to the next tick
            cursor = record.events_seq
            events = json.loads(self._get(
                record, f"/eventz?since={cursor}"))
            latest = int(events.get("seq") or 0)
            boot = str(events.get("boot") or "")
            if boot and record.events_boot and boot != record.events_boot:
                # the worker restarted: its ring began again at 1 under
                # a new boot id — re-baseline instead of polling a
                # cursor into the NEW incarnation's stream (which may
                # already be past it, e.g. after a busy boot journal
                # replay, silently swallowing its first events)
                logger.info("fleet: worker %s restarted (boot %s -> %s);"
                            " re-baselining event cursor", record.node,
                            record.events_boot, boot)
                record.events_boot = boot
                record.events_seq = 0
                # the drop count was the OLD incarnation's — carrying it
                # over would report a healthy new process as losing
                # events forever
                record.events_dropped = 0
                continue
            record.events_boot = boot or record.events_boot
            if latest and latest < cursor:
                # seq moved BACKWARDS: restart fallback for down-level
                # workers whose payload predates the boot id
                logger.info("fleet: worker %s event seq reset (%d -> %d);"
                            " re-baselining cursor", record.node,
                            record.events_seq, latest)
                record.events_seq = 0
                record.events_dropped = 0
                continue
            if cursor > 0:
                # dropped counts only against an ESTABLISHED cursor: a
                # since=0 first poll of a long-running worker reports
                # its whole pre-ring history as "dropped", and a master
                # that merely joined late must not render a healthy
                # node as having lost thousands of events
                record.events_dropped += int(events.get("dropped") or 0)
            batch = events.get("events") or []
            stamped = []
            for event in batch:
                event = dict(event)
                event.setdefault("node", record.node)
                stamped.append(event)
            with self._lock:
                # under _lock: scrape threads append concurrently with
                # snapshot()'s list(self._tail) — an unlocked append
                # mid-iteration raises RuntimeError out of /fleetz
                self._tail.extend(stamped)
            if batch:
                record.events_seq = int(batch[-1].get("seq")
                                        or record.events_seq)
            # a truncated page reports seq == last RETURNED seq, so the
            # cursor comparison alone would read as caught-up — the flag
            # says the worker is holding more
            if events.get("truncated"):
                continue
            if not batch or record.events_seq >= int(events.get("seq")
                                                     or 0):
                break
        # journal backlog + informer staleness + chip utilization
        # (best-effort: these surfaces may be absent on down-level
        # workers, and /utilz answers {"enabled": false} with the
        # sampler off)
        paths = [("/utilz", self._apply_utilz),
                 ("/journalz", self._apply_journalz),
                 ("/cachez", self._apply_cachez)]
        for path, apply in paths:
            if time.monotonic() >= budget:
                break               # keep the prior tick's numbers
            try:
                apply(record, json.loads(self._get(record, path)))
            except (urllib.error.URLError, OSError, ValueError):
                pass

    # activity entries for owners no /utilz scrape has mentioned for
    # this long are pruned (the lease detached, or the node vanished) —
    # the map stays bounded by live attachments, not history
    ACTIVITY_TTL_S = 600.0

    def _apply_utilz(self, record: _NodeRecord, payload: dict) -> None:
        """Digest one node's /utilz: per-node summary for the fleet
        table + the per-owner activity map the idle-lease machinery
        reads. Worker timestamps (last_busy_unix) are wall-clock and
        assumed comparable across the fleet — the idle threshold is
        minutes, clock skew is seconds."""
        if not isinstance(payload, dict) or not payload.get("enabled"):
            # the node answered but the sampler is off (TPU_USAGE=0 after
            # a rollout, or a restart without it): a FROZEN pre-rollout
            # summary rendered as live data is worse than none
            record.utilz = None
            return
        chips = payload.get("chips") or []
        busy = sum(1 for c in chips if c.get("busy"))
        duties = [float(c.get("duty") or 0.0) for c in chips]
        record.utilz = {
            "chips_total": len(chips),
            "chips_busy": busy,
            "avg_duty": (round(sum(duties) / len(duties), 4)
                         if duties else 0.0),
            "unattributed_busy": int(payload.get("unattributed_busy")
                                     or 0),
        }
        now = time.time()
        with self._lock:
            for owner, info in (payload.get("owners") or {}).items():
                ns, _, pod = owner.partition("/")
                if not pod:
                    continue
                act = self._activity.setdefault(
                    (ns, pod), {"first_seen_unix": now,
                                "last_busy_unix": None})
                act["last_seen_unix"] = now
                act["duty"] = float(info.get("avg_duty") or 0.0)
                act["busy_chips"] = int(info.get("busy_chips") or 0)
                act["chips"] = int(info.get("chips") or 0)
                act["node"] = record.node
                last_busy = info.get("last_busy_unix")
                if act["busy_chips"] > 0:
                    act["last_busy_unix"] = now
                elif last_busy is not None:
                    act["last_busy_unix"] = max(
                        act["last_busy_unix"] or 0.0, float(last_busy))
            stale = [key for key, act in self._activity.items()
                     if now - act.get("last_seen_unix", now)
                     > self.ACTIVITY_TTL_S]
            for key in stale:
                del self._activity[key]

    def lease_activity(self) -> dict[tuple[str, str], dict]:
        """Point-in-time copy of the per-owner activity map — the
        broker's idle-lease marking joins this to its lease table
        (gateway binds it via ``broker.bind_utilization``)."""
        with self._lock:
            return {key: dict(act)
                    for key, act in self._activity.items()}

    def _utilization_view(self) -> dict:
        """Per-tenant rollup + currently-idle lease list from the
        activity map, joined to the broker's lease table when bound.
        "Idle" HERE means every observed chip of the lease showed zero
        duty at the latest scrape (visible within ONE fleet tick); the
        broker applies the TPU_IDLE_LEASE_S threshold before acting."""
        lookup = self.lease_lookup
        tenants: dict[str, dict] = {}
        idle: list[dict] = []
        for (ns, pod), act in sorted(self.lease_activity().items()):
            lease = lookup(ns, pod) if lookup is not None else None
            tenant = lease.tenant if lease is not None else ns
            agg = tenants.setdefault(
                tenant, {"chips": 0, "busy_chips": 0, "duty_sum": 0.0,
                         "idle_chips": 0})
            chips = act.get("chips", 0)
            agg["chips"] += chips
            agg["busy_chips"] += act.get("busy_chips", 0)
            agg["duty_sum"] += act.get("duty", 0.0) * chips
            if act.get("busy_chips", 0) == 0 and chips:
                agg["idle_chips"] += chips
                ref = (act.get("last_busy_unix")
                       or act.get("first_seen_unix") or 0.0)
                entry = {
                    "namespace": ns, "pod": pod, "tenant": tenant,
                    "node": act.get("node", ""), "chips": chips,
                    "idle_for_s": round(
                        max(0.0, act.get("last_seen_unix", ref) - ref),
                        1),
                }
                if lease is not None:
                    entry["priority"] = lease.priority
                idle.append(entry)
        for agg in tenants.values():
            chips = agg["chips"]
            agg["avg_duty"] = (round(agg.pop("duty_sum") / chips, 4)
                               if chips else 0.0)
        return {"tenants": tenants, "idle_leases": idle}

    def _export_utilization_gauges(self) -> None:
        view = self._utilization_view()
        seen = set(view["tenants"])
        for tenant, agg in view["tenants"].items():
            REGISTRY.lease_utilization.set(agg["avg_duty"],
                                           tenant=tenant)
        with self._lock:
            vanished = self._util_tenants - seen
            self._util_tenants = set(seen)
        for tenant in vanished:
            # a tenant whose leases all detached must not freeze its
            # last utilization on /metrics: zeroed ONCE, then forgotten
            REGISTRY.lease_utilization.set(0.0, tenant=tenant)

    @staticmethod
    def _apply_journalz(record: _NodeRecord, payload: dict) -> None:
        if isinstance(payload, dict) and "backlog" in payload:
            record.journal_backlog = int(payload["backlog"])

    @staticmethod
    def _apply_cachez(record: _NodeRecord, payload: dict) -> None:
        if not isinstance(payload, dict):
            return
        staleness = [float(s.get("staleness_s") or 0.0)
                     for s in payload.get("scopes") or []]
        if staleness:
            record.cache_staleness_s = round(max(staleness), 1)

    # -- the /fleetz view ------------------------------------------------------

    def snapshot(self, events_limit: int = 64) -> dict:
        from gpumounter_tpu_torch.utils.events import EVENTS
        with self._lock:
            nodes = {r.node: r.to_json()
                     for r in self._nodes.values()}
            ticks = self._ticks
            tail = list(self._tail)
        # interleave the master's own lifecycle events (admission, leases,
        # preemptions) with the workers' — one fleet-wide stream, newest
        # last, each entry saying where it happened
        master_events = [dict(e, process="master")
                         for e in EVENTS.tail(events_limit)]
        merged = sorted(tail[-events_limit:] + master_events,
                        key=lambda e: (e.get("ts", 0.0),
                                       e.get("seq", 0)))[-events_limit:]
        out = {
            "enabled": True,
            "ticks": ticks,
            "tick_interval_s": self.tick_interval_s,
            "stale_ticks_warn": STALE_TICKS_WARN,
            "nodes": nodes,
            "tenants": dict(self.usage_fn()),
            "events": merged,
        }
        # utilization section only once some worker actually served a
        # sampler-enabled /utilz: with TPU_USAGE=0 fleet-wide, /fleetz
        # stays byte-for-byte the pre-sampler payload
        with self._lock:
            has_util = bool(self._activity) or any(
                r.utilz is not None for r in self._nodes.values())
        if has_util:
            out["utilization"] = self._utilization_view()
        if self.slo is not None:
            out["slo"] = self.slo.snapshot()
        if self.ha_fn is not None:
            try:
                out["masters"] = self.ha_fn()
            except Exception as e:   # noqa: BLE001 — view must render
                out["masters"] = {"enabled": True, "error": str(e)[:200]}
        return out
