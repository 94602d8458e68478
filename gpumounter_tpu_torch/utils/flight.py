"""Anomaly flight recorder: one correlated bundle per incident, on disk.
The port's own copy of :mod:`gpumounter_tpu.utils.flight`, with its own
:data:`RECORDER`.

When something goes wrong in this control plane, the evidence is spread
across four bounded in-memory stores that rotate within minutes: the
lifecycle event ring (utils/events.py), the trace store (utils/trace.py),
the attach journal tail and the broker state. By the time an operator
opens `/tracez`, the interesting entries are gone. The flight recorder
closes that gap the way an aircraft FDR does: the moment a **trigger**
fires, it atomically dumps a correlated bundle of all four surfaces to
``TPU_FLIGHT_DIR`` — before the rings rotate — rate-limited so a flapping
fault produces one bundle, not a disk full of them.

Triggers (each call site passes its correlation ids):

- ``fast_burn`` — the SLO engine's 5m burn rate crossed the paging
  threshold (utils/slo.py);
- ``agent_fallback`` — a burst of resident-agent faults (>=
  :data:`FALLBACK_BURST` within :data:`BURST_WINDOW_S`; a single stale-fd
  fallback is normal operation, a burst means the fork-free path is down);
- ``journal_backlog`` — an attach left incomplete actuation state parked
  on the node (interrupted rollback, unresolved replay);
- ``circuit_open`` — a per-target circuit breaker opened (utils/retry.py).

Bundle format (one JSON file, written via tmp + ``os.replace`` so a
reader never sees a torn file)::

    {"id": "flight-<n>-<trigger>", "trigger": ..., "rid": ...,
     "ts": unix, "context": {trigger-site details},
     "events":   last 128 lifecycle events (+ "rid_events": the subset
                 carrying the triggering rid),
     "traces":   {"slowest": top 5, "failed": recent non-SUCCESS,
                  "rid": every stored trace for the triggering rid},
     ...providers: each registered provider's snapshot under its name
                 (worker: "journal"; master: "broker")}

``tpumounterctl flight list|show <id>`` inspects bundles post-hoc.
Disabled unless ``TPU_FLIGHT_DIR`` is set; ``note()`` is then a two-branch
early return, costing the hot path nothing.
"""

from __future__ import annotations

import collections
import itertools
import json
import os
import re
import threading
import time

from gpumounter_tpu_torch.utils.log import get_logger

logger = get_logger("flight")

# Trigger burst thresholds: (count within BURST_WINDOW_S) needed to dump.
# agent_fallback needs a burst (singles are routine), and so does
# idle_lease_burst (ONE idle lease is a tenant who stepped out — many at
# once is a stuck workload class or a dead feed, worth a bundle while
# the evidence is fresh); the rest dump on first occurrence.
FALLBACK_BURST = 3
IDLE_LEASE_BURST = 3
# device_denial_burst likewise needs a burst: ONE denial is a workload
# retrying a just-revoked device (expected during every preemption); a
# burst means something is hammering a gate it lost — worth a bundle
# carrying the deny ring while the tombstone reasons are fresh.
DENIAL_BURST = 3
BURST_WINDOW_S = 60.0
_THRESHOLDS = {"agent_fallback": FALLBACK_BURST,
               "idle_lease_burst": IDLE_LEASE_BURST,
               "device_denial_burst": DENIAL_BURST}

DEFAULT_MIN_INTERVAL_S = 300.0
MAX_BUNDLES = 32        # oldest bundles are pruned beyond this
# Collection delay: triggers fire INSIDE the failing request (the journal
# backlog note runs before that request's trace has finished into the
# store), so the dump settles briefly and then collects — the bundle
# captures the anomaly's own trace, not just its predecessors'.
DEFAULT_SETTLE_S = 0.25


class FlightRecorder:
    """Rate-limited dumper of correlated anomaly bundles."""

    def __init__(self, dir_path: str | None = None,
                 min_interval_s: float = DEFAULT_MIN_INTERVAL_S,
                 settle_s: float = DEFAULT_SETTLE_S,
                 clock=time.monotonic):
        self.dir = dir_path or None
        self.min_interval_s = min_interval_s
        self.settle_s = settle_s
        self._clock = clock
        self._lock = threading.Lock()
        # burst history PER trigger kind: one shared ring would let a
        # flood of journal_backlog notes evict agent_fallback's history
        # mid-burst — suppressing the fallback bundle exactly when both
        # failure modes co-occur
        self._notes: dict[str, collections.deque] = \
            collections.defaultdict(
                lambda: collections.deque(maxlen=256))
        self._last_dump = -float("inf")
        # Seeded lazily from the bundles already on disk (max id + 1): a
        # crash-looping process restarting the counter at 1 would
        # os.replace the PREVIOUS incarnation's bundle for the same
        # trigger — destroying exactly the forensic evidence the
        # recorder exists to preserve.
        self._ids: itertools.count | None = None
        # Extra bundle sections: name -> zero-arg callable returning a
        # JSON-able snapshot (worker/main.py registers "journal", the
        # master gateway "broker"). A raising provider degrades to an
        # error string — the bundle must still be written. Mutate ONLY
        # via register/unregister_provider: _collect snapshots this dict
        # under self._lock, which synchronizes nothing unless writers
        # take the same lock.
        self.providers: dict = {}

    def register_provider(self, name: str, provider) -> None:
        with self._lock:
            self.providers[name] = provider

    def unregister_provider(self, name: str, provider=None) -> None:
        """Remove a bundle section. With ``provider`` given, remove only
        if it is still the registered one — a NEWER owner's registration
        must survive an older owner's late shutdown."""
        with self._lock:
            if provider is None or self.providers.get(name) == provider:
                self.providers.pop(name, None)

    def configure(self, dir_path: str | None,
                  min_interval_s: float | None = None,
                  settle_s: float | None = None) -> None:
        """Re-point the recorder (tests; production configures via env)."""
        with self._lock:
            self.dir = dir_path or None
            if min_interval_s is not None:
                self.min_interval_s = min_interval_s
            if settle_s is not None:
                self.settle_s = settle_s
            self._last_dump = -float("inf")
            self._notes.clear()
            self._ids = None        # re-seed against the new directory

    @property
    def enabled(self) -> bool:
        return self.dir is not None

    # -- trigger side ----------------------------------------------------------

    def note(self, trigger: str, rid: str = "", **context) -> str | None:
        """Record one trigger occurrence; dump when its burst threshold
        is met (most triggers dump on the first occurrence) and the rate
        limit allows. Returns the bundle id, or None."""
        if self.dir is None:
            return None
        now = self._clock()
        with self._lock:
            notes = self._notes[trigger]
            notes.append(now)
            needed = _THRESHOLDS.get(trigger, 1)
            recent = sum(1 for t in notes
                         if now - t <= BURST_WINDOW_S)
            if recent < needed:
                return None
        return self.maybe_dump(trigger, rid=rid, context=context)

    def maybe_dump(self, trigger: str, rid: str = "",
                   context: dict | None = None) -> str | None:
        """Dump a bundle unless one was written within the rate-limit
        window (the anomaly is then already captured). The rate-limit
        slot is claimed NOW; collection runs after ``settle_s`` in a
        background thread so the triggering request's own trace (which
        finishes after the trigger fired) makes it into the bundle."""
        from gpumounter_tpu_torch.utils.metrics import REGISTRY
        if self.dir is None:
            return None
        now = self._clock()
        with self._lock:
            if now - self._last_dump < self.min_interval_s:
                REGISTRY.flight_suppressed.inc()
                return None
            self._last_dump = now
            bundle_id = f"flight-{self._next_id():04d}-{trigger}"
        if self.settle_s > 0:
            thread = threading.Thread(
                target=self._settle_and_dump,
                args=(bundle_id, trigger, rid, context or {}),
                daemon=True, name="tpumounter-flight")
            thread.start()
            return bundle_id
        return self._dump(bundle_id, trigger, rid, context or {})

    _BUNDLE_NAME = re.compile(r"flight-(\d+)-.*\.json$")

    @staticmethod
    def _bundle_order(name: str) -> int:
        """Numeric id order. Filenames zero-pad ids to 4 digits, so a
        lexical sort inverts once the persistent counter passes 9999 —
        pruning would then delete the NEWEST bundle."""
        match = FlightRecorder._BUNDLE_NAME.match(name)
        return int(match.group(1)) if match else 0

    def _next_id(self) -> int:      # caller holds self._lock
        if self._ids is None:
            start = 1
            try:
                for name in os.listdir(self.dir):
                    match = self._BUNDLE_NAME.match(name)
                    if match:
                        start = max(start, int(match.group(1)) + 1)
            except OSError:         # dir not created yet: fresh count
                pass
            self._ids = itertools.count(start)
        return next(self._ids)

    def _settle_and_dump(self, bundle_id: str, trigger: str, rid: str,
                         context: dict) -> None:
        time.sleep(self.settle_s)
        self._dump(bundle_id, trigger, rid, context)

    def _dump(self, bundle_id: str, trigger: str, rid: str,
              context: dict) -> str | None:
        from gpumounter_tpu_torch.utils.metrics import REGISTRY
        try:
            bundle = self._collect(bundle_id, trigger, rid, context)
            self._write(bundle_id, bundle)
        except Exception as e:  # noqa: BLE001 — a failed dump (full/
            # read-only volume, or a collect racing shutdown) must not
            # kill the settle thread with the rate-limit slot claimed
            logger.error("flight bundle %s not written: %s", bundle_id, e)
            # give the rate-limit slot back: nothing was captured, so the
            # NEXT trigger must be allowed to try again (the incident
            # would otherwise be silently swallowed as "suppressed")
            with self._lock:
                self._last_dump = -float("inf")
            return None
        REGISTRY.flight_dumps.inc(trigger=trigger)
        from gpumounter_tpu_torch.utils.events import EVENTS
        EVENTS.emit("flight_dump", rid=rid, trigger=trigger, id=bundle_id)
        logger.warning("flight recorder: bundle %s written (trigger=%s, "
                       "rid=%s)", bundle_id, trigger, rid or "-")
        return bundle_id

    # -- collection ------------------------------------------------------------

    def _collect(self, bundle_id: str, trigger: str, rid: str,
                 context: dict) -> dict:
        from gpumounter_tpu_torch.utils.events import EVENTS
        from gpumounter_tpu_torch.utils.trace import STORE
        events = EVENTS.tail(128)
        bundle: dict = {
            "id": bundle_id,
            "trigger": trigger,
            "rid": rid,
            "ts": round(time.time(), 3),
            "context": context,
            "events": events,
            "rid_events": ([e for e in events if e.get("rid") == rid]
                           if rid else []),
            "traces": {
                "slowest": STORE.slowest(limit=5),
                "failed": [t for t in STORE.recent(limit=32)
                           if t.get("result") not in ("SUCCESS", "ok",
                                                      "200")][:10],
                "rid": STORE.find(rid) if rid else [],
            },
        }
        # snapshot under the lock: the gateway's shutdown pops its
        # "broker" provider while a settle-deferred collect may still be
        # running — iterating the live dict there would raise
        with self._lock:
            providers = list(self.providers.items())
        for name, provider in sorted(providers):
            try:
                bundle[name] = provider()
            except Exception as e:  # noqa: BLE001 — bundle must survive
                bundle[name] = {"error": f"{type(e).__name__}: {e}"}
        return bundle

    def _write(self, bundle_id: str, bundle: dict) -> None:
        os.makedirs(self.dir, exist_ok=True)
        path = os.path.join(self.dir, f"{bundle_id}.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(bundle, f, indent=2, sort_keys=True, default=str)
            f.flush()
        os.replace(tmp, path)       # atomic: no reader sees a torn bundle
        self._prune()

    def _prune(self) -> None:
        try:
            bundles = sorted((n for n in os.listdir(self.dir)
                              if n.startswith("flight-")
                              and n.endswith(".json")),
                             key=self._bundle_order)
        except OSError:
            return
        for name in bundles[:-MAX_BUNDLES]:
            try:
                os.remove(os.path.join(self.dir, name))
            except OSError:
                pass

    # -- inspection (tpumounterctl flight) -------------------------------------

    @staticmethod
    def list_bundles(dir_path: str) -> list[dict]:
        """Bundle summaries (id/trigger/rid/ts), newest first."""
        out = []
        try:
            names = [n for n in os.listdir(dir_path)
                     if n.startswith("flight-") and n.endswith(".json")]
        except OSError:
            return []
        for name in sorted(names, key=FlightRecorder._bundle_order,
                           reverse=True):
            path = os.path.join(dir_path, name)
            try:
                with open(path) as f:
                    bundle = json.load(f)
            except (OSError, ValueError):
                out.append({"id": name[:-5], "error": "unreadable"})
                continue
            out.append({"id": bundle.get("id", name[:-5]),
                        "trigger": bundle.get("trigger"),
                        "rid": bundle.get("rid"),
                        "ts": bundle.get("ts"),
                        "events": len(bundle.get("events") or [])})
        return out

    @staticmethod
    def load(dir_path: str, bundle_id: str) -> dict | None:
        """None = no such bundle; an unreadable one (corrupt, or pruned
        between listing and open) degrades to an ``error`` record like
        :meth:`list_bundles` — never a traceback into the CLI."""
        path = os.path.join(dir_path, f"{bundle_id}.json")
        try:
            with open(path) as f:
                return json.load(f)
        except FileNotFoundError:
            return None
        except (OSError, ValueError):
            return {"id": bundle_id, "error": "unreadable"}


def _from_env() -> FlightRecorder:
    from gpumounter_tpu_torch.utils import consts
    interval = DEFAULT_MIN_INTERVAL_S
    if raw := os.environ.get(consts.ENV_FLIGHT_INTERVAL_S):
        try:
            interval = float(raw)
        except ValueError:
            pass
    return FlightRecorder(
        dir_path=os.environ.get(consts.ENV_FLIGHT_DIR) or None,
        min_interval_s=interval)


# One recorder per process, like metrics.REGISTRY / events.EVENTS.
RECORDER = _from_env()
