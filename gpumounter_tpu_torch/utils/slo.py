"""Per-tenant SLO engine: error-budget burn rates from the live registry
(the port of :mod:`gpumounter_tpu.utils.slo`, on the port's registry).

The metric families answer "what happened"; an on-call needs "is tenant X
inside its service-level objective RIGHT NOW, and how fast is it eating
the error budget?". This module computes that the way a Prometheus
multiwindow burn-rate alert would — but in-process, from the same
counters, so `tpumounterctl doctor` and `/fleetz` answer without a
Prometheus deployment:

- every :meth:`SloEngine.tick` samples the relevant counter/bucket series
  into a bounded history ring;
- for each window (5m, 1h) the engine diffs the newest sample against the
  sample closest to the window's start and computes, per tenant and
  objective, ``burn = windowed_error_ratio / (1 - target)`` — burn 1.0
  means the tenant is consuming its budget exactly at the sustainable
  rate, burn 14.4 over 5m means the whole 30-day budget would be gone in
  ~2 days (the standard fast-burn page threshold);
- results are exported as ``tpumounter_slo_burn_rate{tenant,slo,window}``
  and served inside ``GET /fleetz``; doctor CRITs on fast burn, and a
  fast burn is a flight-recorder trigger (utils/flight.py).

Objectives (targets are deliberately conservative defaults; the PromQL
equivalents live in docs/guide/Observability.md):

- ``attach_success`` (per tenant): admission decisions that granted
  (``granted``/``granted_queued``) vs everything else, target 99%;
- ``attach_overhead`` (fleet-wide, tenant ``*``): gateway ``addgpu``
  requests completing within :data:`OVERHEAD_SLO_S`, target 99% — the
  p99-under-threshold form of the overhead objective;
- ``queue_wait`` (per tenant): queued attaches woken within
  :data:`QUEUE_WAIT_SLO_S`, target 95%.
"""

from __future__ import annotations

import collections
import threading
import time

from gpumounter_tpu_torch.utils.metrics import REGISTRY

# Budget-consumption multipliers (Google SRE workbook, 30d budget):
# 5m burn >= 14.4 pages (CRIT); 1h burn >= 6 tickets (WARN).
FAST_BURN = 14.4
SLOW_BURN = 6.0

# Minimum events in a window before a burn is computed at all: ratios
# over a handful of requests are statistically meaningless (ONE denied
# attach in an otherwise idle window would read as a 50x "burn" and
# page), so low-traffic windows export nothing — the same implicit
# volume floor a rate()-based Prometheus burn alert has.
MIN_WINDOW_SAMPLES = 10

WINDOWS = {"5m": 300.0, "1h": 3600.0}

OVERHEAD_SLO_S = 3.0        # the < 3 s attach north star (BASELINE.md)
QUEUE_WAIT_SLO_S = 30.0

TARGETS = {
    "attach_success": 0.99,
    "attach_overhead": 0.99,
    "queue_wait": 0.95,
}

# Admission outcomes that count as the tenant's attach succeeding.
_GRANTED = ("granted", "granted_queued")


class SloEngine:
    """Windowed burn-rate computation over the process registry."""

    def __init__(self, registry=None, clock=time.monotonic):
        self.registry = registry or REGISTRY
        self._clock = clock
        self._lock = threading.Lock()
        # (t, {series key: cumulative value}); pruned by AGE each tick
        # (longest window + slack), not by count — a count-sized ring
        # silently shrinks the "1h" window when the fleet loop ticks
        # faster than the default 5 s (TPU_FLEET_INTERVAL_S=1 would turn
        # it into ~17 min still exported under the 1h label)
        self._samples: collections.deque = collections.deque()
        # latest computed burns: (tenant, slo, window) -> burn
        self._burns: dict[tuple[str, str, str], float] = {}
        # (tenant, slo) currently fast-burning: the lifecycle event (and
        # flight trigger) fires on the RISING edge only — a sustained
        # burn re-reported every 5 s tick would flood the bounded event
        # ring with duplicates and evict the actual incident evidence
        self._fast: set[tuple[str, str]] = set()

    # -- sampling --------------------------------------------------------------

    def _tenants(self) -> set[str]:
        return {t for t in (dict(key).get("tenant", "") for key in
                            self.registry.admission_decisions.series())
                if t}

    def _sample(self) -> dict:
        reg = self.registry
        sample: dict = {}
        for tenant in self._tenants():
            total = ok = 0.0
            for outcome in ("granted", "granted_queued", "over_quota",
                            "queue_full", "queue_timeout"):
                value = reg.admission_decisions.value(tenant=tenant,
                                                      outcome=outcome)
                total += value
                if outcome in _GRANTED:
                    ok += value
            sample[("admit", tenant, "total")] = total
            sample[("admit", tenant, "ok")] = ok
            sample[("queue", tenant, "total")] = reg.queue_wait.count(
                tenant=tenant)
            sample[("queue", tenant, "ok")] = reg.queue_wait.count_le(
                QUEUE_WAIT_SLO_S, tenant=tenant)
        sample[("latency", "*", "total")] = reg.gateway_requests.count(
            route="addgpu")
        sample[("latency", "*", "ok")] = reg.gateway_requests.count_le(
            OVERHEAD_SLO_S, route="addgpu")
        return sample

    # -- burn computation ------------------------------------------------------

    @staticmethod
    def _burn(errors: float, total: float, target: float) -> float | None:
        """None = no traffic in the window (no burn to speak of)."""
        if total <= 0:
            return None
        return (errors / total) / max(1e-9, 1.0 - target)

    def tick(self, now: float | None = None) -> dict:
        """Sample, recompute every (tenant, slo, window) burn, export the
        gauge. Returns {(tenant, slo, window): burn} for callers (fleet
        loop, tests, the flight-recorder trigger check)."""
        now = self._clock() if now is None else now
        sample = self._sample()
        with self._lock:
            self._samples.append((now, sample))
            horizon = now - (max(WINDOWS.values()) + 120.0)
            while self._samples and self._samples[0][0] < horizon:
                self._samples.popleft()
            samples = list(self._samples)
        burns: dict[tuple[str, str, str], float] = {}
        latest = samples[-1][1]
        for window, span in WINDOWS.items():
            base = self._baseline(samples, now - span)
            if base is None:
                continue
            for key in latest:
                kind, tenant, field = key
                if field != "total":
                    continue
                total = latest[key] - base.get(key, 0.0)
                if total < MIN_WINDOW_SAMPLES:
                    continue
                ok_key = (kind, tenant, "ok")
                ok = latest.get(ok_key, 0.0) - base.get(ok_key, 0.0)
                slo = {"admit": "attach_success",
                       "queue": "queue_wait",
                       "latency": "attach_overhead"}[kind]
                burn = self._burn(max(0.0, total - ok), total,
                                  TARGETS[slo])
                if burn is None:
                    continue
                burns[(tenant, slo, window)] = round(burn, 3)
        for (tenant, slo, window), burn in burns.items():
            self.registry.slo_burn_rate.set(burn, tenant=tenant, slo=slo,
                                            window=window)
        # a tenant that went quiet keeps its last gauge value until traffic
        # resumes — zero it instead, so dashboards don't freeze a burn
        with self._lock:
            for key in set(self._burns) - set(burns):
                tenant, slo, window = key
                self.registry.slo_burn_rate.set(0.0, tenant=tenant,
                                                slo=slo, window=window)
            self._burns = burns
        self._check_fast_burn(burns)
        return burns

    def reset(self) -> None:
        """Zero every burn this engine exported and drop its history —
        called when the owning master stops, so a dead engine's latched
        gauge values can't masquerade as current state on a shared
        registry (in-process test stacks)."""
        with self._lock:
            burns, self._burns = self._burns, {}
            self._samples.clear()
            self._fast.clear()
        for (tenant, slo, window) in burns:
            self.registry.slo_burn_rate.set(0.0, tenant=tenant, slo=slo,
                                            window=window)

    @staticmethod
    def _baseline(samples: list, cutoff: float) -> dict | None:
        """The newest sample at or before ``cutoff`` — or the oldest one
        held, so a young process still judges what history it has. None
        only when this tick took the very first sample (no delta yet)."""
        if len(samples) < 2:
            return None
        best = samples[0]
        for entry in samples:
            if entry[0] <= cutoff:
                best = entry
            else:
                break
        return best[1]

    def _check_fast_burn(self, burns: dict) -> None:
        from gpumounter_tpu_torch.utils.events import EVENTS
        from gpumounter_tpu_torch.utils.flight import RECORDER
        now_fast = {(tenant, slo)
                    for (tenant, slo, window), burn in burns.items()
                    if window == "5m" and burn >= FAST_BURN}
        with self._lock:
            rising = now_fast - self._fast
            self._fast = now_fast
        for tenant, slo in sorted(rising):
            burn = burns[(tenant, slo, "5m")]
            EVENTS.emit("fast_burn", tenant=tenant, slo=slo, burn=burn)
            RECORDER.note("fast_burn", tenant=tenant, slo=slo, burn=burn)

    # -- introspection (/fleetz, doctor) ---------------------------------------

    def snapshot(self) -> dict:
        with self._lock:
            burns = dict(self._burns)
        worst: tuple[str, str, float] | None = None
        for (tenant, slo, window), burn in burns.items():
            if window == "5m" and (worst is None or burn > worst[2]):
                worst = (tenant, slo, burn)
        return {
            "targets": dict(TARGETS),
            "windows": {w: s for w, s in WINDOWS.items()},
            "thresholds": {"fast_burn_5m": FAST_BURN,
                           "slow_burn_1h": SLOW_BURN},
            "burn_rates": [
                {"tenant": tenant, "slo": slo, "window": window,
                 "burn": burn}
                for (tenant, slo, window), burn in sorted(burns.items())],
            "top_burn": (None if worst is None else
                         {"tenant": worst[0], "slo": worst[1],
                          "burn": worst[2]}),
        }
