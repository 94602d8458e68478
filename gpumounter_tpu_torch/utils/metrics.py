"""Minimal Prometheus-text-format metrics registry: the port's own copy of
:mod:`gpumounter_tpu.utils.metrics`.

The machinery (counters, histograms, gauges, the exposition and its
parser) is the control plane's whole. The :class:`Registry` holds the
families the port's modules record into so far, under the control plane's
``tpumounter_*`` names, which the shipped dashboards select on; the rest
arrive with the modules that record them. A process that runs both
packages has two registries, so tests read deltas.

The reference has no metrics at all (SURVEY.md §5: "No metrics endpoint, no
health/readiness probes"). The north-star number for this framework is
hot-attach latency (<3s p50, BASELINE.md), so it must be measured in
production, not just in benchmarks: the worker exports an attach/detach
latency histogram + result counters on its health port, text exposition
format, scrapeable by any Prometheus.
"""

from __future__ import annotations

import collections
import threading
import time
from collections.abc import Iterator

# Histogram bucket upper bounds (seconds) sized around the 3s p50 target.
DEFAULT_BUCKETS = (0.1, 0.25, 0.5, 1.0, 2.0, 3.0, 5.0, 10.0, 30.0, 60.0)


class Counter:
    def __init__(self, name: str, help_text: str):
        self.name = name
        self.help = help_text
        self._lock = threading.Lock()
        self._values: dict[tuple[tuple[str, str], ...], float] = {}

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        key = tuple(sorted(labels.items()))
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels: str) -> float:
        key = tuple(sorted(labels.items()))
        with self._lock:
            return self._values.get(key, 0.0)

    def series(self) -> dict[tuple[tuple[str, str], ...], float]:
        """Every label set ever observed with its value (the SLO engine
        discovers tenants from here)."""
        with self._lock:
            return dict(self._values)

    def render(self, openmetrics: bool = False) -> Iterator[str]:
        # OpenMetrics names the counter FAMILY without the _total suffix
        # (samples keep it); a spec-strict OM parser rejects a family
        # named *_total. The classic exposition keeps the historical
        # family name == sample name.
        family = self.name
        if openmetrics and family.endswith("_total"):
            family = family[:-len("_total")]
        yield f"# HELP {family} {self.help}"
        yield f"# TYPE {family} counter"
        with self._lock:
            items = list(self._values.items())
        for key, value in items:
            yield f"{self.name}{_fmt_labels(dict(key))} {_fmt_num(value)}"


class Histogram:
    # Exact observations kept for percentile(); bounded so a long-lived
    # worker daemon doesn't grow memory with every attach.
    MAX_OBSERVATIONS = 4096

    def __init__(self, name: str, help_text: str,
                 buckets: tuple[float, ...] = DEFAULT_BUCKETS):
        self.name = name
        self.help = help_text
        self.buckets = tuple(sorted(buckets))
        self._lock = threading.Lock()
        self._counts = [0] * (len(self.buckets) + 1)
        self._sum = 0.0
        self._total = 0
        self._observations: collections.deque[float] = collections.deque(
            maxlen=self.MAX_OBSERVATIONS)
        # bucket index -> (labels, value, unix ts): the LAST exemplar that
        # landed in that bucket (OpenMetrics semantics) — a bad
        # gateway_request_seconds bucket links straight to its /tracez rid.
        self._exemplars: dict[int, tuple[dict, float, float]] = {}

    def observe(self, value: float,
                exemplar: dict[str, str] | None = None) -> None:
        with self._lock:
            self._sum += value
            self._total += 1
            self._observations.append(value)
            for i, bound in enumerate(self.buckets):
                if value <= bound:
                    self._counts[i] += 1
                    if exemplar:
                        self._exemplars[i] = (exemplar, value, time.time())
                    return
            self._counts[-1] += 1
            if exemplar:
                self._exemplars[len(self.buckets)] = (exemplar, value,
                                                      time.time())

    def time(self) -> "_Timer":
        return _Timer(self)

    def percentile(self, q: float) -> float:
        """Exact percentile over all observations (for tests/bench; a real
        Prometheus would estimate from buckets)."""
        with self._lock:
            if not self._observations:
                return 0.0
            ordered = sorted(self._observations)
            idx = min(len(ordered) - 1, int(q / 100.0 * len(ordered)))
            return ordered[idx]

    @property
    def count(self) -> int:
        with self._lock:
            return self._total

    def count_le(self, bound: float) -> int:
        """Cumulative observations in buckets whose upper bound is <=
        ``bound`` — what the SLO engine diffs over windows to get
        "fraction of requests under the latency objective". Rounding is
        CONSERVATIVE: a bound between bucket boundaries excludes the
        straddling bucket, over-reporting violations rather than hiding
        them — SLO thresholds should sit on bucket boundaries (the
        shipped ones do: 3.0 s / 30.0 s)."""
        with self._lock:
            cumulative = 0
            for i, upper in enumerate(self.buckets):
                if upper > bound:
                    break
                cumulative += self._counts[i]
            return cumulative

    @staticmethod
    def _fmt_exemplar(ex: tuple[dict, float, float]) -> str:
        labels, value, ts = ex
        inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
        return f" # {{{inner}}} {_fmt_num(value)} {round(ts, 3)}"

    def render(self, exemplars: bool = False) -> Iterator[str]:
        """``exemplars=True`` appends the OpenMetrics ``# {...}`` suffix
        to exemplar-bearing bucket lines. That syntax is NOT valid in the
        classic ``text/plain; version=0.0.4`` exposition (a real
        Prometheus would fail the WHOLE scrape on it), so it is emitted
        only when the scraper negotiated OpenMetrics — see
        Registry.render_text."""
        yield f"# HELP {self.name} {self.help}"
        yield f"# TYPE {self.name} histogram"
        with self._lock:
            cumulative = 0
            for i, bound in enumerate(self.buckets):
                cumulative += self._counts[i]
                suffix = (self._fmt_exemplar(self._exemplars[i])
                          if exemplars and i in self._exemplars else "")
                yield (f'{self.name}_bucket{{le="{_fmt_num(bound)}"}} '
                       f"{cumulative}{suffix}")
            cumulative += self._counts[-1]
            last = len(self.buckets)
            suffix = (self._fmt_exemplar(self._exemplars[last])
                      if exemplars and last in self._exemplars else "")
            yield f'{self.name}_bucket{{le="+Inf"}} {cumulative}{suffix}'
            yield f"{self.name}_sum {_fmt_num(self._sum)}"
            yield f"{self.name}_count {cumulative}"


class LabeledHistogram:
    """A family of :class:`Histogram` series keyed by label values — the
    subset of prometheus-client's labelled histogram this repo needs
    (per-phase attach/detach latency). Series are created on first
    observe; rendering emits one HELP/TYPE header then every series'
    buckets/sum/count with its labels merged alongside ``le``."""

    def __init__(self, name: str, help_text: str,
                 buckets: tuple[float, ...] = DEFAULT_BUCKETS):
        self.name = name
        self.help = help_text
        self.buckets = buckets
        self._lock = threading.Lock()
        self._series: dict[tuple[tuple[str, str], ...], Histogram] = {}

    def _get(self, labels: dict[str, str]) -> Histogram:
        key = tuple(sorted(labels.items()))
        with self._lock:
            hist = self._series.get(key)
            if hist is None:
                hist = self._series[key] = Histogram(
                    self.name, self.help, self.buckets)
            return hist

    def _peek(self, labels: dict[str, str]) -> Histogram | None:
        """Read-side lookup: probing a series that never observed must NOT
        create it, or /metrics would grow a phantom all-zero series per
        mistyped phase queried."""
        with self._lock:
            return self._series.get(tuple(sorted(labels.items())))

    def observe(self, value: float,
                exemplar: dict[str, str] | None = None,
                **labels: str) -> None:
        self._get(labels).observe(value, exemplar=exemplar)

    def percentile(self, q: float, **labels: str) -> float:
        hist = self._peek(labels)
        return hist.percentile(q) if hist is not None else 0.0

    def count(self, **labels: str) -> int:
        hist = self._peek(labels)
        return hist.count if hist is not None else 0

    def count_le(self, bound: float, **labels: str) -> int:
        hist = self._peek(labels)
        return hist.count_le(bound) if hist is not None else 0

    def phases(self) -> list[dict[str, str]]:
        with self._lock:
            return [dict(key) for key in self._series]

    def render(self, exemplars: bool = False) -> Iterator[str]:
        yield f"# HELP {self.name} {self.help}"
        yield f"# TYPE {self.name} histogram"
        with self._lock:
            items = sorted(self._series.items())
        for key, hist in items:
            labels = dict(key)
            for line in hist.render(exemplars=exemplars):
                if line.startswith("#"):
                    continue
                if not labels:
                    # a label-less series: the plain lines are already
                    # valid ({,le=...} with a leading comma is not)
                    yield line
                elif "{" in line:                    # _bucket{le="..."}
                    # merge series labels into the bucket lines
                    head, rest = line.split("{", 1)
                    extra = ",".join(f'{k}="{v}"'
                                     for k, v in sorted(labels.items()))
                    yield f"{head}{{{extra},{rest}"
                else:                                # _sum / _count
                    head, value = line.rsplit(" ", 1)
                    yield f"{head}{_fmt_labels(labels)} {value}"


class _Timer:
    def __init__(self, hist: Histogram):
        self._hist = hist

    def __enter__(self) -> "_Timer":
        self._start = time.monotonic()
        return self

    def __exit__(self, *exc) -> None:
        self._hist.observe(time.monotonic() - self._start)


def parse_exposition(text: str) -> dict:
    """Minimal parser for Prometheus text exposition: returns
    {metric_name: {frozen label tuple: value}} for non-comment lines —
    the read half of the format this module renders (the operator CLI's
    doctor and the master's fleet aggregator both scrape with it).
    Handles the standard optional trailing timestamp
    (``name{labels} value timestamp_ms``) — the value is the FIRST token
    after the name/labels, not the last — and OpenMetrics exemplars
    (``... value # {rid="..."} exemplar_value ts``), which are stripped
    before the label/value split (the exemplar's own ``}`` would
    otherwise hijack the label rpartition)."""
    out: dict = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        line = line.split(" # ", 1)[0].rstrip()
        labels = {}
        if "{" in line:
            name, _, rest = line.partition("{")
            labelstr, _, tail = rest.rpartition("}")
            for part in labelstr.split(","):
                if "=" in part:
                    k, _, v = part.partition("=")
                    labels[k] = v.strip('"')
            fields = tail.split()
        else:
            fields = line.split()
            name, fields = fields[0], fields[1:]
        if not fields:
            continue
        try:
            out.setdefault(name, {})[tuple(sorted(labels.items()))] = \
                float(fields[0])
        except ValueError:
            continue
    return out


def _fmt_labels(labels: dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _fmt_num(v: float) -> str:
    return str(int(v)) if float(v).is_integer() else repr(float(v))


class Gauge:
    def __init__(self, name: str, help_text: str):
        self.name = name
        self.help = help_text     # same attribute as Counter/Histogram
        self._values: dict[tuple, float] = {}
        self._lock = threading.Lock()

    def set(self, value: float, **labels: str) -> None:
        with self._lock:
            self._values[tuple(sorted(labels.items()))] = value

    def value(self, **labels: str) -> float:
        with self._lock:
            return self._values.get(tuple(sorted(labels.items())), 0.0)

    def render(self) -> Iterator[str]:
        yield f"# HELP {self.name} {self.help}"
        yield f"# TYPE {self.name} gauge"
        with self._lock:
            for labels, value in sorted(self._values.items()):
                yield (f"{self.name}{_fmt_labels(dict(labels))} "
                       f"{_fmt_num(value)}")


class Registry:
    """Process-wide metric set for one binary (worker or master)."""

    def __init__(self):
        # The worker's attach and detach (worker/service.py): end-to-end
        # latency and calls by result, under the control plane's names
        # and help texts (the dashboards select on them).
        self.attach_latency = Histogram(
            "tpumounter_attach_seconds",
            "End-to-end AddTPU latency (allocation + actuation)")
        self.detach_latency = Histogram(
            "tpumounter_detach_seconds",
            "End-to-end RemoveTPU latency")
        self.attach_results = Counter(
            "tpumounter_attach_total", "AddTPU calls by result")
        self.detach_results = Counter(
            "tpumounter_detach_total", "RemoveTPU calls by result")
        # Collector snapshots (collector/collector.py): GPUs by allocation
        # state. A GPU node no driver source names ("unidentified") can
        # never be allocated and is never counted free.
        self.chips = Gauge(
            "tpumounter_node_chips",
            "Chips on this node by allocation state "
            "(refreshed on every collector snapshot)")
        # Orphaned slave pods the reconciler deleted (worker/reconciler.py);
        # the labelless series is seeded at 0 so increase() sees the first.
        self.orphans_reclaimed = Counter(
            "tpumounter_orphans_reclaimed_total",
            "Orphaned slave pods deleted by the reconciler (their owner "
            "pod vanished while holding chips — normal GC, but a rising "
            "rate means workloads die mid-hold)")
        self.orphans_reclaimed.inc(0.0)
        # Attach and detach by phase (utils/trace.py Trace.finish).
        self.attach_phase = LabeledHistogram(
            "tpumounter_attach_phase_seconds",
            "AddTPU latency by phase "
            "(worker: policy/allocate/resolve/actuate, rollback on mount "
            "failure; master slice txns: validate/fanout/rollback)")
        self.detach_phase = LabeledHistogram(
            "tpumounter_detach_phase_seconds",
            "RemoveTPU latency by phase (resolve/actuate/cleanup)")
        # Every apiserver / kubelet PodResources round-trip, by verb and
        # resource (utils/trace.py k8s_call).
        self.k8s_latency = LabeledHistogram(
            "tpumounter_k8s_request_seconds",
            "Kubernetes apiserver and kubelet PodResources call latency "
            "by verb and resource",
            buckets=(0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
                     5.0, 10.0, 30.0))
        self.k8s_errors = Counter(
            "tpumounter_k8s_request_errors_total",
            "Kubernetes apiserver and kubelet calls that raised, by verb "
            "and resource (includes expected 404s — same convention as "
            "client-go's rest_client metrics)")
        # Resilience layer (utils/retry.py): re-attempts by coarse target,
        # and the circuit state (0 closed / 1 half-open / 2 open).
        self.retry_attempts = Counter(
            "tpumounter_retry_attempts_total",
            "Retried control-plane calls by target (each increment is one "
            "re-attempt after a transient failure)")
        self.circuit_state = Gauge(
            "tpumounter_circuit_state",
            "Circuit breaker state per target "
            "(0 closed, 1 half-open, 2 open)")
        # Attach journal (worker/journal.py): boot replays by outcome.
        self.journal_replays = Counter(
            "tpumounter_journal_replays_total",
            "Attach-journal records replayed at worker startup, by outcome")
        # Shared pod informer (k8s/informer.py): applied watch events,
        # stream deaths that forced a re-LIST, and the read handle's
        # cache hits and fall-through misses.
        self.informer_events = Counter(
            "tpumounter_informer_events_total",
            "Watch events applied to the shared pod informer cache, by "
            "event type")
        self.informer_watch_restarts = Counter(
            "tpumounter_informer_watch_restarts_total",
            "Informer watch streams that died beyond the resume budget "
            "and re-seeded from a fresh LIST")
        self.informer_watch_restarts.inc(0.0)
        self.cache_hits = Counter(
            "tpumounter_cache_hits_total",
            "Pod reads served from the shared informer cache, by verb")
        self.cache_misses = Counter(
            "tpumounter_cache_misses_total",
            "Covered pod reads that fell through to the apiserver, by "
            "verb and reason")
        # Fused actuation (actuation/mount.py): one namespace crossing per
        # container; batches/ops give the fusion factor.
        self.actuation_batches = Counter(
            "tpumounter_actuation_batches_total",
            "Batched device-node actuation invocations (one namespace "
            "crossing each), by op (create/remove)")
        self.actuation_batch_ops = Counter(
            "tpumounter_actuation_batch_ops_total",
            "Individual device-node operations carried inside actuation "
            "batches, by op (create/remove)")
        self.actuation_batch_size = Gauge(
            "tpumounter_actuation_batch_size",
            "Size of the most recent device-node actuation batch, by op "
            "(create/remove)")
        # Resident actuation agent (actuation/agent.py): plans and ops it
        # ran, faults degraded to the fallback actuator (by reason; a
        # non-zero rate means the agent is unhealthy), namespace-handle
        # revalidations and the handles cached.
        self.agent_batches = Counter(
            "tpumounter_actuation_agent_batches_total",
            "Device-node plans executed by the resident actuation agent, "
            "by op (create/remove)")
        self.agent_batch_ops = Counter(
            "tpumounter_actuation_agent_ops_total",
            "Individual device-node operations executed by the resident "
            "actuation agent")
        self.agent_fallbacks = Counter(
            "tpumounter_actuation_agent_fallbacks_total",
            "Agent faults degraded to the fallback actuator, by reason")
        self.agent_fallbacks.inc(0.0, reason="stale_ns_fd")
        self.agent_revalidations = Counter(
            "tpumounter_actuation_agent_revalidations_total",
            "Cached namespace-handle identity checks, by outcome "
            "(ok/stale)")
        self.agent_ns_fds = Gauge(
            "tpumounter_actuation_agent_ns_fds",
            "Namespace handles currently cached by the resident "
            "actuation agent")
        # Parking executor (utils/parking.py): worker RPC handler threads
        # parked in a slow wait with their active slot released.
        self.worker_rpc_parked = Gauge(
            "tpumounter_worker_rpc_parked",
            "Worker RPC handler threads parked in a slow wait (active "
            "slot released back to the executor budget)")
        # Telemetry plane (utils/events.py): lifecycle events by kind.
        self.events_emitted = Counter(
            "tpumounter_events_total",
            "Lifecycle events emitted into the event log, by kind")
        # Flight recorder (utils/flight.py): bundles by trigger, and
        # triggers the rate limit swallowed. Every trigger is pre-seeded
        # at 0: increase() over a series that first appears at 1 reads 0,
        # and incidents are usually exactly one bundle.
        self.flight_dumps = Counter(
            "tpumounter_flight_dumps_total",
            "Flight-recorder bundles written, by trigger")
        for trigger in ("fast_burn", "agent_fallback", "journal_backlog",
                        "circuit_open", "idle_lease_burst",
                        "device_denial_burst"):
            self.flight_dumps.inc(0.0, trigger=trigger)
        self.flight_suppressed = Counter(
            "tpumounter_flight_suppressed_total",
            "Flight-recorder triggers suppressed by the rate limit")
        self.flight_suppressed.inc(0.0)
        # Device-access accounting: exact per-syscall open counts where
        # the kernel device gate is live (actuation/gate.py pump).
        self.device_opens = Counter(
            "tpumounter_device_opens_total",
            "Observed chip device-node open transitions, by tenant and "
            "outcome (attributed/unattributed; unattributed = busy chip "
            "with no owner on record). Where the kernel device gate is "
            "live these are EXACT per-syscall counts from its policy-map "
            "counters; elsewhere they remain the usage sampler's "
            "sampling-resolution edge accounting")
        self.device_opens.inc(0.0, tenant="", outcome="unattributed")
        # Kernel-enforced device gate (actuation/gate.py): denials with
        # the revocation cause, mutations by backend and outcome, and the
        # drift the audit found.
        self.device_denials = Counter(
            "tpumounter_device_denials_total",
            "Device opens denied by the kernel device gate, by tenant "
            "and reason (revoked:<cause> = access cut by the control "
            "plane; ungranted = never granted)")
        self.device_denials.inc(0.0, tenant="", reason="ungranted")
        self.gate_syncs = Counter(
            "tpumounter_gate_syncs_total",
            "Device-gate policy mutations by backend and outcome "
            "(fault = degraded to the legacy enforcement path)")
        self.gate_syncs.inc(0.0, backend="native-map", outcome="fault")
        self.gate_drift = Gauge(
            "tpumounter_gate_drift",
            "Gate entries found granting chips with no live owner "
            "attachment at the last reconciler audit (reclaimed)")
        # Identifies the build on every /metrics surface (standard
        # <name>_info pattern: constant 1, the payload is the label).
        from gpumounter_tpu_torch import __version__
        # Warm-pool effectiveness (worker/pool.py): hits = slave pods
        # adopted from the pool (attach skipped the scheduler wait),
        # misses = pods the attach had to cold-create with a pool enabled.
        self.pool_hits = Counter(
            "tpumounter_pool_hits_total",
            "Slave pods adopted from the warm pool by AddTPU")
        self.pool_misses = Counter(
            "tpumounter_pool_misses_total",
            "Slave pods cold-created by AddTPU despite an enabled pool")
        self.pool_hits.inc(0.0)      # pre-seed: see orphans_reclaimed
        self.pool_misses.inc(0.0)
        self.warm_pool_size = Gauge(
            "tpumounter_warm_pool_size",
            "Adoptable (Running, unowned) warm slave pods by pool key")
        self.pool_refill_latency = Histogram(
            "tpumounter_pool_refill_seconds",
            "Warm-pod creation to Running (the scheduler cost the pool "
            "pays off the attach critical path)")
        # The master (master/gateway.py, httpfront.py): request latency by
        # route, and the multiplexed front's admission state.
        self.gateway_requests = LabeledHistogram(
            "tpumounter_gateway_request_seconds",
            "Master gateway HTTP request latency by route")
        self.gateway_inflight = Gauge(
            "tpumounter_gateway_inflight",
            "HTTP requests currently admitted by the master gateway "
            "front (queued or being processed)")
        self.gateway_rejected = Counter(
            "tpumounter_gateway_rejected_total",
            "Connections refused by the gateway front's admission bound")
        self.gateway_rejected.inc(0.0)   # pre-seed: see orphans_reclaimed
        # Attach broker (master/admission.py, lease.py, waiterindex.py).
        self.admission_decisions = Counter(
            "tpumounter_admission_decisions_total",
            "Attach-broker admission decisions by tenant and outcome")
        self.queue_depth = Gauge(
            "tpumounter_queue_depth",
            "Attach requests waiting in the broker queue, by priority")
        self.queue_oldest_age = Gauge(
            "tpumounter_queue_oldest_age",
            "Age in seconds of the oldest queued attach request "
            "(0 = queue empty)")
        self.queue_wait = LabeledHistogram(
            "tpumounter_queue_wait_seconds",
            "Time a contended attach spent queued in the broker before "
            "completing or timing out, by tenant")
        self.wakeup_signals = Counter(
            "tpumounter_wakeup_signals_total",
            "Capacity signals that scanned the waiter queue for a "
            "candidate to wake")
        self.wakeup_signals.inc(0.0)     # pre-seed: see orphans_reclaimed
        self.wakeup_evaluations = Counter(
            "tpumounter_wakeup_evaluations_total",
            "Parked waiters examined across all capacity signals (the "
            "per-signal cost of choosing whom to wake)")
        self.wakeup_evaluations.inc(0.0)
        self.preemptions = Counter(
            "tpumounter_preemptions_total",
            "Live attachments detached by the broker to make room for a "
            "high-priority request (victims are over-quota tenants)")
        self.preemptions.inc(0.0)        # pre-seed: see orphans_reclaimed
        self.lease_expirations = Counter(
            "tpumounter_lease_expirations_total",
            "Expired attachment leases auto-detached by the broker "
            "(chips drained back to the pool instead of leaking)")
        self.lease_expirations.inc(0.0)  # pre-seed: see orphans_reclaimed
        self.active_leases = Gauge(
            "tpumounter_active_leases",
            "Live attachment leases tracked by the broker, by tenant")
        self.tenant_chips_in_use = Gauge(
            "tpumounter_tenant_chips_in_use",
            "Chips currently held under broker leases, by tenant")
        self.tenant_quota_chips = Gauge(
            "tpumounter_tenant_quota_chips",
            "Configured chip quota by tenant (absent = unlimited)")
        # The HA plane (master/store.py, master/election.py, the
        # gateway's shard gate). store_cas counts every intent-store
        # compare-and-swap by op and outcome; conflicts are normal CAS
        # churn between replicas, errors mean records parked dirty (see
        # store_lag).
        self.store_cas = Counter(
            "tpumounter_store_cas_total",
            "Intent-store ConfigMap compare-and-swap attempts by op and "
            "outcome (conflict = lost an optimistic-concurrency race)")
        for outcome in ("ok", "conflict", "error"):
            self.store_cas.inc(0.0, op="put", outcome=outcome)
        self.store_records = Gauge(
            "tpumounter_store_records",
            "Intent records this replica has persisted in its owned "
            "shards' state ConfigMaps, by kind (lease/waiter) and shard")
        self.store_lag = Gauge(
            "tpumounter_store_lag",
            "Seconds since the oldest broker mutation that has not yet "
            "reached the intent store (0 = store in sync)")
        # Per-shard leadership as THIS replica sees it; max by (shard)
        # across replicas == 0 means the shard is leaderless.
        self.election_is_leader = Gauge(
            "tpumounter_election_is_leader",
            "Whether this replica currently leads the shard (1/0); "
            "max over replicas == 0 means the shard is leaderless")
        self.election_transitions = Counter(
            "tpumounter_election_transitions_total",
            "Shard leadership transitions observed by this replica, by "
            "shard and outcome (acquired/lost) — a climbing rate is "
            "leadership flapping")
        self.election_transitions.inc(0.0, shard="0", outcome="acquired")
        self.election_transitions.inc(0.0, shard="0", outcome="lost")
        self.shard_forwards = Counter(
            "tpumounter_shard_forwards_total",
            "Requests that landed on a non-owning replica and were "
            "forwarded to the shard leader, by mode (proxy/redirect) "
            "and outcome")
        self.shard_forwards.inc(0.0, mode="proxy", outcome="ok")
        # Cross-shard capacity nudges (master/store.py): sent = this
        # replica stamped a peer shard's state ConfigMap after freeing
        # GPUs; received = a tick observed a moved stamp.
        self.capacity_pokes = Counter(
            "tpumounter_capacity_pokes_total",
            "Cross-shard capacity nudges by direction (sent/received)")
        self.capacity_pokes.inc(0.0, direction="sent")
        self.capacity_pokes.inc(0.0, direction="received")
        # The slice subsystem (master/slicetxn.py): every slice
        # transaction's terminal state by outcome, plus gang hand-backs.
        self.slice_txns = Counter(
            "tpumounter_slice_txns_total",
            "Slice transactions resolved, by outcome (commit/abort/"
            "adopted_commit/adopted_abort) plus gang hand-backs")
        for outcome in ("commit", "abort", "adopted_commit",
                        "adopted_abort", "handback"):
            self.slice_txns.inc(0.0, outcome=outcome)
        self.gang_queue_depth = Gauge(
            "tpumounter_gang_queue_depth",
            "Whole-slice attach requests parked as gang waiters")
        self.slice_txns_pending = Gauge(
            "tpumounter_slice_txns_pending",
            "Slice transactions currently in flight (fan-out running or "
            "gang-parked) on this replica")
        self.slice_txn_oldest_age = Gauge(
            "tpumounter_slice_txn_oldest_age",
            "Age in seconds of the oldest in-flight slice transaction "
            "(0 = none)")
        self.slice_txns_stranded = Gauge(
            "tpumounter_slice_txns_stranded",
            "Slice transaction intent records older than their deadline "
            "with no resolver driving them — a crashed fan-out nobody "
            "adopted; doctor CRITs on any")
        # The re-federation barrier: every transition crosses the one
        # _barrier_transition seam, paired with a slice_barrier event.
        self.slice_barriers = Counter(
            "tpumounter_slice_barriers_total",
            "Re-federation barrier transitions by kind (armed/join/"
            "complete/refused/superseded/rearmed)")
        for transition in ("armed", "join", "complete", "refused",
                           "superseded", "rearmed"):
            self.slice_barriers.inc(0.0, transition=transition)
        self.slice_barriers_incomplete = Gauge(
            "tpumounter_slice_barriers_incomplete",
            "Re-federation barriers with members joined < expected; one "
            "older than TPU_RESIZE_BARRIER_TIMEOUT_S is STUCK (doctor "
            "WARNs with the missing member names)")
        # Per-host attach round trip inside a slice fan-out (the slowest
        # host sets the transaction's wall time).
        self.slice_host_attach = Histogram(
            "tpumounter_slice_host_attach_seconds",
            "Per-host worker attach round-trip inside a slice fan-out "
            "(the max across hosts is the transaction's critical path)")
        self.slice_resize = Histogram(
            "tpumounter_slice_resize_seconds",
            "End-to-end /slice/resize latency (delta txn + generation "
            "bump)")
        # SLO engine (utils/slo.py): error-budget burn rate per tenant and
        # objective over each window ("5m"/"1h").
        self.slo_burn_rate = Gauge(
            "tpumounter_slo_burn_rate",
            "Error-budget burn rate by tenant, slo and window "
            "(1 = exactly consuming the budget; >=14.4 over 5m pages)")
        # Fleet aggregator (master/fleet.py): workers by scrape health,
        # and the utilization join (zero while no worker serves /utilz).
        self.fleet_nodes = Gauge(
            "tpumounter_fleet_nodes",
            "Workers known to the master's fleet aggregator, by state "
            "(fresh/stale)")
        # Node failure domain (master/nodehealth.py): the master's
        # judged health state per node — scrape staleness folded with
        # k8s Node conditions/taints through hysteresis. 0 healthy,
        # 1 draining (worker announced drain — cordoned, not dying),
        # 2 suspect (cordoned from NEW grants, live leases untouched),
        # 3 dead (leases fenced, slices repaired or torn down).
        self.node_health_state = Gauge(
            "tpumounter_node_health_state",
            "Node health as the master's failure-domain tracker judges "
            "it (0 healthy, 1 draining, 2 suspect, 3 dead)")
        # Lease fencing (master/admission.py fence_lease): one-way
        # evictions of leases whose worker cannot be reached — the
        # grant is revoked cluster-side (slave pods deleted, quota
        # freed) WITHOUT a worker detach; a zombie worker rejoining
        # converges its gate/journal against the now-empty ground truth.
        self.lease_fences = Counter(
            "tpumounter_lease_fences_total",
            "Leases fenced (evicted one-way, no worker detach) by "
            "reason (node-dead / reap-unreachable / slice-repair / "
            "slice-teardown)")
        self.lease_fences.inc(0.0, reason="node-dead")
        # Slice self-healing (master/slicetxn.py repair_group): repair
        # transactions by outcome. repaired = the gang re-formed on a
        # spare host under the SAME group lease; migrated = a draining
        # member was moved off proactively; torn_down = no capacity (or
        # budget exhausted) and the group was detached as a unit —
        # never left half-alive; failed = the repair itself errored or
        # a migration deferred.
        self.slice_repairs = Counter(
            "tpumounter_slice_repairs_total",
            "Slice self-healing repair transactions by outcome "
            "(repaired / migrated / torn_down / failed)")
        self.slice_repairs.inc(0.0, outcome="repaired")
        # Usage sampler (collector/usage.py): each GPU's latest sampled
        # duty cycle, from NVML's utilization or the open-fd fallback.
        self.chip_duty_cycle = Gauge(
            "tpumounter_chip_duty_cycle",
            "Most recent sampled duty cycle per chip (0 = idle, 1 = "
            "busy the whole sampling window), by chip id")
        self.lease_utilization = Gauge(
            "tpumounter_lease_utilization",
            "Mean observed duty cycle across a tenant's leased chips "
            "(0..1), from the fleet aggregator's /utilz scrapes")
        self.tenant_chips_idle = Gauge(
            "tpumounter_tenant_chips_idle",
            "Leased chips whose lease the broker marked idle (zero "
            "duty past TPU_IDLE_LEASE_S), by tenant — reclaimable "
            "capacity held against quota")
        # Fleet topology plane (master/topology.py): fragmentation score,
        # each node's largest schedulable free block, GPUs no valid group
        # can use (always 0 on GPU nodes, whose free GPUs form one
        # NVSwitch component), slice host adjacency, the cross-shard
        # tenant rollup and the defrag candidate report. All vanish under
        # TPU_TOPOLOGY=0.
        self.fleet_fragmentation_score = Gauge(
            "tpumounter_fleet_fragmentation_score",
            "Fleet-wide fragmentation: 1 - largest schedulable "
            "contiguous free block / total free chips (0 = unfragmented,"
            " approaching 1 = free capacity shattered)")
        self.node_free_contiguous_chips = Gauge(
            "tpumounter_node_free_contiguous_chips",
            "Largest schedulable contiguous free block on the node's "
            "mesh (chips), by node — the biggest aligned group the node "
            "can still grant")
        self.stranded_chips = Gauge(
            "tpumounter_stranded_chips",
            "Free chips fleet-wide sitting in mesh fragments too small "
            "or misaligned to form any valid ICI group — capacity no "
            "aligned grant can use until a defrag move frees it")
        self.slice_contiguity = Gauge(
            "tpumounter_slice_contiguity",
            "Whether the group's member hosts occupy adjacent positions "
            "in the fleet host order (1 = contiguous, 0 = scattered), "
            "by group — the NamedSharding row-major adjacency proxy")
        self.tenant_chips_in_use_global = Gauge(
            "tpumounter_tenant_chips_in_use_global",
            "Chips in use per tenant summed across every master shard "
            "(quotas remain per-shard; this is the report-only global "
            "rollup), by tenant")
        self.defrag_candidates = Counter(
            "tpumounter_defrag_candidates_total",
            "Defrag candidate reports: leases (idle-preferred) whose "
            "relocation would merge free blocks into a schedulable "
            "slice, by node — paired 1:1 with defrag_candidate events")
        self.defrag_candidates.inc(0.0, node="")
        # Fleet defragmenter (master/defrag.py): every plan and move
        # transition crosses its _note_move seam, paired 1:1 with the
        # defrag_plan / defrag_move events; the in-flight gauge is
        # bounded by TPU_DEFRAG_MAX_INFLIGHT.
        self.defrag_moves = Counter(
            "tpumounter_defrag_moves_total",
            "Defrag migration transitions by outcome (planned / migrated"
            " / deferred / aborted / budget_exhausted) — paired 1:1 with"
            " defrag_plan/defrag_move events")
        for outcome in ("planned", "migrated", "deferred", "aborted",
                        "budget_exhausted"):
            self.defrag_moves.inc(0.0, outcome=outcome)
        self.defrag_inflight = Gauge(
            "tpumounter_defrag_inflight",
            "Defrag migrations currently in flight (journaled and "
            "actuating; bounded by TPU_DEFRAG_MAX_INFLIGHT)")
        self.build_info = Gauge(
            "tpumounter_build_info",
            "Build identity of this binary (value is always 1; the "
            "version label carries the payload)")
        self.build_info.set(1, version=__version__)

    def families(self) -> list:
        """Every registered metric family, in registration order — the
        single source for rendering and for the naming-convention lint."""
        return [m for m in vars(self).values() if hasattr(m, "render")]

    # Content types the /metrics endpoints answer with: exemplars are
    # only legal in the OpenMetrics syntax, so the classic exposition
    # stays exemplar-free and a scraper opts in via its Accept header.
    TEXT_CONTENT_TYPE = "text/plain; version=0.0.4"
    OPENMETRICS_CONTENT_TYPE = \
        "application/openmetrics-text; version=1.0.0; charset=utf-8"

    def render_text(self, openmetrics: bool = False) -> str:
        """Classic Prometheus exposition by default; ``openmetrics=True``
        additionally carries the rid exemplars on histogram buckets and
        the ``# EOF`` terminator (served when the scraper's Accept header
        asks for application/openmetrics-text)."""
        lines: list[str] = []
        for metric in self.families():
            if openmetrics and isinstance(metric, (Histogram,
                                                   LabeledHistogram)):
                lines.extend(metric.render(exemplars=True))
            elif openmetrics and isinstance(metric, Counter):
                lines.extend(metric.render(openmetrics=True))
            else:
                lines.extend(metric.render())
        if openmetrics:
            lines.append("# EOF")
        return "\n".join(lines) + "\n"

    @classmethod
    def negotiate(cls, accept: str | None) -> tuple[bool, str]:
        """(openmetrics?, content type) from a request's Accept header."""
        if accept and "application/openmetrics-text" in accept:
            return True, cls.OPENMETRICS_CONTENT_TYPE
        return False, cls.TEXT_CONTENT_TYPE


REGISTRY = Registry()
