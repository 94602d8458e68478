"""The port's runtime utilities against the control plane's: retry and
circuit breaking, per-request traces, the lifecycle event log, the flight
recorder and the metrics registry. Each scenario (taken from
tests/test_retry.py, test_trace.py, test_events.py, test_flight.py and
test_metrics_lint.py) runs once through ``gpumounter_tpu`` and once
through ``gpumounter_tpu_torch``; the two packages keep separate
registries, so counters are read as deltas."""

import importlib
import json
import os
import random
import re
import threading
import types

import pytest

import gpumounter_tpu
import gpumounter_tpu_torch

PACKAGES = {"jax": "gpumounter_tpu", "torch": "gpumounter_tpu_torch"}
MODULES = ("errors", "retry", "trace", "events", "flight", "metrics")


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    """One package's utils modules, by short name."""
    root = PACKAGES[request.param]
    ns = types.SimpleNamespace(name=request.param, root=root)
    for mod in MODULES:
        setattr(ns, mod, importlib.import_module(f"{root}.utils.{mod}"))
    return ns


class FakeClock:
    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t


def _fail_n_times(n, exc_factory, result="ok"):
    calls = {"n": 0}

    def fn():
        calls["n"] += 1
        if calls["n"] <= n:
            raise exc_factory()
        return result
    fn.calls = calls
    return fn


def _fast(pkg):
    return pkg.retry.RetryPolicy(max_attempts=4, base_delay_s=0.001,
                                 max_delay_s=0.002, deadline_s=5.0,
                                 jitter=0.0)


# -- retry: the classifier -------------------------------------------------------

CLASSIFIED = [
    (("K8sApiError", 429, "throttled"), True),
    (("K8sApiError", 500, "boom"), True),
    (("K8sApiError", 0, "refused", "refused"), True),
    (("K8sApiError", 404, "gone"), False),
    (("K8sApiError", 409, "conflict"), False),
    (("PodNotFoundError", "ns", "p"), False),
    (("KubeletUnavailableError", "socket flap"), True),
    (("MountPolicyError", "denied"), False),
    (("DeviceBusyError", "0", [42]), False),
]


@pytest.mark.parametrize("spec,expected", CLASSIFIED,
                         ids=lambda v: str(v[0]) if isinstance(v, tuple)
                         else str(v))
def test_retryable_classifier(pkg, spec, expected):
    exc = getattr(pkg.errors, spec[0])(*spec[1:])
    assert pkg.retry.retryable(exc) is expected


def test_non_idempotent_classifier_replays_only_unlanded(pkg):
    E = pkg.errors.K8sApiError
    classify = pkg.retry.retryable_non_idempotent
    assert classify(E(0, "refused", cause="refused"))
    assert classify(E(429, "throttled"))
    assert not classify(E(0, "timeout", cause="timeout"))
    assert not classify(E(503, "unavailable"))


def test_policy_delays_grow_and_cap(pkg):
    policy = pkg.retry.RetryPolicy(base_delay_s=0.1, max_delay_s=0.5,
                                   jitter=0.0)
    assert [policy.delay_s(n) for n in (1, 2, 3, 4, 10)] == \
        pytest.approx([0.1, 0.2, 0.4, 0.5, 0.5])


def test_policy_jitter_bounds(pkg):
    policy = pkg.retry.RetryPolicy(base_delay_s=1.0, max_delay_s=1.0,
                                   jitter=0.25)
    for _ in range(50):
        assert 0.75 <= policy.delay_s(1) <= 1.25


def test_call_with_retry_recovers_from_transient_burst(pkg):
    fn = _fail_n_times(2, lambda: pkg.errors.K8sApiError(500, "blip"))
    assert pkg.retry.call_with_retry(fn, policy=_fast(pkg),
                                     target="t") == "ok"
    assert fn.calls["n"] == 3


def test_call_with_retry_gives_up_and_never_retries_denials(pkg):
    fn = _fail_n_times(99, lambda: pkg.errors.K8sApiError(500, "down"))
    with pytest.raises(pkg.errors.K8sApiError):
        pkg.retry.call_with_retry(fn, policy=_fast(pkg), target="t")
    assert fn.calls["n"] == 4
    fn = _fail_n_times(99, lambda: pkg.errors.K8sApiError(404, "no pod"))
    with pytest.raises(pkg.errors.K8sApiError):
        pkg.retry.call_with_retry(fn, policy=_fast(pkg), target="t")
    assert fn.calls["n"] == 1


def test_call_with_retry_honors_retry_after_and_deadline(pkg):
    slept = []
    fn = _fail_n_times(1, lambda: pkg.errors.K8sApiError(
        429, "throttled", retry_after_s=0.123))
    pkg.retry.call_with_retry(fn, policy=_fast(pkg), target="t",
                              sleep=slept.append)
    assert slept == [0.123]
    fn = _fail_n_times(99, lambda: pkg.errors.K8sApiError(
        429, "throttled", retry_after_s=60.0))
    policy = pkg.retry.RetryPolicy(max_attempts=4, base_delay_s=0.001,
                                   deadline_s=0.05, jitter=0.0)
    with pytest.raises(pkg.errors.K8sApiError):
        pkg.retry.call_with_retry(fn, policy=policy, target="t")
    assert fn.calls["n"] == 1


def test_call_with_retry_counts_attempts_metric(pkg):
    reg = pkg.metrics.REGISTRY
    before = reg.retry_attempts.value(target="parity-unit")
    fn = _fail_n_times(2, lambda: pkg.errors.K8sApiError(500, "blip"))
    pkg.retry.call_with_retry(fn, policy=_fast(pkg), target="parity-unit")
    assert reg.retry_attempts.value(target="parity-unit") == before + 2


def test_retry_budget_exhaustion_turns_failures_terminal(pkg):
    budget = pkg.retry.RetryBudget(capacity=1.0, deposit_per_success=0.0)
    fn = _fail_n_times(99, lambda: pkg.errors.K8sApiError(500, "down"))
    with pytest.raises(pkg.errors.K8sApiError):
        pkg.retry.call_with_retry(fn, policy=_fast(pkg), target="t",
                                  budget=budget)
    assert fn.calls["n"] == 2
    budget = pkg.retry.RetryBudget(capacity=2.0, deposit_per_success=1.0)
    assert budget.try_spend() and budget.try_spend()
    assert not budget.try_spend()
    budget.deposit()
    assert budget.try_spend()


def test_breaker_opens_probes_once_and_closes(pkg):
    clock = FakeClock()
    breaker = pkg.retry.CircuitBreaker("parity-w1", failure_threshold=2,
                                       reset_timeout_s=10.0, clock=clock)
    for _ in range(2):
        breaker.allow()
        breaker.record_failure()
    with pytest.raises(pkg.errors.CircuitOpenError) as exc:
        breaker.allow()
    assert exc.value.target == "parity-w1"
    clock.t += 11.0
    breaker.allow()                           # the one probe
    with pytest.raises(pkg.errors.CircuitOpenError):
        breaker.allow()
    breaker.record_success()
    assert breaker.state == pkg.retry.CircuitBreaker.CLOSED


def test_breaker_exports_state_gauge(pkg):
    reg = pkg.metrics.REGISTRY
    clock = FakeClock()
    breaker = pkg.retry.CircuitBreaker("parity-gauge", failure_threshold=1,
                                       reset_timeout_s=10.0, clock=clock)
    assert reg.circuit_state.value(target="parity-gauge") == 0
    breaker.record_failure()
    assert reg.circuit_state.value(target="parity-gauge") == 2
    clock.t += 11.0
    breaker.allow()
    assert reg.circuit_state.value(target="parity-gauge") == 1
    breaker.record_success()
    assert reg.circuit_state.value(target="parity-gauge") == 0


def test_breaker_single_probe_under_contention(pkg):
    clock = FakeClock()
    breaker = pkg.retry.CircuitBreaker("parity-w2", failure_threshold=1,
                                       reset_timeout_s=1.0, clock=clock)
    breaker.record_failure()
    clock.t += 2.0
    admitted = []
    barrier = threading.Barrier(8)

    def contender():
        barrier.wait(timeout=10)
        try:
            breaker.allow()
            admitted.append(1)
        except pkg.errors.CircuitOpenError:
            pass
    threads = [threading.Thread(target=contender) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()
    assert len(admitted) == 1
    breaker.record_success()


def test_breaker_open_emits_event_once(pkg):
    events = pkg.events.EVENTS
    cursor = events.snapshot(limit=-1)["seq"]
    clock = FakeClock()
    breaker = pkg.retry.CircuitBreaker("parity-evt", failure_threshold=1,
                                       reset_timeout_s=1.0, clock=clock)
    breaker.record_failure()
    for _ in range(3):                        # failed probes: no re-announce
        clock.t += 2.0
        breaker.allow()
        breaker.record_failure()
    opened = [e for e in events.since(cursor)[0]
              if e["kind"] == "circuit_open"
              and e.get("attrs", {}).get("target") == "parity-evt"]
    assert len(opened) == 1
    breaker.record_success()


def test_port_jitter_follows_a_seeded_rng():
    """The port's jitter comes from the policy's ``random.Random``: one
    seed, one sequence."""
    from gpumounter_tpu_torch.utils.retry import RetryPolicy

    def delays(seed):
        policy = RetryPolicy(base_delay_s=1.0, max_delay_s=1.0, jitter=0.5,
                             rng=random.Random(seed))
        return [policy.delay_s(1) for _ in range(8)]
    assert delays(7) == delays(7)
    assert delays(7) != delays(8)
    assert all(0.5 <= d <= 1.5 for d in delays(7))


# -- trace -------------------------------------------------------------------------

def test_trace_collects_and_accumulates_spans(pkg):
    trace = pkg.trace.Trace("attach", "rid-1")
    for phase in ("allocate", "allocate", "actuate"):
        with trace.span(phase):
            pass
    assert set(trace.spans) == {"allocate", "actuate"}
    with pytest.raises(RuntimeError):
        with trace.span("rollback"):
            raise RuntimeError("boom")
    assert "rollback" in trace.spans


def test_trace_finish_feeds_labeled_histogram(pkg):
    hist = pkg.metrics.LabeledHistogram("t_seconds", "test")
    trace = pkg.trace.Trace("attach", "rid-2")
    with trace.span("policy"):
        pass
    trace.finish("SUCCESS", hist, store=pkg.trace.NO_STORE)
    assert hist.count(phase="policy") == 1
    assert hist.count(phase="allocate") == 0


def test_span_tree_nests_under_active_phase(pkg):
    t = pkg.trace
    trace = t.Trace("attach", "rid-tree")
    with trace.span("allocate"):
        with t.span("k8s.post", resource="pods"):
            with t.span("inner"):
                pass
    trace.finish("SUCCESS", store=t.NO_STORE)
    allocate = trace.root.children[0]
    assert allocate.children[0].name == "k8s.post"
    assert allocate.children[0].children[0].name == "inner"
    assert set(trace.spans) == {"allocate"}
    assert t.current_span() is None
    with t.span("orphan") as got:
        assert got is None


def test_k8s_call_records_span_and_latency(pkg):
    reg = pkg.metrics.REGISTRY
    before = reg.k8s_latency.count(verb="LIST", resource="parity")
    errors = reg.k8s_errors.value(verb="LIST", resource="parity")
    trace = pkg.trace.Trace("attach", "rid-k8s")
    with trace.span("resolve"):
        with pkg.trace.k8s_call("LIST", "parity"):
            pass
        with pytest.raises(KeyError):
            with pkg.trace.k8s_call("LIST", "parity"):
                raise KeyError("x")
    names = [c.name for c in trace.root.children[0].children]
    assert names == ["k8s.list", "k8s.list"]
    assert reg.k8s_latency.count(verb="LIST", resource="parity") \
        == before + 2
    assert reg.k8s_errors.value(verb="LIST", resource="parity") \
        == errors + 1


def test_trace_store_ring_is_bounded_and_keeps_slowest(pkg):
    store = pkg.trace.TraceStore(recent_max=5, slowest_max=2)
    slow = pkg.trace.Trace("attach", "rid-slow")
    slow._t0 -= 10.0
    slow.finish("SUCCESS", store=store)
    for i in range(20):
        pkg.trace.Trace("attach", f"rid-{i}").finish("SUCCESS", store=store)
    assert len(store.recent(limit=100)) == 5
    assert store.find("rid-slow") == []
    assert store.slowest()[0]["rid"] == "rid-slow"


def test_trace_store_filters(pkg):
    store = pkg.trace.TraceStore()
    pkg.trace.Trace("attach", "rid-a").finish("SUCCESS", store=store)
    pkg.trace.Trace("detach", "rid-a").finish("EXCEPTION", store=store)
    assert [t["op"] for t in store.recent(rid="rid-a")] == \
        ["detach", "attach"]
    snap = store.snapshot(rid="rid-a", result="SUCCESS")
    assert [t["op"] for t in snap["recent"]] == ["attach"]


# -- events --------------------------------------------------------------------

def test_emit_assigns_consecutive_seqs_and_fields(pkg):
    log = pkg.events.EventLog(ring_size=16)
    s1 = log.emit("attach", rid="r1", namespace="default", pod="w",
                  chips=4, result="SUCCESS")
    s2 = log.emit("detach", rid="r2")
    events, latest, dropped = log.since(0)
    assert (s2, latest, dropped) == (s1 + 1, s2, 0)
    first = events[0]
    assert (first["rid"], first["pod"], first["chips"]) == ("r1", "w", 4)
    assert first["attrs"] == {"result": "SUCCESS"}
    assert "tenant" not in first and "node" not in first


def test_ring_rotation_reports_dropped_count(pkg):
    log = pkg.events.EventLog(ring_size=16)
    seqs = [log.emit(f"k{i}") for i in range(40)]
    events, latest, dropped = log.since(0)
    assert (len(events), latest, dropped) == (16, seqs[-1], seqs[-1] - 16)
    events, _, dropped = log.since(seqs[-1] - 5)
    assert len(events) == 5 and dropped == 0


def test_since_limit_pages_oldest_first(pkg):
    log = pkg.events.EventLog(ring_size=64)
    seqs = [log.emit(f"k{i}") for i in range(10)]
    page, latest, _ = log.since(0, limit=4)
    assert [e["seq"] for e in page] == seqs[:4]
    page = log.snapshot(since=0, limit=4)
    assert page["truncated"] and page["seq"] == seqs[3]
    page = log.snapshot(since=seqs[0], limit=0)
    assert page["events"] == [] and page["seq"] == seqs[0]


def test_disabled_log_emits_nothing(pkg):
    log = pkg.events.EventLog(enabled=False)
    assert log.emit("attach", rid="r") == 0
    assert log.snapshot()["events"] == []


def test_jsonl_sidecar_appends_every_event(pkg, tmp_path):
    path = tmp_path / "events" / "log.jsonl"
    log = pkg.events.EventLog(path=str(path))
    log.emit("attach", rid="r1")
    log.emit("detach", rid="r2")
    log.flush()
    lines = [json.loads(line) for line in
             path.read_text().strip().splitlines()]
    assert [e["kind"] for e in lines] == ["attach", "detach"]
    log.path = None                          # writer thread exits


def test_emit_feeds_the_event_counter(pkg):
    reg = pkg.metrics.REGISTRY
    before = reg.events_emitted.value(kind="parity_kind")
    pkg.events.EVENTS.emit("parity_kind")
    assert reg.events_emitted.value(kind="parity_kind") == before + 1


# -- flight recorder -------------------------------------------------------------

def test_flight_single_trigger_dumps_on_first_note(pkg, tmp_path):
    rec = pkg.flight.FlightRecorder(str(tmp_path), min_interval_s=300.0,
                                    settle_s=0.0, clock=FakeClock())
    bundle_id = rec.note("journal_backlog", rid="r1", backlog=2)
    bundle = pkg.flight.FlightRecorder.load(str(tmp_path), bundle_id)
    assert (bundle["trigger"], bundle["rid"], bundle["context"]) == (
        "journal_backlog", "r1", {"backlog": 2})
    assert not [n for n in os.listdir(tmp_path) if n.endswith(".tmp")]
    assert pkg.flight.FlightRecorder(None).note("circuit_open") is None


def test_flight_bursts_and_rate_limit(pkg, tmp_path):
    clock = FakeClock()
    rec = pkg.flight.FlightRecorder(str(tmp_path), min_interval_s=300.0,
                                    settle_s=0.0, clock=clock)
    for _ in range(pkg.flight.FALLBACK_BURST - 1):
        assert rec.note("agent_fallback") is None
    before = pkg.metrics.REGISTRY.flight_suppressed.value()
    assert rec.note("agent_fallback") is not None
    assert rec.note("journal_backlog", rid="r2") is None     # suppressed
    assert pkg.metrics.REGISTRY.flight_suppressed.value() == before + 1
    clock.t += 301.0
    assert rec.note("journal_backlog", rid="r2") is not None
    assert len(pkg.flight.FlightRecorder.list_bundles(str(tmp_path))) == 2


def test_flight_failed_write_releases_the_slot(pkg, tmp_path):
    blocker = tmp_path / "not-a-dir"
    blocker.write_text("")
    rec = pkg.flight.FlightRecorder(str(blocker), min_interval_s=300.0,
                                    settle_s=0.0, clock=FakeClock())
    assert rec.note("circuit_open", target="w1") is None
    rec.dir = str(tmp_path / "flight")
    assert rec.note("journal_backlog", rid="r1") is not None


def test_flight_raising_provider_degrades(pkg, tmp_path):
    rec = pkg.flight.FlightRecorder(str(tmp_path), min_interval_s=0.0,
                                    settle_s=0.0, clock=FakeClock())
    rec.register_provider("broken", lambda: 1 / 0)
    rec.register_provider("fine", lambda: {"ok": True})
    bundle = pkg.flight.FlightRecorder.load(
        str(tmp_path), rec.note("circuit_open"))
    assert bundle["fine"] == {"ok": True}
    assert "ZeroDivisionError" in bundle["broken"]["error"]


def test_flight_restart_keeps_previous_bundles(pkg, tmp_path):
    first = pkg.flight.FlightRecorder(str(tmp_path), min_interval_s=0.0,
                                      settle_s=0.0, clock=FakeClock())
    assert first.note("journal_backlog", rid="boot1") == \
        "flight-0001-journal_backlog"
    reborn = pkg.flight.FlightRecorder(str(tmp_path), min_interval_s=0.0,
                                       settle_s=0.0, clock=FakeClock())
    assert reborn.note("journal_backlog", rid="boot2") == \
        "flight-0002-journal_backlog"
    assert [b["rid"] for b in pkg.flight.FlightRecorder.list_bundles(
        str(tmp_path))] == ["boot2", "boot1"]


# -- metrics -------------------------------------------------------------------

NAME_RE = re.compile(r"^tpumounter_[a-z0-9_]+$")
GAUGE_FORBIDDEN_SUFFIXES = ("_total", "_seconds", "_count", "_sum")


def test_every_family_matches_naming_convention(pkg):
    m = pkg.metrics
    families = m.Registry().families()
    assert len(families) >= 12
    for fam in families:
        assert NAME_RE.match(fam.name), fam.name
        if isinstance(fam, m.Counter):
            assert fam.name.endswith("_total"), fam.name
        elif isinstance(fam, (m.Histogram, m.LabeledHistogram)):
            assert fam.name.endswith("_seconds"), fam.name
        elif isinstance(fam, m.Gauge):
            assert not fam.name.endswith(GAUGE_FORBIDDEN_SUFFIXES), fam.name
        else:
            raise AssertionError(f"unknown family type {type(fam)}")
        rendered = list(fam.render())
        assert rendered[0] == f"# HELP {fam.name} {fam.help}"
        assert rendered[1].startswith(f"# TYPE {fam.name} ")


def test_build_info_identifies_the_package(pkg):
    version = {"jax": gpumounter_tpu.__version__,
               "torch": gpumounter_tpu_torch.__version__}[pkg.name]
    reg = pkg.metrics.Registry()
    assert reg.build_info.value(version=version) == 1.0
    assert f'tpumounter_build_info{{version="{version}"}} 1' in \
        reg.render_text()


def test_exposition_round_trips_and_negotiates(pkg):
    m = pkg.metrics
    reg = m.Registry()
    reg.flight_dumps.inc(trigger="circuit_open")
    parsed = m.parse_exposition(reg.render_text())
    assert parsed["tpumounter_flight_dumps_total"][
        (("trigger", "circuit_open"),)] == 1.0
    assert m.Registry.negotiate("application/openmetrics-text")[0]
    assert reg.render_text(openmetrics=True).endswith("# EOF\n")


def test_port_families_are_the_control_planes():
    """Every family the port registers exists in the control plane's
    registry under the same name, type and help text (the shipped
    dashboards select on them)."""
    from gpumounter_tpu.utils.metrics import Registry as JaxRegistry
    from gpumounter_tpu_torch.utils.metrics import Registry
    jax = {f.name: f for f in JaxRegistry().families()}
    for fam in Registry().families():
        assert fam.name in jax, fam.name
        assert type(fam).__name__ == type(jax[fam.name]).__name__
        if fam.name != "tpumounter_build_info":
            assert fam.help == jax[fam.name].help, fam.name


def test_the_worker_families_are_registered():
    """What the worker's modules record into: attach and detach, their
    phases, the journal, the informer and its cache, the reconciler, the
    resident agent and the parking executor, with the pre-seeded series
    the control plane seeds."""
    from gpumounter_tpu_torch.utils.metrics import Registry
    reg = Registry()
    names = {f.name for f in reg.families()}
    assert {
        "tpumounter_attach_seconds", "tpumounter_detach_seconds",
        "tpumounter_attach_total", "tpumounter_detach_total",
        "tpumounter_attach_phase_seconds",
        "tpumounter_detach_phase_seconds",
        "tpumounter_orphans_reclaimed_total",
        "tpumounter_journal_replays_total",
        "tpumounter_informer_events_total",
        "tpumounter_informer_watch_restarts_total",
        "tpumounter_cache_hits_total", "tpumounter_cache_misses_total",
        "tpumounter_actuation_agent_batches_total",
        "tpumounter_actuation_agent_ops_total",
        "tpumounter_actuation_agent_fallbacks_total",
        "tpumounter_actuation_agent_revalidations_total",
        "tpumounter_actuation_agent_ns_fds",
        "tpumounter_worker_rpc_parked"} <= names
    text = reg.render_text()
    for seeded in ("tpumounter_orphans_reclaimed_total 0",
                   "tpumounter_informer_watch_restarts_total 0",
                   'tpumounter_actuation_agent_fallbacks_total'
                   '{reason="stale_ns_fd"} 0'):
        assert seeded in text.splitlines(), seeded


def test_the_slice_families_are_registered():
    """What the slice subsystem records into (master/slice.py,
    slicetxn.py, the broker's gang gauge), under the control plane's
    names, types and help texts, with its pre-seeded series."""
    from gpumounter_tpu.utils.metrics import Registry as JaxRegistry
    from gpumounter_tpu_torch.utils.metrics import Registry
    slice_families = {
        "tpumounter_slice_txns_total", "tpumounter_gang_queue_depth",
        "tpumounter_slice_txns_pending", "tpumounter_slice_txn_oldest_age",
        "tpumounter_slice_txns_stranded",
        "tpumounter_slice_barriers_total",
        "tpumounter_slice_barriers_incomplete",
        "tpumounter_slice_host_attach_seconds",
        "tpumounter_slice_resize_seconds"}
    port = {f.name: f for f in Registry().families()}
    jax = {f.name: f for f in JaxRegistry().families()}
    assert slice_families <= set(port)
    for name in slice_families:
        assert type(port[name]).__name__ == type(jax[name]).__name__, name
        assert port[name].help == jax[name].help, name
    text = Registry().render_text().splitlines()
    for outcome in ("commit", "abort", "adopted_commit", "adopted_abort",
                    "handback"):
        assert f'tpumounter_slice_txns_total{{outcome="{outcome}"}} 0' \
            in text, outcome
    for transition in ("armed", "join", "complete", "refused",
                       "superseded", "rearmed"):
        assert ("tpumounter_slice_barriers_total"
                f'{{transition="{transition}"}} 0') in text, transition


def test_the_node_health_families_are_registered():
    """What the node failure domain records into (master/nodehealth.py,
    the broker's fence_lease, slice self-healing), under the control
    plane's names, types and help texts, with its pre-seeded series."""
    from gpumounter_tpu.utils.metrics import Registry as JaxRegistry
    from gpumounter_tpu_torch.utils.metrics import Registry
    families = {"tpumounter_node_health_state",
                "tpumounter_lease_fences_total",
                "tpumounter_slice_repairs_total"}
    port = {f.name: f for f in Registry().families()}
    jax = {f.name: f for f in JaxRegistry().families()}
    assert families <= set(port)
    for name in families:
        assert type(port[name]).__name__ == type(jax[name]).__name__, name
        assert port[name].help == jax[name].help, name
    text = Registry().render_text().splitlines()
    assert 'tpumounter_lease_fences_total{reason="node-dead"} 0' in text
    assert 'tpumounter_slice_repairs_total{outcome="repaired"} 0' in text


def test_the_two_packages_keep_separate_registries():
    from gpumounter_tpu.utils.events import EVENTS as JAX_EVENTS
    from gpumounter_tpu.utils.flight import RECORDER as JAX_RECORDER
    from gpumounter_tpu.utils.metrics import REGISTRY as JAX_REGISTRY
    from gpumounter_tpu_torch.utils.events import EVENTS
    from gpumounter_tpu_torch.utils.flight import RECORDER
    from gpumounter_tpu_torch.utils.metrics import REGISTRY
    assert REGISTRY is not JAX_REGISTRY
    assert EVENTS is not JAX_EVENTS and RECORDER is not JAX_RECORDER
    jax_before = JAX_REGISTRY.events_emitted.value(kind="port_only")
    EVENTS.emit("port_only")
    assert JAX_REGISTRY.events_emitted.value(kind="port_only") == jax_before
