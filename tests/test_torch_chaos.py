"""The chaos invariant suite of tests/test_chaos.py, run through both
packages: under ANY fault plan, attaches either converge or roll back
cleanly — no leaked slave-pod reservations, no partial device grants, no
journal backlog, no double attach events.

Each case runs the same plan or crash through the control plane's
``ChaosRig`` and the port's, with the same expected answers: replay
outcome counts, result names and HTTP statuses by role (``norm_result``),
the faults that fired, event reasons by device (``TPUAttached`` /
``GPUAttached``), and each package's own ``assert_invariants``. Counters
are deltas of each package's own registry (registries are
process-global)."""

import json
import time
import urllib.request

import pytest

from tests.torch_control_plane import BOTH, IDS, TORCH, norm_result

RID = "chaos-rid-1"
N = 4


@pytest.fixture(params=BOTH, ids=IDS)
def pkg(request):
    return request.param


@pytest.fixture
def chaos_factory(pkg, tmp_path):
    rigs = []

    def make(plan=None, n_chips=N, **kwargs):
        chaos = pkg.mod("testing.chaos").ChaosRig(
            pkg.host(tmp_path / f"r{len(rigs)}"), n_chips=n_chips,
            plan=plan_for(pkg, plan) if isinstance(plan, tuple) else plan,
            **kwargs)
        rigs.append(chaos)
        return chaos

    yield make
    for chaos in rigs:
        chaos.close()


def plan_for(pkg, spec):
    """A ``(name, [fault kwargs...])`` spec as this package's FaultPlan."""
    chaos = pkg.mod("testing.chaos")
    name, faults = spec
    return chaos.FaultPlan(name, [chaos.Fault(**f) for f in faults])


def all_uuids(pkg, n=N) -> set[str]:
    return {pkg.uuid(i) for i in range(n)}


def reason(pkg, role: str) -> str:
    """``Attached`` -> ``TPUAttached`` / ``GPUAttached``."""
    return f"{pkg.dev.upper()}{role}"


def _attach(pkg, chaos, n=N, entire=True, rid=RID):
    return pkg.add(chaos.rig.service, "workload", "default", n, entire,
                   request_id=rid)


def _remove(pkg, chaos):
    return pkg.remove(chaos.rig.service, "workload", "default", [], False)


# -- the transient-fault matrix: every plan must CONVERGE ----------------------

TRANSIENT_PLANS = [
    ("connection_refused_on_create",
     [dict(op="POST", resource="pods", status=0, cause="refused", times=2)]),
    ("throttled_create_with_retry_after",
     [dict(op="POST", resource="pods", status=429, retry_after_s=0.02,
           times=2)]),
    ("apiserver_429_with_retry_after",
     [dict(op="LIST", resource="pods", status=429, retry_after_s=0.02,
           times=2)]),
    ("connection_refused_on_get",
     [dict(op="GET", resource="pods", status=0, cause="refused", times=2)]),
    ("injected_latency_on_get",
     [dict(op="GET", resource="pods", latency_s=0.05, times=3)]),
    ("watch_hang",
     [dict(op="WATCH", resource="pods", latency_s=0.3, times=1)]),
    ("watch_midstream_death",
     [dict(op="WATCH", resource="pods", status=0, cause="reset", times=2)]),
    ("kubelet_socket_flap",
     [dict(op="LIST", resource="podresources", kubelet=True, times=2)]),
    ("event_post_500s",
     [dict(op="POST", resource="events", status=500, times=4)]),
    ("mixed_storm",
     [dict(op="POST", resource="pods", status=0, cause="refused", times=1),
      dict(op="GET", resource="pods", status=0, cause="timeout", times=1),
      dict(op="LIST", resource="podresources", kubelet=True, times=1),
      dict(op="LIST", resource="pods", latency_s=0.02, times=2)]),
]


def _plan_id(spec):
    return spec[0]


@pytest.mark.parametrize("plan", TRANSIENT_PLANS, ids=_plan_id)
def test_attach_converges_under_transient_faults(pkg, chaos_factory, plan):
    # watch-focused plans need the pods to go Running AFTER the watch is
    # established, or the LIST-then-watch fast path never watches at all
    delay = 0.15 if plan[0].startswith("watch") else 0.0
    chaos = chaos_factory(plan, schedule_delay_s=delay)
    outcome = _attach(pkg, chaos)
    assert norm_result(outcome.result) == "SUCCESS"
    assert {c.uuid for c in outcome.chips} == all_uuids(pkg)
    pkg.mod("testing.chaos").assert_invariants(chaos.rig, all_uuids(pkg))
    assert chaos.injector.fired, "plan never bit — proves nothing"


def test_kubelet_faults_fire_against_the_fake_podresources(pkg,
                                                          chaos_factory):
    """The kubelet flap of the two plans that carry one is consulted by
    the fake PodResources client inside the retry layer, and every
    injected fault is spent."""
    for spec in (TRANSIENT_PLANS[7], TRANSIENT_PLANS[9]):
        chaos = chaos_factory(spec)
        assert chaos.rig.sim.podresources.faults is chaos.injector
        assert norm_result(_attach(pkg, chaos).result) == "SUCCESS"
        flaps = [f for f in chaos.injector.fired
                 if f[1] == "podresources"]
        assert flaps and all(f[2] == "kubelet-flap" for f in flaps)
        assert chaos.injector.remaining == 0, spec[0]


@pytest.mark.parametrize("plan", TRANSIENT_PLANS[:4] + TRANSIENT_PLANS[6:7],
                         ids=_plan_id)
def test_full_attach_detach_cycle_under_faults(pkg, chaos_factory, plan):
    """Detach runs under the same plan's remaining faults; the node ends
    empty with zero leaked state."""
    chaos = chaos_factory(plan)
    assert norm_result(_attach(pkg, chaos).result) == "SUCCESS"
    assert norm_result(_remove(pkg, chaos).result) == "SUCCESS"
    pkg.mod("testing.chaos").assert_invariants(chaos.rig, set(),
                                               max_attached_events=1)


def test_retries_are_observable(pkg, chaos_factory):
    registry = pkg.registry
    chaos = chaos_factory(("observable", [
        dict(op="POST", resource="pods", status=0, cause="refused",
             times=1)]))
    before = registry.retry_attempts.value(target="apiserver")
    assert norm_result(_attach(pkg, chaos).result) == "SUCCESS"
    assert registry.retry_attempts.value(target="apiserver") > before


# -- worker crash-restart at each actuation phase boundary ---------------------

CRASH_POINTS = ("before_actuate", "mid_actuate", "before_commit")


def test_crash_points_match_the_control_planes():
    assert tuple(p.mod("testing.chaos").CRASH_POINTS for p in BOTH) == (
        CRASH_POINTS, CRASH_POINTS)
    assert {p.mod("testing.chaos").DETACH_CRASH_POINTS for p in BOTH} == {
        ("mid_revoke", "mid_gate_sync")}


@pytest.mark.parametrize("point", CRASH_POINTS)
def test_worker_crash_then_replay_completes_attach(pkg, chaos_factory,
                                                   point):
    """Crash before/in the middle of/right after actuation: the journal
    intent survives, the restarted worker's replay COMPLETES the attach
    (owner alive, reservations intact), and exactly one logical attach is
    recorded."""
    mod = pkg.mod("testing.chaos")
    chaos = chaos_factory()
    chaos.arm_crash(point)
    with pytest.raises(mod.WorkerCrash):
        _attach(pkg, chaos)
    assert chaos.rig.journal.backlog() == 1     # intent survived
    assert chaos.restart_worker() == {"completed": 1}
    mod.assert_invariants(chaos.rig, all_uuids(pkg), max_attached_events=1)
    mod.wait_events_drained(chaos.rig.service)
    reasons = [e["reason"] for e in chaos.rig.sim.kube.events]
    assert reasons.count(reason(pkg, "Attached")) == 0   # crash beat it
    assert reasons.count(reason(pkg, "AttachResumed")) == 1
    # and the completed attach is fully functional: detach cleans up
    assert norm_result(_remove(pkg, chaos).result) == "SUCCESS"
    mod.assert_invariants(chaos.rig, set(), max_attached_events=0)


@pytest.mark.parametrize("point", CRASH_POINTS)
def test_crash_on_the_agent_and_procroot_path(tmp_path, point):
    """The port's crash points arm the actuator the mounter actually
    calls: on a rig whose mounter goes through the resident agent over
    the procroot actuator and the gate (the production wiring), each
    crash fires, and replay completes the attach into the container's
    /dev tree. (The control plane's ``mid_actuate`` patches
    ``create_device_node``, which its agent path never calls.)"""
    mod = TORCH.mod("testing.chaos")
    chaos = mod.ChaosRig(TORCH.host(tmp_path), n_chips=N,
                         actuator="procroot", agent=True, gate="fake")
    try:
        chaos.arm_crash(point)
        with pytest.raises(mod.WorkerCrash):
            _attach(TORCH, chaos, n=2, entire=False)
        assert chaos.restart_worker() == {"completed": 1,
                                          "gate_restored": 1}
        uuids = {TORCH.uuid(0), TORCH.uuid(1)}
        mod.assert_invariants(chaos.rig, uuids, max_attached_events=1)
        assert norm_result(_remove(TORCH, chaos).result) == "SUCCESS"
        mod.assert_invariants(chaos.rig, set(), max_attached_events=0)
    finally:
        chaos.close()


def test_worker_crash_then_owner_death_replay_reverts(pkg, chaos_factory):
    """Crash mid-attach AND the owner pod dies while the worker is down:
    replay must release the orphaned reservations instead of completing
    an attach into a dead pod."""
    mod = pkg.mod("testing.chaos")
    chaos = chaos_factory()
    chaos.arm_crash("before_commit")
    with pytest.raises(mod.WorkerCrash):
        _attach(pkg, chaos)
    # owner dies while the worker is "down"; its container (and every
    # device node in its mount namespace) dies with it
    chaos.rig.sim.kube.delete_pod("default", "workload")
    chaos.rig.actuator.created.clear()
    outcomes = chaos.restart_worker()
    assert outcomes in ({"noop": 1}, {"reverted": 1})
    assert chaos.rig.sim.slave_pods() == []     # reservations released
    assert chaos.rig.journal.backlog() == 0


def test_replay_is_idempotent_for_committed_attaches(pkg, chaos_factory):
    """A restart with a fully committed journal replays NOTHING — no
    duplicate actuation, no duplicate events."""
    chaos = chaos_factory()
    assert norm_result(_attach(pkg, chaos).result) == "SUCCESS"
    created_before = list(chaos.rig.actuator.created)
    assert chaos.restart_worker() == {}
    assert chaos.rig.actuator.created == created_before
    pkg.mod("testing.chaos").assert_invariants(chaos.rig, all_uuids(pkg))


# -- rollback itself interrupted by apiserver failure --------------------------

def test_interrupted_rollback_is_journaled_and_finished_by_replay(
        pkg, chaos_factory):
    """Actuation fails → rollback starts → the apiserver dies mid-revert
    (slave-pod deletes all fail). The leftover is journaled as
    revert_pending; the restarted worker's replay finishes the revert."""
    chaos = chaos_factory()
    chaos.rig.actuator.fail_on_create = True
    # deep burst: outlives the delete retries, so the rollback's
    # slave-pod deletes genuinely fail
    chaos.install(plan_for(pkg, ("apiserver_dies_mid_revert", [
        dict(op="DELETE", resource="pods", status=503, times=50)])))
    with pytest.raises(_mounter_error(pkg)):
        _attach(pkg, chaos)
    assert chaos.rig.journal.backlog() == 1
    assert chaos.rig.journal.incomplete()[0]["state"] == "revert_pending"
    assert len(chaos.rig.sim.slave_pods()) == 1   # the leftover
    # apiserver recovers; worker restarts
    chaos.rig.sim.kube.faults = None
    chaos.rig.actuator.fail_on_create = False
    assert chaos.restart_worker() == {"reverted": 1}
    assert chaos.rig.sim.slave_pods() == []
    pkg.mod("testing.chaos").assert_invariants(chaos.rig, set(),
                                               max_attached_events=0)


def _mounter_error(pkg):
    return pkg.errors.TPUMounterError


def test_clean_rollback_needs_no_replay(pkg, chaos_factory):
    """Contrast case: when the rollback completes in-process, the journal
    record is terminal and a restart replays nothing."""
    chaos = chaos_factory()
    chaos.rig.actuator.fail_on_create = True
    with pytest.raises(_mounter_error(pkg)):
        _attach(pkg, chaos)
    assert chaos.rig.journal.backlog() == 0
    assert chaos.restart_worker() == {}
    pkg.mod("testing.chaos").assert_invariants(chaos.rig, set(),
                                               max_attached_events=0)


# -- retry idempotency under faults (rid fencing + adoption) -------------------

def test_caller_retry_after_fault_burst_converges(pkg, chaos_factory):
    """A 503 burst DEEPER than the retry budget kills attempt 1 inside
    the allocation wait; the failure cleans up its slave pods, and the
    caller's retry with the same request id converges on exactly one
    reservation set — no double allocation, no leak."""
    # the fake client retries 4x per call; LIST #3 (the allocation
    # wait's seed LIST) eats all 4 failures and dies for real
    chaos = chaos_factory(("burst_outlives_retries", [
        dict(op="LIST", resource="pods", status=503, times=4, after=2)]))
    with pytest.raises(_mounter_error(pkg)):
        _attach(pkg, chaos)
    assert chaos.rig.sim.slave_pods() == []
    outcome = _attach(pkg, chaos)                  # same rid
    assert norm_result(outcome.result) == "SUCCESS"
    assert len(chaos.rig.sim.slave_pods()) == 1
    pkg.mod("testing.chaos").assert_invariants(chaos.rig, all_uuids(pkg))
    assert len(chaos.injector.fired) == 4


def test_ambiguous_create_failure_is_never_blindly_replayed(pkg,
                                                           chaos_factory):
    """A 503 on a slave-pod POST may mean the apiserver persisted the pod
    before failing: the non-idempotent classifier surfaces the failure
    (exactly ONE POST attempt), the attach rolls back cleanly, and the
    caller's request-id retry converges."""
    chaos = chaos_factory(("ambiguous_create_503", [
        dict(op="POST", resource="pods", status=503, times=1)]))
    with pytest.raises(_mounter_error(pkg)):
        _attach(pkg, chaos)
    assert len(chaos.injector.fired) == 1      # no blind POST replay
    assert chaos.rig.sim.slave_pods() == []    # clean rollback
    assert norm_result(_attach(pkg, chaos).result) == "SUCCESS"
    pkg.mod("testing.chaos").assert_invariants(chaos.rig, all_uuids(pkg))


# -- gateway: per-worker circuit breaker + 429 mapping -------------------------

def _gateway_with_flaky_worker(pkg, worker):
    """A MasterGateway whose worker-client factory returns ``worker``."""
    sim = pkg.mod("testing.sim")
    kube = pkg.mod("k8s.client").FakeKubeClient()
    kube.put_pod(sim.worker_pod("node-a", "10.0.0.5"))
    kube.put_pod(sim.make_target_pod())
    gateway = pkg.mod("master.gateway").MasterGateway(
        kube, pkg.mod("master.discovery").WorkerDirectory(kube),
        worker_client_factory=lambda target: worker)
    gateway.rpc_retry_policy = pkg.mod("utils.retry").RetryPolicy(
        max_attempts=2, base_delay_s=0.001, max_delay_s=0.001,
        deadline_s=5.0, jitter=0.0)
    gateway.breaker_failure_threshold = 2
    gateway.breaker_reset_timeout_s = 0.05
    return gateway


def _rpc_error(code_name: str, text: str):
    import grpc

    class Error(grpc.RpcError):
        def code(self):
            return getattr(grpc.StatusCode, code_name)

        def details(self):
            return text
    return Error


class _Worker:
    """Scriptable worker client of either package (``add_tpu`` and
    ``add_gpu``): raises ``error`` ``down`` times, then answers with
    ``result``."""

    def __init__(self, pkg, down, error=None, result=None):
        self.pkg = pkg
        self.down = down
        self.error = error or _rpc_error("UNAVAILABLE", "worker down")
        self.result = result
        self.calls = 0

    def add(self, *args, **kwargs):
        self.calls += 1
        if self.calls <= self.down:
            raise self.error()
        result = self.result
        if result is None:
            result = int(self.pkg.consts.AddResult.SUCCESS)
        dev = "nvidia" if self.pkg is TORCH else "accel"

        class Resp:
            device_ids = ["0"] if result == 0 else []
            device_paths = [f"/dev/{dev}0"] if result == 0 else []
        Resp.result = result
        return Resp()

    add_tpu = add_gpu = add

    def close(self):
        pass


ADD_PATH = "/addgpu/namespace/default/pod/workload/gpu/1/isEntireMount/false"


def test_gateway_breaker_opens_to_429_with_retry_after_then_recovers(pkg):
    worker = _Worker(pkg, down=10**9)
    gateway = _gateway_with_flaky_worker(pkg, worker)
    # request 1: two UNAVAILABLE attempts reach the threshold (2)
    status, payload = gateway.handle("GET", ADD_PATH)
    assert (status, payload["result"]) == (502, "UNAVAILABLE")
    # request 2: the breaker is open — fail fast, 429 + Retry-After
    status, payload = gateway.handle("GET", ADD_PATH)
    assert (status, payload["result"]) == (429, "WorkerCircuitOpen")
    assert payload["retry_after_s"] > 0
    calls_while_open = worker.calls
    status, _ = gateway.handle("GET", ADD_PATH)
    assert status == 429
    assert worker.calls == calls_while_open     # not dialed again
    # worker recovers; after the reset timeout the half-open probe closes
    worker.down = worker.calls
    time.sleep(0.06)
    status, payload = gateway.handle("GET", ADD_PATH)
    assert (status, payload["result"]) == (200, "SUCCESS")
    assert gateway.handle("GET", ADD_PATH)[0] == 200


def test_gateway_unavailable_retry_recovers_without_opening(pkg):
    worker = _Worker(pkg, down=1)
    gateway = _gateway_with_flaky_worker(pkg, worker)
    status, payload = gateway.handle("GET", ADD_PATH)
    assert (status, payload["result"]) == (200, "SUCCESS")
    assert worker.calls == 2


def test_gateway_hung_worker_opens_breaker(pkg):
    """DEADLINE_EXCEEDED counts as a breaker failure, or a hung-but-
    accepting worker starves the thread pool forever."""
    worker = _Worker(pkg, down=10**9, error=_rpc_error(
        "DEADLINE_EXCEEDED", "deadline exceeded"))
    gateway = _gateway_with_flaky_worker(pkg, worker)
    for _ in range(2):                   # threshold is 2
        status, payload = gateway.handle("GET", ADD_PATH)
        assert (status, payload["result"]) == (504, "DEADLINE_EXCEEDED")
    status, payload = gateway.handle("GET", ADD_PATH)
    assert (status, payload["result"]) == (429, "WorkerCircuitOpen")


def test_gateway_half_open_probe_survives_non_grpc_error(pkg):
    """A ValueError mid-probe (version-skewed worker enum) must not leak
    the half-open probe slot — the worker ANSWERED, so the circuit
    closes and traffic keeps flowing."""
    gateway = _gateway_with_flaky_worker(pkg, _Worker(pkg, down=10**9))
    gateway.handle("GET", ADD_PATH)              # opens the breaker
    assert gateway.handle("GET", ADD_PATH)[0] == 429
    skewed = _Worker(pkg, down=0, result=99)     # unknown enum value
    gateway._worker_client_factory = lambda target: skewed
    gateway._drop_client("10.0.0.5:1200")
    time.sleep(0.06)                             # past reset timeout
    for _ in range(2):       # the probe, then a closed circuit: no 429
        status, payload = gateway.handle("GET", ADD_PATH)
        assert (status, payload["result"]) == (502, "UnknownWorkerResult")
    assert skewed.calls == 2


def test_gateway_maps_resource_exhausted_to_429(pkg):
    worker = _Worker(pkg, down=10**9, error=_rpc_error(
        "RESOURCE_EXHAUSTED", "worker saturated"))
    gateway = _gateway_with_flaky_worker(pkg, worker)
    status, payload = gateway.handle("GET", ADD_PATH)
    assert (status, payload["result"]) == (429, "RESOURCE_EXHAUSTED")
    assert payload["retry_after_s"] > 0


# -- real REST client against the HTTP facade under drops ----------------------

def test_rest_client_rides_out_http_connection_drops(pkg, tmp_path):
    """The production REST client against the HTTP apiserver facade with
    injected TCP connection drops: the retry layer classifies the torn
    connections and converges."""
    chaos = pkg.mod("testing.chaos")
    facade = pkg.mod("testing.http_apiserver")
    client = pkg.mod("k8s.client")
    kube = client.FakeKubeClient()
    kube.put_pod(pkg.mod("testing.sim").make_target_pod())
    apiserver = facade.HttpApiserver(kube)
    try:
        apiserver.faults = chaos.FaultInjector([
            chaos.Fault(op="GET", resource="pods", drop=True, times=2)])
        cfg = facade.write_kubeconfig(str(tmp_path / "kubeconfig"),
                                      apiserver.base)
        rest = client.KubeconfigKubeClient(cfg)
        rest.retry_policy = pkg.mod("utils.retry").RetryPolicy(
            max_attempts=4, base_delay_s=0.01, max_delay_s=0.05,
            deadline_s=5.0, jitter=0.0)
        assert rest.get_pod("default", "workload")["metadata"]["name"] \
            == "workload"
        assert len(apiserver.faults.fired) == 2
    finally:
        apiserver.close()


def test_journalz_served_on_worker_health_port(pkg, chaos_factory):
    """GET /journalz alongside /poolz and /tracez: backlog + replay
    outcomes visible to operators."""
    main = pkg.mod("worker.main")
    chaos = chaos_factory()
    server = None
    try:
        chaos.arm_crash("before_commit")
        with pytest.raises(pkg.mod("testing.chaos").WorkerCrash):
            _attach(pkg, chaos)
        main._HealthHandler.journal = chaos.rig.journal
        server = main.start_health_server(0)
        url = f"http://127.0.0.1:{server.server_port}/journalz"
        with urllib.request.urlopen(url, timeout=5) as resp:
            payload = json.loads(resp.read())
        assert payload["backlog"] == 1
        assert payload["incomplete"][0]["pod"] == "workload"
        assert payload["incomplete"][0]["state"] == "intent"
        chaos.restart_worker()
        main._HealthHandler.journal = chaos.rig.journal
        with urllib.request.urlopen(url, timeout=5) as resp:
            payload = json.loads(resp.read())
        assert payload["backlog"] == 0
        assert payload["replays"]["completed"] >= 1
    finally:
        main._HealthHandler.journal = None
        if server is not None:
            server.shutdown()


def test_fault_free_path_adds_no_retries_or_extra_round_trips(
        pkg, chaos_factory):
    """With no faults injected, an attach performs ZERO retry attempts
    and O(1) kubelet round-trips — the retry layer only exists once a
    call has already failed."""
    registry = pkg.registry
    chaos = chaos_factory()
    targets = ("apiserver", "kubelet", "worker_rpc", "watch")
    before = {t: registry.retry_attempts.value(target=t) for t in targets}
    kubelet_lists = chaos.rig.sim.podresources.list_calls
    assert norm_result(_attach(pkg, chaos).result) == "SUCCESS"
    for target, value in before.items():
        assert registry.retry_attempts.value(target=target) == value, \
            f"fault-free attach burned a {target} retry"
    assert chaos.rig.sim.podresources.list_calls - kubelet_lists <= 3


# -- informer in the loop: the shared cache weakens no invariant ---------------

def test_informer_attach_converges_when_watch_dies_mid_attach(
        pkg, chaos_factory):
    """Kill the informer's ONE stream repeatedly mid-attach (beyond the
    client's resume budget, forcing re-LIST resyncs): the attach still
    converges with every invariant intact."""
    chaos = chaos_factory(("informer_watch_death", [
        dict(op="WATCH", resource="pods", drop=True, times=6)]),
        informer=True, schedule_delay_s=0.15)
    outcome = _attach(pkg, chaos)
    assert norm_result(outcome.result) == "SUCCESS"
    assert {c.uuid for c in outcome.chips} == all_uuids(pkg)
    pkg.mod("testing.chaos").assert_invariants(chaos.rig, all_uuids(pkg))
    assert chaos.injector.fired, "plan never bit — proves nothing"


def test_informer_attach_converges_when_watch_hangs(pkg, chaos_factory):
    chaos = chaos_factory(("informer_watch_hang", [
        dict(op="WATCH", resource="pods", latency_s=0.3, times=2)]),
        informer=True, schedule_delay_s=0.15)
    assert norm_result(_attach(pkg, chaos).result) == "SUCCESS"
    pkg.mod("testing.chaos").assert_invariants(chaos.rig, all_uuids(pkg))
    assert chaos.injector.fired


def test_warm_attach_survives_total_list_outage(pkg, chaos_factory):
    """With the informer + warm pool wired, an apiserver that 503s EVERY
    LIST cannot touch the warm attach path — zero LISTs are issued, so
    the outage plan never even fires."""
    chaos = chaos_factory(informer=True, warm_pool={"entire:4": 1})
    chaos.rig.fill_warm_pool()
    chaos.install(plan_for(pkg, ("lists_down", [
        dict(op="LIST", resource="pods", status=503, times=50)])))
    outcome = _attach(pkg, chaos)
    assert norm_result(outcome.result) == "SUCCESS"
    assert outcome.pool_hits == 1
    lists_fired = [f for f in chaos.injector.fired if f[0] == "LIST"]
    assert lists_fired == [], f"warm attach issued LISTs: {lists_fired}"
    chaos.rig.sim.kube.faults = None
    pkg.mod("testing.chaos").assert_invariants(chaos.rig, all_uuids(pkg))


def test_stale_cache_view_cannot_double_adopt(pkg, chaos_factory,
                                              monkeypatch):
    """Even when the pool's warm view is arbitrarily stale, the
    resourceVersion-guarded adoption patch loses cleanly (409) and the
    second attach falls back cold — two owners never share a slave
    pod."""
    chaos = chaos_factory(n_chips=8, informer=True,
                          warm_pool={"entire:4": 1})
    rig = chaos.rig
    rig.fill_warm_pool()
    stale_view = [dict(p, metadata=dict(p["metadata"]))
                  for p in rig.pool._list_warm()]
    assert norm_result(_attach(pkg, chaos, rid="owner-a").result) \
        == "SUCCESS"
    pod_b = pkg.mod("testing.sim").make_target_pod(
        name="workload-b", uid="uid-b", node=rig.sim.node)
    rig.sim.kube.put_pod(pod_b)
    rig.provision_container(pod_b)
    monkeypatch.setattr(rig.pool, "_list_warm", lambda: stale_view)
    out_b = pkg.add(rig.service, "workload-b", "default", 4, True,
                    request_id="owner-b")
    assert norm_result(out_b.result) == "SUCCESS"
    assert out_b.pool_hits == 0          # the stale claim lost its 409
    objects, consts = pkg.mod("k8s.objects"), pkg.consts
    owners: dict[str, set[str]] = {}
    for slave in rig.sim.slave_pods():
        owner = objects.labels(slave).get(consts.OWNER_POD_LABEL_KEY)
        owners.setdefault(owner, set()).add(objects.name(slave))
    assert set(owners) == {"workload", "workload-b"}
    assert not (owners["workload"] & owners["workload-b"])


def test_informer_crash_replay_still_converges(pkg, chaos_factory):
    """Crash-restart with the informer wired: the journal replay's reads
    go through the cache and the attach still completes exactly once."""
    mod = pkg.mod("testing.chaos")
    chaos = chaos_factory(informer=True)
    chaos.arm_crash("before_commit")
    with pytest.raises(mod.WorkerCrash):
        _attach(pkg, chaos)
    assert chaos.restart_worker() == {"completed": 1}
    mod.assert_invariants(chaos.rig, all_uuids(pkg), max_attached_events=1)
