"""The parking executor and the worker's gRPC server in parking mode,
through both packages (the counterpart of tests/test_worker_parking.py):
the active budget, parked waits releasing their slot, re-entrancy, the
unpark queueing for a slot, slow attaches overlapping beyond the budget,
the drain and the per-request idempotency on the parking server, the
thread pool as the default, and the gRPC knobs from the rigs and the
environment."""

import threading
import time

import grpc
import pytest

from tests.torch_control_plane import BOTH, IDS, norm_result


@pytest.fixture(params=BOTH, ids=IDS)
def pkg(request):
    return request.param


@pytest.fixture
def parking(pkg):
    return pkg.mod("utils.parking")


def test_active_budget_bounds_running_threads(parking):
    ex = parking.ParkingExecutor(max_active=2)
    running, peak, lock = [], [0], threading.Lock()

    def task():
        with lock:
            running.append(1)
            peak[0] = max(peak[0], len(running))
        time.sleep(0.05)
        with lock:
            running.pop()
    for f in [ex.submit(task) for _ in range(8)]:
        f.result(timeout=10)
    assert peak[0] <= 2 and ex.status()["peak_active"] <= 2
    ex.shutdown()


def test_parked_waits_release_their_slot(parking):
    ex = parking.ParkingExecutor(max_active=2)
    release = threading.Event()

    def task():
        with parking.parked("test-wait"):
            release.wait(timeout=30)
        return "done"
    futures = [ex.submit(task) for _ in range(16)]
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and ex.status()["parked"] < 16:
        time.sleep(0.005)
    status = ex.status()
    assert (status["parked"], status["active"]) == (16, 0), status
    release.set()
    assert [f.result(timeout=10) for f in futures] == ["done"] * 16
    assert ex.status()["peak_parked"] == 16
    ex.shutdown()


def test_parked_is_reentrant_and_noop_off_executor(parking):
    with parking.parked("outer"):
        with parking.parked("inner"):
            pass
    ex = parking.ParkingExecutor(max_active=1)
    depths = {}

    def task():
        with parking.parked("outer"):
            depths["outer"] = ex.status()["parked"]
            with parking.parked("inner"):
                depths["inner"] = ex.status()["parked"]
        return True
    assert ex.submit(task).result(timeout=10)
    assert depths == {"outer": 1, "inner": 1}   # released exactly once
    ex.shutdown()


def test_unpark_reacquires_within_the_budget(parking):
    ex = parking.ParkingExecutor(max_active=1)
    gate, order = threading.Event(), []

    def parker():
        with parking.parked("w"):
            gate.wait(timeout=30)
        order.append("parker-resumed")

    def runner():
        order.append("runner-ran")
        gate.set()
        time.sleep(0.05)            # holds the one slot while gate is set
    f1 = ex.submit(parker)
    while ex.status()["parked"] < 1:
        time.sleep(0.005)
    f2 = ex.submit(runner)
    f1.result(timeout=10)
    f2.result(timeout=10)
    assert order == ["runner-ran", "parker-resumed"]
    ex.shutdown()


@pytest.fixture
def parking_stack(pkg, tmp_path):
    """A live gRPC worker in parking mode with an active budget of 2, over
    a kubelet that lags device assignment."""
    grpc_server = pkg.mod("worker.grpc_server")
    rig = pkg.rig(tmp_path, n_chips=8, kubelet_lag_s=0.6, informer=True)
    server, port = grpc_server.build_server(
        rig.service, port=0, address="127.0.0.1", max_workers=2,
        mode="parking")
    server.start()
    client = grpc_server.WorkerClient(f"127.0.0.1:{port}", timeout_s=60)
    try:
        yield rig, server, client, port
    finally:
        client.close()
        server.stop(grace=0)
        rig.close()


def _attach_from_threads(pkg, port, calls):
    results = {}

    def one(key, pod, n, entire, rid):
        with pkg.mod("worker.grpc_server").WorkerClient(
                f"127.0.0.1:{port}", timeout_s=60) as c:
            results[key] = pkg.call(c, "add_{dev}", pod, "default", n,
                                    entire, request_id=rid)
    threads = [threading.Thread(target=one, args=call) for call in calls]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    return results


def test_concurrent_slow_attaches_overlap_beyond_the_budget(pkg,
                                                            parking_stack):
    rig, server, _, port = parking_stack
    pods = []
    for i in range(6):
        rig.provision_container(rig.sim.add_target_pod(name=f"load-{i}",
                                                       uid=f"uid-l{i}"))
        pods.append(f"load-{i}")
    t0 = time.monotonic()
    results = _attach_from_threads(
        pkg, port, [(p, p, 1, False, f"rid-{p}") for p in pods])
    wall = time.monotonic() - t0
    assert len(results) == 6
    add_result = pkg.consts.AddResult
    assert {norm_result(add_result(r.result))
            for r in results.values()} == {"SUCCESS"}
    assert wall < 1.7, f"parking attaches serialised: {wall:.2f}s"
    assert server.parking_executor.peak_parked >= 3, \
        server.parking_executor.status()


def test_drain_tokens_survive_the_parking_restructure(pkg, parking_stack):
    rig, _, client, _port = parking_stack
    drain = pkg.mod("worker.drain").DrainController(rig.sim.node)
    rig.service.drain = drain
    drain.begin("test")
    with pytest.raises(grpc.RpcError) as err:
        pkg.call(client, "add_{dev}", "workload", "default", 1, False,
                 request_id="rid-drained")
    assert err.value.code() == grpc.StatusCode.UNAVAILABLE
    assert err.value.details().startswith(
        pkg.consts.DRAINING_DETAIL_PREFIX)
    assert (drain.status()["refused"], drain.status()["inflight"]) == (1, 0)


def test_per_rid_idempotency_survives_the_parking_restructure(
        pkg, parking_stack):
    rig, _, _, port = parking_stack
    results = _attach_from_threads(
        pkg, port, [(i, "workload", 2, True, "rid-same") for i in range(2)])
    ids = [sorted(r.device_ids) for r in results.values()]
    assert len(ids) == 2 and ids[0] == ids[1] and len(ids[0]) == 2, ids
    assert len(rig.sim.slave_pods()) == 1


def test_threadpool_remains_the_default_off_path(pkg, tmp_path):
    grpc_server = pkg.mod("worker.grpc_server")
    rig = pkg.rig(tmp_path)
    try:
        server, _ = grpc_server.build_server(rig.service, port=0,
                                             address="127.0.0.1")
        assert server.parking_executor is None
        server.stop(grace=0)
        with pytest.raises(ValueError):
            grpc_server.build_server(rig.service, port=0, mode="warp")
    finally:
        rig.close()


def test_grpc_knobs_plumb_through_the_rigs(pkg, tmp_path):
    rig = pkg.rig(tmp_path, grpc_workers=3, grpc_async=True)
    assert (rig.sim.settings.grpc_workers, rig.sim.settings.grpc_async) \
        == (3, True)
    stack = pkg.mod("testing.sim").LiveStack(rig, grpc_workers=None,
                                             grpc_mode="settings")
    try:
        executor = stack.grpc_server.parking_executor
        assert executor is not None and executor.max_active == 3
    finally:
        stack.close()


def test_grpc_knobs_plumb_from_env(pkg):
    settings = pkg.mod("utils.config").Settings
    default = pkg.consts.DEFAULT_GRPC_WORKERS
    assert (settings().grpc_async, settings().grpc_workers) == (False,
                                                                default)
    env = settings.from_env({})
    assert (env.grpc_async, env.grpc_workers) == (True, default)
    off = settings.from_env({"TPU_GRPC_ASYNC": "0",
                             "TPU_GRPC_WORKERS": "32"})
    assert (off.grpc_async, off.grpc_workers) == (False, 32)
    with pytest.raises(ValueError):
        settings.from_env({"TPU_GRPC_WORKERS": "0"})
    with pytest.raises(ValueError):
        settings.from_env({"TPU_GRPC_WORKERS": "64",
                           "TPU_GRPC_MAX_PARKED": "8"})
