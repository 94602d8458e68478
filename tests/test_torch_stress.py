"""Concurrency storms over the live gRPC worker, through both packages (the
counterpart of tests/test_stress.py): many pods mutating one node's
devices in parallel, exact accounting under contention, and a soak that
returns the process to its baseline.

The soak keeps the control plane's thresholds (fds +3, threads +2, empty
lock tables, a drained event queue). Its warm-up also fills the gRPC
server's thread pool to its bound: ``ThreadPoolExecutor`` starts a thread
for a submitted RPC whenever no idle one has re-armed its semaphore yet,
so under CPU load the pool grows lazily towards ``max_workers`` (8)
whatever the cycle count. Those threads are bounded, not leaked; a
baseline taken before the pool is full counts them as growth. The thread
names that did grow are in the assertion's message."""

import os
import threading
import time

import pytest

from tests.torch_control_plane import BOTH, IDS, JAX, TORCH, norm_result

GRPC_WORKERS = 8


@pytest.fixture(params=BOTH, ids=IDS)
def pkg(request):
    return request.param


@pytest.fixture
def grpc_rig(pkg, tmp_path):
    grpc_server = pkg.mod("worker.grpc_server")
    rig = pkg.rig(tmp_path, n_chips=8)
    server, port = grpc_server.build_server(
        rig.service, port=0, address="127.0.0.1", max_workers=GRPC_WORKERS)
    server.start()
    client = grpc_server.WorkerClient(f"127.0.0.1:{port}")
    yield rig, client
    client.close()
    server.stop(grace=0)
    rig.close()


def _add_pods(rig, names):
    for name in names:
        rig.provision_container(rig.sim.add_target_pod(name=name))


def _in_parallel(fn, names, timeout_s):
    threads = [threading.Thread(target=fn, args=(n,)) for n in names]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout_s)


def test_parallel_attach_detach_isolation(pkg, grpc_rig):
    """4 pods x 2 devices in parallel on an 8-device node: all succeed,
    the sets are disjoint, and a parallel detach frees the node."""
    rig, client = grpc_rig
    pods = [f"pod-{i}" for i in range(4)]
    _add_pods(rig, pods)
    results: dict[str, object] = {}

    def attach(name):
        results[name] = pkg.call(client, "add_{dev}", name, "default", 2,
                                 is_entire_mount=True,
                                 request_id=f"rid-{name}")
    _in_parallel(attach, pods, 30)
    assert all(r.result == 0 for r in results.values()), results
    all_ids = [i for r in results.values() for i in r.device_ids]
    assert len(all_ids) == 8 and len(set(all_ids)) == 8
    assert len(rig.sim.slave_pods()) == 4

    def detach(name):
        results[name] = pkg.call(client, "remove_{dev}", name, "default",
                                 list(results[name].device_ids),
                                 force=False)
    _in_parallel(detach, pods, 30)
    assert all(r.result == 0 for r in results.values())
    assert rig.sim.slave_pods() == []
    rig.sim.collector.update_status()
    free = pkg.mod("device.model").DeviceState.FREE
    assert all(c.state is free for c in rig.sim.collector.chips)


def _contention(pkg, rig, client) -> dict:
    pods = [f"racer-{i}" for i in range(8)]
    _add_pods(rig, pods)
    results: dict[str, object] = {}

    def attach(name):
        results[name] = pkg.call(client, "add_{dev}", name, "default", 2,
                                 is_entire_mount=True,
                                 request_id=f"rid-{name}")
    _in_parallel(attach, pods, 60)
    add_result = pkg.consts.AddResult
    by_result: dict[str, list[str]] = {}
    for name, r in sorted(results.items()):
        by_result.setdefault(norm_result(add_result(r.result)),
                             []).append(name)
    winners = by_result.get("SUCCESS", [])
    won_ids = [i for n in winners for i in results[n].device_ids]
    owners = {p["metadata"]["labels"][pkg.consts.OWNER_POD_LABEL_KEY]
              for p in rig.sim.slave_pods()}
    return {"counts": {k: len(v) for k, v in by_result.items()},
            "distinct_ids": len(set(won_ids)), "ids": len(won_ids),
            "slaves_are_winners": owners == set(winners)}


def test_contention_exact_accounting(pkg, grpc_rig):
    """8 pods race for 2 devices each on an 8-device node: exactly 4 win,
    the losers get the insufficient answer and leak nothing."""
    rig, client = grpc_rig
    out = _contention(pkg, rig, client)
    assert out == {"counts": {"SUCCESS": 4, "INSUFFICIENT": 4},
                   "distinct_ids": 8, "ids": 8, "slaves_are_winners": True}
    assert len(rig.sim.slave_pods()) == 4


def _fill_handler_pool(pkg, rig, client) -> None:
    """Hold ``GRPC_WORKERS`` status RPCs in their handlers at once, so the
    server's pool has started every thread it ever will."""
    barrier = threading.Barrier(GRPC_WORKERS)
    name = pkg.fmt("{dev}_status")
    real = getattr(rig.service, name)

    def held(*args, **kwargs):
        barrier.wait(10)
        return real(*args, **kwargs)
    setattr(rig.service, name, held)
    try:
        _in_parallel(lambda _i: pkg.call(client, "{dev}_status", "soak",
                                         "default"),
                     range(GRPC_WORKERS), 20)
    finally:
        delattr(rig.service, name)
    assert not barrier.broken


@pytest.mark.skipif(not os.path.isdir("/proc/self/fd"),
                    reason="needs procfs for fd counting")
def test_no_fd_thread_or_lock_leak_over_many_cycles(pkg, grpc_rig):
    """A months-lived daemon: every attach/detach cycle returns the process
    to its baseline of fds, threads, lock tables and queued events."""
    rig, client = grpc_rig
    _add_pods(rig, ["soak"])

    def cycle(i):
        resp = pkg.call(client, "add_{dev}", "soak", "default", 2, False,
                        request_id=f"soak-{i}")
        assert resp.result == int(pkg.consts.AddResult.SUCCESS)
        out = pkg.call(client, "remove_{dev}", "soak", "default",
                       list(resp.device_ids), False)
        assert out.result == int(pkg.consts.RemoveResult.SUCCESS)

    for i in range(5):                       # warm-up: lazy inits allocate
        cycle(i)
    _fill_handler_pool(pkg, rig, client)
    fds_before = len(os.listdir("/proc/self/fd"))
    names_before = {t.name for t in threading.enumerate()}
    threads_before = threading.active_count()
    for i in range(5, 35):
        cycle(i)
    fds_after = len(os.listdir("/proc/self/fd"))
    threads_after = threading.active_count()
    grown = sorted({t.name for t in threading.enumerate()} - names_before)
    assert fds_after - fds_before <= 3, (fds_before, fds_after)
    assert threads_after - threads_before <= 2, (threads_before,
                                                 threads_after, grown)
    assert rig.service._request_locks._entries == {}
    assert rig.service._pod_locks._entries == {}
    deadline = time.monotonic() + 5.0
    while rig.service._event_queue and time.monotonic() < deadline:
        time.sleep(0.05)
    assert len(rig.service._event_queue) == 0


def test_contention_transcripts_agree(tmp_path):
    out = {}
    for pkg in (JAX, TORCH):
        grpc_server = pkg.mod("worker.grpc_server")
        rig = pkg.rig(tmp_path / pkg.name, n_chips=8)
        server, port = grpc_server.build_server(rig.service, port=0,
                                                address="127.0.0.1")
        server.start()
        client = grpc_server.WorkerClient(f"127.0.0.1:{port}")
        try:
            out[pkg.name] = _contention(pkg, rig, client)
        finally:
            client.close()
            server.stop(grace=0)
            rig.close()
    assert out["torch"] == out["jax"]
