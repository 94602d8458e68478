"""The resident actuation agent, through both packages: the cases of
tests/test_agent.py that tests/test_torch_worker.py does not hold. Batch
execution, idempotent batches, removal, the cached namespace handle, a
stale handle evicted and reopened, a dead container, a filesystem error
passing through as an actuation error, a crash mid-batch, a stopped agent
that faults instead of hanging, the single-op methods, and an agent crash
whose fallback also fails rolling the attach back. Node paths and majors
are each package's own (``/dev/accelN`` at 120, ``/dev/nvidiaN`` at
195)."""

import os
import shutil

import pytest

from tests.torch_control_plane import BOTH, IDS, JAX, TORCH

PID = 4242


@pytest.fixture(params=BOTH, ids=IDS)
def pkg(request):
    return request.param


@pytest.fixture
def host(pkg, tmp_path):
    h = pkg.host(tmp_path)
    os.makedirs(os.path.join(h.proc_root, str(PID), "root", "dev"),
                exist_ok=True)
    return h


@pytest.fixture
def agent(pkg, host):
    a = pkg.mod("actuation.agent").ResidentActuationAgent(host,
                                                          fake_nodes=True)
    yield a
    a.stop()


def _op(pkg, i):
    return (pkg.node(i), pkg.major, i)


def _container_nodes(host, pid=PID):
    root = os.path.join(host.proc_root, str(pid), "root")
    return {"/" + os.path.relpath(os.path.join(d, n), root)
            for d, _, files in os.walk(root) for n in files
            if not n.endswith(".majmin")}


def test_agent_executes_batch_with_zero_forks(pkg, agent, host):
    assert agent.apply(PID, [_op(pkg, 0), _op(pkg, 1)], []) == 2
    assert _container_nodes(host) == {pkg.node(0), pkg.node(1)}
    root = os.path.join(host.proc_root, str(PID), "root")
    with open(root + pkg.node(0) + ".majmin") as f:
        assert f.read() == f"{pkg.major}:0"


def test_agent_batches_are_idempotent(pkg, agent):
    assert agent.apply(PID, [_op(pkg, 0)], []) == 1
    assert agent.apply(PID, [_op(pkg, 0)], []) == 0


def test_agent_removes_nodes_and_sidecars(pkg, agent, host):
    agent.apply(PID, [_op(pkg, 0)], [])
    agent.apply(PID, [], [pkg.node(0)])
    assert _container_nodes(host) == set()
    agent.apply(PID, [], [pkg.node(0)])      # absent: a no-op


def test_agent_caches_the_ns_handle(pkg, agent):
    reg = pkg.registry
    assert agent.warm(PID) is True
    before = reg.agent_revalidations.value(outcome="ok")
    agent.apply(PID, [_op(pkg, 0)], [])
    agent.apply(PID, [], [pkg.node(0)])
    assert reg.agent_revalidations.value(outcome="ok") >= before + 2
    assert [h["pid"] for h in agent.status()["ns_fds"]] == [PID]


def test_stale_handle_is_evicted_and_reopened(pkg, agent, host):
    reg = pkg.registry
    agent.warm(PID)
    pid_dir = os.path.join(host.proc_root, str(PID))
    shutil.rmtree(pid_dir)
    os.makedirs(os.path.join(pid_dir, "root", "dev"))
    before = reg.agent_revalidations.value(outcome="stale")
    assert agent.apply(PID, [_op(pkg, 0)], []) == 1
    assert reg.agent_revalidations.value(outcome="stale") == before + 1
    assert _container_nodes(host) == {pkg.node(0)}


def test_dead_container_raises_agent_fault(pkg, agent, host):
    agent.warm(PID)
    shutil.rmtree(os.path.join(host.proc_root, str(PID)))
    with pytest.raises(pkg.mod("actuation.agent").AgentFault):
        agent.apply(PID, [_op(pkg, 0)], [])


def test_actuation_error_passes_through_not_agent_fault(pkg, agent, host):
    """A filesystem failure is a real actuation failure (the parent path is
    a file, so mkdir fails even as root)."""
    root = os.path.join(host.proc_root, str(PID), "root")
    with open(os.path.join(root, "dev", "blocked"), "w"):
        pass
    with pytest.raises(pkg.errors.ActuationError):
        agent.apply(PID, [("/dev/blocked/node0", pkg.major, 7)], [])


def test_executor_crash_mid_batch_faults_then_recovers(pkg, agent):
    calls = {"n": 0}

    def die_on_second(op, pid, path):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("injected agent crash")
    agent._op_hook = die_on_second
    with pytest.raises(pkg.mod("actuation.agent").AgentFault):
        agent.apply(PID, [_op(pkg, 0), _op(pkg, 1)], [])
    agent._op_hook = None
    assert agent.apply(PID, [_op(pkg, 0), _op(pkg, 1)], []) == 1
    assert agent.status()["executor_alive"] is True


def test_stopped_agent_faults_instead_of_hanging(pkg, agent):
    agent.stop()
    with pytest.raises(pkg.mod("actuation.agent").AgentFault):
        agent.apply(PID, [_op(pkg, 0)], [])


def test_single_op_methods_ride_the_agent(pkg, agent, host):
    actuator = pkg.mod("actuation.agent").AgentActuator(
        agent, pkg.mod("actuation.nsenter").RecordingActuator())
    assert actuator.create_device_node(PID, pkg.node(0), pkg.major,
                                       0) is True
    assert actuator.create_device_node(PID, pkg.node(0), pkg.major,
                                       0) is False
    actuator.remove_device_node(PID, pkg.node(0))
    assert _container_nodes(host) == set()


def _crash_and_failed_fallback(pkg, root) -> dict:
    """The agent dies mid-batch and the fallback fails too: the service's
    rollback runs and leaves nothing behind."""
    rig = pkg.rig(root, n_chips=4, actuator="procroot", informer=True,
                  agent=True)

    def always_die(op, pid, path):
        raise RuntimeError("injected agent crash")
    rig.agent._op_hook = always_die
    fallback = rig.actuator.fallback
    orig = fallback.create_device_node

    def failing_create(pid, device_path, major, minor, mode=0o666):
        raise pkg.errors.ActuationError("injected fallback failure")
    fallback.create_device_node = failing_create
    try:
        with pytest.raises(pkg.errors.TPUMounterError) as err:
            pkg.add(rig.service, "workload", "default", 4, True,
                    request_id="agent-chaos")
        fallback.create_device_node = orig
        rig.agent._op_hook = None
        pkg.mod("testing.chaos").assert_invariants(rig, set())
        return {"error": type(err.value).__name__,
                "backlog": rig.service.journal.backlog(),
                "slaves": len(rig.sim.slave_pods()),
                "nodes": sorted(_container_nodes(rig.host, rig.pid))}
    finally:
        rig.close()


def test_agent_crash_plus_fallback_failure_rolls_back(pkg, tmp_path):
    out = _crash_and_failed_fallback(pkg, tmp_path)
    assert out == {"error": "ActuationError", "backlog": 0, "slaves": 0,
                   "nodes": []}


def test_rollback_transcripts_agree(tmp_path):
    assert _crash_and_failed_fallback(TORCH, tmp_path / "torch") == \
        _crash_and_failed_fallback(JAX, tmp_path / "jax")
