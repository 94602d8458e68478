"""The slice-transaction atomicity pins of tests/test_slice_chaos.py, run
through both packages' ``MultiMasterStack``: the leader master is killed
after k of n hosts attached — after failover, either all n hosts hold
devices under ONE slice-group lease or all k are rolled back. Zero
half-attached slices, zero double-actuation, verified against the
cross-replica store view (each package's ``assert_slice_invariants``).
The body key is the package's (``tpusPerHost`` / ``gpusPerHost``), the
route its own (``/addtpuslice`` / ``/addgpuslice``), attach events by
device."""

import json
import threading
import time

import pytest

from tests.torch_control_plane import BOTH, IDS


@pytest.fixture(params=BOTH, ids=IDS)
def pkg(request):
    return request.param


def _body(pkg) -> bytes:
    return json.dumps({
        "pods": [{"namespace": "default", "pod": "workload-0"},
                 {"namespace": "default", "pod": "workload-1"}],
        f"{pkg.dev}sPerHost": 4}).encode()


class _MasterCrash(BaseException):
    """Simulated master death mid-fan-out. A BaseException on purpose:
    it must skip every Exception-typed cleanup handler on its way out —
    no rollback, no terminal txn record, exactly what SIGKILL leaves."""


def _stack(pkg, tmp_path, queue_timeout_s):
    rigs = [pkg.rig(tmp_path / f"node{i}", n_chips=4, node=f"node-{i}",
                    pod_name=f"workload-{i}") for i in range(2)]
    return pkg.mod("testing.sim").MultiMasterStack(
        rigs=rigs, masters=2, shards=1,
        broker_config=pkg.mod("master.admission").BrokerConfig(
            queue_timeout_s=queue_timeout_s, tick_interval_s=0.1))


def _store_slice_records(pkg, kube) -> list:
    c = pkg.consts
    try:
        cm = kube.get_config_map(c.DEFAULT_POOL_NAMESPACE,
                                 f"{c.STORE_CONFIGMAP_PREFIX}0")
    except pkg.errors.K8sApiError:
        return []
    record = pkg.mod("master.store").SliceTxnRecord
    return [record.from_json(value) for key, value in
            (cm["metadata"].get("annotations") or {}).items()
            if key.startswith(c.STORE_SLICE_ANNOTATION_PREFIX)]


def _crash_leader_mid_fanout(pkg, stack, leader):
    """Run the slice attach on the leader and kill it between hosts:
    workload-0's host lands (commit marker persisted), workload-1's
    never starts. Returns once the crash has happened."""
    gateway = stack.gateways[leader]
    # freeze the doomed leader's maintenance loop first: a live master
    # SELF-heals a crashed fan-out thread from its own tick, but a
    # SIGKILL'd process ticks nothing — the record is the SURVIVOR's
    gateway.broker.stop()
    crashed = threading.Event()

    def before_host_attach(namespace, pod):
        if pod != "workload-1":
            return
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            if any("default/workload-0" in record.committed
                   for record in _store_slice_records(pkg, stack.kube)):
                break
            time.sleep(0.01)
        crashed.set()
        raise _MasterCrash()

    gateway.slices.before_host_attach = before_host_attach

    def run():
        try:
            gateway.handle("POST", f"/add{pkg.dev}slice", _body(pkg))
        except BaseException:   # noqa: BLE001 — the simulated SIGKILL
            pass

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    assert crashed.wait(timeout=30), "crash point never armed"
    thread.join(timeout=10)
    # the torn mid-state while the frozen leader still HOLDS the lock:
    # one unresolved txn record with host-0's commit marker, and exactly
    # host-0 holding devices. Then kill the leader.
    records = _store_slice_records(pkg, stack.kube)
    assert len(records) == 1
    assert records[0].committed == ["default/workload-0"]
    assert len(stack.rigs[0].sim.slave_pods()) == 1
    assert stack.rigs[1].sim.slave_pods() == []
    stack.kill(leader)
    return records[0]


def _wait(predicate, timeout_s=20.0, message=""):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(0.05)
    raise AssertionError(message or "condition never held")


def test_leader_killed_mid_fanout_survivor_completes_the_slice(pkg,
                                                               tmp_path):
    """Deadline still open at failover ⇒ the survivor finishes the
    fan-out under the ORIGINAL rid: host-0 re-runs as an idempotent
    resume (no double actuation), host-1 attaches fresh, and one
    slice-group lease spans both."""
    stack = _stack(pkg, tmp_path, queue_timeout_s=30.0)
    try:
        stack.wait_converged()
        record = _crash_leader_mid_fanout(
            pkg, stack, stack.leader_for("default"))
        survivor = stack.gateways[next(iter(stack.live()))]
        _wait(lambda: not _store_slice_records(pkg, stack.kube),
              message="survivor never resolved the stranded slice txn")
        _wait(lambda: len(survivor.broker.leases.group_leases(
            record.txn_id)) == 2,
            message="survivor did not record the slice-group lease")
        for rig in stack.rigs:
            assert len(rig.sim.slave_pods()) == 1
        leases = survivor.broker.leases.group_leases(record.txn_id)
        assert {lease.pod for lease in leases} == {"workload-0",
                                                   "workload-1"}
        assert all(lease.chips == 4 for lease in leases)
        # zero double-actuation: at most ONE attach event per pod (the
        # adopted re-run of host-0 records the resumed reason)
        attached = f"{pkg.dev.upper()}Attached"
        for rig in stack.rigs:
            events = [e for e in rig.sim.kube.events
                      if e.get("reason") == attached]
            assert len(events) <= 1, [e["message"] for e in events]
        pkg.mod("testing.chaos").assert_slice_invariants(
            survivor.broker, [rig.sim for rig in stack.rigs],
            store=survivor.broker.store)
    finally:
        stack.close()


def test_leader_killed_mid_fanout_expired_txn_rolls_back(pkg, tmp_path):
    """Deadline already passed at failover ⇒ the survivor rolls every
    member back via the txn-targeted detach: zero half-attached slices,
    host-0's devices drain back to the pool."""
    stack = _stack(pkg, tmp_path, queue_timeout_s=0.0)
    try:
        stack.wait_converged()
        _crash_leader_mid_fanout(pkg, stack, stack.leader_for("default"))
        survivor = stack.gateways[next(iter(stack.live()))]
        _wait(lambda: not _store_slice_records(pkg, stack.kube),
              message="survivor never resolved the stranded slice txn")
        _wait(lambda: all(not rig.sim.slave_pods() for rig in stack.rigs),
              message="rollback left a half-attached slice behind")
        assert survivor.broker.leases.groups() == {}
        pkg.mod("testing.chaos").assert_slice_invariants(
            survivor.broker, [rig.sim for rig in stack.rigs],
            store=survivor.broker.store)
    finally:
        stack.close()
