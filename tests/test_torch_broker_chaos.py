"""The broker race plans of tests/test_broker_chaos.py, run through both
packages: a lease expiring while its owner is mid-detach, a preemption
firing during the victim's actuation, and a master crash-restart with a
non-empty contention queue — each must uphold the node-local chaos
invariants (each package's ``assert_invariants``) PLUS the broker-layer
ones (``assert_broker_invariants``: lease table == cluster ground truth,
no stranded waiters, no double-detach). Result names by role, audit
reasons by device, counters as deltas of each package's own registry."""

import threading
import time

from tests.test_torch_broker import (add, detach_messages,  # noqa: F401
                                     pkg, remove, stack_factory)


def test_lease_expires_while_owner_mid_detach(pkg, stack_factory):
    """The expiry reaper races an owner-initiated detach that is slowed
    mid-cleanup (injected DELETE latency). The worker's per-pod lock
    serialises them; whoever loses finds nothing to detach — exactly one
    actuated detach, no double-release, no leaked reservation."""
    chaos = pkg.mod("testing.chaos")
    stack = stack_factory(config=dict(lease_ttl_s=0.2))
    gw = stack.gateway
    status, _ = add(gw, "workload", 2, rid="race-lease")
    assert status == 200
    injector = chaos.FaultInjector([chaos.Fault(
        op="DELETE", resource="pods", latency_s=0.5, times=1)])
    stack.kube.faults = injector
    time.sleep(0.25)                      # lease is now expired
    done = {}
    thread = threading.Thread(
        target=lambda: done.update(res=remove(gw, "workload")))
    thread.start()
    time.sleep(0.1)                       # owner detach is in flight
    reaped = gw.broker.tick()             # expiry reaper fires into the race
    thread.join(timeout=20)
    assert not thread.is_alive()
    assert done["res"][0] == 200          # the owner's detach won
    assert injector.fired, "the DELETE latency fault never bit"
    assert reaped in (0, 1)
    assert gw.broker.leases.leases() == []
    assert stack.rig.sim.slave_pods() == []
    # ONE actuated detach: the loser of the race must not have re-detached
    assert len(detach_messages(pkg, stack)) == 1
    chaos.assert_invariants(stack.rig, set(), max_attached_events=1)
    chaos.assert_broker_invariants(gw.broker, stack.rig.sim)


def test_preemption_fires_during_victim_actuation(pkg, stack_factory):
    """A high-priority request arrives while the victim's attach is still
    actuating (slow scripted scheduler). The preemption detach serialises
    behind the victim's attach on the worker's pod lock; the victim is
    then cleanly detached and the high request completes — no partial
    grant survives on either pod."""
    chaos = pkg.mod("testing.chaos")
    stack = stack_factory(
        config=dict(quotas={"hog": 2, "*": 4}, quota_burst=2.0,
                    queue_timeout_s=30.0),
        extra_pods=("hog-pod", "vip-pod"), schedule_delay_s=0.3)
    gw = stack.gateway
    hog_done, vip_done = {}, {}
    hog_thread = threading.Thread(target=lambda: hog_done.update(
        res=add(gw, "hog-pod", 4, entire=True, tenant="hog",
                rid="hog-rid")))
    hog_thread.start()
    time.sleep(0.1)                       # hog's actuation is in flight
    vip_thread = threading.Thread(target=lambda: vip_done.update(
        res=add(gw, "vip-pod", 4, entire=True, tenant="vip",
                priority="high", rid="vip-rid")))
    vip_thread.start()
    hog_thread.join(timeout=30)
    vip_thread.join(timeout=30)
    assert not hog_thread.is_alive() and not vip_thread.is_alive()
    assert hog_done["res"][0] == 200      # the victim DID attach first
    status, body = vip_done["res"]
    assert status == 200 and len(body["device_ids"]) == 4
    assert gw.broker.leases.get("default", "hog-pod") is None
    lease = gw.broker.leases.get("default", "vip-pod")
    assert lease is not None and lease.chips == 4
    causes = detach_messages(pkg, stack)
    assert any("cause=preempted:vip:vip-rid" in m for m in causes), causes
    chaos.assert_broker_invariants(gw.broker, stack.rig.sim)
    held = {device_id
            for containers in stack.rig.sim.podresources.assignments.values()
            for resources in containers.values()
            for ids in resources.values()
            for device_id in ids}
    assert held == set(body["device_ids"])


def test_master_crash_restart_with_non_empty_queue(pkg, stack_factory):
    """A queued attach is parked when the master 'crashes'. The new
    master re-derives lease state from cluster ground truth, serves
    detaches/attaches immediately, and neither master double-actuates;
    the stranded waiter times out cleanly in the old process."""
    chaos = pkg.mod("testing.chaos")
    admission = pkg.mod("master.admission")
    stack = stack_factory(config=dict(quotas={"*": 4}, queue_timeout_s=1.0),
                          extra_pods=("w2",))
    gw1 = stack.gateway
    assert add(gw1, "workload", 4, entire=True)[0] == 200
    queued = {}
    thread = threading.Thread(
        target=lambda: queued.update(res=add(gw1, "w2", 2,
                                             tenant="other")))
    thread.start()
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and not gw1.broker._waiters:
        time.sleep(0.01)
    assert gw1.broker._waiters, "attach never queued"
    gw2 = stack.new_gateway(admission.BrokerConfig(quotas={"*": 4},
                                                   queue_timeout_s=1.0))
    registry = pkg.registry
    detaches_before = registry.detach_results.value(result="SUCCESS")
    assert gw2.broker.tick() == 0         # re-derivation reaps nothing
    assert registry.detach_results.value(
        result="SUCCESS") == detaches_before
    assert gw2.broker.leases.tenant_usage("default") == 4
    assert add(gw2, "w2", 1)[0] == 429    # quota continuity
    thread.join(timeout=20)
    assert not thread.is_alive()
    status, body = queued["res"]
    assert status == 503 and body.get("queue_timeout") is True
    assert gw1.broker._waiters == []
    assert remove(gw2, "workload")[0] == 200
    assert add(gw2, "w2", 2)[0] == 200
    assert len(detach_messages(pkg, stack)) == 1   # no double-detach
    chaos.assert_broker_invariants(gw2.broker, stack.rig.sim)
