"""The port's slice transactions, gang admission, slice-group leases and
live resize (master/slicetxn.py): the cases of tests/test_slicetxn.py
against the port's ``MultiNodeStack`` (GKE GPU nodes), the slice txn
record's round trip through ``IntentStore`` (and its torn form), and the
cross-shard capacity poke. Every stack test ends on the port's
``assert_slice_invariants``."""

import threading
import time
import urllib.request

import pytest

from gpumounter_tpu_torch.k8s.client import FakeKubeClient
from gpumounter_tpu_torch.master.admission import AttachBroker, BrokerConfig
from gpumounter_tpu_torch.master.election import NullElection
from gpumounter_tpu_torch.master.shardring import ShardRing
from gpumounter_tpu_torch.master.store import (IntentStore, LeaseRecord,
                                               SliceTxnRecord)
from gpumounter_tpu_torch.utils import consts
from gpumounter_tpu_torch.utils.metrics import REGISTRY
from tests.torch_slices import (block_node, get, invariants, post,
                                slice_body, stack)


NS = consts.DEFAULT_POOL_NAMESPACE


# -- SliceTxnRecord round trips ------------------------------------------------

def txn_record(**over):
    fields = dict(txn_id="txn-abc123", rid="rid-9", tenant="teamA",
                  priority="high", pods=["default/w-0", "default/w-1"],
                  gpus_per_host=4, committed=["default/w-0"],
                  created_unix=1000.0, deadline_unix=1030.0,
                  group="txn-original")
    fields.update(over)
    return SliceTxnRecord(**fields)


def test_slice_txn_record_survives_cas_write_byte_identically():
    store = IntentStore(FakeKubeClient(), ShardRing(1), NS)
    record = txn_record()
    assert store.put_slice_txn(record)
    records, torn = store.rehydrate_slice_txns(0)
    assert torn == 0
    assert [r.to_json() for r in records] == [record.to_json()]
    assert records[0].members() == [("default", "w-0"), ("default", "w-1")]
    # the lease/waiter rehydrate must NOT pick slice records up
    assert store.rehydrate(0) == ([], [], 0)
    assert store.delete_slice_txn("default", record.txn_id)
    assert store.rehydrate_slice_txns(0) == ([], 0)


def test_torn_slice_txn_record_is_counted_and_dropped():
    kube = FakeKubeClient()
    store = IntentStore(kube, ShardRing(1), NS)
    store.put_slice_txn(txn_record())
    kube.patch_config_map(NS, store.cm_name(0), {"metadata": {
        "annotations": {consts.STORE_SLICE_ANNOTATION_PREFIX + "deadbeef":
                        '{"txn_id": "half-writ'}}})
    records, torn = store.rehydrate_slice_txns(0)
    assert torn == 1
    assert [r.txn_id for r in records] == ["txn-abc123"]


# -- group leases over a live multi-node stack ---------------------------------

@pytest.fixture
def stack2(tmp_path):
    """2 nodes × 4 GPUs behind one master with queueing + short leases
    enabled (gang + group-lease configuration)."""
    s = stack(tmp_path, hosts=2, n_chips=4,
              broker_config=BrokerConfig(queue_timeout_s=8.0,
                                         gang_hold_s=0.5,
                                         tick_interval_s=0.1))
    yield s
    s.close()


@pytest.fixture
def stack4(tmp_path):
    """4 nodes × 2 GPUs — the resize topology."""
    s = stack(tmp_path, hosts=4, n_chips=2,
              broker_config=BrokerConfig(queue_timeout_s=8.0,
                                         tick_interval_s=0.1))
    yield s
    s.close()


# -- group leases --------------------------------------------------------------

def test_slice_attach_records_group_leases(stack2):
    status, body = post(f"{stack2.base}/addgpuslice", slice_body(2))
    assert status == 200, body
    group = body["group"]
    assert group
    leases = stack2.gateway.broker.leases.group_leases(group)
    assert len(leases) == 2
    assert {lease.pod for lease in leases} == {"workload-0", "workload-1"}
    assert all(lease.chips == 4 for lease in leases)
    assert {lease.node for lease in leases} == {"node-0", "node-1"}
    _, slicez = get(f"{stack2.base}/slicez")
    assert slicez["groups"][group]["chips"] == 8
    assert slicez["groups"][group]["generation"] == 1
    assert slicez["groups"][group]["gpus_per_host"] == 4
    assert slicez["txns"]["pending"] == 0
    invariants(stack2)


def test_group_renewal_extends_every_member(stack2):
    broker = stack2.gateway.broker
    broker.config.lease_ttl_s = 30.0
    status, body = post(f"{stack2.base}/addgpuslice", slice_body(2))
    assert status == 200, body
    group = body["group"]
    before = {lease.key: lease.expires_at
              for lease in broker.leases.group_leases(group)}
    time.sleep(0.05)
    # renewing ONE member pushes every member's expiry out
    urllib.request.urlopen(urllib.request.Request(
        f"{stack2.base}/renew/namespace/default/pod/workload-0?ttl=300",
        method="POST"))
    for lease in broker.leases.group_leases(group):
        assert lease.expires_at > before[lease.key] + 200, lease.pod


def test_group_expiry_detaches_the_whole_slice(stack2):
    broker = stack2.gateway.broker
    broker.config.lease_ttl_s = 0.2
    status, body = post(f"{stack2.base}/addgpuslice", slice_body(2))
    assert status == 200, body
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        broker.tick()
        if all(not rig.sim.slave_pods() for rig in stack2.rigs):
            break
        time.sleep(0.05)
    assert all(not rig.sim.slave_pods() for rig in stack2.rigs), \
        "slice-group expiry left member hosts attached"
    assert broker.leases.groups() == {}
    invariants(stack2)


# -- gang admission ------------------------------------------------------------

def test_gang_parks_and_completes_when_capacity_frees(stack2):
    block_node(stack2, 1)
    result = {}

    def run():
        result["r"] = post(f"{stack2.base}/addgpuslice", slice_body(2))

    t = threading.Thread(target=run)
    t.start()
    # the gang must be parked (not failed fast) with host-0 reserved
    deadline = time.monotonic() + 5
    gangs = []
    while time.monotonic() < deadline:
        with stack2.gateway.broker._lock:
            gangs = [w for w in stack2.gateway.broker._waiters if w.gang]
        if gangs and stack2.rigs[0].sim.slave_pods():
            break
        time.sleep(0.02)
    assert gangs, "slice over capacity failed fast instead of parking"
    assert REGISTRY.gang_queue_depth.value() == 1
    assert len(stack2.rigs[0].sim.slave_pods()) == 1, \
        "gang did not keep the available host as an incremental " \
        "reservation"
    # free node-1: the gang should wake and complete
    post(f"{stack2.base}/removegpu/namespace/default/pod/blocker"
         "/force/false", {})
    t.join(timeout=20)
    assert not t.is_alive()
    status, body = result["r"]
    assert status == 200, body
    assert body["result"] == "SUCCESS"
    assert body["queued_s"] > 0
    assert len(stack2.gateway.broker.leases.group_leases(body["group"])) \
        == 2
    assert REGISTRY.gang_queue_depth.value() == 0
    invariants(stack2)


def test_gang_timeout_rolls_back_reservations(tmp_path):
    s = stack(tmp_path, hosts=2, n_chips=4,
              broker_config=BrokerConfig(queue_timeout_s=1.5,
                                         gang_hold_s=0.4,
                                         tick_interval_s=0.1))
    try:
        block_node(s, 1)
        handbacks = REGISTRY.slice_txns.value(outcome="handback")
        t0 = time.monotonic()
        status, body = post(f"{s.base}/addgpuslice", slice_body(2))
        assert status == 503, body
        assert body["result"] == "SliceAttachFailed"
        assert body["queue_timeout"] is True
        assert body["queued_s"] > 0
        assert body["retry_after_s"] >= 0.1
        assert time.monotonic() - t0 >= 1.4
        # the hold deadline (0.4 s) fired before the queue deadline: the
        # reserved host was handed back mid-wait, and the terminal
        # rollback leaves nothing anywhere
        assert s.rigs[0].sim.slave_pods() == []
        assert len(s.rigs[1].sim.slave_pods()) == 1   # the blocker
        assert s.gateway.broker.leases.groups() == {}
        assert REGISTRY.slice_txns.value(outcome="handback") >= \
            handbacks + 1
        invariants(s)
    finally:
        s.close()


def test_two_competing_gangs_do_not_deadlock(tmp_path):
    """Two gangs each needing BOTH nodes: partial holds + the hold
    deadline + baton passing must converge — one wins all hosts, the
    loser answers 503 with queued_s. No deadlock, no leaked GPUs."""
    s = stack(tmp_path, hosts=2, n_chips=4,
              broker_config=BrokerConfig(queue_timeout_s=6.0,
                                         gang_hold_s=0.4,
                                         tick_interval_s=0.1))
    try:
        pairs = {}
        for gang in ("a", "b"):
            members = []
            for i in range(2):
                name = f"{gang}-{i}"
                s.add_workload(i, name)
                members.append({"namespace": "default", "pod": name})
            pairs[gang] = members
        results = {}

        def run(gang):
            results[gang] = post(f"{s.base}/addgpuslice",
                                 {"pods": pairs[gang], "gpusPerHost": 4})

        threads = [threading.Thread(target=run, args=(g,))
                   for g in ("a", "b")]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads), \
            "gang deadlock: a slice attach never returned"
        outcomes = {g: results[g][0] for g in ("a", "b")}
        assert sorted(outcomes.values()) == [200, 503], outcomes
        loser = next(g for g, st in outcomes.items() if st == 503)
        winner = next(g for g, st in outcomes.items() if st == 200)
        assert results[loser][1]["queued_s"] > 0
        assert results[loser][1]["rolled_back"] is True
        group = results[winner][1]["group"]
        assert len(s.gateway.broker.leases.group_leases(group)) == 2
        invariants(s)
    finally:
        s.close()


def test_gang_queue_full_rolls_back_reservations(tmp_path):
    """A gang the queue refuses (429 QueueFull) resolves its txn before
    the client hears the refusal: landed hosts roll back — reserved GPUs
    cannot outlive a 429."""
    s = stack(tmp_path, hosts=2, n_chips=4,
              broker_config=BrokerConfig(queue_timeout_s=5.0,
                                         queue_depth=0,
                                         tick_interval_s=0.1))
    try:
        block_node(s, 1)
        status, body = post(f"{s.base}/addgpuslice", slice_body(2))
        assert status == 429, body
        assert body["result"] == "QueueFull"
        assert s.rigs[0].sim.slave_pods() == []
        assert s.gateway.broker.leases.groups() == {}
        invariants(s)
    finally:
        s.close()


# -- live resize ---------------------------------------------------------------

def test_resize_grows_and_shrinks_a_live_slice(stack4):
    status, body = post(f"{stack4.base}/addgpuslice", slice_body(2, gpus=2))
    assert status == 200, body
    group = body["group"]
    # grow 2 -> 4 hosts
    status, body = post(f"{stack4.base}/slice/resize",
                        slice_body(4, gpus=2))
    assert status == 200, body
    assert body["group"] == group
    assert body["generation"] == 2
    assert len(body["added"]) == 2 and body["removed"] == []
    assert len(stack4.gateway.broker.leases.group_leases(group)) == 4
    # generation annotation patched on every member pod
    for i in range(4):
        pod = stack4.master_kube.get_pod("default", f"workload-{i}")
        annotations = pod["metadata"].get("annotations") or {}
        assert annotations.get(consts.MESH_GENERATION_ANNOTATION) == "2"
    _, slicez = get(f"{stack4.base}/slicez")
    assert slicez["groups"][group]["generation"] == 2
    assert slicez["groups"][group]["chips"] == 8
    # shrink 4 -> 2 hosts
    status, body = post(f"{stack4.base}/slice/resize",
                        slice_body(2, gpus=2))
    assert status == 200, body
    assert body["generation"] == 3
    assert len(body["removed"]) == 2
    assert len(stack4.gateway.broker.leases.group_leases(group)) == 2
    for i in (2, 3):
        assert stack4.rigs[i].sim.slave_pods() == []
    invariants(stack4)


def test_resize_unknown_group_is_404(stack4):
    status, body = post(f"{stack4.base}/slice/resize",
                        slice_body(2, gpus=2))
    assert status == 404
    assert body["result"] == "SliceNotFound"
    assert "/addgpuslice" in body["message"]


def test_resize_failed_grow_leaves_slice_and_generation_untouched(stack4):
    status, body = post(f"{stack4.base}/addgpuslice", slice_body(2, gpus=2))
    assert status == 200, body
    group = body["group"]
    # node-3's GPUs are taken: growing to 4 hosts cannot complete
    block_node(stack4, 3, gpus=2)
    stack4.gateway.broker.config.queue_timeout_s = 0.0   # fail fast
    status, body = post(f"{stack4.base}/slice/resize",
                        slice_body(4, gpus=2))
    assert status == 503, body
    assert len(stack4.gateway.broker.leases.group_leases(group)) == 2
    _, slicez = get(f"{stack4.base}/slicez")
    assert slicez["groups"][group]["generation"] == 1
    assert stack4.rigs[2].sim.slave_pods() == []
    invariants(stack4)


def test_noop_resize_does_not_bump_generation(stack4):
    status, body = post(f"{stack4.base}/addgpuslice", slice_body(2, gpus=2))
    assert status == 200, body
    group = body["group"]
    status, body = post(f"{stack4.base}/slice/resize",
                        slice_body(2, gpus=2))
    assert status == 200, body
    assert body["generation"] == 1
    assert body["unchanged"] is True
    assert body["added"] == [] and body["removed"] == []
    _, slicez = get(f"{stack4.base}/slicez")
    assert slicez["groups"][group]["generation"] == 1


def test_generation_survives_registry_loss(stack4):
    """A master restart loses the in-memory group registry; the
    generation comes back from the member pods' annotations — or a
    post-restart resize would re-issue an already-seen generation."""
    status, body = post(f"{stack4.base}/addgpuslice", slice_body(2, gpus=2))
    assert status == 200, body
    group = body["group"]
    status, body = post(f"{stack4.base}/slice/resize",
                        slice_body(3, gpus=2))
    assert status == 200 and body["generation"] == 2
    stack4.gateway.slices._groups.clear()
    _, slicez = get(f"{stack4.base}/slicez")
    assert slicez["groups"][group]["generation"] == 2
    stack4.gateway.slices._groups.clear()
    status, body = post(f"{stack4.base}/slice/resize",
                        slice_body(4, gpus=2))
    assert status == 200, body
    assert body["generation"] == 3      # 2 recovered + 1, never back to 2
    invariants(stack4)


def test_defaults_off_slice_semantics(tmp_path):
    """With every knob off (no store, no queue timeout, no lease TTL):
    immediate fail-fast on contention with clean rollback, per-pod
    results, and ZERO ConfigMap traffic."""
    s = stack(tmp_path, hosts=2, n_chips=4)
    try:
        status, body = post(f"{s.base}/addgpuslice", slice_body(2))
        assert status == 200
        assert body["result"] == "SUCCESS"
        assert body["rolled_back"] is False
        assert len(body["pods"]) == 2
        assert "queued_s" not in body
        status, body = post(f"{s.base}/removegpuslice",
                            {"pods": slice_body(2)["pods"]})
        assert status == 200
        # a contended slice fails FAST (no gang parking without a queue)
        block_node(s, 1)
        t0 = time.monotonic()
        status, body = post(f"{s.base}/addgpuslice", slice_body(2))
        assert status == 503
        assert body["result"] == "SliceAttachFailed"
        assert body["rolled_back"] is True
        assert time.monotonic() - t0 < 5.0
        assert "queued_s" not in body
        assert s.master_kube.cm_calls == 0
        for rig in s.rigs:
            assert rig.sim.kube.cm_calls == 0
        invariants(s)
    finally:
        s.close()


# -- cross-shard capacity poke -------------------------------------------------

class _TwoShardElection(NullElection):
    """Election double: enabled, owns only ``mine``."""

    enabled = True

    def __init__(self, shards, mine):
        super().__init__(shards)
        self.mine = mine

    def is_leader(self, shard):
        return shard == self.mine

    def token(self, shard):
        return 7 if shard == self.mine else None

    def owned(self):
        return [self.mine]


def test_release_pokes_peer_shards_and_tick_receives():
    """A detach on shard A's leader stamps peer shards' state ConfigMaps;
    a peer leader's tick observes the moved stamp and opens a retry
    generation for its parked waiters."""
    kube = FakeKubeClient()
    ring = ShardRing(2)
    election_a = _TwoShardElection(2, 0)
    election_b = _TwoShardElection(2, 1)
    store_a = IntentStore(kube, ring, NS, election=election_a)
    store_b = IntentStore(kube, ring, NS, election=election_b)
    broker_a = AttachBroker(kube, BrokerConfig())
    broker_a.bind_ha(store_a, ring, election_a)
    broker_b = AttachBroker(kube, BrokerConfig())
    broker_b.bind_ha(store_b, ring, election_b)
    ns_b = next(ns for ns in ("default", "team-b", "blue", "green")
                if ring.shard_of(ns) == 1)
    store_b.put_lease(LeaseRecord(namespace=ns_b, pod="seed", tenant=ns_b,
                                  chips=1))
    assert store_b.check_poke(1) is False      # baseline
    sent = REGISTRY.capacity_pokes.value(direction="sent")
    # A frees GPUs: release() marks the nudge, A's next tick stamps it
    broker_a.release("whatever", "pod")
    assert broker_a._poke_pending is True
    broker_a.tick()
    assert broker_a._poke_pending is False
    assert REGISTRY.capacity_pokes.value(direction="sent") - sent == 1
    assert store_a.poke_peers({0}) == 0        # rate-limited re-poke
    assert store_b.check_poke(1) is True
    assert store_b.check_poke(1) is False
    gen_before = broker_b._gen
    broker_b.signal_capacity()
    assert broker_b._gen == gen_before + 1


# -- failover adoption of stranded slice transactions ---------------------------

def _bind_store(s):
    store = IntentStore(s.master_kube, ShardRing(1), NS)
    s.gateway.broker.bind_ha(store, store.ring, NullElection(1))
    return store


def _wait(pred, timeout_s=10.0):
    deadline = time.monotonic() + timeout_s
    while not pred():
        assert time.monotonic() < deadline, "timed out"
        time.sleep(0.02)


@pytest.mark.parametrize("remaining_s", [30.0, -1.0],
                         ids=["completes", "rolls-back"])
def test_stranded_txn_record_is_adopted(tmp_path, remaining_s):
    """A txn record a dead leader left behind (one host already
    committed) is completed under its original rid while its deadline
    holds, and rolled back on every member once it has passed; either
    way the record is resolved and no half-attached slice remains."""
    s = stack(tmp_path, hosts=2, n_chips=4)
    try:
        store = _bind_store(s)
        manager = s.gateway.slices
        record = txn_record(pods=["default/workload-0",
                                  "default/workload-1"],
                            committed=[], group="",
                            created_unix=round(time.time(), 3),
                            deadline_unix=round(time.time()
                                                + remaining_s, 3))
        store.put_slice_txn(record)
        outcome = "adopted_commit" if remaining_s > 0 else "adopted_abort"
        before = REGISTRY.slice_txns.value(outcome=outcome)
        manager.tick()
        _wait(lambda: not store.rehydrate_slice_txns(0)[0]
              and not manager._adopting)
        assert REGISTRY.slice_txns.value(outcome=outcome) - before == 1
        groups = s.gateway.broker.leases.groups()
        if remaining_s > 0:
            assert sorted(le.pod for le in groups[record.txn_id]) == \
                ["workload-0", "workload-1"]
        else:
            assert groups == {}
        s.gateway.broker.tick()
        from gpumounter_tpu_torch.testing.chaos import \
            assert_slice_invariants
        assert_slice_invariants(s.gateway.broker, [r.sim for r in s.rigs],
                                kube=s.master_kube, store=store)
    finally:
        s.close()
