"""The port's intent store (master/store.py) against the control plane's:
the scenarios of tests/test_store.py and tests/test_store_groupcommit.py,
each run through both packages with the same inputs and the same expected
answers (counters as deltas of each package's own registry), and the
records across the two packages — one package writes, the other
rehydrates, byte-identical. The one field named for the device (the slice
txn record's ``gpus_per_host``, the control plane's ``tpus_per_host``) is
compared under that rename."""

import json
import time

import pytest

from tests.torch_control_plane import BOTH, IDS, JAX, TORCH


@pytest.fixture(params=BOTH, ids=IDS)
def pkg(request):
    return request.param


def ns(pkg):
    return pkg.consts.DEFAULT_POOL_NAMESPACE


def make_store(pkg, kube=None, shards=1, election=None, **kw):
    kube = kube or pkg.mod("k8s.client").FakeKubeClient()
    return kube, pkg.mod("master.store").IntentStore(
        kube, pkg.mod("master.shardring").ShardRing(shards), ns(pkg),
        election=election, **kw)


def lease_record(pkg, **over):
    fields = dict(namespace="default", pod="workload", tenant="teamA",
                  priority="high", chips=3, uuids=["0", "2", "7"],
                  node="node-a", rid="rid-1", created_unix=1234.5,
                  expires_unix=99999.25, renewals=2)
    fields.update(over)
    return pkg.mod("master.store").LeaseRecord(**fields)


def waiter_record(pkg, **over):
    fields = dict(rid="w-rid-1", namespace="default", pod="contender",
                  tenant="teamB", priority="normal", chips=2,
                  node="node-a", entire=True, enqueued_unix=1000.0,
                  deadline_unix=1060.0)
    fields.update(over)
    return pkg.mod("master.store").WaiterRecord(**fields)


def raw_annotations(pkg, kube, shard=0):
    cm = kube.get_config_map(
        ns(pkg), f"{pkg.consts.STORE_CONFIGMAP_PREFIX}{shard}")
    return dict(cm["metadata"].get("annotations") or {})


def fault_injector(pkg, **fault):
    chaos = pkg.mod("testing.chaos")
    return chaos.FaultInjector([chaos.Fault(**fault)])


def cas(pkg, op, outcome):
    return pkg.registry.store_cas.value(op=op, outcome=outcome)


# -- round trips ---------------------------------------------------------------

def test_lease_record_survives_cas_write_byte_identically(pkg):
    kube, store = make_store(pkg)
    record = lease_record(pkg)
    original = record.to_json()
    assert store.put_lease(record)
    assert raw_annotations(pkg, kube)[record.annotation_key] == original
    leases, waiters, torn = store.rehydrate(0)
    assert torn == 0 and waiters == []
    assert leases == [record]
    assert leases[0].to_json() == original
    lease = leases[0].to_lease()
    assert lease.key == ("default", "workload")
    assert lease.uuids == {"0", "2", "7"}
    assert lease.tenant == "teamA" and lease.priority == "high"
    LeaseRecord = pkg.mod("master.store").LeaseRecord
    assert LeaseRecord.from_lease(lease).uuids == ["0", "2", "7"]


def test_waiter_record_survives_cas_write_byte_identically(pkg):
    kube, store = make_store(pkg)
    record = waiter_record(pkg)
    original = record.to_json()
    assert store.put_waiter(record)
    assert raw_annotations(pkg, kube)[record.annotation_key] == original
    leases, waiters, torn = store.rehydrate(0)
    assert torn == 0 and leases == []
    assert waiters == [record]
    assert waiters[0].to_json() == original
    assert waiters[0].entire is True


def test_eternal_lease_round_trips_none_expiry(pkg):
    _, store = make_store(pkg)
    assert store.put_lease(lease_record(pkg, expires_unix=None))
    leases, _, _ = store.rehydrate(0)
    assert leases[0].expires_unix is None
    assert leases[0].to_lease().expires_at is None


def test_delete_removes_the_record(pkg):
    _, store = make_store(pkg)
    wrec = waiter_record(pkg)
    store.put_lease(lease_record(pkg))
    store.put_waiter(wrec)
    assert store.delete_lease("default", "workload")
    assert store.delete_waiter("default", wrec.rid)
    assert store.rehydrate(0)[:2] == ([], [])


# -- CAS between replicas ------------------------------------------------------

def test_concurrent_replicas_conflict_and_both_land(pkg):
    kube = pkg.mod("k8s.client").FakeKubeClient()
    _, store_a = make_store(pkg, kube)
    _, store_b = make_store(pkg, kube)
    before = cas(pkg, "put", "conflict")
    assert store_a.put_lease(lease_record(pkg, pod="pod-a"))
    assert store_b.put_lease(lease_record(pkg, pod="pod-b"))
    assert store_a.put_lease(lease_record(pkg, pod="pod-c"))
    leases, _, torn = store_a.rehydrate(0)
    assert torn == 0
    assert {r.pod for r in leases} == {"pod-a", "pod-b", "pod-c"}
    assert cas(pkg, "put", "conflict") - before == 1


def test_create_race_one_winner_both_records_survive(pkg):
    kube = pkg.mod("k8s.client").FakeKubeClient()
    _, store_a = make_store(pkg, kube)
    _, store_b = make_store(pkg, kube)
    assert store_a.put_lease(lease_record(pkg, pod="pod-a"))
    assert store_b.put_lease(lease_record(pkg, pod="pod-b"))
    leases, _, _ = store_b.rehydrate(0)
    assert {r.pod for r in leases} == {"pod-a", "pod-b"}


# -- fencing -------------------------------------------------------------------

class _StubElection:
    enabled = True

    def __init__(self, token):
        self._token = token

    def token(self, shard):
        return self._token


def test_deposed_writer_is_fenced(pkg):
    kube = pkg.mod("k8s.client").FakeKubeClient()
    _, old_leader = make_store(pkg, kube, election=_StubElection(1))
    _, new_leader = make_store(pkg, kube, election=_StubElection(2))
    assert old_leader.put_lease(lease_record(pkg, pod="pod-a"))
    assert new_leader.put_lease(lease_record(pkg, pod="pod-b"))
    with pytest.raises(pkg.errors.StoreFencedError) as err:
        old_leader.put_lease(lease_record(pkg, pod="pod-c"))
    assert (err.value.shard, err.value.token, err.value.fence) == (0, 1, 2)
    leases, _, _ = new_leader.rehydrate(0)
    assert {r.pod for r in leases} == {"pod-a", "pod-b"}
    assert raw_annotations(pkg, kube)[
        pkg.consts.STORE_FENCE_ANNOTATION] == "2"


# -- torn records --------------------------------------------------------------

def _slave_pod(pkg, name, owner, owner_ns="default", chips=2):
    c = pkg.consts
    return {
        "metadata": {
            "name": name, "namespace": ns(pkg),
            "labels": {
                c.SLAVE_POD_LABEL_KEY: c.SLAVE_POD_LABEL_VALUE,
                c.OWNER_POD_LABEL_KEY: owner,
                c.OWNER_NAMESPACE_LABEL_KEY: owner_ns,
            }},
        "spec": {"containers": [{
            "name": "c",
            "resources": {"limits": {pkg.resource: str(chips)}}}]},
        "status": {"phase": "Running"},
    }


def test_torn_record_is_dropped_and_counted(pkg):
    kube, store = make_store(pkg)
    good = lease_record(pkg, pod="good")
    store.put_lease(good)
    torn_key = pkg.consts.STORE_LEASE_ANNOTATION_PREFIX + "deadbeefdeadbeef"
    kube.patch_config_map(ns(pkg), store.cm_name(0), {
        "metadata": {"annotations": {
            torn_key: '{"namespace": "default", "pod": "torn-vic'}}})
    leases, _, torn = store.rehydrate(0)
    assert torn == 1 and store.torn_records == 1
    assert [r.pod for r in leases] == ["good"]
    assert good.annotation_key in raw_annotations(pkg, kube)


def test_torn_lease_degrades_to_cluster_rederivation(pkg):
    kube = pkg.mod("k8s.client").FakeKubeClient()
    kube.put_pod(_slave_pod(pkg, "victim-slave-pod-1", "victim", chips=2))
    _, store = make_store(pkg, kube)
    torn_key = pkg.consts.STORE_LEASE_ANNOTATION_PREFIX + "feedfacefeedface"
    kube.create_config_map(ns(pkg), {
        "metadata": {"name": store.cm_name(0),
                     "annotations": {torn_key: '{"namespace": "defau'}}})
    admission = pkg.mod("master.admission")
    broker = admission.AttachBroker(kube, admission.BrokerConfig())
    broker.bind_ha(store, store.ring,
                   pkg.mod("master.election").NullElection(1))
    broker.ensure_rederived()
    assert [(le.namespace, le.pod, le.chips)
            for le in broker.leases.leases()] == [("default", "victim", 2)]
    records, _, _ = store.rehydrate(0)
    assert [(r.namespace, r.pod, r.chips) for r in records] == \
        [("default", "victim", 2)]


# -- dirty queue ---------------------------------------------------------------

def test_failed_write_parks_dirty_and_flushes(pkg):
    kube, store = make_store(pkg)
    store.put_lease(lease_record(pkg, pod="seed"))
    kube.faults = fault_injector(pkg, op="PATCH", resource="configmaps",
                                 status=500, times=50)
    assert store.put_lease(lease_record(pkg, pod="parked")) is False
    assert store.lag_s() > 0.0
    assert store.snapshot()["dirty"] == 1
    kube.faults = None
    assert store.flush_dirty() == 1
    assert store.lag_s() == 0.0
    leases, _, _ = store.rehydrate(0)
    assert {r.pod for r in leases} == {"seed", "parked"}


def test_parked_put_never_resurrects_a_newer_live_delete(pkg):
    kube, store = make_store(pkg)
    store.put_lease(lease_record(pkg, pod="seed"))
    kube.faults = fault_injector(pkg, op="PATCH", resource="configmaps",
                                 status=500, times=50)
    assert store.put_lease(lease_record(pkg, pod="ghost")) is False
    kube.faults = None
    assert store.delete_lease("default", "ghost") is True
    assert store.snapshot()["dirty"] == 0
    assert store.flush_dirty() == 0
    leases, _, _ = store.rehydrate(0)
    assert {r.pod for r in leases} == {"seed"}


def test_dirty_queue_keeps_one_mutation_per_key_newest_value(pkg):
    kube, store = make_store(pkg)
    store.put_lease(lease_record(pkg, pod="seed"))
    kube.faults = fault_injector(pkg, op="PATCH", resource="configmaps",
                                 status=500, times=50)
    assert store.put_lease(lease_record(pkg, pod="p", chips=1,
                                        uuids=["0"])) is False
    assert store.put_lease(lease_record(pkg, pod="p", chips=3,
                                        uuids=["0", "1", "2"])) is False
    assert store.snapshot()["dirty"] == 1
    kube.faults = None
    assert store.flush_dirty() == 1
    by_pod = {r.pod: r for r in store.rehydrate(0)[0]}
    assert by_pod["p"].chips == 3


class _DecayedElection:
    """Election whose token just expired: enabled, owns nothing."""

    enabled = True

    def __init__(self, shards=1):
        self.shards = shards

    def token(self, shard):
        return None


def test_decayed_token_refuses_unfenced_write(pkg):
    kube, store = make_store(pkg, election=_DecayedElection())
    with pytest.raises(pkg.errors.StoreFencedError) as err:
        store._cas(0, {"tpumounter.io/l-x": "{}"})
    assert err.value.token == -1
    with pytest.raises(pkg.errors.K8sApiError):
        kube.get_config_map(ns(pkg),
                            f"{pkg.consts.STORE_CONFIGMAP_PREFIX}0")


def test_put_leases_batches_one_cas_per_shard(pkg):
    kube, store = make_store(pkg)
    records = [lease_record(pkg, pod=f"p{i}") for i in range(5)]
    before = kube.cm_calls
    store.put_leases(records)
    assert kube.cm_calls - before <= 2
    leases, _, _ = store.rehydrate(0)
    assert {r.pod for r in leases} == {f"p{i}" for i in range(5)}
    before = kube.cm_calls
    store.put_leases(records)
    assert kube.cm_calls - before == 1


def test_forget_shard_zeroes_its_record_gauges(pkg):
    _, store = make_store(pkg)
    store.put_lease(lease_record(pkg, pod="a"))
    store.put_lease(lease_record(pkg, pod="b"))
    records = pkg.registry.store_records
    assert records.value(kind="lease", shard="0") == 2
    store.forget_shard(0)
    assert records.value(kind="lease", shard="0") == 0
    assert records.value(kind="waiter", shard="0") == 0


def test_decayed_token_parks_instead_of_dropping(pkg):
    class _Flappy:
        enabled = True
        replica = "m0"

        def __init__(self):
            self.live = False

        def token(self, shard):
            return 3 if self.live else None

        def leaders(self):
            return {0: {"holder": "m0", "url": "", "fence": 3,
                        "expired": True}}

    election = _Flappy()
    _, store = make_store(pkg, election=election)
    assert store.put_lease(lease_record(pkg, pod="held")) is False
    assert store.snapshot()["dirty"] == 1
    assert store.flush_dirty() == 0
    assert store.snapshot()["dirty"] == 1
    election.live = True
    assert store.flush_dirty() == 1
    assert {r.pod for r in store.rehydrate(0)[0]} == {"held"}
    election.live = False
    assert store.put_lease(lease_record(pkg, pod="late")) is False
    election.leaders = lambda: {0: {"holder": "peer", "url": "",
                                    "fence": 4, "expired": False}}
    assert store.flush_dirty() == 0
    assert store.snapshot()["dirty"] == 0


def test_renew_heartbeats_batch_through_flush_not_per_call(pkg):
    kube, store = make_store(pkg)
    table = pkg.mod("master.lease").LeaseTable()
    table.store = store
    for i in range(3):
        table.record("default", f"p{i}", "teamA", "normal",
                     [str(i)], node="node-a", ttl_s=60.0)
    before = kube.cm_calls
    for i in range(3):
        table.renew("default", f"p{i}", 60.0)
    assert kube.cm_calls == before
    assert table.flush_renewals() == 3
    assert kube.cm_calls - before == 1
    assert all(r.renewals == 1 for r in store.rehydrate(0)[0])


# -- defaults-off pin ----------------------------------------------------------

def test_defaults_are_single_master_semantics(pkg):
    config, shardring = pkg.mod("utils.config"), pkg.mod("master.shardring")
    ha = shardring.HAConfig.from_settings(config.Settings())
    assert not ha.enabled
    assert ha.shards == 1 and not ha.election and not ha.store
    env_ha = shardring.HAConfig.from_settings(config.Settings.from_env({}))
    assert not env_ha.enabled


def test_broker_without_ha_never_touches_configmaps(pkg):
    kube = pkg.mod("k8s.client").FakeKubeClient()
    kube.put_pod(_slave_pod(pkg, "w-slave-pod-1", "workload", chips=1))
    admission = pkg.mod("master.admission")
    broker = admission.AttachBroker(kube, admission.BrokerConfig())
    broker.ensure_rederived()
    broker.leases.record("default", "workload", "default", "normal",
                         ["0"], node="node-a", rid="r1", ttl_s=0.0)
    broker.leases.release("default", "workload")
    broker.tick()
    assert kube.cm_calls == 0


def test_shard_ring_is_stable_and_uniformish(pkg):
    ShardRing = pkg.mod("master.shardring").ShardRing
    ring = ShardRing(4)
    assert ring.shard_of("default") == ring.shard_of("default")
    assert {ring.shard_of(f"ns-{i}") for i in range(64)} == {0, 1, 2, 3}
    assert ShardRing(1).shard_of("anything") == 0


# -- group commit --------------------------------------------------------------

def gc_store(pkg, kube=None, election=None, delay=60.0, max_keys=None):
    """delay=60 parks the coalescer thread out of the way so a test
    drives flush_pending() itself."""
    max_keys = max_keys or pkg.consts.STORE_GROUP_COMMIT_MAX_KEYS
    return make_store(pkg, kube, election=election,
                      group_commit_delay_s=delay,
                      group_commit_max_keys=max_keys)


def test_coalesced_mutations_land_as_one_cas_per_shard(pkg):
    kube, store = gc_store(pkg)
    try:
        before = kube.cm_calls
        store.put_lease(lease_record(pkg))
        store.put_lease(lease_record(pkg, pod="workload-2"))
        store.put_waiter(waiter_record(pkg))
        store.put_waiter(waiter_record(pkg, rid="w-rid-2", pod="c2"))
        assert kube.cm_calls == before
        assert store.flush_pending() == 4
        assert kube.cm_calls - before <= 2
        leases, waiters, torn = store.rehydrate(0)
        assert torn == 0
        assert sorted(le.pod for le in leases) == ["workload", "workload-2"]
        assert sorted(w.rid for w in waiters) == ["w-rid-1", "w-rid-2"]
        assert [le for le in leases if le.pod == "workload"] == \
            [lease_record(pkg)]
        assert store.snapshot()["group_commit"] == {
            "delay_s": 60.0, "pending": 0, "commits": 1}
    finally:
        store.stop()


def test_last_writer_wins_per_key_within_a_batch(pkg):
    _, store = gc_store(pkg)
    try:
        record = waiter_record(pkg)
        store.put_waiter(record)
        store.delete_waiter(record.namespace, record.rid)
        store.put_lease(lease_record(pkg))
        store.flush_pending()
        leases, waiters, _ = store.rehydrate(0)
        assert waiters == [] and len(leases) == 1
    finally:
        store.stop()


def _wait_rehydrated(pkg, store, n, timeout_s=2.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        try:
            if len(store.rehydrate(0)[0]) == n:
                return True
        except pkg.errors.K8sApiError:
            pass
        time.sleep(0.005)
    return False


def test_bounded_delay_flushes_without_being_driven(pkg):
    _, store = gc_store(pkg, delay=0.02)
    try:
        store.put_lease(lease_record(pkg))
        assert _wait_rehydrated(pkg, store, 1), \
            "coalescer never flushed within the bounded delay"
    finally:
        store.stop()


def test_size_threshold_flushes_before_the_delay(pkg):
    _, store = gc_store(pkg, delay=30.0, max_keys=3)
    try:
        for i in range(3):
            store.put_lease(lease_record(pkg, pod=f"w{i}"))
        assert _wait_rehydrated(pkg, store, 3), \
            "size threshold did not trigger an early flush"
    finally:
        store.stop()


def test_off_path_is_the_per_record_cas_byte_for_byte(pkg):
    kube, store = make_store(pkg)
    assert store._flusher is None
    before = kube.cm_calls
    store.put_waiter(waiter_record(pkg))
    assert kube.cm_calls > before
    assert store._pending == {}
    assert "group_commit" not in store.snapshot()
    assert len(store.rehydrate(0)[1]) == 1


def _down(pkg):
    def down(*a, **k):
        raise pkg.errors.K8sApiError(503, "apiserver down", cause="refused")
    return down


def test_apiserver_outage_parks_batch_dirty_and_replay_converges(pkg):
    kube, store = gc_store(pkg)
    try:
        real_create = kube.create_config_map
        real_patch = kube.patch_config_map
        kube.create_config_map = kube.patch_config_map = _down(pkg)
        store.put_lease(lease_record(pkg))
        store.put_waiter(waiter_record(pkg))
        assert store.flush_pending() == 0
        assert store.snapshot()["dirty"] == 2
        assert store.lag_s() > 0
        assert store.flush_dirty() == 0
        kube.create_config_map = real_create
        kube.patch_config_map = real_patch
        assert store.flush_dirty() == 2
        leases, waiters, torn = store.rehydrate(0)
        assert torn == 0
        assert leases == [lease_record(pkg)]
        assert [w.rid for w in waiters] == ["w-rid-1"]
        assert store.snapshot()["dirty"] == 0
    finally:
        store.stop()


def test_pending_supersedes_dirty_for_the_same_key(pkg):
    kube, store = gc_store(pkg)
    try:
        real_create = kube.create_config_map
        kube.create_config_map = kube.patch_config_map = _down(pkg)
        store.put_lease(lease_record(pkg, chips=1, uuids=["0"]))
        store.flush_pending()
        assert store.snapshot()["dirty"] == 1
        kube.create_config_map = real_create
        store.put_lease(lease_record(pkg, chips=3, uuids=["0", "2", "7"]))
        assert store.snapshot()["dirty"] == 0
        store.flush_pending()
        assert store.flush_dirty() == 0
        assert store.rehydrate(0)[0][0].chips == 3
    finally:
        store.stop()


class _Election:
    """The election surface the store consults: enabled + token, plus
    the leaders()/replica pair flush_dirty's hand-off check reads."""

    def __init__(self, token):
        self.enabled = True
        self.replica = "m-0"
        self._token = token

    def token(self, shard):
        return self._token

    def leaders(self):
        return {}


def test_decayed_leadership_parks_instead_of_writing_unfenced(pkg):
    election = _Election(token=None)
    kube, store = gc_store(pkg, election=election)
    try:
        before = kube.cm_calls
        store.put_waiter(waiter_record(pkg))
        store.flush_pending()
        assert kube.cm_calls == before
        assert store.snapshot()["dirty"] == 1
        election._token = 3
        assert store.flush_dirty() == 1
        assert len(store.rehydrate(0)[1]) == 1
        assert raw_annotations(pkg, kube)[
            pkg.consts.STORE_FENCE_ANNOTATION] == "3"
    finally:
        store.stop()


def test_deposed_batch_parks_and_fires_on_fenced(pkg):
    kube, store = gc_store(pkg, election=_Election(token=2))
    try:
        kube.create_config_map(ns(pkg), {
            "apiVersion": "v1", "kind": "ConfigMap",
            "metadata": {"name": store.cm_name(0), "annotations": {
                pkg.consts.STORE_FENCE_ANNOTATION: "7"}}})
        fences = []
        store.on_fenced = fences.append
        store.put_waiter(waiter_record(pkg))
        store.flush_pending()
        assert [(f.shard, f.token, f.fence) for f in fences] == [(0, 2, 7)]
        assert store.snapshot()["dirty"] == 1
    finally:
        store.stop()


def test_broker_tick_is_the_flush_backstop(pkg):
    kube, store = gc_store(pkg)
    admission = pkg.mod("master.admission")
    broker = admission.AttachBroker(kube, admission.BrokerConfig())
    broker.bind_ha(store, store.ring, None)
    store.stop()
    broker.leases.record("default", "workload", "teamA", "normal",
                         ["0", "1"], node="node-a", rid="r1")
    assert store._pending
    broker.tick()
    assert [le.pod for le in store.rehydrate(0)[0]] == ["workload"]
    assert store.on_fenced == broker._on_fenced


def test_group_commit_knob_plumbs_from_env(pkg):
    Settings = pkg.mod("utils.config").Settings
    HAConfig = pkg.mod("master.shardring").HAConfig
    default = pkg.consts.DEFAULT_STORE_GROUP_COMMIT_S
    assert Settings().store_group_commit_s == 0.0
    assert Settings.from_env({}).store_group_commit_s == default
    assert Settings.from_env(
        {"TPU_STORE_GROUP_COMMIT": "0"}).store_group_commit_s == 0.0
    assert Settings.from_env(
        {"TPU_STORE_GROUP_COMMIT": "0.02"}).store_group_commit_s == 0.02
    with pytest.raises(ValueError):
        Settings.from_env({"TPU_STORE_GROUP_COMMIT": "-1"})
    assert HAConfig().group_commit_delay_s == 0.0
    assert HAConfig.from_settings(
        Settings.from_env({})).group_commit_delay_s == default


def test_coalesced_stack_holds_broker_invariants_across_outage(pkg,
                                                               tmp_path):
    """A full master stack on group commit takes an apiserver outage
    mid-stream, keeps admitting, and after the heal the dirty replay
    converges: ground truth, lease table and store agree."""
    import http.client
    rig = pkg.rig(tmp_path, n_chips=4)
    stack = pkg.mod("testing.sim").MultiMasterStack(
        rig, masters=1, shards=1,
        broker_config=pkg.mod("master.admission").BrokerConfig(),
        store=True, election=True, group_commit_s=0.005)
    try:
        stack.wait_converged()
        host, _, port = stack.bases[0].rpartition("//")[2].rpartition(":")

        def attach(pod):
            conn = http.client.HTTPConnection(host, int(port), timeout=30)
            conn.request("GET", f"/addgpu/namespace/default/pod/{pod}"
                                "/gpu/2/isEntireMount/false", body=b"")
            body = json.loads(conn.getresponse().read())
            conn.close()
            return body["result"]

        pod2 = rig.sim.add_target_pod(name="workload-b", uid="uid-b")
        rig.provision_container(pod2)
        assert attach("workload") == "SUCCESS"
        kube = stack.kube
        real_patch, real_create = (kube.patch_config_map,
                                   kube.create_config_map)
        store = stack.gateways[0].broker.store
        kube.patch_config_map = kube.create_config_map = _down(pkg)
        assert attach("workload-b") == "SUCCESS"
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline and \
                store.snapshot()["dirty"] == 0:
            store.flush_pending()
            time.sleep(0.01)
        assert store.snapshot()["dirty"] > 0
        kube.patch_config_map, kube.create_config_map = (real_patch,
                                                         real_create)
        store.flush_pending()
        stack.gateways[0].broker.tick()
        assert store.snapshot()["dirty"] == 0
        pkg.mod("testing.chaos").assert_broker_invariants(
            stack.gateways[0].broker, rig.sim, store=store)
        leases, _, torn = store.rehydrate(0)
        assert torn == 0
        assert sorted(le.pod for le in leases) == ["workload", "workload-b"]
    finally:
        stack.close()


# -- across the two packages ---------------------------------------------------

def _records(pkg):
    """One record of each kind the two packages share verbatim."""
    store = pkg.mod("master.store")
    return {
        "lease": lease_record(pkg),
        "lease_eternal": lease_record(pkg, pod="forever",
                                      expires_unix=None),
        "waiter": waiter_record(pkg),
        "barrier": store.SliceBarrierRecord(
            group="txn-g", generation=3,
            members=["default/w-0", "default/w-1"], created_unix=10.5,
            plan={"coordinator": "10.0.0.1:7777", "num_processes": 2},
            completed_unix=11.25),
    }


def _copy_state(src_pkg, src_kube, dst_pkg, dst_kube, shard=0):
    """What one apiserver would show a replica of the other package: the
    writer's state ConfigMap, annotations verbatim."""
    name = f"{src_pkg.consts.STORE_CONFIGMAP_PREFIX}{shard}"
    cm = src_kube.get_config_map(ns(src_pkg), name)
    dst_kube.create_config_map(ns(dst_pkg), {
        "metadata": {"name": name,
                     "annotations": dict(cm["metadata"]["annotations"])}})


@pytest.mark.parametrize("kind", ["lease", "lease_eternal", "waiter",
                                  "barrier"])
@pytest.mark.parametrize("writer,reader", [(JAX, TORCH), (TORCH, JAX)],
                         ids=["jax-writes", "torch-writes"])
def test_records_cross_packages_byte_identically(writer, reader, kind):
    w_kube, w_store = make_store(writer)
    record = _records(writer)[kind]
    put = (w_store.put_barrier if kind == "barrier"
           else w_store.put_waiter if kind == "waiter"
           else w_store.put_lease)
    assert put(record)
    r_kube, r_store = make_store(reader)
    _copy_state(writer, w_kube, reader, r_kube)
    if kind == "barrier":
        got, torn = r_store.rehydrate_barriers(0)
    else:
        leases, waiters, torn = r_store.rehydrate(0)
        got = waiters if kind == "waiter" else leases
    assert torn == 0 and len(got) == 1
    assert got[0].to_json() == record.to_json()
    assert got[0].annotation_key == record.annotation_key
    assert _records(reader)[kind].to_json() == record.to_json()


def _renamed(text: str) -> dict:
    """A control-plane record's fields with the device key renamed."""
    obj = json.loads(text)
    obj["gpus_per_host"] = obj.pop("tpus_per_host")
    return obj


def test_slice_txn_record_differs_only_by_the_device_key():
    fields = dict(txn_id="txn-abc123", rid="rid-9", tenant="teamA",
                  priority="high", pods=["default/w-0", "default/w-1"],
                  committed=["default/w-0"], created_unix=1000.0,
                  deadline_unix=1030.0, group="txn-original")
    jrec = JAX.mod("master.store").SliceTxnRecord(tpus_per_host=4, **fields)
    trec = TORCH.mod("master.store").SliceTxnRecord(gpus_per_host=4,
                                                    **fields)
    assert jrec.annotation_key == trec.annotation_key
    assert _renamed(jrec.to_json()) == json.loads(trec.to_json())
    jmove = JAX.mod("master.store").DefragMoveRecord(
        group="g", namespace="default", pod="w-1", tpus_per_host=2)
    tmove = TORCH.mod("master.store").DefragMoveRecord(
        group="g", namespace="default", pod="w-1", gpus_per_host=2)
    assert jmove.annotation_key == tmove.annotation_key
    assert _renamed(jmove.to_json()) == json.loads(tmove.to_json())
    assert TORCH.mod("master.store").DefragMoveRecord.from_json(
        tmove.to_json()) == tmove


def test_store_names_are_the_control_planes():
    keep = ("STORE_CONFIGMAP_PREFIX", "ELECTION_CONFIGMAP_PREFIX",
            "STORE_LEASE_ANNOTATION_PREFIX", "STORE_WAITER_ANNOTATION_PREFIX",
            "STORE_SLICE_ANNOTATION_PREFIX",
            "STORE_BARRIER_ANNOTATION_PREFIX",
            "STORE_DEFRAG_ANNOTATION_PREFIX", "STORE_FENCE_ANNOTATION",
            "STORE_CAPACITY_POKE_ANNOTATION", "STORE_GROUP_COMMIT_MAX_KEYS",
            "ENV_MASTER_SHARDS", "ENV_ELECTION", "ENV_INTENT_STORE",
            "ENV_STORE_GROUP_COMMIT", "ENV_SHARD_FORWARD",
            "DEFAULT_ELECTION_RENEW_S", "DEFAULT_ELECTION_TTL_S")
    assert {k: getattr(JAX.consts, k) for k in keep} == \
        {k: getattr(TORCH.consts, k) for k in keep}
    families = ("store_cas", "store_records", "store_lag",
                "election_is_leader", "election_transitions",
                "shard_forwards", "capacity_pokes")
    assert [getattr(JAX.registry, f).name for f in families] == \
        [getattr(TORCH.registry, f).name for f in families]
