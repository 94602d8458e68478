"""The topology plane through both packages: the cases of
tests/test_fleet_topology.py — the worker's /topoz view (label source
caching, the snapshot join), the master's FleetTopology (scoring, group
contiguity, the defrag candidate report and its telemetry pairing, the
cross-shard rollup, vanished-series hygiene) and the e2es on the sim
stacks — each run against the control plane and the port.

Where the two rules agree (1- and 2-device hosts: JAX's 1x2 fold is fully
adjacent and both take every count) the same /topoz payloads must give
equal scores and candidates. On larger hosts the port's GPU node is one
NVSwitch component (ROADMAP Queue 3 item 40): its numbers are pinned
beside the control plane's, and the e2e fleets run on the port's
label-less hosts. The CLI lines of the control plane's e2es wait for the
port's CLI (ROADMAP Queue 1 item 13)."""

from __future__ import annotations

import importlib
import json
import time
import types
import urllib.error
import urllib.request

import pytest

from tests.torch_control_plane import BOTH, IDS, JAX, TORCH


@pytest.fixture(params=BOTH, ids=IDS)
def pkg(request):
    return request.param


def _m(pkg, name):
    return importlib.import_module(f"{pkg.root}.{name}")


def _get_json(url, timeout=30):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return json.loads(resp.read())


def _node(pkg, name="node-a", n=4):
    sim = pkg.mod("testing.sim")
    return (sim.make_gpu_node(name=name, gpus=n) if pkg is TORCH
            else sim.make_tpu_node(name=name, chips=n))


def _payload(pkg, leased, n=4, owners=None):
    """A /topoz payload of an ``n``-device host with ``leased`` ranks, as
    each package's worker writes it: a 2x2 ICI mesh for the control
    plane's 4-chip host, ``[1, n]`` for a GPU node."""
    if pkg is TORCH:
        coords = [[0, rank] for rank in range(n)]
        meta = {"accelerator": "nvidia-h100-80gb", "topology": "",
                "gpus_per_node": n, "mesh": [1, n]}
    else:
        topology = "2x2" if n == 4 else f"1x{n}"
        rows, cols = _m(JAX, "collector.topology").host_grid(topology, n)
        coords = [[rank // cols, rank % cols] for rank in range(n)]
        meta = {"accelerator": "tpu-v5-lite-podslice", "topology": topology,
                "chips_per_host": n, "mesh": [rows, cols]}
    chips = []
    for rank in range(n):
        chip = {"chip": f"uuid-{rank}", "index": rank, "coord": coords[rank],
                "device_path": f"/dev/dev{rank}",
                "state": "leased" if rank in leased else "free"}
        if rank in leased and owners:
            chip["owner"] = owners.get(rank, "")
        chips.append(chip)
    return {"enabled": True, "node": "", **meta, "chips": chips,
            "free": n - len(leased), "leased": len(leased)}


def _lease(pod, node, chips=2, ns="default", tenant="teamA",
           uuids=(), group="", idle=None):
    return types.SimpleNamespace(
        namespace=ns, pod=pod, tenant=tenant, chips=chips,
        uuids=set(uuids), node=node, group=group, idle_since_unix=idle)


def _topo(pkg, **kw):
    return _m(pkg, "master.topology").FleetTopology(**kw)


def _host(tmp_path, pkg, i):
    return pkg.host(tmp_path / f"{pkg.name}-node{i}")


# -- worker side: coordinates + snapshot ---------------------------------------

def test_gpu_node_coordinates_are_one_row(tmp_path):
    """A GPU node's "mesh" is ``[1, N]`` with GPU ``i`` (its rank in
    index order) at ``[0, i]`` — the control plane's ``host_grid`` folds
    4 chips to 2x2, which a GPU node has no counterpart of."""
    rig = TORCH.rig(tmp_path, n_chips=4, topo=True)
    try:
        snap = rig.topo.snapshot()
        assert snap["mesh"] == [1, 4]
        assert [c["coord"] for c in snap["chips"]] == \
            [[0, 0], [0, 1], [0, 2], [0, 3]]
        assert _m(JAX, "collector.topology").host_grid("", 4) == (2, 2)
    finally:
        rig.close()


def test_unlabelled_gpu_node_reports_its_enumerated_count(tmp_path):
    """No node object and no labels: the node is unconstrained and
    reports its enumerated GPU count; an empty inventory has no mesh."""
    rig = TORCH.rig(tmp_path, n_chips=3, topo=True)
    try:
        rig.sim.kube.put_node(TORCH.mod("testing.sim").make_gpu_node(
            name="node-a", accelerator=None, gpus=3))
        snap = rig.topo.snapshot()
        assert (snap["accelerator"], snap["gpus_per_node"]) == ("", 3)
        assert snap["mesh"] == [1, 3] and snap["free"] == 3
    finally:
        rig.close()
    empty = _m(TORCH, "collector.topology").NodeTopologyView(
        types.SimpleNamespace(chips=[]))
    assert empty.snapshot()["mesh"] == [0, 0]


def test_node_topology_source_caches_and_retries_failures(pkg, tmp_path):
    rig = pkg.rig(tmp_path, n_chips=4)
    try:
        calls = {"n": 0}
        real_get_node = rig.sim.kube.get_node

        def counting_get_node(name):
            calls["n"] += 1
            return real_get_node(name)

        rig.sim.kube.get_node = counting_get_node
        source_of = _m(pkg, "collector.topology").node_topology_source
        source = source_of(rig.sim.kube, "node-a")
        assert source() is None
        assert calls["n"] == 1
        rig.sim.kube.put_node(_node(pkg))
        assert source() is None           # inside the retry fuse
        assert calls["n"] == 1
        fresh = source_of(rig.sim.kube, "node-a")
        topo = fresh()
        assert topo is not None and topo.accelerator
        assert fresh() is topo            # TTL cache: the read is free
        assert calls["n"] == 2
    finally:
        rig.close()


def test_worker_topoz_snapshot_joins_mesh_and_ownership(pkg, tmp_path):
    rig = pkg.rig(tmp_path, n_chips=4, topo=True)
    try:
        rig.sim.kube.put_node(_node(pkg))
        outcome = pkg.add(rig.service, "workload", "default", 2, False)
        assert outcome.result.name == "SUCCESS", outcome
        snap = rig.topo.snapshot()
        assert snap["enabled"] is True and snap["node"] == "node-a"
        if pkg is TORCH:
            assert snap["accelerator"] == "nvidia-h100-80gb"
            assert (snap["gpus_per_node"], snap["mesh"]) == (4, [1, 4])
            assert [c["coord"] for c in snap["chips"]] == \
                [[0, 0], [0, 1], [0, 2], [0, 3]]
        else:
            assert (snap["topology"], snap["mesh"]) == ("2x2", [2, 2])
            assert snap["chips_per_host"] == 4
        assert (snap["free"], snap["leased"]) == (2, 2)
        leased = [c for c in snap["chips"] if c["state"] == "leased"]
        for chip in leased:
            assert chip["owner"] == "default/workload", chip
            assert chip["slave_pod"], chip
        assert all("owner" not in c for c in snap["chips"]
                   if c["state"] == "free")
    finally:
        rig.close()


def test_worker_topoz_without_node_labels(pkg, tmp_path):
    rig = pkg.rig(tmp_path, n_chips=4, topo=True)
    try:
        snap = rig.topo.snapshot()
        assert snap["topology"] == "" and snap["free"] == 4
        assert snap["mesh"] == ([1, 4] if pkg is TORCH else [2, 2])
    finally:
        rig.close()


# -- master side: scoring primitives -------------------------------------------

def test_components_of_a_gpu_node_are_one_block():
    """Free GPUs 0 and 2 around a leased GPU 1 are one component on a GPU
    node; the control plane's 4-neighbour rule splits them."""
    comps = _m(TORCH, "master.topology")._components({(0, 0), (0, 2)})
    assert [len(c) for c in comps] == [2]
    assert _m(TORCH, "master.topology")._components(set()) == []
    jax_comps = _m(JAX, "master.topology")._components({(0, 0), (0, 2)})
    assert sorted(len(c) for c in jax_comps) == [1, 1]


def test_four_device_departure_is_pinned(pkg):
    """Three free devices of a 4-device host: the control plane's L on a
    2x2 mesh serves an aligned 2 and strands 1 (score 1 - 2/3); the
    port's GPU node grants all 3 (score 0, nothing stranded)."""
    score = _m(pkg, "master.topology")._score_free_set
    if pkg is TORCH:
        assert score({(0, 1), (0, 2), (0, 3)}, [1, 2, 3, 4]) == (3, 0, [3])
        assert score({(0, 0), (0, 3)}, [1, 2, 3, 4]) == (2, 0, [2])
    else:
        assert score({(0, 1), (1, 0), (1, 1)}, [1, 2, 4]) == (2, 1, [3])
        assert score({(0, 0), (1, 1)}, [1, 2, 4]) == (1, 0, [1, 1])
    assert score(set(), [1, 2, 4]) == (0, 0, [])
    topo = _topo(pkg)
    topo.ingest("node-0", _payload(pkg, {0}))
    topo.tick()
    view = topo.fleetz_section()
    want = ({"largest_free_block": 3, "stranded": 0, "frag": 0.0}
            if pkg is TORCH else
            {"largest_free_block": 2, "stranded": 1,
             "frag": round(1 - 2 / 3, 4)})
    assert {k: view["nodes"]["node-0"][k] for k in want} == want
    topo.withdraw()


def test_tick_scores_nodes_and_fleet(pkg):
    chaos = _m(pkg, "testing.chaos")
    reg = pkg.registry
    topo = _topo(pkg)
    topo.ingest("node-0", _payload(pkg, {0}))
    topo.ingest("node-1", _payload(pkg, {0, 3}))
    topo.tick()
    view = topo.fleetz_section()
    largest0, stranded0 = (3, 0) if pkg is TORCH else (2, 1)
    node0 = view["nodes"]["node-0"]
    assert (node0["free"], node0["leased"]) == (3, 1)
    assert (node0["largest_free_block"], node0["stranded"]) == \
        (largest0, stranded0)
    assert node0["free_components"] == [3]
    assert node0["frag"] == round(1 - largest0 / 3, 4)
    assert view["nodes"]["node-1"]["free_components"] == \
        ([2] if pkg is TORCH else [1, 1])
    assert view["score"] == round(1 - largest0 / 5, 4)
    assert view["stranded"] == stranded0
    chaos.assert_topology_invariants(view)
    assert reg.fleet_fragmentation_score.value() == view["score"]
    assert reg.stranded_chips.value() == stranded0
    assert reg.node_free_contiguous_chips.value(node="node-0") == largest0
    topo.withdraw()


@pytest.mark.parametrize("n", [1, 2])
def test_scores_and_candidates_agree_on_small_hosts(n):
    """The parity case: 1- and 2-device hosts, where both rules take every
    count, give equal scores, free counts, blocks, stranding and
    candidates from the same payloads."""
    payloads = {
        "node-0": {0} if n == 1 else {0},
        "node-1": set(),
        "node-2": set(range(n)),
        "node-3": {n - 1},
    }
    leases = [_lease("pod-0", "node-0", chips=1, uuids={"uuid-0"},
                     idle=time.time(), group="g0"),
              _lease("pod-2", "node-2", chips=n,
                     uuids={f"uuid-{r}" for r in range(n)}),
              _lease("pod-3", "node-3", chips=1, uuids={f"uuid-{n - 1}"})]
    views = {}
    for pkg in BOTH:
        topo = _topo(pkg, leases_fn=lambda: leases)
        for node, leased in payloads.items():
            payload = _payload(TORCH, leased, n=n)
            payload["chips_per_host"] = n        # the control plane's key
            payload["topology"] = f"1x{n}"
            topo.ingest(node, payload)
        topo.tick()
        views[pkg.name] = topo.fleetz_section()
        topo.withdraw()
    for key in ("score", "free", "largest_free_block", "stranded",
                "defrag_candidates"):
        assert views["torch"][key] == views["jax"][key], key
    assert views["torch"]["nodes"] == views["jax"]["nodes"]
    if n == 2:
        assert [c["pod"] for c in views["torch"]["defrag_candidates"]] \
            == ["pod-0", "pod-2", "pod-3"]


def test_ingest_disabled_or_dead_node_withdraws_it(pkg):
    topo = _topo(pkg)
    topo.ingest("node-0", _payload(pkg, set()))
    topo.ingest("node-1", _payload(pkg, set()))
    topo.tick()
    assert set(topo.fleetz_section()["nodes"]) == {"node-0", "node-1"}
    topo.ingest("node-1", {"enabled": False})
    topo.tick()
    assert set(topo.fleetz_section()["nodes"]) == {"node-0"}
    topo.tick(live_nodes=set())
    assert topo.fleetz_section() is None
    topo.withdraw()


def test_vanished_node_gauge_zeroed_once_then_forgotten(pkg):
    reg = pkg.registry
    topo = _topo(pkg)
    topo.ingest("node-z", _payload(pkg, set()))
    topo.tick()
    assert reg.node_free_contiguous_chips.value(node="node-z") == 4
    topo.ingest("node-z", None)
    topo.tick()
    assert reg.node_free_contiguous_chips.value(node="node-z") == 0
    reg.node_free_contiguous_chips.set(7, node="node-z")
    topo.tick()
    assert reg.node_free_contiguous_chips.value(node="node-z") == 7
    reg.node_free_contiguous_chips.set(0, node="node-z")
    topo.withdraw()


def test_withdraw_zeroes_every_exported_series(pkg):
    reg = pkg.registry
    topo = _topo(pkg,
                 groups_fn=lambda: {"g-w": [_lease("p", "node-0",
                                                   group="g-w")]},
                 local_usage_fn=lambda: {"teamW": 3})
    topo.ingest("node-0", _payload(pkg, {0}))
    topo.tick()
    assert reg.slice_contiguity.value(group="g-w") == 1
    assert reg.tenant_chips_in_use_global.value(tenant="teamW") == 3
    topo.withdraw()
    assert reg.fleet_fragmentation_score.value() == 0.0
    assert reg.stranded_chips.value() == 0
    assert reg.node_free_contiguous_chips.value(node="node-0") == 0
    assert reg.slice_contiguity.value(group="g-w") == 0
    assert reg.tenant_chips_in_use_global.value(tenant="teamW") == 0


def test_group_contiguity_judged_against_host_order(pkg):
    reg = pkg.registry
    groups = {"g-adj": [_lease("a", "node-0", group="g-adj"),
                        _lease("b", "node-1", group="g-adj")],
              "g-torn": [_lease("c", "node-0", group="g-torn"),
                         _lease("d", "node-2", group="g-torn")],
              "g-unknown": [_lease("e", "node-9", group="g-unknown")]}
    topo = _topo(pkg, groups_fn=lambda: groups)
    for i in range(3):
        topo.ingest(f"node-{i}", _payload(pkg, set()))
    topo.tick()
    view = topo.fleetz_section()
    assert view["groups"]["g-adj"]["contiguous"] is True
    assert view["groups"]["g-torn"]["contiguous"] is False
    assert view["groups"]["g-unknown"]["contiguous"] is None
    assert reg.slice_contiguity.value(group="g-adj") == 1
    assert reg.slice_contiguity.value(group="g-torn") == 0
    topo.withdraw()


def test_defrag_candidates_idle_preferred_and_actionable_only(pkg):
    leases = [
        _lease("busy-pod", "node-0", chips=1, uuids={"uuid-0"}),
        _lease("idle-pod", "node-2", chips=1, uuids={"uuid-0"},
               idle=time.time()),
    ]
    topo = _topo(pkg, leases_fn=lambda: leases)
    topo.ingest("node-0", _payload(pkg, {0}))
    topo.ingest("node-1", _payload(pkg, set()))
    topo.ingest("node-2", _payload(pkg, {0}))
    topo.tick()
    cands = topo.fleetz_section()["defrag_candidates"]
    assert [c["pod"] for c in cands] == ["idle-pod", "busy-pod"]
    assert cands[0]["idle"] is True and cands[1]["idle"] is False
    # freeing the leased device makes the whole host one block: the
    # control plane's L of 3 served 2 (gain 2), the port's block 3 (gain 1)
    assert {c["gain"] for c in cands} == {1 if pkg is TORCH else 2}
    topo.withdraw()


def test_defrag_candidate_needs_somewhere_to_go(pkg):
    leases = [_lease("pod-a", "node-0", chips=1, uuids={"uuid-0"})]
    topo = _topo(pkg, leases_fn=lambda: leases)
    topo.ingest("node-0", _payload(pkg, {0}))
    before = pkg.registry.defrag_candidates.value(node="node-0")
    topo.tick()
    assert topo.fleetz_section()["defrag_candidates"] == []
    assert pkg.registry.defrag_candidates.value(node="node-0") == before
    topo.withdraw()


def test_defrag_candidate_event_fires_once_per_new_candidate(pkg):
    events = _m(pkg, "utils.events").EVENTS
    reg = pkg.registry
    leases = [_lease("pod-a", "node-0", chips=1, uuids={"uuid-0"})]
    topo = _topo(pkg, leases_fn=lambda: leases)
    topo.ingest("node-0", _payload(pkg, {0}))
    topo.ingest("node-1", _payload(pkg, set()))
    before = reg.defrag_candidates.value(node="node-0")
    seq0 = events.tail(1)[-1]["seq"] if events.tail(1) else 0
    topo.tick()
    topo.tick()
    assert reg.defrag_candidates.value(node="node-0") == before + 1
    fired = [e for e in events.tail(64)
             if e["kind"] == "defrag_candidate" and e["seq"] > seq0]
    assert len(fired) == 1
    assert fired[0]["node"] == "node-0" and fired[0]["tenant"] == "teamA"
    assert fired[0]["attrs"]["gain"] == (1 if pkg is TORCH else 2)
    released = []
    topo.leases_fn = lambda: released
    topo.tick()
    topo.leases_fn = lambda: leases
    topo.tick()
    assert reg.defrag_candidates.value(node="node-0") == before + 2
    topo.withdraw()


def test_rollup_sums_local_usage_and_skips_self_and_expired(pkg):
    peers = {0: {"holder": "me", "url": "http://127.0.0.1:1", "fence": 1,
                 "expired": False},
             1: {"holder": "ghost", "url": "http://127.0.0.1:1",
                 "fence": 2, "expired": True}}
    topo = _topo(pkg, local_usage_fn=lambda: {"teamA": 2},
                 peers_fn=lambda: peers, replica="me")
    topo.tick()
    assert topo.global_tenants() == {"tenants": {"teamA": 2},
                                     "peers_scraped": 0, "peer_errors": 0}
    assert pkg.registry.tenant_chips_in_use_global.value(
        tenant="teamA") == 2
    bare = _topo(pkg)
    bare.tick()
    assert bare.global_tenants() is None
    topo.withdraw()


def test_snapshot_serves_raw_maps_and_scored_view(pkg):
    topo = _topo(pkg)
    snap = topo.snapshot()
    assert snap["enabled"] is True and snap["fleet"] is None
    assert snap["ticks"] == 0 and snap["nodes"] == {}
    topo.ingest("node-0", _payload(pkg, {0}))
    topo.tick()
    snap = topo.snapshot()
    assert snap["ticks"] == 1
    assert snap["fleet"]["nodes"]["node-0"]["stranded"] == \
        (0 if pkg is TORCH else 1)
    assert snap["nodes"]["node-0"]["mesh"] == \
        ([1, 4] if pkg is TORCH else [2, 2])
    assert len(snap["nodes"]["node-0"]["chips"]) == 4
    topo.withdraw()


def test_topology_families_are_the_control_planes():
    """The port registers the topology and defrag families under the
    control plane's names, types and help texts."""
    names = {"tpumounter_chip_duty_cycle",
             "tpumounter_fleet_fragmentation_score",
             "tpumounter_node_free_contiguous_chips",
             "tpumounter_stranded_chips", "tpumounter_slice_contiguity",
             "tpumounter_tenant_chips_in_use_global",
             "tpumounter_defrag_candidates_total",
             "tpumounter_defrag_moves_total", "tpumounter_defrag_inflight"}
    port = {f.name: f for f in _m(TORCH, "utils.metrics").Registry()
            .families()}
    jax = {f.name: f for f in _m(JAX, "utils.metrics").Registry()
           .families()}
    assert names <= set(port)
    for name in names:
        assert (type(port[name]).__name__, port[name].help) == \
            (type(jax[name]).__name__, jax[name].help), name


# -- acceptance e2e: fragmentation scored, defrag named, release drops it ------

def _stack(pkg, tmp_path, count, **kw):
    sim = pkg.mod("testing.sim")
    hosts = [_host(tmp_path, pkg, i) for i in range(count)]
    if pkg is TORCH:
        kw.setdefault("accelerator", None)    # the control plane's hosts
    return sim.MultiNodeStack(hosts, n_chips=4, health=True, topo=True,
                              **kw)


def test_e2e_fragmentation_scored_and_defrag_candidate_named(pkg,
                                                             tmp_path):
    """Fragmented grants across a 4-host fleet → the score and stranded
    count land in /fleetz within ONE tick, the defrag report names the
    movable idle-preferred grant, and releasing it drops the score next
    tick."""
    chaos = _m(pkg, "testing.chaos")
    admission = pkg.mod("master.admission")
    stack = _stack(pkg, tmp_path, 4,
                   broker_config=admission.BrokerConfig())
    try:
        def attach(i, n):
            body = _get_json(
                f"{stack.base}/add{pkg.dev}/namespace/default/pod/"
                f"workload-{i}/{pkg.dev}/{n}/isEntireMount/false"
                f"?tenant=team{i}", timeout=60)
            assert body["result"] == "SUCCESS", body

        attach(0, 1)
        for i in (1, 2, 3):
            attach(i, 2)
        lease_1 = next(lease for lease in
                       stack.gateway.broker.leases.leases()
                       if lease.pod == "workload-1")
        lease_1.idle_since_unix = time.time()

        states = stack.gateway.fleet.tick()
        assert set(states.values()) == {"fresh"}, states
        fleetz = _get_json(f"{stack.base}/fleetz")
        topo = fleetz["topology"]
        chaos.assert_topology_invariants(topo)
        # free 3 + 2+2+2 = 9; node-0's block is 3 on a GPU node, an
        # aligned 2 (one stranded) on the control plane's 2x2 host
        largest, stranded = (3, 0) if pkg is TORCH else (2, 1)
        assert topo["free"] == 9
        assert (topo["largest_free_block"], topo["stranded"]) == \
            (largest, stranded)
        assert topo["score"] == pytest.approx(1 - largest / 9, abs=1e-3)
        cands = topo["defrag_candidates"]
        assert cands[0]["pod"] == "workload-1" and cands[0]["idle"] is True
        assert cands[0]["node"] == "node-1" and cands[0]["gain"] > 0
        assert pkg.registry.defrag_candidates.value(node="node-1") >= 1
        eventz = _get_json(f"{stack.base}/eventz?limit=-1")
        assert any(e["kind"] == "defrag_candidate"
                   and e.get("pod") == "workload-1"
                   for e in eventz["events"])
        assert pkg.registry.fleet_fragmentation_score.value() == \
            pytest.approx(topo["score"], abs=1e-6)
        assert fleetz["global_tenants"]["tenants"]["team1"] == 2
        topoz = _get_json(f"{stack.base}/topoz")
        assert topoz["enabled"] is True
        assert set(topoz["nodes"]) == {f"node-{i}" for i in range(4)}

        release = urllib.request.Request(
            f"{stack.base}/remove{pkg.dev}/namespace/default/pod/workload-1"
            f"/force/false", data=b"{}", method="POST")
        with urllib.request.urlopen(release, timeout=60) as resp:
            assert json.loads(resp.read())["result"] == "SUCCESS"
        stack.gateway.fleet.tick()
        after = _get_json(f"{stack.base}/fleetz")["topology"]
        chaos.assert_topology_invariants(after)
        assert (after["largest_free_block"], after["free"]) == (4, 11)
        assert after["score"] == pytest.approx(1 - 4 / 11, abs=1e-3)
        assert after["score"] < topo["score"]
    finally:
        stack.close()


def test_e2e_slice_contiguity_flips_on_scattered_migration(pkg, tmp_path):
    stack = _stack(pkg, tmp_path, 4)
    try:
        status, body = stack.gateway.handle(
            "POST", f"/add{pkg.dev}slice", json.dumps({
                "pods": [{"namespace": "default", "pod": "workload-0"},
                         {"namespace": "default", "pod": "workload-1"}],
                f"{pkg.dev}sPerHost": 4}).encode())
        assert status == 200 and body["result"] == "SUCCESS", body
        stack.gateway.fleet.tick()
        groups = _get_json(f"{stack.base}/fleetz")["topology"]["groups"]
        [group] = groups
        assert groups[group] == {"hosts": ["node-0", "node-1"],
                                 "contiguous": True}
        assert pkg.registry.slice_contiguity.value(group=group) == 1
        for lease in stack.gateway.broker.leases.groups()[group]:
            if lease.node == "node-1":
                lease.node = "node-3"
        stack.gateway.fleet.tick()
        groups = _get_json(f"{stack.base}/fleetz")["topology"]["groups"]
        assert groups[group] == {"hosts": ["node-0", "node-3"],
                                 "contiguous": False}
        assert pkg.registry.slice_contiguity.value(group=group) == 0
    finally:
        stack.close()


# -- TPU_TOPOLOGY=0: the pre-topology payloads ---------------------------------

def test_topology_off_restores_pre_topology_payloads(pkg, tmp_path,
                                                     monkeypatch):
    monkeypatch.setenv("TPU_TOPOLOGY", "0")
    admission = pkg.mod("master.admission")
    rig = pkg.rig(tmp_path, n_chips=4)
    stack = pkg.mod("testing.sim").LiveStack(
        rig, broker_config=admission.BrokerConfig(), shared_kube=True)
    try:
        assert stack.gateway.topology is None
        assert stack.gateway.defrag is None
        rig.provision_container(rig.sim.add_target_pod(name="pod-z"))
        body = _get_json(
            f"{stack.base}/add{pkg.dev}/namespace/default/pod/pod-z"
            f"/{pkg.dev}/2/isEntireMount/true", timeout=60)
        assert body["result"] == "SUCCESS", body
        health = f"http://127.0.0.1:{stack.health_server.server_port}"
        assert _get_json(f"{health}/topoz") == {"enabled": False}
        stack.gateway.fleet.tick()
        fleetz = _get_json(f"{stack.base}/fleetz")
        for section in ("topology", "global_tenants", "defrag"):
            assert section not in fleetz
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(f"{stack.base}/topoz", timeout=30)
        assert exc.value.code == 404
        body = json.loads(exc.value.read())
        assert (body["result"], body["message"]) == ("NoSuchRoute",
                                                     "/topoz")
    finally:
        stack.close()


def test_workers_off_masters_on_keeps_fleetz_topology_free(pkg, tmp_path):
    admission = pkg.mod("master.admission")
    rig = pkg.rig(tmp_path, n_chips=4)
    stack = pkg.mod("testing.sim").LiveStack(
        rig, broker_config=admission.BrokerConfig(), shared_kube=True)
    try:
        assert stack.gateway.topology is not None
        stack.gateway.fleet.tick()
        fleetz = _get_json(f"{stack.base}/fleetz")
        assert "topology" not in fleetz
        assert fleetz["global_tenants"]["tenants"] == {}
        topoz = _get_json(f"{stack.base}/topoz")
        assert topoz["enabled"] is True and topoz["nodes"] == {}
    finally:
        stack.close()


# -- acceptance e2e: cross-shard global tenant rollup --------------------------

def test_e2e_cross_shard_rollup_equals_per_shard_brokerz(pkg, tmp_path):
    rig = pkg.rig(tmp_path, n_chips=4)
    stack = pkg.mod("testing.sim").MultiMasterStack(rig, masters=2,
                                                    shards=2)
    try:
        stack.wait_converged()
        assert stack.ring.shard_of("default") != \
            stack.ring.shard_of("other")
        other_pod = rig.sim.add_target_pod(
            name="pod-o", namespace="other", uid="uid-o",
            container_id="containerd://" + "cd" * 32)
        rig.provision_container(other_pod)

        def attach(ns, pod, n, tenant):
            leader = stack.leader_for(ns)
            body = _get_json(
                f"{stack.bases[leader]}/add{pkg.dev}/namespace/{ns}/pod/"
                f"{pod}/{pkg.dev}/{n}/isEntireMount/false?tenant={tenant}",
                timeout=60)
            assert body["result"] == "SUCCESS", body

        attach("default", "workload", 2, "teamA")
        attach("other", "pod-o", 1, "teamB")
        per_shard: dict[str, int] = {}
        for i in stack.live():
            brokerz = _get_json(f"{stack.bases[i]}/brokerz")
            for tenant, info in brokerz["tenants"].items():
                per_shard[tenant] = (per_shard.get(tenant, 0)
                                     + info["in_use"])
        assert per_shard == {"teamA": 2, "teamB": 1}
        for i in stack.live():
            stack.gateways[i].fleet.tick()
        total_scraped = 0
        for i in stack.live():
            rollup = _get_json(f"{stack.bases[i]}/fleetz")["global_tenants"]
            assert rollup["tenants"] == per_shard, (i, rollup)
            gw = stack.gateways[i]
            expected = len({
                str(info.get("holder") or "")
                for info in gw.election.leaders().values()
                if not info.get("expired")
                and str(info.get("url") or "")
                and str(info.get("holder") or "") != gw.topology.replica})
            assert rollup["peers_scraped"] == expected, (i, rollup)
            assert rollup["peer_errors"] == 0
            total_scraped += rollup["peers_scraped"]
        assert total_scraped >= 1
        assert pkg.registry.tenant_chips_in_use_global.value(
            tenant="teamA") == 2
        assert pkg.registry.tenant_chips_in_use_global.value(
            tenant="teamB") == 1
    finally:
        stack.close()


def test_topology_invariants_read_both_packages_views():
    """``assert_topology_invariants`` of either package accepts the other
    package's scored view: the section's keys are the control plane's."""
    for writer in BOTH:
        topo = _topo(writer)
        topo.ingest("node-0", _payload(writer, {1}))
        topo.ingest("node-1", _payload(writer, set()))
        topo.tick()
        view = topo.fleetz_section()
        topo.withdraw()
        for reader in BOTH:
            _m(reader, "testing.chaos").assert_topology_invariants(view)
