"""The fleet defragmenter through both packages: the cases of
tests/test_defrag.py — the actuator's interlocks (hysteresis counted on
real fleet ticks, idle-only, cordoned-source exclusion, duty/busy-GPU
refusal, the in-flight cap, the sliding budget and its halt, the
post-move score check charging thrash), the failover adoption decision
table, plan mode and mode 0 — each run against the control plane and the
port with the same scripted repair seam and views (counters compared as
deltas). A transcript test feeds both actuators one script and compares
their move outcomes and journal records.

The e2es run on the port's stacks: an act-mode fleet of label-less 4-GPU
hosts consolidates through ``migrate_member``, and a master killed
mid-move leaves the group at exactly the old or the new placement on
``MultiMasterStack``. Their brokers run with ``idle_lease_s=0``: the idle
stamp ``MultiNodeStack.fragment`` sets is the signal under test, and with
no usage telemetry the broker's idle marking would clear it on its next
tick. A labelled fleet pins what the faithful port does where a member
must fill its host (ROADMAP Queue 3 item 42). The CLI lines wait for the
port's CLI (ROADMAP Queue 1 item 13)."""

from __future__ import annotations

import dataclasses
import importlib
import json
import threading
import time
import types
import urllib.request

import pytest

from tests.torch_control_plane import BOTH, IDS, TORCH


@pytest.fixture(params=BOTH, ids=IDS)
def pkg(request):
    return request.param


def _m(pkg, name):
    return importlib.import_module(f"{pkg.root}.{name}")


def _get_json(url, timeout=30):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return json.loads(resp.read())


def _wait(predicate, timeout_s=20.0, message=""):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(0.05)
    raise AssertionError(message or "condition never held")


# -- unit rig: a fake repair seam + a scripted topology view -------------------

class _Slices:
    """The repair seam, scripted: records every migrate_member call and
    answers with a canned result; group membership is a plain dict."""

    def __init__(self):
        self.members: dict[str, list] = {}
        self.calls: list[tuple] = []
        self.result: dict = {"outcome": "migrated", "generation": 2,
                             "added": [("default", "spare-0")]}
        self.inflight_rids: set[str] = set()
        self.finished: list[tuple] = []
        self.finish_ok = True
        self.broker = types.SimpleNamespace(
            leases=types.SimpleNamespace(
                group_leases=lambda g: list(self.members.get(g, []))),
            _on_fenced=lambda e: None)

    def migrate_member(self, group, member, rid):
        self.calls.append((group, tuple(member), rid))
        return dict(self.result)

    def txn_inflight(self, rid):
        return rid in self.inflight_rids

    def finish_member_detach(self, group, member, rid):
        self.finished.append((group, tuple(member), rid))
        return self.finish_ok


class _ViewBox:
    """A hand-cranked FleetTopology.snapshot(): tests advance the tick
    counter explicitly — the actuator must count THESE, not its own
    wakeups."""

    def __init__(self):
        self.ticks = 0
        self.score = 0.7
        self.cands: list[dict] = []

    def snapshot(self):
        return {"enabled": True, "ticks": self.ticks,
                "fleet": {"score": self.score, "nodes": {"node-0": {}},
                          "defrag_candidates": [dict(c)
                                                for c in self.cands]}}


def _cand(**kw):
    base = {"namespace": "default", "pod": "w0", "tenant": "t",
            "node": "node-0", "chips": 1, "gain": 2, "idle": True,
            "group": "g1"}
    base.update(kw)
    return base


def _lease(ns="default", pod="w0"):
    return types.SimpleNamespace(namespace=ns, pod=pod)


def _actuator(pkg, sl, box, **kw):
    kw.setdefault("mode", "act")
    kw.setdefault("hysteresis_ticks", 3)
    kw.setdefault("max_inflight", 1)
    kw.setdefault("budget", 4)
    return _m(pkg, "master.defrag").DefragActuator(
        slices=sl, view_fn=box.snapshot, **kw)


def _round(box, act):
    box.ticks += 1
    act.tick()


def test_hysteresis_counts_fleet_ticks_not_wakeups(pkg):
    sl, box = _Slices(), _ViewBox()
    sl.members["g1"] = [_lease()]
    box.cands = [_cand()]
    act = _actuator(pkg, sl, box, hysteresis_ticks=3)
    for _ in range(2):
        _round(box, act)
    for _ in range(5):
        act.tick()                  # wakeups on an unchanged fleet tick
    assert sl.calls == []
    _round(box, act)
    assert len(sl.calls) == 1
    assert sl.calls[0][:2] == ("g1", ("default", "w0"))


def test_candidate_vanishing_resets_the_streak(pkg):
    sl, box = _Slices(), _ViewBox()
    sl.members["g1"] = [_lease()]
    box.cands = [_cand()]
    act = _actuator(pkg, sl, box, hysteresis_ticks=3)
    _round(box, act)
    _round(box, act)
    box.cands = []
    _round(box, act)
    box.cands = [_cand()]
    _round(box, act)
    _round(box, act)
    assert sl.calls == []
    _round(box, act)
    assert len(sl.calls) == 1


@pytest.mark.parametrize("why,cand_kw,act_kw", [
    ("not idle", {"idle": False}, {}),
    ("not a group lease", {"group": ""}, {}),
    ("cordoned source", {}, {"node_excluded_fn": lambda node: True}),
    ("duty above threshold", {},
     {"activity_fn": lambda: {("default", "w0"): {"duty": 0.5,
                                                  "busy_chips": 0}}}),
    ("busy chips", {},
     {"activity_fn": lambda: {("default", "w0"): {"duty": 0.0,
                                                  "busy_chips": 1}}}),
])
def test_interlocks_never_issue_the_move(pkg, why, cand_kw, act_kw):
    sl, box = _Slices(), _ViewBox()
    sl.members["g1"] = [_lease()]
    box.cands = [_cand(**cand_kw)]
    act = _actuator(pkg, sl, box, hysteresis_ticks=1, **act_kw)
    for _ in range(5):
        _round(box, act)
    assert sl.calls == [], why
    assert act.fleetz_section()["plans"] == [], why


def test_repair_in_flight_defers_and_keeps_the_group(pkg):
    sl, box = _Slices(), _ViewBox()
    sl.members["g1"] = [_lease()]
    sl.result = {"outcome": "deferred", "why": "repair in flight"}
    box.cands = [_cand()]
    act = _actuator(pkg, sl, box, hysteresis_ticks=1)
    _round(box, act)
    assert len(sl.calls) == 1
    recent = act.fleetz_section()["recent"]
    assert (recent[0]["outcome"], recent[0]["why"]) == \
        ("deferred", "repair in flight")
    assert sl.members["g1"]


def test_budget_exhaustion_halts_until_the_window_slides(pkg):
    window = pkg.consts.DEFRAG_BUDGET_WINDOW_S
    sl, box = _Slices(), _ViewBox()
    sl.members["g1"] = [_lease()]
    box.cands = [_cand()]
    base = pkg.registry.defrag_moves.value(outcome="budget_exhausted")
    act = _actuator(pkg, sl, box, hysteresis_ticks=1, budget=2)
    _round(box, act)
    box.score = 0.6
    _round(box, act)
    assert len(sl.calls) == 2
    box.score = 0.5
    _round(box, act)
    _round(box, act)
    assert len(sl.calls) == 2
    assert pkg.registry.defrag_moves.value(
        outcome="budget_exhausted") == base + 1
    assert act.fleetz_section()["budget"]["exhausted"] is True
    act._move_stamps[:] = [time.monotonic() - window - 1.0] * 2
    _round(box, act)
    assert len(sl.calls) == 3
    assert act.fleetz_section()["budget"]["exhausted"] is False


def test_failed_score_check_charges_budget_and_rearms_hysteresis(pkg):
    sl, box = _Slices(), _ViewBox()
    sl.members["g1"] = [_lease()]
    box.cands = [_cand()]
    act = _actuator(pkg, sl, box, hysteresis_ticks=2, budget=10)
    _round(box, act)
    _round(box, act)
    assert len(sl.calls) == 1
    _round(box, act)
    assert len(act._move_stamps) == 2      # the move + the charge
    assert len(sl.calls) == 1
    recent = act.fleetz_section()["recent"]
    assert (recent[0]["outcome"], recent[0]["improved"]) == \
        ("migrated", False)
    _round(box, act)
    assert len(sl.calls) == 2


def test_improved_score_does_not_charge_the_budget(pkg):
    sl, box = _Slices(), _ViewBox()
    sl.members["g1"] = [_lease()]
    box.cands = [_cand()]
    act = _actuator(pkg, sl, box, hysteresis_ticks=1, budget=10)
    _round(box, act)
    assert len(sl.calls) == 1
    box.score = 0.4
    box.cands = []
    _round(box, act)
    assert len(act._move_stamps) == 1
    assert act.fleetz_section()["recent"][0]["improved"] is True


def test_plan_mode_journals_and_reports_but_never_actuates(pkg):
    sl, box = _Slices(), _ViewBox()
    sl.members["g1"] = [_lease()]
    box.cands = [_cand()]
    base = pkg.registry.defrag_moves.value(outcome="planned")
    act = _actuator(pkg, sl, box, mode="plan", hysteresis_ticks=1)
    for _ in range(4):
        _round(box, act)
    assert sl.calls == []
    section = act.fleetz_section()
    assert section["mode"] == "plan"
    assert [p["pod"] for p in section["plans"]] == ["w0"]
    assert pkg.registry.defrag_moves.value(outcome="planned") == base + 1


# -- failover adoption: the decision table -------------------------------------

class _Store:
    def __init__(self):
        self.put: list = []
        self.deleted: list = []

    def put_defrag_move(self, record):
        self.put.append(record)

    def delete_defrag_move(self, namespace, group, pod):
        self.deleted.append((namespace, group, pod))


def _record(pkg, **kw):
    base = dict(group="g1", namespace="default", pod="w0", rid="r1",
                hosts=1, src_node="node-0", state="acting")
    base.update(kw)
    return _m(pkg, "master.store").DefragMoveRecord(**base)


def _adopt_one(pkg, sl, record):
    store = _Store()
    act = _m(pkg, "master.defrag").DefragActuator(
        slices=sl, view_fn=lambda: None, store=store)
    assert act.adopt([record]) == (1 if record.state == "acting" else 0)
    act.join_adoptions()
    return act, store


def test_adopt_planned_record_drops_quietly(pkg):
    sl = _Slices()
    _, store = _adopt_one(pkg, sl, _record(pkg, state="planned"))
    assert store.deleted == [("default", "g1", "w0")]
    assert sl.finished == []


def test_adopt_group_gone_aborts(pkg):
    sl = _Slices()
    base = pkg.registry.defrag_moves.value(outcome="aborted")
    _, store = _adopt_one(pkg, sl, _record(pkg))
    assert store.deleted == [("default", "g1", "w0")]
    assert pkg.registry.defrag_moves.value(outcome="aborted") == base + 1


def test_adopt_completed_move_is_migrated(pkg):
    sl = _Slices()
    sl.members["g1"] = [_lease(pod="spare-0")]
    base = pkg.registry.defrag_moves.value(outcome="migrated")
    _, store = _adopt_one(pkg, sl, _record(pkg))
    assert sl.finished == []
    assert store.deleted == [("default", "g1", "w0")]
    assert pkg.registry.defrag_moves.value(outcome="migrated") == base + 1


def test_adopt_landed_grow_finishes_the_detach(pkg):
    sl = _Slices()
    sl.members["g1"] = [_lease(), _lease(pod="spare-0")]
    _, store = _adopt_one(pkg, sl, _record(pkg))
    assert sl.finished == [("g1", ("default", "w0"), "r1")]
    assert store.deleted == [("default", "g1", "w0")]


def test_adopt_unlanded_grow_aborts_to_old_placement(pkg):
    sl = _Slices()
    sl.members["g1"] = [_lease()]
    base = pkg.registry.defrag_moves.value(outcome="aborted")
    _, store = _adopt_one(pkg, sl, _record(pkg))
    assert sl.finished == []
    assert store.deleted == [("default", "g1", "w0")]
    assert pkg.registry.defrag_moves.value(outcome="aborted") == base + 1


def test_adopt_waits_for_the_inflight_slice_txn(pkg):
    sl = _Slices()
    sl.members["g1"] = [_lease(), _lease(pod="spare-0")]
    sl.inflight_rids.add("r1")
    act = _m(pkg, "master.defrag").DefragActuator(
        slices=sl, view_fn=lambda: None, store=_Store())
    act.adopt([_record(pkg)])
    time.sleep(0.2)
    assert sl.finished == []
    sl.inflight_rids.discard("r1")
    act.join_adoptions()
    assert sl.finished == [("g1", ("default", "w0"), "r1")]


# -- the transcript: one script through both actuators -------------------------

def _transcript(pkg) -> dict:
    """Drive one actuator through a fixed script of fleet views, activity
    feeds and seam outcomes; return its move notes and journal writes
    with the random request ids numbered and the wall clock dropped."""
    sl, box = _Slices(), _ViewBox()
    sl.members = {"g1": [_lease()], "g2": [_lease(pod="w1")]}
    store = _Store()
    feed = {("default", "w1"): {"duty": 0.3, "busy_chips": 0}}
    act = _actuator(pkg, sl, box, hysteresis_ticks=2, budget=3,
                    store=store, activity_fn=lambda: feed)
    notes = []
    note = act._note_move

    def recording(outcome, **fields):
        notes.append((outcome, fields))
        note(outcome, **fields)

    act._note_move = recording
    seam = [{"outcome": "deferred", "why": "no spare capacity"},
            {"outcome": "migrated", "generation": 2},
            {"outcome": "gone"}]
    script = [
        (0.7, [_cand(), _cand(pod="w1", group="g2", gain=3)]),
        (0.7, [_cand(), _cand(pod="w1", group="g2", gain=3)]),
        (0.7, [_cand(), _cand(pod="w1", group="g2", gain=3)]),
        (0.7, [_cand(), _cand(pod="w1", group="g2", gain=3)]),
        (0.5, [_cand()]),
        (0.5, [_cand()]),
        (0.5, [_cand()]),
        (0.5, []),
    ]
    for step, (score, cands) in enumerate(script):
        if step == 4:
            feed.clear()               # w1 idle now, but gone from view
        box.score, box.cands = score, cands
        sl.result = seam[min(len(sl.calls), len(seam) - 1)]
        _round(box, act)
    rids: dict[str, str] = {}

    def rid(value):
        return rids.setdefault(value, f"rid-{len(rids)}")

    def clean(fields):
        return {k: (rid(v) if k == "rid" else v)
                for k, v in fields.items() if k not in ("unix",)}

    journal = []
    for record in store.put:
        row = dataclasses.asdict(record)
        row["devices_per_host"] = row.pop(
            "gpus_per_host" if pkg is TORCH else "tpus_per_host")
        row.pop("created_unix")
        row["rid"] = rid(row["rid"])
        journal.append(row)
    return {"notes": [(o, clean(f)) for o, f in notes],
            "journal": journal,
            "deleted": store.deleted,
            "calls": [(g, m, rid(r)) for g, m, r in sl.calls],
            "section": {k: v for k, v in act.fleetz_section().items()
                        if k not in ("recent",)}}


def test_defrag_transcripts_agree():
    """One scripted sequence of views, activity and seam outcomes gives
    the same move outcomes, journal records (the device count under its
    package's field name), journal deletions and seam calls in both
    packages."""
    jax, torch = (_transcript(pkg) for pkg in BOTH)
    assert [o for o, _ in torch["notes"]] == [o for o, _ in jax["notes"]]
    assert torch == jax
    outcomes = [o for o, _ in torch["notes"]]
    assert outcomes.count("planned") >= 2
    assert {"deferred", "migrated"} <= set(outcomes)
    assert torch["journal"] and {r["state"] for r in torch["journal"]} == \
        {"planned", "acting"}


# -- acceptance e2e: consolidation through the repair seam ---------------------

def _fleet(tmp_path, count, **kw):
    from gpumounter_tpu_torch.master.admission import BrokerConfig
    from gpumounter_tpu_torch.testing.sim import MultiNodeStack
    hosts = [TORCH.host(tmp_path / f"node{i}") for i in range(count)]
    kw.setdefault("accelerator", None)
    return MultiNodeStack(hosts, n_chips=kw.pop("n_chips", 4), health=True,
                          topo=True,
                          broker_config=BrokerConfig(idle_lease_s=0), **kw)


def test_e2e_act_mode_consolidates_the_fragmented_fleet(tmp_path,
                                                        monkeypatch):
    """A 4-host fleet of label-less 4-GPU hosts fragmented by one idle
    1-GPU group and three busy 2-GPU gangs. In act mode the actuator
    waits out hysteresis, then migrates ONLY the idle group onto the
    spare host through ``migrate_member`` — the score strictly drops,
    the freed host schedules a whole-host mount again, and the busy
    gangs never move."""
    from gpumounter_tpu_torch.testing.chaos import (assert_defrag_invariants,
                                                    assert_slice_invariants,
                                                    assert_topology_invariants)
    from gpumounter_tpu_torch.utils.metrics import REGISTRY
    monkeypatch.setenv("TPU_DEFRAG_MODE", "act")
    stack = _fleet(tmp_path, 4)
    base_migrated = REGISTRY.defrag_moves.value(outcome="migrated")
    try:
        defrag = stack.gateway.defrag
        assert defrag is not None and defrag.mode == "act"
        defrag.stop()                      # drive ticks by hand
        calls = []
        seam = stack.gateway.slices.migrate_member

        def counted(*args):
            calls.append(args[:2])
            return seam(*args)

        stack.gateway.slices.migrate_member = counted
        groups = stack.fragment([1, 2, 2, 2], idle=(0,))
        stack.add_workload(3, "spare-0", spare=True)
        busy_before = {
            i: (lease.node, lease.chips)
            for i in (1, 2, 3)
            for lease in [stack.gateway.broker.leases.get(
                "default", f"workload-{i}")]}

        stack.gateway.fleet.tick()
        before = _get_json(f"{stack.base}/fleetz")
        pre_score = before["topology"]["score"]
        # free 3 + 2 + 2 + 2; node-0's 3 free GPUs are one block
        assert pre_score == pytest.approx(1 - 3 / 9, abs=1e-3)
        assert_topology_invariants(before["topology"])
        assert before["defrag"]["mode"] == "act"
        defrag.tick()
        for _ in range(6):
            if REGISTRY.defrag_moves.value(outcome="migrated") \
                    > base_migrated:
                break
            stack.gateway.fleet.tick()
            defrag.tick()
        assert REGISTRY.defrag_moves.value(outcome="migrated") \
            == base_migrated + 1
        assert calls == [(groups[0], ("default", "workload-0"))]

        members = stack.gateway.broker.leases.group_leases(groups[0])
        assert [(m.pod, m.node) for m in members] == \
            [("spare-0", "node-3")]
        assert stack.rigs[0].sim.slave_pods() == []
        assert stack.gateway.broker.leases.get(
            "default", "workload-0") is None
        for i, (node, chips) in busy_before.items():
            lease = stack.gateway.broker.leases.get(
                "default", f"workload-{i}")
            assert (lease.node, lease.chips) == (node, chips), i

        stack.gateway.fleet.tick()
        defrag.tick()                      # the verify pass (improved)
        after = _get_json(f"{stack.base}/fleetz")
        assert after["topology"]["score"] < pre_score
        assert after["topology"]["score"] == pytest.approx(1 - 4 / 9,
                                                           abs=1e-3)
        assert after["topology"]["nodes"]["node-0"][
            "largest_free_block"] == 4
        recent = after["defrag"]["recent"]
        assert recent[0]["outcome"] == "migrated"
        assert recent[0]["group"] == groups[0]
        assert recent[0]["improved"] is True
        assert after["defrag"]["budget"]["used"] == 1

        body = _get_json(
            f"{stack.base}/addgpu/namespace/default/pod/workload-0"
            f"/gpu/4/isEntireMount/true", timeout=60)
        assert body["result"] == "SUCCESS", body
        assert_defrag_invariants(stack.gateway.broker, actuator=defrag)
        assert_slice_invariants(stack.gateway.broker,
                                [rig.sim for rig in stack.rigs])
    finally:
        stack.close()


# -- acceptance e2e: a master killed mid-move ----------------------------------

class _MasterCrash(BaseException):
    """Simulated master death mid-move: a BaseException skips every
    Exception-typed cleanup on the way out — no rollback, no record
    retirement, exactly what SIGKILL leaves."""


def _store_defrag_records(kube) -> list:
    from gpumounter_tpu_torch.master.store import DefragMoveRecord
    from gpumounter_tpu_torch.utils import consts
    from gpumounter_tpu_torch.utils.errors import K8sApiError
    try:
        cm = kube.get_config_map(consts.DEFAULT_POOL_NAMESPACE,
                                 f"{consts.STORE_CONFIGMAP_PREFIX}0")
    except K8sApiError:
        return []
    return [DefragMoveRecord.from_json(value)
            for key, value in (cm["metadata"].get("annotations")
                               or {}).items()
            if key.startswith(consts.STORE_DEFRAG_ANNOTATION_PREFIX)]


def _crash_stack(tmp_path, monkeypatch, queue_timeout_s):
    from gpumounter_tpu_torch.master.admission import BrokerConfig
    from gpumounter_tpu_torch.testing.sim import MultiMasterStack
    from gpumounter_tpu_torch.utils import consts
    monkeypatch.setenv(consts.ENV_DEFRAG_MODE, "act")
    rigs = [TORCH.rig(tmp_path / f"node{i}", n_chips=4, node=f"node-{i}",
                      pod_name=f"workload-{i}") for i in range(2)]
    stack = MultiMasterStack(
        rigs=rigs, masters=2, shards=1,
        broker_config=BrokerConfig(queue_timeout_s=queue_timeout_s,
                                   tick_interval_s=0.1))
    stack.wait_converged()
    spare = stack.rigs[1].sim.add_target_pod(
        name="spare-0", uid="uid-spare-0",
        container_id="containerd://" + ("ab" * 32)[:64])
    spare["metadata"]["labels"][consts.SLICE_SPARE_LABEL_KEY] = \
        consts.SLICE_SPARE_LABEL_VALUE
    stack.rigs[1].sim.kube.put_pod(spare)
    stack.rigs[1].provision_container(spare)
    stack.kube.put_pod(spare)
    return stack


def _crash_leader_mid_move(stack):
    """Journal + start the move on the leader and kill it while the grow
    is in flight: the defrag record (state=acting) and the slice txn
    record survive on the store. Returns (group, leader index)."""
    leader = stack.leader_for("default")
    gateway = stack.gateways[leader]
    status, payload = gateway.handle("POST", "/addgpuslice", json.dumps({
        "pods": [{"namespace": "default", "pod": "workload-0"}],
        "gpusPerHost": 4}).encode())
    assert status == 200 and payload["result"] == "SUCCESS", payload
    group = payload["group"]
    gateway.broker.stop()
    gateway.defrag.stop()
    crashed = threading.Event()

    def before_host_attach(namespace, pod):
        if pod == "spare-0":
            crashed.set()
            raise _MasterCrash()

    gateway.slices.before_host_attach = before_host_attach
    plan = {"namespace": "default", "pod": "workload-0", "tenant": "",
            "node": "node-0", "chips": 4, "gain": 2, "group": group,
            "rid": "defrag-crash1", "created_unix": round(time.time(), 3)}
    key = ("default", "workload-0", "node-0", group)

    def run():
        try:
            gateway.defrag._execute(key, plan, 0.9, 1)
        except BaseException:   # noqa: BLE001 — the simulated SIGKILL
            pass

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    assert crashed.wait(timeout=30), "crash point never armed"
    thread.join(timeout=10)
    records = _store_defrag_records(stack.kube)
    assert [(r.group, r.pod, r.state, r.hosts, r.gpus_per_host)
            for r in records] == [(group, "workload-0", "acting", 1, 4)]
    assert len(stack.rigs[0].sim.slave_pods()) == 1
    assert stack.rigs[1].sim.slave_pods() == []
    stack.kill(leader)
    return group, leader


def _survivor(stack, dead):
    [i] = [i for i in stack.live() if i != dead]
    return stack.gateways[i]


def test_e2e_crash_mid_move_survivor_completes_to_new_placement(
        tmp_path, monkeypatch):
    """Queue deadline still open at failover ⇒ the survivor finishes the
    adopted grow txn under the original rid, then the defrag adoption
    finishes the detach: the group lands WHOLE at the new placement."""
    from gpumounter_tpu_torch.testing.chaos import (assert_defrag_invariants,
                                                    assert_slice_invariants)
    stack = _crash_stack(tmp_path, monkeypatch, queue_timeout_s=30)
    try:
        group, dead = _crash_leader_mid_move(stack)
        surv = _survivor(stack, dead)
        _wait(lambda: not _store_defrag_records(stack.kube),
              timeout_s=30, message="defrag record never resolved")
        surv.defrag.join_adoptions()
        _wait(lambda: [(m.pod, m.node) for m in
                       surv.broker.leases.group_leases(group)]
              == [("spare-0", "node-1")],
              timeout_s=30, message="group never reached new placement")
        assert len(stack.rigs[1].sim.slave_pods()) == 1
        _wait(lambda: stack.rigs[0].sim.slave_pods() == [],
              timeout_s=30, message="old member never detached")
        assert_slice_invariants(surv.broker,
                                [rig.sim for rig in stack.rigs],
                                store=surv.broker.store)
        assert_defrag_invariants(surv.broker, store=surv.broker.store,
                                 actuator=surv.defrag)
    finally:
        stack.close()


def test_e2e_crash_mid_move_survivor_aborts_to_old_placement(
        tmp_path, monkeypatch):
    """Queue deadline already passed at failover ⇒ the adopted grow txn
    rolls back, the defrag adoption sees the grow never landed and
    aborts: the group stays WHOLE at the old placement."""
    from gpumounter_tpu_torch.testing.chaos import (assert_defrag_invariants,
                                                    assert_slice_invariants)
    stack = _crash_stack(tmp_path, monkeypatch, queue_timeout_s=0)
    try:
        group, dead = _crash_leader_mid_move(stack)
        surv = _survivor(stack, dead)
        _wait(lambda: not _store_defrag_records(stack.kube),
              timeout_s=30, message="defrag record never resolved")
        surv.defrag.join_adoptions()
        members = surv.broker.leases.group_leases(group)
        assert [(m.pod, m.node) for m in members] == \
            [("workload-0", "node-0")]
        assert len(stack.rigs[0].sim.slave_pods()) == 1
        assert stack.rigs[1].sim.slave_pods() == []
        assert_slice_invariants(surv.broker,
                                [rig.sim for rig in stack.rigs],
                                store=surv.broker.store)
        assert_defrag_invariants(surv.broker, store=surv.broker.store,
                                 actuator=surv.defrag)
    finally:
        stack.close()


# -- plan mode + mode 0 --------------------------------------------------------

def test_e2e_plan_mode_reports_but_never_moves(tmp_path):
    """The staged-rollout default: plans appear on /fleetz and as
    defrag_plan events, but nothing is ever actuated."""
    from gpumounter_tpu_torch.testing.chaos import assert_defrag_invariants
    from gpumounter_tpu_torch.utils.metrics import REGISTRY
    stack = _fleet(tmp_path, 2)
    base_migrated = REGISTRY.defrag_moves.value(outcome="migrated")
    try:
        defrag = stack.gateway.defrag
        assert defrag is not None and defrag.mode == "plan"
        defrag.stop()
        stack.fragment([1, 2], idle=(0,))
        stack.add_workload(1, "spare-0", spare=True)
        slaves_before = [len(rig.sim.slave_pods()) for rig in stack.rigs]
        for _ in range(5):
            stack.gateway.fleet.tick()
            defrag.tick()
        section = _get_json(f"{stack.base}/fleetz")["defrag"]
        assert section["mode"] == "plan"
        assert [p["pod"] for p in section["plans"]] == ["workload-0"]
        eventz = _get_json(f"{stack.base}/eventz?limit=-1")
        assert any(e["kind"] == "defrag_plan"
                   and e.get("pod") == "workload-0"
                   for e in eventz["events"])
        assert REGISTRY.defrag_moves.value(outcome="migrated") \
            == base_migrated
        assert [len(rig.sim.slave_pods()) for rig in stack.rigs] \
            == slaves_before
        assert_defrag_invariants(stack.gateway.broker, actuator=defrag)
    finally:
        stack.close()


def test_e2e_mode_0_removes_the_actuator_and_section(tmp_path,
                                                     monkeypatch):
    monkeypatch.setenv("TPU_DEFRAG_MODE", "0")
    stack = _fleet(tmp_path, 1)
    try:
        assert stack.gateway.defrag is None
        assert stack.gateway.broker._defrag is None
        stack.gateway.fleet.tick()
        fleetz = _get_json(f"{stack.base}/fleetz")
        assert "defrag" not in fleetz
        assert "topology" in fleetz        # the measurement half stays
    finally:
        stack.close()


# -- a labelled fleet: members fill their hosts --------------------------------

def test_labelled_fleet_moves_whole_hosts_and_the_budget_halts(
        tmp_path, monkeypatch):
    """On labelled GKE GPU hosts a slice member fills its host (ROADMAP
    Queue 3 item 34), so a move frees one whole host and takes another:
    the fleet's largest free block never grows. What the faithful port
    does, pinned: the report names the idle member every time it is idle
    (gain = the host it would free), each move's verify pass finds the
    score unchanged (0.0 → 0.0) and charges the budget, and after two
    moves (four charges of a budget of four) the actuator halts. The
    member is re-stamped idle before each round, as usage telemetry would
    once ``TPU_IDLE_LEASE_S`` of zero duty passed."""
    from gpumounter_tpu_torch.utils.metrics import REGISTRY
    monkeypatch.setenv("TPU_DEFRAG_MODE", "act")
    stack = _fleet(tmp_path, 3, n_chips=2, accelerator="nvidia-h100-80gb")
    base = {o: REGISTRY.defrag_moves.value(outcome=o)
            for o in ("migrated", "budget_exhausted")}
    try:
        defrag = stack.gateway.defrag
        defrag.stop()
        groups = stack.fragment([2, 0, 2], idle=(0,))
        stack.add_workload(1, "spare-a", spare=True)
        stack.add_workload(0, "spare-b", spare=True)
        group = groups[0]
        named, scores, placements = [], [], []
        for _ in range(20):
            for lease in stack.gateway.broker.leases.group_leases(group):
                lease.idle_since_unix = lease.idle_since_unix or time.time()
            stack.gateway.fleet.tick()
            view = stack.gateway.topology.fleetz_section()
            scores.append(view["score"])
            named += [c["pod"] for c in view["defrag_candidates"]
                      if c["group"] == group]
            defrag.tick()
            placement = [(m.pod, m.node) for m in
                         stack.gateway.broker.leases.group_leases(group)]
            if not placements or placements[-1] != placement:
                placements.append(placement)
            if defrag.fleetz_section()["budget"]["exhausted"]:
                break
        section = defrag.fleetz_section()
        assert placements == [[("workload-0", "node-0")],
                              [("spare-a", "node-1")],
                              [("spare-b", "node-0")]]
        assert set(named) == {"workload-0", "spare-a", "spare-b"}
        assert set(scores) == {0.0}
        assert view["largest_free_block"] == 2
        migrated = [e for e in section["recent"]
                    if e["outcome"] == "migrated"]
        assert [e.get("improved") for e in migrated] == [False, False]
        assert REGISTRY.defrag_moves.value(outcome="migrated") \
            == base["migrated"] + 2
        assert section["budget"]["exhausted"] is True
        assert section["budget"]["used"] == 4
        assert REGISTRY.defrag_moves.value(outcome="budget_exhausted") \
            == base["budget_exhausted"] + 1
    finally:
        stack.close()
