"""The port master's re-federation barrier (master/slicetxn.py), the
master-side cases of tests/test_federation.py: armed on a fresh slice's
commit and on every mesh-generation bump, joined over ``POST
/slice/barrier``, completing into a federation plan (ordered membership =
process ids, coordinator = member 0's address); stale and future
generations and non-members refused; an incomplete barrier superseded by
the next generation; the stuck flag in /slicez; lazy re-arm after state
loss; teardown retiring it. The cases that re-arm from the intent store
(``adopt_barriers``) are in tests/test_torch_federation.py; the doctor
and ``slice status`` CLI halves wait for the CLI (item 13)."""

import time

import pytest

from gpumounter_tpu_torch.master.admission import BrokerConfig
from gpumounter_tpu_torch.torchcheck import federation as fed
from gpumounter_tpu_torch.utils.events import EVENTS
from gpumounter_tpu_torch.utils.metrics import REGISTRY
from tests.torch_slices import get, invariants, post, pods, stack


def _target(members, gpus=2):
    return {"pods": pods(members), "gpusPerHost": gpus}


def _join(base, group, gen, member, address="127.0.0.1:1"):
    return post(f"{base}/slice/barrier",
                {"group": group, "generation": gen,
                 "member": member, "address": address})


@pytest.fixture
def s2(tmp_path):
    st = stack(tmp_path, hosts=2, n_chips=2)
    yield st
    try:
        invariants(st)
    finally:
        st.close()


def test_slice_attach_arms_generation_one_barrier(s2):
    status, body = post(f"{s2.base}/addgpuslice", _target(range(2)))
    assert status == 200, body
    group = body["group"]
    status, barrier = get(f"{s2.base}/slice/barrier?group={group}")
    assert status == 200
    assert barrier["generation"] == 1
    assert barrier["expected"] == 2
    assert barrier["complete"] is False
    assert barrier["missing"] == ["default/workload-0",
                                  "default/workload-1"]
    assert barrier["stuck"] is False
    # the waiting barrier renders in /slicez
    _, slicez = get(f"{s2.base}/slicez")
    assert slicez["groups"][group]["barrier"]["expected"] == 2
    assert slicez["stuck_barriers"] == 0


def test_barrier_completes_into_plan_and_refuses_stale(s2):
    _, body = post(f"{s2.base}/addgpuslice", _target(range(2)))
    group = body["group"]
    status, out = _join(s2.base, group, 1, "default/workload-0",
                        "127.0.0.1:4000")
    assert status == 200 and out["complete"] is False
    # joining is idempotent: a re-join refreshes the address
    status, out = _join(s2.base, group, 1, "default/workload-0",
                        "127.0.0.1:4001")
    assert status == 200 and len(out["joined"]) == 1
    status, out = _join(s2.base, group, 1, "default/workload-1",
                        "127.0.0.1:5000")
    assert status == 200 and out["complete"] is True
    plan = out["plan"]
    assert plan["members"] == ["default/workload-0", "default/workload-1"]
    assert plan["num_processes"] == 2
    assert plan["coordinator"] == "127.0.0.1:4001"
    # a completed barrier no longer renders in /slicez
    _, slicez = get(f"{s2.base}/slicez")
    assert "barrier" not in slicez["groups"][group]
    # resize bumps to generation 2 → the old generation is refused
    status, body = post(f"{s2.base}/slice/resize", {"pods": pods([0])})
    assert status == 200 and body["generation"] == 2
    status, out = _join(s2.base, group, 1, "default/workload-0")
    assert status == 409 and out["result"] == "StaleGeneration"
    assert out["current"] == 2
    status, out = _join(s2.base, group, 7, "default/workload-0")
    assert status == 409 and out["result"] == "UnknownGeneration"
    status, out = _join(s2.base, group, 2, "default/workload-1")
    assert status == 403 and out["result"] == "NotAMember"
    status, out = post(f"{s2.base}/slice/barrier",
                       {"group": group, "generation": "x",
                        "member": "default/workload-0"})
    assert status == 400
    status, out = get(f"{s2.base}/slice/barrier")
    assert status == 400 and out["result"] == "BadRequest"


def test_new_generation_supersedes_incomplete_barrier(tmp_path):
    s = stack(tmp_path, hosts=3, n_chips=2)
    try:
        _, body = post(f"{s.base}/addgpuslice", _target(range(2)))
        group = body["group"]
        status, _ = _join(s.base, group, 1, "default/workload-0")
        assert status == 200
        superseded0 = REGISTRY.slice_barriers.series().get(
            (("transition", "superseded"),), 0.0)
        events0 = EVENTS.snapshot(limit=-1)["seq"]
        _, body = post(f"{s.base}/slice/resize", _target(range(3)))
        assert body["generation"] == 2
        _, barrier = get(f"{s.base}/slice/barrier?group={group}")
        assert barrier["generation"] == 2
        assert barrier["joined"] == []          # joins restart
        assert barrier["expected"] == 3
        superseded1 = REGISTRY.slice_barriers.series().get(
            (("transition", "superseded"),), 0.0)
        assert superseded1 == superseded0 + 1
        tail = [e for e in EVENTS.snapshot(since=events0,
                                           limit=-1)["events"]
                if e["kind"] == "slice_barrier"
                and e["attrs"].get("group") == group
                and e["attrs"].get("transition") == "superseded"]
        assert len(tail) == 1 and tail[0]["attrs"]["generation"] == 1
        assert tail[0]["attrs"]["superseded_by"] == 2
        invariants(s)
    finally:
        s.close()


def test_stuck_barrier_surfaces_in_slicez(tmp_path):
    s = stack(tmp_path, hosts=2, n_chips=2,
              broker_config=BrokerConfig(resize_barrier_timeout_s=0.05))
    try:
        _, body = post(f"{s.base}/addgpuslice", _target(range(2)))
        group = body["group"]
        _join(s.base, group, 1, "default/workload-0")
        time.sleep(0.1)
        _, barrier = get(f"{s.base}/slice/barrier?group={group}")
        assert barrier["stuck"] is True
        assert barrier["missing"] == ["default/workload-1"]
        _, slicez = get(f"{s.base}/slicez")
        assert slicez["stuck_barriers"] == 1
        assert slicez["groups"][group]["barrier"]["missing"] == \
            ["default/workload-1"]
        invariants(s)
    finally:
        s.close()


def test_barrier_rearms_lazily_after_state_loss(s2):
    """A restarted master has no barrier state, but a member's join
    lazily re-arms one at the group's CURRENT generation from the lease
    table — the control plane stays the source of truth."""
    _, body = post(f"{s2.base}/addgpuslice", _target(range(2)))
    group = body["group"]
    manager = s2.gateway.slices
    with manager._lock:                   # "restart": in-memory loss
        manager._barriers.clear()
    status, out = _join(s2.base, group, 1, "default/workload-1")
    assert status == 200
    assert out["generation"] == 1
    assert out["joined"] == ["default/workload-1"]
    status, out = _join(s2.base, group, 0, "default/workload-1")
    assert status == 409


def test_teardown_retires_the_barrier(s2):
    _, body = post(f"{s2.base}/addgpuslice", _target(range(2)))
    group = body["group"]
    post(f"{s2.base}/removegpuslice", _target(range(2)))
    s2.gateway.slices.export_gauges()
    status, _ = get(f"{s2.base}/slice/barrier?group={group}")
    assert status == 404
    assert REGISTRY.slice_barriers_incomplete.value() == 0
    # a member mid-refederation when the group vanished gets the clean
    # resized-out exit, not a transport-error crash
    client = fed.BarrierClient(s2.base, group, "default/workload-0")
    with pytest.raises(fed.MembershipRefusedError):
        client.join(1, "127.0.0.1:4000")
