"""The worker's AddGPU/RemoveGPU flows, through both packages: the cases of
tests/test_worker_service.py that tests/test_torch_worker.py does not hold
(the entire mount's one slave pod, single mounts composing, the full
round trip, the empty-uuid detach, the detach answers, the lagging
kubelet's LIST per round, and the event audit trail). Event reasons
follow the device: ``GPUAttached`` where the control plane posts
``TPUAttached`` (ROADMAP Queue 3)."""

import os
import time

import pytest

from tests.torch_control_plane import (BOTH, IDS, JAX, TORCH, norm_path,
                                       norm_result, norm_text)

COMPANIONS = {"ctl", "uvm", "uvm-tools"}


@pytest.fixture(params=BOTH, ids=IDS)
def pkg(request):
    return request.param


@pytest.fixture
def rig(pkg, tmp_path):
    r = pkg.rig(tmp_path)
    yield r
    r.close()


def _devices(entries) -> list[str]:
    return [norm_path(e[1]) for e in entries
            if norm_path(e[1]) not in COMPANIONS]


def test_add_entire_mount_one_slave_pod(pkg, rig):
    out = pkg.add(rig.service, "workload", "default", 4, True)
    assert norm_result(out.result) == "SUCCESS"
    assert len(out.chips) == 4 and len(rig.sim.slave_pods()) == 1


def test_add_pod_not_running_names_the_phase(pkg, rig):
    rig.sim.kube.set_pod_status("default", "workload", phase="Pending")
    out = pkg.add(rig.service, "workload", "default", 1, False)
    assert norm_result(out.result) == "POD_NOT_FOUND"
    assert "Pending" in out.message


def test_add_single_then_single_composes(pkg, rig):
    for _ in range(2):
        assert norm_result(pkg.add(rig.service, "workload", "default", 1,
                                   False).result) == "SUCCESS"
    assert len(rig.sim.slave_pods()) == 2
    with pytest.raises(pkg.errors.MountPolicyError):
        pkg.add(rig.service, "workload", "default", 2, True)


def test_add_rollback_frees_the_devices(pkg, rig):
    rig.actuator.fail_on_create = True
    with pytest.raises(pkg.errors.ActuationError):
        pkg.add(rig.service, "workload", "default", 2, False)
    assert rig.sim.slave_pods() == []
    assert rig.sim.podresources.assignments == {}
    rig.actuator.fail_on_create = False
    assert norm_result(pkg.add(rig.service, "workload", "default", 4,
                               True).result) == "SUCCESS"


def test_remove_full_roundtrip(pkg, rig):
    added = pkg.add(rig.service, "workload", "default", 2, False)
    out = pkg.remove(rig.service, "workload", "default",
                     [c.uuid for c in added.chips], False)
    assert norm_result(out.result) == "SUCCESS"
    assert rig.sim.slave_pods() == []
    assert _devices(rig.actuator.removed) == ["dev0", "dev1"]
    assert os.path.exists(os.path.join(rig.cgroup_dir, "devices.deny"))
    assert norm_result(pkg.add(rig.service, "workload", "default", 1,
                               True).result) == "SUCCESS"


def test_remove_empty_uuids_removes_all(pkg, rig):
    pkg.add(rig.service, "workload", "default", 2, False)
    out = pkg.remove(rig.service, "workload", "default", [], False)
    assert norm_result(out.result) == "SUCCESS"
    assert rig.sim.slave_pods() == []


@pytest.mark.parametrize("name,attach,uuids,expect", [
    ("ghost", 0, [], "POD_NOT_FOUND"),
    ("workload", 0, [], "NOT_FOUND"),           # nothing mounted
    ("workload", 1, ["bogus"], "NOT_FOUND"),
])
def test_remove_answers(pkg, rig, name, attach, uuids, expect):
    if attach:
        pkg.add(rig.service, "workload", "default", attach, False)
    out = pkg.remove(rig.service, name, "default", uuids, False)
    assert norm_result(out.result) == expect


def test_lag_retry_lists_once_per_round_not_per_pod(pkg, tmp_path):
    """Four one-device slave pods behind a lagging kubelet: each retry
    round is one LIST for all of them."""
    rig = pkg.rig(tmp_path, n_chips=4, kubelet_lag_s=0.5)
    try:
        rig.sim.podresources.list_calls = 0
        out = pkg.add(rig.service, "workload", "default", 4, False)
        assert norm_result(out.result) == "SUCCESS"
        assert rig.sim.podresources.list_calls <= 6
    finally:
        rig.close()


def _wait_events(rig, n, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if len(rig.sim.kube.events) >= n:
            return
        time.sleep(0.01)
    raise AssertionError(f"only {len(rig.sim.kube.events)} events after "
                         f"{timeout}s")


def _events_transcript(pkg, rig) -> list:
    """Attach, detach, a refused attach twice, then a broken events API."""
    events = rig.sim.kube.events
    out = []

    def event(e):
        return (norm_text(e["reason"]), e["type"],
                e["involvedObject"]["name"], norm_text(
                    e["source"]["component"].replace(pkg.dev, "<dev>")))
    assert norm_result(pkg.add(rig.service, "workload", "default", 2,
                               True).result) == "SUCCESS"
    _wait_events(rig, 1)
    out.append(event(events[0]))
    out.append(events[0]["message"].replace(pkg.dev.upper(), "<DEV>"))
    assert norm_result(pkg.remove(rig.service, "workload", "default", [],
                                  False).result) == "SUCCESS"
    _wait_events(rig, 2)
    out.append(event(events[1]))
    for _ in range(2):              # a repeated warning is suppressed
        assert norm_result(pkg.add(rig.service, "workload", "default", 99,
                                   False).result) == "INSUFFICIENT"
        _wait_events(rig, 3)
    time.sleep(0.2)
    out.append([event(e) for e in events[2:]])
    calls = []

    def broken(ns, ev):
        calls.append(norm_text(ev["reason"]))
        raise RuntimeError("rbac denied")
    rig.sim.kube.create_event = broken
    assert norm_result(pkg.add(rig.service, "workload", "default", 1,
                               False).result) == "SUCCESS"
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline and not calls:
        time.sleep(0.01)
    out.append((calls, len(events)))
    return out


def test_events_audit_trail(pkg, rig):
    out = _events_transcript(pkg, rig)
    attached, message, detached, failed, broken = out
    assert attached == ("<DEV>Attached", "Normal", "workload",
                        "<dev>-mounter-worker")
    assert "2 <DEV>" in message
    assert detached[:2] == ("<DEV>Detached", "Normal")
    assert [f[:2] for f in failed] == [("<DEV>AttachFailed", "Warning")]
    assert broken == (["<DEV>Attached"], 3)     # posted, raised, swallowed


def test_events_transcripts_agree(tmp_path):
    out = {}
    for pkg in (JAX, TORCH):
        rig = pkg.rig(tmp_path / pkg.name)
        try:
            out[pkg.name] = _events_transcript(pkg, rig)
        finally:
            rig.close()
    # the message names the device kind in the package's own words
    jax_msg, torch_msg = out["jax"].pop(1), out["torch"].pop(1)
    assert "2 <DEV> chip(s)" in jax_msg and "2 <DEV>" in torch_msg
    assert out["torch"] == out["jax"]
