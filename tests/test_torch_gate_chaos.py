"""The device gate's chaos plans of tests/test_gate_chaos.py, run through
both packages, and the companion baseline across a worker restart.

Three scenarios the gate exists to survive:

- an **open-fd holder after lease expiry**: the broker's reap finds the
  device busy and defers node cleanup — but gate access is cut within
  that SAME tick, so every re-open denies with the lease-expiry reason;
- a **worker killed mid-revoke** or **mid gate sync**: restart
  convergence re-derives desired map contents from attachment ground
  truth — no gate grant outlives its lease, no live lease loses its
  grant, and the pending gate record is resolved;
- a **backend fault mid-detach**: enforcement degrades to the legacy
  path without corrupting the gate's accounting.

What only GPUs have: every GPU shares ``nvidiactl`` and the uvm pair, and
a detach revokes them only when the container did not hold them before
its first grant. That baseline is journaled, so a restarted worker's gate
revokes exactly what the live one would have (a container that held none
keeps none; one that held them keeps them)."""

import os
import time

import pytest

from tests.test_torch_broker import BrokerStack, add
from tests.torch_control_plane import (BOTH, IDS, JAX, TORCH, norm_path,
                                       norm_result)


@pytest.fixture(params=BOTH, ids=IDS)
def pkg(request):
    return request.param


@pytest.fixture
def chaos(pkg, tmp_path):
    rig = pkg.mod("testing.chaos").ChaosRig(pkg.host(tmp_path), n_chips=4,
                                            gate="fake")
    yield rig
    rig.close()


def _gate_key(rig):
    keys = rig.gate_backend.keys()
    assert keys, "no gated container"
    return keys[0]


def _majmin(pkg, i=0) -> tuple[int, int]:
    gpu = pkg.mod("device.fake").make_chips(i + 1)[i]
    return gpu.major, gpu.minor


def _add(pkg, rig, n, rid):
    return pkg.add(rig.service, "workload", "default", n, False,
                   request_id=rid)


def _remove(pkg, rig, rid):
    return pkg.remove(rig.service, "workload", "default", [], False,
                      request_id=rid)


# -- expired lease => deny-on-open within one broker tick ----------------------

def test_open_fd_holder_denied_within_one_tick_of_expiry(pkg, tmp_path):
    stack = BrokerStack(pkg, tmp_path,
                        pkg.mod("master.admission").BrokerConfig(
                            lease_ttl_s=0.3), gate="fake")
    try:
        rig, gw = stack.rig, stack.gateway
        status, body = add(gw, "workload", 1)
        assert status == 200
        path = body["device_paths"][0]
        key = _gate_key(rig)
        major, minor = _majmin(pkg)
        # a workload process holds the device open
        rig.sim.enumerator.busy_pids = {path: [rig.pid]}
        assert rig.gate.try_open(key, major, minor)
        time.sleep(0.35)
        syncs_before = rig.gate_backend.sync_calls
        assert gw.broker.tick() == 0          # busy: node cleanup deferred
        # ...but within that ONE tick, gate access is cut:
        assert not rig.gate.try_open(key, major, minor)
        recent = rig.gate.snapshot()["denials"]["recent"]
        assert recent[-1]["reason"] == "revoked:lease-expired"
        # an in-place map update: no legacy deny-file write
        assert rig.gate_backend.sync_calls > syncs_before
        assert not os.path.exists(os.path.join(rig.cgroup_dir,
                                               "devices.deny"))
        # holder exits; the deferred reap completes past the backoff and
        # the gate ends empty, matching ground truth
        rig.sim.enumerator.busy_pids = {}
        time.sleep(2.1)
        assert gw.broker.tick() == 1
        assert rig.gate.granted_uuids() == set()
        assert rig.sim.slave_pods() == []
    finally:
        stack.close()


# -- crash mid-revoke / mid gate sync converges on restart ---------------------

def test_crash_mid_revoke_converges_on_restart(pkg, chaos):
    """Killed between the gate revoke and the node unlink: restart
    convergence re-grants (the lease still stands), and the retried
    detach then completes to empty."""
    mod = pkg.mod("testing.chaos")
    rig = chaos.rig
    out = _add(pkg, rig, 2, "r1")
    assert norm_result(out.result) == "SUCCESS"
    uuids = {c.uuid for c in out.chips}
    key = _gate_key(rig)
    major, minor = _majmin(pkg)
    chaos.arm_crash("mid_revoke")
    with pytest.raises(mod.WorkerCrash):
        _remove(pkg, rig, "r2")
    # the crash window: access already revoked, nodes still linked
    assert not rig.gate.try_open(key, major, minor)
    replay = chaos.restart_worker()
    assert replay.get("gate_restored", 0) >= 1
    assert rig.gate.granted_uuids() == uuids
    assert rig.gate.try_open(key, major, minor)
    mod.assert_invariants(rig, uuids, max_attached_events=1)
    assert norm_result(_remove(pkg, rig, "r2").result) == "SUCCESS"
    assert rig.gate.granted_uuids() == set()
    mod.assert_invariants(rig, set(), max_attached_events=1)


def test_crash_before_commit_replay_completes_attach_with_gate(pkg, chaos):
    mod = pkg.mod("testing.chaos")
    rig = chaos.rig
    chaos.arm_crash("before_commit")
    with pytest.raises(mod.WorkerCrash):
        _add(pkg, rig, 2, "r1")
    replay = chaos.restart_worker()
    assert replay.get("completed") == 1
    granted = rig.gate.granted_uuids()
    assert len(granted) == 2
    mod.assert_invariants(rig, granted, max_attached_events=1)


def test_crash_mid_gate_sync_leaves_pending_record_replay_resolves(pkg,
                                                                  chaos):
    """Killed INSIDE the gate backend mutation: the gate journal record
    is on disk, its commit is not. Restart convergence re-grants and
    resolves the pending record."""
    mod = pkg.mod("testing.chaos")
    rig = chaos.rig
    out = _add(pkg, rig, 2, "r1")
    assert norm_result(out.result) == "SUCCESS"
    uuids = {c.uuid for c in out.chips}
    chaos.arm_crash("mid_gate_sync")
    with pytest.raises(mod.WorkerCrash):
        _remove(pkg, rig, "r2")
    assert rig.journal.pending_gates()           # intent without commit
    replay = chaos.restart_worker()
    assert replay.get("gate_restored", 0) >= 1
    assert not rig.journal.pending_gates()       # resolved by convergence
    assert rig.gate.granted_uuids() == uuids
    mod.assert_invariants(rig, uuids, max_attached_events=1)
    assert norm_result(_remove(pkg, rig, "r2").result) == "SUCCESS"
    assert rig.gate.granted_uuids() == set()
    mod.assert_invariants(rig, set(), max_attached_events=1)


def test_backend_fault_mid_detach_degrades_and_invariants_hold(pkg, chaos):
    rig = chaos.rig
    registry = pkg.registry
    assert norm_result(_add(pkg, rig, 2, "r1").result) == "SUCCESS"
    faults_before = registry.gate_syncs.value(backend="fake",
                                              outcome="fault")
    rig.gate_backend.fail_ops = 1
    assert norm_result(_remove(pkg, rig, "r2").result) == "SUCCESS"
    assert registry.gate_syncs.value(
        backend="fake", outcome="fault") - faults_before == 1
    assert rig.gate.granted_uuids() == set()
    assert rig.gate.snapshot()["counts"]["faults"] == 1
    pkg.mod("testing.chaos").assert_invariants(rig, set(),
                                               max_attached_events=1)


# -- the companion baseline across a worker restart ----------------------------

def _access(pkg, rig, gate: str) -> list[str]:
    """Device roles the container may open now: the live gate map's
    device rules, or (legacy) the v1 allow lines less the deny lines."""
    universe = {}
    for gpu in rig.sim.enumerator.enumerate():
        universe[(gpu.major, gpu.minor)] = norm_path(gpu.device_path)
        for c in gpu.companions:
            universe[(c.major, c.minor)] = norm_path(c.host_path)
    if gate == "fake":
        live, _opens, _denies = rig.gate_backend.read(_gate_key(rig))
        pairs = {(major, minor) for _t, major, minor in live}
    else:
        def lines(name):
            path = os.path.join(rig.cgroup_dir, name)
            if not os.path.exists(path):
                return set()
            with open(path) as f:
                return {tuple(int(x) for x in line.split()[1].split(":"))
                        for line in f.read().splitlines()}
        pairs = lines("devices.allow") - lines("devices.deny")
    return sorted(universe[mm] for mm in pairs if mm in universe)


def _nodes(rig) -> list[str]:
    dev = os.path.join(rig.host.proc_root, str(rig.pid), "root", "dev")
    return sorted(norm_path(n) for n in os.listdir(dev)
                  if not n.endswith(".majmin"))


def _attach_restart_detach(pkg, root, gate: str, restarts: int,
                           held=()) -> tuple[list[str], list[str], dict]:
    chaos = pkg.mod("testing.chaos").ChaosRig(
        pkg.host(root), n_chips=4, actuator="procroot",
        gate="fake" if gate == "fake" else False)
    try:
        rig = chaos.rig
        dev = os.path.join(rig.host.proc_root, str(rig.pid), "root", "dev")
        for path, major, minor in held:      # the runtime's own nodes
            node = os.path.join(dev, os.path.basename(path))
            open(node, "w").close()
            with open(node + ".majmin", "w") as f:
                f.write(f"{major}:{minor}")
        assert norm_result(_add(pkg, rig, 1, "a").result) == "SUCCESS"
        replays = {}
        for i in range(restarts):
            replays[i] = chaos.restart_worker()
        snapshot = rig.journal.snapshot()
        assert norm_result(_remove(pkg, rig, "d").result) == "SUCCESS"
        return _access(pkg, rig, gate), _nodes(rig), snapshot
    finally:
        chaos.close()


@pytest.mark.parametrize("restarts", [0, 1, 2])
@pytest.mark.parametrize("gate", ["fake", "legacy"])
def test_no_companion_outlives_a_detach_across_restarts(tmp_path, gate,
                                                        restarts):
    """Attach one device to a container that held none, restart the
    worker (twice: the second restart reads a compacted journal), detach:
    both packages leave the container no device access and no node. The
    port's companions (``nvidiactl``, the uvm pair) go with the GPU, as
    without the restart."""
    runs = {p.name: _attach_restart_detach(p, tmp_path / p.name, gate,
                                           restarts) for p in BOTH}
    assert runs["jax"][:2] == runs["torch"][:2] == ([], [])
    # the baseline records stay out of /journalz
    assert not [r for r in runs["torch"][2]["records"]
                if "held" in r or r.get("state") is None]


@pytest.mark.parametrize("restarts", [0, 1, 2])
@pytest.mark.parametrize("gate", ["fake", "legacy"])
def test_companions_held_at_creation_survive_restart_and_detach(
        tmp_path, gate, restarts):
    """A container the runtime gave ``nvidiactl`` and the uvm pair keeps
    them across the worker's restarts and the hot-attached GPU's
    detach."""
    from gpumounter_tpu_torch.device.fake import FAKE_COMPANIONS
    held = [(c.host_path, c.major, c.minor) for c in FAKE_COMPANIONS]
    access, nodes, _ = _attach_restart_detach(TORCH, tmp_path, gate,
                                              restarts, held=held)
    assert nodes == access == ["ctl", "uvm", "uvm-tools"]


def test_baselines_are_journaled_and_compacted_by_container(tmp_path):
    """The baseline record's life: written at the first grant, read back
    by a fresh journal, kept by ``compact`` while the container's cgroup
    dir exists, dropped with it."""
    journal_mod = TORCH.mod("worker.journal")
    key = str(tmp_path / "cg" / "ctr")
    os.makedirs(key)
    journal = journal_mod.AttachJournal(str(tmp_path / "j.jsonl"))
    journal.record_baseline(key, {(195, 255)})
    journal.record_baseline(str(tmp_path / "gone"), None)
    assert journal.backlog() == 0 and journal.snapshot()["records"] == []
    reread = journal_mod.AttachJournal(journal.path)
    assert reread.baselines() == {key: {(195, 255)},
                                  str(tmp_path / "gone"): None}
    reread.compact()
    assert journal_mod.AttachJournal(journal.path).baselines() == {
        key: {(195, 255)}}
    reread.drop_baseline(key)
    assert journal_mod.AttachJournal(journal.path).baselines() == {}


def test_the_control_planes_gate_needs_no_baseline():
    """The control plane revokes every node a detached chip brings that no
    remaining chip needs, restart or not: a TPU chip has no shared
    companion, so there is no baseline to keep."""
    gpu = JAX.mod("device.fake").make_chips(1)[0]
    assert not getattr(gpu, "companions", ())
