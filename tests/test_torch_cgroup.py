"""Cgroup paths, QoS, version detection and the v1/v2 device writes,
through both packages (the counterpart of tests/test_cgroup.py;
tests/test_torch_actuation.py holds the resolver paths and a few v1
writes). The v2 cases run over a recording gate. Devices that share a
companion are each package's own: ``/dev/vfio/vfio`` for the control
plane's chips, the port's companions for every GPU."""

import builtins
import os
import shutil

import pytest

from tests.test_cgroup import UID, mk_pod
from tests.torch_control_plane import BOTH, IDS, sharing_devices

CID = "containerd://" + "ab" * 32


@pytest.fixture(params=BOTH, ids=IDS)
def pkg(request):
    return request.param


@pytest.fixture
def cgroup(pkg):
    return pkg.mod("actuation.cgroup")


@pytest.fixture
def host(pkg, tmp_path):
    return pkg.host(tmp_path)


def _chips(pkg, n):
    return pkg.mod("device.fake").make_chips(n)


def _companion_lines(chips):
    seen = []
    for chip in chips:
        for c in getattr(chip, "companions", ()):
            if f"c {c.major}:{c.minor} rw" not in seen:
                seen.append(f"c {c.major}:{c.minor} rw")
    return seen


# -- QoS and paths (ref cgroup.go:52-237) ---------------------------------------

@pytest.mark.parametrize("spec,reported,want", [
    ("guaranteed", None, "QOS_GUARANTEED"),
    ("burstable", None, "QOS_BURSTABLE"),
    ("none", None, "QOS_BEST_EFFORT"),
])
def test_qos_computed(pkg, spec, reported, want):
    objects = pkg.mod("k8s.objects")
    assert objects.compute_qos_class(mk_pod(qos_spec=spec)) == \
        getattr(objects, want)


def test_qos_prefers_kubelet_reported(pkg):
    pod = mk_pod(qos_reported="Burstable", qos_spec="guaranteed")
    assert pkg.mod("k8s.objects").qos_class(pod) == "Burstable"


def test_cgroupfs_paths_per_qos(cgroup):
    r = cgroup.CgroupResolver("cgroupfs")
    assert r.pod_cgroup(mk_pod(qos_reported="Guaranteed")) == \
        f"kubepods/pod{UID}"
    assert r.pod_cgroup(mk_pod(qos_reported="Burstable")) == \
        f"kubepods/burstable/pod{UID}"
    assert r.pod_cgroup(mk_pod(qos_reported="BestEffort")) == \
        f"kubepods/besteffort/pod{UID}"
    assert r.container_cgroup(mk_pod(qos_reported="Guaranteed"),
                              "docker://" + "cd" * 32) == \
        f"kubepods/pod{UID}/{'cd' * 32}"


def test_systemd_paths_and_scopes(cgroup):
    r = cgroup.CgroupResolver("systemd")
    uid_r = UID.replace("-", "_")
    assert r.pod_cgroup(mk_pod(qos_reported="Guaranteed")) == \
        f"kubepods.slice/kubepods-pod{uid_r}.slice"
    assert r.pod_cgroup(mk_pod(qos_reported="Burstable")) == \
        (f"kubepods.slice/kubepods-burstable.slice/"
         f"kubepods-burstable-pod{uid_r}.slice")
    pod = mk_pod(qos_reported="Guaranteed")
    base, hexid = r.pod_cgroup(pod), "ef" * 32
    for cid, scope in ((f"containerd://{hexid}", "cri-containerd"),
                       (f"docker://{hexid}", "docker"),
                       (f"cri-o://{hexid}", "crio"),
                       (hexid, "cri-containerd")):     # bare: containerd
        assert r.container_cgroup(pod, cid) == f"{base}/{scope}-{hexid}.scope"


def test_bad_driver_rejected(pkg, cgroup):
    with pytest.raises(pkg.errors.CgroupError):
        cgroup.CgroupResolver("bogus")


def test_detect_version(cgroup, tmp_path):
    assert cgroup.detect_cgroup_version(str(tmp_path)) == 1
    open(tmp_path / "cgroup.controllers", "w").close()
    assert cgroup.detect_cgroup_version(str(tmp_path)) == 2


# -- v1 writes (ref cgroup.go:143-169) ------------------------------------------

@pytest.fixture
def v1_setup(cgroup, host):
    pod = mk_pod(qos_reported="Guaranteed")
    ctrl = cgroup.CgroupDeviceController(host, driver="cgroupfs", version=1)
    cdir = ctrl.container_dir(pod, CID)
    os.makedirs(cdir)
    return pod, ctrl, cdir


def _lines(cdir, name):
    with open(os.path.join(cdir, name)) as f:
        return f.read().splitlines()


def test_v1_allow_and_deny_writes(pkg, v1_setup):
    pod, ctrl, cdir = v1_setup
    chips = _chips(pkg, 2)
    ctrl.sync_device_access(pod, CID, chips)
    lines = _lines(cdir, "devices.allow")
    devices = [f"c {pkg.major}:0 rw", f"c {pkg.major}:1 rw"]
    assert [x for x in lines if x in devices] == devices
    assert sorted(x for x in lines if x not in devices) == \
        sorted(_companion_lines(chips))
    ctrl.revoke_device_access(pod, CID, [chips[0]], [chips[1]])
    assert _lines(cdir, "devices.deny") == [f"c {pkg.major}:0 rw"]


def test_v1_missing_cgroup_raises(pkg, cgroup, host):
    ctrl = cgroup.CgroupDeviceController(host, driver="cgroupfs", version=1)
    with pytest.raises(pkg.errors.CgroupError):
        ctrl.sync_device_access(mk_pod(qos_reported="Guaranteed"), CID,
                                _chips(pkg, 1))


def test_get_pids(pkg, v1_setup):
    pod, ctrl, cdir = v1_setup
    with open(os.path.join(cdir, "cgroup.procs"), "w") as f:
        f.write("100\n200\n300\n")
    assert ctrl.get_pids(pod, CID) == [100, 200, 300]
    with pytest.raises(pkg.errors.CgroupError):
        ctrl.get_pids(pod, "containerd://" + "00" * 32)


def test_v1_allow_covers_shared_companions_once(pkg, v1_setup):
    pod, ctrl, cdir = v1_setup
    chips = sharing_devices(pkg, 2)
    ctrl.sync_device_access(pod, CID, chips)
    first, second = (f"c {c.major}:{c.minor} rw" for c in chips)
    assert _lines(cdir, "devices.allow") == \
        [first, *_companion_lines(chips), second]
    ctrl.revoke_device_access(pod, CID, [chips[0]], [chips[1]])
    assert _lines(cdir, "devices.deny") == [first]   # companions stay


def test_v1_batch_issues_one_write_syscall_per_rule(pkg, v1_setup):
    """devices.allow parses one rule per write(2): the writer flushes each
    entry and never coalesces the batch."""
    pod, ctrl, _cdir = v1_setup
    chips = sharing_devices(pkg, 3)
    flushed: list[str] = []
    real_open = builtins.open

    def spying_open(path, mode="r", *args, **kwargs):
        f = real_open(path, mode, *args, **kwargs)
        if not (str(path).endswith("devices.allow") and "a" in mode):
            return f
        buffered: list[str] = []

        class Spy:
            def write(self, data):
                buffered.append(data)
                return f.write(data)

            def flush(self):
                flushed.append("".join(buffered))
                buffered.clear()
                return f.flush()

            def __enter__(self):
                return self

            def __exit__(self, *exc):
                if buffered:
                    flushed.append("".join(buffered))
                f.close()

            def __getattr__(self, name):
                return getattr(f, name)
        return Spy()
    builtins.open = spying_open
    try:
        ctrl.sync_device_access(pod, CID, chips)
    finally:
        builtins.open = real_open
    assert len(flushed) == 3 + len(_companion_lines(chips)), flushed
    assert all(chunk.count("\n") == 1 for chunk in flushed), flushed


# -- v2: the BPF sync wiring over a recording gate -----------------------------

class RecordingGate:
    def __init__(self):
        self.calls, self.rules = [], []

    def sync(self, cgroup_dir, rules):
        self.calls.append((cgroup_dir, len(rules)))
        self.rules.append(list(rules))
        return 1


def give_live_pid(host, cdir, pid=4242, dev_nodes=()):
    """One live pid whose /proc/<pid>/root/dev holds ``dev_nodes`` as fake
    device files with .majmin sidecars."""
    with open(os.path.join(cdir, "cgroup.procs"), "w") as f:
        f.write(f"{pid}\n")
    droot = os.path.join(host.proc_root, str(pid), "root", "dev")
    os.makedirs(droot, exist_ok=True)
    for name, major, minor in dev_nodes:
        path = os.path.join(droot, name)
        open(path, "w").close()
        with open(path + ".majmin", "w") as f:
            f.write(f"{major}:{minor}")
    return pid


@pytest.fixture
def v2_setup(cgroup, host):
    pod = mk_pod(qos_reported="Guaranteed")
    gate = RecordingGate()
    ctrl = cgroup.CgroupDeviceController(host, driver="systemd", version=2,
                                         bpf_gate=gate)
    cdir = ctrl.container_dir(pod, CID)
    os.makedirs(cdir)
    return pod, ctrl, gate, cdir


def _majmins(gate):
    return {(r.major, r.minor) for r in gate.rules[-1]}


def test_v2_sync_passes_full_ruleset(pkg, host, v2_setup):
    defaults = len(pkg.mod("actuation.bpf").CONTAINER_DEFAULT_RULES)
    pod, ctrl, gate, cdir = v2_setup
    give_live_pid(host, cdir)
    chips = _chips(pkg, 4)
    companions = len(_companion_lines(chips))
    ctrl.sync_device_access(pod, CID, chips)
    assert gate.calls == [(cdir, defaults + 4 + companions)]
    ctrl.revoke_device_access(pod, CID, chips[1:], chips[:1])
    assert gate.calls[-1] == (cdir, defaults + 1 + companions)


def test_v2_missing_cgroup_raises(pkg, cgroup, host):
    ctrl = cgroup.CgroupDeviceController(host, driver="systemd", version=2,
                                         bpf_gate=RecordingGate())
    with pytest.raises(pkg.errors.CgroupError):
        ctrl.sync_device_access(mk_pod(qos_reported="Guaranteed"), CID,
                                _chips(pkg, 1))


def test_v2_revoke_excludes_detached_chip_still_in_dev(pkg, host, v2_setup):
    pod, ctrl, gate, cdir = v2_setup
    chips = _chips(pkg, 2)
    give_live_pid(host, cdir, dev_nodes=[
        (os.path.basename(c.device_path), c.major, c.minor) for c in chips]
        + [("fuse", 10, 229)])
    ctrl.revoke_device_access(pod, CID, [chips[0]], [chips[1]])
    majmins = _majmins(gate)
    assert (pkg.major, 0) not in majmins
    assert (pkg.major, 1) in majmins and (10, 229) in majmins


def test_v2_revoke_keeps_shared_companion(pkg, host, v2_setup):
    pod, ctrl, gate, cdir = v2_setup
    chips = sharing_devices(pkg, 2)
    comps = {(c.major, c.minor) for c in chips[0].companions}
    give_live_pid(host, cdir, dev_nodes=[
        (f"node{i}", c.major, c.minor) for i, c in enumerate(chips)] + [
        (f"comp{i}", major, minor) for i, (major, minor) in
        enumerate(sorted(comps))])
    ctrl.revoke_device_access(pod, CID, [chips[0]], [chips[1]])
    majmins = _majmins(gate)
    assert (chips[0].major, chips[0].minor) not in majmins
    assert (chips[1].major, chips[1].minor) in majmins
    assert comps <= majmins                    # shared companions survive


def test_v2_sync_fails_closed_without_pid_or_cache(pkg, v2_setup):
    pod, ctrl, gate, _cdir = v2_setup
    with pytest.raises(pkg.errors.CgroupError, match="fail closed"):
        ctrl.sync_device_access(pod, CID, _chips(pkg, 1))
    assert gate.calls == []


def test_v2_sync_unreadable_dev_is_not_an_empty_baseline(pkg, host,
                                                         v2_setup):
    pod, ctrl, gate, cdir = v2_setup
    with open(os.path.join(cdir, "cgroup.procs"), "w") as f:
        f.write("4242\n")
    os.makedirs(os.path.join(host.proc_root, "4242"))     # no root/dev
    with pytest.raises(pkg.errors.CgroupError, match="fail closed"):
        ctrl.sync_device_access(pod, CID, _chips(pkg, 1))
    assert gate.calls == [] and ctrl._observed_cache == {}


def test_v2_sync_falls_back_to_cached_baseline(pkg, host, v2_setup):
    pod, ctrl, gate, cdir = v2_setup
    chips = _chips(pkg, 2)
    pid = give_live_pid(host, cdir, dev_nodes=[("fuse", 10, 229)])
    ctrl.sync_device_access(pod, CID, chips)
    assert (10, 229) in _majmins(gate)
    shutil.rmtree(os.path.join(host.proc_root, str(pid)))
    with open(os.path.join(cdir, "cgroup.procs"), "w") as f:
        f.write("")
    ctrl.revoke_device_access(pod, CID, [chips[0]], [chips[1]])
    majmins = _majmins(gate)
    assert (10, 229) in majmins
    assert (pkg.major, 0) not in majmins and (pkg.major, 1) in majmins
