"""The device gate against a live kernel, through both packages (the
counterpart of tests/test_bpf_kernel.py and tests/test_cgroup_v1_kernel.py).

The port builds its own ``native/build/libbpfgate.so`` and has its own
``actuation/cgroup.py``; here both packages' gates write into real cgroups
and the kernel's answer is read back: the attached program's instructions
run through the codegen tests' interpreter, real ``open(2)`` calls in a
cgroup, and the v1 ``devices.list``. The gates are the control plane's
files': the cgroup-v2 tests skip without root, or where no private cgroup2
can be mounted or the kernel refuses the program; the v1 tests skip
without root or a mounted v1 devices controller. They never fail for
want of a kernel.

Every cgroup a test makes is named for its own process and a random
suffix (the cgroup2 child, and the v1 pod and container), and the restart
walk is rooted in the test's own cgroup, so these tests, the control
plane's files and another checkout's run of this file may all run at the
same time on one kernel."""

import os
import subprocess

import pytest

from tests.test_torch_actuation import DEV_BLOCK, DEV_CHAR, interpret
from tests.torch_control_plane import BOTH, IDS, sharing_devices

ROOT = os.geteuid() == 0
DEVICES_ROOT = "/sys/fs/cgroup/devices"
HAS_V1 = os.path.exists(os.path.join(DEVICES_ROOT, "devices.list"))


@pytest.fixture(params=BOTH, ids=IDS)
def pkg(request):
    return request.param


# -- cgroup v2: the BPF program and its map ------------------------------------

@pytest.fixture
def cg2(tmp_path):
    """A private cgroup2 mount with one scratch child cgroup of a unique
    name, removed by the teardown alone (a cgroup2 mount shows the one
    kernel-wide hierarchy, where another run's children live too)."""
    if not ROOT:
        pytest.skip("kernel BPF tests need root")
    mnt = tmp_path / "cg2"
    mnt.mkdir()
    try:
        subprocess.run(["mount", "-t", "cgroup2", "none", str(mnt)],
                       check=True, capture_output=True)
        if not (mnt / "cgroup.controllers").exists():
            raise OSError("mount reported success but no cgroup2 appeared")
        child = mnt / (f"gpumounter-torch-test-{os.getpid()}-"
                       f"{os.urandom(4).hex()}")
        child.mkdir()
    except (subprocess.CalledProcessError, OSError) as e:
        subprocess.run(["umount", "-l", str(mnt)], capture_output=True)
        pytest.skip(f"cannot mount a private cgroup2 here: {e}")
    yield str(child)
    try:
        child.rmdir()
    except OSError:
        pass
    subprocess.run(["umount", str(mnt)], capture_output=True)
    subprocess.run(["umount", "-l", str(mnt)], capture_output=True)


@pytest.fixture
def bpf(pkg):
    return pkg.mod("actuation.bpf")


@pytest.fixture
def gate(bpf):
    g = bpf.BpfGate()
    if not g.supported():
        pytest.skip("kernel refuses CGROUP_DEVICE prog load (no CAP_BPF?)")
    return g


def _runtime_extra(bpf):
    """The non-default device a runtime may have granted (/dev/net/tun)."""
    return bpf.DeviceRule("c", bpf.ACC_RW, 10, 200)


def _attach_runtime_program(bpf, gate, cgroup):
    gate.attach(cgroup, list(bpf.CONTAINER_DEFAULT_RULES)
                + [_runtime_extra(bpf)])
    assert gate.attached_count(cgroup) == 1


def _chips(pkg, n):
    return pkg.mod("device.fake").make_chips(n)


def _companion_majmins(chips) -> set[tuple[int, int]]:
    return {(c.major, c.minor) for chip in chips
            for c in getattr(chip, "companions", ())}


def test_sync_replaces_and_preserves_nondefault_rule(pkg, bpf, gate, cg2):
    _attach_runtime_program(bpf, gate, cg2)
    chips = _chips(pkg, 2)
    observed = [bpf.DeviceRule("c", bpf.ACC_RWM, 10, 200)]
    rc = gate.sync(cg2, bpf.rules_for_chips(chips, observed=observed))
    assert rc == bpf.BpfGate.SYNC_OK
    assert gate.attached_count(cg2) == 1        # replaced, not stacked
    prog = gate.read_attached(cg2)
    assert interpret(prog, DEV_CHAR, bpf.ACC_RW, pkg.major, 0) == 1
    assert interpret(prog, DEV_CHAR, bpf.ACC_RW, pkg.major, 1) == 1
    for major, minor in _companion_majmins(chips):    # GPUs only
        assert interpret(prog, DEV_CHAR, bpf.ACC_RW, major, minor) == 1
    assert interpret(prog, DEV_CHAR, bpf.ACC_RW, 10, 200) == 1
    assert interpret(prog, DEV_CHAR, bpf.ACC_RWM, 1, 3) == 1   # /dev/null
    assert interpret(prog, DEV_CHAR, bpf.ACC_READ, 9, 9) == 0
    assert interpret(prog, DEV_BLOCK, bpf.ACC_READ, 8, 0) == 0


def test_sync_noop_when_no_program_attached(pkg, bpf, gate, cg2):
    rc = gate.sync(cg2, bpf.rules_for_chips(_chips(pkg, 1)))
    assert rc == bpf.BpfGate.SYNC_NOOP
    assert gate.attached_count(cg2) == 0


def test_sync_revoke_removes_chip_keeps_rest(pkg, bpf, gate, cg2):
    _attach_runtime_program(bpf, gate, cg2)
    observed = [bpf.DeviceRule("c", bpf.ACC_RWM, 10, 200)]
    chips = _chips(pkg, 1)
    assert gate.sync(cg2, bpf.rules_for_chips(chips,
                                              observed=observed)) == 1
    assert gate.sync(cg2, bpf.rules_for_chips([], observed=observed)) == 1
    prog = gate.read_attached(cg2)
    assert interpret(prog, DEV_CHAR, bpf.ACC_RW, pkg.major, 0) == 0
    assert interpret(prog, DEV_CHAR, bpf.ACC_RW, 10, 200) == 1
    assert interpret(prog, DEV_CHAR, bpf.ACC_RWM, 1, 3) == 1


def _mknod(path, major, minor):
    try:
        os.mknod(str(path), 0o666 | 0o020000, os.makedev(major, minor))
    except OSError as e:
        pytest.skip(f"mknod denied: {e}")


def test_observed_dev_scan_feeds_sync_end_to_end(pkg, bpf, gate, cg2,
                                                 tmp_path):
    proc_root = tmp_path / "proc"
    dev = proc_root / "4242" / "root" / "dev" / "net"
    dev.mkdir(parents=True)
    _mknod(dev / "tun", 10, 200)
    observed = bpf.container_device_rules(str(proc_root), 4242)
    assert bpf.DeviceRule("c", bpf.ACC_RWM, 10, 200) in observed
    _attach_runtime_program(bpf, gate, cg2)
    assert gate.sync(cg2, bpf.rules_for_chips(_chips(pkg, 1),
                                              observed=observed)) == 1
    prog = gate.read_attached(cg2)
    assert interpret(prog, DEV_CHAR, bpf.ACC_RW, 10, 200) == 1
    assert interpret(prog, DEV_CHAR, bpf.ACC_RW, pkg.major, 0) == 1


def test_production_revoke_with_chip_still_in_dev(pkg, bpf, gate, cg2,
                                                  tmp_path):
    """At detach time the device's node is still in the container's /dev:
    the production revoke, live /dev scan included, must deny the detached
    device while the remaining one and the runtime's extra survive."""
    uid = "22222222-3333-4444-5555-666666666666"
    cid_hex = "ef" * 32
    pod = {
        "metadata": {"name": "t", "namespace": "default", "uid": uid},
        "spec": {"containers": [{"name": "main", "resources": {
            "limits": {"cpu": "1", "memory": "1Gi"},
            "requests": {"cpu": "1", "memory": "1Gi"}}}]},
        "status": {"qosClass": "Guaranteed", "containerStatuses": [
            {"name": "main", "containerID": f"containerd://{cid_hex}"}]},
    }
    nested = [f"{cg2}/kubepods", f"{cg2}/kubepods/pod{uid}",
              f"{cg2}/kubepods/pod{uid}/{cid_hex}"]
    for d in nested:
        os.mkdir(d)
    container_cg = nested[-1]
    sleeper = subprocess.Popen(["sleep", "120"])
    dev = tmp_path / "proc" / str(sleeper.pid) / "root" / "dev"
    dev.mkdir(parents=True)
    chips = _chips(pkg, 2)
    try:
        for chip in chips:
            _mknod(dev / os.path.basename(chip.device_path), pkg.major,
                   chip.minor)
        for major, minor in _companion_majmins(chips):
            _mknod(dev / f"companion-{major}-{minor}", major, minor)
        _mknod(dev / "tun", 10, 200)
        with open(os.path.join(container_cg, "cgroup.procs"), "w") as f:
            f.write(str(sleeper.pid))
        _attach_runtime_program(bpf, gate, container_cg)
        host = pkg.mod("utils.config").HostPaths(
            proc_root=str(tmp_path / "proc"), cgroup_root=cg2)
        ctrl = pkg.mod("actuation.cgroup").CgroupDeviceController(
            host, driver="cgroupfs", version=2, bpf_gate=gate)
        ctrl.revoke_device_access(pod, f"containerd://{cid_hex}",
                                  [chips[0]], [chips[1]])
        prog = gate.read_attached(container_cg)
        assert interpret(prog, DEV_CHAR, bpf.ACC_RW, pkg.major, 0) == 0
        assert interpret(prog, DEV_CHAR, bpf.ACC_RW, pkg.major, 1) == 1
        for major, minor in _companion_majmins(chips):   # still needed
            assert interpret(prog, DEV_CHAR, bpf.ACC_RW, major, minor) == 1
        assert interpret(prog, DEV_CHAR, bpf.ACC_RW, 10, 200) == 1
        assert interpret(prog, DEV_CHAR, bpf.ACC_RWM, 1, 3) == 1
        assert interpret(prog, DEV_CHAR, bpf.ACC_READ, 9, 9) == 0
    finally:
        sleeper.kill()
        sleeper.wait()
        for d in reversed(nested):
            try:
                os.rmdir(d)
            except OSError:
                pass


def _in_cgroup_open(cgroup: str, path: str, flags=os.O_RDONLY) -> int:
    """fork a child, move it into the cgroup, try open(2); 0 on success,
    else the child's errno (EPERM: the device program denied it)."""
    pid = os.fork()
    if pid == 0:
        try:
            with open(os.path.join(cgroup, "cgroup.procs"), "w") as f:
                f.write(str(os.getpid()))
            os.close(os.open(path, flags))
            os._exit(0)
        except OSError as e:
            os._exit(e.errno or 99)
    return os.waitstatus_to_exitcode(os.waitpid(pid, 0)[1])


def test_map_gate_grant_revoke_and_exact_counters(bpf, gate, cg2):
    _attach_runtime_program(bpf, gate, cg2)
    rules = [bpf.DeviceRule("c", bpf.ACC_RWM, 1, 3),
             bpf.DeviceRule("c", bpf.ACC_READ, 1, None)]
    rc, map_fd = gate.map_attach(cg2, rules)
    assert rc == bpf.BpfGate.MAP_ATTACHED and map_fd >= 0
    assert gate.attached_count(cg2) == 1
    try:
        assert _in_cgroup_open(cg2, "/dev/null") == 0
        assert _in_cgroup_open(cg2, "/dev/null", os.O_RDWR) == 0
        assert _in_cgroup_open(cg2, "/dev/zero") == 0
        assert _in_cgroup_open(cg2, "/dev/zero", os.O_RDWR) == 1
        assert _in_cgroup_open(cg2, "/dev/tty") == 1
        gate.map_sync(map_fd, [bpf.DeviceRule("c", bpf.ACC_READ, 1, None)])
        assert gate.attached_count(cg2) == 1      # same program, new map
        assert _in_cgroup_open(cg2, "/dev/null", os.O_RDWR) == 1
        assert _in_cgroup_open(cg2, "/dev/null") == 0
        live, _opens, denies = gate.map_read(map_fd)
        assert {(r.dev_type, r.major, r.minor) for r in live} == \
            {("c", 1, None)}
        assert denies == 3
        rc2, map_fd2 = gate.map_attach(
            cg2, [bpf.DeviceRule("c", bpf.ACC_READ, 1, None)])
        assert rc2 == bpf.BpfGate.MAP_ADOPTED
        assert gate.map_read(map_fd2)[2] == denies
        gate.map_close(map_fd2)
    finally:
        gate.map_close(map_fd)


def test_map_gate_noop_on_unrestricted_cgroup(bpf, gate, cg2):
    rc, map_fd = gate.map_attach(cg2, [bpf.DeviceRule("c", bpf.ACC_RWM,
                                                      1, 3)])
    assert rc == bpf.BpfGate.MAP_NOOP and map_fd == -1
    assert gate.attached_count(cg2) == 0


def test_map_recover_discovers_previous_incarnations_maps(pkg, bpf, gate,
                                                          cg2):
    """A restarted worker (a fresh backend, no fd cache) walks the kubelet
    subtree and adopts a map that outlived its process."""
    rules = [bpf.DeviceRule("c", bpf.ACC_RWM, 1, 3),
             bpf.DeviceRule("c", bpf.ACC_RW, pkg.major, 0)]
    _attach_runtime_program(bpf, gate, cg2)
    rc, map_fd = gate.map_attach(cg2, rules)
    assert rc == bpf.BpfGate.MAP_ATTACHED
    gate.map_close(map_fd)                    # the old process died
    rc, fd = gate.map_recover(cg2)
    assert rc == bpf.BpfGate.MAP_ADOPTED and fd >= 0
    live, _opens, _denies = gate.map_read(fd)
    assert {(r.dev_type, r.major, r.minor) for r in live} == \
        {("c", 1, 3), ("c", pkg.major, 0)}
    gate.map_close(fd)
    assert gate.map_recover(os.path.dirname(cg2))[0] == \
        bpf.BpfGate.MAP_NOOP                  # ungated: nothing adopted
    root = os.path.join(cg2, "walk")
    kube_top = os.path.join(root, "kubepods")
    nested = os.path.join(kube_top, "pod-dead", "container-x")
    os.makedirs(nested)
    try:
        _attach_runtime_program(bpf, gate, nested)
        rc, map_fd = gate.map_attach(nested, rules)
        assert rc == bpf.BpfGate.MAP_ATTACHED
        gate.map_close(map_fd)
        backend = pkg.mod("actuation.gate").NativeGateBackend(
            gate, cgroup_root=root)
        assert backend.discover() == 1
        assert nested in backend.keys()
        live, _o, _d = backend.read(nested)
        assert ("c", pkg.major, 0) in live
        backend.remove(nested)
    finally:
        for d in (nested, os.path.dirname(nested), kube_top, root):
            try:
                os.rmdir(d)
            except OSError:
                pass


# -- cgroup v1: devices.allow / devices.deny -----------------------------------

def mk_pod(uid: str, cid: str) -> dict:
    return {
        "metadata": {"name": "train-pod", "namespace": "default",
                     "uid": uid},
        "spec": {"containers": [{"name": "main", "resources": {
            "limits": {"cpu": "1", "memory": "1Gi"},
            "requests": {"cpu": "1", "memory": "1Gi"}}}]},
        "status": {"containerStatuses": [
            {"name": "main", "containerID": cid}]},
    }


def _makedirs(leaf: str) -> None:
    """``os.makedirs``, again where another run's teardown removed a
    shared parent (``kubepods``) between two of its mkdirs."""
    for _ in range(10):
        try:
            os.makedirs(leaf, exist_ok=True)
            return
        except FileNotFoundError:
            continue
    os.makedirs(leaf, exist_ok=True)


@pytest.fixture
def controller(pkg):
    """(controller, the pod, its container id, the container's v1 leaf):
    a pod uid and container id of this run's own, so no other run reads or
    removes the leaf; the teardown removes the leaf and every parent left
    empty up to ``kubepods``."""
    if not (ROOT and HAS_V1):
        pytest.skip("needs root and a mounted cgroup-v1 devices controller")
    ctrl = pkg.mod("actuation.cgroup").CgroupDeviceController(
        host=pkg.mod("utils.config").HostPaths(cgroup_root="/sys/fs/cgroup"),
        driver="cgroupfs", version=1)
    tag = f"{os.getpid():08x}{os.urandom(4).hex()}"
    uid = f"{tag[:8]}-{tag[8:12]}-{tag[12:16]}-1111-222233334444"
    cid = "containerd://" + (tag * 4)
    pod = mk_pod(uid, cid)
    leaf = ctrl._v1_devices_dir(pod, cid)
    _makedirs(leaf)
    try:
        with open(os.path.join(leaf, "devices.deny"), "w") as f:
            f.write("a")                      # the runtime's deny-all
        yield ctrl, pod, cid, leaf
    finally:
        path = leaf
        while (path.startswith(os.path.join(DEVICES_ROOT, "kubepods"))
               and os.path.isdir(path)):
            try:
                os.rmdir(path)
            except OSError:
                break
            path = os.path.dirname(path)


def read_list(leaf: str) -> set[str]:
    with open(os.path.join(leaf, "devices.list")) as f:
        return {line.strip() for line in f if line.strip()}


def _companion_entries(chips) -> set[str]:
    return {f"c {a}:{b} rw" for a, b in _companion_majmins(chips)}


def test_kernel_accepts_production_allow_writes(pkg, controller):
    ctrl, pod, cid, leaf = controller
    assert read_list(leaf) == set()           # the deny-all took
    chips = _chips(pkg, 2)
    ctrl.sync_device_access(pod, cid, chips)
    assert read_list(leaf) == {f"c {pkg.major}:0 rw",
                               f"c {pkg.major}:1 rw"} | \
        _companion_entries(chips)             # and nothing else


def test_kernel_revoke_removes_only_detached_chips(pkg, controller):
    ctrl, pod, cid, leaf = controller
    chips = _chips(pkg, 2)
    ctrl.sync_device_access(pod, cid, chips)
    ctrl.revoke_device_access(pod, cid, chips_to_remove=[chips[0]],
                              remaining_chips=[chips[1]])
    got = read_list(leaf)
    assert f"c {pkg.major}:0 rw" not in got, got
    assert f"c {pkg.major}:1 rw" in got, got


def test_kernel_revoke_keeps_shared_companion_nodes(pkg, controller):
    """A companion a remaining device still needs survives the revoke."""
    ctrl, pod, cid, leaf = controller
    chips = sharing_devices(pkg, 2)
    shared = _companion_entries(chips)
    assert shared
    ctrl.sync_device_access(pod, cid, chips)
    assert shared <= read_list(leaf)
    ctrl.revoke_device_access(pod, cid, chips_to_remove=[chips[0]],
                              remaining_chips=[chips[1]])
    got = read_list(leaf)
    gone, kept = (f"c {c.major}:{c.minor} rw" for c in chips)
    assert gone not in got and kept in got, got
    assert shared <= got, got                 # shared companions survive
