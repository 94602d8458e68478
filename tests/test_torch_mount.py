"""The mount façade and the namespace actuators, through both packages: the
cases of tests/test_mount.py that tests/test_torch_actuation.py does not
run through both (the v1 allow and deny lines, a pod without containers,
the batch metrics, one batch per container with a shared companion
deduplicated, two containers fanning out, the proc-root actuator's fake
and real nodes, and killing a gone pid)."""

import os
import stat

import pytest

from tests.test_cgroup import mk_pod
from tests.test_torch_multicontainer import make_two_container_pod
from tests.torch_control_plane import BOTH, IDS, TORCH, norm_path

CID = "containerd://" + "ab" * 32
COMPANIONS = {"ctl", "uvm", "uvm-tools"}


@pytest.fixture(params=BOTH, ids=IDS)
def pkg(request):
    return request.param


@pytest.fixture
def host(pkg, tmp_path):
    return pkg.host(tmp_path)


@pytest.fixture
def rig(pkg, host):
    """A container cgroup with pids 4242 (live) and 4243 (no /proc dir),
    the real v1 controller and a recording actuator."""
    pod = mk_pod(qos_reported="Guaranteed")
    ctrl = pkg.mod("actuation.cgroup").CgroupDeviceController(
        host, driver="cgroupfs", version=1)
    cdir = ctrl.container_dir(pod, CID)
    os.makedirs(cdir)
    with open(os.path.join(cdir, "cgroup.procs"), "w") as f:
        f.write("4242\n4243\n")
    os.makedirs(os.path.join(host.proc_root, "4242", "root", "dev"))
    fake = pkg.mod("device.fake")
    enum = fake.FakeEnumerator(fake.make_chips(4))
    actuator = pkg.mod("actuation.nsenter").RecordingActuator()
    mounter = _mounter_class(pkg)(ctrl, actuator, enum, host)
    return pod, mounter, actuator, enum, cdir


def _mounter_class(pkg):
    mount = pkg.mod("actuation.mount")
    return mount.GPUMounter if pkg is TORCH else mount.TPUMounter


def _chips(pkg, n):
    return pkg.mod("device.fake").make_chips(n)


def _lines(cdir, name):
    with open(os.path.join(cdir, name)) as f:
        return f.read().splitlines()


def _companion_lines(chips):
    return sorted({f"c {c.major}:{c.minor} rw" for chip in chips
                   for c in getattr(chip, "companions", ())})


def test_mount_chips_full_path(pkg, rig):
    pod, mounter, actuator, _enum, cdir = rig
    chips = _chips(pkg, 2)
    mounter.mount_chips(pod, chips, chips)
    devices = [f"c {pkg.major}:0 rw", f"c {pkg.major}:1 rw"]
    lines = _lines(cdir, "devices.allow")
    assert [x for x in lines if x in devices] == devices
    assert sorted(x for x in lines if x not in devices) == \
        _companion_lines(chips)
    # through the first live pid (4243 has no /proc dir)
    assert [(pid, norm_path(p), major, minor)
            for pid, p, major, minor in actuator.created
            if norm_path(p) not in COMPANIONS] == [
        (4242, "dev0", pkg.major, 0), (4242, "dev1", pkg.major, 1)]


def test_mount_no_containers_raises(pkg, rig):
    pod, mounter, *_ = rig
    pod["status"]["containerStatuses"] = []
    with pytest.raises(pkg.errors.ActuationError):
        mounter.mount_chips(pod, _chips(pkg, 1), _chips(pkg, 1))


def test_unmount_clean_denies_only_the_detached_device(pkg, rig):
    pod, mounter, actuator, _enum, cdir = rig
    chips = _chips(pkg, 2)
    mounter.mount_chips(pod, chips, chips)
    mounter.unmount_chips(pod, [chips[0]], [chips[1]])
    assert _lines(cdir, "devices.deny") == [f"c {pkg.major}:0 rw"]
    assert actuator.removed == [(4242, pkg.node(0))]   # companions stay
    assert actuator.killed == []


def test_batch_metrics_recorded(pkg, rig):
    pod, mounter, *_ = rig
    reg = pkg.registry
    batches = reg.actuation_batches.value(op="create")
    ops = reg.actuation_batch_ops.value(op="create")
    chips = _chips(pkg, 3)
    mounter.mount_chips(pod, chips, chips)
    nodes = 3 + len(_companion_lines(chips))
    assert reg.actuation_batches.value(op="create") == batches + 1
    assert reg.actuation_batch_ops.value(op="create") == ops + nodes
    assert reg.actuation_batch_size.value(op="create") == nodes


def test_mount_is_one_batch_with_shared_companions_once(pkg, rig):
    """Devices and companions fuse into one crossing; a companion every
    device shares is created once. The control plane's devices share
    /dev/vfio/vfio here; every GPU shares its companions anyway."""
    pod, mounter, actuator, *_ = rig
    chips = _chips(pkg, 2)
    if pkg is not TORCH:
        vfio = pkg.mod("device.model").CompanionNode(
            host_path="/dev/vfio/vfio", major=10, minor=196)
        for chip in chips:
            chip.companions = (vfio,)
    mounter.mount_chips(pod, chips, chips)
    ((_pid, created, removed),) = actuator.batches
    shared = [c.host_path for c in chips[0].companions]
    assert created == (chips[0].device_path, *shared, chips[1].device_path)
    assert removed == ()


def test_multi_container_batches_fan_out(pkg, tmp_path):
    """Two containers: two batches, one crossing each, whatever the
    device count."""
    rig = pkg.rig(tmp_path, n_chips=4)
    try:
        pod = make_two_container_pod(pkg)
        rig.sim.kube.put_pod(pod)
        rig.provision_container(pod)
        outcome = pkg.add(rig.service, pod["metadata"]["name"], "default",
                          4, True)
        assert outcome.result.name == "SUCCESS"
        creates = [b for b in rig.actuator.batches if b[1]]
        assert len(creates) == 2
        for _, paths, _ in creates:
            assert len([p for p in paths
                        if norm_path(p) not in COMPANIONS]) == 4
            assert len(paths) == len(set(paths))     # each node once
    finally:
        rig.close()


def test_proc_root_actuator_fake_nodes(pkg, host):
    actuator = pkg.mod("actuation.nsenter").ProcRootActuator(
        host, fake_nodes=True)
    container_root = os.path.join(host.proc_root, "4242", "root")
    os.makedirs(os.path.join(container_root, "dev"))
    actuator.create_device_node(4242, pkg.node(0), pkg.major, 0)
    node = container_root + pkg.node(0)
    with open(node + ".majmin") as f:
        assert f.read() == f"{pkg.major}:0"
    inner = pkg.mod("device.enumerator").PyEnumerator(
        pkg.mod("utils.config").HostPaths(
            dev_root=os.path.join(container_root, "dev"),
            proc_root=host.proc_root),
        allow_fake=True)
    assert [c.minor for c in inner.enumerate()] == [0]
    actuator.create_device_node(4242, pkg.node(0), pkg.major, 0)
    actuator.remove_device_node(4242, pkg.node(0))
    assert not os.path.exists(node)
    assert not os.path.exists(node + ".majmin")


def test_proc_root_actuator_real_mknod_if_privileged(pkg, host):
    actuator = pkg.mod("actuation.nsenter").ProcRootActuator(
        host, fake_nodes=False)
    os.makedirs(os.path.join(host.proc_root, "1", "root", "dev"))
    try:
        actuator.create_device_node(1, pkg.node(0), pkg.major, 0)
    except pkg.errors.ActuationError:
        pytest.skip("this filesystem refuses mknod of char devices")
    st = os.stat(os.path.join(host.proc_root, "1", "root") + pkg.node(0))
    assert stat.S_ISCHR(st.st_mode)
    assert (os.major(st.st_rdev), os.minor(st.st_rdev)) == (pkg.major, 0)
    assert stat.S_IMODE(st.st_mode) == pkg.consts.DEVICE_FILE_MODE


def test_kill_processes_tolerates_gone_pids(pkg, host):
    pkg.mod("actuation.nsenter").ProcRootActuator(host).kill_processes(
        [2 ** 22 + 12345])
