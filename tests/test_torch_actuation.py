"""The port's actuation layer against the control plane's: the policy
composition (``rules_for_chips``, ``chip_majmins``), the port's own
``libbpfgate.so`` against the control plane's, cgroup-v1 writes on fixture
trees, the device gate (fake, v1 and legacy backends: grant, revoke,
converge, audit) and the mounter with fake nodes, busy refusal included.
The same scenario runs through both packages, TPU chip ``i`` (``accelN``,
120:i) matched with GPU ``i`` (``nvidiaN``, 195:i); the port's results are
the control plane's plus the companions every GPU shares.

Then what only GPUs have: a detach never revokes ``nvidiactl`` or the uvm
pair while another GPU needs them, or when the container held them before
any attach."""

import importlib
import os
import re
import subprocess
import types

import pytest

from gpumounter_tpu_torch.actuation import bpf as port_bpf
from gpumounter_tpu_torch.actuation.gate import (CgroupV1GateBackend,
                                                 DeviceGate,
                                                 FakeGateBackend, build_gate)
from gpumounter_tpu_torch.device.fake import FAKE_UVM_MAJOR, make_chips
from gpumounter_tpu_torch.utils.config import Settings
from gpumounter_tpu_torch.utils.errors import (ActuationError, CgroupError,
                                               DeviceBusyError)
from gpumounter_tpu_torch.utils.metrics import REGISTRY

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
UID = "a1b2c3d4-1111-2222-3333-444455556666"
CID = "containerd://" + "ab" * 32
PID = 4242
COMPANIONS = {(195, 255): "ctl", (FAKE_UVM_MAJOR, 0): "uvm",
              (FAKE_UVM_MAJOR, 1): "uvm-tools"}
PACKAGES = {"jax": "gpumounter_tpu", "torch": "gpumounter_tpu_torch"}


def load(name):
    root = PACKAGES[name]
    ns = types.SimpleNamespace(name=name)
    for mod in ("actuation.bpf", "actuation.cgroup", "actuation.gate",
                "actuation.mount", "actuation.nsenter", "device.fake",
                "utils.config", "utils.consts", "utils.errors"):
        setattr(ns, mod.split(".")[1], importlib.import_module(
            f"{root}.{mod}"))
    ns.Mounter = getattr(ns.mount, "GPUMounter" if name == "torch"
                         else "TPUMounter")
    return ns


JAX, TORCH = load("jax"), load("torch")
BOTH = (JAX, TORCH)


def norm(majmin):
    """A device of either family by role: ``devN`` for GPU/chip N, the
    companion's name otherwise."""
    if majmin in COMPANIONS:
        return COMPANIONS[majmin]
    return f"dev{majmin[1]}"


NODE_NAMES = {"nvidiactl": "ctl", "nvidia-uvm": "uvm",
              "nvidia-uvm-tools": "uvm-tools"}


def norm_path(path):
    """A node path by role, as :func:`norm` names its device."""
    base = os.path.basename(path)
    m = re.fullmatch(r"(?:accel|nvidia)(\d+)", base)
    return f"dev{m.group(1)}" if m else NODE_NAMES.get(base, base)


def split(items):
    """(device entries, companion entries) of a normalised list."""
    return ([x for x in items if not str(x).split()[-1].startswith(
        ("ctl", "uvm"))],
        [x for x in items if str(x).split()[-1].startswith(("ctl", "uvm"))])


def mk_pod(name="train-pod", uid=UID):
    return {
        "metadata": {"name": name, "namespace": "default", "uid": uid},
        "spec": {"containers": [{"name": "main", "resources": {
            "limits": {"cpu": "1", "memory": "1Gi"},
            "requests": {"cpu": "1", "memory": "1Gi"}}}]},
        "status": {"qosClass": "Guaranteed", "containerStatuses": [
            {"name": "main", "containerID": CID}]},
    }


class Rig:
    """One package's actuation stack over a fixture tree: a v1 cgroup dir
    holding PID, ``proc/PID/root/dev`` as the container's /dev, fake
    nodes, and the gate backend asked for."""

    def __init__(self, pkg, base, gate="fake", held=(), pod=None):
        self.pkg = pkg
        host = self.host = pkg.config.HostPaths(
            dev_root=str(base / "dev"), proc_root=str(base / "proc"),
            sys_root=str(base / "sys"),
            cgroup_root=str(base / "sys" / "fs" / "cgroup"))
        for d in (host.dev_root, host.proc_root, host.cgroup_root):
            os.makedirs(d, exist_ok=True)
        self.pod = pod or mk_pod()
        self.ctrl = pkg.cgroup.CgroupDeviceController(
            host, driver="cgroupfs", version=1)
        self.cdir = self.ctrl.container_dir(self.pod, CID)
        os.makedirs(self.cdir)
        with open(os.path.join(self.cdir, "cgroup.procs"), "w") as f:
            f.write(f"{PID}\n")
        self.dev = os.path.join(host.proc_root, str(PID), "root", "dev")
        os.makedirs(self.dev)
        for path, major, minor in held:      # the runtime's own nodes
            node = os.path.join(self.dev, os.path.basename(path))
            open(node, "w").close()
            with open(node + ".majmin", "w") as f:
                f.write(f"{major}:{minor}")
        self.chips = pkg.fake.make_chips(4)
        self.enum = pkg.fake.FakeEnumerator(pkg.fake.make_chips(4))
        self.backend = None
        if gate == "fake":
            self.backend = pkg.gate.FakeGateBackend()
        elif gate == "v1":
            self.backend = pkg.gate.CgroupV1GateBackend(self.ctrl)
        self.gate = pkg.gate.DeviceGate(
            self.ctrl, self.backend,
            mode="legacy" if gate == "legacy" else "auto", node_name="n")
        self.actuator = pkg.nsenter.ProcRootActuator(host, fake_nodes=True)
        self.mounter = pkg.Mounter(self.ctrl, self.actuator, self.enum,
                                   host, gate=self.gate)

    @property
    def key(self):
        return self.ctrl.container_dir(self.pod, CID)

    def nodes(self):
        return sorted(norm_path(n) for n in os.listdir(self.dev)
                      if not n.endswith(".majmin"))

    def lines(self, filename):
        path = os.path.join(self.cdir, filename)
        if not os.path.exists(path):
            return []
        with open(path) as f:
            return [self._norm_line(line) for line in f.read().splitlines()]

    @staticmethod
    def _norm_line(line):
        kind, majmin, perm = line.split()
        major, minor = (int(x) for x in majmin.split(":"))
        return f"{kind} {perm} {norm((major, minor))}"

    def map_devices(self):
        """Normalised (device, access) pairs of the fake map's char rules
        outside the container defaults."""
        rules, _opens, _denies = self.backend.read(self.key)
        defaults = {(r.dev_type, r.major, r.minor)
                    for r in self.pkg.bpf.CONTAINER_DEFAULT_RULES}
        return sorted((norm((k[1], k[2])), access)
                      for k, access in rules.items()
                      if k not in defaults and k[0] == "c")


# -- policy composition ------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 4])
def test_rules_for_chips_are_tpu_rules_plus_deduplicated_companions(n):
    def rows(pkg):
        return [(r.dev_type, r.access,
                 norm((r.major, r.minor)) if r.major is not None
                 and r not in pkg.bpf.CONTAINER_DEFAULT_RULES
                 else (r.major, r.minor))
                for r in pkg.bpf.rules_for_chips(pkg.fake.make_chips(n))]
    jax, torch = rows(JAX), rows(TORCH)
    _, companions = split([r[2] for r in torch])
    assert [r for r in torch if r[2] not in ("ctl", "uvm", "uvm-tools")] \
        == jax
    assert sorted(companions) == ["ctl", "uvm", "uvm-tools"]   # once each
    assert {r[1] for r in torch if r[2] in companions} == {
        port_bpf.ACC_RW | port_bpf.ACC_MKNOD}


def test_chip_majmins_dedup_shared_companions():
    jax = [norm(mm) for mm in JAX.bpf.chip_majmins(JAX.fake.make_chips(3))]
    torch = [norm(mm) for mm in port_bpf.chip_majmins(make_chips(3))]
    assert [x for x in torch if x.startswith("dev")] == jax
    assert torch == ["dev0", "ctl", "uvm", "uvm-tools", "dev1", "dev2"]


def test_rules_merge_access_bits_on_equal_majmin():
    observed = [port_bpf.DeviceRule("c", port_bpf.ACC_READ, 195, 255)]
    merged = [r for r in port_bpf.rules_for_chips(make_chips(2), observed)
              if (r.major, r.minor) == (195, 255)]
    assert len(merged) == 1
    assert merged[0].access == port_bpf.ACC_RWM


@pytest.mark.parametrize("case,remaining,held,want", [
    ("last GPU, nothing held", [], set(), ["dev0", "ctl", "uvm",
                                           "uvm-tools"]),
    ("another GPU remains", [1], set(), ["dev0"]),
    ("companions held before attach", [],
     {(195, 255), (FAKE_UVM_MAJOR, 0)}, ["dev0", "uvm-tools"]),
    ("baseline never observed", [], None, ["dev0"]),
])
def test_revoked_majmins(case, remaining, held, want):
    chips = make_chips(2)
    got = port_bpf.revoked_majmins([chips[0]],
                                   [chips[i] for i in remaining], held)
    assert [norm(mm) for mm in got] == want


def test_container_device_rules_read_the_same_dev_tree(tmp_path):
    dev = tmp_path / str(PID) / "root" / "dev"
    (dev / "sub").mkdir(parents=True)
    for name, majmin in (("null", "1:3"), ("nvidia0", "195:0"),
                         ("sub/x", "10:200")):
        (dev / name).write_text("")
        (dev / f"{name}.majmin").write_text(majmin)
    (dev / "stray").write_text("")          # no sidecar: not a device
    jax = JAX.bpf.container_device_rules(str(tmp_path), PID)
    torch = port_bpf.container_device_rules(str(tmp_path), PID)
    assert [(r.dev_type, r.access, r.major, r.minor) for r in jax] == \
        [(r.dev_type, r.access, r.major, r.minor) for r in torch]
    assert len(torch) == 3
    with pytest.raises(OSError):
        port_bpf.container_device_rules(str(tmp_path), PID + 1)


# -- the native library -----------------------------------------------------------

DEV_CHAR, DEV_BLOCK = 2, 1


def interpret(insns, dev_type, access, major, minor):
    """The instruction subset the codegen uses (a copy of the interpreter
    of tests/test_bpf_gate.py): run the program over a
    bpf_cgroup_dev_ctx and return r0."""
    ctx = {0: (access << 16) | dev_type, 4: major, 8: minor}
    regs = {1: "ctx"}
    pc = 0
    for _ in range(10_000):
        ins = insns[pc]
        code, off, imm = ins.code, ins.off, ins.imm
        dst = ins.regs & 0x0F
        src = (ins.regs >> 4) & 0x0F
        cls = code & 0x07
        if cls == 0x01:  # LDX MEM W
            assert regs.get(src) == "ctx"
            regs[dst] = ctx[off]
        elif cls == 0x04:  # ALU32
            op = code & 0xF0
            if op == 0x50:  # AND
                regs[dst] = (regs[dst] & imm) & 0xFFFFFFFF
            elif op == 0x70:  # RSH
                regs[dst] = (regs[dst] >> imm) & 0xFFFFFFFF
            elif op == 0xB0:  # MOV
                regs[dst] = regs[src] if code & 0x08 else imm
            else:
                raise AssertionError(f"alu op {op:#x}")
        elif cls == 0x06:  # JMP32
            op = code & 0xF0
            other = regs[src] if code & 0x08 else imm
            if op == 0x50:  # JNE
                if regs[dst] != other:
                    pc += off
            else:
                raise AssertionError(f"jmp op {op:#x}")
        elif cls == 0x07:  # ALU64 MOV imm
            regs[dst] = imm
        elif cls == 0x05 and (code & 0xF0) == 0x90:  # EXIT
            return regs[0]
        else:
            raise AssertionError(f"unknown insn code {code:#x}")
        pc += 1
    raise AssertionError("program did not terminate")


@pytest.fixture(scope="module")
def gates():
    """Both packages' libbpfgate.so, each built from its own source."""
    for pkg in ("gpumounter_tpu", "gpumounter_tpu_torch"):
        subprocess.run(["make", "-C", os.path.join(REPO, pkg, "native")],
                       check=True, capture_output=True)
    return JAX.bpf.BpfGate(), port_bpf.BpfGate()


def _insns(prog):
    return [(i.code, i.regs, i.off, i.imm) for i in prog]


RULE_SETS = {
    "empty": lambda b, chips: [],
    "defaults": lambda b, chips: list(b.CONTAINER_DEFAULT_RULES),
    "gpus": lambda b, chips: port_bpf.rules_for_chips(chips),
    "wildcards": lambda b, chips: [
        b.DeviceRule("a", b.ACC_MKNOD, None, None),
        b.DeviceRule("c", b.ACC_READ, 195, None),
        b.DeviceRule("b", b.ACC_RW, None, 7)],
}


@pytest.mark.parametrize("rule_set", sorted(RULE_SETS))
def test_port_library_emits_the_control_planes_program(gates, rule_set):
    theirs, ours = gates
    chips = make_chips(3)
    jax_rules = RULE_SETS[rule_set](JAX.bpf, chips)
    jax_rules = [JAX.bpf.DeviceRule(r.dev_type, r.access, r.major, r.minor)
                 for r in jax_rules]
    port_rules = RULE_SETS[rule_set](port_bpf, chips)
    jax_prog, port_prog = (theirs.build_program(jax_rules),
                           ours.build_program(port_rules))
    assert _insns(jax_prog) == _insns(port_prog)
    for dev_type in (DEV_CHAR, DEV_BLOCK):
        for access in (port_bpf.ACC_READ, port_bpf.ACC_RW,
                       port_bpf.ACC_MKNOD):
            for major, minor in ((1, 3), (195, 0), (195, 2), (195, 255),
                                 (FAKE_UVM_MAJOR, 1), (196, 0), (8, 7)):
                assert interpret(jax_prog, dev_type, access, major, minor) \
                    == interpret(port_prog, dev_type, access, major, minor)


def test_gpu_program_grants_gpus_and_companions_only(gates):
    _, ours = gates
    chips = make_chips(2)
    prog = ours.build_program(port_bpf.rules_for_chips(chips))
    for major, minor in ((195, 0), (195, 1), (195, 255),
                         (FAKE_UVM_MAJOR, 0), (FAKE_UVM_MAJOR, 1), (1, 3)):
        assert interpret(prog, DEV_CHAR, port_bpf.ACC_RW, major, minor) == 1
    assert interpret(prog, DEV_CHAR, port_bpf.ACC_RW, 195, 2) == 0
    assert interpret(prog, DEV_BLOCK, port_bpf.ACC_RW, 195, 0) == 0


def test_map_program_is_the_control_planes(gates):
    theirs, ours = gates
    assert _insns(theirs.build_map_program(5)) == \
        _insns(ours.build_map_program(5))
    assert ours.supported() == theirs.supported()


def test_bpf_gate_loads_only_the_checkouts_library(tmp_path):
    with pytest.raises(OSError):
        port_bpf.BpfGate(str(tmp_path / "libbpfgate.so"))


# -- cgroup ----------------------------------------------------------------------

@pytest.mark.parametrize("driver", ["systemd", "cgroupfs"])
@pytest.mark.parametrize("qos", ["Guaranteed", "Burstable", "BestEffort"])
def test_resolver_paths_match(driver, qos):
    pod = mk_pod()
    pod["status"]["qosClass"] = qos
    paths = [pkg.cgroup.CgroupResolver(driver).container_cgroup(pod, CID)
             for pkg in BOTH]
    assert paths[0] == paths[1]


def test_v1_writes_on_a_fixture_tree(tmp_path):
    """Grant then revoke one of two devices: the port writes the control
    plane's lines for the devices, and the companions ride the grant and
    stay while the other GPU does."""
    out = {}
    for pkg in BOTH:
        rig = Rig(pkg, tmp_path / pkg.name, gate="legacy")
        rig.ctrl.sync_device_access(rig.pod, CID, rig.chips[:2])
        rig.ctrl.revoke_device_access(rig.pod, CID, rig.chips[:1],
                                      rig.chips[1:2])
        out[pkg.name] = rig.lines("devices.allow"), rig.lines("devices.deny")
    (jax_allow, jax_deny), (allow, deny) = out["jax"], out["torch"]
    assert split(allow)[0] == jax_allow == ["c rw dev0", "c rw dev1"]
    assert sorted(split(allow)[1]) == ["c rw ctl", "c rw uvm",
                                       "c rw uvm-tools"]
    assert deny == jax_deny == ["c rw dev0"]


def test_v1_revoke_of_the_last_gpu_denies_the_companions(tmp_path):
    rig = Rig(TORCH, tmp_path, gate="legacy")
    rig.ctrl.sync_device_access(rig.pod, CID, rig.chips[:1])
    rig.ctrl.revoke_device_access(rig.pod, CID, rig.chips[:1], [])
    assert rig.lines("devices.deny") == [
        "c rw dev0", "c rw ctl", "c rw uvm", "c rw uvm-tools"]


def test_pids_and_observed_baseline_fail_closed(tmp_path):
    for pkg in BOTH:
        rig = Rig(pkg, tmp_path / pkg.name)
        assert rig.ctrl.get_pids(rig.pod, CID) == [PID]
        assert rig.ctrl.observed_baseline(rig.pod, CID) == []
        os.rmdir(rig.dev)
        os.rmdir(os.path.dirname(rig.dev))
        os.rmdir(os.path.dirname(os.path.dirname(rig.dev)))
        # the cached baseline (empty, observed above) still serves
        assert rig.ctrl.observed_baseline(rig.pod, CID) == []
        other = mk_pod("other", uid="b2")
        os.makedirs(rig.ctrl.container_dir(other, CID))
        with pytest.raises(pkg.errors.CgroupError):
            rig.ctrl.observed_baseline(other, CID)


def test_held_majmins_read_the_containers_dev(tmp_path):
    rig = Rig(TORCH, tmp_path, held=[("/dev/nvidiactl", 195, 255),
                                     ("/dev/null", 1, 3)])
    assert rig.ctrl.held_majmins(rig.pod, CID) == {(195, 255), (1, 3)}
    os.unlink(os.path.join(rig.cdir, "cgroup.procs"))
    assert rig.ctrl.held_majmins(rig.pod, CID) is None


# -- the device gate ---------------------------------------------------------------

def test_gate_grant_puts_defaults_and_devices_in_the_map(tmp_path):
    out = {}
    for pkg in BOTH:
        rig = Rig(pkg, tmp_path / pkg.name)
        rig.gate.grant(rig.pod, CID, rig.chips[:2])
        rules, _opens, denies = rig.backend.read(rig.key)
        assert rules[("c", 1, 3)] == pkg.bpf.ACC_RWM
        assert denies == 0
        out[pkg.name] = rig.map_devices(), rig.gate.granted_uuids()
    assert split([d for d, _ in out["torch"][0]])[0] == \
        [d for d, _ in out["jax"][0]] == ["dev0", "dev1"]
    assert len(out["torch"][0]) == 5
    assert out["torch"][1] == {c.uuid for c in make_chips(2)}


def test_gate_revoke_denies_reopen_with_reason(tmp_path):
    for pkg in BOTH:
        rig = Rig(pkg, tmp_path / pkg.name)
        c0, c1 = rig.chips[:2]
        rig.gate.grant(rig.pod, CID, [c0, c1])
        assert rig.gate.try_open(rig.key, c0.major, c0.minor)
        rig.gate.revoke(rig.pod, CID, [c0], [c1], cause="preempted:x")
        assert not rig.gate.try_open(rig.key, c0.major, c0.minor)
        assert rig.gate.try_open(rig.key, c1.major, c1.minor)
        recent = rig.gate.snapshot()["denials"]["recent"]
        assert (recent[-1]["reason"], recent[-1]["tenant"]) == (
            "revoked:preempted", "default")
        if pkg is TORCH:            # the other GPU keeps the companions
            for major, minor in COMPANIONS:
                assert rig.gate.try_open(rig.key, major, minor)


def test_gate_converge_restores_grants_and_revokes_orphans(tmp_path):
    out = {}
    for pkg in BOTH:
        rig = Rig(pkg, tmp_path / pkg.name)
        c = rig.chips
        rig.gate.grant(rig.pod, CID, c[:2])
        maps = rig.backend.maps[rig.key]
        maps[("c", c[3].major, c[3].minor)] = pkg.bpf.ACC_RWM   # orphan
        del maps[("c", c[0].major, c[0].minor)]                 # lost
        rig.backend.maps["/stale"] = {("c", c[2].major, c[2].minor):
                                      pkg.bpf.ACC_RW}
        universe = set(pkg.bpf.chip_majmins(c))
        stats = rig.gate.converge([(rig.pod, CID, c[:2])], universe)
        stale, _o, _d = rig.backend.read("/stale")
        out[pkg.name] = (stats, rig.map_devices(), stale,
                         rig.gate.granted_uuids() == {x.uuid for x in c[:2]})
    (jstats, jmap, jstale, jok), (stats, pmap, pstale, ok) = \
        out["jax"], out["torch"]
    assert stats == jstats == {"restored": 1, "orphans_revoked": 1}
    assert split([d for d, _ in pmap])[0] == [d for d, _ in jmap] == \
        ["dev0", "dev1"]
    assert jstale == pstale == {}
    assert jok and ok


def test_gate_audit_reclaims_a_dead_owners_grants(tmp_path):
    for pkg in BOTH:
        rig = Rig(pkg, tmp_path / pkg.name)
        c0 = rig.chips[0]
        rig.gate.grant(rig.pod, CID, [c0])
        assert rig.gate.audit({("default", "train-pod")}) == []
        drift = rig.gate.audit(set())
        assert [d["owner"] for d in drift] == ["default/train-pod"]
        assert not rig.backend.try_open(rig.key, c0.major, c0.minor)
        assert rig.backend.try_open(rig.key, 1, 3)        # defaults kept
        assert rig.gate.granted_uuids() == set()


def test_gate_backend_fault_degrades_to_the_legacy_writes(tmp_path):
    out = {}
    for pkg in BOTH:
        rig = Rig(pkg, tmp_path / pkg.name)
        rig.backend.fail_ops = 1
        rig.gate.grant(rig.pod, CID, rig.chips[:2])
        assert rig.gate.snapshot()["counts"]["faults"] == 1
        assert rig.gate.granted_uuids() == {c.uuid for c in rig.chips[:2]}
        out[pkg.name] = rig.lines("devices.allow")
    assert split(out["torch"])[0] == out["jax"]
    assert len(out["torch"]) == 5


def test_v1_gate_backend_diffs_against_its_shadow(tmp_path):
    rig = Rig(TORCH, tmp_path, gate="v1")
    c0, c1 = rig.chips[:2]
    rig.gate.grant(rig.pod, CID, [c0, c1])
    rig.gate.grant(rig.pod, CID, [c0, c1])            # no new writes
    assert len(rig.lines("devices.allow")) == 5
    rig.gate.revoke(rig.pod, CID, [c0], [c1])
    assert rig.lines("devices.deny") == ["c rw dev0"]
    live, _opens, _denies = rig.backend.read(rig.key)
    assert sorted(norm((k[1], k[2])) for k in live) == [
        "ctl", "dev1", "uvm", "uvm-tools"]


def test_build_gate_picks_the_backend(tmp_path):
    rig = Rig(TORCH, tmp_path, gate="legacy")
    gate = build_gate(Settings(node_name="n"), rig.ctrl)
    assert gate.live and isinstance(gate.backend, CgroupV1GateBackend)
    assert gate.node_name == "n"
    assert not build_gate(Settings(gate_mode="legacy"), rig.ctrl).live

    class NoBpf:
        def supported(self):
            return False
    v2 = TORCH.cgroup.CgroupDeviceController(
        rig.host, driver="cgroupfs", version=2, bpf_gate=NoBpf())
    before = REGISTRY.gate_syncs.value(backend="native-map",
                                       outcome="fault")
    gate = build_gate(Settings(), v2)
    assert not gate.live and gate.mode == "legacy"
    assert REGISTRY.gate_syncs.value(backend="native-map",
                                     outcome="fault") == before + 1


# -- the mounter ---------------------------------------------------------------------

def test_can_mount_matrix():
    for pkg in BOTH:
        MT = pkg.consts.MountType
        got = {(mt.name, entire): pkg.mount.can_mount(mt, entire)
               for mt in MT for entire in (False, True)}
        assert got == {("NONE", False): True, ("NONE", True): True,
                       ("SINGLE", False): True, ("SINGLE", True): False,
                       ("ENTIRE", False): False, ("ENTIRE", True): False,
                       ("UNKNOWN", False): False, ("UNKNOWN", True): False}


def test_mount_and_unmount_with_fake_nodes(tmp_path):
    out = {}
    for pkg in BOTH:
        rig = Rig(pkg, tmp_path / pkg.name)
        c0, c1 = rig.chips[:2]
        made = rig.mounter.mount_chips(rig.pod, [c0, c1], [c0, c1])
        again = rig.mounter.mount_chips(rig.pod, [c0, c1], [c0, c1])
        after_mount = rig.nodes()
        for name in os.listdir(rig.dev):      # every sidecar is its node's
            if name.endswith(".majmin"):
                with open(os.path.join(rig.dev, name)) as f:
                    major, minor = (int(x) for x in f.read().split(":"))
                assert norm((major, minor)) == norm_path(name[:-7])
        rig.mounter.unmount_chips(rig.pod, [c0], [c1])
        after_one = rig.nodes()
        rig.mounter.unmount_chips(rig.pod, [c1], [])
        out[pkg.name] = (made, again, after_mount, after_one, rig.nodes(),
                         rig.map_devices())
    jax, torch = out["jax"], out["torch"]
    assert (jax[0], torch[0]) == (2, 5) and jax[1] == torch[1] == 0
    assert split(torch[2])[0] == jax[2] == ["dev0", "dev1"]
    assert split(torch[3])[0] == jax[3] == ["dev1"]
    assert sorted(split(torch[3])[1]) == ["ctl", "uvm", "uvm-tools"]
    assert torch[4] == jax[4] == [] and torch[5] == jax[5] == []


def test_unmount_busy_refuses_and_force_kills(tmp_path):
    for pkg in BOTH:
        rig = Rig(pkg, tmp_path / pkg.name)
        rig.actuator = pkg.nsenter.RecordingActuator()
        rig.mounter.actuator = rig.actuator
        c0 = rig.chips[0]
        rig.mounter.mount_chips(rig.pod, [c0], [c0])
        rig.enum.busy_pids = {c0.device_path: [PID, 9999]}
        with pytest.raises(pkg.errors.DeviceBusyError) as exc:
            rig.mounter.unmount_chips(rig.pod, [c0], [])
        assert exc.value.pids == [PID]         # 9999 is not in the cgroup
        assert rig.actuator.removed == []
        assert rig.gate.try_open(rig.key, c0.major, c0.minor)
        rig.mounter.unmount_chips(rig.pod, [c0], [], force=True)
        assert rig.actuator.killed == [(PID, 9)]
        assert [norm_path(p) for _, p in rig.actuator.removed][0] == "dev0"


def test_busy_broker_detach_cuts_gate_access_first(tmp_path):
    for pkg in BOTH:
        rig = Rig(pkg, tmp_path / pkg.name)
        c0 = rig.chips[0]
        rig.mounter.mount_chips(rig.pod, [c0], [c0])
        rig.enum.busy_pids = {c0.device_path: [PID]}
        with pytest.raises(pkg.errors.DeviceBusyError):
            rig.mounter.unmount_chips(rig.pod, [c0], [],
                                      cause="lease-expired:t")
        assert not rig.gate.try_open(rig.key, c0.major, c0.minor)
        assert "dev0" in rig.nodes()           # cleanup deferred


def test_mount_is_one_batch_per_container(tmp_path):
    rig = Rig(TORCH, tmp_path)
    rig.actuator = rig.mounter.actuator = TORCH.nsenter.RecordingActuator()
    before = REGISTRY.actuation_batch_ops.value(op="create")
    rig.mounter.mount_chips(rig.pod, rig.chips[:3], rig.chips[:3])
    ((pid, created, removed),) = rig.actuator.batches
    assert pid == PID and removed == ()
    assert sorted(norm_path(p) for p in created) == [
        "ctl", "dev0", "dev1", "dev2", "uvm", "uvm-tools"]
    assert REGISTRY.actuation_batch_ops.value(op="create") == before + 6


def test_mount_without_a_live_pid_raises(tmp_path):
    for pkg in BOTH:
        rig = Rig(pkg, tmp_path / pkg.name)
        with open(os.path.join(rig.cdir, "cgroup.procs"), "w") as f:
            f.write("7777\n")
        with pytest.raises(pkg.errors.ActuationError):
            rig.mounter.mount_chips(rig.pod, rig.chips[:1], rig.chips[:1])


# -- shared companions on revoke (GPU only) ------------------------------------------

GATES = ["fake", "v1", "legacy"]


def _granted(rig, majmin):
    """Whether the container may open ``majmin`` after the revoke, read
    from whichever surface the gate wrote."""
    if isinstance(rig.backend, FakeGateBackend):
        return rig.gate.try_open(rig.key, *majmin)
    denied = {line for line in rig.lines("devices.deny")}
    return f"c rw {norm(majmin)}" not in denied


@pytest.mark.parametrize("gate", GATES)
def test_detach_keeps_companions_another_gpu_needs(tmp_path, gate):
    rig = Rig(TORCH, tmp_path, gate=gate)
    c0, c1 = rig.chips[:2]
    rig.mounter.mount_chips(rig.pod, [c0], [c0])
    rig.mounter.mount_chips(rig.pod, [c1], [c0, c1])
    rig.mounter.unmount_chips(rig.pod, [c1], [c0])
    assert not _granted(rig, (195, 1))
    assert all(_granted(rig, mm) for mm in COMPANIONS)
    assert rig.nodes() == ["ctl", "dev0", "uvm", "uvm-tools"]


@pytest.mark.parametrize("gate", GATES)
def test_detach_keeps_companions_the_container_held_before(tmp_path, gate):
    """The runtime gave the Pod a GPU at creation (its /dev holds nvidia0,
    nvidiactl and the uvm pair); a hot-attached GPU comes and goes, and
    the companions the first GPU needs stay granted and in place."""
    held = [("/dev/nvidia0", 195, 0), ("/dev/nvidiactl", 195, 255),
            ("/dev/nvidia-uvm", FAKE_UVM_MAJOR, 0),
            ("/dev/nvidia-uvm-tools", FAKE_UVM_MAJOR, 1)]
    rig = Rig(TORCH, tmp_path, gate=gate, held=held)
    c1 = rig.chips[1]
    assert rig.mounter.mount_chips(rig.pod, [c1], [c1]) == 1
    rig.mounter.unmount_chips(rig.pod, [c1], [])
    assert not _granted(rig, (195, 1))
    assert all(_granted(rig, mm) for mm in COMPANIONS)
    assert rig.nodes() == ["ctl", "dev0", "uvm", "uvm-tools"]


@pytest.mark.parametrize("gate", GATES)
def test_detach_of_the_last_gpu_revokes_companions(tmp_path, gate):
    rig = Rig(TORCH, tmp_path, gate=gate, held=[("/dev/null", 1, 3)])
    c0 = rig.chips[0]
    rig.mounter.mount_chips(rig.pod, [c0], [c0])
    rig.mounter.unmount_chips(rig.pod, [c0], [])
    assert not any(_granted(rig, mm) for mm in [(195, 0), *COMPANIONS])
    assert rig.nodes() == ["null"]


@pytest.mark.parametrize("gate", GATES)
def test_unknown_baseline_keeps_companions(tmp_path, gate):
    """A container whose /dev was never observed (the gate's first touch
    is a revoke, and no journal holds its baseline) loses the GPU and
    keeps the companions: denying one might break a GPU the runtime
    granted."""
    rig = Rig(TORCH, tmp_path, gate=gate)
    c0 = rig.chips[0]
    rig.mounter.mount_chips(rig.pod, [c0], [c0])
    restarted = DeviceGate(rig.ctrl, rig.backend,
                           mode="legacy" if gate == "legacy" else "auto")
    rig.mounter.gate = restarted
    rig.gate = restarted
    rig.mounter.unmount_chips(rig.pod, [c0], [])
    assert restarted.held(rig.pod, CID) is None
    assert not _granted(rig, (195, 0))
    assert all(_granted(rig, mm) for mm in COMPANIONS)
    assert rig.nodes() == ["ctl", "uvm", "uvm-tools"]


def test_errors_are_the_port_copies():
    assert issubclass(DeviceBusyError, TORCH.errors.TPUMounterError)
    assert issubclass(CgroupError, ActuationError)
    assert not issubclass(DeviceBusyError, JAX.errors.TPUMounterError)


def test_busy_means_the_gpus_own_node(tmp_path):
    """Every CUDA process holds nvidiactl and nvidia-uvm open, whichever
    GPUs it uses: a holder of the companions alone does not make a GPU
    busy, a holder of its node does."""
    rig = Rig(TORCH, tmp_path)
    c0 = rig.chips[0]
    rig.mounter.mount_chips(rig.pod, [c0], [c0])
    rig.enum.busy_pids = {c.host_path: [PID] for c in c0.companions}
    assert rig.mounter.pod_device_processes(rig.pod, c0) == []
    rig.enum.busy_pids[c0.device_path] = [PID]
    assert rig.mounter.pod_device_processes(rig.pod, c0) == [PID]


def test_nsenter_batch_is_one_shell_invocation():
    """The fused nsenter path: one script for the whole batch, idempotent
    per node, failing fast — the same script shape in both packages."""
    scripts = {}
    for pkg, creates, removes in (
            (JAX, [("/dev/accel0", 120, 0), ("/dev/accel1", 120, 1)],
             ["/dev/accel9"]),
            (TORCH, [("/dev/nvidia0", 195, 0), ("/dev/nvidiactl", 195, 255)],
             ["/dev/nvidia9"])):
        inner = pkg.nsenter.NsenterActuator()
        seen = []
        inner._run_in_mount_ns = lambda pid, script, seen=seen: (
            seen.append((pid, script)) or "created\ncreated\n")
        assert inner.apply_device_nodes(PID, creates, removes) == 2
        assert inner.apply_device_nodes(PID) == 0       # no crossing
        ((pid, script),) = seen
        assert pid == PID
        script = re.sub(r"accel|nvidia(?=\d)", "N", script)
        scripts[pkg.name] = re.sub(r" c (120|195) ", " c M ",
                                   script).splitlines()
    jax, torch = scripts["jax"], scripts["torch"]
    assert torch[0] == jax[0] == "set -e"
    assert torch[1] == jax[1]
    assert torch[3] == jax[3] == "rm -f /dev/N9"
    assert "mknod -m 666 /dev/nvidiactl c M 255" in torch[2]


def test_proc_root_actuator_fake_nodes_enumerate_in_the_container(tmp_path):
    host = TORCH.config.HostPaths(proc_root=str(tmp_path))
    actuator = TORCH.nsenter.ProcRootActuator(host, fake_nodes=True)
    dev = tmp_path / str(PID) / "root" / "dev"
    dev.mkdir(parents=True)
    assert actuator.create_device_node(PID, "/dev/nvidia2", 195, 2)
    assert not actuator.create_device_node(PID, "/dev/nvidia2", 195, 2)
    actuator.create_device_node(PID, "/dev/nvidiactl", 195, 255)
    from gpumounter_tpu_torch.device.enumerator import PyEnumerator
    inner = PyEnumerator(TORCH.config.HostPaths(dev_root=str(dev),
                                                proc_root=str(tmp_path)),
                         allow_fake=True)
    (gpu,) = inner.enumerate()
    assert (gpu.major, gpu.minor) == (195, 2)
    assert [(c.major, c.minor) for c in gpu.companions] == [(195, 255)]
    actuator.remove_device_node(PID, "/dev/nvidia2")
    assert sorted(os.listdir(dev)) == ["nvidiactl", "nvidiactl.majmin"]
    actuator.kill_processes([2 ** 22 + 12345])         # gone: no raise


def test_proc_root_actuator_real_mknod_where_the_filesystem_allows(tmp_path):
    import stat
    host = TORCH.config.HostPaths(proc_root=str(tmp_path))
    actuator = TORCH.nsenter.ProcRootActuator(host)
    (tmp_path / "1" / "root" / "dev").mkdir(parents=True)
    try:
        actuator.create_device_node(1, "/dev/nvidia0", 195, 0)
    except ActuationError:
        pytest.skip("this filesystem refuses mknod of char devices")
    st = os.stat(tmp_path / "1" / "root" / "dev" / "nvidia0")
    assert stat.S_ISCHR(st.st_mode)
    assert (os.major(st.st_rdev), os.minor(st.st_rdev)) == (195, 0)
    assert stat.S_IMODE(st.st_mode) == TORCH.consts.DEVICE_FILE_MODE


def test_unmount_is_one_batch_per_container(tmp_path):
    out = {}
    for pkg in BOTH:
        rig = Rig(pkg, tmp_path / pkg.name)
        rig.actuator = rig.mounter.actuator = \
            pkg.nsenter.RecordingActuator()
        rig.mounter.mount_chips(rig.pod, rig.chips[:2], rig.chips[:2])
        rig.actuator.batches.clear()
        rig.mounter.unmount_chips(rig.pod, rig.chips[:2], [])
        ((_pid, created, removed),) = rig.actuator.batches
        out[pkg.name] = created, [norm_path(p) for p in removed]
    assert out["jax"] == ((), ["dev0", "dev1"])
    assert out["torch"] == ((), ["dev0", "ctl", "uvm", "uvm-tools",
                                 "dev1"])
