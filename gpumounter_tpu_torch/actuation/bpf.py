"""cgroup-v2 device gating: Python side of the native BPF gate (the port of
:mod:`gpumounter_tpu.actuation.bpf`).

The reference's device permissioning is a cgroup-v1 file write
(``pkg/util/cgroup/cgroup.go:143-169``); on cgroup v2 (GKE >= 1.26) the
controller is an eBPF program and permissions can only be *extended* by
replacing the runtime's attached program with one whose allowlist is
(container defaults ∪ attached GPUs). See
``gpumounter_tpu_torch/native/bpf_gate.cc`` for kernel mechanics (a copy of
the control plane's, built into the port's own ``build/libbpfgate.so``,
the only library :class:`BpfGate` loads); this module owns
the *policy*: the canonical container default rule set (what runc/crun grant
every container) and the desired-state composition.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
import stat as stat_mod

from gpumounter_tpu_torch.device.model import GPUDevice
from gpumounter_tpu_torch.utils.log import get_logger

logger = get_logger("actuation.bpf")

_LIB_NAME = "libbpfgate.so"
_ABI_VERSION = 3

ACC_MKNOD = 1
ACC_READ = 2
ACC_WRITE = 4
ACC_RWM = ACC_MKNOD | ACC_READ | ACC_WRITE
ACC_RW = ACC_READ | ACC_WRITE


class CDeviceRule(ctypes.Structure):
    _fields_ = [
        ("dev_type", ctypes.c_int32),   # ord('c') | ord('b') | ord('a')
        ("access", ctypes.c_int32),
        ("major", ctypes.c_int32),
        ("minor", ctypes.c_int32),
        ("has_major", ctypes.c_int32),
        ("has_minor", ctypes.c_int32),
    ]


class CBpfInsn(ctypes.Structure):
    _fields_ = [
        ("code", ctypes.c_uint8),
        ("regs", ctypes.c_uint8),       # dst:4 | src:4
        ("off", ctypes.c_int16),
        ("imm", ctypes.c_int32),
    ]


@dataclasses.dataclass(frozen=True)
class DeviceRule:
    dev_type: str = "c"       # 'c' char, 'b' block, 'a' all
    access: int = ACC_RWM
    major: int | None = None  # None = wildcard
    minor: int | None = None

    def to_c(self) -> CDeviceRule:
        return CDeviceRule(
            dev_type=ord(self.dev_type),
            access=self.access,
            major=self.major or 0,
            minor=self.minor or 0,
            has_major=0 if self.major is None else 1,
            has_minor=0 if self.minor is None else 1,
        )


# The devices every OCI container is granted by default (runc/crun defaults:
# mknod of any char/block device, plus rwm on null, zero, full, random,
# urandom, tty, console, ptmx and the pts namespace). A hot-attach must
# preserve exactly this set when replacing the runtime's program, or the
# container loses /dev/null et al.
CONTAINER_DEFAULT_RULES: tuple[DeviceRule, ...] = (
    DeviceRule("c", ACC_MKNOD, None, None),
    DeviceRule("b", ACC_MKNOD, None, None),
    DeviceRule("c", ACC_RWM, 1, 3),    # /dev/null
    DeviceRule("c", ACC_RWM, 1, 5),    # /dev/zero
    DeviceRule("c", ACC_RWM, 1, 7),    # /dev/full
    DeviceRule("c", ACC_RWM, 1, 8),    # /dev/random
    DeviceRule("c", ACC_RWM, 1, 9),    # /dev/urandom
    DeviceRule("c", ACC_RWM, 5, 0),    # /dev/tty
    DeviceRule("c", ACC_RWM, 5, 1),    # /dev/console
    DeviceRule("c", ACC_RWM, 5, 2),    # /dev/ptmx
    DeviceRule("c", ACC_RWM, 136, None),  # /dev/pts/*
)


def rules_for_chips(chips: list[GPUDevice],
                    observed: list[DeviceRule] | tuple = ()
                    ) -> list[DeviceRule]:
    """Desired device-program allowlist: container defaults + ``observed``
    (devices the runtime already granted this container, derived from its
    live /dev — see :func:`container_device_rules`) + GPU nodes + their
    companion nodes (``nvidiactl`` and the uvm pair carry their own majmin
    — without these rules the GPU node is visible but unusable; a
    companion every GPU shares yields one rule).

    Rules agreeing on ``(type, major, minor)`` MERGE their access bits
    instead of first-wins: an observed narrow rule (e.g. a read-only spec
    device that happens to share a majmin with a chip grant) must not
    shadow the chip's rw+mknod — nor the chip grant an operator's wider
    observed access."""
    rules = list(CONTAINER_DEFAULT_RULES)
    index: dict[tuple[str, int | None, int | None], int] = {
        (r.dev_type, r.major, r.minor): i for i, r in enumerate(rules)}

    def _merge(rule: DeviceRule) -> None:
        key = (rule.dev_type, rule.major, rule.minor)
        at = index.get(key)
        if at is None:
            index[key] = len(rules)
            rules.append(rule)
        elif rules[at].access | rule.access != rules[at].access:
            rules[at] = dataclasses.replace(
                rules[at], access=rules[at].access | rule.access)

    for rule in observed:
        _merge(rule)
    for chip in chips:
        for major, minor in [(chip.major, chip.minor),
                             *((c.major, c.minor) for c in chip.companions)]:
            _merge(DeviceRule("c", ACC_RW | ACC_MKNOD, major, minor))
    return rules


def chip_majmins(chips: list[GPUDevice]) -> list[tuple[int, int]]:
    """Deduped (major, minor) pairs for GPUs AND their companion nodes —
    THE one expansion every consumer (cgroup controller, device gate,
    replay convergence) must agree on."""
    out: list[tuple[int, int]] = []
    seen: set[tuple[int, int]] = set()
    for chip in chips:
        for key in [(chip.major, chip.minor),
                    *((c.major, c.minor) for c in chip.companions)]:
            if key not in seen:
                seen.add(key)
                out.append(key)
    return out


def revoked_majmins(chips: list[GPUDevice], remaining_chips: list[GPUDevice],
                    held: set[tuple[int, int]] | None = frozenset()
                    ) -> list[tuple[int, int]]:
    """The (major, minor) pairs a detach of ``chips`` revokes, in
    :func:`chip_majmins` order: each detached GPU's own node always; a
    companion only when no remaining GPU needs it and the container did not
    hold it before any attach (``held``, its observed baseline). Every GPU
    of a node shares ``nvidiactl`` and the uvm pair, so a container the
    runtime gave a GPU at creation keeps them when a hot-attached GPU
    leaves. ``held=None`` means the baseline is unknown (never observed):
    then no companion is revoked, since denying one could break a GPU the
    runtime granted."""
    keep = set(chip_majmins(remaining_chips))
    own = {(chip.major, chip.minor) for chip in chips}
    return [mm for mm in chip_majmins(chips)
            if mm not in keep
            and (mm in own or (held is not None and mm not in held))]


def container_device_rules(proc_root: str, pid: int,
                           limit: int = 256) -> list[DeviceRule]:
    """The device nodes actually present in the container's /dev, read
    through ``/proc/<pid>/root`` — ground truth for what the runtime (spec
    devices, device plugins, GKE extras) granted this container beyond the
    OCI defaults. Replacing the attached BPF program with defaults∪chips
    alone would silently revoke these (round-1 VERDICT missing #3); the
    composed allowlist must carry them.

    Grants RWM per found node (a runtime-granted node is at least rw; the
    widening to mknod is negligible against the alternative of revoking).
    Fixture trees represent fake nodes as regular files with ``.majmin``
    sidecars — accepted so the full path stays testable unprivileged.
    ``limit`` bounds a pathological /dev.

    Raises OSError when the /dev dir is missing or vanishes mid-walk (the
    PID exited between liveness check and scan) — an unobservable /dev must
    NOT be conflated with an observed-empty one, or the caller would treat
    it as a valid baseline and silently revoke runtime grants. Hitting
    ``limit`` raises for the same reason: a PARTIAL baseline composed as
    ground truth would silently revoke every runtime grant past the cap
    (the callers' fail-closed/cached-baseline handling applies)."""
    dev_dir = os.path.join(proc_root, str(pid), "root", "dev")
    if not os.path.isdir(dev_dir):
        raise OSError(f"container /dev not readable via {dev_dir}")
    rules: list[DeviceRule] = []
    seen: set[tuple[str, int, int]] = set()

    def _walk_error(err: OSError):
        raise err

    for dirpath, _, filenames in os.walk(dev_dir, onerror=_walk_error):
        for name in sorted(filenames):
            path = os.path.join(dirpath, name)
            if name.endswith(".majmin"):
                continue
            try:
                st = os.lstat(path)
            except OSError:
                continue
            dev_type = None
            major = minor = 0
            if stat_mod.S_ISCHR(st.st_mode):
                dev_type = "c"
                major, minor = os.major(st.st_rdev), os.minor(st.st_rdev)
            elif stat_mod.S_ISBLK(st.st_mode):
                dev_type = "b"
                major, minor = os.major(st.st_rdev), os.minor(st.st_rdev)
            elif stat_mod.S_ISREG(st.st_mode):
                try:
                    with open(path + ".majmin") as f:
                        major_s, _, minor_s = f.read().strip().partition(":")
                    dev_type, major, minor = "c", int(major_s), int(minor_s)
                except (OSError, ValueError):
                    continue
            if dev_type is None:
                continue
            key = (dev_type, major, minor)
            if key not in seen:
                if len(rules) >= limit:
                    raise OSError(
                        f"container /dev of pid {pid} exceeds {limit} "
                        "device nodes; refusing a truncated baseline that "
                        "would compose as ground truth and silently "
                        "revoke grants past the cap")
                seen.add(key)
                rules.append(DeviceRule(dev_type, ACC_RWM, major, minor))
    return rules


def _default_lib_path() -> str:
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.join(here, "..", "native", "build", _LIB_NAME)


class BpfGate:
    """Binding to libbpfgate.so. ``sync`` is the only mutating entry point."""

    SYNC_OK = 1
    SYNC_NOOP = 2  # no program attached => access already unrestricted

    def __init__(self, lib_path: str | None = None):
        # the library built from this checkout's source, never one
        # installed elsewhere on the system (OSError when it is not built)
        self._lib = ctypes.CDLL(lib_path or _default_lib_path())
        self._lib.bpfgate_build_program.restype = ctypes.c_int
        self._lib.bpfgate_build_program.argtypes = [
            ctypes.POINTER(CDeviceRule), ctypes.c_int,
            ctypes.POINTER(CBpfInsn), ctypes.c_int]
        self._lib.bpfgate_supported.restype = ctypes.c_int
        self._lib.bpfgate_supported.argtypes = []
        self._lib.bpfgate_sync.restype = ctypes.c_int
        self._lib.bpfgate_sync.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(CDeviceRule), ctypes.c_int]
        self._lib.bpfgate_attached_count.restype = ctypes.c_int
        self._lib.bpfgate_attached_count.argtypes = [ctypes.c_char_p]
        self._lib.bpfgate_read_attached.restype = ctypes.c_int
        self._lib.bpfgate_read_attached.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(CBpfInsn),
            ctypes.c_int]
        self._lib.bpfgate_attach.restype = ctypes.c_int
        self._lib.bpfgate_attach.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(CDeviceRule), ctypes.c_int]
        # Map-driven gate (PR 12): per-cgroup policy map, in-place updates.
        self._lib.bpfgate_map_attach.restype = ctypes.c_int
        self._lib.bpfgate_map_attach.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(CDeviceRule), ctypes.c_int,
            ctypes.POINTER(ctypes.c_int)]
        self._lib.bpfgate_map_sync.restype = ctypes.c_int
        self._lib.bpfgate_map_sync.argtypes = [
            ctypes.c_int, ctypes.POINTER(CDeviceRule), ctypes.c_int]
        self._lib.bpfgate_map_read.restype = ctypes.c_int
        self._lib.bpfgate_map_read.argtypes = [
            ctypes.c_int, ctypes.POINTER(CDeviceRule),
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_int]
        self._lib.bpfgate_map_close.restype = ctypes.c_int
        self._lib.bpfgate_map_close.argtypes = [ctypes.c_int]
        self._lib.bpfgate_map_recover.restype = ctypes.c_int
        self._lib.bpfgate_map_recover.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int)]
        self._lib.bpfgate_build_map_program.restype = ctypes.c_int
        self._lib.bpfgate_build_map_program.argtypes = [
            ctypes.c_int, ctypes.POINTER(CBpfInsn), ctypes.c_int]
        self._lib.bpfgate_abi_version.restype = ctypes.c_int
        if self._lib.bpfgate_abi_version() != _ABI_VERSION:
            raise OSError("libbpfgate ABI mismatch")

    def build_program(self, rules: list[DeviceRule]) -> list[CBpfInsn]:
        """Pure codegen (no privileges) — exposed for tests/debugging."""
        c_rules = (CDeviceRule * max(len(rules), 1))(
            *[r.to_c() for r in rules])
        max_insns = 16 + 8 * len(rules)
        out = (CBpfInsn * max_insns)()
        n = self._lib.bpfgate_build_program(c_rules, len(rules), out,
                                            max_insns)
        if n < 0:
            raise OSError("bpfgate_build_program failed")
        return list(out[:n])

    def supported(self) -> bool:
        return self._lib.bpfgate_supported() == 1

    def sync(self, cgroup_path: str, rules: list[DeviceRule]) -> int:
        c_rules = (CDeviceRule * max(len(rules), 1))(
            *[r.to_c() for r in rules])
        rc = self._lib.bpfgate_sync(cgroup_path.encode(), c_rules, len(rules))
        if rc < 0:
            raise OSError(f"bpfgate_sync({cgroup_path}) failed: errno {-rc}")
        return rc

    def attached_count(self, cgroup_path: str) -> int:
        rc = self._lib.bpfgate_attached_count(cgroup_path.encode())
        if rc < 0:
            raise OSError(
                f"bpfgate_attached_count({cgroup_path}): errno {-rc}")
        return rc

    def read_attached(self, cgroup_path: str,
                      index: int = 0) -> list[CBpfInsn]:
        """Xlated instruction stream of attached program ``index`` —
        CGROUP_DEVICE has no ctx rewriting, so the stream is directly
        interpretable (kernel-proven tests run the test interpreter over
        it). Needs CAP_SYS_ADMIN/CAP_PERFMON."""
        max_insns = 4096
        out = (CBpfInsn * max_insns)()
        rc = self._lib.bpfgate_read_attached(cgroup_path.encode(), index,
                                             out, max_insns)
        if rc < 0:
            raise OSError(
                f"bpfgate_read_attached({cgroup_path}, {index}): errno {-rc}")
        return list(out[:rc])

    # -- map-driven gate (PR 12) ----------------------------------------------
    # Outcomes of :meth:`map_attach` (mirror the C layer's return codes).
    MAP_ATTACHED = 1     # replaced the runtime's program with the map gate
    MAP_NOOP = 2         # no program attached: access already unrestricted
    MAP_ADOPTED = 3      # recovered a previous incarnation's live map

    def map_attach(self, cgroup_path: str,
                   rules: list[DeviceRule]) -> tuple[int, int]:
        """Attach (or adopt) the map-driven gate and sync its policy map
        to ``rules``. Returns ``(outcome, map_fd)``; ``map_fd`` is -1 on
        NOOP. Grant/revoke afterwards go through :meth:`map_sync` — pure
        in-place map updates, no program replacement."""
        c_rules = (CDeviceRule * max(len(rules), 1))(
            *[r.to_c() for r in rules])
        fd = ctypes.c_int(-1)
        rc = self._lib.bpfgate_map_attach(cgroup_path.encode(), c_rules,
                                          len(rules), ctypes.byref(fd))
        if rc < 0:
            raise OSError(
                f"bpfgate_map_attach({cgroup_path}) failed: errno {-rc}")
        return rc, fd.value

    def map_sync(self, map_fd: int, rules: list[DeviceRule]) -> None:
        """Make the live policy map match exactly ``rules`` (stale keys
        deleted first — revocation wins; surviving keys keep their open
        counters)."""
        c_rules = (CDeviceRule * max(len(rules), 1))(
            *[r.to_c() for r in rules])
        rc = self._lib.bpfgate_map_sync(map_fd, c_rules, len(rules))
        if rc < 0:
            raise OSError(f"bpfgate_map_sync(fd={map_fd}): errno {-rc}")

    def map_read(self, map_fd: int,
                 max_entries: int = 1024
                 ) -> tuple[list[DeviceRule], dict[tuple, int], int]:
        """Live map contents: (rules, {(type, major, minor): opens},
        denies). The reserved deny-counter key is split out as the third
        element; wildcards read back as None major/minor."""
        out = (CDeviceRule * max_entries)()
        opens = (ctypes.c_uint64 * max_entries)()
        n = self._lib.bpfgate_map_read(map_fd, out, opens, max_entries)
        if n < 0:
            raise OSError(f"bpfgate_map_read(fd={map_fd}): errno {-n}")
        rules: list[DeviceRule] = []
        open_counts: dict[tuple, int] = {}
        denies = 0
        for i in range(n):
            raw = out[i]
            if raw.dev_type == 0:
                denies = int(opens[i])
                continue
            rule = DeviceRule(
                chr(raw.dev_type), raw.access,
                raw.major if raw.has_major else None,
                raw.minor if raw.has_minor else None)
            rules.append(rule)
            open_counts[(rule.dev_type, rule.major, rule.minor)] = \
                int(opens[i])
        return rules, open_counts, denies

    def map_close(self, map_fd: int) -> None:
        self._lib.bpfgate_map_close(map_fd)

    def map_recover(self, cgroup_path: str) -> tuple[int, int]:
        """Recover-ONLY adoption probe: ``(outcome, map_fd)`` —
        MAP_ADOPTED with the live map's fd if a tpumounter map program is
        attached here, MAP_NOOP (fd -1) otherwise. Never mutates policy;
        what restart-time orphan discovery walks the cgroup tree with."""
        fd = ctypes.c_int(-1)
        rc = self._lib.bpfgate_map_recover(cgroup_path.encode(),
                                           ctypes.byref(fd))
        if rc < 0:
            raise OSError(
                f"bpfgate_map_recover({cgroup_path}): errno {-rc}")
        return rc, fd.value

    def build_map_program(self, map_fd: int = 3) -> list[CBpfInsn]:
        """Pure codegen of the map-driven program (map_fd only lands in
        the ld_imm64) — exposed for tests/debugging."""
        max_insns = 256
        out = (CBpfInsn * max_insns)()
        n = self._lib.bpfgate_build_map_program(map_fd, out, max_insns)
        if n < 0:
            raise OSError("bpfgate_build_map_program failed")
        return list(out[:n])

    def attach(self, cgroup_path: str, rules: list[DeviceRule]) -> None:
        """Attach a fresh program like a container runtime would
        (ALLOW_MULTI, no replace) — test scaffolding for scratch cgroups;
        production mutation goes through :meth:`sync` only."""
        c_rules = (CDeviceRule * max(len(rules), 1))(
            *[r.to_c() for r in rules])
        rc = self._lib.bpfgate_attach(cgroup_path.encode(), c_rules,
                                      len(rules))
        if rc < 0:
            raise OSError(f"bpfgate_attach({cgroup_path}): errno {-rc}")
