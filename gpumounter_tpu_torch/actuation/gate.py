"""Kernel-enforced device gate: the ONE seam every grant/revoke crosses (the
port of :mod:`gpumounter_tpu.actuation.gate`).

Revocation used to be the weakest invariant in this control plane: detach,
lease expiry and preemption unlinked device nodes and rewrote cgroup files,
so a process already holding an open ``/dev/nvidiaN`` fd kept the GPU after
its lease was gone, and a worker crash mid-revoke could leave a GPU
accessible with no lease on record. This module turns the policy pieces
(:mod:`gpumounter_tpu_torch.actuation.bpf` policy composition +
``native/bpf_gate.cc`` program codegen) into a wired enforcement subsystem,
the gpu_ext (PAPERS.md) shape — extensible OS-level accelerator policy via
eBPF, with a map-update enforcement point the FlexNPU-style fractional
sharing item can later meter against:

- :class:`DeviceGate` is the seam. ``grant``/``revoke`` are the only
  sanctioned device-permission mutations on the worker
  (tests/test_gate_lint.py pins that no detach/expiry/preempt path reaches
  the cgroup controller or an unlink-based revoke around it). Revocation
  goes through the gate FIRST (instant deny — a map update, no program
  replacement, no nsenter, no fork) and only then do device nodes get
  cleaned up.
- Three backends: :class:`NativeGateBackend` (cgroup v2 — the per-cgroup
  BPF policy map keyed by ``(type, major, minor)`` → access bits, exact
  per-syscall open/deny counters maintained by the kernel program),
  :class:`CgroupV1GateBackend` (the existing v1 ``devices.allow/deny``
  writes, diffed against a shadow of the granted set), and
  :class:`FakeGateBackend` (in-memory maps + deny simulation — what every
  test/chaos/sim rig drives).
- **Crash consistency**: every gate mutation is journaled around actuation
  like mknod/unlink already are (``worker/journal.py`` gate records);
  startup replay re-derives the desired map contents from attachment
  ground truth and :meth:`DeviceGate.converge`\\ s the live maps — orphan
  entries revoked, missing grants restored. The reconciler audits
  gate-vs-lease drift each pass (:meth:`DeviceGate.audit`).
- **Deny-with-reason audit**: denials surface in a bounded ring with the
  revocation cause attributed from tombstones
  (``device_denials_total{tenant,reason}``), served as ``GET /gatez`` with
  a flight-recorder provider and a denial-burst trigger.

``TPU_GATE=legacy`` reverts to today's semantics byte-for-byte (the gate
becomes a pure passthrough to the cgroup controller — pinned by test);
any backend fault degrades to the legacy path (counted + evented), never
to an unenforced attach.

**Shared companions.** Every GPU of a node shares ``nvidiactl`` and the uvm
pair. Before a container's first grant the gate records the char nodes its
/dev already holds (:meth:`DeviceGate.held`); a revoke, live or legacy,
then denies a companion only when no remaining GPU needs it and the
container did not hold it before any attach
(:func:`~gpumounter_tpu_torch.actuation.bpf.revoked_majmins`). A container
whose baseline was never observed keeps its companions. The baseline is
persisted in the attach journal (``baseline`` records): a restarted
worker's gate reads it back, since after an attach the container's /dev
no longer tells a companion the runtime gave from one the attach added.
"""

from __future__ import annotations

import abc
import collections
import dataclasses
import threading
import time

from gpumounter_tpu_torch.actuation.bpf import (ACC_MKNOD, ACC_RW,
                                                DeviceRule, revoked_majmins,
                                                rules_for_chips)
from gpumounter_tpu_torch.actuation.bpf import chip_majmins as _chip_majmins
from gpumounter_tpu_torch.device.model import GPUDevice
from gpumounter_tpu_torch.k8s import objects
from gpumounter_tpu_torch.utils.errors import (ActuationError, CgroupError,
                                               GateBackendError)
from gpumounter_tpu_torch.utils.events import EVENTS
from gpumounter_tpu_torch.utils.flight import RECORDER
from gpumounter_tpu_torch.utils.log import get_logger
from gpumounter_tpu_torch.utils.metrics import REGISTRY

logger = get_logger("actuation.gate")

# Gate modes (TPU_GATE): "auto" (default ON — pick the strongest backend
# for this node) | "legacy" (byte-for-byte today's semantics: direct
# cgroup-controller calls, zero gate state, zero new series).
GATE_MODES = ("auto", "legacy")

# Deny ring bound and tombstone retention: reasons only need to outlive
# the window in which an evicted holder is still retrying opens.
DENY_RING_SIZE = 128
TOMBSTONE_TTL_S = 3600.0
TOMBSTONE_MAX = 4096

MajMin = tuple[str, int | None, int | None]     # (dev_type, major, minor)


def _match(rules: dict[MajMin, int], dev_type: str, major: int,
           minor: int) -> int:
    """Kernel lookup semantics over a rule dict: union the access bits of
    the exact, (major,*), (*,minor) and (*,*) entries — exactly the four
    map lookups the native program performs."""
    allowed = 0
    for key in ((dev_type, major, minor), (dev_type, major, None),
                (dev_type, None, minor), (dev_type, None, None)):
        allowed |= rules.get(key, 0)
    return allowed


def _rules_dict(rules: list[DeviceRule]) -> dict[MajMin, int]:
    """Rule list → map contents; 'a' expands to char+block like the
    native layer, equal keys merge access bits."""
    out: dict[MajMin, int] = {}
    for rule in rules:
        types = ("c", "b") if rule.dev_type == "a" else (rule.dev_type,)
        for dev_type in types:
            key = (dev_type, rule.major, rule.minor)
            out[key] = out.get(key, 0) | rule.access
    return out


@dataclasses.dataclass
class GateEntry:
    """One gated container: what the gate believes the live map holds."""

    key: str                      # container cgroup dir (the map identity)
    namespace: str
    pod: str
    container_id: str
    tenant: str                   # owner namespace (the broker's default)
    chips: dict[str, list[tuple[int, int]]]   # uuid -> its majmins
    rules: int = 0                # live rule count (after last sync)
    enforced: bool = True         # False = backend answered NOOP
    updated_at: float = 0.0


class GateBackend(abc.ABC):
    """Storage/enforcement for per-container device policy maps.

    ``baseline`` names what rule set :class:`DeviceGate` composes for this
    backend: ``"observed"`` = defaults ∪ live-/dev scan ∪ chips (the v2
    whole-map replacement discipline), ``"defaults"`` = defaults ∪ chips
    (deterministic — the fake), ``"chips"`` = chip rules only (v1 writes
    are incremental on top of the runtime's own policy).
    """

    name = "?"
    baseline = "observed"
    # Whether this backend maintains EXACT per-syscall open counters the
    # gate may substitute for the sampler's edge accounting. v1 cannot
    # (write-only kernel surface): its chips must keep edge accounting.
    exact_counters = True

    @abc.abstractmethod
    def attach(self, key: str, rules: list[DeviceRule],
               deny: list[tuple[int, int]] = ()) -> str:
        """Gate the container; returns attached|adopted|noop. Raises
        :class:`GateBackendError` on backend faults. ``deny`` names
        (major, minor) pairs being REVOKED by this mutation: exact-sync
        backends revoke them implicitly (absent from ``rules``), but an
        incremental backend (v1) must write explicit denies for them
        even when its shadow has no record — a lost shadow (restart,
        prior fault) must fail CLOSED, not skip the revocation."""

    @abc.abstractmethod
    def sync(self, key: str, rules: list[DeviceRule],
             deny: list[tuple[int, int]] = ()) -> None:
        """Make the live policy match exactly ``rules`` (in-place);
        ``deny`` as in :meth:`attach`."""

    @abc.abstractmethod
    def read(self, key: str) -> tuple[dict[MajMin, int],
                                      dict[MajMin, int], int]:
        """(live rules, per-key open counts, deny count) for audit."""

    @abc.abstractmethod
    def remove(self, key: str) -> None:
        """Forget the container (cgroup gone / orphan reclaim)."""

    def keys(self) -> list[str]:
        """Containers this backend currently gates (best-effort; v1 and
        a freshly restarted native backend only know what they touched)."""
        return []


class FakeGateBackend(GateBackend):
    """In-memory policy maps + deny simulation — the rig backend.

    The object plays the KERNEL: it survives a simulated worker crash
    (``ChaosRig.restart_worker`` keeps the backend while rebuilding the
    service), so convergence tests exercise exactly the recover-the-
    live-map path the native backend walks. ``fail_ops`` scripts backend
    faults (the degrade-to-legacy seam)."""

    name = "fake"
    baseline = "defaults"

    def __init__(self):
        self.maps: dict[str, dict[MajMin, int]] = {}
        self.opens: dict[str, dict[MajMin, int]] = {}
        self.denies: dict[str, int] = {}
        self.fail_ops = 0           # next N mutations raise (fault seam)
        self.sync_calls = 0
        self._lock = threading.Lock()

    def _maybe_fault(self) -> None:
        if self.fail_ops > 0:
            self.fail_ops -= 1
            raise GateBackendError("injected fake-backend fault")

    def attach(self, key: str, rules: list[DeviceRule],
               deny: list[tuple[int, int]] = ()) -> str:
        del deny                    # exact sync: absence IS revocation
        with self._lock:
            self._maybe_fault()
            adopted = key in self.maps
            self.maps[key] = _rules_dict(rules)
            self.opens.setdefault(key, {})
            self.denies.setdefault(key, 0)
            self.sync_calls += 1
        return "adopted" if adopted else "attached"

    def sync(self, key: str, rules: list[DeviceRule],
             deny: list[tuple[int, int]] = ()) -> None:
        del deny                    # exact sync: absence IS revocation
        with self._lock:
            self._maybe_fault()
            if key not in self.maps:
                raise GateBackendError(f"no live map for {key}")
            self.maps[key] = _rules_dict(rules)
            self.sync_calls += 1

    def read(self, key: str) -> tuple[dict[MajMin, int],
                                      dict[MajMin, int], int]:
        with self._lock:
            return (dict(self.maps.get(key, {})),
                    dict(self.opens.get(key, {})),
                    self.denies.get(key, 0))

    def remove(self, key: str) -> None:
        with self._lock:
            self.maps.pop(key, None)
            self.opens.pop(key, None)
            self.denies.pop(key, None)

    def keys(self) -> list[str]:
        with self._lock:
            return list(self.maps)

    # -- the simulated kernel hook (what a workload's open(2) hits) ----------

    def try_open(self, key: str, major: int, minor: int,
                 access: int = ACC_RW, dev_type: str = "c") -> bool:
        """Simulate a process inside the container opening the device:
        allowed iff the map grants every requested bit (wildcard lookups
        included), with exact open/deny accounting — the in-memory twin
        of the native program's verdict path."""
        with self._lock:
            rules = self.maps.get(key)
            if rules is None:
                return True         # ungated container: unrestricted
            allowed = _match(rules, dev_type, major, minor)
            if access and (access & allowed) == access:
                per_key = self.opens.setdefault(key, {})
                exact = (dev_type, major, minor)
                if exact in rules:
                    per_key[exact] = per_key.get(exact, 0) + 1
                return True
            self.denies[key] = self.denies.get(key, 0) + 1
            return False


class NativeGateBackend(GateBackend):
    """cgroup v2: the real per-cgroup BPF policy map (native/bpf_gate.cc).

    Map fds are cached per cgroup; a restarted worker re-ADOPTS the live
    map from the attached program (the kernel kept it — policy and open
    counters survive the crash). Every OSError from the native layer is a
    :class:`GateBackendError`, degrading the caller to the legacy path.
    """

    name = "native-map"
    baseline = "observed"

    # Discovery-walk bounds: kubelet cgroup layouts are at most 4 levels
    # below the root (kubepods[.slice]/<qos>/<pod>/<container>); the dir
    # cap keeps a pathological hierarchy from stalling boot.
    DISCOVER_MAX_DEPTH = 4
    DISCOVER_MAX_DIRS = 8192

    def __init__(self, bpf_gate, cgroup_root: str = ""):
        self.gate = bpf_gate
        # cgroup hierarchy root for restart-time orphan discovery; ""
        # disables the walk (unit constructions).
        self.cgroup_root = cgroup_root
        self._fds: dict[str, int] = {}
        self._lock = threading.Lock()

    def discover(self) -> int:
        """Walk the kubelet cgroup subtree and ADOPT (recover-only — no
        policy mutation) every live tpumounter map program this process
        holds no handle for. A restarted worker's in-process fd cache is
        empty while crash-surviving kernel maps keep enforcing; without
        this enumeration the converge orphan sweep could only see what
        this incarnation touched, and a dead owner's grants would outlive
        their lease invisibly. Bounded depth + dir count; returns the
        number of maps adopted."""
        if not self.cgroup_root:
            return 0
        import os
        adopted = 0
        visited = 0
        try:
            tops = [e for e in os.listdir(self.cgroup_root)
                    if e.startswith("kubepods")]
        except OSError:
            return 0
        stack = [(os.path.join(self.cgroup_root, top), 1) for top in tops]
        while stack and visited < self.DISCOVER_MAX_DIRS:
            path, depth = stack.pop()
            if not os.path.isdir(path):
                continue
            visited += 1
            with self._lock:
                known = path in self._fds
            if not known:
                try:
                    rc, fd = self.gate.map_recover(path)
                except OSError:
                    rc, fd = 0, -1
                if rc == self.gate.MAP_ADOPTED:
                    with self._lock:
                        self._fds[path] = fd
                    adopted += 1
            if depth >= self.DISCOVER_MAX_DEPTH:
                continue
            try:
                for entry in os.listdir(path):
                    child = os.path.join(path, entry)
                    if os.path.isdir(child):
                        stack.append((child, depth + 1))
            except OSError:
                continue
        return adopted

    def attach(self, key: str, rules: list[DeviceRule],
               deny: list[tuple[int, int]] = ()) -> str:
        del deny                    # exact map sync: absence IS revocation
        try:
            with self._lock:
                fd = self._fds.get(key)
            if fd is not None:
                self.gate.map_sync(fd, rules)
                return "attached"
            rc, fd = self.gate.map_attach(key, rules)
        except OSError as e:
            raise GateBackendError(f"native map attach on {key}: {e}") \
                from e
        if rc == self.gate.MAP_NOOP:
            return "noop"
        with self._lock:
            stale = self._fds.pop(key, None)
            self._fds[key] = fd
        if stale is not None:
            self.gate.map_close(stale)
        return "adopted" if rc == self.gate.MAP_ADOPTED else "attached"

    def sync(self, key: str, rules: list[DeviceRule],
             deny: list[tuple[int, int]] = ()) -> None:
        del deny                    # exact map sync: absence IS revocation
        with self._lock:
            fd = self._fds.get(key)
        if fd is None:
            # restarted process: adopt the live map, then sync rides along
            outcome = self.attach(key, rules)
            if outcome == "noop":
                raise GateBackendError(f"no device program on {key}")
            return
        try:
            self.gate.map_sync(fd, rules)
        except OSError as e:
            raise GateBackendError(f"native map sync on {key}: {e}") from e

    def read(self, key: str) -> tuple[dict[MajMin, int],
                                      dict[MajMin, int], int]:
        with self._lock:
            fd = self._fds.get(key)
        if fd is None:
            # NOT an empty map: we simply hold no handle (restart, prior
            # fault). Composing {} as ground truth would let a caller
            # sync a zero-rule map over the container's whole baseline.
            raise GateBackendError(f"no live map handle for {key}")
        try:
            rules, opens, denies = self.gate.map_read(fd)
        except OSError as e:
            raise GateBackendError(f"native map read on {key}: {e}") from e
        return ({(r.dev_type, r.major, r.minor): r.access for r in rules},
                opens, denies)

    def remove(self, key: str) -> None:
        with self._lock:
            fd = self._fds.pop(key, None)
        if fd is not None:
            self.gate.map_close(fd)

    def keys(self) -> list[str]:
        with self._lock:
            return list(self._fds)


class CgroupV1GateBackend(GateBackend):
    """cgroup v1: the existing ``devices.allow``/``devices.deny`` writes,
    diffed against an in-memory shadow of the granted set (the kernel
    surface is write-only). No exact open counters — the usage sampler's
    edge accounting keeps covering v1 nodes — but revocation still
    crosses the one seam, journaled and audited like the map backends."""

    name = "cgroup-v1"
    baseline = "chips"
    exact_counters = False

    def __init__(self, controller):
        self.controller = controller
        self._shadow: dict[str, dict[MajMin, int]] = {}
        # key -> (pod, container_id): the controller writes by pod, the
        # gate addresses by cgroup dir
        self._addr: dict[str, tuple] = {}
        self._lock = threading.Lock()

    def address(self, key: str, pod, container_id: str) -> None:
        with self._lock:
            self._addr[key] = (pod, container_id)

    def _write(self, key: str, filename: str,
               majmins: list[tuple[int, int]]) -> None:
        with self._lock:
            addr = self._addr.get(key)
        if addr is None:
            raise GateBackendError(f"no v1 address recorded for {key}")
        try:
            self.controller._v1_write_batch(addr[0], addr[1], filename,
                                            majmins)
        except CgroupError as e:
            raise GateBackendError(str(e)) from e

    def attach(self, key: str, rules: list[DeviceRule],
               deny: list[tuple[int, int]] = ()) -> str:
        existed = key in self._shadow
        self.sync(key, rules, deny=deny)
        return "adopted" if existed else "attached"

    def sync(self, key: str, rules: list[DeviceRule],
             deny: list[tuple[int, int]] = ()) -> None:
        desired = _rules_dict(rules)
        with self._lock:
            old = dict(self._shadow.get(key, {}))
        grant = [(k[1], k[2]) for k in desired
                 if k not in old and k[1] is not None and k[2] is not None]
        # Revocation fails CLOSED: the shadow diff alone would skip the
        # deny write whenever the shadow is gone (restart without
        # convergence reaching this container, prior fault) — the
        # caller's explicit ``deny`` list is written UNCONDITIONALLY
        # (minus anything still desired), like the legacy revoke did.
        keep = {(k[1], k[2]) for k in desired}
        revoke = [(k[1], k[2]) for k in old
                  if k not in desired and k[1] is not None
                  and k[2] is not None]
        revoke.extend(mm for mm in deny
                      if mm not in keep and mm not in revoke)
        if revoke:
            self._write(key, "devices.deny", revoke)
        if grant:
            self._write(key, "devices.allow", grant)
        with self._lock:
            self._shadow[key] = desired

    def read(self, key: str) -> tuple[dict[MajMin, int],
                                      dict[MajMin, int], int]:
        with self._lock:
            return dict(self._shadow.get(key, {})), {}, 0

    def remove(self, key: str) -> None:
        with self._lock:
            self._shadow.pop(key, None)
            self._addr.pop(key, None)

    def keys(self) -> list[str]:
        with self._lock:
            return list(self._shadow)


class DeviceGate:
    """The enforcement seam. ``backend=None`` or ``mode="legacy"`` is the
    pure passthrough: every call lands directly on the cgroup controller
    with zero gate state — byte-for-byte today's semantics (pinned)."""

    def __init__(self, controller, backend: GateBackend | None = None,
                 journal=None, mode: str = "auto", node_name: str = ""):
        if mode not in GATE_MODES:
            raise ValueError(f"gate mode must be one of {GATE_MODES}, "
                             f"got {mode!r}")
        self.controller = controller
        self.backend = backend if mode != "legacy" else None
        self.mode = "legacy" if self.backend is None else mode
        self.journal = journal
        self.node_name = node_name
        self._lock = threading.Lock()
        self._entries: dict[str, GateEntry] = {}
        # (key, (major, minor)) -> (cause, tenant, ts): why access to this
        # device was taken away — the deny-reason attribution store
        self._tombstones: dict = {}
        self._deny_ring: collections.deque = collections.deque(
            maxlen=DENY_RING_SIZE)
        # per-key counter baselines for delta polling (pump)
        self._seen_denies: dict[str, int] = {}
        self._seen_opens: dict[str, dict[MajMin, int]] = {}
        self._counts = {"grants": 0, "revokes": 0, "faults": 0,
                        "denials": 0, "reclaims": 0}
        self._drift: list[dict] = []
        self._converge_stats: dict = {}
        # container key -> the (major, minor) pairs its /dev held before
        # its first grant (None = not observable then); persisted in the
        # journal, so a restarted worker's gate starts from what the dead
        # one observed
        self._held: dict[str, set[tuple[int, int]] | None] = (
            journal.baselines() if journal is not None else {})

    @property
    def live(self) -> bool:
        """Enforcing through a gate backend (False = legacy passthrough)."""
        return self.backend is not None

    # -- policy composition ----------------------------------------------------

    def _compose(self, pod, container_id: str, chips: list[GPUDevice],
                 exclude: set[tuple[int, int]] = frozenset(),
                 keep: list[tuple[int, int]] = ()) -> list[DeviceRule]:
        """The rule set for ``chips`` on this backend's baseline, plus the
        ``keep`` pairs: companions a detach leaves granted although no
        remaining GPU needs them (the container held them before any
        attach)."""
        kept = [DeviceRule("c", ACC_RW | ACC_MKNOD, major, minor)
                for major, minor in keep]
        if self.backend.baseline == "chips":
            return [DeviceRule("c", ACC_RW | ACC_MKNOD, major, minor)
                    for major, minor in _chip_majmins(chips)
                    if (major, minor) not in exclude] + kept
        observed: list[DeviceRule] = []
        if self.backend.baseline == "observed":
            observed = self.controller.observed_baseline(pod, container_id,
                                                         exclude)
        return rules_for_chips(chips, observed=observed + kept)

    def _journal_gate(self, op: str, namespace: str, pod_name: str,
                      key: str, chips: list[GPUDevice],
                      cause: str = "") -> str | None:
        if self.journal is None:
            return None
        from gpumounter_tpu_torch.utils.trace import current_span
        span = current_span()
        rid = span._trace.rid if span is not None else ""
        rid = "" if rid == "-" else rid
        return self.journal.record_gate(
            rid, namespace, pod_name, op,
            [c.uuid for c in chips], key=key, cause=cause)

    # -- the container's pre-attach baseline -----------------------------------

    def held(self, pod, container_id: str) -> set[tuple[int, int]] | None:
        """The char nodes the container held before its first grant
        through this gate; None when that was never observed."""
        key = self.controller.container_dir(pod, container_id)
        with self._lock:
            return self._held.get(key)

    def revoked(self, pod, container_id: str, chips: list[GPUDevice],
                remaining_chips: list[GPUDevice]) -> list[tuple[int, int]]:
        """The (major, minor) pairs :meth:`revoke` takes away from this
        container (``revoked_majmins`` under its recorded baseline) — and
        so the nodes a detach may unlink."""
        return revoked_majmins(chips, remaining_chips,
                               self.held(pod, container_id))

    def _record_held(self, pod, container_id: str) -> None:
        key = self.controller.container_dir(pod, container_id)
        with self._lock:
            if key in self._held:
                return
        held = self.controller.held_majmins(pod, container_id)
        with self._lock:
            if key in self._held:
                return
            self._held[key] = held
        if self.journal is not None:
            self.journal.record_baseline(key, held)

    def _forget_held(self, key: str) -> None:
        """Drop a reclaimed container's baseline, in memory and journal."""
        with self._lock:
            self._held.pop(key, None)
        if self.journal is not None:
            self.journal.drop_baseline(key)

    # -- the two sanctioned mutations ------------------------------------------

    def grant(self, pod, container_id: str,
              desired_chips: list[GPUDevice]) -> None:
        """Make the container's device access include exactly
        ``desired_chips`` on top of its baseline. Crosses the backend as
        one in-place map sync; any backend fault degrades to the legacy
        controller path — never to an unenforced attach."""
        self._record_held(pod, container_id)
        if not self.live:
            self.controller.sync_device_access(pod, container_id,
                                               desired_chips)
            return
        self._mutate("grant", pod, container_id, desired_chips,
                     desired_chips, cause="")

    def revoke(self, pod, container_id: str, chips: list[GPUDevice],
               remaining_chips: list[GPUDevice], cause: str = "") -> None:
        """Cut access to ``chips`` FIRST (instant in-place deny — no
        program replacement, no nsenter, no unlink dependence), keeping
        ``remaining_chips`` and the container's pre-attach companions
        granted. Callers clean device nodes up only after this returns.
        ``cause`` (``lease-expired:...``, ``preempted:...``) lands in the
        journal record and the deny-reason tombstones."""
        held = self.held(pod, container_id)
        if not self.live:
            self.controller.revoke_device_access(pod, container_id, chips,
                                                 remaining_chips, held=held)
            return
        exclude = set(revoked_majmins(chips, remaining_chips, held))
        needed = set(_chip_majmins(remaining_chips))
        keep = [mm for mm in _chip_majmins(chips)
                if mm not in exclude and mm not in needed]
        self._mutate("revoke", pod, container_id, chips, remaining_chips,
                     cause=cause, exclude=exclude, held=held, keep=keep)

    def _mutate(self, op: str, pod, container_id: str,
                op_chips: list[GPUDevice], desired_chips: list[GPUDevice],
                cause: str, exclude: set = frozenset(),
                held: set[tuple[int, int]] | None = frozenset(),
                keep: list[tuple[int, int]] = ()) -> None:
        namespace, pod_name = objects.namespace(pod), objects.name(pod)
        key = self.controller.container_dir(pod, container_id)
        jid = self._journal_gate(op, namespace, pod_name, key, op_chips,
                                 cause=cause)
        try:
            if isinstance(self.backend, CgroupV1GateBackend):
                self.backend.address(key, pod, container_id)
            rules = self._compose(pod, container_id, desired_chips,
                                  exclude=exclude, keep=keep)
            deny = sorted(exclude) if op == "revoke" else []
            with self._lock:
                known = key in self._entries
            if known and key in self.backend.keys():
                self.backend.sync(key, rules, deny=deny)
                outcome = "ok"
            else:
                # first touch, or the backend lost the key (process
                # restart, prior fault): attach adopts or re-establishes
                outcome = self.backend.attach(key, rules, deny=deny)
                self._prime_counters(key)
        except (GateBackendError, CgroupError) as e:
            # Degrade, never un-enforce: the legacy controller applies the
            # SAME mutation through the pre-gate machinery. The backend's
            # state for this container is DROPPED (on a real v2 node the
            # legacy program-replacement displaced the map program), and
            # the entry tracks the applied desired state as legacy-
            # enforced — enforcement accounting survives the fault.
            REGISTRY.gate_syncs.inc(backend=self.backend.name,
                                    outcome="fault")
            with self._lock:
                self._counts["faults"] += 1
            EVENTS.emit("gate_fallback", namespace=namespace, pod=pod_name,
                        node=self.node_name, op=op, error=str(e)[:200])
            logger.warning("gate %s on %s degraded to legacy path: %s",
                           op, key, e)
            if op == "grant":
                self.controller.sync_device_access(pod, container_id,
                                                   desired_chips)
            else:
                self.controller.revoke_device_access(
                    pod, container_id, op_chips, desired_chips, held=held)
            try:
                self.backend.remove(key)
            except GateBackendError:
                pass
            now = time.monotonic()
            with self._lock:
                self._entries[key] = GateEntry(
                    key=key, namespace=namespace, pod=pod_name,
                    container_id=container_id, tenant=namespace,
                    chips={c.uuid: _chip_majmins([c])
                           for c in desired_chips},
                    rules=0, enforced=False, updated_at=now)
                if op == "revoke":
                    for major, minor in exclude:
                        self._tombstone_locked(key, (major, minor),
                                               cause or "detach",
                                               namespace, now)
            if jid is not None:
                self.journal.gate_commit(jid)
            return
        REGISTRY.gate_syncs.inc(backend=self.backend.name,
                                outcome=outcome if outcome != "ok"
                                else op)
        tenant = namespace
        now = time.monotonic()
        with self._lock:
            self._counts["grants" if op == "grant" else "revokes"] += 1
            chip_map = {c.uuid: _chip_majmins([c]) for c in desired_chips}
            self._entries[key] = GateEntry(
                key=key, namespace=namespace, pod=pod_name,
                container_id=container_id, tenant=tenant, chips=chip_map,
                rules=len(rules), enforced=outcome != "noop",
                updated_at=now)
            if op == "revoke":
                for major, minor in exclude:
                    self._tombstone_locked(key, (major, minor),
                                           cause or "detach", tenant, now)
            else:
                for chip in desired_chips:
                    for mm in _chip_majmins([chip]):
                        self._tombstones.pop((key, mm), None)
        if jid is not None:
            self.journal.gate_commit(jid)

    def _prime_counters(self, key: str) -> None:
        """Baseline the pump deltas at the map's CURRENT counters on
        first touch. An ADOPTED map carries its whole lifetime's
        open/deny history (that survival is the point) — replaying it as
        a fresh delta would spike `device_opens_total`, mass-record
        reasonless denials and fire a false denial-burst bundle on every
        worker restart of a node that ever denied."""
        with self._lock:
            primed = key in self._seen_denies
        if primed:
            return
        try:
            _rules, opens, denies = self.backend.read(key)
        except GateBackendError:
            return
        with self._lock:
            self._seen_denies.setdefault(key, denies)
            self._seen_opens.setdefault(key, dict(opens))

    def _tombstone_locked(self, key: str, majmin: tuple[int, int],
                          cause: str, tenant: str, now: float) -> None:
        if len(self._tombstones) >= TOMBSTONE_MAX:
            cutoff = now - TOMBSTONE_TTL_S
            self._tombstones = {
                k: v for k, v in self._tombstones.items()
                if v[2] > cutoff}
        self._tombstones[(key, majmin)] = (cause, tenant, now)

    # -- the simulated/audited open path ---------------------------------------

    def try_open(self, key: str, major: int, minor: int,
                 access: int = ACC_RW, dev_type: str = "c") -> bool:
        """What a workload's ``open(2)`` answers under this gate — the
        test/sim surface (rigs drive it through the fake backend; on a
        real node the kernel program IS this function). Denials land in
        the deny ring with the revocation cause attributed from
        tombstones, feed ``device_denials_total{tenant,reason}`` and the
        denial-burst flight trigger."""
        if not self.live or not hasattr(self.backend, "try_open"):
            return True
        allowed = self.backend.try_open(key, major, minor, access,
                                        dev_type=dev_type)
        if not allowed:
            self._record_denial(key, (major, minor))
        return allowed

    def _record_denial(self, key: str, majmin: tuple[int, int],
                       count: int = 1,
                       advance_baseline: bool = True) -> None:
        with self._lock:
            stone = self._tombstones.get((key, majmin))
            entry = self._entries.get(key)
            if stone is not None:
                reason = f"revoked:{stone[0].split(':', 1)[0]}"
                tenant = stone[1]
            else:
                reason = "ungranted"
                tenant = entry.tenant if entry is not None else ""
            self._counts["denials"] += count
            self._deny_ring.append({
                "ts": round(time.time(), 3), "cgroup": key,
                "device": (f"{majmin[0]}:{majmin[1]}"
                           if majmin[0] is not None else "?"),
                "tenant": tenant, "reason": reason, "count": count})
            if advance_baseline:
                # a try_open-simulated denial bumped the backend counter
                # synchronously: advance the pump baseline so the polled
                # counters don't re-count it (pump advances its own
                # baseline in its delta-claiming critical section)
                self._seen_denies[key] = \
                    self._seen_denies.get(key, 0) + count
        REGISTRY.device_denials.inc(count, tenant=tenant, reason=reason)
        EVENTS.emit("device_denied", namespace="", pod="",
                    node=self.node_name, device=f"{majmin[0]}:{majmin[1]}",
                    tenant=tenant, reason=reason, count=count)
        RECORDER.note("device_denial_burst", tenant=tenant, reason=reason)

    def pump(self) -> dict:
        """Poll backend counters (sampler loop / reconciler pass — never a
        request thread): attribute exact open deltas to tenants
        (``device_opens_total{tenant,outcome="attributed"}`` — the
        per-syscall counts that replace edge accounting where the gate is
        live) and convert kernel deny deltas into reasoned denial records.
        Returns ``{"opens": {(major, minor): total}, "covered":
        {(major, minor), ...}}`` for the usage sampler's /utilz join."""
        if not self.live or not self.backend.exact_counters:
            # v1 (or legacy): no kernel counters — the sampler's edge
            # accounting keeps covering these chips, exactly as before
            return {"opens": {}, "covered": set()}
        totals: dict[tuple[int, int], int] = {}
        covered: set[tuple[int, int]] = set()
        with self._lock:
            entries = list(self._entries.values())
        for entry in entries:
            try:
                rules, opens, denies = self.backend.read(entry.key)
            except GateBackendError:
                continue
            chip_mms = {mm for mms in entry.chips.values() for mm in mms}
            covered |= chip_mms
            with self._lock:
                seen = self._seen_opens.setdefault(entry.key, {})
                for mkey, total in opens.items():
                    if mkey[1] is None or mkey[2] is None:
                        continue
                    mm = (mkey[1], mkey[2])
                    delta = total - seen.get(mkey, 0)
                    seen[mkey] = total
                    if mm in chip_mms:
                        totals[mm] = totals.get(mm, 0) + total
                        if delta > 0:
                            REGISTRY.device_opens.inc(
                                delta, tenant=entry.tenant,
                                outcome="attributed")
                # CLAIM the deny delta inside this critical section: a
                # concurrent pump (sampler thread vs reconciler pass)
                # must not attribute the same kernel delta twice — nor
                # may the baseline advance be deferred to
                # _record_denial's separate lock acquisition
                deny_delta = denies - self._seen_denies.get(entry.key, 0)
                if deny_delta > 0:
                    self._seen_denies[entry.key] = denies
            if deny_delta > 0:
                # kernel-counted denials: attribute the newest tombstone's
                # cause for this cgroup (else the access was never granted)
                with self._lock:
                    stones = [(mm, v) for (k, mm), v
                              in self._tombstones.items()
                              if k == entry.key]
                newest = max(stones, key=lambda s: s[1][2], default=None)
                self._record_denial(
                    entry.key,
                    newest[0] if newest else (None, None),
                    count=deny_delta, advance_baseline=False)
        return {"opens": totals, "covered": covered}

    # -- crash convergence + drift audit ---------------------------------------

    def _strip_chips(self, key: str,
                     chip_majmins: set[tuple[int, int]]) -> bool:
        """REVOKE chip access on a container whose owner is gone, by
        syncing the live policy to (live minus chip rules) IN the
        backend. Closing/forgetting the map would not revoke anything —
        the attached kernel program holds its own map reference, and a
        forgotten fake map reads as unrestricted — so reclaim must be a
        sync, never a forget. Returns False when the backend could not
        be read/synced (cgroup usually died with the pod; nothing left
        to enforce on)."""
        if key not in self.backend.keys():
            # the backend holds no state for this container (the
            # mutation degraded to the legacy path, whose program dies
            # with the cgroup): nothing for the gate to revoke
            return True
        try:
            live, _opens, _denies = self.backend.read(key)
            keep = [DeviceRule(t, access, major, minor)
                    for (t, major, minor), access in live.items()
                    if not (t == "c" and major is not None
                            and (major, minor) in chip_majmins)]
            self.backend.sync(key, keep, deny=sorted(chip_majmins))
            return True
        except GateBackendError as e:
            logger.warning("gate reclaim sync on %s failed: %s", key, e)
            return False

    def converge(self, desired: list[tuple],
                 all_chip_majmins: set[tuple[int, int]] = frozenset()
                 ) -> dict:
        """Re-derive the live maps from attachment ground truth (startup
        replay): ``desired`` is ``[(pod, container_id, chips), ...]`` for
        every live attachment on this node. Each is re-granted (an exact
        sync — orphan map ENTRIES vanish, missing grants return); any
        backend map whose container is not in the desired set is an
        orphan grant outliving its attachment — its chip rules
        (``all_chip_majmins`` = this node's chip+companion universe) are
        REVOKED by an in-place sync. A failed re-grant is counted: the
        caller must keep its pending journal records for the next boot
        instead of resolving them over a divergent map."""
        if not self.live:
            return {}
        # restart-time enumeration: a backend that can discover crash-
        # surviving gate state beyond its in-process cache (native: walk
        # the kubelet cgroup subtree, recover-only) does so BEFORE the
        # orphan sweep — keys() alone only knows what this incarnation
        # touched
        discover = getattr(self.backend, "discover", None)
        if discover is not None:
            try:
                found = discover()
                if found:
                    logger.info("gate converge: discovered %d live "
                                "map(s) from a previous incarnation",
                                found)
            except OSError as e:
                logger.warning("gate discovery walk failed: %s", e)
        restored = 0
        failed = 0
        wanted_keys = set()
        for pod, container_id, chips in desired:
            key = self.controller.container_dir(pod, container_id)
            wanted_keys.add(key)
            try:
                self.grant(pod, container_id, chips)
                restored += 1
            except (ActuationError, OSError) as e:
                failed += 1
                logger.warning("gate converge: re-grant for %s/%s "
                               "failed: %s", objects.namespace(pod),
                               objects.name(pod), e)
        orphans = 0
        for key in self.backend.keys():
            if key in wanted_keys:
                continue
            if not self._strip_chips(key, set(all_chip_majmins)):
                failed += 1
                continue
            orphans += 1
            with self._lock:
                entry = self._entries.pop(key, None)
                self._counts["reclaims"] += 1
            self._forget_held(key)
            EVENTS.emit("gate_reclaim", node=self.node_name,
                        namespace=entry.namespace if entry else "",
                        pod=entry.pod if entry else "", key=key,
                        cause="replay-orphan")
        stats = {"restored": restored, "orphans_revoked": orphans}
        if failed:
            stats["failed"] = failed
        with self._lock:
            self._converge_stats = dict(stats, ts=round(time.time(), 3))
        EVENTS.emit("gate_converge", node=self.node_name, **stats)
        return stats

    def audit(self, live_owners: set[tuple[str, str]]) -> list[dict]:
        """Reconciler pass: gate-vs-lease drift. An entry whose owner pod
        the reconciler proved dead is a grant outliving its attachment —
        its chip rules are REVOKED by an in-place backend sync (the
        cgroup usually died with the pod; this covers the one that
        didn't), counted and surfaced on /gatez + doctor."""
        if not self.live:
            return []
        drifted: list[dict] = []
        with self._lock:
            entries = list(self._entries.values())
        for entry in entries:
            if (entry.namespace, entry.pod) in live_owners:
                continue
            if not entry.chips:
                continue            # defaults-only map: nothing leased
            drifted.append({"cgroup": entry.key,
                            "owner": f"{entry.namespace}/{entry.pod}",
                            "chips": sorted(entry.chips)})
            if not self._strip_chips(entry.key,
                                     {mm for mms in entry.chips.values()
                                      for mm in mms}):
                # revoke did NOT land (backend trouble): keep the entry
                # so the NEXT audit pass retries — popping it would make
                # the still-live grant invisible to every future audit
                continue
            now = time.monotonic()
            self._forget_held(entry.key)
            with self._lock:
                self._entries.pop(entry.key, None)
                self._counts["reclaims"] += 1
                for mms in entry.chips.values():
                    for mm in mms:
                        self._tombstone_locked(entry.key, mm,
                                               "owner-gone", entry.tenant,
                                               now)
            EVENTS.emit("gate_reclaim", node=self.node_name,
                        namespace=entry.namespace, pod=entry.pod,
                        key=entry.key, cause="owner-gone")
            logger.warning("gate drift: revoked %s (owner %s/%s gone)",
                           entry.key, entry.namespace, entry.pod)
        with self._lock:
            self._drift = drifted
        REGISTRY.gate_drift.set(len(drifted))
        return drifted

    # -- the /gatez view -------------------------------------------------------

    def owners(self) -> set[tuple[str, str]]:
        """(namespace, pod) of every live gate entry with granted chips —
        the reconciler audit's working set."""
        with self._lock:
            return {(e.namespace, e.pod) for e in self._entries.values()
                    if e.chips}

    def granted_uuids(self) -> set[str]:
        """Chip uuids with a live gate grant (chaos invariant: must never
        exceed the chips backed by a live lease/attachment)."""
        with self._lock:
            return {uuid for entry in self._entries.values()
                    for uuid in entry.chips}

    def snapshot(self) -> dict:
        """The GET /gatez payload — already-collected state only."""
        if not self.live:
            return {"enabled": False, "mode": self.mode}
        with self._lock:
            entries = [dataclasses.asdict(e)
                       for e in self._entries.values()]
            counts = dict(self._counts)
            ring = list(self._deny_ring)
            drift = list(self._drift)
            converge = dict(self._converge_stats)
        for entry in entries:
            entry["chips"] = sorted(entry["chips"])
            entry.pop("updated_at", None)
        pending = (len(self.journal.pending_gates())
                   if self.journal is not None else 0)
        return {
            "enabled": True,
            "mode": self.mode,
            "backend": self.backend.name,
            "node": self.node_name,
            "entries": sorted(entries, key=lambda e: e["key"]),
            "counts": counts,
            "denials": {"total": counts["denials"],
                        "recent": ring[-32:]},
            "drift": {"count": len(drift), "entries": drift},
            "converge": converge,
            "journal_pending": pending,
        }


def build_gate(settings, controller, journal=None) -> DeviceGate:
    """Production wiring (worker/main.py): pick the strongest backend for
    this node under ``settings.gate_mode == "auto"`` (``TPU_GATE``), or the
    byte-for-byte legacy passthrough under ``"legacy"``; the gate's node
    name is ``settings.node_name`` (``NODE_NAME``). A native stack that
    cannot load (no lib, unsupported kernel, no CAP_BPF) degrades to
    legacy — LOUD, counted, but never unenforced."""
    node_name = settings.node_name
    if settings.gate_mode == "legacy":
        return DeviceGate(controller, None, journal=journal, mode="legacy",
                          node_name=node_name)
    backend: GateBackend | None = None
    if controller.version == 2:
        try:
            from gpumounter_tpu_torch.actuation.bpf import BpfGate
            bpf = controller._gate or BpfGate()
            if bpf.supported():
                backend = NativeGateBackend(
                    bpf, cgroup_root=controller.host.cgroup_root)
            else:
                logger.error(
                    "TPU_GATE=auto but this kernel/caller cannot load "
                    "cgroup-device programs (CAP_BPF+CAP_SYS_ADMIN?); "
                    "device gate DEGRADED to legacy program-replacement")
        except OSError as e:
            logger.error("TPU_GATE=auto but libbpfgate unavailable (%s); "
                         "device gate DEGRADED to legacy", e)
    else:
        backend = CgroupV1GateBackend(controller)
    if backend is None:
        REGISTRY.gate_syncs.inc(backend="native-map", outcome="fault")
        return DeviceGate(controller, None, journal=journal, mode="legacy",
                          node_name=node_name)
    return DeviceGate(controller, backend, journal=journal, mode="auto",
                      node_name=node_name)
