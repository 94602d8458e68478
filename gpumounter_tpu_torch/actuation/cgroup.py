"""Container cgroup resolution and device-permission control (the port of
:mod:`gpumounter_tpu.actuation.cgroup`).

Ref ``pkg/util/cgroup/cgroup.go``: reconstruct the kubelet-managed cgroup path
for a container (driver- and QoS-dependent, :52-113), list its PIDs
(:120-141), and grant/revoke device access (:143-169). Deliberate widenings
over the reference, which supported only cgroup v1 + docker:

- **cgroup v2** (GKE >= 1.26): no ``devices.allow`` file exists;
  permissioning goes through the eBPF gate
  (:mod:`gpumounter_tpu_torch.actuation.bpf`), *syncing* the container's
  program to (defaults ∪ desired GPUs).
- **containerd / CRI-O scopes** (GKE default is containerd): systemd scope
  prefixes ``cri-containerd-`` / ``crio-`` besides ``docker-``
  (ref cgroup.go:106-113 hardcoded ``docker-``).
- Direct file writes instead of shelling ``sh -c echo ...``
  (ref cgroup.go:143-155 execs a shell per write).

On v1 a grant writes ``c 195:N rw`` for the GPU and the same for each
companion (``nvidiactl`` at 195:255, ``nvidia-uvm`` and ``-tools`` at the
major ``/proc/devices`` gives). A revoke denies only what
:func:`~gpumounter_tpu_torch.actuation.bpf.revoked_majmins` gives: the
GPU's own node, and a shared companion only when neither a remaining GPU
nor the container's pre-attach baseline holds it (the reference only ever
denies ``c 195:<minor>``, cgroup.go:157-169).
"""

from __future__ import annotations

import os
import threading

from gpumounter_tpu_torch.actuation.bpf import (BpfGate, chip_majmins,
                                                container_device_rules,
                                                revoked_majmins,
                                                rules_for_chips)
from gpumounter_tpu_torch.device.model import GPUDevice
from gpumounter_tpu_torch.k8s import objects
from gpumounter_tpu_torch.utils import consts
from gpumounter_tpu_torch.utils.config import HostPaths
from gpumounter_tpu_torch.utils.errors import CgroupError
from gpumounter_tpu_torch.utils.log import get_logger

logger = get_logger("actuation.cgroup")

_SYSTEMD_SCOPE_PREFIX = {
    "docker": "docker",
    "containerd": "cri-containerd",
    "cri-o": "crio",
    "": "cri-containerd",  # bare id: assume GKE default runtime
}



def detect_cgroup_version(cgroup_root: str) -> int:
    """v2 iff the unified hierarchy's cgroup.controllers sits at the root."""
    if os.path.exists(os.path.join(cgroup_root, "cgroup.controllers")):
        return 2
    return 1


class CgroupResolver:
    """Renders kubelet cgroup paths for both drivers (ref cgroup.go:52-113)."""

    def __init__(self, driver: str = "systemd"):
        if driver not in ("systemd", "cgroupfs"):
            raise CgroupError(f"unsupported cgroup driver: {driver}")
        self.driver = driver

    def pod_cgroup(self, pod: objects.Pod) -> str:
        qos = objects.qos_class(pod)
        pod_uid = objects.uid(pod)
        if not pod_uid:
            raise CgroupError(f"pod {objects.name(pod)} has no UID")
        if self.driver == "cgroupfs":
            parts = ["kubepods"]
            if qos == objects.QOS_BURSTABLE:
                parts.append("burstable")
            elif qos == objects.QOS_BEST_EFFORT:
                parts.append("besteffort")
            parts.append(f"pod{pod_uid}")
            return "/".join(parts)
        # systemd driver: nested .slice directories with dash-expanded names
        uid_r = pod_uid.replace("-", "_")
        if qos == objects.QOS_GUARANTEED:
            leaf = f"kubepods-pod{uid_r}.slice"
            return f"kubepods.slice/{leaf}"
        qos_token = ("burstable" if qos == objects.QOS_BURSTABLE
                     else "besteffort")
        return (f"kubepods.slice/kubepods-{qos_token}.slice/"
                f"kubepods-{qos_token}-pod{uid_r}.slice")

    def container_cgroup(self, pod: objects.Pod, raw_container_id: str) -> str:
        runtime, cid = objects.parse_container_id(raw_container_id)
        base = self.pod_cgroup(pod)
        if self.driver == "cgroupfs":
            return f"{base}/{cid}"
        prefix = _SYSTEMD_SCOPE_PREFIX.get(runtime)
        if prefix is None:
            raise CgroupError(f"unknown container runtime {runtime!r}")
        return f"{base}/{prefix}-{cid}.scope"


class CgroupDeviceController:
    """Grants/revokes device access on a container cgroup, v1 or v2."""

    def __init__(self, host: HostPaths | None = None, driver: str = "systemd",
                 bpf_gate: BpfGate | None = None,
                 version: int | None = None):
        self.host = host or HostPaths()
        self.resolver = CgroupResolver(driver)
        self.version = (version if version is not None
                        else detect_cgroup_version(self.host.cgroup_root))
        self._gate = bpf_gate
        # Last successfully observed (post-exclude) /dev baseline per
        # container cgroup dir. When a sync finds no readable PID (all
        # processes exited/unreadable mid-sync), proceeding with
        # defaults+chips only would silently revoke runtime-granted devices
        # — the exact bug the observed-/dev composition prevents. Fall back
        # to this cache instead; with neither source, fail closed.
        self._observed_cache: dict[str, list] = {}
        self._observed_cache_lock = threading.Lock()
        logger.info("cgroup v%d, driver=%s, root=%s", self.version, driver,
                    self.host.cgroup_root)

    # -- path helpers ----------------------------------------------------------

    def _v1_devices_dir(self, pod: objects.Pod, container_id: str) -> str:
        # ref cgroup.go:115-118: devices subtree rooted at
        # <cgroup_root>/devices
        rel = self.resolver.container_cgroup(pod, container_id)
        return os.path.join(self.host.cgroup_root, "devices", rel)

    def _v2_cgroup_dir(self, pod: objects.Pod, container_id: str) -> str:
        rel = self.resolver.container_cgroup(pod, container_id)
        return os.path.join(self.host.cgroup_root, rel)

    def container_dir(self, pod: objects.Pod, container_id: str) -> str:
        if self.version == 1:
            return self._v1_devices_dir(pod, container_id)
        return self._v2_cgroup_dir(pod, container_id)

    # -- PIDs ------------------------------------------------------------------

    def get_pids(self, pod: objects.Pod, container_id: str) -> list[int]:
        """Ref cgroup.go:120-141 GetCgroupPIDs (cgroup.procs)."""
        procs = os.path.join(self.container_dir(pod, container_id),
                             "cgroup.procs")
        try:
            with open(procs) as f:
                return [int(line) for line in f.read().split() if line]
        except OSError as e:
            raise CgroupError(f"cannot read {procs}: {e}") from e
        except ValueError as e:
            raise CgroupError(f"garbled {procs}: {e}") from e

    # -- device permissions ----------------------------------------------------

    def sync_device_access(self, pod: objects.Pod, container_id: str,
                           desired_chips: list[GPUDevice]) -> None:
        """Make the container's device permissions include exactly
        ``desired_chips`` (on top of the container defaults).

        v1 semantics are inherently incremental (allow/deny files), so the
        caller passes the *full* desired set and we diff against what we can
        infer; v2 replaces the BPF program with defaults+desired in one shot.
        """
        if self.version == 2:
            self._v2_sync(pod, container_id, desired_chips)
        else:
            # v1 has no read-back of current rules; write allows for all
            # desired (idempotent — duplicate allows are no-ops).
            self._v1_write_batch(pod, container_id, "devices.allow",
                                 chip_majmins(desired_chips))

    def revoke_device_access(self, pod: objects.Pod, container_id: str,
                             chips_to_remove: list[GPUDevice],
                             remaining_chips: list[GPUDevice],
                             held: set[tuple[int, int]] | None = frozenset()
                             ) -> None:
        """Revoke what :func:`revoked_majmins` gives for this detach:
        ``held`` is the container's pre-attach baseline (None = unknown,
        so shared companions stay)."""
        revoked = revoked_majmins(chips_to_remove, remaining_chips, held)
        if self.version == 2:
            # The detached GPUs' device nodes are still present in the
            # container's /dev at this point (unmount removes nodes only
            # after the cgroup sync), so the observed-/dev scan would see
            # them and re-grant exactly the access being revoked. Exclude
            # the revoked (major, minor) pairs; a companion that stays is
            # carried by the scan.
            self._v2_sync(pod, container_id, remaining_chips,
                          exclude=set(revoked))
        else:
            self._v1_write_batch(pod, container_id, "devices.deny", revoked)

    def _v1_write_batch(self, pod: objects.Pod, container_id: str,
                        filename: str,
                        majmins: list[tuple[int, int]]) -> None:
        """Ref cgroup.go:143-169 Add/RemoveGPUDevicePermission, as direct
        writes of ``c <major>:<minor> rw`` instead of shelling echo. All of
        a batch's rules go through ONE open of the devices file —
        the v1 side of the fused-actuation discipline. Each rule stays its
        own write(2): the kernel parses one op per write, so fusing the
        file open must not fuse the ops themselves."""
        if not majmins:
            return
        path = os.path.join(self._v1_devices_dir(pod, container_id), filename)
        entries = [f"c {major}:{minor} {consts.DEVICE_CGROUP_PERMISSIONS}"
                   for major, minor in majmins]
        try:
            # O_APPEND, kernel-equivalent to "w" (the devices files are
            # write-only ops, not stores). Append is load-bearing for
            # process-level verification: subprocess boot tests and operators
            # inspecting a fixture/host tree can only observe grants through
            # this file, and truncate-mode would erase all but the last op.
            with open(path, "a") as f:
                for entry in entries:
                    f.write(entry + "\n")
                    # flush per rule: the kernel parses devices.allow/deny
                    # one rule per write(2), and the buffered writer would
                    # otherwise coalesce the batch into a single write
                    # that the kernel truncates at the first newline
                    f.flush()
        except OSError as e:
            raise CgroupError(
                f"write {entries!r} to {path} failed: {e}") from e
        logger.debug("v1 %s <- %d rule(s)", path, len(entries))

    def held_majmins(self, pod: objects.Pod, container_id: str
                     ) -> set[tuple[int, int]] | None:
        """(major, minor) of every char node in the container's /dev now,
        read through its first PID whose /dev is readable; None when none
        is. The device gate records it before a container's first grant,
        as the baseline a revoke must leave alone."""
        try:
            pids = self.get_pids(pod, container_id)
        except CgroupError:
            return None
        for pid in pids:
            try:
                rules = container_device_rules(self.host.proc_root, pid)
            except OSError:
                continue
            return {(r.major, r.minor) for r in rules if r.dev_type == "c"}
        return None

    def observed_baseline(self, pod: objects.Pod, container_id: str,
                          exclude: set[tuple[int, int]] = frozenset()
                          ) -> list:
        """The runtime-granted device baseline of the container: its live
        /dev read through procfs, cached per cgroup dir. The replacement
        program (or gate policy map) must preserve every device the
        runtime already granted this container (spec devices, device
        plugins, GKE extras) — assumed-runc-defaults alone would silently
        revoke them. Fails CLOSED (CgroupError) when no live PID is
        readable and no cached baseline exists — shared seam of the
        legacy v2 program-replacement sync and the map-driven device gate
        (actuation/gate.py)."""
        cgroup_dir = self._v2_cgroup_dir(pod, container_id)
        observed: list | None = None
        try:
            pids = self.get_pids(pod, container_id)
        except CgroupError as e:
            logger.warning("cannot read container PIDs of %s: %s",
                           container_id, e)
            pids = []
        for pid in pids:
            if not os.path.isdir(os.path.join(self.host.proc_root,
                                              str(pid))):
                continue
            try:
                observed = container_device_rules(self.host.proc_root, pid)
                break
            except OSError:
                continue  # pid exited between liveness check and /dev scan
        if observed is None:
            with self._observed_cache_lock:
                cached = self._observed_cache.get(cgroup_dir)
            if cached is None:
                raise CgroupError(
                    f"no live/readable PID in container {container_id} and "
                    "no cached device baseline; refusing a sync that could "
                    "silently revoke runtime-granted devices (fail closed)")
            logger.warning(
                "no live PID in container %s; falling back to cached "
                "device baseline (%d rules)", container_id, len(cached))
            observed = list(cached)
        if exclude:
            observed = [r for r in observed
                        if not (r.dev_type == "c"
                                and (r.major, r.minor) in exclude)]
        with self._observed_cache_lock:
            # move-to-end so the bound evicts the least-recently-synced
            # container, not the longest-lived active one
            self._observed_cache.pop(cgroup_dir, None)
            if len(self._observed_cache) >= 4096:
                self._observed_cache.pop(next(iter(self._observed_cache)))
            self._observed_cache[cgroup_dir] = list(observed)
        return observed

    def _v2_sync(self, pod: objects.Pod, container_id: str,
                 chips: list[GPUDevice],
                 exclude: set[tuple[int, int]] = frozenset()) -> None:
        cgroup_dir = self._v2_cgroup_dir(pod, container_id)
        if not os.path.isdir(cgroup_dir):
            raise CgroupError(f"container cgroup not found: {cgroup_dir}")
        observed = self.observed_baseline(pod, container_id, exclude)
        try:
            if self._gate is None:
                self._gate = BpfGate()
            rc = self._gate.sync(cgroup_dir,
                                 rules_for_chips(chips, observed=observed))
        except OSError as e:
            raise CgroupError(
                f"BPF device-gate sync on {cgroup_dir} failed ({e}); "
                "is this a cgroup2 mount and does the worker have CAP_BPF + "
                "CAP_SYS_ADMIN?") from e
        logger.debug("v2 sync %s -> rc=%d (%d chips, %d observed rules)",
                     cgroup_dir, rc, len(chips), len(observed))
