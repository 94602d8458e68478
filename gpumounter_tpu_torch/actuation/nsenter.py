"""Device-node lifecycle inside the target container's mount namespace (the
port of :mod:`gpumounter_tpu.actuation.nsenter`).

Ref ``pkg/util/namespace/namespace.go``: the reference builds
``nsenter --target <pid> --mount sh -c "mknod -m 666 /dev/nvidiaN c 195 M"``
(:70-177), which requires the *target image* to ship ``sh`` and ``mknod``
(their FAQ documents this limitation, ``docs/guide/FAQ.md:3-4``).

We default to a stronger mechanism: with ``hostPID`` the container's root
filesystem is addressable from the worker as ``/proc/<pid>/root/``, so the
worker can ``mknod(2)``/``unlink(2)`` the device node *directly* — no binary
inside the target image is needed, and no shell is spawned. The nsenter
variant is retained as a fallback for kernels/configs where proc-root
traversal is restricted.

Signals cross PID namespaces fine from a hostPID root process, so force-kill
is a plain ``kill(2)`` (ref namespace.go:191-201 execs ``kill`` in-namespace
instead).
"""

from __future__ import annotations

import abc
import os
import signal
import stat as stat_mod
import subprocess

from gpumounter_tpu_torch.utils import consts
from gpumounter_tpu_torch.utils.config import HostPaths
from gpumounter_tpu_torch.utils.errors import ActuationError
from gpumounter_tpu_torch.utils.log import get_logger

logger = get_logger("actuation.nsenter")


# One batched device-node operation: (container_path, major, minor).
DeviceNodeOp = tuple[str, int, int]


class ContainerNsActuator(abc.ABC):
    """Create/remove device nodes in a container and signal its processes."""

    @abc.abstractmethod
    def create_device_node(self, pid: int, device_path: str, major: int,
                           minor: int,
                           mode: int = consts.DEVICE_FILE_MODE) -> bool:
        """Returns True when a node was newly created, False when an
        existing node short-circuited (the idempotent-resume signal)."""
        ...

    @abc.abstractmethod
    def remove_device_node(self, pid: int, device_path: str) -> None:
        ...

    @abc.abstractmethod
    def kill_processes(self, pids: list[int],
                       sig: int = signal.SIGKILL) -> None:
        ...

    def apply_device_nodes(self, pid: int,
                           creates: list[DeviceNodeOp] = (),
                           removes: list[str] = (),
                           mode: int = consts.DEVICE_FILE_MODE) -> int:
        """Apply a whole container's node creates + removes in ONE call —
        the operation-fusion seam (GPUOS-style, PAPERS.md): actuators
        whose crossing has a fixed cost (nsenter spawns a shell per call)
        override this with a single-crossing batch. The default composes
        the single-op methods, so existing actuators — and test doubles
        whose single-op hooks tests patch — keep working unchanged.

        Returns the number of nodes newly created (existing nodes
        short-circuit, preserving idempotent resume)."""
        created = 0
        for device_path, major, minor in creates:
            created += bool(self.create_device_node(pid, device_path,
                                                    major, minor, mode))
        for device_path in removes:
            self.remove_device_node(pid, device_path)
        return created


class ProcRootActuator(ContainerNsActuator):
    """Default: direct syscalls through ``/proc/<pid>/root``.

    ``fake_nodes=True`` creates regular files with ``.majmin`` sidecars
    instead of real char nodes — the same fixture format the enumerators
    accept with ``allow_fake`` — so the full attach path runs unprivileged
    in tests.
    """

    def __init__(self, host: HostPaths | None = None,
                 fake_nodes: bool = False):
        self.host = host or HostPaths()
        self.fake_nodes = fake_nodes

    def _container_path(self, pid: int, device_path: str) -> str:
        root = os.path.join(self.host.proc_root, str(pid), "root")
        return root + device_path

    def create_device_node(self, pid: int, device_path: str, major: int,
                           minor: int,
                           mode: int = consts.DEVICE_FILE_MODE) -> bool:
        target = self._container_path(pid, device_path)
        parent = os.path.dirname(target)
        try:
            os.makedirs(parent, exist_ok=True)
            if os.path.exists(target):
                logger.debug("device node already present: %s", target)
                return False
            if self.fake_nodes:
                with open(target, "w"):
                    pass
                with open(target + ".majmin", "w") as f:
                    f.write(f"{major}:{minor}")
            else:
                os.mknod(target, mode | stat_mod.S_IFCHR,
                         os.makedev(major, minor))
                os.chmod(target, mode)  # mknod mode is masked by umask
        except OSError as e:
            raise ActuationError(
                f"mknod {device_path} (c {major}:{minor}) in pid {pid} "
                f"mount ns failed: {e}") from e
        logger.info("created %s (c %d:%d) via pid %d", device_path, major,
                    minor, pid)
        return True

    def remove_device_node(self, pid: int, device_path: str) -> None:
        target = self._container_path(pid, device_path)
        try:
            if os.path.exists(target):
                os.unlink(target)
            sidecar = target + ".majmin"
            if self.fake_nodes and os.path.exists(sidecar):
                os.unlink(sidecar)
        except OSError as e:
            raise ActuationError(
                f"unlink {device_path} in pid {pid} mount ns failed: {e}"
            ) from e
        logger.info("removed %s via pid %d", device_path, pid)

    def kill_processes(self, pids: list[int],
                       sig: int = signal.SIGKILL) -> None:
        for pid in pids:
            try:
                os.kill(pid, sig)
                logger.info("sent signal %d to pid %d", sig, pid)
            except ProcessLookupError:
                pass  # already gone — that's the goal
            except OSError as e:
                raise ActuationError(f"kill {pid} failed: {e}") from e


class NsenterActuator(ContainerNsActuator):
    """Parity fallback: shell out to nsenter(1) like the reference
    (namespace.go:70-201). Requires sh + mknod in the target image."""

    def __init__(self, nsenter_bin: str = "nsenter"):
        self.nsenter_bin = nsenter_bin

    def _run_in_mount_ns(self, pid: int, script: str) -> str:
        cmd = [self.nsenter_bin, "--target", str(pid), "--mount", "--",
               "sh", "-c", script]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=30)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise ActuationError(f"nsenter failed: {e}") from e
        if proc.returncode != 0:
            raise ActuationError(
                f"nsenter script {script!r} in pid {pid} failed "
                f"rc={proc.returncode}: {proc.stderr.strip()}")
        return proc.stdout

    def create_device_node(self, pid: int, device_path: str, major: int,
                           minor: int,
                           mode: int = consts.DEVICE_FILE_MODE) -> bool:
        # ref namespace.go:167-177 AddGPUDeviceFile — but idempotent: an
        # existing node short-circuits (EEXIST must not fail the resume
        # path), matching ProcRootActuator's behaviour.
        out = self._run_in_mount_ns(
            pid, f"test -e {device_path} || "
                 f"{{ mknod -m {mode:o} {device_path} c {major} {minor}"
                 f" && echo created; }}")
        return "created" in out

    def remove_device_node(self, pid: int, device_path: str) -> None:
        # ref namespace.go:179-189 RemoveGPUDeviceFile
        self._run_in_mount_ns(pid, f"rm -f {device_path}")

    def apply_device_nodes(self, pid: int,
                           creates: list[DeviceNodeOp] = (),
                           removes: list[str] = (),
                           mode: int = consts.DEVICE_FILE_MODE) -> int:
        """ONE nsenter round trip for the whole batch. The reference paid
        a shell spawn per node (namespace.go:70-177 builds one nsenter
        command per mknod); an entire-node attach (GPUs + their
        companions) cost ~dozens of crossings. Fused: a single script,
        ``set -e`` so the first real failure aborts with a nonzero rc,
        idempotent per node (``test -e`` short-circuits), newly created
        nodes counted from the echoed markers."""
        if not creates and not removes:
            return 0
        lines = ["set -e"]
        for device_path, major, minor in creates:
            lines.append(
                f"test -e {device_path} || "
                f"{{ mknod -m {mode:o} {device_path} c {major} {minor}"
                f" && echo created; }}")
        for device_path in removes:
            lines.append(f"rm -f {device_path}")
        out = self._run_in_mount_ns(pid, "\n".join(lines))
        return out.count("created")

    def kill_processes(self, pids: list[int],
                       sig: int = signal.SIGKILL) -> None:
        # host-side kill works under hostPID; no need to enter the ns
        ProcRootActuator().kill_processes(pids, sig)


class RecordingActuator(ContainerNsActuator):
    """Test double recording every call.

    ``batches`` logs each :meth:`apply_device_nodes` invocation as
    ``(pid, created_paths, removed_paths)`` — the round-trip budget tests
    assert one namespace crossing per container from it. The batch
    delegates to the single-op methods through the base class, so chaos
    hooks patched onto ``create_device_node`` still fire mid-batch."""

    def __init__(self):
        self.created: list[tuple[int, str, int, int]] = []
        self.removed: list[tuple[int, str]] = []
        self.killed: list[tuple[int, int]] = []
        self.batches: list[tuple[int, tuple[str, ...], tuple[str, ...]]] = []
        self.fail_on_create: bool = False

    def apply_device_nodes(self, pid, creates=(), removes=(),
                           mode=consts.DEVICE_FILE_MODE):
        self.batches.append((pid, tuple(p for p, _, _ in creates),
                             tuple(removes)))
        return super().apply_device_nodes(pid, creates, removes, mode)

    def create_device_node(self, pid, device_path, major, minor,
                           mode=consts.DEVICE_FILE_MODE):
        if self.fail_on_create:
            raise ActuationError("injected create failure")
        # Idempotent like the real actuators: re-creating an already
        # recorded (pid, path) node is a no-op short-circuit.
        if any(p == pid and d == device_path for p, d, _, _ in self.created):
            return False
        self.created.append((pid, device_path, major, minor))
        return True

    def remove_device_node(self, pid, device_path):
        self.removed.append((pid, device_path))
        # Mirror the real actuators: the node is gone, so a later create of
        # the same (pid, path) genuinely creates (returns True) — without
        # this, a detach->attach cycle would be misread as a no-op resume.
        self.created = [e for e in self.created
                        if not (e[0] == pid and e[1] == device_path)]

    def kill_processes(self, pids, sig=signal.SIGKILL):
        self.killed.extend((pid, sig) for pid in pids)
