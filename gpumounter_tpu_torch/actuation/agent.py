"""Resident per-node actuation agent: the namespace crossing as a cached,
in-process primitive instead of a per-attach fork/exec.

GPUOS (PAPERS.md) argues the per-operation crossing tax of accelerator
control planes should be fused into one resident primitive; the Kubernetes
Network Driver Model makes the companion point that a thin declarative
control plane only pays off when the data-plane crossings underneath it
are resident and multiplexed. This module is that primitive for device
node actuation:

- **Cached namespace handles.** On first use of a container (and on
  explicit :meth:`ResidentActuationAgent.warm`), the agent opens and
  caches a handle on the container's mount-namespace anchor —
  ``/proc/<pid>/ns/mnt`` where the kernel exposes it, the ``/proc/<pid>``
  directory itself on fixture trees — so repeat attaches/detaches to the
  same container pay zero path resolution.
- **fd-liveness revalidation.** A cached handle is only trusted after an
  identity check: ``fstat(fd)`` against a fresh ``stat(path)`` of the
  anchor. A container restarted between warm and attach gets a new
  ``/proc/<pid>`` (new inode / failed stat); the stale handle is evicted,
  re-opened when the new incarnation is live, and counted in
  ``actuation_agent_revalidations_total{outcome="stale"}``.
- **One resident executor.** A dedicated daemon thread owns every
  namespace entry and executes whole batched mknod/unlink plans with
  direct syscalls — zero shell, zero fork on the warm path. Where the
  kernel + privileges allow (root on a real ``/proc``), the thread
  unshares CLONE_FS and enters the container via ``setns(2)``; everywhere
  else it uses the hostPID ``/proc/<pid>/root`` traversal (the same
  direct-syscall mechanism :class:`ProcRootActuator` uses, made resident
  and batched).
- **Transparent fallback.** Any agent fault — stale handle that cannot be
  re-opened, executor death, unexpected errno — degrades to the wrapped
  fallback actuator (``ProcRootActuator`` or the fork/exec
  :class:`NsenterActuator`), counted in
  ``actuation_agent_fallbacks_total{reason}``. Actuation is idempotent
  (existing nodes short-circuit), so a fallback retry after a mid-batch
  agent death completes the batch rather than double-applying it; the
  attach journal's revert path runs through the fallback the same way.

The port of :mod:`gpumounter_tpu.actuation.agent`; on the GPU worker it
makes ``/dev/nvidiaN`` and its companions in the container.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
import queue
import signal
import stat as stat_mod
import threading
import time

from gpumounter_tpu_torch.actuation.nsenter import (ContainerNsActuator,
                                                    DeviceNodeOp)
from gpumounter_tpu_torch.utils import consts
from gpumounter_tpu_torch.utils.config import HostPaths
from gpumounter_tpu_torch.utils.errors import ActuationError
from gpumounter_tpu_torch.utils.log import get_logger
from gpumounter_tpu_torch.utils.metrics import REGISTRY

logger = get_logger("actuation.agent")

CLONE_FS = 0x00000200
CLONE_NEWNS = 0x00020000


class AgentFault(Exception):
    """The resident agent could not execute a plan (stale handle beyond
    repair, executor dead, unexpected OS error). The caller falls back to
    the wrapped actuator; this never surfaces past AgentActuator."""

    def __init__(self, reason: str, message: str):
        super().__init__(message)
        self.reason = reason


class StaleNsHandleError(AgentFault):
    """The cached namespace handle no longer matches the live container
    (restarted / exited between warm and use)."""

    def __init__(self, pid: int):
        super().__init__("stale_ns_fd",
                         f"cached ns handle for pid {pid} is stale")


@dataclasses.dataclass
class _NsHandle:
    """One cached namespace anchor: the fd plus the identity it was opened
    with, so revalidation is two stats and an integer compare."""

    pid: int
    fd: int
    path: str
    st_dev: int
    st_ino: int
    opened_at: float
    uses: int = 0


@dataclasses.dataclass
class _Plan:
    """One submitted batch: executed atomically by the agent thread."""

    pid: int
    creates: tuple[DeviceNodeOp, ...]
    removes: tuple[str, ...]
    mode: int
    done: threading.Event = dataclasses.field(
        default_factory=threading.Event)
    created: int = 0
    error: BaseException | None = None
    # Set by the submitter when it gave up waiting (executor wedged) and
    # fell back: a late-unwedging executor must NOT execute this plan —
    # the fallback already applied it, and the pod may since have been
    # detached (re-mknod'ing would resurrect removed nodes).
    cancelled: bool = False


class ResidentActuationAgent:
    """The per-node resident executor + namespace-handle cache.

    One instance per worker process. Thread-safe: submissions are
    serialised through the executor queue (device-node actuation for one
    node is not a parallel workload — the win is killing the per-op
    crossing setup, not parallelism).
    """

    # A plan that takes longer than this has wedged the executor (a real
    # batch is microseconds of syscalls); submitters fall back rather
    # than queue behind it forever.
    PLAN_TIMEOUT_S = 30.0
    MAX_HANDLES = 256

    def __init__(self, host: HostPaths | None = None,
                 fake_nodes: bool = False):
        self.host = host or HostPaths()
        self.fake_nodes = fake_nodes
        self._handles: dict[int, _NsHandle] = {}
        self._handles_lock = threading.Lock()
        self._queue: queue.SimpleQueue[_Plan | None] = queue.SimpleQueue()
        self._started = False
        self._stopped = False
        self._thread: threading.Thread | None = None
        self._start_lock = threading.Lock()
        # setns mode needs root, a real /proc, and a host-mnt-ns fd to
        # return to; decided once at first start. Everywhere else the
        # executor stays resident but crosses via /proc/<pid>/root.
        self._setns_mode = False
        self._host_mnt_fd: int | None = None
        self._libc = None
        # Test seam: chaos rigs install a hook called before each
        # individual op; raising from it simulates the agent dying
        # mid-batch (the journal/fallback interplay tests arm it).
        self._op_hook = None
        # Parent dirs already ensured per (pid, dir) — the common case
        # (/dev inside the container) exists once and forever, so the
        # per-node makedirs/stat round-trips collapse to a set lookup.
        self._known_dirs: set[tuple[int, str]] = set()

    # -- lifecycle -------------------------------------------------------------

    def _ensure_started(self) -> None:
        if self._started and self._thread is not None \
                and self._thread.is_alive():
            return
        with self._start_lock:
            if self._stopped:
                raise AgentFault("stopped", "agent stopped")
            if self._started and self._thread is not None \
                    and self._thread.is_alive():
                return
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name="tpumounter-actuation")
            self._thread.start()
            self._started = True

    def stop(self) -> None:
        self._stopped = True
        if self._thread is not None:
            self._queue.put(None)
            self._thread.join(timeout=2.0)
            self._thread = None
        with self._handles_lock:
            for handle in self._handles.values():
                self._close_fd(handle.fd)
            self._handles.clear()
        if self._host_mnt_fd is not None:
            self._close_fd(self._host_mnt_fd)
            self._host_mnt_fd = None
        self._export_handle_gauge()

    @staticmethod
    def _close_fd(fd: int) -> None:
        try:
            os.close(fd)
        except OSError:
            pass

    # -- namespace handle cache ------------------------------------------------

    def _anchor_path(self, pid: int) -> str:
        """The stat-able object whose identity IS the container's mount
        view: the kernel's ns/mnt link when present (real /proc), the pid
        dir itself on fixture trees (recreated-with-new-inode on container
        restart, which is exactly the signal revalidation needs)."""
        ns = os.path.join(self.host.proc_root, str(pid), "ns", "mnt")
        if os.path.exists(ns):
            return ns
        return os.path.join(self.host.proc_root, str(pid))

    def warm(self, pid: int) -> bool:
        """Open + cache the namespace handle ahead of need (pool-warm /
        first-attach hook). Returns False when the container is not live
        (the first batch will retry); never raises."""
        try:
            self._handle(pid)
            return True
        except AgentFault:
            return False

    def _handle(self, pid: int) -> _NsHandle:
        with self._handles_lock:
            handle = self._handles.get(pid)
        if handle is not None:
            if self._revalidate(handle):
                return handle
            self._evict(pid, handle)
        return self._open_handle(pid)

    def _revalidate(self, handle: _NsHandle) -> bool:
        """stat the anchor vs the cached fd identity. A dead or restarted
        container fails the stat or changes (dev, ino)."""
        try:
            st = os.stat(handle.path)
        except OSError:
            REGISTRY.agent_revalidations.inc(outcome="stale")
            return False
        if (st.st_dev, st.st_ino) != (handle.st_dev, handle.st_ino):
            REGISTRY.agent_revalidations.inc(outcome="stale")
            return False
        REGISTRY.agent_revalidations.inc(outcome="ok")
        return True

    def _evict(self, pid: int, handle: _NsHandle) -> None:
        with self._handles_lock:
            if self._handles.get(pid) is handle:
                del self._handles[pid]
            self._known_dirs = {k for k in self._known_dirs
                                if k[0] != pid}
        self._close_fd(handle.fd)
        self._export_handle_gauge()
        logger.info("evicted stale ns handle for pid %d", pid)

    def _open_handle(self, pid: int) -> _NsHandle:
        path = self._anchor_path(pid)
        try:
            fd = os.open(path, os.O_RDONLY)
            st = os.fstat(fd)
        except OSError as e:
            raise AgentFault(
                "open_ns_fd",
                f"cannot open ns anchor for pid {pid}: {e}") from e
        handle = _NsHandle(pid=pid, fd=fd, path=path, st_dev=st.st_dev,
                           st_ino=st.st_ino, opened_at=time.monotonic())
        with self._handles_lock:
            racer = self._handles.get(pid)
            if racer is not None:
                # a concurrent first-use won the open race: keep ITS
                # handle, close ours — overwriting would leak its fd
                self._close_fd(fd)
                return racer
            if len(self._handles) >= self.MAX_HANDLES:
                # evict the least-used handle; the cache is a latency
                # optimisation, correctness never depends on it
                victim_pid = min(self._handles,
                                 key=lambda p: self._handles[p].uses)
                self._close_fd(self._handles.pop(victim_pid).fd)
                # same hygiene as _evict: the victim pid's parent-dir
                # knowledge dies with its handle (the pid number may be
                # recycled to a container whose /dev does not exist yet)
                self._known_dirs = {k for k in self._known_dirs
                                    if k[0] != victim_pid}
            self._handles[pid] = handle
        self._export_handle_gauge()
        return handle

    def _export_handle_gauge(self) -> None:
        with self._handles_lock:
            REGISTRY.agent_ns_fds.set(len(self._handles))

    # -- plan execution (agent thread) -----------------------------------------

    def apply(self, pid: int, creates: list[DeviceNodeOp] = (),
              removes: list[str] = (),
              mode: int = consts.DEVICE_FILE_MODE) -> int:
        """Execute one batched plan through the resident executor.
        Raises :class:`AgentFault` on any agent-side failure (the caller's
        fallback seam); raises :class:`ActuationError` for genuine
        actuation failures (EPERM on mknod etc. — falling back would just
        fail the same way, and the error must reach the rollback path)."""
        self._ensure_started()
        handle = self._handle(pid)          # revalidates; AgentFault seam
        plan = _Plan(pid=pid, creates=tuple(creates),
                     removes=tuple(removes), mode=mode)
        self._queue.put(plan)
        if not plan.done.wait(self.PLAN_TIMEOUT_S):
            plan.cancelled = True
            raise AgentFault("executor_wedged",
                             f"plan for pid {pid} not executed within "
                             f"{self.PLAN_TIMEOUT_S}s")
        if plan.error is not None:
            if isinstance(plan.error, ActuationError):
                raise plan.error
            raise AgentFault(
                "executor_error",
                f"agent execution failed for pid {pid}: {plan.error}"
            ) from plan.error
        handle.uses += 1
        REGISTRY.agent_batches.inc(
            op="create" if creates else "remove")
        REGISTRY.agent_batch_ops.inc(len(creates) + len(removes))
        return plan.created

    def _run(self) -> None:
        try:
            self._init_executor_thread()
            while True:
                plan = self._queue.get()
                if plan is None:
                    return
                fatal = False
                try:
                    if not plan.cancelled:
                        plan.created = self._execute(plan)
                except BaseException as e:      # noqa: BLE001 — handed to
                    plan.error = e              # the submitter's seam
                    # the ONE unrecoverable state: stuck in a container's
                    # mount ns. Executing any further plan there would
                    # actuate the wrong filesystem — this incarnation
                    # dies; _ensure_started boots a fresh one (back in
                    # the host ns) on the next submission.
                    fatal = (isinstance(e, AgentFault)
                             and e.reason == "setns_return")
                finally:
                    plan.done.set()
                if fatal:
                    return
        finally:
            # dead-for-any-reason is restartable: flag it so a racing
            # submitter doesn't enqueue onto a thread mid-unwind
            self._started = False

    def _init_executor_thread(self) -> None:
        """Decide the crossing mechanism once per executor incarnation.
        setns needs the thread un-shared from the process's CLONE_FS group
        (Python threads share it) and a host mnt-ns fd to return to."""
        if os.geteuid() != 0 or self.host.proc_root != "/proc":
            self._setns_mode = False
            return
        try:
            libc = ctypes.CDLL(None, use_errno=True)
            if libc.unshare(CLONE_FS) != 0:
                raise OSError(ctypes.get_errno(), "unshare(CLONE_FS)")
            self._host_mnt_fd = os.open("/proc/self/ns/mnt", os.O_RDONLY)
            self._libc = libc
            self._setns_mode = True
            logger.info("actuation agent: setns mode (resident in-kernel "
                        "namespace entry)")
        except OSError as e:
            logger.info("actuation agent: proc-root mode (setns "
                        "unavailable: %s)", e)
            self._setns_mode = False

    def _execute(self, plan: _Plan) -> int:
        if self._setns_mode:
            return self._execute_setns(plan)
        return self._execute_procroot(plan)

    def _execute_setns(self, plan: _Plan) -> int:
        """Enter the container's mount namespace for the whole batch, act
        on the container-absolute paths, return to the host ns."""
        with self._handles_lock:
            handle = self._handles.get(plan.pid)
        if handle is None:
            raise StaleNsHandleError(plan.pid)
        if self._libc.setns(handle.fd, CLONE_NEWNS) != 0:
            raise StaleNsHandleError(plan.pid)
        try:
            return self._run_ops(plan, prefix="")
        finally:
            if self._libc.setns(self._host_mnt_fd, CLONE_NEWNS) != 0:
                # cannot get back to the host view: this executor must
                # not run any further plan — die loudly; the next
                # submission starts a fresh thread (back in host ns)
                raise AgentFault("setns_return",
                                 "failed to return to host mount ns")

    def _execute_procroot(self, plan: _Plan) -> int:
        """hostPID traversal: the container's root filesystem addressed as
        ``<proc_root>/<pid>/root`` — same direct-syscall effect as setns,
        available unprivileged and on fixture trees."""
        root = os.path.join(self.host.proc_root, str(plan.pid), "root")
        if not os.path.isdir(root):
            raise StaleNsHandleError(plan.pid)
        return self._run_ops(plan, prefix=root)

    def _run_ops(self, plan: _Plan, prefix: str) -> int:
        created = 0
        for device_path, major, minor in plan.creates:
            if plan.cancelled:      # submitter gave up: stop mid-batch
                break
            if self._op_hook is not None:
                self._op_hook("create", plan.pid, device_path)
            created += self._mknod(plan.pid, prefix + device_path, major,
                                   minor, plan.mode)
        for device_path in plan.removes:
            if plan.cancelled:
                break
            if self._op_hook is not None:
                self._op_hook("remove", plan.pid, device_path)
            self._unlink(prefix + device_path)
        if plan.creates or plan.removes:
            logger.debug("agent batch pid=%d +%d/-%d nodes (%d new)",
                         plan.pid, len(plan.creates), len(plan.removes),
                         created)
        return created

    def _ensure_parent(self, pid: int, target: str) -> None:
        parent = os.path.dirname(target)
        key = (pid, parent)
        # _known_dirs shares the handle lock: the executor adds entries
        # while submitters evict a pid's whole set — an unsynchronized
        # add could survive the eviction and skip a needed mkdir when
        # the pid number is recycled
        with self._handles_lock:
            if key in self._known_dirs:
                return
        os.makedirs(parent, exist_ok=True)
        with self._handles_lock:
            self._known_dirs.add(key)

    def _mknod(self, pid: int, target: str, major: int, minor: int,
               mode: int) -> int:
        """One node, idempotent, minimal syscalls: EEXIST short-circuits
        instead of a pre-stat (the idempotent-resume signal is 0)."""
        try:
            self._ensure_parent(pid, target)
        except OSError as e:
            raise ActuationError(
                f"agent mkdir for {target} failed: {e}") from e
        try:
            if self.fake_nodes:
                # fixture format shared with the enumerators: a regular
                # file plus a ".majmin" sidecar (device/enumerator.py)
                fd = os.open(target, os.O_CREAT | os.O_EXCL | os.O_WRONLY,
                             mode)
                os.close(fd)
                sidecar = os.open(target + ".majmin",
                                  os.O_CREAT | os.O_WRONLY | os.O_TRUNC)
                os.write(sidecar, f"{major}:{minor}".encode())
                os.close(sidecar)
            else:
                os.mknod(target, mode | stat_mod.S_IFCHR,
                         os.makedev(major, minor))
                os.chmod(target, mode)      # mknod mode is masked by umask
        except FileExistsError:
            return 0
        except OSError as e:
            raise ActuationError(
                f"agent mknod {target} (c {major}:{minor}) failed: {e}"
            ) from e
        return 1

    def _unlink(self, target: str) -> None:
        try:
            os.unlink(target)
        except FileNotFoundError:
            pass
        except OSError as e:
            raise ActuationError(f"agent unlink {target} failed: {e}") \
                from e
        if self.fake_nodes:
            try:
                os.unlink(target + ".majmin")
            except OSError:
                pass

    # -- introspection (/agentz) -----------------------------------------------

    def status(self) -> dict:
        with self._handles_lock:
            handles = [{
                "pid": h.pid,
                "anchor": h.path,
                "age_s": round(time.monotonic() - h.opened_at, 1),
                "uses": h.uses,
            } for h in sorted(self._handles.values(),
                              key=lambda h: h.pid)]
        alive = self._thread is not None and self._thread.is_alive()
        return {
            "enabled": True,
            "mode": "setns" if self._setns_mode else "procroot",
            "executor_alive": alive,
            "ns_fds": handles,
            "counters": {
                "batches": int(REGISTRY.agent_batches.value(op="create")
                               + REGISTRY.agent_batches.value(op="remove")),
                "revalidations_ok": int(
                    REGISTRY.agent_revalidations.value(outcome="ok")),
                "revalidations_stale": int(
                    REGISTRY.agent_revalidations.value(outcome="stale")),
                "fallbacks": int(_fallback_total()),
            },
        }


def _fallback_total() -> float:
    return sum(REGISTRY.agent_fallbacks.value(reason=r)
               for r in ("stale_ns_fd", "open_ns_fd", "executor_error",
                         "executor_wedged", "executor_dead", "stopped",
                         "setns_return"))


class AgentActuator(ContainerNsActuator):
    """The actuator the mounter sees: agent on the warm path, wrapped
    fallback actuator on any agent fault. Single-op calls ride the agent
    as one-op batches so the crossing discipline is uniform; force-kill
    never needs a namespace (hostPID signal delivery) and goes straight
    to the fallback."""

    def __init__(self, agent: ResidentActuationAgent,
                 fallback: ContainerNsActuator):
        self.agent = agent
        self.fallback = fallback

    def _fall_back(self, fault: AgentFault, pid: int):
        from gpumounter_tpu_torch.utils.events import EVENTS
        from gpumounter_tpu_torch.utils.flight import RECORDER
        from gpumounter_tpu_torch.utils.trace import current_span
        REGISTRY.agent_fallbacks.inc(reason=fault.reason)
        # correlate with the request being actuated: the active trace's
        # rid (fallbacks happen inside a traced attach/detach phase)
        span = current_span()
        rid = (span._trace.rid if span is not None
               and getattr(span, "_trace", None) is not None else "")
        rid = "" if rid == "-" else rid
        EVENTS.emit("agent_fallback", rid=rid, reason=fault.reason,
                    pid=pid)
        # a BURST of fallbacks (not a routine single stale-fd one) is a
        # flight-recorder trigger: the fork-free warm path is down
        RECORDER.note("agent_fallback", rid=rid, reason=fault.reason)
        logger.warning("actuation agent fault (%s) for pid %d; falling "
                       "back to %s: %s", fault.reason, pid,
                       type(self.fallback).__name__, fault)

    def apply_device_nodes(self, pid: int,
                           creates: list[DeviceNodeOp] = (),
                           removes: list[str] = (),
                           mode: int = consts.DEVICE_FILE_MODE) -> int:
        try:
            return self.agent.apply(pid, creates, removes, mode)
        except AgentFault as fault:
            self._fall_back(fault, pid)
            return self.fallback.apply_device_nodes(pid, creates, removes,
                                                    mode)

    def create_device_node(self, pid: int, device_path: str, major: int,
                           minor: int,
                           mode: int = consts.DEVICE_FILE_MODE) -> bool:
        return bool(self.apply_device_nodes(
            pid, [(device_path, major, minor)], [], mode))

    def remove_device_node(self, pid: int, device_path: str) -> None:
        self.apply_device_nodes(pid, [], [device_path])

    def kill_processes(self, pids: list[int],
                       sig: int = signal.SIGKILL) -> None:
        self.fallback.kill_processes(pids, sig)
