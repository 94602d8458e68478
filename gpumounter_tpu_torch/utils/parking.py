"""Parking executor: the worker's continuation seam over sync gRPC.

The port's own copy of :mod:`gpumounter_tpu.utils.parking`.

The worker's gRPC server is a thread-pool server (``grpc_server.py``):
an attach RPC's wall time is dominated by *waits* — slave-pod
scheduling, informer fences, kubelet device-plugin lag — during which
the handler thread does nothing but occupy one of the pool's slots. At
thousands of in-flight RPCs a fixed pool either serializes (8 threads)
or explodes into thousands of *schedulable* threads fighting the GIL
(one big pool).

This module is the middle path (the shape Go's runtime gives syscalls
for free): an executor whose
concurrency budget is counted in **running** threads, with a
``parked()`` seam the slow waits enter. A parked thread hands its
active slot back to the executor — which lets a queued RPC start — and
re-acquires one when its wait completes. Thousands of in-flight RPCs
then cost thousands of *sleeping* threads (cheap: a stack apiece, no
scheduler pressure) while the set of threads actually contending for
the GIL stays at ``max_active``.

The seam is deliberately transparent: ``parked()`` no-ops on threads
that are not executor workers, so the instrumented wait sites
(``k8s/informer.py`` fence + pod waits, the allocator's kubelet-lag
poll, the service's keyed-lock acquisitions) behave byte-for-byte
identically under the legacy thread-pool server, unit rigs, and the
master process. Nothing about the service's semantics moves: the drain
controller's in-flight tokens and the per-rid/per-pod keyed locks are
held across parks exactly as across any other blocking call — only the
executor's accounting of the thread changes.

Keyed-lock acquisitions are parked for a correctness reason, not just
throughput: a thread that parks while HOLDING a pod lock frees its
slot; if the waiters piling up on that same lock still counted as
active, they could consume every slot and deadlock the holder's
un-park. Parking lock waits makes the budget deadlock-free by
construction — a thread blocked on state another request owns is never
charged against the budget.
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import threading

from gpumounter_tpu_torch.utils.log import get_logger
from gpumounter_tpu_torch.utils.metrics import REGISTRY

logger = get_logger("utils.parking")

_TLS = threading.local()


@contextlib.contextmanager
def parked(reason: str = "wait"):
    """Mark the enclosed blocking wait as parked: the current thread's
    active slot is released for the scope and re-acquired on exit.
    No-op (zero overhead beyond one thread-local read) on threads that
    do not belong to a :class:`ParkingExecutor` — which is every thread
    under the legacy thread-pool server. Re-entrant: only the outermost
    ``parked()`` releases the slot."""
    parker = getattr(_TLS, "parker", None)
    if parker is None:
        yield
        return
    depth = getattr(_TLS, "depth", 0)
    _TLS.depth = depth + 1
    if depth == 0:
        parker._park(reason)
    try:
        yield
    finally:
        _TLS.depth = depth
        if depth == 0:
            parker._unpark()


class ParkingExecutor(concurrent.futures.Executor):
    """A ``futures.Executor`` whose budget counts RUNNING threads.

    ``max_active`` bounds the threads that may execute un-parked at
    once (the knob ``TPU_GRPC_WORKERS`` plumbs); ``max_threads`` bounds
    total threads — the in-flight RPC ceiling, far above the active
    budget because a parked thread costs only its stack. ``submit``
    spawns a worker when none is idle, so the pool grows with in-flight
    work and shrinks back on idle timeout.
    """

    def __init__(self, max_active: int = 8, max_threads: int = 4096,
                 idle_timeout_s: float = 10.0,
                 name: str = "tpumounter-grpc"):
        if max_active < 1:
            raise ValueError(f"max_active must be >= 1, got {max_active}")
        if max_threads < max_active:
            raise ValueError("max_threads must be >= max_active")
        self.max_active = max_active
        self.max_threads = max_threads
        self.idle_timeout_s = idle_timeout_s
        self.name = name
        self._cond = threading.Condition()
        self._work: collections.deque = collections.deque()
        self._threads = 0
        self._idle = 0
        self._active = 0          # threads running un-parked right now
        self._parked = 0          # threads inside a parked() wait
        self._shutdown = False
        self._seq = 0
        # high-water marks for /introspection + the parking tests
        self.peak_active = 0
        self.peak_parked = 0
        self.tasks_total = 0

    # -- futures.Executor surface ----------------------------------------------

    def submit(self, fn, /, *args, **kwargs):
        future: concurrent.futures.Future = concurrent.futures.Future()
        with self._cond:
            if self._shutdown:
                raise RuntimeError(
                    "cannot schedule new futures after shutdown")
            self._work.append((future, fn, args, kwargs))
            self.tasks_total += 1
            if self._idle == 0 and self._threads < self.max_threads:
                self._spawn_locked()
            else:
                self._cond.notify()
        return future

    def shutdown(self, wait: bool = True, *, cancel_futures: bool = False):
        with self._cond:
            self._shutdown = True
            if cancel_futures:
                while self._work:
                    self._work.popleft()[0].cancel()
            self._cond.notify_all()
        if wait:
            deadline = threading.Event()
            while True:
                with self._cond:
                    if self._threads == 0:
                        return
                deadline.wait(0.02)

    # -- worker loop -----------------------------------------------------------

    def _spawn_locked(self) -> None:
        self._threads += 1
        self._seq += 1
        threading.Thread(target=self._run, daemon=True,
                         name=f"{self.name}-{self._seq}").start()

    def _run(self) -> None:
        _TLS.parker = self
        _TLS.depth = 0
        try:
            while True:
                with self._cond:
                    while not self._work:
                        if self._shutdown:
                            return
                        self._idle += 1
                        signalled = self._cond.wait(
                            timeout=self.idle_timeout_s)
                        self._idle -= 1
                        if not self._work and not signalled:
                            return              # idle-timeout shrink
                        if not self._work and self._shutdown:
                            return
                    item = self._work.popleft()
                    # the active slot is acquired BEFORE the task runs —
                    # this is the budget; parked threads gave theirs back
                    while self._active >= self.max_active:
                        self._cond.wait(timeout=0.5)
                        if self._shutdown and not self._work:
                            item[0].cancel()
                            return
                    self._active += 1
                    self.peak_active = max(self.peak_active, self._active)
                future, fn, args, kwargs = item
                try:
                    if future.set_running_or_notify_cancel():
                        try:
                            future.set_result(fn(*args, **kwargs))
                        except BaseException as e:  # noqa: BLE001 — the
                            future.set_exception(e)  # future carries it
                finally:
                    with self._cond:
                        self._active -= 1
                        self._cond.notify_all()
        finally:
            _TLS.parker = None
            with self._cond:
                self._threads -= 1
                self._cond.notify_all()

    # -- the parked() seam -----------------------------------------------------

    def _park(self, reason: str) -> None:
        with self._cond:
            self._active -= 1
            self._parked += 1
            self.peak_parked = max(self.peak_parked, self._parked)
            REGISTRY.worker_rpc_parked.set(self._parked)
            # a queued task (or a returning un-parker) can use the slot
            self._cond.notify_all()

    def _unpark(self) -> None:
        with self._cond:
            while self._active >= self.max_active and not self._shutdown:
                self._cond.wait(timeout=0.5)
            self._parked -= 1
            self._active += 1
            self.peak_active = max(self.peak_active, self._active)
            REGISTRY.worker_rpc_parked.set(self._parked)

    # -- introspection ---------------------------------------------------------

    def status(self) -> dict:
        with self._cond:
            return {
                "max_active": self.max_active,
                "threads": self._threads,
                "active": self._active,
                "parked": self._parked,
                "queued": len(self._work),
                "peak_active": self.peak_active,
                "peak_parked": self.peak_parked,
                "tasks_total": self.tasks_total,
            }
