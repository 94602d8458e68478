"""Graceful worker drain: SIGTERM / POST /drainz / spot-termination.

The port's own copy of :mod:`gpumounter_tpu.worker.drain`.

A worker that simply dies strands its failure domain on the master's
node-health machinery (master/nodehealth.py): leases fence, slices
self-heal — recoverable, but disruptive. A worker that KNOWS it is
going away (rolling restart, node scale-down, spot preemption notice)
can leave cleanly instead:

1. **stop admitting new attaches** — the service refuses them with
   :class:`~gpumounter_tpu_torch.utils.errors.WorkerDrainingError`, which the
   gRPC adapter turns into ``UNAVAILABLE`` + a ``draining:`` detail and
   the gateway maps to a typed ``503 Draining`` (never retried as a
   transport fault). Detaches keep flowing — drain frees capacity.
2. **settle in-flight actuation** — every attach/detach holds an
   in-flight token; drain waits (bounded by ``TPU_DRAIN_TIMEOUT_S``)
   until the last one finishes or rolls back through its own journal'd
   path. Nothing is yanked mid-mknod.
3. **flush the evidence** — the attach journal is compacted and the
   event log's sidecar drained, so the node's post-mortem surfaces are
   complete before the process goes.
4. **announce it** — ``/healthz`` answers ``draining``; the master's
   fleet scrape folds that into the node state machine within ONE tick
   (cordon from new grants + proactive slice migration off the node).

The :class:`SpotTerminationWatcher` closes the involuntary half: when
``TPU_SPOT_TERMINATION_FILE`` names a path, a watcher thread polls it
and begins the same drain the moment the preemption notice lands (a
node-problem-detector / metadata-watcher sidecar touches the file) —
migration starts BEFORE the node dies instead of after.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time

from gpumounter_tpu_torch.utils.errors import WorkerDrainingError
from gpumounter_tpu_torch.utils.events import EVENTS
from gpumounter_tpu_torch.utils.log import get_logger

logger = get_logger("worker.drain")


class DrainController:
    """Owns the worker's drain state: the admitting flag, the in-flight
    actuation gate, and the drain sequence. One per worker process;
    the service consults :meth:`inflight` on every RPC."""

    def __init__(self, node_name: str = "",
                 default_timeout_s: float | None = None):
        from gpumounter_tpu_torch.utils import consts
        self.node_name = node_name
        # the settle window every entry point shares (SIGTERM, POST
        # /drainz, spot watcher) — set from TPU_DRAIN_TIMEOUT_S at
        # construction so no caller can forget to plumb it
        self.default_timeout_s = (consts.DEFAULT_DRAIN_TIMEOUT_S
                                  if default_timeout_s is None
                                  else default_timeout_s)
        self._cond = threading.Condition()
        self._draining = False
        self._inflight = 0
        self.reason = ""
        self.started_unix: float | None = None
        self.completed_unix: float | None = None
        self.settled: bool | None = None
        self.refused = 0
        # flush hooks run after settle, before the journal compact:
        # durability work that must land once actuation is quiet but
        # before the process goes (e.g. the service's mesh-generation
        # notification flush — an elastic job's reshape signal must not
        # die in the page cache with the worker)
        self._flush_hooks: list = []

    def register_flush(self, hook) -> None:
        """Add a zero-arg callable to the post-settle flush sequence
        (exceptions are logged, never abort the drain)."""
        self._flush_hooks.append(hook)

    @property
    def draining(self) -> bool:
        with self._cond:
            return self._draining

    # -- the service-side gate -------------------------------------------------

    @contextlib.contextmanager
    def inflight(self, kind: str = "attach"):
        """Hold one in-flight actuation token for the scope. A NEW
        attach during a drain is refused with
        :class:`WorkerDrainingError` (→ typed 503 Draining at the
        gateway); detaches are always admitted — drain frees capacity,
        it must never wedge it."""
        with self._cond:
            if self._draining and kind == "attach":
                self.refused += 1
                raise WorkerDrainingError(
                    f"worker on node {self.node_name or '?'} is "
                    "draining: new attaches are refused (retry against "
                    "another node or after the restart)")
            self._inflight += 1
        try:
            yield
        finally:
            with self._cond:
                self._inflight -= 1
                self._cond.notify_all()

    # -- the drain sequence ----------------------------------------------------

    def begin(self, reason: str = "sigterm") -> bool:
        """Flip to draining (idempotent). From this instant new attaches
        are refused and /healthz answers ``draining`` — the master
        cordons the node within one fleet tick."""
        with self._cond:
            if self._draining:
                return False
            self._draining = True
            self.reason = reason
            self.started_unix = time.time()
        EVENTS.emit("drain_begin", node=self.node_name, reason=reason)
        logger.warning("drain begun (%s): new attaches refused, "
                       "settling in-flight actuation", reason)
        return True

    def wait_settled(self, timeout_s: float) -> bool:
        """Block until every in-flight attach/detach finished (or rolled
        back through its own path). True = settled inside the window."""
        deadline = time.monotonic() + timeout_s
        with self._cond:
            while self._inflight > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cond.wait(timeout=min(remaining, 0.5))
            return True

    def run(self, journal=None, timeout_s: float | None = None,
            reason: str = "sigterm") -> bool:
        """The whole sequence: stop admitting → settle in-flight →
        flush journal + event sidecar → announce completion. Returns
        whether in-flight work settled inside the window (False means
        the process is going down with actuation possibly mid-flight —
        the journal replay at next boot finishes or reverts it, exactly
        the crash path, just announced)."""
        if timeout_s is None:
            timeout_s = self.default_timeout_s
        self.begin(reason)
        settled = self.wait_settled(timeout_s)
        if not settled:
            logger.error("drain window (%.0fs) expired with actuation "
                         "still in flight — the journal replay at next "
                         "boot resolves it", timeout_s)
        for hook in self._flush_hooks:
            try:
                hook()
            except Exception:    # noqa: BLE001 — a flush hiccup must
                logger.exception("drain flush hook failed")   # not abort
        if journal is not None:
            try:
                journal.compact()
            except OSError as e:
                logger.warning("journal compact during drain failed: %s",
                               e)
        try:
            EVENTS.flush()
        except Exception:    # noqa: BLE001 — a sidecar hiccup must not
            logger.exception("event flush during drain failed")  # abort
        with self._cond:
            self.settled = settled
            self.completed_unix = time.time()
        EVENTS.emit("drain_complete", node=self.node_name,
                    reason=reason, settled=settled,
                    refused=self.refused)
        # flush AGAIN so drain_complete itself reaches the sidecar —
        # the last thing this process says must not die in the ring
        try:
            EVENTS.flush()
        except Exception:    # noqa: BLE001
            pass
        logger.warning("drain complete (settled=%s, %d attach(es) "
                       "refused)", settled, self.refused)
        return settled

    # -- introspection (/drainz + healthz) -------------------------------------

    def status(self) -> dict:
        with self._cond:
            return {
                "draining": self._draining,
                "reason": self.reason,
                "inflight": self._inflight,
                "refused": self.refused,
                "started_unix": self.started_unix,
                "completed_unix": self.completed_unix,
                "settled": self.settled,
            }


class SpotTerminationWatcher:
    """Polls the spot/preemption notice path and triggers a proactive
    drain the moment it appears. The file is the seam: on GKE a
    node-problem-detector (or a one-line metadata-watcher sidecar
    polling ``instance/preempted``) touches it; tests touch it
    directly."""

    def __init__(self, path: str, on_terminate,
                 poll_interval_s: float = 1.0):
        self.path = path
        self.on_terminate = on_terminate
        self.poll_interval_s = poll_interval_s
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.fired = False

    def start(self) -> "SpotTerminationWatcher":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, daemon=True,
                name="tpumounter-spot-watcher")
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    def _run(self) -> None:
        while not self._stop.wait(self.poll_interval_s):
            try:
                if not os.path.exists(self.path):
                    continue
            except OSError:
                continue
            self.fired = True
            EVENTS.emit("spot_termination", path=self.path)
            logger.warning("spot-termination notice at %s: beginning "
                           "proactive drain", self.path)
            try:
                self.on_terminate()
            except Exception:    # noqa: BLE001 — the watcher thread
                logger.exception("spot-termination handler failed")
            return               # one-shot: the node is going away
