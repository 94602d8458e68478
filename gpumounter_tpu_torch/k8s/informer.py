"""Shared node-scoped pod informer: ONE list+watch stream per scope.

The port's own copy of :mod:`gpumounter_tpu.k8s.informer`.

The reference pays for every attach with fresh apiserver LISTs
(``cmd/GPUMounter-master/main.go:248``, ``allocator.go:247-282``) — every
caller polls its own view of the same few dozen pods. The Kubernetes
Network Driver model (PAPERS.md) shows the composable fix: a shared
list-watch cache that every reader consults, so steady-state apiserver
load is one watch stream per scope instead of O(callers × polls).

Two pieces:

- :class:`PodInformer` — one (namespace, label_selector) scope. A single
  ``list_pods_with_version`` seeds an indexed in-memory store; one
  resilient watch stream (the client's resume-from-resourceVersion
  machinery) keeps it current. Watch death beyond the resume budget
  triggers a re-LIST resync (counted in ``watch_restarts``); while the
  apiserver is unreachable the cache serves its last known state and its
  **staleness** (seconds since the stream last proved liveness) is
  exported so /cachez and doctor can see the degradation.
- :class:`PodCacheReads` — the read handle the hot-path modules
  (allocator, pool, worker/service) hold instead of calling
  ``kube.list_pods`` directly (enforced by tests/test_informer_lint.py).
  Covered reads are served from the cache; uncovered scopes fall through
  to the real client unchanged, so a handle with no informers behaves
  byte-for-byte like the bare client.

Consistency model (docs/guide/Performance.md):

- **Reads may be stale** by the event-propagation delay (normally
  milliseconds). Every write that must be *arbitrated* — warm-pod
  adoption, precondition deletes — is already resourceVersion-guarded at
  the apiserver, so a stale read can cost a retry, never a double-grant.
- **Read-your-writes fencing**: mutation responses are fed back via
  :meth:`PodCacheReads.observe_write`; subsequent covered reads wait
  (bounded) for the cache to reach that resourceVersion and fall through
  to a REAL apiserver call when it lags past the fence timeout. Callers
  can also demand an explicit floor with ``min_resource_version``.
- **Authoritative absence** only for selector-less scopes: a namespace-
  wide informer that is caught up can answer "pod not found" from cache;
  selector-scoped informers serve positive hits only.
"""

from __future__ import annotations

import threading
import time
from collections.abc import Callable, Iterable

from gpumounter_tpu_torch.k8s import objects
from gpumounter_tpu_torch.k8s.client import KubeClient, _match_label_selector
from gpumounter_tpu_torch.utils.errors import K8sApiError, PodNotFoundError
from gpumounter_tpu_torch.utils.log import get_logger
from gpumounter_tpu_torch.utils.parking import parked
from gpumounter_tpu_torch.utils.retry import retryable

logger = get_logger("k8s.informer")


def _rv_int(rv) -> int | None:
    """resourceVersions are opaque strings, but both etcd and the test
    fake use monotonically increasing integers in practice. None when the
    version can't be ordered — fencing then falls through to a real
    call rather than guessing."""
    try:
        return int(rv)
    except (TypeError, ValueError):
        return None


def _selector_clauses(selector: str | None) -> set[str]:
    if not selector:
        return set()
    return {c.strip() for c in selector.split(",") if c.strip()}


class PodInformer:
    """One (namespace, label_selector) list-watch scope with an indexed
    in-memory store. Thread-safe; readers see a consistent snapshot under
    the condition lock and waiters are woken on every applied event."""

    def __init__(self, kube: KubeClient, namespace: str,
                 label_selector: str | None = None,
                 watch_chunk_s: float = 30.0,
                 resync_backoff_s: float = 1.0):
        self.kube = kube
        self.namespace = namespace
        self.label_selector = label_selector
        self.watch_chunk_s = watch_chunk_s
        self.resync_backoff_s = resync_backoff_s
        self._cond = threading.Condition()
        self._pods: dict[str, objects.Pod] = {}
        self._rv: str = ""
        self._fence_rv: int = 0           # read-your-writes high-water mark
        self._seeded = False
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.watch_restarts = 0           # re-LIST resyncs after stream death
        self.events_seen = 0
        # last moment the stream PROVED liveness: an applied event, a
        # clean chunk end, or a successful resync. Staleness is measured
        # from here — a quiet-but-healthy watch is not stale.
        self._last_contact = time.monotonic()

    # -- lifecycle -------------------------------------------------------------

    def start(self) -> "PodInformer":
        """Seed synchronously (callers get a warm cache immediately) and
        start the watch loop. A failed seed is LOUD but non-fatal: the
        loop keeps retrying and reads fall through to the real client
        until the first successful LIST."""
        try:
            self._resync()
        except K8sApiError as e:
            logger.warning("informer %s seed LIST failed (%s); serving "
                           "fall-through until the stream recovers",
                           self.scope(), e)
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"pod-informer-{self.namespace}")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        with self._cond:
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=1.0)
            self._thread = None

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def ready(self) -> bool:
        with self._cond:
            return self._seeded

    def scope(self) -> str:
        return f"{self.namespace}/{self.label_selector or '*'}"

    # -- stream ----------------------------------------------------------------

    def _resync(self) -> None:
        pods, rv = self.kube.list_pods_with_version(self.namespace,
                                                    self.label_selector)
        with self._cond:
            self._pods = {objects.name(p): p for p in pods}
            self._rv = rv
            self._seeded = True
            self._last_contact = time.monotonic()
            self._cond.notify_all()

    def _run(self) -> None:
        backoff = self.resync_backoff_s
        while not self._stop.is_set():
            if not self.ready():
                # boot seed failed: retry it here WITHOUT counting a watch
                # restart (no stream ever existed) and without the
                # double-LIST the except path would add.
                try:
                    self._resync()
                    backoff = self.resync_backoff_s
                except K8sApiError as e:
                    logger.warning("informer %s seed LIST failed (%s); "
                                   "retrying", self.scope(), e)
                    if self._stop.wait(timeout=backoff):
                        return
                    backoff = min(backoff * 2, 30.0)
                    continue
            try:
                for etype, pod in self.kube.watch_pods(
                        self.namespace, label_selector=self.label_selector,
                        timeout_s=self.watch_chunk_s,
                        resource_version=self._rv or None):
                    if self._stop.is_set():
                        return
                    self._apply(etype, pod)
                with self._cond:      # clean server-side chunk end: alive
                    self._last_contact = time.monotonic()
                backoff = self.resync_backoff_s
            except Exception as e:
                if self._stop.is_set():
                    return
                # 410 Gone, resume budget exhausted, apiserver outage —
                # anything that kills the stream funnels here: count it,
                # re-LIST, keep serving the last known state meanwhile.
                from gpumounter_tpu_torch.utils.metrics import REGISTRY
                self.watch_restarts += 1
                REGISTRY.informer_watch_restarts.inc()
                if isinstance(e, K8sApiError) \
                        and (e.status == 410 or retryable(e)):
                    logger.warning("informer %s stream died (%s); "
                                   "re-LISTing (restart %d)", self.scope(),
                                   e, self.watch_restarts)
                else:
                    logger.exception("informer %s stream failed "
                                     "unexpectedly; re-LISTing (restart %d)",
                                     self.scope(), self.watch_restarts)
                try:
                    self._resync()
                except K8sApiError as sync_err:
                    logger.warning("informer %s resync failed (%s); "
                                   "cache serves last known state",
                                   self.scope(), sync_err)
                # Throttle EVERY death->restart cycle, resync success or
                # not: an intermediary that kills watches instantly must
                # degrade to a paced relist, never a LIST storm. Backoff
                # resets only when a stream survives a full chunk.
                if self._stop.wait(timeout=backoff):
                    return
                backoff = min(backoff * 2, 30.0)

    def _apply(self, etype: str, pod: objects.Pod) -> None:
        from gpumounter_tpu_torch.utils.metrics import REGISTRY
        if not isinstance(pod, dict):
            return
        rv = pod.get("metadata", {}).get("resourceVersion", "")
        name = objects.name(pod)
        with self._cond:
            if etype == "DELETED":
                self._pods.pop(name, None)
            elif etype in ("ADDED", "MODIFIED"):
                self._pods[name] = pod
            # BOOKMARK (and everything else) still advances the cursor
            self._rv = rv or self._rv
            self.events_seen += 1
            self._last_contact = time.monotonic()
            self._cond.notify_all()
        REGISTRY.informer_events.inc(type=etype)

    # -- reads (under the lock) ------------------------------------------------

    def get(self, name: str) -> objects.Pod | None:
        with self._cond:
            return self._pods.get(name)

    def snapshot(self, label_selector: str | None = None
                 ) -> list[objects.Pod]:
        """Matching pods. Returned dicts are the cache's own objects —
        treat as read-only."""
        with self._cond:
            return [p for p in self._pods.values()
                    if _match_label_selector(p, label_selector)]

    def matching(self, label_selector: str | None = None
                 ) -> dict[str, objects.Pod]:
        with self._cond:
            return {name: p for name, p in self._pods.items()
                    if _match_label_selector(p, label_selector)}

    @property
    def resource_version(self) -> str:
        with self._cond:
            return self._rv

    def staleness_s(self) -> float:
        with self._cond:
            return time.monotonic() - self._last_contact

    # -- fencing ---------------------------------------------------------------

    def note_write(self, resource_version: str | None) -> None:
        """Record a mutation's resourceVersion: covered reads now wait for
        the cache to catch up to it (read-your-writes)."""
        rv = _rv_int(resource_version)
        if rv is None:
            return
        with self._cond:
            self._fence_rv = max(self._fence_rv, rv)

    def caught_up(self, min_rv: int | None = None) -> bool:
        with self._cond:
            floor = max(self._fence_rv, min_rv or 0)
            if floor == 0:
                return True
            have = _rv_int(self._rv)
            return have is not None and have >= floor

    def wait_caught_up(self, min_rv: int | None,
                       timeout_s: float) -> bool:
        return self.wait_for(lambda: self.caught_up(min_rv), timeout_s)

    # -- event-driven waits ----------------------------------------------------

    def wait_for(self, predicate: Callable[[], bool],
                 timeout_s: float) -> bool:
        """Re-evaluate ``predicate`` on every applied event (and at least
        twice a second) until it returns True or the deadline passes.
        The predicate may raise; the error propagates to the caller."""
        deadline = time.monotonic() + timeout_s
        with self._cond:
            while True:
                if predicate():
                    return True
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cond.wait(timeout=min(remaining, 0.5))

    # -- introspection ---------------------------------------------------------

    def status(self) -> dict:
        with self._cond:
            return {
                "namespace": self.namespace,
                "selector": self.label_selector,
                "pods": len(self._pods),
                "resource_version": self._rv,
                "fence_rv": self._fence_rv,
                "seeded": self._seeded,
                "running": self.running,
                "staleness_s": round(
                    time.monotonic() - self._last_contact, 3),
                "watch_restarts": self.watch_restarts,
                "events_seen": self.events_seen,
            }


class PodCacheReads:
    """The informer handle: the ONLY way hot-path modules read pods.

    Covered (namespace, selector) reads are served from a shared
    :class:`PodInformer`; everything else falls through to the wrapped
    :class:`KubeClient` unchanged. With no informers this is a pure
    passthrough — unit rigs keep today's behavior exactly.
    """

    def __init__(self, kube: KubeClient,
                 informers: Iterable[PodInformer] = (),
                 fence_timeout_s: float = 2.0):
        self.kube = kube
        self.informers = list(informers)
        self.fence_timeout_s = fence_timeout_s

    # -- plumbing --------------------------------------------------------------

    def _covering(self, namespace: str,
                  label_selector: str | None) -> PodInformer | None:
        """The informer that can answer reads for this scope: same
        namespace, and the informer's own selector clauses are a subset of
        the request's (a namespace-wide informer covers every selector —
        the request filter is applied in memory)."""
        for informer in self.informers:
            if informer.namespace != namespace:
                continue
            if _selector_clauses(informer.label_selector) <= \
                    _selector_clauses(label_selector) and informer.ready():
                return informer
        return None

    def covers(self, namespace: str,
               label_selector: str | None = None) -> bool:
        """Whether a ready informer currently serves this scope's reads
        from cache (callers that are only worth short-circuiting when the
        read is local — e.g. the detach resolution cache — check this)."""
        return self._covering(namespace, label_selector) is not None

    def _hit(self, verb: str) -> None:
        from gpumounter_tpu_torch.utils.metrics import REGISTRY
        REGISTRY.cache_hits.inc(verb=verb)

    def _miss(self, verb: str, reason: str) -> None:
        from gpumounter_tpu_torch.utils.metrics import REGISTRY
        REGISTRY.cache_misses.inc(verb=verb, reason=reason)

    def observe_write(self, pod: objects.Pod | None) -> None:
        """Feed a mutation RESPONSE back so covered reads become
        read-your-writes (see module docstring). Accepts None / versionless
        objects silently — fencing is an optimization, not a contract."""
        if not isinstance(pod, dict):
            return
        namespace = objects.namespace(pod)
        rv = pod.get("metadata", {}).get("resourceVersion")
        for informer in self.informers:
            if informer.namespace == namespace:
                informer.note_write(rv)

    # -- reads -----------------------------------------------------------------

    def get_pod(self, namespace: str, name: str,
                min_resource_version: str | None = None) -> objects.Pod:
        """Raises :class:`PodNotFoundError` like the client. Served from
        cache only for selector-less scopes (a selector-scoped cache
        cannot prove absence)."""
        informer = self._covering(namespace, None)
        if informer is None or informer.label_selector:
            return self.kube.get_pod(namespace, name)
        want = _rv_int(min_resource_version)
        with parked("informer-fence"):
            caught_up = informer.wait_caught_up(want, self.fence_timeout_s)
        if not caught_up:
            self._miss("get", "lag")
            return self.kube.get_pod(namespace, name)
        pod = informer.get(name)
        if pod is None:
            self._hit("get")
            raise PodNotFoundError(namespace, name)
        if want is not None:
            have = _rv_int(pod.get("metadata", {}).get("resourceVersion"))
            if have is None or have < want:
                self._miss("get", "stale")
                return self.kube.get_pod(namespace, name)
        self._hit("get")
        return pod

    def list_pods(self, namespace: str,
                  label_selector: str | None = None) -> list[objects.Pod]:
        return self.list_pods_with_version(namespace, label_selector)[0]

    def list_pods_with_version(
            self, namespace: str, label_selector: str | None = None
    ) -> tuple[list[objects.Pod], str]:
        informer = self._covering(namespace, label_selector)
        if informer is None:
            return self.kube.list_pods_with_version(namespace,
                                                    label_selector)
        with parked("informer-fence"):
            caught_up = informer.wait_caught_up(None, self.fence_timeout_s)
        if not caught_up:
            self._miss("list", "lag")
            return self.kube.list_pods_with_version(namespace,
                                                    label_selector)
        self._hit("list")
        return informer.snapshot(label_selector), informer.resource_version

    # -- event-driven waits ----------------------------------------------------

    def wait_pods(self, namespace: str, label_selector: str | None,
                  step: Callable[[dict[str, objects.Pod]], bool],
                  timeout_s: float, watch_chunk_s: float = 30.0) -> bool:
        """Drive ``step(pods_by_name)`` — the scope's current matching
        pods — once immediately and again after every change, until it
        returns True or the deadline passes (returns False). ``step`` may
        raise typed errors (Unschedulable, terminal phase); they
        propagate.

        Informer-backed scopes piggyback on the ONE shared stream; others
        run the legacy LIST-seeded watch (resume on 410/transient error by
        re-LISTing), which is exactly the state machine the allocator ran
        before the informer existed.
        """
        informer = self._covering(namespace, label_selector)
        if informer is not None and informer.running:
            # Fence first: a wait whose step interprets ABSENCE (deleted /
            # already adopted / nothing to wait for) must not evaluate a
            # cache that hasn't yet applied this process's own creates —
            # it would prune just-created pods as gone. Cache lagging the
            # fence ⇒ the legacy LIST-seeded path sees ground truth.
            # Informer-backed waits run parked (utils/parking.py): the
            # thread sleeps on the shared stream's condition — a handler
            # parked here hands its executor slot back. The LIST-seeded
            # fallback below is deliberately NOT parked: it does real
            # apiserver work (LIST + watch processing) per waiter, and
            # uncharging it would let thousands of concurrent watch
            # loops run exactly when the slow path is most expensive.
            with parked("informer-fence"):
                caught_up = informer.wait_caught_up(None,
                                                    self.fence_timeout_s)
            if caught_up:
                with parked("pod-wait"):
                    return informer.wait_for(
                        lambda: step(informer.matching(label_selector)),
                        timeout_s)
            self._miss("wait", "lag")
        return self._wait_pods_watch(namespace, label_selector, step,
                                     timeout_s, watch_chunk_s)

    def _wait_pods_watch(self, namespace: str, label_selector: str | None,
                         step, timeout_s: float,
                         watch_chunk_s: float) -> bool:
        deadline = time.monotonic() + timeout_s
        pods_map: dict[str, objects.Pod] = {}

        def sync() -> str:
            pods, rv = self.kube.list_pods_with_version(namespace,
                                                        label_selector)
            pods_map.clear()
            pods_map.update({objects.name(p): p for p in pods})
            return rv

        rv = sync()
        if step(dict(pods_map)):
            return True
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return False
            try:
                for etype, pod in self.kube.watch_pods(
                        namespace, label_selector=label_selector,
                        timeout_s=min(remaining, watch_chunk_s),
                        resource_version=rv):
                    rv = pod.get("metadata", {}).get(
                        "resourceVersion", "") or rv
                    if etype == "DELETED":
                        pods_map.pop(objects.name(pod), None)
                    else:
                        pods_map[objects.name(pod)] = pod
                    if step(dict(pods_map)):
                        return True
            except K8sApiError as e:
                # 410: version expired. Transient beyond the client's own
                # resume budget: survive by re-seeding — the deadline, not
                # one broken stream, decides when the wait gives up.
                if e.status != 410 and not retryable(e):
                    raise
                logger.warning("wait_pods watch interrupted (%s); "
                               "re-seeding from a fresh LIST", e)
                rv = sync()
                if step(dict(pods_map)):
                    return True

    # -- lifecycle / introspection ---------------------------------------------

    def stop(self) -> None:
        for informer in self.informers:
            informer.stop()

    def status(self) -> dict:
        """The /cachez payload."""
        from gpumounter_tpu_torch.utils.metrics import REGISTRY
        hits = sum(REGISTRY.cache_hits.value(verb=v)
                   for v in ("get", "list"))
        misses = sum(REGISTRY.cache_misses.value(verb=v, reason=r)
                     for v in ("get", "list", "wait")
                     for r in ("lag", "stale", "uncovered"))
        total = hits + misses
        return {
            "enabled": bool(self.informers),
            "fence_timeout_s": self.fence_timeout_s,
            "hits": int(hits),
            "misses": int(misses),
            "hit_ratio": round(hits / total, 4) if total else None,
            "scopes": [inf.status() for inf in self.informers],
        }
