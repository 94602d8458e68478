"""Worker discovery: which per-node worker daemon serves a given node (the
port of :mod:`gpumounter_tpu.master.discovery`).

Ref ``cmd/GPUMounter-master/main.go:248-268`` ``findAllWorker``: LIST pods in
kube-system labelled ``app=gpu-mounter-worker`` and map ``spec.nodeName`` →
pod. The reference issues that LIST **per request** with no caching
(SURVEY.md §3.5 "No caching/informers"); we keep a TTL cache so steady-state
mount requests cost zero apiserver round-trips, with a forced refresh on miss
(covers freshly scheduled workers)."""

from __future__ import annotations

import threading
import time

from gpumounter_tpu_torch.k8s import objects
from gpumounter_tpu_torch.k8s.client import KubeClient
from gpumounter_tpu_torch.utils import consts
from gpumounter_tpu_torch.utils.errors import TPUMounterError
from gpumounter_tpu_torch.utils.log import get_logger

logger = get_logger("master.discovery")

# Workers normally all serve on WORKER_GRPC_PORT; a pod can override its
# advertised port with this annotation (hostNetwork setups, local testing).
PORT_ANNOTATION = "tpumounter.io/grpc-port"


class WorkerNotFoundError(TPUMounterError):
    def __init__(self, node: str):
        super().__init__(
            f"no ready gpu-mounter worker on node {node!r} — is the "
            "DaemonSet running and the node labelled for it?")
        self.node = node


class WorkerDirectory:
    def __init__(self, kube: KubeClient,
                 namespace: str = consts.WORKER_NAMESPACE,
                 label_selector: str = consts.WORKER_LABEL_SELECTOR,
                 grpc_port: int = consts.WORKER_GRPC_PORT,
                 ttl_s: float = 15.0):
        self.kube = kube
        self.namespace = namespace
        self.label_selector = label_selector
        self.grpc_port = grpc_port
        self.ttl_s = ttl_s
        self._lock = threading.Lock()           # guards the cache map
        self._refresh_lock = threading.Lock()   # serialises apiserver LISTs
        self._by_node: dict[str, str] = {}     # node -> "ip:port" target
        self._fetched_at = 0.0
        # Negative cache (node failure domain): a node whose worker the
        # gateway found dead (invalidate()) fast-fails worker_target
        # for a backoff window instead of adding a re-resolve + dial
        # timeout to every request routed near it. node -> (until
        # monotonic, consecutive failures, the target that failed).
        # A refresh that maps the node to a NEW target (worker pod
        # restarted with a new IP/port) clears the entry immediately.
        self._negative: dict[str, tuple[float, int, str]] = {}

    def _refresh(self) -> None:
        """LIST outside the cache lock (a hung apiserver must not block
        cache hits in other gateway threads), swap the map under it. A
        second lock serialises LISTs; a thread that waited for another's
        refresh reuses that result instead of re-LISTing (stampede guard)."""
        before = self._fetched_at
        with self._refresh_lock:
            if self._fetched_at > before:
                return      # someone else just refreshed
            pods = self.kube.list_pods(self.namespace, self.label_selector)
            by_node: dict[str, str] = {}
            for pod in pods:
                ip = pod.get("status", {}).get("podIP", "")
                if objects.is_running(pod) and ip and objects.node_name(pod):
                    # per-pod port override (hostNetwork / test deployments)
                    port = (pod.get("metadata", {}).get("annotations", {})
                            or {}).get(PORT_ANNOTATION, self.grpc_port)
                    by_node[objects.node_name(pod)] = f"{ip}:{port}"
            with self._lock:
                self._by_node = by_node
                self._fetched_at = time.monotonic()
        logger.debug("worker directory refreshed: %d nodes", len(by_node))

    # Floor between miss-triggered refreshes so clients hammering a node
    # whose worker is down can't turn every request into an apiserver LIST.
    MISS_REFRESH_INTERVAL_S = 1.0
    # Negative-cache backoff: the quarantine window arms only after
    # this many CONSECUTIVE invalidations (a single transient blip —
    # which the gateway's in-request retry absorbs — must not
    # quarantine a healthy node), then doubles per failure up to the
    # cap. The failure count decays after a quiet period.
    NEGATIVE_AFTER_FAILURES = 3
    NEGATIVE_TTL_BASE_S = 1.0
    NEGATIVE_TTL_MAX_S = 30.0
    NEGATIVE_DECAY_S = 60.0

    def worker_target(self, node: str) -> str:
        """gRPC target ``ip:port`` of the worker on ``node``.

        Negative-cache semantics: inside a dead node's backoff window
        the ONLY way out is a (rate-limited) refresh resolving the node
        to a DIFFERENT target — the worker pod was replaced, the
        failure history belongs to the dead incarnation. Re-resolving
        to the SAME failed target fast-fails (WorkerNotFoundError)
        without a dial, so a dead node costs one dial timeout per
        backoff window instead of one per request routed near it. Past
        the window one attempt goes through half-open; failing re-arms
        the window doubled (invalidate())."""
        now = time.monotonic()
        with self._lock:
            negative = self._negative.get(node)
            stale = now - self._fetched_at > self.ttl_s
            target = self._by_node.get(node)
        quarantined = negative is not None and now < negative[0]
        if stale or (target is None and self._miss_refresh_allowed()):
            self._refresh()
            with self._lock:
                target = self._by_node.get(node)
        if quarantined and target == negative[2] \
                and self._miss_refresh_allowed():
            # quarantined and still mapping to the dead address: one
            # rate-limited LIST may reveal a REPLACEMENT pod (the only
            # way out of the window) — a dial is never risked on it
            self._refresh()
            with self._lock:
                target = self._by_node.get(node)
        if not target:
            raise WorkerNotFoundError(node)
        if negative is not None:
            if target == negative[2] and quarantined:
                # same dead address, window still open: fail fast —
                # no dial timeout for this request
                raise WorkerNotFoundError(node)
            with self._lock:
                current = self._negative.get(node)
                if current is not None and target != current[2]:
                    del self._negative[node]
        return target

    def _miss_refresh_allowed(self) -> bool:
        with self._lock:
            return (time.monotonic() - self._fetched_at
                    > self.MISS_REFRESH_INTERVAL_S)

    def targets(self) -> dict[str, str]:
        """Snapshot of every known node's gRPC target (the fleet
        aggregator's worker enumeration). Refreshes on TTL expiry; an
        unreachable apiserver degrades to the stale snapshot — the fleet
        view goes stale, it does not wedge."""
        with self._lock:
            stale = time.monotonic() - self._fetched_at > self.ttl_s
            snapshot = dict(self._by_node)
        if stale:
            try:
                self._refresh()
            except TPUMounterError as e:
                logger.warning("worker directory refresh failed: %s", e)
                return snapshot
            with self._lock:
                snapshot = dict(self._by_node)
        return snapshot

    def invalidate(self, node: str) -> None:
        """Drop a cached entry the caller found to be dead (e.g. gRPC
        UNAVAILABLE after a worker pod restart) so the next request
        re-resolves instead of 502ing until the TTL expires — AND arm
        the node's negative cache: until the backoff window passes,
        ``worker_target`` fast-fails instead of re-LISTing and
        re-dialing the same dead address per request. Consecutive
        invalidations double the window (capped); a refresh that maps
        the node to a NEW target clears it."""
        now = time.monotonic()
        with self._lock:
            failed_target = self._by_node.pop(node, None)
            if failed_target is not None:
                # age the cache so the next lookup's miss-refresh engages
                self._fetched_at = min(
                    self._fetched_at,
                    now - self.MISS_REFRESH_INTERVAL_S - 1e-3)
            prior = self._negative.get(node)
            failures = prior[1] if prior is not None else 0
            if prior is not None \
                    and now - prior[3] > self.NEGATIVE_DECAY_S:
                failures = 0         # quiet period: old failures expired
            failures += 1
            over = failures - self.NEGATIVE_AFTER_FAILURES
            window = (min(self.NEGATIVE_TTL_MAX_S,
                          self.NEGATIVE_TTL_BASE_S * 2 ** over)
                      if over >= 0 else 0.0)
            self._negative[node] = (
                now + window, failures,
                failed_target or (prior[2] if prior is not None else ""),
                now)
        if window > 0:
            logger.info("invalidated worker cache for node %s "
                        "(negative-cached %.1fs, consecutive failure "
                        "#%d)", node, window, failures)
        else:
            logger.info("invalidated worker cache for node %s", node)
