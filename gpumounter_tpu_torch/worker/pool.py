"""Warm slave-pod pool: takes the scheduler off the attach critical path
(the port of :mod:`gpumounter_tpu.worker.pool`; a warm pod requests
``nvidia.com/gpu`` through the allocator's GPU group rules).

bench.py shows the e2e attach cost is dominated by the per-slave-pod
scheduler + device-plugin delay — the framework's own overhead is
milliseconds, the injected 1 s scheduling delay is the rest. The paper's
design necessarily pays that delay per attach because accounting happens
via scheduler-placed slave pods (SURVEY.md §0). This module moves the
delay off the request path the way FlexNPU pre-provisions decode capacity
(PAPERS.md): a per-node background loop keeps N pre-scheduled, UNOWNED
slave pods warm per pool key (``"entire:4"`` = one 4-chip entire-mount
pod), created through the *same* scheduler path as cold slave pods — node
allocatable accounting never lies, warm chips are genuinely reserved.

On AddGPU the allocator asks :meth:`PoolManager.claim` to *adopt* a warm
pod instead of create+wait: a JSON merge-patch writes the owner labels in
and the warm label out, guarded by the pod's observed ``resourceVersion``
— two concurrent claimers race on the same observed version, the
apiserver admits exactly one (the loser's 409 moves it to the next
candidate or the cold path). A full pool hit therefore pays only
actuation: no pod create, no ``_wait_running`` watch, no kubelet lag
(the warm pod's chips were assigned when it went Running).

Pool state is re-derived from the cluster on every pass (the warm label +
liveness), never persisted locally — the same restart-safety property as
the OrphanReconciler. Disabled (the default), nothing changes: no warm
pods exist, ``claim`` is never wired in, the cold path is byte-for-byte
today's behavior.
"""

from __future__ import annotations

import threading
import time

from gpumounter_tpu_torch.allocator.allocator import is_unschedulable
from gpumounter_tpu_torch.k8s import objects
from gpumounter_tpu_torch.k8s.informer import PodCacheReads
from gpumounter_tpu_torch.utils import consts
from gpumounter_tpu_torch.utils.events import EVENTS
from gpumounter_tpu_torch.utils.errors import K8sApiError, PodNotFoundError
from gpumounter_tpu_torch.utils.log import get_logger
from gpumounter_tpu_torch.utils.metrics import REGISTRY
from gpumounter_tpu_torch.utils.trace import annotate, span as trace_span

logger = get_logger("worker.pool")

_WARM_SELECTOR = (f"{consts.SLAVE_POD_LABEL_KEY}="
                  f"{consts.SLAVE_POD_LABEL_VALUE},"
                  f"{consts.WARM_POD_LABEL_KEY}="
                  f"{consts.WARM_POD_LABEL_VALUE}")


def pool_key(entire: bool, chips: int) -> str:
    """The pool is partitioned by what a slave pod IS — its chip count and
    mount type — because adoption must hand over a pod whose label set and
    resource request exactly match what the cold path would have created."""
    return f"{'entire' if entire else 'single'}:{chips}"


def parse_pool_key(key: str) -> tuple[bool, int]:
    mount, _, chips = key.partition(":")
    return mount == "entire", int(chips)


class PoolManager:
    """Per-node warm-pod keeper: one background loop, sibling of the
    OrphanReconciler, plus the synchronous :meth:`claim` the allocator
    calls on the attach path."""

    def __init__(self, allocator, kube, settings=None,
                 interval_s: float | None = None,
                 reads: PodCacheReads | None = None):
        from gpumounter_tpu_torch.utils.config import Settings
        self.allocator = allocator
        self.kube = kube
        # Read-side informer handle, shared with the allocator by default
        # so both see the same cache + write fences; a plain passthrough
        # when no informer is wired (exactly the historical behavior).
        self.reads = (reads if reads is not None
                      else getattr(allocator, "reads", None)
                      or PodCacheReads(kube))
        self.settings = settings or Settings()
        self.interval_s = (self.settings.warm_pool_interval_s
                           if interval_s is None else interval_s)
        # How long one refill pass waits for its creations to go Running
        # (for the refill-latency histogram and a fresh gauge). Pods that
        # are still Pending at the deadline stay for the next pass — on a
        # full node the pool simply refills when a detach frees chips.
        self.refill_wait_s = min(30.0, self.settings.allocation_timeout_s)
        self._stop = threading.Event()
        self._kick = threading.Event()
        self._thread: threading.Thread | None = None
        # Pool-warm actuation hook: invoked once per reconcile
        # pass so the actuation plan cache / inventory snapshot is
        # precomputed OFF the attach hot path (worker/main.py binds it to
        # the collector's refresh; the resident agent's plan cache rides
        # each re-enumeration). Best-effort: a failing hook never blocks
        # pool reconciliation.
        self.warm_hook = None
        self._gauge_keys: set[str] = set()  # every key ever exported
        # Server-side node scoping: warm pods carry this worker's node as
        # a LABEL (the nodeSelector spec field cannot be label-selected),
        # so every LIST/watch here is O(this node's warm pods), not
        # O(the fleet's). Unset NODE_NAME = single-node test rig.
        self._selector = _WARM_SELECTOR
        if self.settings.node_name:
            self._selector += (f",{consts.WARM_POD_NODE_LABEL_KEY}="
                               f"{self.settings.node_name}")

    @property
    def enabled(self) -> bool:
        return (self.settings.warm_pool_enabled
                and bool(self.settings.warm_pool_sizes))

    # -- cluster views ---------------------------------------------------------

    def _is_ours(self, pod: objects.Pod) -> bool:
        """This node's warm pods only (same rule as the reconciler: unset
        NODE_NAME = single-node test rig, everything is ours)."""
        if not self.settings.node_name:
            return True
        selector = (pod.get("spec", {}).get("nodeSelector", {}) or {})
        return selector.get("kubernetes.io/hostname") == \
            self.settings.node_name

    def _pod_key(self, pod: objects.Pod) -> str:
        mount = objects.labels(pod).get(consts.MOUNT_TYPE_LABEL_KEY, "")
        chips = objects.resource_limit(pod, self.settings.resource_name)
        return pool_key(mount == consts.MountType.ENTIRE.value, chips)

    def _list_warm(self) -> list[objects.Pod]:
        return [p for p in self.reads.list_pods(
                    self.settings.pool_namespace,
                    label_selector=self._selector)
                if self._is_ours(p)]

    # -- adoption (the attach hot path) ----------------------------------------

    def claim(self, owner: objects.Pod, gpus_per_pod: int, entire: bool,
              count: int, txn_id: str = "", request_id: str = "",
              extra_labels: dict[str, str] | None = None) -> list[str]:
        """Atomically adopt up to ``count`` Running warm pods of the right
        pool key for ``owner``; returns the claimed names (possibly
        fewer — the shortfall is the caller's cold-path fallback).

        The claim is one resourceVersion-guarded merge-patch per pod:
        ownership labels in, warm label out (``None`` deletes under RFC
        7386), ownerReference added when namespaces match. Any concurrent
        mutation of the candidate — another claimer, a status change, a
        deletion — bumps its version and this claim loses cleanly (409 /
        404) and moves on. Hits/misses are recorded here so the counters
        see every adoption attempt exactly once."""
        if not self.enabled or count <= 0:
            return []
        key = pool_key(entire, gpus_per_pod)
        with trace_span("pool.claim", key=key, requested=count):
            return self._claim(owner, key, count, txn_id=txn_id,
                               request_id=request_id,
                               extra_labels=extra_labels)

    def _claim(self, owner: objects.Pod, key: str, count: int,
               txn_id: str = "", request_id: str = "",
               extra_labels: dict[str, str] | None = None) -> list[str]:
        try:
            warm = self._list_warm()
        except K8sApiError as e:
            # The pool is an optimization: a flaky warm-pod LIST must
            # degrade to a counted miss (cold path unchanged), never add a
            # new hard-failure mode to the attach.
            logger.warning("warm LIST failed, treating as miss: %s", e)
            REGISTRY.pool_misses.inc(count)
            annotate(adopted=0, list_failed=True)
            return []
        candidates = sorted(
            (p for p in warm
             if objects.is_running(p) and self._pod_key(p) == key),
            key=objects.name)
        labels: dict[str, str | None] = {
            consts.OWNER_POD_LABEL_KEY: objects.name(owner),
            consts.OWNER_NAMESPACE_LABEL_KEY: objects.namespace(owner),
            consts.OWNER_UID_LABEL_KEY: objects.uid(owner),
            consts.WARM_POD_LABEL_KEY: None,
        }
        labels.update(extra_labels or {})
        if txn_id:
            labels[consts.TXN_LABEL_KEY] = txn_id
        if request_id:
            labels[consts.REQUEST_ID_LABEL_KEY] = request_id
        patch: dict = {"metadata": {"labels": labels}}
        owner_refs = self.allocator.owner_references(owner)
        if owner_refs:
            patch["metadata"]["ownerReferences"] = owner_refs
        claimed: list[str] = []
        for pod in candidates:
            if len(claimed) >= count:
                break
            name = objects.name(pod)
            rv = pod.get("metadata", {}).get("resourceVersion", "")
            try:
                adopted = self.kube.patch_pod(
                    self.settings.pool_namespace, name, patch,
                    resource_version=rv or None)
                # fence: the allocator's post-claim cache reads must see
                # the ownership labels this patch just wrote
                self.reads.observe_write(adopted)
            except PodNotFoundError:
                continue            # deleted under us: not adoptable
            except K8sApiError as e:
                if e.status == 409:
                    logger.info("warm pod %s lost to a concurrent claimer; "
                                "trying next", name)
                    continue
                # Apiserver trouble mid-claim: keep what we already won —
                # raising here would leave earlier claims owned but
                # uncounted, invisible to the allocator's failure cleanup.
                # The attach proceeds with a partial claim; its cold path
                # either works or fails and cleans these up with it.
                logger.warning("warm claim aborted after %d pod(s): %s",
                               len(claimed), e)
                break
            claimed.append(name)
        REGISTRY.pool_hits.inc(len(claimed))
        REGISTRY.pool_misses.inc(count - len(claimed))
        if claimed:
            EVENTS.emit("pool_adopt", rid=request_id or txn_id,
                        namespace=objects.namespace(owner),
                        pod=objects.name(owner),
                        node=self.settings.node_name,
                        adopted=len(claimed), requested=count, key=key)
            logger.debug("adopted %d/%d warm pod(s) %s for %s/%s",
                        len(claimed), count, claimed,
                        objects.namespace(owner), objects.name(owner))
            self.notify()           # refill asynchronously, off this path
        annotate(adopted=len(claimed))
        return claimed

    def notify(self) -> None:
        """Wake the refill loop now (called after each adoption)."""
        self._kick.set()

    # -- reconciliation (the background loop body) -----------------------------

    def scan_once(self) -> dict[str, list[str]]:
        """One reconcile pass: GC stale warm pods, trim excess, create the
        shortfall per configured key, wait (bounded) for the creations to
        go Running, refresh the gauge. Returns {"deleted": [...],
        "created": [...]} for tests/operators."""
        if not self.enabled:
            return {"deleted": [], "created": []}
        try:
            warm = self._list_warm()
        except K8sApiError as e:
            logger.warning("pool list failed: %s", e)
            return {"deleted": [], "created": []}
        by_key: dict[str, list[objects.Pod]] = {}
        doomed: list[objects.Pod] = []
        for pod in warm:
            key = self._pod_key(pod)
            # Stale: terminal phase (pause exited?), a key no longer
            # configured (resize/retarget), or Unschedulable — deleting an
            # unschedulable warm pod and recreating next pass is the
            # retry loop that picks up capacity as detaches free chips.
            if (objects.is_terminal(pod)
                    or key not in self.settings.warm_pool_sizes
                    or is_unschedulable(pod)):
                doomed.append(pod)
                continue
            by_key.setdefault(key, []).append(pod)
        for key, target in self.settings.warm_pool_sizes.items():
            have = by_key.get(key, [])
            if len(have) > target:
                # trim Pending before Running: never burn an adoptable pod
                # while a not-yet-scheduled one would do
                trim = sorted(have, key=objects.is_running)
                trimmed = trim[:len(have) - target]
                doomed.extend(trimmed)
                by_key[key] = [p for p in have if p not in trimmed]
        # Deletes BEFORE creates: a resize/retarget frees its chips first,
        # so the replacement pods can schedule in this same pass. Each
        # delete is preconditioned on the resourceVersion this pass
        # LISTed: if an attach adopted the pod in between (the adoption
        # patch bumps the version), the delete 409s and the pod — now
        # owned and possibly mid-mount — survives.
        deleted: list[str] = []
        for pod in doomed:
            name = objects.name(pod)
            try:
                self.kube.delete_pod(
                    self.settings.pool_namespace, name,
                    resource_version=pod.get("metadata", {}).get(
                        "resourceVersion") or None)
                deleted.append(name)
                logger.info("deleted stale/excess warm pod %s", name)
            except K8sApiError as e:
                if e.status == 409:
                    logger.info("warm pod %s changed since the scan "
                                "(adopted?); leaving it", name)
                else:
                    logger.warning("delete warm pod %s failed: %s", name, e)
        created: list[str] = []
        create_t0: dict[str, float] = {}
        for key, target in self.settings.warm_pool_sizes.items():
            entire, chips = parse_pool_key(key)
            for _ in range(target - len(by_key.get(key, []))):
                spec = self.allocator.new_warm_slave_pod(
                    self.settings.node_name, chips, entire)
                try:
                    resp = self.kube.create_pod(self.settings.pool_namespace,
                                                spec)
                    self.reads.observe_write(resp)
                except K8sApiError as e:
                    logger.warning("warm pod create (%s) failed: %s", key, e)
                    break
                created.append(objects.name(spec))
                create_t0[objects.name(spec)] = time.monotonic()
        if created or deleted:
            EVENTS.emit("pool_refill", node=self.settings.node_name,
                        created=len(created), deleted=len(deleted))
        if created:
            self._await_running(created, create_t0)
        self._refresh_gauge()
        if self.warm_hook is not None:
            try:
                self.warm_hook()
            except Exception:       # noqa: BLE001 — warming is best-effort
                logger.exception("pool warm hook failed")
        return {"deleted": deleted, "created": created}

    # watch chunking, same rationale as the allocator's state machines
    _WATCH_CHUNK_S = 30.0

    def _await_running(self, names: list[str],
                       create_t0: dict[str, float]) -> None:
        """Until the freshly created warm pods are Running, observing each
        one's create->Running latency (the scheduler cost the pool absorbs
        so attaches don't). Event-driven like the allocator's
        ``_wait_running`` — informer-backed scopes ride the shared stream,
        others run the legacy LIST-seeded watch. Still-Pending pods at the
        deadline are left for the next pass; Unschedulable/terminal/
        vanished (deleted or already adopted) ones stop being waited on
        (next pass retries)."""
        pending = set(names)

        def step(pods: dict[str, objects.Pod]) -> bool:
            # absent from the warm view = deleted or already adopted;
            # either way no Running transition will ever come for it here
            pending.intersection_update(pods.keys())
            for name in list(pending):
                pod = pods[name]
                if objects.is_running(pod):
                    REGISTRY.pool_refill_latency.observe(
                        time.monotonic() - create_t0[name])
                    pending.discard(name)
                elif is_unschedulable(pod) or objects.is_terminal(pod):
                    pending.discard(name)
            return not pending

        try:
            self.reads.wait_pods(self.settings.pool_namespace,
                                 self._selector, step, self.refill_wait_s,
                                 watch_chunk_s=self._WATCH_CHUNK_S)
        except K8sApiError as e:
            logger.warning("refill wait aborted: %s", e)

    def _refresh_gauge(self) -> None:
        try:
            warm = self._list_warm()
        except K8sApiError:
            return
        # include every key ever exported: a resized-away key must drop to
        # 0, not freeze at its last value (phantom adoptable capacity)
        counts = {key: 0 for key in
                  set(self.settings.warm_pool_sizes) | self._gauge_keys}
        for pod in warm:
            if objects.is_running(pod):
                key = self._pod_key(pod)
                counts[key] = counts.get(key, 0) + 1
        for key, n in counts.items():
            REGISTRY.warm_pool_size.set(n, key=key)
        self._gauge_keys |= set(counts)

    # -- introspection ---------------------------------------------------------

    def status(self) -> dict:
        """Operator view (worker /poolz): configured targets vs live
        counts, plus lifetime hit/miss counters. ``running`` = adoptable
        now, ``pending`` = scheduling in progress, ``stale`` = will never
        become adoptable (terminal/Unschedulable — the next GC pass's
        work), bucketed with the same classification scan_once uses so an
        operator debugging a low hit rate isn't shown phantom capacity."""
        blank = {"target": 0, "running": 0, "pending": 0, "stale": 0}
        keys: dict[str, dict[str, int]] = {
            key: {**blank, "target": target}
            for key, target in self.settings.warm_pool_sizes.items()}
        if self.enabled:
            try:
                for pod in self._list_warm():
                    entry = keys.setdefault(self._pod_key(pod),
                                            dict(blank))
                    if objects.is_terminal(pod) or is_unschedulable(pod):
                        entry["stale"] += 1
                    elif objects.is_running(pod):
                        entry["running"] += 1
                    else:
                        entry["pending"] += 1
            except K8sApiError:
                pass
        return {
            "enabled": self.enabled,
            "node": self.settings.node_name,
            "interval_s": self.interval_s,
            "hits": int(REGISTRY.pool_hits.value()),
            "misses": int(REGISTRY.pool_misses.value()),
            "keys": keys,
        }

    # -- background loop -------------------------------------------------------

    def start(self) -> "PoolManager":
        self._stop.clear()
        self._kick.set()        # first pass immediately: fill on boot
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="warm-pool")
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.is_set():
            self._kick.wait(timeout=self.interval_s)
            self._kick.clear()
            if self._stop.is_set():
                return
            try:
                self.scan_once()
            except Exception:
                logger.exception("pool reconcile pass failed")

    def stop(self) -> None:
        self._stop.set()
        self._kick.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
