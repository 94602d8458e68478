"""Orphaned-slave-pod reconciler.

The port's own copy of :mod:`gpumounter_tpu.worker.reconciler`.

The reference GCs slave pods via an OwnerReference to the target pod
(``allocator.go:204-213``) — but Kubernetes ignores cross-namespace owner
references, and slave pods live in the pool namespace while targets live
anywhere, so that GC silently never fires for the common case (the reference
also shipped mismatched namespaces, SURVEY.md §8). Chips held by a slave pod
whose owner died would stay allocated forever.

This reconciler closes the leak: every interval, list this node's slave pods
and delete any whose owner pod is gone or terminal (Succeeded/Failed). No
actuation rollback is needed — the owner's container is gone, taking its
cgroup and mount namespace with it; deleting the slave pod releases the
scheduler accounting, which is the part that outlives the owner.

Warm-pool pods (worker/pool.py) are unowned BY DESIGN and must not be
treated as orphans: carriers of the warm label are exempt from the
owner-liveness check. They are still GC'd here when genuinely stale — a
terminal phase (the pause container exited), or the pool being disabled on
this worker (nothing maintains them any more, so they would silently hold
chips forever). A live pool trims its own excess; this is the backstop.

State is re-derived from the cluster on every pass (owner labels stamped at
creation + pod liveness), so the reconciler is restart-safe with no local
persistence — the same ground-truth-re-derivation property SURVEY.md §5
credits the reference's collector with.
"""

from __future__ import annotations

import threading

from gpumounter_tpu_torch.k8s import objects
from gpumounter_tpu_torch.k8s.client import KubeClient
from gpumounter_tpu_torch.utils import consts
from gpumounter_tpu_torch.utils.config import Settings
from gpumounter_tpu_torch.utils.errors import K8sApiError, PodNotFoundError
from gpumounter_tpu_torch.utils.log import get_logger
from gpumounter_tpu_torch.utils.metrics import REGISTRY

logger = get_logger("worker.reconciler")


class OrphanReconciler:
    def __init__(self, kube: KubeClient, settings: Settings | None = None,
                 interval_s: float = 30.0, gate=None):
        self.kube = kube
        self.settings = settings or Settings()
        self.interval_s = interval_s
        # Device gate (actuation/gate.py): each pass audits gate-vs-lease
        # drift — a gate entry granting chips whose owner attachment is
        # gone is a grant outliving its lease (reclaimed + surfaced on
        # /gatez; doctor CRITs). None / legacy mode = no audit.
        self.gate = gate
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- one pass --------------------------------------------------------------

    def _is_ours(self, slave: objects.Pod) -> bool:
        """Restrict to this node's slave pods when NODE_NAME is set (each
        DaemonSet worker owns its node; unset = single-node test rigs)."""
        if not self.settings.node_name:
            return True
        selector = (slave.get("spec", {}).get("nodeSelector", {}) or {})
        return selector.get("kubernetes.io/hostname") == \
            self.settings.node_name

    def _warm_pod_stale(self, slave: objects.Pod) -> bool:
        """A warm pod is stale when its holder exited (terminal phase) or
        no pool maintains it (disabled on this worker) — either way it is
        dead scheduler accounting that would otherwise live forever."""
        if objects.is_terminal(slave):
            return True
        return not self.settings.warm_pool_enabled

    def _owner_alive(self, slave: objects.Pod) -> bool:
        labels = objects.labels(slave)
        owner = labels.get(consts.OWNER_POD_LABEL_KEY)
        owner_ns = labels.get(consts.OWNER_NAMESPACE_LABEL_KEY)
        if not owner or not owner_ns:
            # pre-label-schema pod or hand-made: leave it alone
            return True
        try:
            pod = self.kube.get_pod(owner_ns, owner)
        except PodNotFoundError:
            return False
        # A same-named RECREATED owner (StatefulSet pattern) is not the pod
        # these chips were mounted into — compare UIDs when stamped.
        owner_uid = labels.get(consts.OWNER_UID_LABEL_KEY)
        if owner_uid and objects.uid(pod) != owner_uid:
            return False
        return not objects.is_terminal(pod)

    def scan_once(self) -> list[str]:
        """Delete orphaned slave pods; returns their names."""
        try:
            slaves = self.kube.list_pods(
                self.settings.pool_namespace,
                label_selector=(f"{consts.SLAVE_POD_LABEL_KEY}="
                                f"{consts.SLAVE_POD_LABEL_VALUE}"))
        except K8sApiError as e:
            logger.warning("reconcile list failed: %s", e)
            return []
        deleted = []
        # Gate drift audit input: owners PROVEN alive this pass. Collected
        # while the orphan scan already does the liveness work; an
        # apiserver blip keeps the owner in the live set (absence of
        # proof ≠ dead — the audit must never revoke on a blip).
        live_owners: set[tuple[str, str]] = set()
        for slave in slaves:
            if not self._is_ours(slave):
                continue
            if objects.labels(slave).get(consts.WARM_POD_LABEL_KEY) == \
                    consts.WARM_POD_LABEL_VALUE:
                # warm-pool pod: unowned by design, not an orphan
                if not self._warm_pod_stale(slave):
                    continue
                name = objects.name(slave)
                logger.info("deleting stale warm pod %s (%s)", name,
                            "terminal" if objects.is_terminal(slave)
                            else "pool disabled")
                try:
                    # rv precondition: never race a concurrent adoption
                    self.kube.delete_pod(
                        self.settings.pool_namespace, name,
                        resource_version=slave.get("metadata", {}).get(
                            "resourceVersion") or None)
                    deleted.append(name)
                except K8sApiError as e:
                    if e.status != 409:
                        logger.warning("delete warm pod %s failed: %s",
                                       name, e)
                continue
            labels = objects.labels(slave)
            owner_key = (labels.get(consts.OWNER_NAMESPACE_LABEL_KEY),
                         labels.get(consts.OWNER_POD_LABEL_KEY))
            try:
                if self._owner_alive(slave):
                    if all(owner_key):
                        live_owners.add(owner_key)
                    continue
            except K8sApiError as e:
                logger.warning("owner check for %s failed: %s",
                               objects.name(slave), e)
                if all(owner_key):
                    live_owners.add(owner_key)  # blip ≠ dead owner
                continue
            name = objects.name(slave)
            logger.info("deleting orphaned slave pod %s (owner %s/%s gone)",
                        name,
                        objects.labels(slave).get(
                            consts.OWNER_NAMESPACE_LABEL_KEY),
                        objects.labels(slave).get(consts.OWNER_POD_LABEL_KEY))
            try:
                self.kube.delete_pod(self.settings.pool_namespace, name)
                deleted.append(name)
                REGISTRY.orphans_reclaimed.inc()
            except K8sApiError as e:
                logger.warning("delete orphan %s failed: %s", name, e)
        self._audit_gate(live_owners)
        return deleted

    def _audit_gate(self, live_owners: set[tuple[str, str]]) -> None:
        """Gate-vs-lease drift audit. ``live_owners`` carries owners the
        slave scan proved alive; gate entries naming OTHER owners (e.g. a
        pod whose chips all came from its own spec — no slave pods to
        list) get their own liveness check before the gate may treat them
        as drift. Every uncertainty (apiserver blip) counts as alive: the
        audit reclaims only definitively-dead owners' grants."""
        if self.gate is None or not self.gate.live:
            return
        audited = set(live_owners)
        for owner in self.gate.owners() - audited:
            namespace, name = owner
            try:
                pod = self.kube.get_pod(namespace, name)
            except PodNotFoundError:
                continue                     # definitively gone: drift
            except K8sApiError:
                audited.add(owner)           # blip ≠ dead owner
                continue
            if not objects.is_terminal(pod):
                audited.add(owner)
        self.gate.audit(audited)
        # keep the exact open/deny counters flowing even on nodes where
        # the usage sampler is off (its loop is the primary pump)
        self.gate.pump()

    # -- background loop -------------------------------------------------------

    def start(self) -> "OrphanReconciler":
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="orphan-reconciler")
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.scan_once()
            except Exception:
                logger.exception("reconcile pass failed")

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
