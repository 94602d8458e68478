"""Typed accessors over plain-dict Kubernetes objects: the port's own copy
of :mod:`gpumounter_tpu.k8s.objects`.

The control plane speaks to the apiserver in raw JSON (no client library in
this build), so pods are dicts; this module is the single place that knows
their shape. Includes the QoS-class computation the reference vendored from
kubelet (``pkg/util/cgroup/cgroup.go:177-237`` GetPodQOS) — we prefer the
kubelet-reported ``status.qosClass`` and fall back to computing it from the
spec exactly as kubelet does.
"""

from __future__ import annotations

from typing import Any

Pod = dict[str, Any]

QOS_GUARANTEED = "Guaranteed"
QOS_BURSTABLE = "Burstable"
QOS_BEST_EFFORT = "BestEffort"

_SUPPORTED_QOS_RESOURCES = ("cpu", "memory")


def name(pod: Pod) -> str:
    return pod.get("metadata", {}).get("name", "")


def namespace(pod: Pod) -> str:
    return pod.get("metadata", {}).get("namespace", "")


def uid(pod: Pod) -> str:
    return pod.get("metadata", {}).get("uid", "")


def labels(pod: Pod) -> dict[str, str]:
    return pod.get("metadata", {}).get("labels", {}) or {}


def node_name(pod: Pod) -> str:
    return pod.get("spec", {}).get("nodeName", "")


def phase(pod: Pod) -> str:
    return pod.get("status", {}).get("phase", "")


def is_running(pod: Pod) -> bool:
    return phase(pod) == "Running"


def is_terminal(pod: Pod) -> bool:
    """Succeeded/Failed — the one lifecycle rule shared by the orphan
    reconciler and the warm pool, so they can never drift on what counts
    as a dead pod."""
    return phase(pod) in ("Succeeded", "Failed")


def container_ids(pod: Pod) -> list[str]:
    """Raw containerID strings, e.g. ``containerd://<64hex>`` (GKE default)
    or ``docker://<64hex>`` — the reference only handled docker
    (``pkg/util/util.go:22-23``)."""
    statuses = pod.get("status", {}).get("containerStatuses", []) or []
    return [s.get("containerID", "") for s in statuses if s.get("containerID")]


def parse_container_id(raw: str) -> tuple[str, str]:
    """Split ``<runtime>://<id>`` into (runtime, id). Accepts docker,
    containerd, cri-o; bare IDs pass through with runtime ''. """
    if "://" in raw:
        runtime, _, cid = raw.partition("://")
        return runtime, cid
    return "", raw


def qos_class(pod: Pod) -> str:
    """Kubelet-reported QoS if present, else computed (ref cgroup.go:177-237)."""
    reported = pod.get("status", {}).get("qosClass")
    if reported:
        return reported
    return compute_qos_class(pod)


def compute_qos_class(pod: Pod) -> str:
    """The upstream kubelet algorithm: Guaranteed iff every container sets
    cpu+memory limits with requests (if set) equal to limits; BestEffort iff
    no container sets any cpu/memory request or limit; else Burstable."""
    requests: dict[str, str] = {}
    limits: dict[str, str] = {}
    guaranteed = True
    containers = (pod.get("spec", {}).get("containers", []) or []) + \
                 (pod.get("spec", {}).get("initContainers", []) or [])
    for container in containers:
        resources = container.get("resources", {}) or {}
        for resource, qty in (resources.get("requests", {}) or {}).items():
            if resource in _SUPPORTED_QOS_RESOURCES:
                requests[resource] = qty
        for resource, qty in (resources.get("limits", {}) or {}).items():
            if resource in _SUPPORTED_QOS_RESOURCES:
                limits[resource] = qty
        req = (resources.get("requests", {}) or {})
        lim = (resources.get("limits", {}) or {})
        for resource in _SUPPORTED_QOS_RESOURCES:
            if resource not in lim:
                guaranteed = False
            elif resource in req and req[resource] != lim[resource]:
                guaranteed = False
    if not requests and not limits:
        return QOS_BEST_EFFORT
    if guaranteed and len(limits) == len(_SUPPORTED_QOS_RESOURCES):
        return QOS_GUARANTEED
    return QOS_BURSTABLE


def owner_references(pod: Pod) -> list[dict[str, Any]]:
    return pod.get("metadata", {}).get("ownerReferences", []) or []


def resource_limit(pod: Pod, resource: str) -> int:
    """Total `resource` limit across containers (integer quantities only —
    device-plugin resources are always integers)."""
    total = 0
    for container in pod.get("spec", {}).get("containers", []) or []:
        qty = ((container.get("resources", {}) or {})
               .get("limits", {}) or {}).get(resource)
        if qty is not None:
            total += int(qty)
    return total
