"""Typed errors for the control plane: the port's own copy of
:mod:`gpumounter_tpu.utils.errors`, with the device-specific names
following the device (``InsufficientGPUError``).

The reference smuggles error kinds through string comparison (e.g. the literal
``"GPUBusy"`` at ``pkg/util/util.go:108`` matched at
``pkg/server/gpu-mount/server.go:70-76``). We use an exception hierarchy so
every layer can classify failures without string matching, and the gRPC layer
maps them onto the wire enums in one place.
"""

from __future__ import annotations


class TPUMounterError(Exception):
    """Base class for all framework errors."""


class PodNotFoundError(TPUMounterError):
    def __init__(self, namespace: str, name: str):
        super().__init__(f"pod {namespace}/{name} not found")
        self.namespace = namespace
        self.name = name


class InsufficientGPUError(TPUMounterError):
    """The scheduler could not place slave pods: not enough free GPUs."""


class DeviceBusyError(TPUMounterError):
    """Processes inside the target container hold the device open."""

    def __init__(self, device_id: str, pids: list[int]):
        super().__init__(f"device {device_id} busy (pids={pids})")
        self.device_id = device_id
        self.pids = pids


class DeviceNotFoundError(TPUMounterError):
    def __init__(self, device_id: str):
        super().__init__(f"device {device_id} not found / not removable")
        self.device_id = device_id


class MountPolicyError(TPUMounterError):
    """The requested mount conflicts with the pod's current mount type
    (ref ``pkg/util/util.go:207-226`` CanMount)."""


class TopologyError(MountPolicyError):
    """The requested GPU count cannot form a valid group on the target
    node's advertised topology (no reference analog: the reference treats
    GPUs as interchangeable). Subclasses MountPolicyError so it rides the
    same FAILED_PRECONDITION→412 mapping."""


class ActuationError(TPUMounterError):
    """Host-side actuation (cgroup write / BPF attach / nsenter) failed."""


class CgroupError(ActuationError):
    """Could not resolve or modify the container's cgroup."""


class GateBackendError(ActuationError):
    """A device-gate backend (eBPF map / cgroup writes / fake) faulted.

    Deliberately distinct from :class:`CgroupError`: a backend fault makes
    the :class:`~gpumounter_tpu_torch.actuation.gate.DeviceGate` degrade to
    the legacy enforcement path (counted + evented), while a CgroupError is
    a typed actuation failure that rides the normal rollback."""


class AllocationTimeoutError(TPUMounterError):
    """Slave pod did not reach Running/terminal state within the deadline.

    The reference busy-polls the apiserver forever with no timeout
    (allocator.go:247-282); we watch with a deadline instead.
    """


class KubeletUnavailableError(TPUMounterError):
    """The kubelet PodResources socket is missing or unresponsive."""


class WorkerDrainingError(TPUMounterError):
    """The worker is draining (SIGTERM / POST /drainz / spot notice):
    NEW attaches are refused — the gRPC adapter answers UNAVAILABLE with
    a ``draining:`` detail the gateway maps to a typed 503 Draining
    (never retried as a transport fault). Detaches keep flowing: drain
    frees capacity, it must not wedge it."""


class K8sApiError(TPUMounterError):
    """Non-404 failure talking to the kube-apiserver.

    ``status`` is the HTTP status, or 0 when no HTTP response was received
    at all. Status 0 used to conflate every transport failure; ``cause``
    now carries the underlying kind so the retry classifier and trace
    error attributes can tell a socket timeout (the request may have
    LANDED) from connection refusal (it certainly did not):

    - ``"timeout"``   — connect/read deadline expired mid-request
    - ``"refused"``   — TCP connection refused (nothing listening)
    - ``"reset"``     — established connection reset/broken mid-stream
    - ``"dns"``       — name resolution failed
    - ``"unreachable"`` — other transport-level failure
    - ``""``          — an HTTP-level error (status > 0) or legacy callers

    ``retry_after_s`` carries a parsed ``Retry-After`` header (429/503)
    for the backoff layer to honor.
    """

    def __init__(self, status: int, message: str, cause: str = "",
                 retry_after_s: float | None = None):
        detail = f" [{cause}]" if cause else ""
        super().__init__(f"apiserver error {status}{detail}: {message}")
        self.status = status
        self.cause = cause
        self.retry_after_s = retry_after_s


class QuotaExceededError(TPUMounterError):
    """Admission denial: the tenant's live chip usage plus this request
    would exceed its admission cap (quota * burst). ``retry_after_s`` is
    the broker's hint for when capacity may free (soonest lease expiry of
    the tenant, else a default) — surfaced as an HTTP Retry-After."""

    def __init__(self, tenant: str, usage: int, requested: int, cap: int,
                 retry_after_s: float):
        super().__init__(
            f"tenant {tenant!r} over quota: {usage} chip(s) in use + "
            f"{requested} requested > cap {cap}")
        self.tenant = tenant
        self.usage = usage
        self.requested = requested
        self.cap = cap
        self.retry_after_s = retry_after_s


class QueueFullError(TPUMounterError):
    """The broker's per-priority FIFO is at its bound: the request is
    shed instead of queued (429 + Retry-After upstream)."""

    def __init__(self, priority: str, depth: int, retry_after_s: float):
        super().__init__(
            f"attach queue full at priority {priority!r} ({depth} waiting)")
        self.priority = priority
        self.depth = depth
        self.retry_after_s = retry_after_s


class StoreFencedError(TPUMounterError):
    """An intent-store write carried a fencing token below the shard's
    recorded fence: this replica was deposed (a peer acquired the shard
    with a higher token) and must demote instead of writing — the
    mechanism that makes split-brain writes impossible (docs/guide/HA.md)."""

    def __init__(self, shard: int, token: int, fence: int):
        super().__init__(
            f"store write fenced on shard {shard}: token {token} < "
            f"recorded fence {fence} (a peer leads this shard now)")
        self.shard = shard
        self.token = token
        self.fence = fence


class CircuitOpenError(TPUMounterError):
    """A circuit breaker is open: the target has failed enough consecutive
    calls that further attempts are refused without dialing, until the
    half-open probe succeeds. ``retry_after_s`` is the time until the next
    probe slot — surfaced to HTTP callers as a Retry-After header."""

    def __init__(self, target: str, retry_after_s: float):
        super().__init__(
            f"circuit open for {target}: failing fast "
            f"(probe in {retry_after_s:.1f}s)")
        self.target = target
        self.retry_after_s = retry_after_s
