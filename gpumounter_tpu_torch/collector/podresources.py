"""Kubelet PodResources client over the node-local unix socket.

The port of :mod:`gpumounter_tpu.collector.podresources`. Ref
``pkg/util/gpu/collector/collector.go:90-111,165-194``: stat the socket,
dial it with a unix dialer and 10s timeout, call the PodResourcesLister
``List`` RPC. On an NVIDIA node the API reports ``nvidia.com/gpu`` by the
driver's ``GPU-...`` UUIDs.

API version: modern kubelets serve ``v1`` (with GetAllocatableResources);
the 2020-era reference consumed ``v1alpha1`` via client-go, and alpha APIs
can be disabled outright. The client tries v1 first and permanently falls
back to v1alpha1 on UNIMPLEMENTED, so it works against either kubelet
generation.

``grpc`` and the generated protobuf modules are imported inside the gRPC
client only: the collector and :class:`FakePodResourcesClient` run on a
machine that has neither package. The fake lists plain
:class:`PodResourcesListing` objects, which carry the response's field
names, so the collector reads either.
"""

from __future__ import annotations

import abc
import dataclasses
import os
import threading
import time

from gpumounter_tpu_torch.utils import consts
from gpumounter_tpu_torch.utils.errors import KubeletUnavailableError
from gpumounter_tpu_torch.utils.log import get_logger
from gpumounter_tpu_torch.utils.retry import RetryPolicy, call_with_retry
from gpumounter_tpu_torch.utils.trace import k8s_call

logger = get_logger("collector.podresources")

_LIST_METHOD_V1ALPHA1 = "/v1alpha1.PodResourcesLister/List"
_LIST_METHOD_V1 = "/v1.PodResourcesLister/List"
_ALLOCATABLE_METHOD_V1 = "/v1.PodResourcesLister/GetAllocatableResources"

# UNIMPLEMENTED is what a kubelet without the service answers — a
# PERMANENT fact about the serving API. UNKNOWN can also mean a transient
# failure of a registered handler (grpc-go), so it only triggers a
# fallback for THIS call without pinning the version — the next List
# re-probes v1. (Status-code names; grpc is imported where they are used.)
_PERMANENT_FALLBACK_CODES = ("UNIMPLEMENTED",)
_TRANSIENT_FALLBACK_CODES = ("UNKNOWN",)


# -- the listing, as plain objects ----------------------------------------------
# Field names are the PodResources messages'; a response parsed from the
# wire and a PodResourcesListing read the same.

@dataclasses.dataclass
class ContainerDevices:
    resource_name: str
    device_ids: list[str]


@dataclasses.dataclass
class ContainerResources:
    name: str
    devices: list[ContainerDevices]


@dataclasses.dataclass
class PodResources:
    name: str
    namespace: str
    containers: list[ContainerResources]


@dataclasses.dataclass
class PodResourcesListing:
    pod_resources: list[PodResources]


class PodResourcesClient(abc.ABC):
    """Interface so the collector can run against a fake in tests
    (SURVEY.md §4: interface-extract the kubelet PodResources client).

    :meth:`list_pods` is a template: subclasses implement the one-shot
    :meth:`_list_pods_once`, and the base class runs it under the unified
    retry layer — a kubelet socket flap (kubelet restart, device-plugin
    re-registration window) is absorbed here instead of failing the whole
    attach. The backoff is short and aggressive: the socket is node-local,
    and the caller is holding an attach request open.
    """

    retry_policy = RetryPolicy(max_attempts=3, base_delay_s=0.05,
                               max_delay_s=0.5, deadline_s=10.0)

    @abc.abstractmethod
    def _list_pods_once(self):
        """One List: a ``ListPodResourcesResponse`` or a
        :class:`PodResourcesListing`."""

    def list_pods(self):
        # Kubelet snapshots share the k8s request family (it IS a control-
        # plane hop of the attach path); resource label "podresources"
        # keeps them distinguishable from apiserver calls. One k8s_call
        # per attempt, like the apiserver client.
        def attempt():
            with k8s_call("LIST", "podresources"):
                return self._list_pods_once()
        return call_with_retry(attempt, policy=self.retry_policy,
                               target="kubelet")

    def allocatable_gpu_ids(self, resource_name: str) -> set[str] | None:
        """Device ids the kubelet will actually schedule for
        ``resource_name`` (v1 GetAllocatableResources), or None when the
        serving API has no such RPC (v1alpha1) — callers then fall back to
        the enumerator's view."""
        return None


class KubeletPodResourcesClient(PodResourcesClient):
    # The allocatable set only changes on device-plugin health transitions;
    # re-fetching it on every collector refresh (which runs per RPC) would
    # double the unix-socket round-trips for no information.
    ALLOCATABLE_TTL_S = 10.0

    def __init__(self, socket_path: str = consts.KUBELET_SOCKET_PATH,
                 timeout_s: float = consts.PODRESOURCES_CONNECT_TIMEOUT_S):
        self.socket_path = socket_path
        self.timeout_s = timeout_s
        self.api_version: str | None = None     # probed on first List
        self._alloc_cache: dict[str, tuple[float, set[str] | None]] = {}
        # ONE long-lived channel to the node-local socket: a fresh dial +
        # HTTP/2 handshake per snapshot was the largest single cost of the
        # kubelet hop. (channel, {method: multicallable}) is one unit under
        # the lock: stubs are bound to the channel they were created from,
        # so a concurrent _drop_channel can never leave a stub pointing at
        # a closed channel in the cache.
        self._cached: tuple | None = None
        self._channel_lock = threading.Lock()

    def _call(self, channel_stubs: tuple, method: str, request,
              response_type):
        channel, stubs = channel_stubs
        call = stubs.get(method)
        if call is None:
            call = stubs[method] = channel.unary_unary(
                method,
                request_serializer=request.SerializeToString,
                response_deserializer=response_type.FromString,
            )
        return call(request, timeout=self.timeout_s)

    def _channel(self) -> tuple:
        """The cached (channel, stubs) pair."""
        import grpc
        # ref collector.go:92: stat before dialing for a crisp error
        if not os.path.exists(self.socket_path):
            raise KubeletUnavailableError(
                f"kubelet PodResources socket missing: {self.socket_path}")
        with self._channel_lock:
            if self._cached is None:
                self._cached = (grpc.insecure_channel(
                    f"unix://{self.socket_path}"), {})
            return self._cached

    def _drop_channel(self) -> None:
        """Forget the cached channel after a transport failure: the next
        call re-dials (the kubelet may have restarted on a new socket
        incarnation). In-flight calls that still hold the old pair keep
        their own consistent channel+stubs view."""
        with self._channel_lock:
            cached, self._cached = self._cached, None
        if cached is not None:
            try:
                cached[0].close()
            except Exception:       # noqa: BLE001 — teardown best-effort
                pass

    def _list_pods_once(self):
        import grpc

        from gpumounter_tpu_torch.api import podresources_pb2 as pb
        from gpumounter_tpu_torch.api import podresources_v1_pb2 as pb_v1
        conn = self._channel()
        if self.api_version in (None, "v1"):
            try:
                resp = self._call(conn, _LIST_METHOD_V1,
                                  pb_v1.ListPodResourcesRequest(),
                                  pb_v1.ListPodResourcesResponse)
                if self.api_version is None:
                    logger.info("kubelet PodResources API: v1")
                    self.api_version = "v1"
                return resp
            except grpc.RpcError as e:
                code = e.code().name
                if (self.api_version is None
                        and code in _PERMANENT_FALLBACK_CODES):
                    logger.info(
                        "kubelet has no v1 PodResources (%s); falling "
                        "back to v1alpha1", code)
                    self.api_version = "v1alpha1"
                elif (self.api_version is None
                        and code in _TRANSIENT_FALLBACK_CODES):
                    # try v1alpha1 for this call, but leave the version
                    # unpinned so the next List re-probes v1
                    logger.info(
                        "v1 PodResources List returned %s; trying "
                        "v1alpha1 without pinning", code)
                else:
                    # transport-level failure: drop the cached channel
                    # so the retry (and every later call) re-dials
                    self._drop_channel()
                    raise KubeletUnavailableError(
                        f"PodResources List failed: {e.code()}: "
                        f"{e.details()}") from e
        try:
            return self._call(conn, _LIST_METHOD_V1ALPHA1,
                              pb.ListPodResourcesRequest(),
                              pb.ListPodResourcesResponse)
        except grpc.RpcError as e:
            self._drop_channel()
            raise KubeletUnavailableError(
                f"PodResources List failed: {e.code()}: "
                f"{e.details()}") from e

    def allocatable_gpu_ids(self, resource_name: str) -> set[str] | None:
        if self.api_version is None:
            self.list_pods()                    # probe the API version
        if self.api_version != "v1":
            return None
        cached = self._alloc_cache.get(resource_name)
        now = time.monotonic()
        if cached is not None and now < cached[0]:
            return cached[1]

        def attempt():
            with k8s_call("GET", "podresources"):
                return self._allocatable_once(resource_name, now)
        resp = call_with_retry(attempt, policy=self.retry_policy,
                               target="kubelet")
        if resp is None:        # fallback-code path cached None already
            return None
        ids = {device_id
               for dev in resp.devices if dev.resource_name == resource_name
               for device_id in dev.device_ids}
        self._alloc_cache[resource_name] = (
            now + self.ALLOCATABLE_TTL_S, ids)
        return ids

    def _allocatable_once(self, resource_name: str, now: float):
        import grpc

        from gpumounter_tpu_torch.api import podresources_v1_pb2 as pb_v1
        conn = self._channel()
        try:
            return self._call(conn, _ALLOCATABLE_METHOD_V1,
                              pb_v1.AllocatableResourcesRequest(),
                              pb_v1.AllocatableResourcesResponse)
        except grpc.RpcError as e:
            if e.code().name in (_PERMANENT_FALLBACK_CODES
                                 + _TRANSIENT_FALLBACK_CODES):
                # fake/partial v1 server; cache too — absent stays absent
                self._alloc_cache[resource_name] = (
                    now + self.ALLOCATABLE_TTL_S, None)
                return None
            self._drop_channel()
            raise KubeletUnavailableError(
                f"GetAllocatableResources failed: {e.code()}: "
                f"{e.details()}") from e


class FakePodResourcesClient(PodResourcesClient):
    """In-memory fake: assignments is {(namespace, pod): {container: {resource:
    [device_ids]}}}. Lists plain :class:`PodResourcesListing` objects, so
    it needs no protobuf."""

    def __init__(self, assignments: dict | None = None):
        self.assignments = assignments or {}
        self.list_calls = 0        # tests assert O(1) LISTs per RPC
        # {resource: [ids]} — what a v1 kubelet's GetAllocatableResources
        # reports. None = "no v1 allocatable view" (v1alpha1-era behaviour).
        self.allocatable: dict[str, list[str]] | None = None
        # testing/chaos.py FaultInjector: kubelet socket-flap injection
        # fires inside the base class's retry layer, same as production.
        self.faults = None

    def assign(self, namespace: str, pod: str, device_ids: list[str],
               container: str = "main",
               resource: str = consts.GPU_RESOURCE_NAME) -> None:
        self.assignments.setdefault((namespace, pod), {}).setdefault(
            container, {})[resource] = list(device_ids)

    def unassign(self, namespace: str, pod: str) -> None:
        self.assignments.pop((namespace, pod), None)

    def _list_pods_once(self) -> PodResourcesListing:
        if self.faults is not None:
            self.faults.fire("LIST", "podresources")
        self.list_calls += 1
        # the scheduler's threads assign while kubelet handlers list: walk
        # copies (one list() of a dict is atomic under the GIL), or a List
        # under load fails with "dictionary changed size during iteration"
        return PodResourcesListing([
            PodResources(pod, ns, [
                ContainerResources(cname, [
                    ContainerDevices(resource, list(ids))
                    for resource, ids in list(resources.items())])
                for cname, resources in list(containers.items())])
            for (ns, pod), containers in list(self.assignments.items())])

    def allocatable_gpu_ids(self, resource_name: str) -> set[str] | None:
        if self.allocatable is None:
            return None
        return set(self.allocatable.get(resource_name, []))
