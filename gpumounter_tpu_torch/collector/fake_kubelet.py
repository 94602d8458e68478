"""A real gRPC server speaking the PodResources protocol on a unix socket.

The port of :mod:`gpumounter_tpu.collector.fake_kubelet`: a test double for
the kubelet itself, so the production
:class:`~gpumounter_tpu_torch.collector.podresources.KubeletPodResourcesClient`
is exercised over an actual socket, wire format and all.

Serves BOTH API generations a real kubelet lineage spans: ``v1`` (List +
GetAllocatableResources, modern kubelets) and ``v1alpha1`` (List only, the
API the reference consumed). ``serve_v1=False`` models an old kubelet so
tests can pin the client's fallback path.

Without a ``socket_path`` the server binds under a fresh, short temporary
directory: an ``AF_UNIX`` path holds at most 107 bytes, which a deep test
directory can exceed. ``grpc`` is imported when the server starts.
"""

from __future__ import annotations

import concurrent.futures
import os
import shutil
import tempfile

from gpumounter_tpu_torch.collector.podresources import FakePodResourcesClient

# sun_path is 108 bytes, one of them the terminating NUL
UNIX_PATH_MAX = 107


def _to_pb(listing, pb_module):
    """A listing (plain or parsed) as ``pb_module``'s response message."""
    resp = pb_module.ListPodResourcesResponse()
    for pod in listing.pod_resources:
        pr = resp.pod_resources.add(name=pod.name, namespace=pod.namespace)
        for container in pod.containers:
            cr = pr.containers.add(name=container.name)
            for dev in container.devices:
                cr.devices.add(resource_name=dev.resource_name,
                               device_ids=list(dev.device_ids))
    return resp


class FakeKubeletServer:
    """Serves the PodResourcesLister services on ``unix://<socket_path>``
    from a FakePodResourcesClient's assignment table (mutable while
    running)."""

    def __init__(self, socket_path: str | None = None,
                 state: FakePodResourcesClient | None = None,
                 serve_v1: bool = True):
        self._tmpdir: str | None = None
        if socket_path is None:
            self._tmpdir = tempfile.mkdtemp(prefix="fk-")
            socket_path = os.path.join(self._tmpdir, "kubelet.sock")
        if len(os.fsencode(socket_path)) > UNIX_PATH_MAX:
            raise ValueError(
                f"unix socket path is {len(os.fsencode(socket_path))} bytes,"
                f" over the {UNIX_PATH_MAX}-byte limit: {socket_path}")
        self.socket_path = socket_path
        self.state = state or FakePodResourcesClient()
        self.serve_v1 = serve_v1
        self._server = None

    def _v1alpha1_handler(self, grpc):
        from gpumounter_tpu_torch.api import podresources_pb2 as pb

        def list_handler(request, context):
            return _to_pb(self.state.list_pods(), pb)

        return grpc.method_handlers_generic_handler(
            "v1alpha1.PodResourcesLister", {
                "List": grpc.unary_unary_rpc_method_handler(
                    list_handler,
                    request_deserializer=(
                        pb.ListPodResourcesRequest.FromString),
                    response_serializer=(
                        pb.ListPodResourcesResponse.SerializeToString),
                ),
            })

    def _v1_handler(self, grpc):
        from gpumounter_tpu_torch.api import podresources_v1_pb2 as pb_v1

        def list_handler(request, context):
            # same assignment table, under the v1 package
            return _to_pb(self.state.list_pods(), pb_v1)

        def allocatable_handler(request, context):
            # None = this fake has no allocatable opinion; a real v1 kubelet
            # always answers, so tests opting in set state.allocatable.
            if self.state.allocatable is None:
                context.abort(grpc.StatusCode.UNIMPLEMENTED,
                              "fake kubelet: no allocatable table set")
            resp = pb_v1.AllocatableResourcesResponse()
            for resource, ids in self.state.allocatable.items():
                resp.devices.add(resource_name=resource, device_ids=ids)
            return resp

        return grpc.method_handlers_generic_handler(
            "v1.PodResourcesLister", {
                "List": grpc.unary_unary_rpc_method_handler(
                    list_handler,
                    request_deserializer=(
                        pb_v1.ListPodResourcesRequest.FromString),
                    response_serializer=(
                        pb_v1.ListPodResourcesResponse.SerializeToString),
                ),
                "GetAllocatableResources":
                    grpc.unary_unary_rpc_method_handler(
                        allocatable_handler,
                        request_deserializer=(
                            pb_v1.AllocatableResourcesRequest.FromString),
                        response_serializer=(
                            pb_v1.AllocatableResourcesResponse
                            .SerializeToString),
                    ),
            })

    def start(self) -> "FakeKubeletServer":
        import grpc
        os.makedirs(os.path.dirname(self.socket_path), exist_ok=True)
        if os.path.exists(self.socket_path):
            os.unlink(self.socket_path)
        self._executor = concurrent.futures.ThreadPoolExecutor(max_workers=2)
        self._server = grpc.server(self._executor)
        handlers = [self._v1alpha1_handler(grpc)]
        if self.serve_v1:
            handlers.append(self._v1_handler(grpc))
        self._server.add_generic_rpc_handlers(tuple(handlers))
        self._server.add_insecure_port(f"unix://{self.socket_path}")
        self._server.start()
        return self

    def pause(self) -> None:
        """Stop serving and remove the socket, as a restarting kubelet
        does; :meth:`start` serves again on the same path."""
        if self._server is not None:
            self._server.stop(grace=0).wait()
            self._server = None
            # gRPC does not own its executor: end its idle threads too
            self._executor.shutdown(wait=False)
        if os.path.exists(self.socket_path):
            os.unlink(self.socket_path)

    def stop(self) -> None:
        if self._server is not None:
            self._server.stop(grace=0)
            self._server = None
            # gRPC does not own its executor: end its idle threads too
            self._executor.shutdown(wait=False)
        if os.path.exists(self.socket_path):
            os.unlink(self.socket_path)
        if self._tmpdir is not None:
            shutil.rmtree(self._tmpdir, ignore_errors=True)
            self._tmpdir = None

    def __enter__(self) -> "FakeKubeletServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
