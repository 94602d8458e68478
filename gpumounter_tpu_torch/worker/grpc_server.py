"""gRPC wire adapter for the worker service (the port of
:mod:`gpumounter_tpu.worker.grpc_server`).

Ref ``cmd/GPUMounter-worker/main.go:24-33`` (insecure gRPC on :1200 with both
services registered). One combined ``gpu_mount.GPUMountService`` here instead
of the reference's two single-method services (``api.proto:21-23,43-45``) —
same RPCs, one registration. Policy violations and actuation failures become
gRPC status errors (FAILED_PRECONDITION / INTERNAL); expected domain outcomes
ride in the response enum, exactly like the reference's result codes.
"""

from __future__ import annotations

import concurrent.futures

import grpc

from gpumounter_tpu_torch.api import gpu_mount_pb2 as pb
from gpumounter_tpu_torch.utils import consts
from gpumounter_tpu_torch.utils.errors import (MountPolicyError,
                                               TPUMounterError,
                                               WorkerDrainingError)
from gpumounter_tpu_torch.utils.log import get_logger
from gpumounter_tpu_torch.utils.trace import Trace
from gpumounter_tpu_torch.worker.service import GPUMountService

logger = get_logger("worker.grpc")

SERVICE_NAME = "gpu_mount.GPUMountService"


def _metadata_value(context: grpc.ServicerContext, wanted: str,
                    default: str = "") -> str:
    for key, value in context.invocation_metadata() or ():
        if key == wanted:
            return value
    return default


def _request_id(context: grpc.ServicerContext) -> str:
    """x-request-id from the caller's metadata (master stamps one per HTTP
    request) so one mount flow is grep-able across master+worker logs."""
    return _metadata_value(context, "x-request-id", "-")


def _add_handler(service: GPUMountService):
    def handle(request: pb.AddGPURequest,
               context: grpc.ServicerContext) -> pb.AddGPUResponse:
        rid = _request_id(context)
        logger.debug("[rid=%s] AddGPU %s/%s n=%d entire=%s", rid,
                    request.namespace, request.pod_name, request.gpu_num,
                    request.is_entire_mount)
        try:
            outcome = service.add_gpu(request.pod_name, request.namespace,
                                      request.gpu_num,
                                      request.is_entire_mount,
                                      txn_id=request.txn_id,
                                      request_id=rid if rid != "-" else "")
        except WorkerDrainingError as e:
            # the worker is going away gracefully (worker/drain.py):
            # UNAVAILABLE with the draining: detail marker the gateway
            # maps to a typed 503 Draining (and never retries — every
            # retry would get the same answer until the drain ends)
            context.abort(grpc.StatusCode.UNAVAILABLE,
                          consts.DRAINING_DETAIL_PREFIX + " " + str(e))
        except MountPolicyError as e:
            context.abort(grpc.StatusCode.FAILED_PRECONDITION, str(e))
        except TPUMounterError as e:
            logger.exception("[rid=%s] AddGPU internal failure", rid)
            context.abort(grpc.StatusCode.INTERNAL, str(e))
        resp = pb.AddGPUResponse(result=int(outcome.result))
        resp.device_ids.extend(c.uuid for c in outcome.chips)
        resp.device_paths.extend(c.container_path for c in outcome.chips)
        logger.debug("[rid=%s] AddGPU -> %s", rid, outcome.result.name)
        return resp
    return handle


def _remove_handler(service: GPUMountService):
    def handle(request: pb.RemoveGPURequest,
               context: grpc.ServicerContext) -> pb.RemoveGPUResponse:
        rid = _request_id(context)
        # Detach cause rides metadata (no proto change): the broker's
        # preemption / lease-expiry detaches say why, and the service
        # propagates it into the audit event + journal record.
        cause = _metadata_value(context, consts.DETACH_CAUSE_METADATA_KEY)
        logger.debug("[rid=%s] RemoveGPU %s/%s uuids=%s force=%s%s", rid,
                    request.namespace, request.pod_name,
                    list(request.uuids), request.force,
                    f" cause={cause}" if cause else "")
        try:
            outcome = service.remove_gpu(request.pod_name, request.namespace,
                                         list(request.uuids), request.force,
                                         txn_id=request.txn_id,
                                         request_id=rid if rid != "-" else "",
                                         cause=cause)
        except TPUMounterError as e:
            logger.exception("[rid=%s] RemoveGPU internal failure", rid)
            context.abort(grpc.StatusCode.INTERNAL, str(e))
        resp = pb.RemoveGPUResponse(result=int(outcome.result))
        resp.busy_pids.extend(outcome.busy_pids)
        logger.debug("[rid=%s] RemoveGPU -> %s", rid, outcome.result.name)
        return resp
    return handle


def _status_handler(service: GPUMountService):
    def handle(request: pb.GPUStatusRequest,
               context: grpc.ServicerContext) -> pb.GPUStatusResponse:
        from gpumounter_tpu_torch.utils.errors import PodNotFoundError
        # Status RPCs get a trace too: they are the read path operators
        # lean on while debugging, and they hit both the apiserver and the
        # kubelet — the k8s child spans join via trace.activate().
        trace = Trace("status", _request_id(context))
        result = "EXCEPTION"
        try:
            with trace.activate():
                mount_type, chips = service.gpu_status(request.pod_name,
                                                       request.namespace)
            result = "SUCCESS"
        except PodNotFoundError as e:
            result = "POD_NOT_FOUND"
            context.abort(grpc.StatusCode.NOT_FOUND, str(e))
        except TPUMounterError as e:
            logger.exception("GPUStatus internal failure")
            context.abort(grpc.StatusCode.INTERNAL, str(e))
        finally:
            trace.finish(result)
        resp = pb.GPUStatusResponse(mount_type=mount_type.value)
        for chip in chips:
            entry = resp.gpus.add(device_id=chip.device_id,
                                   device_path=chip.device_path,
                                   slave_pod=chip.slave_pod)
            entry.busy_pids.extend(chip.busy_pids)
        return resp
    return handle


def _node_status_handler(service: GPUMountService):
    def handle(request: pb.GPUNodeStatusRequest,
               context: grpc.ServicerContext) -> pb.GPUNodeStatusResponse:
        trace = Trace("node_status", _request_id(context))
        result = "EXCEPTION"
        try:
            with trace.activate():
                chips = service.node_status()
            result = "SUCCESS"
        except TPUMounterError as e:
            logger.exception("GPUNodeStatus internal failure")
            context.abort(grpc.StatusCode.INTERNAL, str(e))
        finally:
            trace.finish(result)
        resp = pb.GPUNodeStatusResponse(
            node=service.settings.node_name)
        for chip in chips:
            resp.gpus.add(device_id=chip.uuid,
                          device_path=chip.device_path,
                          state=chip.state.value,
                          pod_name=chip.pod_name,
                          namespace=chip.namespace,
                          accelerator=chip.accelerator)
        return resp
    return handle


# Workers are dialed by pod IP, which cannot appear in a pre-provisioned
# cert's SANs; the client instead verifies against this fixed DNS name,
# which the cert must carry (override with TPU_MOUNTER_TLS_SERVER_NAME).
DEFAULT_TLS_SERVER_NAME = "gpu-mounter-worker"


def load_tls_config(env: dict | None = None) -> "TlsConfig | None":
    """TLS material from TPU_MOUNTER_TLS_{CERT,KEY,CA}_FILE env vars. The
    reference dials workers with ``grpc.WithInsecure`` on the pod network
    (cmd/GPUMounter-master/main.go:82 — SURVEY.md §7 lists TLS as a
    required delta); with a CA set on the server, client certs are required
    (mTLS). CA-only is valid for a client (server-auth TLS). A half-set
    cert/key pair raises rather than silently downgrading to plaintext."""
    import os
    env = os.environ if env is None else env
    cert = env.get("TPU_MOUNTER_TLS_CERT_FILE")
    key = env.get("TPU_MOUNTER_TLS_KEY_FILE")
    ca = env.get("TPU_MOUNTER_TLS_CA_FILE")
    if not (cert or key or ca):
        return None
    if bool(cert) != bool(key):
        raise ValueError(
            "TPU_MOUNTER_TLS_CERT_FILE and TPU_MOUNTER_TLS_KEY_FILE must be "
            "set together (refusing to silently run without TLS)")
    return TlsConfig(cert_file=cert, key_file=key, ca_file=ca,
                     server_name=env.get("TPU_MOUNTER_TLS_SERVER_NAME",
                                         DEFAULT_TLS_SERVER_NAME))


class TlsConfig:
    def __init__(self, cert_file: str | None = None,
                 key_file: str | None = None,
                 ca_file: str | None = None,
                 server_name: str = DEFAULT_TLS_SERVER_NAME):
        self.cert_file = cert_file
        self.key_file = key_file
        self.ca_file = ca_file
        self.server_name = server_name

    def _read(self, path: str | None) -> bytes | None:
        if not path:
            return None
        with open(path, "rb") as f:
            return f.read()

    def server_credentials(self) -> grpc.ServerCredentials:
        if not (self.cert_file and self.key_file):
            raise ValueError("server TLS requires cert and key files")
        ca = self._read(self.ca_file)
        return grpc.ssl_server_credentials(
            [(self._read(self.key_file), self._read(self.cert_file))],
            root_certificates=ca,
            require_client_auth=ca is not None)

    def channel_credentials(self) -> grpc.ChannelCredentials:
        return grpc.ssl_channel_credentials(
            root_certificates=self._read(self.ca_file),
            private_key=self._read(self.key_file),
            certificate_chain=self._read(self.cert_file))

    def channel_options(self) -> list[tuple[str, str]]:
        return [("grpc.ssl_target_name_override", self.server_name)]


def build_server(service: GPUMountService,
                 port: int = consts.WORKER_GRPC_PORT,
                 address: str = "[::]",
                 max_workers: int = 8,
                 tls: TlsConfig | None = None,
                 mode: str = "threadpool",
                 max_parked: int = consts.DEFAULT_GRPC_MAX_PARKED
                 ) -> tuple[grpc.Server, int]:
    """Returns (server, bound_port); port 0 picks a free port (tests).

    ``mode="threadpool"`` (default here; rigs and the TPU_GRPC_ASYNC=0
    fallback) is the historical fixed pool: ``max_workers`` threads,
    each occupied for its RPC's full wall time. ``mode="parking"`` (the
    production default via worker/main.py) serves handlers from a
    :class:`~gpumounter_tpu_torch.utils.parking.ParkingExecutor`:
    ``max_workers`` becomes the ACTIVE-thread budget and slow waits
    release their slot, so in-flight RPCs are bounded by ``max_parked``
    instead of the thread count — the 10k admission path's worker half.
    """
    if mode == "parking":
        from gpumounter_tpu_torch.utils.parking import ParkingExecutor
        executor = ParkingExecutor(max_active=max_workers,
                                   max_threads=max_parked)
        # max_parked really IS the in-flight bound: gRPC refuses RPC
        # number max_parked+1 with RESOURCE_EXHAUSTED (the gateway maps
        # it to 429 + Retry-After through the retry classifier) instead
        # of queueing it unboundedly behind the thread ceiling
        server = grpc.server(executor,
                             maximum_concurrent_rpcs=max_parked)
    elif mode == "threadpool":
        executor = concurrent.futures.ThreadPoolExecutor(
            max_workers=max_workers)
        server = grpc.server(executor)
    else:
        raise ValueError(f"unknown gRPC server mode {mode!r}: "
                         "want parking|threadpool")
    # introspection handle for tests and /drainz-adjacent tooling; None
    # under the legacy pool (so its absence IS the off-path pin)
    server.parking_executor = (executor if mode == "parking" else None)
    server.executor = executor
    handler = grpc.method_handlers_generic_handler(SERVICE_NAME, {
        "AddGPU": grpc.unary_unary_rpc_method_handler(
            _add_handler(service),
            request_deserializer=pb.AddGPURequest.FromString,
            response_serializer=pb.AddGPUResponse.SerializeToString),
        "RemoveGPU": grpc.unary_unary_rpc_method_handler(
            _remove_handler(service),
            request_deserializer=pb.RemoveGPURequest.FromString,
            response_serializer=pb.RemoveGPUResponse.SerializeToString),
        "GPUStatus": grpc.unary_unary_rpc_method_handler(
            _status_handler(service),
            request_deserializer=pb.GPUStatusRequest.FromString,
            response_serializer=pb.GPUStatusResponse.SerializeToString),
        "GPUNodeStatus": grpc.unary_unary_rpc_method_handler(
            _node_status_handler(service),
            request_deserializer=pb.GPUNodeStatusRequest.FromString,
            response_serializer=pb.GPUNodeStatusResponse.SerializeToString),
    })
    server.add_generic_rpc_handlers((handler,))
    if tls is not None:
        bound = server.add_secure_port(f"{address}:{port}",
                                       tls.server_credentials())
    else:
        bound = server.add_insecure_port(f"{address}:{port}")
    return server, bound


class WorkerClient:
    """Typed client for the worker RPCs (used by the master and tests).
    ``request_id`` (settable per call) rides gRPC metadata as x-request-id
    for cross-binary log correlation."""

    def __init__(self, target: str, timeout_s: float = 180.0,
                 tls: TlsConfig | None = None):
        self.target = target
        self.timeout_s = timeout_s
        if tls is not None:
            self._channel = grpc.secure_channel(
                target, tls.channel_credentials(),
                options=tls.channel_options())
        else:
            self._channel = grpc.insecure_channel(target)
        self._add = self._channel.unary_unary(
            f"/{SERVICE_NAME}/AddGPU",
            request_serializer=pb.AddGPURequest.SerializeToString,
            response_deserializer=pb.AddGPUResponse.FromString)
        self._remove = self._channel.unary_unary(
            f"/{SERVICE_NAME}/RemoveGPU",
            request_serializer=pb.RemoveGPURequest.SerializeToString,
            response_deserializer=pb.RemoveGPUResponse.FromString)
        self._status = self._channel.unary_unary(
            f"/{SERVICE_NAME}/GPUStatus",
            request_serializer=pb.GPUStatusRequest.SerializeToString,
            response_deserializer=pb.GPUStatusResponse.FromString)
        self._node_status = self._channel.unary_unary(
            f"/{SERVICE_NAME}/GPUNodeStatus",
            request_serializer=pb.GPUNodeStatusRequest.SerializeToString,
            response_deserializer=pb.GPUNodeStatusResponse.FromString)

    @staticmethod
    def _metadata(request_id: str | None, cause: str = ""):
        meta = []
        if request_id:
            meta.append(("x-request-id", request_id))
        if cause:
            meta.append((consts.DETACH_CAUSE_METADATA_KEY, cause))
        return tuple(meta) or None

    def add_gpu(self, pod_name: str, namespace: str, gpu_num: int,
                is_entire_mount: bool = False,
                request_id: str | None = None,
                txn_id: str = "") -> pb.AddGPUResponse:
        return self._add(
            pb.AddGPURequest(pod_name=pod_name, namespace=namespace,
                             gpu_num=gpu_num,
                             is_entire_mount=is_entire_mount,
                             txn_id=txn_id),
            timeout=self.timeout_s, metadata=self._metadata(request_id))

    def remove_gpu(self, pod_name: str, namespace: str,
                   uuids: list[str] = (), force: bool = False,
                   request_id: str | None = None,
                   txn_id: str = "",
                   cause: str = "") -> pb.RemoveGPUResponse:
        return self._remove(
            pb.RemoveGPURequest(pod_name=pod_name, namespace=namespace,
                                uuids=list(uuids), force=force,
                                txn_id=txn_id),
            timeout=self.timeout_s,
            metadata=self._metadata(request_id, cause))

    def gpu_status(self, pod_name: str, namespace: str,
                   request_id: str | None = None) -> pb.GPUStatusResponse:
        return self._status(
            pb.GPUStatusRequest(pod_name=pod_name, namespace=namespace),
            timeout=self.timeout_s, metadata=self._metadata(request_id))

    def node_status(self, request_id: str | None = None
                    ) -> pb.GPUNodeStatusResponse:
        return self._node_status(
            pb.GPUNodeStatusRequest(),
            timeout=self.timeout_s, metadata=self._metadata(request_id))

    def close(self) -> None:
        self._channel.close()

    def __enter__(self) -> "WorkerClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
