"""Master REST gateway (the port of :mod:`gpumounter_tpu.master.gateway`).

Ref ``cmd/GPUMounter-master/main.go``: HTTP server on :8080 (:235-238) with
the reference's own routes (:233-234)

    GET  /addgpu/namespace/:ns/pod/:pod/gpu/:n/isEntireMount/:bool
    POST /removegpu/namespace/:ns/pod/:pod/force/:bool   (form/JSON: uuids)

Booleans accept what Go's ``strconv.ParseBool`` did (main.go:38,140).
Resolve the Pod's node via the apiserver (:52-66), find that node's worker
(:248-268, here TTL cached), dial its gRPC (:82-96), translate result enums
to HTTP (:103-116, :206-224). Responses are JSON (the reference returned
bare strings).

Status mapping: Success→200; PodNotFound/GPUNotFound→404;
InsufficientGPU→503; GPUBusy→409 (busy_pids in the body); mount-policy
violations (gRPC FAILED_PRECONDITION)→412; worker unreachable/internal→502.

Attach requests additionally pass through the attach broker
(master/admission.py): tenant quota admission (over-quota → 429
QuotaExceeded + Retry-After), optional contention queueing with
priority/preemption, and attachment leases (``POST /renew``,
``GET /brokerz``) — all default-off, see docs/guide/Multitenancy.md. A
known route hit with the wrong HTTP method answers 405 + Allow.

Multi-host slices (master/slice.py, master/slicetxn.py) ride five more
routes: ``POST /addgpuslice`` and ``/removegpuslice`` (body
``{"pods": [{"namespace", "pod"}, ...], "gpusPerHost": N}``), ``POST
/slice/resize``, ``GET/POST /slice/barrier`` (the re-federation barrier)
and ``GET /slicez``.

With the HA plane on (``HAConfig``: shards, election, intent store) each
replica admits only the shards it leads; a request for a foreign shard is
proxied to the leader (or redirected with 307 + ``Location``, or shed with
503 + ``Retry-After`` while the shard is leaderless).

With node health on (the default; ``TPU_NODE_HEALTH=0`` removes it) the
fleet tick feeds a ``NodeHealthTracker`` (master/nodehealth.py): a
suspect, draining or dead node answers ``/addgpu`` with 503
``NodeCordoned``, a dead node's leases are fenced and its slice groups
repaired onto spare pods, and a draining node's slice members migrate.

With the topology plane on (the default; ``TPU_TOPOLOGY=0`` removes it)
the fleet tick scrapes each worker's ``/topoz`` into ``FleetTopology``
(master/topology.py): ``GET /topoz`` and the ``/fleetz`` ``topology`` and
``global_tenants`` sections serve its fragmentation score, defrag
candidates and cross-shard tenant rollup. The defragmenter
(master/defrag.py, ``TPU_DEFRAG_MODE``: ``plan`` by default, ``act``,
``0``) plans over those candidates and, in ``act`` mode, moves an idle
slice member through ``SliceTxnManager.migrate_member``.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
import urllib.parse
import urllib.request
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import grpc

import gpumounter_tpu_torch
from gpumounter_tpu_torch.k8s import objects
from gpumounter_tpu_torch.k8s.client import KubeClient
from gpumounter_tpu_torch.master.admission import AttachBroker
from gpumounter_tpu_torch.master.discovery import (WorkerDirectory,
                                                   WorkerNotFoundError)
from gpumounter_tpu_torch.master.election import NullElection, ShardElection
from gpumounter_tpu_torch.master.fleet import FleetAggregator
from gpumounter_tpu_torch.master.shardring import HAConfig, ShardRing
from gpumounter_tpu_torch.master.slice import DETACH_DONE, SliceCoordinator
from gpumounter_tpu_torch.master.slicetxn import SliceTxnManager
from gpumounter_tpu_torch.master.store import IntentStore
from gpumounter_tpu_torch.utils import consts
from gpumounter_tpu_torch.utils.events import EVENTS
from gpumounter_tpu_torch.utils.errors import (CircuitOpenError, K8sApiError,
                                               PodNotFoundError,
                                               QueueFullError,
                                               QuotaExceededError,
                                               TopologyError)
from gpumounter_tpu_torch.utils.log import get_logger
from gpumounter_tpu_torch.utils.metrics import REGISTRY
from gpumounter_tpu_torch.utils.retry import CircuitBreaker, RetryPolicy
from gpumounter_tpu_torch.utils.trace import STORE, Trace, annotate, span
from gpumounter_tpu_torch.worker.grpc_server import WorkerClient

logger = get_logger("master.gateway")

# The reference's exact route shapes (cmd/GPUMounter-master/main.go:233-234),
# so GPUMounter users' scripts work unchanged against this master. Booleans
# accept everything Go's strconv.ParseBool did (main.go:38,140):
# 1/0/t/f/T/F/true/false/True/False/TRUE/FALSE.
_ADD_GPU_RE = re.compile(
    r"^/addgpu/namespace/(?P<ns>[^/]+)/pod/(?P<pod>[^/]+)"
    r"/gpu/(?P<num>\d+)/isEntireMount/(?P<entire>[^/]+)$")
_REMOVE_GPU_RE = re.compile(
    r"^/removegpu/namespace/(?P<ns>[^/]+)/pod/(?P<pod>[^/]+)"
    r"/force/(?P<force>[^/]+)$")
_STATUS_RE = re.compile(
    r"^/gpustatus/namespace/(?P<ns>[^/]+)/pod/(?P<pod>[^/]+)$")
_NODE_STATUS_RE = re.compile(r"^/nodestatus/node/(?P<node>[^/]+)$")
_RENEW_RE = re.compile(
    r"^/renew/namespace/(?P<ns>[^/]+)/pod/(?P<pod>[^/]+)$")

_PARSEBOOL = {"1": True, "t": True, "T": True,
              "true": True, "True": True, "TRUE": True,
              "0": False, "f": False, "F": False,
              "false": False, "False": False, "FALSE": False}


def _parse_bool(token: str) -> bool | None:
    """Exactly strconv.ParseBool's accepted set; None = unparseable."""
    return _PARSEBOOL.get(token)

# Client-supplied X-Request-Id must be usable as a k8s label value (slave
# pods are stamped with it for idempotent adoption, allocator.py:181-190):
# <=63 chars, alnum ends, [-_.A-Za-z0-9] middle.
_RID_RE = re.compile(r"^[A-Za-z0-9]([A-Za-z0-9_.-]{0,61}[A-Za-z0-9])?$")

_ADD_HTTP = {
    consts.AddResult.SUCCESS: 200,
    consts.AddResult.INSUFFICIENT_GPU: 503,
    consts.AddResult.POD_NOT_FOUND: 404,
}
_REMOVE_HTTP = {
    consts.RemoveResult.SUCCESS: 200,
    consts.RemoveResult.GPU_BUSY: 409,
    consts.RemoveResult.POD_NOT_FOUND: 404,
    consts.RemoveResult.GPU_NOT_FOUND: 404,
}
_GRPC_HTTP = {
    grpc.StatusCode.FAILED_PRECONDITION: 412,
    grpc.StatusCode.INTERNAL: 502,
    grpc.StatusCode.UNAVAILABLE: 502,
    grpc.StatusCode.DEADLINE_EXCEEDED: 504,
    # The worker is alive but saturated — a retryable-by-the-client
    # condition, so 429 + Retry-After, not a generic 500.
    grpc.StatusCode.RESOURCE_EXHAUSTED: 429,
}
# Default client backoff hint when the worker said RESOURCE_EXHAUSTED
# without its own timing.
_RESOURCE_EXHAUSTED_RETRY_AFTER_S = 1.0

# Route labels for tpumounter_gateway_request_seconds{route} and for the
# op field of master request traces. Fixed vocabulary — the histogram's
# label cardinality must not scale with attacker-chosen paths.
_ROUTE_LABELS = (
    ("addgpu", lambda p: _ADD_GPU_RE.match(p)),
    ("removegpu", lambda p: _REMOVE_GPU_RE.match(p)),
    ("gpustatus", lambda p: _STATUS_RE.match(p)),
    ("nodestatus", lambda p: _NODE_STATUS_RE.match(p)),
    ("renew", lambda p: _RENEW_RE.match(p)),
)
_PLAIN_ROUTES = {"/healthz": "healthz", "/version": "version",
                 "/tracez": "tracez", "/brokerz": "brokerz",
                 "/eventz": "eventz", "/fleetz": "fleetz",
                 "/addgpuslice": "addgpuslice",
                 "/removegpuslice": "removegpuslice",
                 "/slice/resize": "sliceresize",
                 "/slice/barrier": "slicebarrier",
                 "/slicez": "slicez",
                 "/topoz": "topoz"}
# Pure introspection requests (and renew heartbeats) would drown the
# mount traces in the ring buffer; they are measured (histogram) but not
# stored.
_UNTRACED_ROUTES = {"healthz", "version", "tracez", "brokerz", "eventz",
                    "fleetz", "renew", "slicez", "slicebarrier",
                    "topoz", "unknown"}


def _route_label(path: str) -> str:
    p = urllib.parse.urlparse(path).path
    for label, match in _ROUTE_LABELS:
        if match(p):
            return label
    return _PLAIN_ROUTES.get(p, "unknown")


class MasterGateway:
    """Route handling decoupled from the HTTP server so it is unit-testable;
    ``serve()`` wraps it in a ThreadingHTTPServer."""

    def __init__(self, kube: KubeClient, directory: WorkerDirectory,
                 worker_client_factory=WorkerClient,
                 worker_tracez_base=None, broker: AttachBroker | None = None,
                 ha: HAConfig | None = None):
        self.kube = kube
        self.directory = directory
        self._worker_client_factory = worker_client_factory
        # Attach broker (master/admission.py): tenant-quota admission,
        # contention queue + preemption, attachment leases. The default
        # BrokerConfig is a no-op policy (no quotas, no queue, eternal
        # leases) — exactly the pre-broker behavior. Preemption / lease
        # expiry detaches come back through _broker_detach so they ride
        # the normal traced, breaker-guarded worker path.
        self.broker = broker or AttachBroker(kube)
        self.broker.bind(self._broker_detach)
        # HA plane (docs/guide/HA.md): namespace hash-ring sharding of
        # admission, per-shard leader election, declarative intent store.
        # The default HAConfig is the single-master semantics — one
        # shard, no election, no store, zero ConfigMap traffic.
        self.ha = ha or HAConfig()
        self.ring: ShardRing | None = None
        self.election = None
        if self.ha.enabled:
            self.ring = ShardRing(self.ha.shards)
            if self.ha.election:
                self.election = ShardElection(
                    kube, self.ha,
                    on_acquire=self.broker.on_shard_acquired,
                    on_lose=self.broker.on_shard_lost)
            else:
                self.election = NullElection(self.ha.shards)
            store = (IntentStore(kube, self.ring, self.ha.namespace,
                                 election=self.election,
                                 group_commit_delay_s=self.ha.
                                 group_commit_delay_s)
                     if self.ha.store else None)
            self.broker.bind_ha(store, self.ring, self.election)
            self.broker.bind_attempt_factory(self._adopted_attempt)
        # Elastic slice subsystem (master/slicetxn.py): slice
        # transactions, gang admission, slice-group leases, /slice/resize
        # and the re-federation barrier. With the defaults (no queue
        # timeout, no lease TTL) it is the plain all-or-nothing fan-out
        # with rollback.
        self.slices = SliceTxnManager(self)
        self.broker.bind_slice(self.slices)
        # Telemetry plane: the SLO engine computes per-tenant burn rates
        # from this process's registry; the fleet aggregator scrapes every
        # worker's health port into the /fleetz cluster view and ticks the
        # engine. serve() starts the loop; unit tests drive tick().
        from gpumounter_tpu_torch.utils.slo import SloEngine
        self.slo = SloEngine()
        # Node failure domain (master/nodehealth.py): per-node
        # healthy → suspect → dead from fleet scrape staleness + k8s
        # Node conditions/taints. suspect/draining cordon the node from
        # NEW grants; dead fences its leases (one-way eviction through
        # broker.fence_lease) and triggers slice self-healing.
        # TPU_NODE_HEALTH=0 removes the tracker entirely — no /fleetz
        # section, no series, no fencing. The topology plane and the
        # defragmenter bind the tracker's cordon as node_excluded_fn.
        from gpumounter_tpu_torch.master import nodehealth
        self.nodehealth = None
        if nodehealth.enabled():
            def _env_int(name, default):
                try:
                    return int(os.environ.get(name, default))
                except ValueError:
                    return default
            self.nodehealth = nodehealth.NodeHealthTracker(
                kube,
                on_dead=self._on_node_dead,
                on_drain=self._on_node_drain,
                suspect_after_ticks=_env_int(
                    consts.ENV_NODE_SUSPECT_TICKS,
                    consts.DEFAULT_NODE_SUSPECT_TICKS),
                dead_after_ticks=_env_int(
                    consts.ENV_NODE_DEAD_TICKS,
                    consts.DEFAULT_NODE_DEAD_TICKS))
            self.broker.bind_node_health(self.nodehealth.state)
            self.slices.bind_repair_candidates(self._repair_candidates)
        try:
            fleet_interval = float(os.environ.get(
                consts.ENV_FLEET_INTERVAL_S, "5"))
        except ValueError:
            fleet_interval = 5.0
        if fleet_interval <= 0:
            # wait(0) never blocks: the loop would busy-spin a core and
            # hammer every worker's health port with no pacing
            logger.warning("%s=%r is not a valid scrape interval; "
                           "using 1s", consts.ENV_FLEET_INTERVAL_S,
                           fleet_interval)
            fleet_interval = 1.0
        # Fleet topology & fragmentation plane (master/topology.py): the
        # fleet tick scrapes each worker's /topoz into this model and
        # scores it (fragmentation, stranded GPUs, contiguity, defrag
        # candidates, the cross-shard tenant rollup). TPU_TOPOLOGY=0
        # removes the model entirely — no scrape, no /topoz route, no
        # /fleetz sections, no series.
        from gpumounter_tpu_torch.master import topology as fleettopo
        self.topology = None
        if fleettopo.enabled():
            self.topology = fleettopo.FleetTopology(
                leases_fn=self.broker.leases.leases,
                groups_fn=self.broker.leases.groups,
                local_usage_fn=self.broker.leases.usage,
                peers_fn=self._topology_peers,
                replica=self.ha.replica,
                # cordoned/draining/suspect nodes are no migration
                # source: the candidate report prunes them each tick
                node_excluded_fn=(self.nodehealth.cordoned
                                  if self.nodehealth is not None
                                  else None))
        self.fleet = FleetAggregator(
            targets_fn=self._fleet_targets,
            usage_fn=self.broker.leases.usage,
            slo=self.slo,
            tick_interval_s=fleet_interval,
            ha_fn=self._ha_view,
            # joins scraped chip utilization to the tenant holding the
            # grant (/fleetz per-tenant utilization + idle-lease list)
            lease_lookup=self.broker.leases.get,
            node_health=self.nodehealth,
            topology=self.topology)
        # ...and the reverse direction: the broker tick reads the
        # fleet's observed per-lease activity to mark leases idle past
        # TPU_IDLE_LEASE_S (reclaim signal + preemption preference).
        self.broker.bind_utilization(self.fleet.lease_activity)
        # Fleet defragmenter (master/defrag.py): the optimizer tick over
        # the topology plane's candidate report — "plan" (the default)
        # journals and reports, "act" moves idle slice members through
        # the repair seam, "0" removes it. Needs the topology plane.
        from gpumounter_tpu_torch.master import defrag as defrag_mod
        self.defrag = None
        if self.topology is not None and defrag_mod.enabled():
            def _env_num(name, default, cast):
                try:
                    return cast(os.environ.get(name, default))
                except ValueError:
                    return cast(default)
            self.defrag = defrag_mod.DefragActuator(
                slices=self.slices,
                view_fn=self.topology.snapshot,
                activity_fn=self.fleet.lease_activity,
                node_excluded_fn=(self.nodehealth.cordoned
                                  if self.nodehealth is not None
                                  else None),
                store=self.broker.store,
                mode=defrag_mod.mode(),
                hysteresis_ticks=_env_num(
                    consts.ENV_DEFRAG_HYSTERESIS_TICKS,
                    consts.DEFAULT_DEFRAG_HYSTERESIS_TICKS, int),
                idle_duty_max=_env_num(
                    consts.ENV_DEFRAG_IDLE_DUTY_MAX,
                    consts.DEFAULT_DEFRAG_IDLE_DUTY_MAX, float),
                max_inflight=_env_num(
                    consts.ENV_DEFRAG_MAX_INFLIGHT,
                    consts.DEFAULT_DEFRAG_MAX_INFLIGHT, int),
                budget=_env_num(consts.ENV_DEFRAG_BUDGET,
                                consts.DEFAULT_DEFRAG_BUDGET, int),
                tick_interval_s=fleet_interval)
            self.fleet.bind_defrag(self.defrag)
            self.broker.bind_defrag(self.defrag)
        # gRPC target "ip:port" -> base URL of that worker's health/tracez
        # HTTP endpoint. The default follows the worker's fixed convention
        # (health on grpc_port + 1, worker/main.py HEALTH_PORT_OFFSET);
        # test stacks with ephemeral ports inject their own resolver.
        self.worker_tracez_base = (worker_tracez_base
                                   or self._default_tracez_base)
        # Per-target client POOL: gRPC channels are long-lived by design
        # (re-dialing per request would put TCP+HTTP/2 setup on the
        # latency-benchmarked hot path), and a single channel serialises
        # its HTTP/2 flow control under hundreds of concurrent RPCs — a
        # small round-robined pool per worker keeps the multiplexed front
        # from funnelling every in-flight attach through one stream head.
        self.channels_per_worker = max(1, int(os.environ.get(
            consts.ENV_GATEWAY_WORKER_CHANNELS, "4")))
        self._clients: dict[str, list[WorkerClient]] = {}
        self._clients_rr: dict[str, int] = {}
        self._clients_lock = threading.Lock()
        # Per-worker circuit breakers: a dead node fails fast (429 +
        # Retry-After) instead of eating a gateway thread per request for
        # the full dial timeout — one dead worker cannot starve the pool.
        # UNAVAILABLE retries are safe because the worker's per-request-id
        # fencing makes AddGPU idempotent (worker/service.py).
        self._breakers: dict[str, CircuitBreaker] = {}
        self._breakers_lock = threading.Lock()
        self.breaker_failure_threshold = 5
        self.breaker_reset_timeout_s = 15.0
        self.rpc_retry_policy = RetryPolicy(max_attempts=3,
                                            base_delay_s=0.05,
                                            max_delay_s=1.0,
                                            deadline_s=60.0)

    # -- node failure domain callbacks (master/nodehealth.py) ------------------

    def _on_node_dead(self, node: str) -> None:
        """Fleet-tick callback: the tracker judged ``node`` dead. Its
        single leases are fenced (one-way, through the broker's seam),
        its slice groups self-heal, and the worker directory arms its
        negative cache so dead-node dials stop costing a timeout each.
        The fencing itself (apiserver LIST+DELETE per lease) runs on
        its OWN thread — a populous node dying against a degraded
        apiserver must not freeze the fleet scrape loop; the broker
        tick re-notifies dead nodes, so a thread dying mid-way
        converges."""
        logger.warning("node %s judged DEAD: fencing its leases, "
                       "repairing its slices", node)
        self.directory.invalidate(node)
        threading.Thread(
            target=lambda: self.broker.handle_node_down(
                node, dead=True, reason="node-dead"),
            daemon=True, name=f"tpumounter-node-dead-{node}").start()

    def _on_node_drain(self, node: str) -> None:
        """The node announced a drain (worker healthz) or carries a
        termination taint: proactively migrate slice groups off it
        while its worker still answers; single leases detach through
        their owners' own paths (the drain finishes them)."""
        logger.info("node %s draining: migrating its slice groups",
                    node)
        threading.Thread(
            target=lambda: self.broker.handle_node_down(
                node, dead=False, reason="node-draining"),
            daemon=True, name=f"tpumounter-node-drain-{node}").start()

    def _repair_candidates(self, namespace: str, count: int,
                           exclude) -> list[tuple[str, str]]:
        """Spare pods slice self-healing may grow onto: Running pods
        labelled ``tpumounter.io/slice-spare=true`` in the group's
        namespace, on nodes the health tracker has not cordoned."""
        selector = (f"{consts.SLICE_SPARE_LABEL_KEY}="
                    f"{consts.SLICE_SPARE_LABEL_VALUE}")
        try:
            pods = self.kube.list_pods(namespace,
                                       label_selector=selector)
        except K8sApiError as e:
            logger.warning("spare discovery in %s failed: %s", namespace,
                           e)
            return []
        out: list[tuple[str, str]] = []
        for pod in sorted(pods, key=objects.name):
            key = (objects.namespace(pod), objects.name(pod))
            node = objects.node_name(pod)
            if key in exclude or not objects.is_running(pod) or not node:
                continue
            if self.nodehealth is not None \
                    and self.nodehealth.cordoned(node):
                continue
            out.append(key)
            if len(out) >= count:
                break
        return out

    def _fleet_targets(self) -> dict[str, str]:
        """{node: worker health base URL} for the fleet aggregator —
        the directory's gRPC targets mapped through the same health-port
        convention the /tracez stitch uses."""
        out = {}
        for node, target in self.directory.targets().items():
            base = self.worker_tracez_base(target)
            if base:
                out[node] = base
        return out

    @staticmethod
    def _default_tracez_base(target: str) -> str | None:
        host, _, port = target.rpartition(":")
        if not host or not port.isdigit():
            return None
        return f"http://{host}:{int(port) + 1}"

    def _client(self, target: str) -> WorkerClient:
        with self._clients_lock:
            pool = self._clients.get(target)
            if pool is None:
                pool = self._clients[target] = [
                    self._worker_client_factory(target)
                    for _ in range(self.channels_per_worker)]
                self._clients_rr[target] = 0
            index = self._clients_rr[target]
            self._clients_rr[target] = (index + 1) % len(pool)
            return pool[index]

    def _breaker(self, target: str) -> CircuitBreaker:
        with self._breakers_lock:
            breaker = self._breakers.get(target)
            if breaker is None:
                breaker = self._breakers[target] = CircuitBreaker(
                    target,
                    failure_threshold=self.breaker_failure_threshold,
                    reset_timeout_s=self.breaker_reset_timeout_s)
            return breaker

    def _drop_client(self, target: str) -> None:
        with self._clients_lock:
            pool = self._clients.pop(target, None) or []
            self._clients_rr.pop(target, None)
        for client in pool:
            try:
                client.close()
            except (grpc.RpcError, ValueError, OSError) as e:
                # a channel that fails to close is an annoyance, not an
                # outage — but only expected teardown kinds are swallowed;
                # a genuine bug (TypeError, AttributeError) must surface,
                # not masquerade as a resolve miss
                logger.warning("closing worker channel %s failed: %s",
                               target, e)

    # -- request handling ------------------------------------------------------

    def handle(self, method: str, path: str, body: bytes = b"",
               headers=None) -> tuple[int, dict]:
        """Returns (http_status, json_payload). Every request gets an
        x-request-id, echoed in the payload and stamped onto worker gRPC
        metadata, so one mount flow greps across master+worker logs.

        Retry contract: a client MAY supply ``X-Request-Id``. Retrying a
        lost-response AddGPU with the same id reaches the worker's
        adoption machinery (allocator.py:147-207) and returns the same
        chip set instead of double-attaching. Ids must be valid k8s label
        values (they are stamped onto slave pods); anything else is 400.
        The reference's REST surface had no such contract
        (cmd/GPUMounter-master/main.go:233-234)."""
        rid = None
        ctx: dict = {}
        if headers is not None:
            get = getattr(headers, "get", None)
            if callable(get):
                rid = get("X-Request-Id") or get("x-request-id")
                ctx["tenant"] = (get(consts.TENANT_HEADER)
                                 or get(consts.TENANT_HEADER.lower()))
                ctx["priority"] = (get(consts.PRIORITY_HEADER)
                                   or get(consts.PRIORITY_HEADER.lower()))
                # one-hop forwarding guard (see _shard_gate): a request a
                # peer already forwarded is never forwarded again
                ctx["forwarded"] = bool(get("X-Tpu-Forwarded")
                                        or get("x-tpu-forwarded"))
        if rid:
            if not _RID_RE.match(rid):
                return 400, {
                    "result": "BadRequestId",
                    "message": "X-Request-Id must be a valid k8s label "
                               "value: <=63 chars, alphanumeric ends, "
                               "[-_.A-Za-z0-9] interior",
                    "request_id": rid[:63]}
        else:
            rid = uuid.uuid4().hex[:12]
        # Master-side request trace (route → resolve → dial → rpc): the
        # master half of every SLO-counted second was previously invisible
        # — only result counters moved here.
        route = _route_label(path)
        trace = Trace(route, rid) if route not in _UNTRACED_ROUTES else None
        t0 = time.monotonic()
        try:
            if trace is not None:
                with trace.activate():
                    status, payload = self._route(method, path, body, rid,
                                                  ctx)
            else:
                status, payload = self._route(method, path, body, rid, ctx)
        except QuotaExceededError as e:
            # admission denial: the tenant is at its cap — a client-side
            # retryable condition, so 429 + Retry-After, not a 5xx
            status, payload = 429, {
                "result": "QuotaExceeded",
                "message": str(e),
                "tenant": e.tenant,
                "retry_after_s": round(max(0.1, e.retry_after_s), 1)}
        except QueueFullError as e:
            status, payload = 429, {
                "result": "QueueFull",
                "message": str(e),
                "retry_after_s": round(max(0.1, e.retry_after_s), 1)}
        except PodNotFoundError as e:
            status, payload = 404, {"result": "PodNotFound",
                                    "message": str(e)}
        except WorkerNotFoundError as e:
            status, payload = 502, {"result": "WorkerNotFound",
                                    "message": str(e)}
        except K8sApiError as e:
            status, payload = 502, {"result": "ApiserverError",
                                    "message": str(e)}
        except CircuitOpenError as e:
            # the worker's breaker is open: tell the client exactly when a
            # retry has a chance instead of letting it hammer a dead node
            status, payload = 429, {
                "result": "WorkerCircuitOpen",
                "message": str(e),
                "retry_after_s": round(max(0.1, e.retry_after_s), 1)}
        except grpc.RpcError as e:
            code = e.code() if hasattr(e, "code") else None
            details = e.details() if hasattr(e, "details") else str(e)
            if code == grpc.StatusCode.UNAVAILABLE and (
                    details or "").startswith(
                        consts.DRAINING_DETAIL_PREFIX):
                # typed 503 Draining: the worker refused a NEW attach
                # because it is gracefully draining (worker/drain.py) —
                # a retryable-by-the-client condition with a clear
                # horizon, not a 502 transport failure
                status, payload = 503, {
                    "result": "Draining",
                    "message": details,
                    "retry_after_s": 15.0}
            else:
                status, payload = (_GRPC_HTTP.get(code, 502),
                                   {"result": str(code and code.name),
                                    "message": details})
            if code == grpc.StatusCode.RESOURCE_EXHAUSTED:
                payload["retry_after_s"] = _RESOURCE_EXHAUSTED_RETRY_AFTER_S
        except ValueError as e:
            # e.g. a version-skewed worker returning a result enum value we
            # don't know — answer with JSON instead of dropping the socket
            status, payload = 502, {"result": "UnknownWorkerResult",
                                    "message": str(e)}
        # rid exemplar on the route histogram: a bad bucket links straight
        # to its /tracez entry (introspection routes carry no trace)
        REGISTRY.gateway_requests.observe(
            time.monotonic() - t0, route=route,
            exemplar={"rid": rid} if trace is not None else None)
        if trace is not None:
            trace.root.attrs.update(route=route, status=status)
            trace.finish(str(payload.get("result", status)))
            if status >= 500:
                # 5xx on a mount route is a lifecycle-visible failure the
                # result counters alone can't correlate: log it into the
                # event stream with the rid and the typed result
                EVENTS.emit("request_error", rid=rid, route=route,
                            status=status,
                            result=str(payload.get("result", "")))
        # error paths especially need the id — they're what gets debugged
        payload.setdefault("request_id", rid)
        return status, payload

    @staticmethod
    def _method_not_allowed(allow: str, method: str,
                            path: str) -> tuple[int, dict]:
        """A KNOWN route hit with the wrong HTTP method is a 405 with an
        Allow header (serve() lifts ``allow`` into the header), not the
        404 NoSuchRoute it used to fall through to — the difference
        between "you typo'd the path" and "use POST"."""
        return 405, {"result": "MethodNotAllowed",
                     "message": f"{method} not allowed on {path}",
                     "allow": allow}

    def _route(self, method: str, path: str, body: bytes,
               rid: str = "-", ctx: dict | None = None) -> tuple[int, dict]:
        parsed = urllib.parse.urlparse(path)
        p = parsed.path
        query = urllib.parse.parse_qs(parsed.query)
        if p == "/healthz":
            if method != "GET":
                return self._method_not_allowed("GET", method, p)
            return 200, {"status": "ok"}
        if p == "/version":
            return (200, {"version": gpumounter_tpu_torch.__version__}) \
                if method == "GET" \
                else self._method_not_allowed("GET", method, p)
        match = _ADD_GPU_RE.match(p)
        if match:
            if method != "GET":
                return self._method_not_allowed("GET", method, p)
            entire = _parse_bool(match["entire"])
            if entire is None:
                return 400, {"result": "BadRequest",
                             "message": f"bad isEntireMount value "
                                        f"{match['entire']!r}"}
            gate = self._shard_gate(match["ns"], method, path, body, rid,
                                    ctx)
            if gate is not None:
                return gate
            return self._add(match["ns"], match["pod"], int(match["num"]),
                             entire, rid, query, ctx)
        match = _REMOVE_GPU_RE.match(p)
        if match:
            if method != "POST":
                return self._method_not_allowed("POST", method, p)
            force = _parse_bool(match["force"])
            if force is None:
                return 400, {"result": "BadRequest",
                             "message": f"bad force value "
                                        f"{match['force']!r}"}
            gate = self._shard_gate(match["ns"], method, path, body, rid,
                                    ctx)
            if gate is not None:
                return gate
            uuids = _parse_uuids(body, parsed.query)
            return self._remove(match["ns"], match["pod"], uuids,
                                force, rid)
        match = _STATUS_RE.match(p)
        if match:
            if method != "GET":
                return self._method_not_allowed("GET", method, p)
            return self._status(match["ns"], match["pod"], rid)
        match = _NODE_STATUS_RE.match(p)
        if match:
            if method != "GET":
                return self._method_not_allowed("GET", method, p)
            return self._node_status(match["node"], rid)
        match = _RENEW_RE.match(p)
        if match:
            if method != "POST":
                return self._method_not_allowed("POST", method, p)
            gate = self._shard_gate(match["ns"], method, path, body, rid,
                                    ctx)
            if gate is not None:
                return gate
            return self._renew(match["ns"], match["pod"], query)
        if p == "/addgpuslice":
            if method != "POST":
                return self._method_not_allowed("POST", method, p)
            return self._slice_attach(body, rid, ctx)
        if p == "/removegpuslice":
            if method != "POST":
                return self._method_not_allowed("POST", method, p)
            return self._slice_detach(body, rid, ctx)
        if p == "/slice/resize":
            if method != "POST":
                return self._method_not_allowed("POST", method, p)
            return self._slice_resize(body, rid, ctx)
        if p == "/slice/barrier":
            if method == "GET":
                group = (query.get("group") or [""])[0]
                if not group:
                    return 400, {"result": "BadRequest",
                                 "message": "?group= is required"}
                # sharded deployments: a ?namespace= (BarrierClient
                # sends the member's) routes the poll to the shard
                # leader that owns the barrier, like every slice route
                namespace = (query.get("namespace") or [""])[0]
                if namespace:
                    gate = self._shard_gate(namespace, method, path,
                                            body, rid, ctx)
                    if gate is not None:
                        return gate
                return self.slices.barrier_status(group)
            if method != "POST":
                return self._method_not_allowed("GET, POST", method, p)
            return self._slice_barrier_join(body, rid, ctx)
        if p == "/slicez":
            if method != "GET":
                return self._method_not_allowed("GET", method, p)
            return 200, self.slices.snapshot()
        if p == "/tracez":
            if method != "GET":
                return self._method_not_allowed("GET", method, p)
            return self._tracez(query)
        if p == "/brokerz":
            if method != "GET":
                return self._method_not_allowed("GET", method, p)
            return 200, self.broker.snapshot()
        if p == "/eventz":
            if method != "GET":
                return self._method_not_allowed("GET", method, p)
            return 200, EVENTS.snapshot_from_query(query)
        if p == "/fleetz":
            if method != "GET":
                return self._method_not_allowed("GET", method, p)
            try:
                limit = int((query.get("limit") or [64])[0])
            except ValueError:
                limit = 64
            return 200, self.fleet.snapshot(
                events_limit=max(1, min(512, limit)))
        if p == "/topoz":
            if method != "GET":
                return self._method_not_allowed("GET", method, p)
            if self.topology is None:
                # TPU_TOPOLOGY=0: the route does not exist — the
                # pre-topology 404 payload
                return 404, {"result": "NoSuchRoute", "message": path}
            return 200, self.topology.snapshot()
        return 404, {"result": "NoSuchRoute", "message": path}

    # -- /tracez: trace introspection + master↔worker stitching ----------------

    def _tracez(self, params: dict[str, list[str]]) -> tuple[int, dict]:
        """Recent/slowest master traces; with ``rid=`` the master also
        fetches the worker's spans for the same request id (over the
        worker's health port) and grafts each worker trace under the
        master trace's ``rpc`` span — ONE combined tree per request, the
        cross-process view neither binary has alone."""
        rid = (params.get("rid") or [None])[0]
        result = (params.get("result") or [None])[0]
        try:
            limit = int((params.get("limit") or ["32"])[0])
        except ValueError:
            limit = 32
        if not rid:
            return 200, STORE.snapshot(result=result, limit=limit)
        # deep-copy: grafting must never mutate the store's own entries
        # (a second query would otherwise double-graft). Worker-op entries
        # are excluded from the top level — in a split deployment they
        # never appear in the master's store, and in a shared-process
        # stack they would list once raw and again grafted.
        traces = [json.loads(json.dumps(t)) for t in STORE.find(rid)
                  if (result is None or t["result"] == result)
                  and t["op"] not in self._WORKER_OPS]
        failed: dict[str, str] = {}
        worker_traces = self._fetch_worker_traces(traces, rid, failed)
        errors = [f"worker {t}: {m}" for t, m in failed.items()]
        for trace in traces:
            self._graft_worker_spans(trace, worker_traces, failed)
        payload: dict = {"rid": rid, "traces": traces,
                         "worker_traces": len(worker_traces)}
        if errors:
            payload["stitch_errors"] = errors
        return (200 if traces else 404), payload

    # worker ops whose traces belong under a master rpc span (a worker's
    # /tracez can also hold foreign entries when master and worker share a
    # process, as the in-process test stacks do)
    _WORKER_OPS = ("attach", "detach", "status", "node_status")

    def _fetch_worker_traces(self, traces: list[dict], rid: str,
                             failed: dict[str, str]) -> list[dict]:
        """GET /tracez?rid= from every worker the master traces name."""
        targets: list[str] = []
        for trace in traces:
            for rpc in _find_spans(trace.get("spans", {}), "rpc"):
                worker = (rpc.get("attrs") or {}).get("worker")
                if worker and worker not in targets:
                    targets.append(worker)
        fetched: list[dict] = []
        for target in targets:
            base = self.worker_tracez_base(target)
            if not base:
                continue
            url = (f"{base}/tracez?"
                   + urllib.parse.urlencode({"rid": rid}))
            try:
                with urllib.request.urlopen(url, timeout=5.0) as resp:
                    remote = json.loads(resp.read())
            except (urllib.error.URLError, OSError, ValueError) as e:
                # stitch is best-effort, but only expected network/parse
                # failures degrade silently — a coding bug must not
                # vanish into "worker spans incomplete"
                failed[target] = str(e)
                continue
            for entry in remote.get("recent", []):
                if entry.get("op") in self._WORKER_OPS \
                        and entry not in fetched:
                    entry.setdefault("process", "worker")
                    entry["worker"] = target
                    fetched.append(entry)
        return fetched

    def _graft_worker_spans(self, trace: dict,
                            worker_traces: list[dict],
                            failed: dict[str, str] | None = None) -> None:
        rpcs = _find_spans(trace.get("spans", {}), "rpc")
        if not rpcs:
            if worker_traces:
                trace["worker_spans"] = [w["spans"] for w in worker_traces]
            return
        for rpc in rpcs:
            rpc_worker = (rpc.get("attrs") or {}).get("worker")
            grafted_before = len(rpc.get("children") or [])
            for worker in worker_traces:
                # graft only under the rpc that actually talked to this
                # worker — a retried request has two rpc spans, a slice
                # has one per host, and misplacing spans would make the
                # waterfall lie about who did the work
                if rpc_worker and worker.get("worker") \
                        and worker["worker"] != rpc_worker:
                    continue
                child = dict(worker["spans"])
                child["name"] = f"worker:{worker['op']}"
                attrs = dict(child.get("attrs") or {})
                attrs.update(result=worker.get("result"),
                             worker=worker.get("worker"))
                child["attrs"] = attrs
                rpc.setdefault("children", []).append(child)
            if failed and len(rpc.get("children") or []) == grafted_before:
                # the worker half could not be fetched (health port down /
                # unreachable): degrade, don't error — the master half of
                # the tree still renders, annotated with the cause. The
                # cause must be THIS rpc's worker's failure: with one
                # worker down and another merely rotated out of its
                # bounded store, quoting the global error list would
                # point the operator at the wrong node's outage.
                if rpc_worker:
                    cause = failed.get(rpc_worker)
                else:
                    cause = "; ".join(f"worker {t}: {m}"
                                      for t, m in failed.items())
                if not cause:
                    continue
                cause = cause[:200]
                rpc.setdefault("children", []).append({
                    "name": "worker spans unavailable",
                    "start_unix": rpc.get("start_unix"),
                    "duration_ms": 0.0,
                    "attrs": {"cause": cause},
                })

    # -- multi-host slice transactions ------------------------------------------

    def _slice_coordinator(self) -> SliceCoordinator:
        return SliceCoordinator(self)

    @staticmethod
    def _parse_slice_body(body: bytes) -> tuple[list[tuple[str, str]], dict]:
        try:
            obj = json.loads(body.decode() or "{}")
        except json.JSONDecodeError as e:
            raise ValueError(f"bad JSON body: {e}") from e
        if not isinstance(obj, dict) or not isinstance(obj.get("pods"), list):
            raise ValueError(
                'body must be {"pods": [{"namespace": ..., "pod": ...}, '
                '...], ...}')
        pods = [(str(p.get("namespace", "default")), str(p["pod"]))
                for p in obj["pods"] if isinstance(p, dict) and p.get("pod")]
        if not pods:
            raise ValueError(
                'body must be {"pods": [{"namespace": ..., "pod": ...}, '
                '...], ...}')
        # A duplicated (namespace, pod) entry would fan out TWO attaches
        # to the same pod — double slave pods, a double-counted lease,
        # and a rollback that only targets one of them. Reject precisely
        # rather than silently dedupe: the caller's host list is wrong.
        seen: set[tuple[str, str]] = set()
        for entry in pods:
            if entry in seen:
                raise ValueError(
                    f"duplicate pod {entry[0]}/{entry[1]} in pods[]: "
                    "each slice member must be listed exactly once")
            seen.add(entry)
        return pods, obj

    @staticmethod
    def _parse_strict(obj: dict) -> bool:
        strict = obj.get("strict", False)
        if not isinstance(strict, bool):
            raise ValueError(f'"strict" must be a boolean, got {strict!r}')
        return strict

    def _slice_attach(self, body: bytes, rid: str = "-",
                      ctx: dict | None = None) -> tuple[int, dict]:
        try:
            pods, obj = self._parse_slice_body(body)
            gpus = obj.get("gpusPerHost", 4)
            if not isinstance(gpus, int) or isinstance(gpus, bool) \
                    or gpus < 1:
                raise ValueError(
                    f"gpusPerHost must be a positive integer, got {gpus!r}")
            strict = self._parse_strict(obj)
        except ValueError as e:
            return 400, {"result": "BadRequest", "message": str(e)}
        # Shard gate keyed on the FIRST pod's namespace (the slice's
        # admission home): under sharding a slice must not span
        # namespaces, or the foreign-namespace leases would land on a
        # shard this replica never persists, reaps, or survives a
        # restart with.
        gate = (self._slice_shard_guard(pods)
                or self._shard_gate(pods[0][0], "POST", "/addgpuslice",
                                    body, rid, ctx))
        if gate is not None:
            return gate
        # Tenant resolution for the WHOLE slice (body "tenant"/"priority",
        # falling back to header then the first pod's namespace). The
        # slice txn manager runs the reservation-scoped quota admission
        # for the aggregate GPU count (over-quota → 429 before any host
        # is touched), the transaction itself, and — with the queue
        # enabled — gang parking instead of failing fast.
        tenant = str(obj.get("tenant") or (ctx or {}).get("tenant")
                     or pods[0][0])
        priority = str(obj.get("priority") or (ctx or {}).get("priority")
                       or consts.DEFAULT_PRIORITY)
        if not _RID_RE.match(tenant):
            return 400, {"result": "BadRequest",
                         "message": f"bad tenant {tenant!r}"}
        if priority not in consts.PRIORITIES:
            return 400, {"result": "BadRequest",
                         "message": f"bad priority {priority!r}: want "
                                    f"{'|'.join(consts.PRIORITIES)}"}
        try:
            return self.slices.attach(pods, gpus, tenant=tenant,
                                      priority=priority, rid=rid,
                                      strict=strict)
        except TopologyError as e:
            # pre-fan-out rejection: no host was touched
            return 412, {"result": "TopologyMismatch",
                         "message": str(e)}

    def _slice_barrier_join(self, body: bytes, rid: str = "-",
                            ctx: dict | None = None) -> tuple[int, dict]:
        """``POST /slice/barrier`` — a slice member announces it has
        drained and torn down its old backend and is ready to federate
        at the named generation (torchcheck/federation.py; protocol in
        master/slicetxn.py barrier_join). Not an attach: no admission —
        the GPUs were granted when the generation's txn committed — but
        shard-gated like every slice route: a join landing on a
        non-leader replica would lazily arm a split-brain barrier."""
        try:
            obj = json.loads(body or b"{}")
            if not isinstance(obj, dict):
                raise ValueError("body must be a JSON object")
            group = obj.get("group")
            member = obj.get("member")
            generation = obj.get("generation")
            if not group or not isinstance(group, str):
                raise ValueError('"group" (string) is required')
            if not member or not isinstance(member, str) \
                    or "/" not in member:
                raise ValueError('"member" ("namespace/pod") is '
                                 "required")
            if not isinstance(generation, int) \
                    or isinstance(generation, bool):
                raise ValueError('"generation" (integer) is required')
            address = obj.get("address") or ""
            if not isinstance(address, str):
                raise ValueError('"address" must be a string')
        except ValueError as e:
            return 400, {"result": "BadRequest", "message": str(e)}
        gate = self._shard_gate(member.split("/", 1)[0], "POST",
                                "/slice/barrier", body, rid, ctx)
        if gate is not None:
            return gate
        return self.slices.barrier_join(group, generation, member,
                                        address)

    def _slice_resize(self, body: bytes, rid: str = "-",
                      ctx: dict | None = None) -> tuple[int, dict]:
        """``POST /slice/resize`` — reshape a live slice to the body's
        target membership: the grow half runs as a slice txn joining the
        existing group, the shrink half detaches through the normal
        path, and the mesh generation bumps only once the new device set
        is fully actuated."""
        try:
            pods, obj = self._parse_slice_body(body)
            gpus = obj.get("gpusPerHost")
            if gpus is not None and (not isinstance(gpus, int)
                                     or isinstance(gpus, bool)
                                     or gpus < 1):
                raise ValueError(
                    f"gpusPerHost must be a positive integer, got {gpus!r}")
            strict = self._parse_strict(obj)
        except ValueError as e:
            return 400, {"result": "BadRequest", "message": str(e)}
        gate = (self._slice_shard_guard(pods)
                or self._shard_gate(pods[0][0], "POST", "/slice/resize",
                                    body, rid, ctx))
        if gate is not None:
            return gate
        tenant = obj.get("tenant") or (ctx or {}).get("tenant")
        priority = obj.get("priority") or (ctx or {}).get("priority")
        if tenant is not None and not _RID_RE.match(str(tenant)):
            return 400, {"result": "BadRequest",
                         "message": f"bad tenant {tenant!r}"}
        if priority is not None and priority not in consts.PRIORITIES:
            return 400, {"result": "BadRequest",
                         "message": f"bad priority {priority!r}: want "
                                    f"{'|'.join(consts.PRIORITIES)}"}
        try:
            return self.slices.resize(
                pods, gpus, rid=rid,
                tenant=str(tenant) if tenant else None,
                priority=str(priority) if priority else None,
                group=(str(obj["group"]) if obj.get("group") else None),
                strict=strict, force=bool(obj.get("force", False)))
        except TopologyError as e:
            return 412, {"result": "TopologyMismatch", "message": str(e)}

    def _slice_detach(self, body: bytes, rid: str = "-",
                      ctx: dict | None = None) -> tuple[int, dict]:
        try:
            pods, obj = self._parse_slice_body(body)
        except ValueError as e:
            return 400, {"result": "BadRequest", "message": str(e)}
        gate = (self._slice_shard_guard(pods)
                or self._shard_gate(pods[0][0], "POST", "/removegpuslice",
                                    body, rid, ctx))
        if gate is not None:
            return gate
        force = bool(obj.get("force", False))
        ok, results = self._slice_coordinator().detach(pods, force,
                                                       request_id=rid)
        for r in results:
            if r.result in DETACH_DONE:
                self.broker.release(r.namespace, r.pod)
        return (200 if ok else 409), {
            "result": "SUCCESS" if ok else "SliceDetachIncomplete",
            "pods": [r.to_json() for r in results]}

    def _call_worker(self, namespace: str, pod_name: str, fn):
        """Resolve pod -> node -> worker and run ``fn(client)``. On
        UNAVAILABLE the cached worker IP is presumed dead (pod restarted):
        invalidate both caches and retry once against a fresh resolve."""
        with span("resolve", pod=f"{namespace}/{pod_name}"):
            pod = self.kube.get_pod(namespace, pod_name)  # ref main.go:52-66
            node = objects.node_name(pod)
            if not node:
                raise PodNotFoundError(namespace, pod_name)
            annotate(node=node)
        return self._call_node_worker(node, fn)

    def _call_node_worker(self, node: str, fn):
        """Resolve the node's worker and run ``fn(client)`` under the rpc
        retry policy + that worker's circuit breaker.

        UNAVAILABLE means the cached worker IP is presumed dead (pod
        restarted / connection blip): invalidate both caches and retry
        against a fresh resolve, with backoff, up to the policy's attempt
        budget — safe because the worker's per-request-id fencing makes
        the RPCs idempotent. Every UNAVAILABLE feeds the breaker; enough
        of them open it and subsequent requests fail fast with
        :class:`CircuitOpenError` (→ 429 + Retry-After) instead of eating
        a gateway thread each for the full dial timeout."""
        # Hand-rolled rather than call_with_retry: each attempt may
        # RE-RESOLVE to a different target (worker pod restarted with a
        # new IP), so the breaker is chosen per attempt — call_with_retry
        # binds one breaker for the whole call.
        policy = self.rpc_retry_policy
        deadline = time.monotonic() + policy.deadline_s
        attempt = 0
        while True:
            attempt += 1
            extra = {"retry": True} if attempt > 1 else {}
            with span("dial", node=node, **extra):
                target = self.directory.worker_target(node)
                client = self._client(target)
                annotate(worker=target)
            breaker = self._breaker(target)
            breaker.allow()              # CircuitOpenError → 429 upstream
            try:
                with span("rpc", node=node, worker=target, **extra):
                    result = fn(client)
            except grpc.RpcError as e:
                code = e.code() if hasattr(e, "code") else None
                if code == grpc.StatusCode.DEADLINE_EXCEEDED:
                    # a hung worker proves nothing about liveness and ate
                    # a gateway thread for the full deadline — that is a
                    # breaker FAILURE (enough of them must fail fast), but
                    # not worth re-waiting a whole deadline in-request
                    breaker.record_failure()
                    raise
                if code != grpc.StatusCode.UNAVAILABLE:
                    # the worker ANSWERED (policy denial, internal error,
                    # saturation): the channel is alive — that is breaker
                    # success even when the answer is a failure
                    breaker.record_success()
                    raise
                details = e.details() if hasattr(e, "details") else ""
                if (details or "").startswith(
                        consts.DRAINING_DETAIL_PREFIX):
                    # the worker is ALIVE and said so: it is draining
                    # (worker/drain.py). Not a transport fault — no
                    # breaker failure, no cache invalidation, and above
                    # all NO retry (every retry would get the same
                    # answer until the drain completes)
                    breaker.record_success()
                    raise
                breaker.record_failure()
                self._drop_client(target)
                self.directory.invalidate(node)
                delay = policy.delay_s(attempt)
                if attempt >= policy.max_attempts \
                        or time.monotonic() + delay >= deadline:
                    raise
                REGISTRY.retry_attempts.inc(target="worker_rpc")
                annotate(unavailable_retries=attempt)
                time.sleep(delay)
                continue
            except Exception:
                # non-gRPC failure AFTER a delivered response (e.g. a
                # version-skewed result enum): transport worked, and the
                # half-open probe slot must not leak — without this a
                # ValueError mid-probe would leave the breaker failing
                # fast forever
                breaker.record_success()
                raise
            breaker.record_success()
            return result

    # -- HA: shard gate + forwarding (master/shardring.py) ---------------------

    def _slice_shard_guard(self, pods) -> tuple[int, dict] | None:
        """Sharded admission is keyed on namespace: a slice spanning
        namespaces would record leases for shards this replica does not
        own — never persisted (the store skips foreign shards), never
        reaped (the tick skips them), and evicted by the next
        re-derivation. Reject it up front; single-master (election off)
        accepts multi-namespace slices unchanged."""
        if self.ring is None or self.election is None \
                or not self.election.enabled:
            return None
        namespaces = {ns for ns, _ in pods}
        if len(namespaces) > 1:
            return 400, {
                "result": "BadRequest",
                "message": f"slice pods span namespaces "
                           f"{sorted(namespaces)}: admission sharding "
                           "is keyed on namespace, so a slice must stay "
                           "in one"}
        return None

    def _shard_gate(self, namespace: str, method: str, path: str,
                    body: bytes, rid: str,
                    ctx: dict | None) -> tuple[int, dict] | None:
        """None = this replica owns the namespace's shard, handle
        locally. Otherwise the forwarded answer: proxied to the leader
        (default — clients stay dumb), a 307 + Location under
        ``TPU_SHARD_FORWARD=redirect``, or 503 + Retry-After when the
        shard is currently leaderless (failover in progress)."""
        if self.ring is None or self.election is None \
                or not self.election.enabled:
            return None
        shard = self.ring.shard_of(namespace)
        if self.election.is_leader(shard):
            return None
        retry_hint = round(max(self.ha.renew_interval_s, 1.0), 1)
        if (ctx or {}).get("forwarded"):
            # one-hop guard: a forwarded request landing on another
            # non-owner means the routing tables disagree mid-failover —
            # bounce to the client rather than ping-pong between peers
            REGISTRY.shard_forwards.inc(mode=self.ha.forward,
                                        outcome="loop")
            return 503, {
                "result": "ShardLeaderUnknown",
                "message": f"shard {shard} ownership is in flux "
                           "(failover in progress)",
                "retry_after_s": retry_hint}
        info = self.election.leaders().get(shard)
        url = (info or {}).get("url", "")
        if not info or info.get("expired") or not url \
                or info.get("holder") == self.ha.replica:
            REGISTRY.shard_forwards.inc(mode=self.ha.forward,
                                        outcome="no_leader")
            return 503, {
                "result": "ShardLeaderUnknown",
                "message": f"no live leader for shard {shard} yet",
                "retry_after_s": retry_hint}
        if self.ha.forward == "redirect":
            REGISTRY.shard_forwards.inc(mode="redirect", outcome="ok")
            return 307, {
                "result": "ShardRedirect",
                "location": url.rstrip("/") + path,
                "shard": shard,
                "leader": info.get("holder", "")}
        return self._proxy_to_leader(url, method, path, body, rid, ctx,
                                     shard)

    def _proxy_to_leader(self, base: str, method: str, path: str,
                         body: bytes, rid: str, ctx: dict | None,
                         shard: int) -> tuple[int, dict]:
        url = base.rstrip("/") + path
        req = urllib.request.Request(url, data=body or None,
                                     method=method)
        req.add_header("X-Request-Id", rid)
        req.add_header("X-Tpu-Forwarded", "1")
        for header, key in ((consts.TENANT_HEADER, "tenant"),
                            (consts.PRIORITY_HEADER, "priority")):
            value = (ctx or {}).get(key)
            if value:
                req.add_header(header, value)
        # a queued attach legitimately holds the upstream connection for
        # the whole queue deadline — the proxy must outwait it
        timeout = max(30.0, self.broker.config.queue_timeout_s + 30.0)
        try:
            try:
                with urllib.request.urlopen(req, timeout=timeout) as resp:
                    status, raw = resp.status, resp.read()
            except urllib.error.HTTPError as e:
                status, raw = e.code, e.read()
        except (urllib.error.URLError, OSError) as e:
            REGISTRY.shard_forwards.inc(mode="proxy", outcome="error")
            return 502, {"result": "ShardForwardFailed",
                         "message": f"shard {shard} leader at {base} "
                                    f"unreachable: {e}",
                         "retry_after_s": round(
                             max(self.ha.renew_interval_s, 1.0), 1)}
        try:
            payload = json.loads(raw or b"{}")
        except ValueError:
            payload = {"result": "ShardForwardBadPayload",
                       "message": raw.decode(errors="replace")[:200]}
        REGISTRY.shard_forwards.inc(mode="proxy", outcome="ok")
        if isinstance(payload, dict):
            payload.setdefault("forwarded_shard", shard)
        return status, payload

    def _worker_attach_attempt(self, namespace: str, pod_name: str,
                               chips: int, entire: bool, rid: str,
                               node: str, adopted: bool = False):
        """The one attach attempt_fn: the worker add_gpu RPC + result
        accounting + HTTP mapping, shared by the live route (`_add`) and
        adopted waiter re-runs so the two can never drift. Only invoked
        from inside broker.attach, so admission, queueing and lease
        recording all wrap it."""
        assert self.broker is not None

        def attempt() -> tuple[int, dict]:
            resp = self._call_node_worker(
                node, lambda w: w.add_gpu(pod_name, namespace, chips,
                                          entire, request_id=rid))
            result = consts.AddResult(resp.result)
            REGISTRY.attach_results.inc(result=f"master_{result.name}")
            payload = {
                "result": result.name,
                "device_ids": list(resp.device_ids),
                "device_paths": list(resp.device_paths),
            }
            if adopted:
                payload["adopted"] = True
            return _ADD_HTTP[result], payload

        return attempt

    def _adopted_attempt(self, namespace: str, pod_name: str, chips: int,
                         entire: bool, rid: str, node: str):
        """attempt_fn factory for a waiter rehydrated from the store:
        the exact worker RPC `_add` would have run, under the ORIGINAL
        request id (the worker's per-rid adoption makes the re-run
        idempotent). Bound via bind_attempt_factory in __init__."""
        return self._worker_attach_attempt(namespace, pod_name, chips,
                                           entire, rid, node,
                                           adopted=True)

    def _ha_view(self) -> dict:
        """This replica's HA posture for /fleetz: role per shard, peers
        as the lock records name them, store lag. Store-only (election
        off) still counts as enabled — a lagging store is exactly what a
        restart would lose."""
        if self.election is None:
            return {"enabled": False}
        enabled = bool(self.election.enabled
                       or self.broker.store is not None)
        view: dict = {"enabled": enabled,
                      "replica": self.ha.replica,
                      "shards": self.ha.shards,
                      "election": self.election.snapshot()}
        if self.broker.store is not None:
            view["store"] = self.broker.store.snapshot()
        return view

    def _topology_peers(self) -> dict:
        """Peer master shards for the global tenant rollup, straight from
        the election's lock records ({shard: {holder, url, fence,
        expired}}). No election = no peers = the rollup equals this
        shard's own usage."""
        if self.election is None:
            return {}
        try:
            return self.election.leaders()
        except Exception:    # noqa: BLE001 — rollup degrades, never dies
            logger.exception("peer leader listing failed")
            return {}

    def _add(self, namespace: str, pod_name: str, gpu_num: int,
             entire: bool, rid: str = "-", query: dict | None = None,
             ctx: dict | None = None) -> tuple[int, dict]:
        """Attach, admission-gated: tenant/priority resolve (query param >
        header > defaults), pod→node resolve, then the broker orchestrates
        quota check / queueing / preemption around the worker RPC."""
        query = query or {}
        tenant = ((query.get("tenant") or [None])[0]
                  or (ctx or {}).get("tenant") or namespace)
        priority = ((query.get("priority") or [None])[0]
                    or (ctx or {}).get("priority")
                    or consts.DEFAULT_PRIORITY)
        if not _RID_RE.match(tenant):
            return 400, {"result": "BadRequest",
                         "message": f"bad tenant {tenant!r}: must be a "
                                    "k8s-label-safe token"}
        if priority not in consts.PRIORITIES:
            return 400, {"result": "BadRequest",
                         "message": f"bad priority {priority!r}: want "
                                    f"{'|'.join(consts.PRIORITIES)}"}
        # Resolve before admission so the lease knows its node (the
        # preemption victim filter is node-scoped); same single GET the
        # old _call_worker path performed — budgets unchanged.
        with span("resolve", pod=f"{namespace}/{pod_name}"):
            pod = self.kube.get_pod(namespace, pod_name)  # ref main.go:52-66
            node = objects.node_name(pod)
            if not node:
                raise PodNotFoundError(namespace, pod_name)
            annotate(node=node, tenant=tenant)
        if self.nodehealth is not None and self.nodehealth.cordoned(node):
            # suspect/draining/dead cordons the node from NEW grants
            # only — live leases are untouched (suspect) or already
            # fenced (dead). The pod lives on that node, so there is
            # nowhere to re-place this attach: tell the client when to
            # come back instead of burning a dial timeout on it.
            state = self.nodehealth.state(node)
            REGISTRY.admission_decisions.inc(tenant=tenant,
                                             outcome="node_cordoned")
            EVENTS.emit("admit_denied", rid=rid, tenant=tenant,
                        chips=gpu_num, outcome="node_cordoned",
                        node=node, node_state=state)
            return 503, {
                "result": "NodeCordoned",
                "message": f"node {node} is {state}: new grants are "
                           "cordoned until it recovers",
                "node": node,
                "node_state": state,
                "retry_after_s": 15.0}
        return self.broker.attach(
            tenant=tenant, priority=priority, namespace=namespace,
            pod=pod_name, chips=gpu_num, node=node, rid=rid,
            attempt_fn=self._worker_attach_attempt(
                namespace, pod_name, gpu_num, entire, rid, node),
            entire=entire)

    def _remove(self, namespace: str, pod_name: str, uuids: list[str],
                force: bool, rid: str = "-") -> tuple[int, dict]:
        resp = self._call_worker(
            namespace, pod_name,
            lambda w: w.remove_gpu(pod_name, namespace, uuids, force,
                                   request_id=rid))
        result = consts.RemoveResult(resp.result)
        REGISTRY.detach_results.inc(result=f"master_{result.name}")
        if result == consts.RemoveResult.SUCCESS:
            # lease bookkeeping + wake the contention queue: freed chips
            # are what queued attaches are waiting for
            self.broker.release(namespace, pod_name, uuids or None)
        payload: dict = {"result": result.name}
        if resp.busy_pids:
            payload["busy_pids"] = list(resp.busy_pids)
        return _REMOVE_HTTP[result], payload

    def _renew(self, namespace: str, pod_name: str,
               query: dict | None = None) -> tuple[int, dict]:
        """``POST /renew/namespace/:ns/pod/:pod[?ttl=S]`` — push the
        lease's expiry out (default: the configured TPU_LEASE_TTL_S)."""
        ttl = None
        raw = ((query or {}).get("ttl") or [None])[0]
        if raw is not None:
            try:
                ttl = float(raw)
            except ValueError:
                ttl = -1.0
            if ttl < 0:
                return 400, {"result": "BadRequest",
                             "message": f"bad ttl {raw!r}: want seconds "
                                        ">= 0 (0 = never expire)"}
        try:
            lease = self.broker.renew(namespace, pod_name, ttl)
        except KeyError:
            return 404, {
                "result": "LeaseNotFound",
                "message": f"no attachment lease for "
                           f"{namespace}/{pod_name} (expired leases are "
                           "reaped and cannot be renewed)"}
        return 200, {"result": "SUCCESS", "lease": lease.to_json()}

    def _broker_detach(self, lease, cause: str, force: bool) -> str:
        """Detach on the broker's behalf (preemption / lease expiry)
        through the NORMAL worker path — traced, retried, breaker-guarded,
        journaled worker-side — with the cause stamped into gRPC metadata
        so the worker's audit event and journal say WHY. Returns the
        result name; transport failures return "ERROR" (the broker
        retries next tick)."""
        rid = f"broker-{uuid.uuid4().hex[:8]}"
        try:
            resp = self._call_worker(
                lease.namespace, lease.pod,
                lambda w: w.remove_gpu(lease.pod, lease.namespace, [],
                                       force, request_id=rid,
                                       cause=cause))
            result = consts.RemoveResult(resp.result).name
        except PodNotFoundError:
            result = "POD_NOT_FOUND"
        except (WorkerNotFoundError, K8sApiError, CircuitOpenError,
                grpc.RpcError, ValueError) as e:
            logger.warning("broker detach of %s/%s (%s) failed: %s",
                           lease.namespace, lease.pod, cause, e)
            result = "ERROR"
        REGISTRY.detach_results.inc(result=f"broker_{result}")
        logger.info("[rid=%s] broker detach %s/%s cause=%s -> %s", rid,
                    lease.namespace, lease.pod, cause, result)
        return result

    def _status(self, namespace: str, pod_name: str,
                rid: str = "-") -> tuple[int, dict]:
        resp = self._call_worker(
            namespace, pod_name,
            lambda w: w.gpu_status(pod_name, namespace, request_id=rid))
        return 200, {
            "mount_type": resp.mount_type,
            "gpus": [{
                "device_id": g.device_id,
                "device_path": g.device_path,
                "slave_pod": g.slave_pod,
                "busy_pids": list(g.busy_pids),
            } for g in resp.gpus],
        }

    def _node_status(self, node: str, rid: str = "-") -> tuple[int, dict]:
        try:
            resp = self._call_node_worker(
                node, lambda w: w.node_status(request_id=rid))
        except WorkerNotFoundError:
            # Distinguish a typo'd node (client error, 404) from a real
            # node whose worker is missing (genuine 502).
            try:
                self.kube.get_node(node)
            except K8sApiError as e:
                if e.status == 404:
                    return 404, {"result": "NodeNotFound",
                                 "message": f"node {node} does not exist"}
            raise
        gpus = [{
            "device_id": g.device_id,
            "device_path": g.device_path,
            "state": g.state,
            "pod_name": g.pod_name,
            "namespace": g.namespace,
            "accelerator": g.accelerator,
        } for g in resp.gpus]
        return 200, {
            "node": resp.node or node,
            "free": sum(1 for g in gpus if g["state"] == "FREE"),
            "total": len(gpus),
            "gpus": gpus,
        }

    # -- HTTP server -----------------------------------------------------------

    def serve(self, port: int = consts.MASTER_HTTP_PORT,
              address: str = "0.0.0.0", front: str | None = None,
              workers: int | None = None, max_conns: int | None = None):
        """Start the HTTP front. Default is the bounded multiplexed front
        (master/httpfront.py): HTTP/1.1 keep-alive, a selector loop
        owning idle connections, N worker threads multiplexing M >> N
        connections, and connection admission BEFORE thread allocation —
        the configuration the sustained-RPS bench pins at >= 500
        concurrent in-flight attach RPCs. ``TPU_GATEWAY_FRONT=threaded``
        reverts to the legacy thread-per-request ThreadingHTTPServer."""
        gateway = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def _respond(self):
                length = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(length) if length else b""
                if self.path == "/metrics":
                    # exemplars only under negotiated OpenMetrics — the
                    # classic text exposition would fail a real
                    # Prometheus scrape on the ` # {...}` suffix
                    openmetrics, ctype = REGISTRY.negotiate(
                        self.headers.get("Accept"))
                    payload = REGISTRY.render_text(
                        openmetrics=openmetrics).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", ctype)
                    self.send_header("Content-Length", str(len(payload)))
                    self.end_headers()
                    self.wfile.write(payload)
                    return
                status, obj = gateway.handle(self.command, self.path, body,
                                             headers=self.headers)
                payload = (json.dumps(obj) + "\n").encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                retry_after = obj.get("retry_after_s")
                if retry_after is not None:
                    # RFC 9110 Retry-After is whole seconds; round up so
                    # the client never comes back before the hint
                    self.send_header("Retry-After",
                                     str(max(1, int(-(-retry_after // 1)))))
                allow = obj.get("allow")
                if status == 405 and allow:
                    self.send_header("Allow", allow)
                location = obj.get("location")
                if location and status in (301, 302, 307, 308):
                    # shard redirect (TPU_SHARD_FORWARD=redirect): the
                    # payload names the owning replica; lift it into the
                    # header a redirect-following client acts on
                    self.send_header("Location", location)
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            do_GET = do_POST = _respond

        front = front or os.environ.get(consts.ENV_GATEWAY_FRONT,
                                        "multiplexed")
        if front == "threaded":
            server = ThreadingHTTPServer((address, port), Handler)
            threading.Thread(target=server.serve_forever,
                             daemon=True).start()
        else:
            from gpumounter_tpu_torch.master.httpfront import \
                MultiplexedHTTPServer
            server = MultiplexedHTTPServer(
                address, port, Handler,
                workers=workers or int(os.environ.get(
                    consts.ENV_GATEWAY_WORKERS, "0")) or None,
                max_conns=max_conns or int(os.environ.get(
                    consts.ENV_GATEWAY_MAX_CONNS, "1024")))
        # A serving master runs the broker's maintenance loop (lease
        # expiry, gauge refresh) and the fleet aggregator's scrape loop
        # (which also ticks the SLO engine); unit tests drive
        # broker.tick() / fleet.tick() directly. The loops' lifetime is
        # tied to the server's: shutting the front down stops them (an
        # orphaned fleet loop would keep ticking the SLO engine against
        # the process registry — and withdraw, on stop, the burn gauges
        # it exported).
        self.broker.start()
        self.fleet.start()
        if self.defrag is not None:
            self.defrag.start()
        # HA: the election loop acquires/renews this replica's shard
        # locks; its lifetime is tied to the server's like the loops
        # above (a stopped master releases nothing — the locks simply
        # expire and peers take over within one renew interval).
        if self.election is not None:
            self.election.start()
        # Flight-recorder bundles written by this master carry the broker
        # state (who held what when the anomaly fired). Registered HERE,
        # symmetric with the removal in shutdown: a gateway constructed
        # but never served must not park a provider on the process-global
        # recorder (stale broker snapshots in later bundles, retained
        # object graph).
        from gpumounter_tpu_torch.utils.flight import RECORDER
        RECORDER.register_provider("broker", self.broker.snapshot)
        orig_shutdown = server.shutdown

        def shutdown_with_loops():
            if self.defrag is not None:
                self.defrag.stop()
            self.fleet.stop()
            self.broker.stop()
            if self.election is not None:
                self.election.stop()
            # the process-global recorder must not snapshot a stopped
            # broker into later bundles (or retain this gateway forever)
            from gpumounter_tpu_torch.utils.flight import RECORDER
            RECORDER.unregister_provider("broker", self.broker.snapshot)
            orig_shutdown()

        server.shutdown = shutdown_with_loops
        logger.info("master gateway serving on %s:%d (%s front)", address,
                    server.server_port, front)
        return server


def _find_spans(span_dict: dict, name: str) -> list[dict]:
    """All spans named ``name`` in a span-tree dict, depth-first."""
    hits = []
    if span_dict.get("name") == name:
        hits.append(span_dict)
    for child in span_dict.get("children", []) or []:
        hits.extend(_find_spans(child, name))
    return hits


def _parse_uuids(body: bytes, query: str) -> list[str]:
    """uuids from JSON body {"uuids": [...]}, form field (repeated or
    comma-separated — the reference took repeated form values,
    main.go:121-128), or query string."""
    text = body.decode(errors="replace").strip()
    if text.startswith("{"):
        try:
            raw = json.loads(text).get("uuids", [])
        except json.JSONDecodeError:
            return []
        if raw is None:
            return []
        if isinstance(raw, str):          # "0,1" — not char-by-char
            return [u for u in raw.split(",") if u]
        if isinstance(raw, list):
            return [str(u) for u in raw]
        return []
    merged: list[str] = []
    for source in (text, query):
        if not source:
            continue
        for value in urllib.parse.parse_qs(source).get("uuids", []):
            merged.extend(u for u in value.split(",") if u)
    return merged
