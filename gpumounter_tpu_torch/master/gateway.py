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

The port serves the single-master path. Every plane it does not run yet is
in the off state the control plane defines for it: no HA (``HAConfig``
enabled raises), no node health (as ``TPU_NODE_HEALTH=0``), no topology
plane or defragmenter (as ``TPU_TOPOLOGY=0``: ``/topoz`` is no route), and
no slice subsystem: its routes answer 501 naming the ROADMAP item.
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
from gpumounter_tpu_torch.master.fleet import FleetAggregator
from gpumounter_tpu_torch.master.shardring import HAConfig
from gpumounter_tpu_torch.utils import consts
from gpumounter_tpu_torch.utils.events import EVENTS
from gpumounter_tpu_torch.utils.errors import (CircuitOpenError, K8sApiError,
                                               PodNotFoundError,
                                               QueueFullError,
                                               QuotaExceededError)
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
                 "/slicez": "slicez"}
# The slice subsystem's routes (master/slicetxn.py, master/slice.py) are
# not ported yet: they answer 501 and name the ROADMAP item that ports them.
_SLICE_ROUTES = ("/addgpuslice", "/removegpuslice", "/slice/resize",
                 "/slice/barrier", "/slicez")
_SLICE_NOT_PORTED = ("the slice subsystem (master/slicetxn.py, "
                     "master/slice.py) is not ported yet: ROADMAP Queue 1 "
                     "item 12a")
_HA_NOT_PORTED = ("the HA plane (master/store.py, master/election.py) is "
                  "not ported yet: ROADMAP Queue 1 item 12b")
# Pure introspection requests (and renew heartbeats) would drown the
# mount traces in the ring buffer; they are measured (histogram) but not
# stored.
_UNTRACED_ROUTES = {"healthz", "version", "tracez", "brokerz", "eventz",
                    "fleetz", "renew", "slicez", "slicebarrier",
                    "unknown"}


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
        # HA plane (docs/guide/HA.md): the default HAConfig is the
        # single-master semantics — one shard, no election, no store.
        if ha is not None and ha.enabled:
            raise NotImplementedError(_HA_NOT_PORTED)
        # Telemetry plane: the SLO engine computes per-tenant burn rates
        # from this process's registry; the fleet aggregator scrapes every
        # worker's health port into the /fleetz cluster view and ticks the
        # engine. serve() starts the loop; unit tests drive tick().
        from gpumounter_tpu_torch.utils.slo import SloEngine
        self.slo = SloEngine()
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
        self.fleet = FleetAggregator(
            targets_fn=self._fleet_targets,
            usage_fn=self.broker.leases.usage,
            slo=self.slo,
            tick_interval_s=fleet_interval,
            ha_fn=lambda: {"enabled": False},
            # joins scraped chip utilization to the tenant holding the
            # grant (/fleetz per-tenant utilization + idle-lease list)
            lease_lookup=self.broker.leases.get)
        # ...and the reverse direction: the broker tick reads the
        # fleet's observed per-lease activity to mark leases idle past
        # TPU_IDLE_LEASE_S (reclaim signal + preemption preference).
        self.broker.bind_utilization(self.fleet.lease_activity)
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
            return self._renew(match["ns"], match["pod"], query)
        if p in _SLICE_ROUTES:
            return 501, {"result": "NotImplemented",
                         "message": f"{p}: {_SLICE_NOT_PORTED}"}
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

    def _worker_attach_attempt(self, namespace: str, pod_name: str,
                               chips: int, entire: bool, rid: str,
                               node: str):
        """The attach attempt_fn: the worker add_gpu RPC + result
        accounting + HTTP mapping. Only invoked from inside
        broker.attach, so admission, queueing and lease recording all
        wrap it."""
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
            return _ADD_HTTP[result], payload

        return attempt

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
        return self.broker.attach(
            tenant=tenant, priority=priority, namespace=namespace,
            pod=pod_name, chips=gpu_num, node=node, rid=rid,
            attempt_fn=self._worker_attach_attempt(
                namespace, pod_name, gpu_num, entire, rid, node))

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
            self.fleet.stop()
            self.broker.stop()
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
