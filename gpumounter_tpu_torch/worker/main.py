"""Worker daemon entrypoint (the port of :mod:`gpumounter_tpu.worker.main`).

Ref ``cmd/GPUMounter-worker/main.go``: boot logging, construct the mounter
stack, serve gRPC on :1200. Additions the reference lacks (SURVEY.md §5):
an HTTP health/metrics sidecar port (``/healthz``, ``/readyz``, ``/metrics``)
so the DaemonSet can carry probes and Prometheus can scrape attach latency.

Run as: ``python -m gpumounter_tpu_torch.worker.main``.
"""

from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from gpumounter_tpu_torch.actuation.cgroup import CgroupDeviceController
from gpumounter_tpu_torch.actuation.mount import GPUMounter
from gpumounter_tpu_torch.actuation.nsenter import ProcRootActuator
from gpumounter_tpu_torch.allocator import GPUAllocator
from gpumounter_tpu_torch.collector.collector import GPUCollector
from gpumounter_tpu_torch.collector.podresources import \
    KubeletPodResourcesClient
from gpumounter_tpu_torch.device.native_enumerator import best_enumerator
from gpumounter_tpu_torch.k8s.client import default_kube_client
from gpumounter_tpu_torch.utils.config import Settings
from gpumounter_tpu_torch.utils.log import get_logger
from gpumounter_tpu_torch.utils.metrics import REGISTRY
from gpumounter_tpu_torch.worker.grpc_server import (build_server,
                                                     load_tls_config)
from gpumounter_tpu_torch.worker.service import GPUMountService

logger = get_logger("worker.main")

HEALTH_PORT_OFFSET = 1  # health on grpc_port + 1 (1201 by default)


class _HealthHandler(BaseHTTPRequestHandler):
    ready = False
    pool = None        # PoolManager, set by main() when the pool is enabled
    journal = None     # AttachJournal, set by main() when journaling is on
    cache = None       # PodCacheReads, set by main() (informer handle)
    agent = None       # ResidentActuationAgent, set when the agent is on
    events = None      # EventLog override; None = the process singleton
    usage = None       # ChipUsageSampler, set when TPU_USAGE is on
    topo = None        # NodeTopologyView, set when TPU_TOPOLOGY is on
    gate = None        # DeviceGate, set when TPU_GATE != legacy
    drain = None       # DrainController, set by main() (graceful drain)

    def log_message(self, *args):
        pass

    def do_POST(self):
        # POST /drainz: begin a graceful drain (idempotent; the full
        # settle/flush sequence runs on its own thread so the request
        # answers immediately with the current status). The SIGTERM
        # handler runs the same sequence — this is the operator's/
        # pre-stop hook's entry to it.
        import json
        drain = type(self).drain
        if self.path.split("?", 1)[0] != "/drainz":
            body, ctype, code = b"not found", "text/plain", 404
        elif drain is None:
            body = json.dumps({"enabled": False}).encode()
            ctype, code = "application/json", 503
        else:
            started = drain.begin("drainz")
            if started:
                journal = type(self).journal
                threading.Thread(
                    target=lambda: drain.run(journal=journal,
                                             reason="drainz"),
                    daemon=True, name="tpumounter-drainz").start()
            body = json.dumps({"enabled": True, "started": started,
                               **drain.status()}).encode()
            ctype, code = "application/json", 200
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path == "/metrics":
            # exemplars only when the scraper negotiated OpenMetrics —
            # they are a parse error in the classic text exposition
            openmetrics, ctype = REGISTRY.negotiate(
                self.headers.get("Accept"))
            body = REGISTRY.render_text(openmetrics=openmetrics).encode()
            code = 200
        elif self.path.split("?", 1)[0] == "/eventz":
            # lifecycle event tail: every attach/detach/journal/pool/
            # agent transition on this node, cursor-paginated by seq —
            # what the master's fleet aggregator tails per tick
            import json
            import urllib.parse
            from gpumounter_tpu_torch.utils.events import EVENTS
            params = urllib.parse.parse_qs(
                urllib.parse.urlparse(self.path).query)
            log = type(self).events or EVENTS
            body = json.dumps(log.snapshot_from_query(params)).encode()
            ctype = "application/json"
            code = 200
        elif self.path.split("?", 1)[0] == "/tracez":
            # recent + slowest completed traces (span trees), filterable
            # by rid= and result= — the master stitches this node's view
            # into its own for cross-process request archaeology
            import json
            import urllib.parse
            from gpumounter_tpu_torch.utils.trace import STORE
            params = urllib.parse.parse_qs(
                urllib.parse.urlparse(self.path).query)
            try:
                limit = int((params.get("limit") or ["32"])[0])
            except ValueError:
                limit = 32
            body = json.dumps(STORE.snapshot(
                rid=(params.get("rid") or [None])[0],
                result=(params.get("result") or [None])[0],
                limit=limit)).encode()
            ctype = "application/json"
            code = 200
        elif self.path == "/poolz":
            # warm-pool introspection: targets vs live counts, hit/miss
            import json
            pool = type(self).pool
            body = json.dumps(pool.status() if pool is not None
                              else {"enabled": False}).encode()
            ctype = "application/json"
            code = 200
        elif self.path == "/cachez":
            # shared-informer introspection: per-scope staleness, watch
            # restarts, fence position, and cache hit/miss totals
            import json
            cache = type(self).cache
            body = json.dumps(cache.status() if cache is not None
                              else {"enabled": False}).encode()
            ctype = "application/json"
            code = 200
        elif self.path == "/agentz":
            # resident actuation agent: cached ns handles per container,
            # revalidation outcomes, fallback count (doctor WARNs on a
            # non-zero windowed fallback rate)
            import json
            agent = type(self).agent
            body = json.dumps(agent.status() if agent is not None
                              else {"enabled": False}).encode()
            ctype = "application/json"
            code = 200
        elif self.path == "/utilz":
            # chip utilization & device-access accounting: per-chip duty
            # cycle + window average, owner attribution (chip → slave
            # pod → owner pod), open/close accounting — what the
            # master's fleet aggregator joins to leases/tenants. Serves
            # ALREADY-collected sampler state; no sampling runs on this
            # request thread (tests/test_usage_lint.py pins it).
            import json
            usage = type(self).usage
            body = json.dumps(usage.snapshot() if usage is not None
                              else {"enabled": False}).encode()
            ctype = "application/json"
            code = 200
        elif self.path == "/topoz":
            # fleet topology plane: each chip's coordinate in the node's
            # advertised mesh + free/leased occupancy joined to its
            # owner — what the master's FleetTopology scrapes for
            # fragmentation scoring. Serves the view's snapshot() over
            # the collector's CACHED inventory; no enumeration or
            # kubelet probe runs on this request thread
            # (tests/test_topology_lint.py pins it).
            import json
            topo = type(self).topo
            body = json.dumps(topo.snapshot() if topo is not None
                              else {"enabled": False}).encode()
            ctype = "application/json"
            code = 200
        elif self.path == "/gatez":
            # kernel device gate: backend + per-container entries, the
            # deny ring with reasons, drift audit, converge stats —
            # ALREADY-collected state only (snapshot(); no backend poll
            # runs on this request thread)
            import json
            gate = type(self).gate
            body = json.dumps(gate.snapshot() if gate is not None
                              else {"enabled": False}).encode()
            ctype = "application/json"
            code = 200
        elif self.path == "/journalz":
            # attach-journal introspection: backlog of incomplete records
            # (should be 0 outside a crash window) + replay outcomes
            import json
            journal = type(self).journal
            body = json.dumps(journal.snapshot() if journal is not None
                              else {"enabled": False}).encode()
            ctype = "application/json"
            code = 200
        elif self.path == "/drainz":
            # drain state: draining flag, in-flight actuation count,
            # refused attaches — POST here begins the drain
            import json
            drain = type(self).drain
            body = json.dumps({"enabled": True, **drain.status()}
                              if drain is not None
                              else {"enabled": False}).encode()
            ctype = "application/json"
            code = 200
        elif self.path in ("/healthz", "/readyz"):
            drain = type(self).drain
            draining = drain is not None and drain.draining
            if self.path == "/healthz":
                # a draining worker is ALIVE but leaving: say so — the
                # master's fleet scrape folds this into the node state
                # machine (cordon within one tick). 200, not 5xx: the
                # process is healthy, just not accepting new grants.
                body = b"draining" if draining else b"ok"
                code = 200
            else:
                ok = type(self).ready and not draining
                body = b"ok" if ok else b"not ready"
                code = 200 if ok else 503
            ctype = "text/plain"
        else:
            body, ctype, code = b"not found", "text/plain", 404
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


def start_health_server(port: int, **state) -> ThreadingHTTPServer:
    """Serve the health/metrics/introspection sidecar. ``state`` keys
    (``journal``/``cache``/``pool``/``agent``/``events``/``ready``)
    override the module-level handler attributes for THIS server only —
    multi-worker test stacks give each simulated node its own journal and
    event log behind its own port; production (and existing rigs) keep
    setting the ``_HealthHandler`` class attributes directly."""
    handler = _HealthHandler
    if state:
        unknown = set(state) - {"journal", "cache", "pool", "agent",
                                "events", "ready", "usage", "gate",
                                "drain", "topo"}
        if unknown:
            raise TypeError(f"unknown health-server state: {unknown}")
        handler = type("_ScopedHealthHandler", (_HealthHandler,), state)
    server = ThreadingHTTPServer(("0.0.0.0", port), handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


def _build_journal(settings: Settings):
    """The attach journal, or None when disabled/unwritable. An unwritable
    journal dir is LOUD but non-fatal: a worker that can't journal still
    serves attaches (with the pre-journal crash window), which beats a
    crash-looping DaemonSet on a misconfigured hostPath."""
    if not settings.journal_path:
        return None
    from gpumounter_tpu_torch.worker.journal import AttachJournal
    try:
        return AttachJournal(settings.journal_path)
    except OSError as e:
        logger.error("attach journal %s unusable (%s); running WITHOUT "
                     "crash-safe attach journaling", settings.journal_path,
                     e)
        return None


def build_stack(settings: Settings) -> GPUMountService:
    """Wire the production object graph (ref server.go:22-33 NewGPUMounter →
    NewGPUAllocator → NewGPUCollector; composition instead of embedding).
    The shared pod informer (one list+watch over the pool namespace) is
    the default read path; ``TPU_INFORMER=0`` reverts every read to direct
    apiserver calls. The resident actuation agent (cached ns fds, zero
    fork on the warm path) is the default actuator; ``TPU_AGENT=0``
    reverts to direct per-call actuation."""
    enumerator = best_enumerator(settings.host,
                                 allow_fake=settings.allow_fake_devices,
                                 cache_ttl_s=settings.enum_cache_ttl_s)
    podresources = KubeletPodResourcesClient(settings.host.kubelet_socket)
    collector = GPUCollector(enumerator, podresources,
                             resource_name=settings.resource_name,
                             pool_namespace=settings.pool_namespace)
    kube = default_kube_client()
    reads = None
    if settings.informer_enabled:
        from gpumounter_tpu_torch.k8s.informer import PodCacheReads, PodInformer
        informer = PodInformer(kube, settings.pool_namespace).start()
        reads = PodCacheReads(kube, [informer],
                              fence_timeout_s=settings.
                              informer_fence_timeout_s)
    allocator = GPUAllocator(collector, kube, settings, reads=reads)
    cgroups = CgroupDeviceController(settings.host,
                                     driver=settings.cgroup_driver)
    journal = _build_journal(settings)
    # Kernel-enforced device gate (actuation/gate.py): EVERY device
    # grant/revoke crosses this seam. TPU_GATE=auto (default) picks the
    # strongest backend (eBPF policy map on cgroup v2, devices.allow/deny
    # on v1); TPU_GATE=legacy reverts to direct controller calls
    # byte-for-byte. Journaled for crash convergence when a journal is on.
    from gpumounter_tpu_torch.actuation.gate import build_gate
    gate = build_gate(settings, cgroups, journal=journal)
    if gate.live:
        _HealthHandler.gate = gate
        logger.info("device gate enabled: backend=%s", gate.backend.name)
    actuator = ProcRootActuator(settings.host)
    if settings.agent_enabled:
        from gpumounter_tpu_torch.actuation.agent import (
            AgentActuator, ResidentActuationAgent)
        # fake_nodes stays False even with TPU_ALLOW_FAKE_DEVICES: that
        # flag widens what the ENUMERATOR accepts; actuation always
        # creates real char nodes, exactly like the ProcRootActuator
        # fallback beneath it (boot tests run both paths as root).
        agent = ResidentActuationAgent(settings.host, fake_nodes=False)
        actuator = AgentActuator(agent, actuator)
        _HealthHandler.agent = agent
    mounter = GPUMounter(cgroups, actuator, enumerator, settings.host,
                         plans=collector.plans, gate=gate)
    return GPUMountService(allocator, mounter, kube, settings,
                           journal=journal)


def main() -> None:
    from gpumounter_tpu_torch.utils.log import init_logger
    init_logger()
    settings = Settings.from_env()
    logger.info("worker starting: node=%s pool_ns=%s driver=%s",
                settings.node_name, settings.pool_namespace,
                settings.cgroup_driver)
    health = start_health_server(
        settings.worker_grpc_port + HEALTH_PORT_OFFSET)
    # Fail fast like the reference (SURVEY.md §3.1: worker exits if NVML or
    # the kubelet socket is unavailable) — the nodeSelector guarantees GPU
    # nodes, so a broken stack here is a deploy error worth crashing on.
    service = build_stack(settings)
    _HealthHandler.journal = service.journal
    _HealthHandler.cache = service.reads
    if service.journal is not None:
        # flight-recorder bundles on this node carry the journal tail
        from gpumounter_tpu_torch.utils.flight import RECORDER
        RECORDER.register_provider("journal", service.journal.snapshot)
    # BEFORE serving: a crash mid-attach must be repaired (and the device
    # gate converged to attachment ground truth) before new requests can
    # race the leftover state. Runs journal-less too: gate convergence
    # derives from the cluster, not the journal.
    outcomes = service.replay_journal()
    if outcomes:
        logger.info("attach-journal replay: %s", outcomes)
    if _HealthHandler.gate is not None:
        # anomaly bundles answer "what was the gate enforcing / denying"
        from gpumounter_tpu_torch.utils.flight import RECORDER
        RECORDER.register_provider("gate", _HealthHandler.gate.snapshot)
    from gpumounter_tpu_torch.worker.reconciler import OrphanReconciler
    reconciler = OrphanReconciler(service.kube, settings,
                                  gate=service.mounter.gate).start()
    pool = None
    if settings.warm_pool_enabled:
        from gpumounter_tpu_torch.worker.pool import PoolManager
        pool = PoolManager(service.allocator, service.kube,
                           settings)
        # pool-warm actuation hook: each reconcile pass refreshes the
        # inventory snapshot (and with it the precomputed actuation plan
        # cache) OFF the attach hot path
        pool.warm_hook = service.allocator.collector.update_status
        pool.start()
        service.pool = pool
        _HealthHandler.pool = pool
        logger.info("warm pool enabled: %s", settings.warm_pool_sizes)
    sampler = None
    if settings.usage_enabled:
        # GPU usage sampler (collector/usage.py): duty cycles (NVML
        # utilization, else open-fd detection) + device open accounting
        # on its OWN thread, served as GET /utilz — the fleet
        # aggregator's per-lease utilization source. TPU_USAGE=0 removes
        # the thread and every new series.
        from gpumounter_tpu_torch.collector.usage import build_sampler
        from gpumounter_tpu_torch.utils.flight import RECORDER
        sampler = build_sampler(service, settings,
                                gate=service.mounter.gate).start()
        _HealthHandler.usage = sampler
        # anomaly bundles on this node answer "what were the GPUs DOING"
        RECORDER.register_provider("usage", sampler.snapshot)
        logger.info("usage sampler enabled: interval %.1fs",
                    settings.usage_interval_s)
    if settings.topology_enabled:
        # fleet topology plane (collector/topology.py): snapshot-only GPU
        # coordinate + occupancy view served as GET /topoz for the
        # master's fragmentation scoring. No thread — the view reads
        # state other components already maintain. TPU_TOPOLOGY=0
        # removes the payload and the fleet scrape.
        from gpumounter_tpu_torch.collector.topology import \
            build_topology_view
        _HealthHandler.topo = build_topology_view(service, settings)
        logger.info("topology snapshot enabled (/topoz)")
    tls = load_tls_config()
    if tls:
        logger.info("worker gRPC TLS enabled (mTLS=%s)",
                    bool(tls.ca_file))
    # The 10k admission path (utils/parking.py): the parking executor is
    # the production default — TPU_GRPC_WORKERS bounds ACTIVE threads
    # while parked waits ride free. TPU_GRPC_ASYNC=0 reverts to the
    # fixed thread pool (where TPU_GRPC_WORKERS is simply its size —
    # the formerly hard-coded 8, now deployable).
    server, port = build_server(
        service, settings.worker_grpc_port, tls=tls,
        max_workers=settings.grpc_workers,
        mode="parking" if settings.grpc_async else "threadpool",
        max_parked=settings.grpc_max_parked)
    logger.info("worker gRPC executor: %s (workers=%d)",
                "parking" if settings.grpc_async else "threadpool",
                settings.grpc_workers)
    # Graceful drain (worker/drain.py): SIGTERM (the DaemonSet's rolling
    # restart / node shutdown) begins the drain sequence — stop admitting
    # attaches, settle in-flight actuation, flush journal/events, report
    # "draining" on healthz so the master cordons within one fleet tick —
    # then stops the gRPC server. A spot-termination watcher triggers the
    # same drain proactively when the preemption notice file appears.
    import signal

    from gpumounter_tpu_torch.worker.drain import (DrainController,
                                                   SpotTerminationWatcher)
    drainer = DrainController(settings.node_name,
                              default_timeout_s=settings.drain_timeout_s)
    drainer.register_flush(service.flush_mesh_generation)
    service.drain = drainer
    _HealthHandler.drain = drainer

    def _drain_and_stop(reason: str) -> None:
        drainer.run(journal=service.journal, reason=reason)
        server.stop(grace=5.0)

    def _on_sigterm(signum, frame):
        threading.Thread(target=_drain_and_stop, args=("sigterm",),
                         daemon=True,
                         name="tpumounter-sigterm-drain").start()

    try:
        signal.signal(signal.SIGTERM, _on_sigterm)
    except ValueError:
        # not the main thread (embedded runs): SIGTERM stays default;
        # POST /drainz and the spot watcher still work
        logger.warning("SIGTERM drain handler not installed (not on "
                       "the main thread)")
    spot_watcher = None
    if settings.spot_termination_file:
        spot_watcher = SpotTerminationWatcher(
            settings.spot_termination_file,
            on_terminate=lambda: _drain_and_stop("spot-termination"),
        ).start()
        logger.info("spot-termination watcher on %s",
                    settings.spot_termination_file)
    server.start()
    _HealthHandler.ready = True
    logger.info("worker serving gRPC on :%d, health on :%d", port,
                settings.worker_grpc_port + HEALTH_PORT_OFFSET)
    try:
        server.wait_for_termination()
    finally:
        if spot_watcher is not None:
            spot_watcher.stop()
        if pool is not None:
            pool.stop()
        if sampler is not None:
            from gpumounter_tpu_torch.utils.flight import RECORDER
            RECORDER.unregister_provider("usage", sampler.snapshot)
            sampler.stop()
        if _HealthHandler.agent is not None:
            _HealthHandler.agent.stop()
        reconciler.stop()
        service.reads.stop()
        health.shutdown()


if __name__ == "__main__":
    main()
