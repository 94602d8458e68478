"""What the worker serves in a GPU cluster beside the attach itself, on one
node: mTLS, a Pod of two containers, busy detection in the sidecar, the
status surfaces, the in-pod proof, and a long storm.

:func:`run_worker_surface` runs on the worker of :mod:`.worker_attach`
(its ``_Stack``: an HTTP apiserver facade, a scripted scheduler with a
PodResources gRPC server, the informer, the v1 device gate, the resident
agent and a fixture node), around whatever enumerator the caller passes:

1. **mTLS, dialed by IP.** A self-signed certificate carrying the worker's
   fixed name (``DEFAULT_TLS_SERVER_NAME``, ``gpu-mounter-worker``) is made
   under ``root``; the worker serves with it and requires client
   certificates, and the client dials ``127.0.0.1:<port>`` and verifies
   that name (``ssl_target_name_override``). A client with the same CA
   and name but no certificate of its own, and a plaintext client, must
   both be refused.
2. **Two containers, one Pod.** ``AddGPU`` puts the GPU's node and the
   companions once into both ``main`` and ``sidecar``, and the v1 gate
   grants them in both.
3. **Busy in the sidecar.** ``spawn_holder``'s process runs in the sidecar
   only. ``GPUStatus`` over mTLS and the master's ``/gpustatus`` (a
   :class:`.master_attach.Master` dialing the worker with the same TLS
   material) name its pid; the master echoes a supplied ``X-Request-Id``;
   ``RemoveGPU`` answers ``GPUBusy`` with that pid, and the forced detach
   kills it and leaves no node and no rule in either container.
4. **The in-pod proof** (``spawn_proof``) from the sidecar after a
   re-attach.
5. **A storm and the budgets.** After a warm-up that also starts every
   thread the gRPC server's executor will run, ``storm_cycles``
   ``AddGPU``/``RemoveGPU`` pairs over mTLS must leave the process's fds
   (+3), threads (+2), the service's lock tables (empty) and its event
   queue (drained) as they found them, within the apiserver and kubelet
   requests per attach that ``tests/test_torch_round_trip_budget.py``
   pins for this wiring (an informer and no warm pool), exactly: a
   request the retry layer sent again fails the budget, and the report
   names its cause. Then
   ``timed_pairs`` pairs through the master over mTLS beside as many
   through a second master over plaintext to a plaintext server of the
   same service: host-clock medians with min and max, and the gateway's
   and the worker's span medians.

Every check is reported by name; the caller decides what failing means.
"""

from __future__ import annotations

import contextlib
import datetime
import logging
import os
import shutil
import subprocess
import threading
import time
from collections.abc import Callable

from gpumounter_tpu_torch.device.enumerator import Enumerator
from gpumounter_tpu_torch.device.model import GPUDevice
from gpumounter_tpu_torch.testing.master_attach import Master, _http
from gpumounter_tpu_torch.testing.worker_attach import (IDLE, _delta,
                                                        _host_majmin,
                                                        _Stack, _stats,
                                                        spawn)

STORM_CYCLES = 30
TIMED_PAIRS = 20
POD = "surface"
# Requests per attach/detach pair with an informer and no warm pool, once
# the node's topology is cached (tests/test_torch_round_trip_budget.py:
# the cold attach without its node GET, and the detach).
APISERVER_BUDGET = {"GET/pods": 2, "POST/pods": 1, "DELETE/pods": 1}
KUBELET_LISTS_PER_ATTACH = 3
FD_GROWTH, THREAD_GROWTH = 3, 2


def make_cert(directory: str, name: str) -> tuple[str, str]:
    """A self-signed certificate and key for ``name`` (its CN and its one
    DNS SAN) under ``directory``. Returns (cert, key); raises ImportError
    where ``cryptography`` is missing, and the phase fails with it."""
    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import rsa
    from cryptography.x509.oid import NameOID

    os.makedirs(directory, exist_ok=True)
    cert = os.path.join(directory, "worker.crt")
    key = os.path.join(directory, "worker.key")
    private = rsa.generate_private_key(public_exponent=65537, key_size=2048)
    subject = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, name)])
    now = datetime.datetime.now(datetime.timezone.utc)
    certificate = (
        x509.CertificateBuilder().subject_name(subject).issuer_name(subject)
        .public_key(private.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now - datetime.timedelta(minutes=5))
        .not_valid_after(now + datetime.timedelta(days=1))
        .add_extension(x509.SubjectAlternativeName([x509.DNSName(name)]),
                       critical=False)
        .sign(private, hashes.SHA256()))
    with open(cert, "wb") as f:
        f.write(certificate.public_bytes(serialization.Encoding.PEM))
    with open(key, "wb") as f:
        f.write(private.private_bytes(
            serialization.Encoding.PEM, serialization.PrivateFormat.PKCS8,
            serialization.NoEncryption()))
    return cert, key


def _trace_medians(op: str, n: int) -> dict:
    """Median total milliseconds of the last ``n`` traces of ``op``."""
    from gpumounter_tpu_torch.utils.trace import STORE
    totals = [t["total_ms"] for t in STORE.recent(op=op, limit=n)]
    return _stats(totals) if totals else {}


@contextlib.contextmanager
def retry_causes(target: str = "apiserver"):
    """Collect, while the block runs, why the retry layer sent a call to
    ``target`` again: the error's ``cause`` (``reset``, ``timeout``,
    ``refused``, ...), else its HTTP status, else its type. Read from the
    layer's "retrying" log record, which carries the error."""
    from gpumounter_tpu_torch.utils import retry
    causes: list[str] = []

    class Handler(logging.Handler):
        def emit(self, record: logging.LogRecord) -> None:
            if (str(record.msg).startswith("retrying ") and record.args
                    and record.args[0] == target):
                error = record.args[-1]
                causes.append(getattr(error, "cause", "")
                              or str(getattr(error, "status", "")
                                     or type(error).__name__))
    handler, level = Handler(), retry.logger.level
    retry.logger.addHandler(handler)
    retry.logger.setLevel(logging.INFO)
    try:
        yield causes
    finally:
        retry.logger.removeHandler(handler)
        retry.logger.setLevel(level)


def _pair(base: str) -> tuple[float, float, bool]:
    """One attach and detach of one GPU through the master at ``base``:
    the host clock of each, in ms, and whether both succeeded."""
    t0 = time.perf_counter()
    add, body = _http("GET", base + f"/addgpu/namespace/default/pod/{POD}"
                      "/gpu/1/isEntireMount/false")
    t1 = time.perf_counter()
    rm, out = _http("POST", base + f"/removegpu/namespace/default/pod/{POD}"
                    "/force/false")
    t2 = time.perf_counter()
    ok = (add == 200 and rm == 200 and body.get("result") == "SUCCESS"
          and out.get("result") == "SUCCESS")
    return (t1 - t0) * 1e3, (t2 - t1) * 1e3, ok


def _fill_handler_threads(stack: _Stack, n: int) -> bool:
    """Start ``n`` threads in the gRPC server's parking executor: ``n``
    tasks that hold until all are running, each submitted once the one
    before it runs (so every submit finds no idle thread and starts one).
    Returns whether all ``n`` ran at once."""
    executor = stack.server.parking_executor
    release = threading.Event()
    futures, running = [], 0
    for _ in range(n):
        started = threading.Event()
        futures.append(executor.submit(
            lambda started=started: (started.set(), release.wait(30))))
        if not started.wait(10):
            break
        running += 1
    release.set()
    for future in futures:
        future.result(timeout=30)
    return running == n


def run_worker_surface(root: str, enumerator: Enumerator,
                       spawn_holder: Callable[[GPUDevice], subprocess.Popen],
                       spawn_proof: Callable[[GPUDevice], subprocess.Popen],
                       storm_cycles: int = STORM_CYCLES,
                       timed_pairs: int = TIMED_PAIRS) -> dict:
    """Drive the worker's surface under ``root`` (removed first and
    afterwards). ``spawn_holder(gpu)`` starts a process that holds the
    GPU's node open; ``spawn_proof(gpu)`` the in-pod proof, which prints
    one JSON line and holds until its stdin closes. Returns the report
    with its ``checks``."""
    import json

    import grpc

    from gpumounter_tpu_torch.actuation.agent import _fallback_total
    from gpumounter_tpu_torch.api import gpu_mount_pb2 as pb
    from gpumounter_tpu_torch.utils.metrics import REGISTRY
    from gpumounter_tpu_torch.worker.grpc_server import (
        DEFAULT_TLS_SERVER_NAME, TlsConfig, WorkerClient, build_server)

    shutil.rmtree(root, ignore_errors=True)
    t_phase = time.perf_counter()
    procs: list[subprocess.Popen] = []
    closers: list[Callable[[], object]] = []
    checks: dict[str, bool] = {}
    report: dict = {}
    stack = None
    fallbacks_before = _fallback_total()
    ok_add, ok_rm = pb.AddGPUResponse.Success, pb.RemoveGPUResponse.Success
    try:
        # 1. mTLS, dialed by IP
        cert, key = make_cert(os.path.join(root, "tls"),
                              DEFAULT_TLS_SERVER_NAME)
        tls = TlsConfig(cert_file=cert, key_file=key, ca_file=cert)
        stack = _Stack(os.path.join(root, "node"), enumerator, tls=tls)
        gpus = [d for d in enumerator.enumerate() if d.uuid]
        checks["node_has_a_gpu"] = bool(gpus)
        checks["mtls_dialed_by_ip"] = (
            stack.client.target == f"127.0.0.1:{stack.port}"
            and len(stack.client.node_status().gpus) == len(gpus))

        def refused_with(client_tls: TlsConfig | None) -> str | None:
            client = WorkerClient(f"127.0.0.1:{stack.port}", timeout_s=5,
                                  tls=client_tls)
            try:
                client.node_status()
                return None
            except grpc.RpcError as e:
                return e.code().name
            finally:
                client.close()
        # the same CA and name as the mTLS client, without its key pair
        report["tls"] = {"server_name": tls.server_name,
                         "certless_refused_with": refused_with(
                             TlsConfig(ca_file=cert)),
                         "plaintext_refused_with": refused_with(None)}
        checks["client_cert_required"] = \
            report["tls"]["certless_refused_with"] == "UNAVAILABLE"
        checks["plaintext_refused"] = \
            report["tls"]["plaintext_refused_with"] == "UNAVAILABLE"

        # 2. two containers, one Pod
        idle_main, idle_side = spawn(IDLE), spawn(IDLE)
        procs += [idle_main, idle_side]
        main = stack.node.container(POD, [idle_main.pid])
        side = main.add_container("sidecar", [idle_side.pid])
        pod = stack.add_target(main)
        checks["pod_has_two_containers"] = [
            c["name"] for c in pod["spec"]["containers"]] == ["main",
                                                              "sidecar"]
        resp = stack.client.add_gpu(POD, "default", 1)
        gpu = next((d for d in gpus if list(resp.device_ids) == [d.uuid]),
                   None)
        checks["add_over_mtls"] = resp.result == ok_add and gpu is not None
        if gpu is None:
            report["device_ids"] = list(resp.device_ids)
            return report
        own = _host_majmin(gpu.device_path, gpu.major, gpu.minor)
        companions = {os.path.basename(c.host_path):
                      _host_majmin(c.host_path, c.major, c.minor)
                      for c in gpu.companions}
        granted = {own, *companions.values()}
        expect = {os.path.basename(gpu.device_path): own, **companions}
        lines = sorted(f"c {a}:{b} rw" for a, b in granted)
        keys = {box.container: stack.node.controller.container_dir(
            pod, box.container_id) for box in (main, side)}

        def gate_pairs(box) -> set:
            live, _opens, _denies = stack.gate.backend.read(
                keys[box.container])
            return {(k[1], k[2]) for k in live}
        for box in (main, side):
            checks[f"{box.container}_nodes_match_host_rdev"] = \
                box.nodes() == expect
            checks[f"{box.container}_gate_grants_once"] = (
                gate_pairs(box) == granted
                and sorted(box.cgroup_lines("devices.allow")) == lines)
        checks["gate_grants_the_card"] = \
            gpu.uuid in stack.gate.granted_uuids()

        # 3. busy in the sidecar
        holder = spawn_holder(gpu)
        procs.append(holder)
        side.set_pids([idle_side.pid, holder.pid])
        status = stack.client.gpu_status(POD, "default")
        checks["gpu_status_names_the_holder"] = (
            [(g.device_id, list(g.busy_pids)) for g in status.gpus]
            == [(gpu.uuid, [holder.pid])])
        # the master (its fleet loop lists the worker pods) is up only
        # while it is asked, so the storm's request counts are the
        # worker's own
        master = Master(stack, lambda target: WorkerClient(target, tls=tls))
        rid = "surface-status-1"
        try:
            code, body = _http("GET", master.base + f"/gpustatus/"
                               f"namespace/default/pod/{POD}",
                               headers={"X-Request-Id": rid})
        finally:
            master.close()
        report["gpustatus"] = body
        checks["gpustatus_names_the_holder"] = (
            code == 200 and isinstance(body, dict)
            and [(g["device_id"], g["busy_pids"]) for g in body["gpus"]]
            == [(gpu.uuid, [holder.pid])])
        checks["request_id_echoed"] = (isinstance(body, dict)
                                       and body.get("request_id") == rid)
        busy = stack.client.remove_gpu(POD, "default", [gpu.uuid])
        checks["busy_names_the_holder"] = (
            busy.result == pb.RemoveGPUResponse.GPUBusy
            and list(busy.busy_pids) == [holder.pid])
        forced = stack.client.remove_gpu(POD, "default", [gpu.uuid],
                                         force=True)
        report["holder_rc"] = holder.wait(timeout=60)
        side.set_pids([idle_side.pid])
        checks["forced_detach_kills_the_holder"] = (
            forced.result == ok_rm and report["holder_rc"] == -9)
        for box in (main, side):
            checks[f"{box.container}_left_clean"] = (
                box.nodes() == {} and gate_pairs(box) == set()
                and sorted(box.cgroup_lines("devices.deny")) == lines)
        checks["no_slave_pod_left"] = stack.slave_pods() == []

        # 4. the in-pod proof from the sidecar
        again = stack.client.add_gpu(POD, "default", 1)
        proof = spawn_proof(gpu)
        procs.append(proof)
        side.set_pids([idle_side.pid, proof.pid])
        line = proof.stdout.readline()
        try:
            report["in_pod"] = json.loads(line)
        except ValueError:
            report["in_pod"] = {"ok": False, "output": line[-2000:]}
        proof.stdin.close()
        report["in_pod"]["rc"] = proof.wait(timeout=120)
        side.set_pids([idle_side.pid])
        done = stack.client.remove_gpu(POD, "default")
        checks["in_pod_flash_fwd"] = (
            again.result == ok_add and done.result == ok_rm
            and report["in_pod"].get("ok") is True
            and report["in_pod"].get("launches", 0) > 0
            and report["in_pod"]["rc"] == 0)

        # 5. the storm over mTLS, its budgets, and the timed pairs
        def cycle(i: int) -> bool:
            a = stack.client.add_gpu(POD, "default", 1,
                                     request_id=f"storm-{i}")
            r = stack.client.remove_gpu(POD, "default", list(a.device_ids))
            return a.result == ok_add and r.result == ok_rm
        warm = all(cycle(i) for i in range(5))
        checks["handler_threads_started"] = _fill_handler_threads(
            stack, stack.settings.grpc_workers)
        fds0 = len(os.listdir("/proc/self/fd"))
        names0 = {t.name for t in threading.enumerate()}
        threads0 = threading.active_count()
        requests0 = stack.requests.snapshot()
        lists0 = stack.sim.podresources.list_calls
        resyncs0 = stack.informer.watch_restarts
        misses0 = stack.reads.status()["misses"]
        retries0 = REGISTRY.retry_attempts.value(target="apiserver")
        t0 = time.perf_counter()
        with retry_causes() as causes:
            storm_ok = all(cycle(i) for i in range(5, 5 + storm_cycles))
        storm_s = time.perf_counter() - t0
        deadline = time.monotonic() + 5.0
        while stack.service._event_queue and time.monotonic() < deadline:
            time.sleep(0.05)
        fds1 = len(os.listdir("/proc/self/fd"))
        threads1 = threading.active_count()
        requests = _delta(requests0, stack.requests.snapshot(),
                          per=storm_cycles)
        lists = (stack.sim.podresources.list_calls - lists0) / storm_cycles
        retries = (REGISTRY.retry_attempts.value(target="apiserver")
                   - retries0)
        report["storm"] = {
            "cycles": storm_cycles, "seconds": storm_s,
            "fds": [fds0, fds1], "threads": [threads0, threads1],
            "threads_grown": sorted({t.name for t in threading.enumerate()}
                                    - names0),
            "apiserver_per_pair": requests,
            "kubelet_lists_per_pair": lists,
            "informer_resyncs": stack.informer.watch_restarts - resyncs0,
            "cache_misses": stack.reads.status()["misses"] - misses0,
            "apiserver_retries": retries,
            "apiserver_retry_causes": causes}
        checks["storm_succeeds"] = warm and storm_ok
        checks["storm_fds"] = fds1 - fds0 <= FD_GROWTH
        checks["storm_threads"] = threads1 - threads0 <= THREAD_GROWTH
        checks["storm_lock_tables_empty"] = (
            stack.service._request_locks._entries == {}
            and stack.service._pod_locks._entries == {})
        checks["storm_event_queue_drained"] = \
            len(stack.service._event_queue) == 0
        checks["apiserver_budget"] = {
            k: v for k, v in requests.items()
            if not k.startswith("WATCH/")} == APISERVER_BUDGET
        checks["kubelet_budget"] = lists <= KUBELET_LISTS_PER_ATTACH

        plain_server, plain_port = build_server(
            stack.service, port=0, address="127.0.0.1",
            max_workers=stack.settings.grpc_workers, mode="parking",
            max_parked=stack.settings.grpc_max_parked)
        plain_server.start()
        closers.append(lambda: plain_server.stop(grace=0).wait())
        master = Master(stack, lambda target: WorkerClient(target, tls=tls))
        closers.append(master.close)
        plain_master = Master(stack, lambda target: WorkerClient(
            f"127.0.0.1:{plain_port}"))
        closers.append(plain_master.close)
        timing, pairs_ok = {}, True
        for label, m in (("mtls", master), ("plaintext", plain_master)):
            _pair(m.base)               # the channel's first use, untimed
            add_ms, rm_ms = [], []
            for _ in range(timed_pairs):
                a, r, ok = _pair(m.base)
                add_ms.append(a)
                rm_ms.append(r)
                pairs_ok = pairs_ok and ok
            timing[label] = {
                "addgpu_ms": _stats(add_ms), "removegpu_ms": _stats(rm_ms),
                "gateway_span_ms": {op: _trace_medians(op, timed_pairs)
                                    for op in ("addgpu", "removegpu")},
                "worker_span_ms": {op: _trace_medians(op, timed_pairs)
                                   for op in ("attach", "detach")}}
        report["timed_pairs"] = timing
        checks["timed_pairs_succeed"] = pairs_ok
        report["agent_fallbacks"] = _fallback_total() - fallbacks_before
        checks["agent_no_fallback"] = report["agent_fallbacks"] == 0
        report.update(card={"uuid": gpu.uuid, "node": gpu.device_path,
                            "majmin": list(own)},
                      companions=companions,
                      gate_backend=stack.gate.backend.name)
        return report
    finally:
        report["checks"] = checks
        report["ok"] = bool(checks) and all(checks.values())
        while closers:
            closers.pop()()
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
            proc.wait(timeout=60)
        if stack is not None:
            stack.close()
        shutil.rmtree(root, ignore_errors=True)
        report["phase_s"] = time.perf_counter() - t_phase

