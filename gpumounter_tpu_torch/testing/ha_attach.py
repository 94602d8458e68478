"""A leader fail-over under a live attach, over HTTP, on one node, with the
proof inside the Pod.

:func:`run_ha_attach` puts TWO of the port's masters (replicas A and B) in
front of the worker that :mod:`.worker_attach` wires (its ``_Stack``: an
HTTP apiserver facade holding a GKE GPU node with one allocatable GPU, a
scripted scheduler behind a PodResources gRPC server, the v1 device gate,
the resident agent, a fixture container), around whatever enumerator the
caller passes (its first GPU). Each master is built as ``master/main.py`` builds it under
``TPU_MASTER_SHARDS=2 TPU_ELECTION=1 TPU_INTENT_STORE=1``: a
``MasterGateway`` with ``HAConfig.from_settings`` (the production renew and
TTL, 2 s and 6 s, group commit on, ``proxy`` forwarding) and its own REST
client on the facade, so the election locks and the store's ConfigMaps
cross HTTP like every other apiserver call. The broker queues
(``queue_timeout_s`` 20).

The run, each step checked by name:

1. both shards get a leader; the owner O of ``default``'s shard and the
   peer P are named;
2. ``GET /addgpu/...`` for ``workload`` sent to P is proxied to O and
   answered SUCCESS with the card's UUID; the lease record is in O's
   shard ConfigMap on the facade;
3. the in-pod proof (``spawn_proof``: on a card, ``flash_fwd`` in a child
   pinned to the UUID) holds the card, and ``POST /removegpu/...`` answers
   ``GPU_BUSY`` through both masters;
4. an attach for ``workload-2`` parks on O (the node's one GPU is held);
   its ``WaiterRecord`` is in the store;
5. O is killed with crash semantics (it stops serving and renewing and
   cleans up nothing); timed until P leads the shard with a bumped fence,
   has merged the lease and adopted the waiter;
6. once the proof exits, the detach of ``workload`` through P succeeds and
   the adopted waiter completes on the same UUID (one attach event, no
   double actuation); it is detached;
7. O comes back as a fresh replica and does not take the shard back while
   P renews;
8. ``cycles`` ``/addgpu`` + ``/removegpu`` pairs through the owner and as
   many through the non-owner (proxied), each with the median, min and
   max, the owner's span medians and the facade's ConfigMap and pod
   requests per pair;
9. ``/fleetz`` ``masters`` (roles, store lag) and the ``shard_forwards``
   counter are read;
10. the broker invariants with the store's clause, and zero agent
    fallbacks.
"""

from __future__ import annotations

import collections
import json
import shutil
import socket
import subprocess
import threading
import time
from collections.abc import Callable

from gpumounter_tpu_torch.device.enumerator import Enumerator
from gpumounter_tpu_torch.device.model import GPUDevice
from gpumounter_tpu_torch.testing.master_attach import _http
from gpumounter_tpu_torch.testing.slice_attach import OneGPU
from gpumounter_tpu_torch.testing.worker_attach import (CYCLES, IDLE, NODE,
                                                        _stats, _Stack,
                                                        spawn)
from gpumounter_tpu_torch.utils import consts

SHARDS = 2
QUEUE_TIMEOUT_S = 20.0
# The whole phase's budget (checked): the proof's CUDA start, a failover
# bounded by the TTL plus one renew, and the timed pairs.
BUDGET_S = 60.0
PARK_RID = "ha-park-1"


def _add(pod: str) -> str:
    return f"/addgpu/namespace/default/pod/{pod}/gpu/1/isEntireMount/true"


def _remove(pod: str) -> str:
    return f"/removegpu/namespace/default/pod/{pod}/force/false"


def _free_port() -> int:
    """A port the master can bind next: its URL goes into the election
    lock record before it serves, so peers can forward from the start."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _Master:
    """One master replica as ``master/main.py`` builds it with the HA plane
    on; :meth:`kill` is a crash (nothing released)."""

    def __init__(self, worker: _Stack, replica: str):
        from gpumounter_tpu_torch.k8s.client import InClusterKubeClient
        from gpumounter_tpu_torch.master.admission import (AttachBroker,
                                                           BrokerConfig)
        from gpumounter_tpu_torch.master.discovery import WorkerDirectory
        from gpumounter_tpu_torch.master.gateway import MasterGateway
        from gpumounter_tpu_torch.master.shardring import HAConfig
        from gpumounter_tpu_torch.utils.config import Settings

        port = _free_port()
        self.base = f"http://127.0.0.1:{port}"
        settings = Settings(
            master_shards=SHARDS, election_enabled=True,
            intent_store_enabled=True, replica_id=replica,
            advertise_url=self.base, shard_forward="proxy",
            store_group_commit_s=consts.DEFAULT_STORE_GROUP_COMMIT_S,
            queue_timeout_s=QUEUE_TIMEOUT_S)
        self.ha = HAConfig.from_settings(settings)
        self.kube = InClusterKubeClient(host=worker.facade.base,
                                        sa_dir=worker.sa_dir)
        self.gateway = MasterGateway(
            self.kube, WorkerDirectory(self.kube),
            # no worker health sidecar in this rig: no fleet scrape
            worker_tracez_base=lambda target: None,
            broker=AttachBroker(self.kube,
                                BrokerConfig.from_settings(settings)),
            ha=self.ha)
        self.http = self.gateway.serve(port=port, address="127.0.0.1")
        self.alive = True

    @property
    def election(self):
        return self.gateway.election

    @property
    def broker(self):
        return self.gateway.broker

    def kill(self) -> None:
        if self.alive:
            self.alive = False
            self.http.shutdown()


class _HAStack:
    """The worker, two masters, and the replica that comes back; close()
    stops every server and thread."""

    def __init__(self, root: str, enumerator: Enumerator):
        from gpumounter_tpu_torch.testing.sim import worker_pod
        self.worker = _Stack(root, enumerator)
        self.worker.kube.put_pod(worker_pod(NODE, "127.0.0.1",
                                            grpc_port=self.worker.port))
        self.masters = [_Master(self.worker, "master-a"),
                        _Master(self.worker, "master-b")]

    def restart(self, i: int) -> _Master:
        self.masters[i].kill()
        self.masters[i] = _Master(self.worker,
                                  self.masters[i].ha.replica)
        return self.masters[i]

    def close(self) -> None:
        for master in self.masters:
            master.kill()
        self.worker.close()


def _wait(predicate, timeout_s: float, step_s: float = 0.01) -> bool:
    deadline = time.monotonic() + timeout_s
    while True:
        if predicate():
            return True
        if time.monotonic() >= deadline:
            return False
        time.sleep(step_s)


def _requests_delta(before: dict, after: dict, per: int) -> dict:
    """Facade requests between two readings by ``VERB/resource`` (pods,
    nodes and the HA plane's configmaps), per pair."""
    out = {}
    for key, value in sorted(after.items()):
        if key[1] in ("pods", "nodes", "configmaps") \
                and value != before.get(key, 0):
            out[f"{key[0]}/{key[1]}"] = (value - before.get(key, 0)) / per
    return out


def _span_medians(op: str, rids: set[str]) -> dict[str, float]:
    """Median milliseconds of each span of the traces of ``op`` for
    ``rids`` that have spans: the owner's (a forwarding replica's trace of
    the same rid has none)."""
    from gpumounter_tpu_torch.utils.trace import STORE
    per: dict[str, list[float]] = collections.defaultdict(list)

    def walk(span: dict, prefix: str) -> None:
        for child in span.get("children", ()):
            path = prefix + child["name"]
            per[path].append(child["duration_ms"])
            walk(child, path + "/")
    for trace in STORE.recent(op=op, limit=8 * len(rids) + 64):
        if trace["rid"] in rids and trace["spans"].get("children"):
            walk(trace["spans"], "")
    return {path: _stats(values)["median"]
            for path, values in sorted(per.items())}


def _state_annotations(worker: _Stack, shard: int) -> dict:
    """The shard's state ConfigMap annotations as the facade holds them
    (none before its first write)."""
    from gpumounter_tpu_torch.utils.errors import K8sApiError
    try:
        cm = worker.kube.get_config_map(
            worker.settings.pool_namespace,
            f"{consts.STORE_CONFIGMAP_PREFIX}{shard}")
    except K8sApiError:
        return {}
    return dict(cm["metadata"].get("annotations") or {})


def _attached_events(worker: _Stack, pod: str) -> int:
    """The worker's attach events for ``pod`` (a fresh attach or the
    resume of an earlier attempt): one per actuation."""
    return sum(1 for e in worker.kube.events
               if e.get("reason") in ("GPUAttached", "GPUAttachResumed")
               and (e.get("involvedObject") or {}).get("name") == pod)


def _time_pairs(base: str, pod: str, cycles: int, tag: str
                ) -> tuple[bool, dict, set[str]]:
    times: dict[str, list[float]] = {"addgpu": [], "removegpu": []}
    ok = True
    rids = set()
    for i in range(cycles):
        rid = f"ha-{tag}-{i}"
        rids.add(rid)
        t0 = time.perf_counter()
        a = _http("GET", base + _add(pod), headers={"X-Request-Id": rid})
        t1 = time.perf_counter()
        r = _http("POST", base + _remove(pod), b"",
                  headers={"X-Request-Id": rid + "-rm"})
        t2 = time.perf_counter()
        ok = ok and a[0] == 200 and r[0] == 200
        times["addgpu"].append((t1 - t0) * 1e3)
        times["removegpu"].append((t2 - t1) * 1e3)
    return ok, {k: _stats(v) for k, v in times.items()}, rids


def run_ha_attach(root: str, enumerator: Enumerator,
                  spawn_proof: Callable[[GPUDevice], subprocess.Popen],
                  cycles: int = CYCLES) -> dict:
    """Drive the fail-over under ``root`` (removed first and afterwards).
    ``spawn_proof(gpu)`` starts the in-pod proof: a process that holds the
    GPU's node open, prints one JSON line (its ``ok``, ``launches`` and
    ``device_count``) and exits when its stdin closes. Returns the report
    with its ``checks``. The node is an ``a3-highgpu-1g`` view of the
    machine: the first of its GPUs."""
    from gpumounter_tpu_torch.actuation.agent import _fallback_total
    from gpumounter_tpu_torch.master.store import LeaseRecord, WaiterRecord
    from gpumounter_tpu_torch.testing.chaos import assert_broker_invariants
    from gpumounter_tpu_torch.utils.metrics import REGISTRY, parse_exposition

    shutil.rmtree(root, ignore_errors=True)
    t_phase = time.perf_counter()
    procs: list[subprocess.Popen] = []
    checks: dict[str, bool] = {}
    report: dict = {}
    stack = None
    fallbacks_before = _fallback_total()
    forwards_before = {o: REGISTRY.shard_forwards.value(mode="proxy",
                                                        outcome=o)
                       for o in ("ok", "error", "no_leader", "loop")}
    try:
        enumerator = OneGPU(enumerator)
        stack = _HAStack(root, enumerator)
        worker = stack.worker
        gpus = [d for d in enumerator.enumerate() if d.uuid]
        checks["node_has_one_gpu"] = len(gpus) == 1
        idle = spawn(IDLE)
        idle2 = spawn(IDLE)
        procs += [idle, idle2]
        box = worker.node.container("workload", [idle.pid])
        box2 = worker.node.container("workload-2", [idle2.pid])
        worker.add_target(box)
        worker.add_target(box2)

        # 1. both shards led; O owns default's shard, P is the peer
        t0 = time.perf_counter()
        ring_shard = stack.masters[0].gateway.ring.shard_of("default")
        led = _wait(lambda: all(
            any(m.election.is_leader(s) for m in stack.masters)
            for s in range(SHARDS)), 30.0)
        report["leaders_s"] = time.perf_counter() - t0
        checks["both_shards_led"] = led
        if not led:
            return report
        o = next(i for i, m in enumerate(stack.masters)
                 if m.election.is_leader(ring_shard))
        p = 1 - o
        owner, peer = stack.masters[o], stack.masters[p]
        report["owner"] = owner.ha.replica
        report["peer"] = peer.ha.replica
        report["shard"] = ring_shard
        fence0 = owner.election.token(ring_shard)
        report["fence_before"] = fence0
        checks["peer_routes_to_owner"] = _wait(
            lambda: (peer.election.leaders().get(ring_shard) or {}).get(
                "url") == owner.base, 10.0)

        # 2. the attach through P, proxied to O
        t0 = time.perf_counter()
        status, body = _http("GET", peer.base + _add("workload"))
        report["first_attach_ms"] = (time.perf_counter() - t0) * 1e3
        report["first_attach"] = body
        checks["proxied_attach_200_success"] = (
            status == 200 and isinstance(body, dict)
            and body.get("result") == "SUCCESS"
            and body.get("forwarded_shard") == ring_shard)
        ids = body.get("device_ids") if isinstance(body, dict) else None
        gpu = next((d for d in gpus if ids == [d.uuid]), None)
        checks["device_ids_are_the_uuid"] = gpu is not None
        if gpu is None:
            return report
        report["card"] = {"uuid": gpu.uuid, "node": gpu.device_path}
        checks["lease_on_the_owner_only"] = (
            [le.pod for le in owner.broker.leases.leases()] == ["workload"]
            and peer.broker.leases.leases() == [])
        lease_key = LeaseRecord(namespace="default", pod="workload",
                                tenant="default").annotation_key

        def lease_persisted():
            raw = _state_annotations(worker, ring_shard).get(lease_key)
            return raw is not None and \
                LeaseRecord.from_json(raw).uuids == [gpu.uuid]
        checks["lease_record_in_owner_shard_configmap"] = _wait(
            lease_persisted, 5.0)

        # 3. the in-pod proof holds the card: busy through both masters
        proof = spawn_proof(gpu)
        procs.append(proof)
        line = proof.stdout.readline()
        try:
            report["in_pod"] = json.loads(line)
        except ValueError:
            report["in_pod"] = {"ok": False, "output": line[-2000:]}
        in_pod = report["in_pod"]
        checks["in_pod_kernel_matches_plain"] = bool(in_pod.get("ok"))
        checks["in_pod_kernel_launched"] = in_pod.get("launches", 0) >= 1
        checks["in_pod_sees_one_gpu"] = in_pod.get("device_count") == 1
        box.set_pids([idle.pid, proof.pid])
        busy = [_http("POST", m.base + _remove("workload"), b"")
                for m in (owner, peer)]
        report["busy_detach"] = [b for _, b in busy]
        checks["busy_detach_409_through_both"] = all(
            s == 409 and isinstance(b, dict)
            and b.get("result") == "GPU_BUSY"
            and b.get("busy_pids") == [proof.pid] for s, b in busy)

        # 4. a second attach parks on O; its intent is in the store
        parked: dict = {}

        def park():
            try:
                parked["answer"] = _http(
                    "GET", owner.base + _add("workload-2"),
                    headers={"X-Request-Id": PARK_RID})
            except OSError as e:       # its master died under it
                parked["answer"] = ("dead-master", str(e))

        threading.Thread(target=park, daemon=True,
                         name="ha-attach-park").start()
        waiter_key = WaiterRecord(rid=PARK_RID, namespace="default",
                                  pod="workload-2",
                                  tenant="default").annotation_key
        checks["waiter_parked_on_owner"] = _wait(
            lambda: any(w.rid == PARK_RID for w in owner.broker._waiters),
            10.0)
        checks["waiter_record_in_store"] = _wait(
            lambda: waiter_key in _state_annotations(worker, ring_shard),
            5.0)

        # 5. kill O: crash semantics; time the take-over and the adoption
        t_kill = time.perf_counter()
        owner.kill()
        took_over = _wait(
            lambda: (peer.election.is_leader(ring_shard)
                     and (peer.election.token(ring_shard) or 0) > fence0),
            30.0)
        report["failover_s"] = time.perf_counter() - t_kill
        report["fence_after"] = peer.election.token(ring_shard)
        checks["peer_took_over_with_bumped_fence"] = took_over

        def merged_and_adopted():
            lease = peer.broker.leases.get("default", "workload")
            return (lease is not None and lease.uuids == {gpu.uuid}
                    and any(w.rid == PARK_RID
                            for w in peer.broker._waiters))
        checks["lease_merged_and_waiter_adopted"] = _wait(
            merged_and_adopted, 30.0)
        report["adopted_s"] = time.perf_counter() - t_kill

        # 6. the proof exits; the detach through P; the adopted waiter
        # completes on the same card
        proof.stdin.close()
        report["proof_rc"] = proof.wait(timeout=120)
        box.set_pids([idle.pid])
        status, done = _http("POST", peer.base + _remove("workload"), b"")
        checks["detach_through_peer_succeeds"] = (
            status == 200 and isinstance(done, dict)
            and done.get("result") == "SUCCESS")
        t0 = time.perf_counter()
        checks["adopted_waiter_completes_on_the_card"] = _wait(
            lambda: (peer.broker.leases.get("default", "workload-2")
                     or None) is not None
            and peer.broker.leases.get("default",
                                       "workload-2").uuids == {gpu.uuid},
            15.0)
        report["adopted_grant_ms"] = (time.perf_counter() - t0) * 1e3
        checks["adopted_attach_actuated_once"] = (
            _wait(lambda: _attached_events(worker, "workload-2") >= 1, 5.0)
            and _attached_events(worker, "workload-2") == 1
            and len(box2.nodes()) >= 1)
        checks["waiter_record_resolved"] = _wait(
            lambda: waiter_key not in _state_annotations(worker,
                                                         ring_shard), 5.0)
        status, done = _http("POST", peer.base + _remove("workload-2"), b"")
        checks["adopted_attach_detached"] = (
            status == 200 and isinstance(done, dict)
            and done.get("result") == "SUCCESS" and box2.nodes() == {}
            and worker.slave_pods() == [])
        report["parked_client"] = parked.get("answer")

        # 7. O comes back fresh and must not take the shard back
        token = peer.election.token(ring_shard)
        back = stack.restart(o)
        checks["restarted_replica_routes_to_peer"] = _wait(
            lambda: (back.election.leaders().get(ring_shard) or {}).get(
                "url") == peer.base, 10.0)

        # 8. timed pairs through the owner, then through the non-owner
        ms: dict = {}
        rq: dict = {}
        spans: dict = {}
        for tag, base in (("owner", peer.base), ("proxy", back.base)):
            before = worker.requests.snapshot()
            ok, ms[tag], rids = _time_pairs(base, "workload", cycles, tag)
            rq[tag] = _requests_delta(before, worker.requests.snapshot(),
                                      cycles)
            spans[tag] = {
                "addgpu": _span_medians("addgpu", rids),
                "removegpu": _span_medians(
                    "removegpu", {r + "-rm" for r in rids})}
            checks[f"cycles_through_{tag}_succeed"] = ok and box.nodes() == {}
        report.update(ms=ms, requests_per_pair=rq, phase_median_ms=spans)
        checks["no_takeback_while_peer_renews"] = (
            peer.election.is_leader(ring_shard)
            and peer.election.token(ring_shard) == token
            and not back.election.is_leader(ring_shard)
            and back.election.transitions == 0)

        # 9. the fleet view and the forward counter
        status, fleetz = _http("GET", peer.base + "/fleetz")
        masters = fleetz.get("masters", {}) if isinstance(fleetz, dict) \
            else {}
        report["fleetz_masters"] = masters
        roles = {s: v.get("leader") for s, v in
                 masters.get("election", {}).get("shards", {}).items()}
        checks["fleetz_peer_leads_every_shard"] = (
            masters.get("replica") == peer.ha.replica
            and roles == {str(s): True for s in range(SHARDS)})
        checks["fleetz_store_lag_zero"] = \
            masters.get("store", {}).get("lag_s") == 0.0
        metrics = parse_exposition(_http("GET", peer.base + "/metrics")[1])
        family = metrics.get("tpumounter_shard_forwards_total", {})
        report["shard_forwards_delta"] = {
            o_: family.get((("mode", "proxy"), ("outcome", o_)), 0.0) - v
            for o_, v in forwards_before.items()}
        # the proxied first attach, the busy detach through P, and each
        # proxied pair's attach and detach
        checks["shard_forwards_counted"] = (
            report["shard_forwards_delta"]["ok"] == 2 + 2 * cycles)

        # 10. invariants and the agent
        try:
            assert_broker_invariants(peer.broker, worker.sim,
                                     store=peer.broker.store)
            checks["broker_invariants_with_store"] = True
        except AssertionError as e:
            report["invariants_error"] = str(e)[:2000]
            checks["broker_invariants_with_store"] = False
        report["agent_fallbacks"] = _fallback_total() - fallbacks_before
        checks["agent_no_fallback"] = report["agent_fallbacks"] == 0
        report["seconds_in_phase"] = time.perf_counter() - t_phase
        checks["phase_within_budget"] = report["seconds_in_phase"] < BUDGET_S
        return report
    finally:
        report["checks"] = checks
        report["ok"] = bool(checks) and all(checks.values())
        for proc in procs:
            if proc.poll() is None:
                if proc.stdin is not None:
                    proc.stdin.close()
                proc.kill()
            proc.wait(timeout=60)
        if stack is not None:
            stack.close()
        shutil.rmtree(root, ignore_errors=True)
