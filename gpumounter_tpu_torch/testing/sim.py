"""A simulated single-node GPU cluster wired through the real control plane
(the port of :mod:`gpumounter_tpu.testing.sim`).

``ClusterSim`` glues the fakes into a behaving system: a FakeKubeClient whose
on_create hook plays the scheduler + NVIDIA device plugin (slave pods
requesting ``nvidia.com/gpu`` go Running and get free GPUs, by UUID,
assigned in the fake PodResources table; too few free GPUs ⇒ Unschedulable
condition), and whose on_delete hook releases the assignment — exactly the
control loop the real cluster runs for the allocator's slave-pod trick
(SURVEY.md §0). The GPUs are a fake enumerator's unless the caller passes
another (a real node's :class:`~gpumounter_tpu_torch.device.enumerator.
PyEnumerator`): the scheduler hands out whatever UUIDs it enumerates.

``WorkerRig`` adds the worker stack on a fixture host tree; ``LiveStack``
puts a real gRPC worker and a real HTTP master in front of it. The HA and
multi-node stacks (``MultiMasterStack``, ``MultiNodeStack``) arrive with
the planes they exercise (ROADMAP Queue 1 item 12).
"""

from __future__ import annotations

import os
import threading
import time

from gpumounter_tpu_torch.collector.collector import GPUCollector
from gpumounter_tpu_torch.collector.podresources import FakePodResourcesClient
from gpumounter_tpu_torch.device.enumerator import Enumerator
from gpumounter_tpu_torch.device.fake import FakeEnumerator, make_chips
from gpumounter_tpu_torch.k8s import objects
from gpumounter_tpu_torch.k8s.client import FakeKubeClient
from gpumounter_tpu_torch.utils import consts
from gpumounter_tpu_torch.utils.config import Settings


def make_target_pod(name="workload", namespace="default", node="node-a",
                    container_id="containerd://" + "ab" * 32, uid="uid-w"):
    return {
        "apiVersion": "v1",
        "kind": "Pod",
        "metadata": {"name": name, "namespace": namespace, "uid": uid,
                     "labels": {}},
        "spec": {"nodeName": node, "containers": [
            {"name": "main", "resources": {}}]},
        "status": {
            "phase": "Running",
            "qosClass": "BestEffort",
            "containerStatuses": [
                {"name": "main", "containerID": container_id}],
        },
    }


def make_gpu_node(name="node-a", accelerator="nvidia-h100-80gb", gpus=8):
    """A Node object with the GKE accelerator label + allocatable
    ``nvidia.com/gpu``, as the allocator's group rule reads it.
    ``accelerator=None`` gives a label-less node (no group rule)."""
    node = {
        "apiVersion": "v1",
        "kind": "Node",
        "metadata": {"name": name, "labels": {}},
        "status": {"allocatable": {consts.GPU_RESOURCE_NAME: str(gpus)}},
    }
    if accelerator is not None:
        node["metadata"]["labels"] = {
            consts.LABEL_GPU_ACCELERATOR: accelerator}
    return node


def worker_pod(node, ip, name="w1", grpc_port: int | None = None):
    """A Running gpu-mounter-worker pod as the master's discovery sees it.
    ``grpc_port`` sets the per-pod port-override annotation (local stacks
    run several workers on one IP)."""
    pod = {
        "metadata": {"name": name, "namespace": consts.WORKER_NAMESPACE,
                     "labels": {"app": "gpu-mounter-worker"}},
        "spec": {"nodeName": node},
        "status": {"phase": "Running", "podIP": ip},
    }
    if grpc_port is not None:
        from gpumounter_tpu_torch.master.discovery import PORT_ANNOTATION
        pod["metadata"]["annotations"] = {PORT_ANNOTATION: str(grpc_port)}
    return pod


class ClusterSim:
    """One node with ``n_chips`` fake GPUs (or the GPUs ``enumerator``
    names) and a scripted scheduler.

    ``kubelet_socket_path``: when set, the collector talks to a REAL gRPC
    unix-socket server (FakeKubeletServer) through the production
    KubeletPodResourcesClient instead of the in-memory fake — wire format
    and all; ``True`` binds it under a short temporary path. Call
    :meth:`close` to stop it. ``enumerator`` replaces the fake GPUs (a real
    node's enumerator: the scheduler hands out the UUIDs it names);
    ``kube`` replaces the fake cluster (one an HTTP facade serves).
    """

    def __init__(self, n_chips=4, node="node-a", schedule_delay_s=0.0,
                 settings: Settings | None = None,
                 kubelet_socket_path: str | bool | None = None,
                 kubelet_lag_s: float = 0.0,
                 enumerator: Enumerator | None = None,
                 kube: FakeKubeClient | None = None):
        self.node = node
        self.settings = settings or Settings()
        # the worker knows its node via the downward-API NODE_NAME env
        self.settings.node_name = self.settings.node_name or node
        self.enumerator = (enumerator if enumerator is not None
                           else FakeEnumerator(make_chips(n_chips)))
        self.podresources = FakePodResourcesClient()
        self.kube = kube if kube is not None else FakeKubeClient()
        self.schedule_delay_s = schedule_delay_s
        # When >0, the PodResources listing trails the Running transition by
        # this long — the real kubelet's asynchronous device-plugin
        # assignment (the allocator must tolerate it with bounded retries).
        self.kubelet_lag_s = kubelet_lag_s
        self._pending_assign: dict[tuple[str, str], list[str]] = {}
        self._lock = threading.Lock()
        self.kube.on_create.append(self._schedule)
        self.kube.on_delete.append(self._release)

        self._kubelet_server = None
        collector_client = self.podresources
        if kubelet_socket_path:
            from gpumounter_tpu_torch.collector.fake_kubelet import \
                FakeKubeletServer
            from gpumounter_tpu_torch.collector.podresources import \
                KubeletPodResourcesClient
            self._kubelet_server = FakeKubeletServer(
                None if kubelet_socket_path is True else kubelet_socket_path,
                self.podresources).start()
            collector_client = KubeletPodResourcesClient(
                self._kubelet_server.socket_path)
        self.collector = GPUCollector(
            self.enumerator, collector_client,
            resource_name=self.settings.resource_name,
            pool_namespace=self.settings.pool_namespace)

    def close(self) -> None:
        if self._kubelet_server is not None:
            self._kubelet_server.stop()
            self._kubelet_server = None

    # -- scripted control plane ------------------------------------------------

    def _free_uuids(self) -> list[str]:
        assigned = {
            device_id
            for containers in self.podresources.assignments.values()
            for resources in containers.values()
            for ids in resources.values()
            for device_id in ids}
        assigned |= {u for uuids in self._pending_assign.values()
                     for u in uuids}
        return [c.uuid for c in self.enumerator.enumerate()
                if c.uuid and c.uuid not in assigned]

    def _schedule(self, pod: objects.Pod) -> None:
        if self.schedule_delay_s:
            time.sleep(self.schedule_delay_s)
        want = objects.resource_limit(pod, self.settings.resource_name)
        if want <= 0:
            self.kube.set_pod_status(objects.namespace(pod),
                                     objects.name(pod), phase="Running")
            return
        key = (objects.namespace(pod), objects.name(pod))
        with self._lock:
            free = self._free_uuids()
            if len(free) < want:
                self.kube.set_pod_status(
                    objects.namespace(pod), objects.name(pod),
                    phase="Pending",
                    conditions=[{"type": "PodScheduled", "status": "False",
                                 "reason": "Unschedulable"}])
                return
            if self.kubelet_lag_s > 0:
                # reserve now, surface in PodResources only after the lag
                self._pending_assign[key] = free[:want]
                timer = threading.Timer(self.kubelet_lag_s,
                                        self._apply_pending, args=(key,))
                timer.daemon = True
                timer.start()
            else:
                self.podresources.assign(key[0], key[1], free[:want])
        self.kube.set_pod_status(
            objects.namespace(pod), objects.name(pod), phase="Running",
            conditions=[{"type": "PodScheduled", "status": "True"}])

    def _apply_pending(self, key: tuple[str, str]) -> None:
        with self._lock:
            uuids = self._pending_assign.pop(key, None)
        if uuids:
            self.podresources.assign(key[0], key[1], uuids)

    def _release(self, pod: objects.Pod) -> None:
        with self._lock:
            self._pending_assign.pop(
                (objects.namespace(pod), objects.name(pod)), None)
        self.podresources.unassign(objects.namespace(pod), objects.name(pod))

    # -- conveniences ----------------------------------------------------------

    def add_target_pod(self, **kwargs) -> objects.Pod:
        pod = make_target_pod(node=self.node, **kwargs)
        self.kube.put_pod(pod)
        return pod

    def slave_pods(self) -> list[objects.Pod]:
        return self.kube.list_pods(
            self.settings.pool_namespace,
            label_selector=(f"{consts.SLAVE_POD_LABEL_KEY}="
                            f"{consts.SLAVE_POD_LABEL_VALUE}"))


class WorkerRig:
    """A full worker stack over a ClusterSim and a tmp host fixture tree:
    real allocator + real mount façade + real cgroup(v1) controller.

    ``actuator``: "recording" (default — assertable test double) or
    "procroot" (real ProcRootActuator with fake device nodes under
    ``<proc_root>/<pid>/root/dev`` — the bench/verify configuration).

    The options are the control plane's rig's, less ``usage``/``topo``
    (the usage sampler and topology view are not ported yet).
    """

    def __init__(self, fake_host, n_chips=4, pid=4242, actuator="recording",
                 use_kubelet_socket=False, node="node-a",
                 pod_name="workload", schedule_delay_s=0.0,
                 kubelet_lag_s=0.0, warm_pool: dict[str, int] | None = None,
                 informer: bool = False, agent: bool = False,
                 gate=False, grpc_workers: int | None = None,
                 grpc_async: bool | None = None):
        from gpumounter_tpu_torch.actuation.cgroup import CgroupDeviceController
        from gpumounter_tpu_torch.actuation.mount import GPUMounter
        from gpumounter_tpu_torch.actuation.nsenter import (ProcRootActuator,
                                                            RecordingActuator)
        from gpumounter_tpu_torch.allocator import GPUAllocator
        from gpumounter_tpu_torch.k8s.informer import PodCacheReads, PodInformer
        from gpumounter_tpu_torch.worker.service import GPUMountService

        self.sim = ClusterSim(
            n_chips=n_chips, node=node, schedule_delay_s=schedule_delay_s,
            kubelet_lag_s=kubelet_lag_s,
            kubelet_socket_path=(fake_host.kubelet_socket
                                 if use_kubelet_socket else None))
        self.sim.settings.host = fake_host
        self.host = fake_host
        # gRPC executor knobs (the TPU_GRPC_WORKERS / TPU_GRPC_ASYNC
        # pair): carried on the rig's Settings so LiveStack's
        # grpc_workers=None / grpc_mode="settings" defaults read them —
        # the same Settings → server plumbing worker/main.py runs.
        if grpc_workers is not None:
            self.sim.settings.grpc_workers = grpc_workers
        if grpc_async is not None:
            self.sim.settings.grpc_async = grpc_async
        self.pod = self.sim.add_target_pod(name=pod_name)
        self.pod_name = pod_name
        self.pid = pid

        # container cgroup with one live PID
        self.cgroups = CgroupDeviceController(fake_host, driver="cgroupfs",
                                              version=1)
        cid = objects.container_ids(self.pod)[0]
        self.cgroup_dir = self.cgroups.container_dir(self.pod, cid)
        os.makedirs(self.cgroup_dir, exist_ok=True)
        with open(os.path.join(self.cgroup_dir, "cgroup.procs"), "w") as f:
            f.write(f"{pid}\n")
        os.makedirs(os.path.join(fake_host.proc_root, str(pid)),
                    exist_ok=True)

        self._actuator_kind = actuator
        # DrainController (worker/drain.py), attached by stacks that
        # exercise graceful drain (MultiNodeStack wires one per node).
        self.drain = None
        if actuator == "recording":
            self.actuator = RecordingActuator()
        elif actuator == "procroot":
            self.actuator = ProcRootActuator(fake_host, fake_nodes=True)
            os.makedirs(os.path.join(fake_host.proc_root, str(pid), "root",
                                     "dev"), exist_ok=True)
        else:
            raise ValueError(f"unknown actuator kind {actuator!r}")
        # Resident actuation agent (``agent=True``): the production
        # default wiring (worker/main.py) — cached ns handles + in-
        # process batch execution, with the rig's base actuator as the
        # fallback seam. Off by default so unit rigs keep patching the
        # single-op methods directly.
        self.agent = None
        if agent:
            from gpumounter_tpu_torch.actuation.agent import (
                AgentActuator, ResidentActuationAgent)
            self.agent = ResidentActuationAgent(
                fake_host, fake_nodes=(actuator == "procroot"))
            self.actuator = AgentActuator(self.agent, self.actuator)
        # Crash-safe attach journal path decided early: the gate journals
        # its mutations through the same file.
        from gpumounter_tpu_torch.worker.journal import AttachJournal
        self.sim.settings.journal_path = os.path.join(
            os.path.dirname(fake_host.proc_root), "attach-journal.jsonl")
        self.journal = AttachJournal(self.sim.settings.journal_path)
        # Kernel device gate (``gate="fake"``): every grant/revoke crosses
        # the DeviceGate seam over a FakeGateBackend — in-memory policy
        # maps + deny simulation playing the KERNEL (it survives a
        # simulated worker crash; ChaosRig.restart_worker keeps the
        # backend while rebuilding the service, exactly like live kernel
        # maps outliving the process). ``gate=<GateBackend>`` wires a
        # caller-built backend. Default off = the legacy passthrough —
        # byte-for-byte pre-gate semantics for rigs that predate it.
        self.gate = None
        self.gate_backend = None
        if gate:
            from gpumounter_tpu_torch.actuation.gate import (DeviceGate,
                                                             FakeGateBackend,
                                                             GateBackend)
            self.gate_backend = (gate if isinstance(gate, GateBackend)
                                 else FakeGateBackend())
            self.gate = DeviceGate(self.cgroups, self.gate_backend,
                                   journal=self.journal, mode="auto",
                                   node_name=node)
        self.mounter = GPUMounter(self.cgroups, self.actuator,
                                  self.sim.enumerator, fake_host,
                                  plans=self.sim.collector.plans,
                                  gate=self.gate)
        # Shared pod informer (``informer=True``): ONE list+watch over the
        # pool namespace serves every hot-path read — the production
        # default wiring (worker/main.py). Off by default so unit rigs
        # keep the historical direct-LIST behavior.
        self.informer = None
        reads = None
        if informer:
            self.informer = PodInformer(self.sim.kube,
                                        self.sim.settings.pool_namespace,
                                        watch_chunk_s=2.0,
                                        resync_backoff_s=0.05).start()
            reads = PodCacheReads(self.sim.kube, [self.informer])
        self.allocator = GPUAllocator(self.sim.collector, self.sim.kube,
                                      self.sim.settings, reads=reads)
        self.reads = self.allocator.reads
        # Warm pool (worker/pool.py): ``warm_pool={"entire:4": 1}`` keeps
        # one 4-GPU entire-mount slave pod pre-scheduled. The loop is NOT
        # started — tests drive scan_once() for determinism.
        self.pool = None
        if warm_pool:
            from gpumounter_tpu_torch.worker.pool import PoolManager
            self.sim.settings.warm_pool_sizes = dict(warm_pool)
            self.sim.settings.warm_pool_enabled = True
            self.pool = PoolManager(self.allocator, self.sim.kube,
                                    self.sim.settings)
        # Crash-safe attach journal on the fixture tree (created above,
        # before the gate) — enabled by default so every rig-driven
        # attach exercises the production write-ahead path; chaos tests
        # "restart the worker" by building a fresh service over the same
        # journal (testing/chaos.py).
        self.service = GPUMountService(self.allocator, self.mounter,
                                       self.sim.kube, self.sim.settings,
                                       pool=self.pool,
                                       journal=self.journal)

    def provision_container(self, pod: objects.Pod,
                            pid: int | None = None) -> dict[str, int]:
        """Create fixture cgroup dirs + one live PID per container of the
        pod (the rig's own target pod's first container is provisioned in
        __init__). Returns {container_id: pid}."""
        next_pid = pid or (self.pid + 1 + len(os.listdir(self.host.proc_root)))
        out: dict[str, int] = {}
        for cid in objects.container_ids(pod):
            cgroup_dir = self.cgroups.container_dir(pod, cid)
            os.makedirs(cgroup_dir, exist_ok=True)
            with open(os.path.join(cgroup_dir, "cgroup.procs"), "w") as f:
                f.write(f"{next_pid}\n")
            os.makedirs(os.path.join(self.host.proc_root, str(next_pid)),
                        exist_ok=True)
            if self._actuator_kind == "procroot":
                os.makedirs(os.path.join(self.host.proc_root, str(next_pid),
                                         "root", "dev"), exist_ok=True)
            out[cid] = next_pid
            next_pid += 1
        return out

    def fill_warm_pool(self, timeout_s: float = 30.0) -> None:
        """Drive pool reconciliation until every configured key holds its
        target count of Running (adoptable) warm pods."""
        assert self.pool is not None, "rig built without warm_pool="
        deadline = time.monotonic() + timeout_s
        while True:
            self.pool.scan_once()
            status = self.pool.status()
            if all(v["running"] >= v["target"]
                   for v in status["keys"].values()):
                return
            if time.monotonic() >= deadline:
                raise TimeoutError(f"warm pool not filled: {status}")
            time.sleep(0.05)

    def close(self) -> None:
        if self.agent is not None:
            self.agent.stop()
        if self.informer is not None:
            self.informer.stop()
        self.sim.close()


class LiveStack:
    """Real gRPC worker + real HTTP master over a WorkerRig, on localhost.
    ``base`` is the master's URL; close() tears everything down."""

    def __init__(self, rig: WorkerRig, broker_config=None,
                 shared_kube: bool = False,
                 grpc_workers: int | None = 8,
                 grpc_mode: str = "threadpool",
                 gateway_workers: int | None = None,
                 gateway_max_conns: int | None = None):
        from gpumounter_tpu_torch.master.admission import AttachBroker
        from gpumounter_tpu_torch.master.discovery import WorkerDirectory
        from gpumounter_tpu_torch.master.gateway import MasterGateway
        from gpumounter_tpu_torch.worker.grpc_server import build_server
        from gpumounter_tpu_torch.worker.main import start_health_server

        self.rig = rig
        # ``grpc_mode="parking"`` = the production worker executor
        # (worker/main.py TPU_GRPC_ASYNC default): grpc_workers becomes
        # the ACTIVE-thread budget, slow waits park. ``grpc_workers=None``
        # / ``grpc_mode="settings"`` defer to the rig's Settings (the
        # WorkerRig(grpc_workers=, grpc_async=) plumbing — exactly what
        # worker/main.py reads from env).
        if grpc_workers is None:
            grpc_workers = rig.sim.settings.grpc_workers
        if grpc_mode == "settings":
            grpc_mode = ("parking" if rig.sim.settings.grpc_async
                         else "threadpool")
        self.grpc_server, grpc_port = build_server(rig.service, port=0,
                                                   address="127.0.0.1",
                                                   max_workers=grpc_workers,
                                                   mode=grpc_mode)
        self.grpc_port = grpc_port
        self.grpc_server.start()
        # the worker's real health/metrics/tracez sidecar on an ephemeral
        # port (production convention is grpc_port + 1, which an
        # ephemeral gRPC bind can't honour) — the master's /tracez stitch
        # and fleet scrape resolve it through worker_tracez_base below.
        # The sidecar gets the state worker/main.py gives it, for this
        # server only.
        self.health_server = start_health_server(
            0, journal=rig.service.journal, cache=rig.service.reads,
            agent=rig.agent, gate=rig.gate, pool=rig.pool)
        health_port = self.health_server.server_port
        self.health_base = f"http://127.0.0.1:{health_port}"
        # ``shared_kube=True``: the master reads the SAME fake cluster the
        # worker mutates (slave pods visible), which broker restart
        # re-derivation needs; the default keeps the split-view topology.
        if shared_kube:
            self.master_kube = rig.sim.kube
        else:
            self.master_kube = FakeKubeClient()
            self.master_kube.put_pod(rig.pod)
        self.master_kube.put_pod(worker_pod(rig.sim.node, "127.0.0.1"))
        broker = (AttachBroker(self.master_kube, broker_config)
                  if broker_config is not None else None)
        self.gateway = MasterGateway(
            self.master_kube,
            WorkerDirectory(self.master_kube, grpc_port=grpc_port),
            worker_tracez_base=lambda target: self.health_base,
            broker=broker)
        self.http_server = self.gateway.serve(
            port=0, address="127.0.0.1", workers=gateway_workers,
            max_conns=gateway_max_conns)
        self.base = f"http://127.0.0.1:{self.http_server.server_port}"

    def close(self) -> None:
        self.http_server.shutdown()
        self.health_server.shutdown()
        self.grpc_server.stop(grace=0)
        self.rig.close()
