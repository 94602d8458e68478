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
puts a real gRPC worker and a real HTTP master in front of it;
``MultiNodeStack`` puts N such workers (GKE GPU nodes) behind one master,
the multi-host slice topology; ``MultiMasterStack`` puts N HA masters
(election, intent store, shard forwarding) over one cluster and one
worker. ``MultiNodeStack`` carries the node-failure primitives (health
sidecars, spare pods, ``kill_node``/``restart_node``) and the
fragmentation primitive the defragmenter's suite drives (``fragment``).
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


def delete_slave_pods(clusters, namespace: str, pod: str) -> None:
    """Delete the slave pods owned by ``namespace/pod`` in every cluster of
    ``clusters`` (``(kube, pool namespace)`` pairs): the one apiserver a
    deployment has, for test stacks that split it per node. Deleting
    releases the scheduler reservation through the sim's on_delete hook,
    as the real control loop does."""
    selector = (f"{consts.OWNER_POD_LABEL_KEY}={pod},"
                f"{consts.OWNER_NAMESPACE_LABEL_KEY}={namespace}")
    for kube, pool in clusters:
        for slave in kube.list_pods(pool, label_selector=selector):
            kube.delete_pod(pool, objects.name(slave))


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

    @property
    def kubelet_server(self):
        """The PodResources gRPC server (None with the in-memory fake)."""
        return self._kubelet_server

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

    ``usage="fake"`` wires a usage sampler over a
    :class:`~gpumounter_tpu_torch.collector.usage.FakeUsageProbe` tests
    script (``rig.usage_probe.set_duty``); ``usage="gpu"`` the real
    :class:`~gpumounter_tpu_torch.collector.usage.GpuUsageProbe` (NVML,
    else open-fd detection). ``topo=True`` wires the /topoz view.
    """

    def __init__(self, fake_host, n_chips=4, pid=4242, actuator="recording",
                 use_kubelet_socket=False, node="node-a",
                 pod_name="workload", schedule_delay_s=0.0,
                 kubelet_lag_s=0.0, warm_pool: dict[str, int] | None = None,
                 informer: bool = False, agent: bool = False,
                 gate=False, grpc_workers: int | None = None,
                 grpc_async: bool | None = None, usage=False,
                 usage_interval_s: float = 0.25, topo: bool = False):
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
        # the container's /dev, empty: the gate reads the companion
        # baseline there before the first grant
        os.makedirs(os.path.join(fake_host.proc_root, str(pid), "root",
                                 "dev"), exist_ok=True)

        self._actuator_kind = actuator
        # DrainController (worker/drain.py), attached by stacks that
        # exercise graceful drain (MultiNodeStack wires one per node).
        self.drain = None
        if actuator == "recording":
            self.actuator = RecordingActuator()
        elif actuator == "procroot":
            self.actuator = ProcRootActuator(fake_host, fake_nodes=True)
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
            from gpumounter_tpu_torch.actuation.gate import (FakeGateBackend,
                                                             GateBackend)
            self.gate_backend = (gate if isinstance(gate, GateBackend)
                                 else FakeGateBackend())
        self.mounter = GPUMounter(self.cgroups, self.actuator,
                                  self.sim.enumerator, fake_host,
                                  plans=self.sim.collector.plans,
                                  gate=self._build_gate())
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
        # Usage sampler (collector/usage.py). The loop is NOT started —
        # tests drive ``sample_once()`` for determinism; stacks that
        # serve /utilz live call ``rig.usage.start()``.
        self.usage = None
        self.usage_probe = None
        if usage:
            from gpumounter_tpu_torch.collector.usage import (
                ChipUsageSampler, FakeUsageProbe, GpuUsageProbe,
                slave_owner_resolver)
            self.usage_probe = (GpuUsageProbe(fake_host, self.sim.enumerator)
                                if usage == "gpu" else FakeUsageProbe())
            self.usage = ChipUsageSampler(
                self.sim.collector, self.usage_probe,
                interval_s=usage_interval_s,
                pool_namespace=self.sim.settings.pool_namespace,
                node_name=node,
                owners_fn=slave_owner_resolver(
                    self.reads, self.sim.settings.pool_namespace,
                    service=self.service),
                refresh_inventory=True)
        # Topology snapshot view (collector/topology.py): the /topoz
        # payload builder over this rig's collector — labels from the
        # sim's node object, ownership resolved like the sampler's.
        # Snapshot-only; nothing to start or stop.
        self.topo = None
        if topo:
            from gpumounter_tpu_torch.collector.topology import (
                NodeTopologyView, node_topology_source)
            from gpumounter_tpu_torch.collector.usage import \
                slave_owner_resolver
            self.topo = NodeTopologyView(
                self.sim.collector,
                node_name=node,
                topology_fn=node_topology_source(self.sim.kube, node),
                owners_fn=slave_owner_resolver(
                    self.reads, self.sim.settings.pool_namespace,
                    service=self.service),
                pool_namespace=self.sim.settings.pool_namespace)

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
            os.makedirs(os.path.join(self.host.proc_root, str(next_pid),
                                     "root", "dev"), exist_ok=True)
            out[cid] = next_pid
            next_pid += 1
        return out

    def restart_worker(self) -> dict[str, int]:
        """A fresh worker process over this rig's surviving state: a fresh
        journal object over the same file, a fresh DeviceGate over the
        SAME backend (kernel maps survive a crash), a fresh service and
        its startup replay. Returns the replay outcome counts (the
        zombie-rejoin convergence)."""
        from gpumounter_tpu_torch.worker.journal import AttachJournal
        from gpumounter_tpu_torch.worker.service import GPUMountService
        self.journal = AttachJournal(self.sim.settings.journal_path)
        self.mounter.gate = self._build_gate()
        self.service = GPUMountService(self.allocator, self.mounter,
                                       self.sim.kube, self.sim.settings,
                                       pool=self.pool, journal=self.journal)
        return self.service.replay_journal()

    def _build_gate(self):
        """The worker's DeviceGate over this rig's journal: over the rig's
        gate backend (``rig.gate``), or the legacy passthrough a rig built
        without ``gate=`` runs (``rig.gate`` stays None). Both keep the
        companion baselines in the journal."""
        from gpumounter_tpu_torch.actuation.gate import DeviceGate
        if self.gate_backend is None:
            return DeviceGate(self.cgroups, None, journal=self.journal,
                              mode="legacy", node_name=self.sim.node)
        self.gate = DeviceGate(self.cgroups, self.gate_backend,
                               journal=self.journal, mode="auto",
                               node_name=self.sim.node)
        return self.gate

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
        if self.usage is not None:
            self.usage.stop()
        if self.agent is not None:
            self.agent.stop()
        if self.informer is not None:
            # the informer's thread waits in a watch until its chunk ends,
            # past stop()'s join: end the fake's streams first
            self.sim.kube.end_watches()
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
            agent=rig.agent, gate=rig.gate, pool=rig.pool, usage=rig.usage,
            topo=rig.topo)
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
        self.health_server.server_close()
        self.grpc_server.stop(grace=0)
        # gRPC does not own the executor it was given: its idle threads
        # would outlive the server
        self.grpc_server.executor.shutdown(wait=False)
        self.rig.close()


class MultiMasterStack:
    """N master gateways — each a REAL HTTP front with its own broker,
    election view and intent store — over ONE fake cluster and one live
    gRPC worker: the HA control-plane topology (docs/guide/HA.md).

    Every master shares the FakeKubeClient, so election locks and store
    records written by one replica are cluster state the others observe —
    exactly the production coordination medium, minus the network.
    :meth:`kill` has crash semantics (stop serving, stop renewing, clean
    up NOTHING: lock and intent records survive on the "cluster"), so a
    peer must take the shard over and drain the persisted waiters.
    """

    def __init__(self, rig: WorkerRig | None = None, masters: int = 2,
                 shards: int | None = None, broker_config=None,
                 store: bool = True, election: bool = True,
                 forward: str = "proxy",
                 renew_interval_s: float = 0.15,
                 lease_duration_s: float = 0.45,
                 rigs: list[WorkerRig] | None = None,
                 group_commit_s: float = 0.0):
        from gpumounter_tpu_torch.master.shardring import ShardRing
        from gpumounter_tpu_torch.worker.grpc_server import build_server

        # ``rigs=[...]``: N simulated GPU nodes behind the HA masters.
        # Each rig keeps its own fake cluster (its worker's slave pods
        # live there); the masters share a separate kube holding worker +
        # target pods and the election/store ConfigMaps, so broker state
        # recovery must come from the intent store. Single-rig (the
        # default) shares the rig's cluster.
        self.rigs = list(rigs) if rigs is not None else [rig]
        assert self.rigs and self.rigs[0] is not None
        self.rig = self.rigs[0]
        self.kube = (self.rig.sim.kube if rigs is None
                     else FakeKubeClient())
        self.shards = shards or masters
        self.ring = ShardRing(self.shards)
        self.broker_config = broker_config
        self.ha_args = dict(store=store, election=election, forward=forward,
                            renew_interval_s=renew_interval_s,
                            lease_duration_s=lease_duration_s,
                            group_commit_s=group_commit_s)
        self.grpc_servers = []
        for worker_rig in self.rigs:
            server, grpc_port = build_server(worker_rig.service, port=0,
                                             address="127.0.0.1")
            server.start()
            self.grpc_servers.append(server)
            self.kube.put_pod(worker_pod(
                worker_rig.sim.node, "127.0.0.1",
                name=f"w-{worker_rig.sim.node}", grpc_port=grpc_port))
            if rigs is not None:
                self.kube.put_pod(worker_rig.pod)
        self.grpc_server = self.grpc_servers[0]
        self.gateways = []
        self.http_servers = []
        self.bases: list[str] = []
        self.dead: set[int] = set()
        for i in range(masters):
            gateway, server, base = self._start_master(i)
            self.gateways.append(gateway)
            self.http_servers.append(server)
            self.bases.append(base)

    def _start_master(self, i: int):
        import dataclasses

        from gpumounter_tpu_torch.master.admission import AttachBroker
        from gpumounter_tpu_torch.master.discovery import WorkerDirectory
        from gpumounter_tpu_torch.master.gateway import MasterGateway
        from gpumounter_tpu_torch.master.shardring import HAConfig

        args = self.ha_args
        ha = HAConfig(
            shards=self.shards, election=args["election"],
            store=args["store"], replica=f"master-{i}",
            forward=args["forward"],
            renew_interval_s=args["renew_interval_s"],
            lease_duration_s=args["lease_duration_s"],
            namespace=self.rig.sim.settings.pool_namespace,
            # 0 (default) = the per-record CAS path; the group-commit
            # tests pass a real delay
            group_commit_delay_s=args["group_commit_s"])
        config = (dataclasses.replace(
            self.broker_config, quotas=dict(self.broker_config.quotas))
            if self.broker_config is not None else None)
        gateway = MasterGateway(
            self.kube, WorkerDirectory(self.kube),
            # no per-worker health sidecars in this stack: disable the
            # fleet scrape (and /tracez stitch) resolution
            worker_tracez_base=lambda target: None,
            broker=AttachBroker(self.kube, config), ha=ha)
        server = gateway.serve(port=0, address="127.0.0.1")
        base = f"http://127.0.0.1:{server.server_port}"
        # the ephemeral port exists only now: advertise it — the next
        # renew writes it into the lock record peers route by
        ha.advertise_url = base
        return gateway, server, base

    def live(self) -> list[int]:
        return [i for i in range(len(self.gateways))
                if i not in self.dead]

    def wait_converged(self, timeout_s: float = 10.0) -> None:
        """Block until every shard has a live leader whose advertised URL
        has propagated into every live replica's routing view."""
        deadline = time.monotonic() + timeout_s
        while True:
            owned = set()
            views_ok = True
            for i in self.live():
                election = self.gateways[i].election
                for shard in range(self.shards):
                    if election.is_leader(shard):
                        owned.add(shard)
                leaders = election.leaders()
                for shard in range(self.shards):
                    info = leaders.get(shard)
                    if not info or info.get("expired") \
                            or not info.get("url"):
                        views_ok = False
            if views_ok and owned == set(range(self.shards)):
                return
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"election never converged: owned={sorted(owned)} "
                    f"of {self.shards} shard(s)")
            time.sleep(0.03)

    def leader_for(self, namespace: str) -> int:
        """Index of the live master leading the namespace's shard."""
        shard = self.ring.shard_of(namespace)
        for i in self.live():
            if self.gateways[i].election.is_leader(shard):
                return i
        raise AssertionError(f"no live leader for shard {shard}")

    def kill(self, i: int) -> None:
        """Crash master ``i``: stop serving and stop every loop (incl.
        election renewal) but clean up NOTHING — its lock records simply
        expire and its store records await the next leader, exactly like
        a SIGKILL'd replica."""
        self.dead.add(i)
        self.http_servers[i].shutdown()

    def restart(self, i: int) -> None:
        """Bring master ``i`` back as a FRESH replica under the same
        identity (a Deployment restarting the pod): new broker, election
        view and store over the same cluster, on a new port."""
        assert i in self.dead, f"master {i} is still running"
        gateway, server, base = self._start_master(i)
        self.gateways[i] = gateway
        self.http_servers[i] = server
        self.bases[i] = base
        self.dead.discard(i)

    def close(self) -> None:
        for i in self.live():
            self.http_servers[i].shutdown()
            self.dead.add(i)
        for server in self.grpc_servers:
            server.stop(grace=0)
            server.executor.shutdown(wait=False)
        for rig in self.rigs:
            rig.close()


class MultiNodeStack:
    """N simulated GPU nodes (one WorkerRig + live gRPC worker each) behind
    ONE master — the multi-host slice topology. Node i is ``node-i``, a
    GKE node (``cloud.google.com/gke-accelerator: nvidia-h100-80gb``,
    ``n_chips`` allocatable ``nvidia.com/gpu``) holding pod
    ``workload-i``; the master reads the node objects, so a slice's
    ``gpusPerHost`` must be the whole host. ``accelerator=None`` builds
    label-less nodes instead, as the control plane's stack does: no group
    rule applies, and a slice member may take part of its host (what the
    defragmenter's suite fragments). ``usage``/``topo`` are
    :class:`WorkerRig`'s options for every node; with ``health=True`` the
    sidecars serve them.

    Node failure domain support: ``health=True`` gives each simulated
    worker its own real health sidecar (ephemeral port) — what the
    master's fleet aggregator scrapes and its node-health tracker judges;
    :meth:`kill_node` SIGKILLs a simulated worker (gRPC + health sidecar
    down, nothing cleaned up — the fleet scrape starts missing and the
    master's node-health machinery takes it from there);
    :meth:`restart_node` boots a fresh "worker process" over the same node
    state (same journal file, same gate backend, fresh servers). Because
    this stack keeps the production's ONE apiserver split across per-rig
    fakes (each rig's slave pods live in its own sim), the broker's fence
    cleanup is bridged to delete a fenced owner's slave pods in whichever
    rig's cluster holds them — exactly what the single production
    apiserver would do."""

    def __init__(self, hosts: list, n_chips=4, broker_config=None,
                 gate=False, health: bool = False, usage=False,
                 topo: bool = False,
                 accelerator: str | None = "nvidia-h100-80gb"):
        from gpumounter_tpu_torch.master.admission import AttachBroker
        from gpumounter_tpu_torch.master.discovery import WorkerDirectory
        from gpumounter_tpu_torch.master.gateway import MasterGateway
        from gpumounter_tpu_torch.worker.grpc_server import build_server

        self.rigs: list[WorkerRig] = []
        self.grpc_servers = []
        self.grpc_ports: list[int] = []
        self.health = health
        self.health_servers: list = []
        self._health_bases: dict[str, str] = {}
        self.dead_nodes: set[int] = set()
        self.master_kube = FakeKubeClient()
        for i, host in enumerate(hosts):
            rig = WorkerRig(host, n_chips=n_chips, node=f"node-{i}",
                            pod_name=f"workload-{i}", gate=gate,
                            usage=usage, topo=topo)
            node = make_gpu_node(name=f"node-{i}", accelerator=accelerator,
                                 gpus=n_chips)
            rig.sim.kube.put_node(node)
            self.master_kube.put_node(node)
            self._attach_drain(rig)
            self.rigs.append(rig)
            server, port = build_server(rig.service, port=0,
                                        address="127.0.0.1")
            server.start()
            self.grpc_servers.append(server)
            self.grpc_ports.append(port)
            self.health_servers.append(self._start_health(rig, port)
                                       if health else None)
            self.master_kube.put_pod(worker_pod(
                f"node-{i}", "127.0.0.1", name=f"w{i}", grpc_port=port))
            self.master_kube.put_pod(rig.pod)
        broker = (AttachBroker(self.master_kube, broker_config)
                  if broker_config is not None else None)
        self.gateway = MasterGateway(
            self.master_kube, WorkerDirectory(self.master_kube),
            worker_tracez_base=(self._health_bases.get if health
                                else None),
            broker=broker)
        # split-view bridge (see class docstring): fencing deletes the
        # owner's slave pods in the rig cluster that actually holds them
        self.gateway.broker.fence_cleanup = self._fence_cleanup
        self.http_server = self.gateway.serve(port=0, address="127.0.0.1")
        self.base = f"http://127.0.0.1:{self.http_server.server_port}"

    @staticmethod
    def _attach_drain(rig: WorkerRig) -> None:
        from gpumounter_tpu_torch.worker.drain import DrainController
        rig.drain = DrainController(rig.sim.node)
        rig.drain.register_flush(rig.service.flush_mesh_generation)
        rig.service.drain = rig.drain

    def _start_health(self, rig: WorkerRig, grpc_port: int):
        from gpumounter_tpu_torch.worker.main import start_health_server
        hs = start_health_server(0, journal=rig.journal,
                                 cache=rig.service.reads, gate=rig.gate,
                                 drain=rig.drain, usage=rig.usage,
                                 topo=rig.topo, ready=True)
        self._health_bases[f"127.0.0.1:{grpc_port}"] = \
            f"http://127.0.0.1:{hs.server_port}"
        return hs

    # -- workload / spare provisioning -----------------------------------------

    def add_workload(self, i: int, name: str,
                     spare: bool = False) -> objects.Pod:
        """A second workload pod on node ``i``, provisioned (cgroup +
        live pid) and visible to BOTH the master and the node's worker.
        ``spare=True`` labels it as a slice-repair spare
        (``tpumounter.io/slice-spare=true``) — what self-healing grows
        a broken gang onto."""
        rig = self.rigs[i]
        pod = rig.sim.add_target_pod(
            name=name, uid=f"uid-{name}",
            container_id="containerd://" + (f"{i:02x}" * 32)[:64])
        if spare:
            pod["metadata"]["labels"][consts.SLICE_SPARE_LABEL_KEY] = \
                consts.SLICE_SPARE_LABEL_VALUE
            rig.sim.kube.put_pod(pod)
        rig.provision_container(pod)
        self.master_kube.put_pod(pod)
        return pod

    def fragment(self, chips: list[int],
                 idle: tuple[int, ...] = ()) -> dict[int, str]:
        """Deterministically fragment the fleet: node ``i``'s
        ``workload-i`` becomes a single-pod slice GROUP holding
        ``chips[i]`` GPUs (0 = leave the node untouched), and nodes in
        ``idle`` get the idle stamp on their lease — the shape the defrag
        suite needs (group leases are the only thing the defragmenter may
        move, idleness its hardest interlock). On labelled nodes a member
        must fill its host (``chips[i]`` = ``n_chips``). Returns ``{i:
        group}`` for the attached nodes."""
        import json as json_mod
        out: dict[int, str] = {}
        for i, n in enumerate(chips):
            if not n:
                continue
            body = json_mod.dumps({
                "pods": [{"namespace": "default",
                          "pod": f"workload-{i}"}],
                "gpusPerHost": n}).encode()
            status, payload = self.gateway.handle(
                "POST", "/addgpuslice", body)
            assert status == 200 and payload["result"] == "SUCCESS", \
                (status, payload)
            out[i] = payload["group"]
        for i in idle:
            lease = self.gateway.broker.leases.get(
                "default", f"workload-{i}")
            assert lease is not None, f"no lease to idle on node-{i}"
            lease.idle_since_unix = time.time()
        return out

    # -- node failure primitives -----------------------------------------------

    def kill_node(self, i: int) -> None:
        """SIGKILL node ``i``'s worker: gRPC server and health sidecar
        go down mid-steady-state, nothing is cleaned up — its journal
        file, gate backend and cluster state stay exactly as the crash
        left them (restart_node boots over them)."""
        self.dead_nodes.add(i)
        self.grpc_servers[i].stop(grace=0)
        hs = self.health_servers[i] if self.health else None
        if hs is not None:
            hs.shutdown()
            # close the LISTENING socket too: shutdown() only stops the
            # serve loop, leaving the backlog accepting connections that
            # never answer — a dead process refuses instantly, and the
            # fleet scrape must see that, not a 3s read timeout per tick
            hs.server_close()

    def restart_node(self, i: int) -> dict[str, int]:
        """Boot a fresh "worker process" over node ``i``'s surviving
        state (``WorkerRig.restart_worker``: journal replay, the gate over
        the same backend), then fresh gRPC + health servers on new ports,
        announced to the master. Returns the replay outcome counts."""
        from gpumounter_tpu_torch.worker.grpc_server import build_server
        rig = self.rigs[i]
        outcomes = rig.restart_worker()
        self._attach_drain(rig)
        server, port = build_server(rig.service, port=0,
                                    address="127.0.0.1")
        server.start()
        self.grpc_servers[i] = server
        self.grpc_ports[i] = port
        if self.health:
            self.health_servers[i] = self._start_health(rig, port)
        self.master_kube.put_pod(worker_pod(
            f"node-{i}", "127.0.0.1", name=f"w{i}", grpc_port=port))
        self.gateway.directory.invalidate(f"node-{i}")
        # force the directory to see the restarted worker NOW: the TTL
        # refresh would take up to 15 wall-clock seconds, which manual-
        # tick tests do not have
        self.gateway.directory._refresh()
        # the fleet's scrape breaker opened against the dead sidecar;
        # the restarted one lives at a NEW address, so the failure
        # history is the dead incarnation's — drop it so recovery is
        # immediate
        with self.gateway.fleet._lock:
            self.gateway.fleet._breakers.pop(f"node-{i}", None)
        self.dead_nodes.discard(i)
        return outcomes

    def _fence_cleanup(self, namespace: str, pod: str) -> None:
        delete_slave_pods([(rig.sim.kube, rig.sim.settings.pool_namespace)
                           for rig in self.rigs], namespace, pod)

    def close(self) -> None:
        self.gateway.fleet.stop()
        self.gateway.broker.stop()
        self.http_server.shutdown()
        for server in self.health_servers:
            if server is None:
                continue
            try:
                server.shutdown()
            except Exception:       # noqa: BLE001 — may be dead mid-test
                pass
        for i, server in enumerate(self.grpc_servers):
            if i not in self.dead_nodes:
                server.stop(grace=0)
        for rig in self.rigs:
            rig.close()
