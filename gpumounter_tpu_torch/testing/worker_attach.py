"""The worker half of an attach, over real sockets, on one node.

:func:`run_worker_attach` wires the worker the way ``worker/main.py``'s
``build_stack`` does, around whatever enumerator the caller passes (a card
machine's real ``/dev`` and NVML, or fake GPUs on a CPU):

- an HTTP apiserver facade (:class:`~.http_apiserver.HttpApiserver`) serves
  a :class:`~gpumounter_tpu_torch.k8s.client.FakeKubeClient` holding the
  target pod and a GKE GPU node (``cloud.google.com/gke-accelerator``,
  allocatable ``nvidia.com/gpu``); the worker talks to it through a REST
  client (``InClusterKubeClient`` on the facade's URL: no kubeconfig, so
  no PyYAML) and one shared informer;
- a scripted scheduler (:class:`~.sim.ClusterSim`) answers each slave pod's
  creation by assigning a free GPU's UUID through a real PodResources gRPC
  server on a short unix socket, which the production
  ``KubeletPodResourcesClient`` reads;
- the container is a :class:`~.node_fixture.FixtureNode` container
  (cgroup v1, fake nodes with ``.majmin`` sidecars: the tree may sit on a
  filesystem that refuses mknod), actuated by the resident agent with the
  procroot actuator as its fallback, through the v1 device gate, journaled;
- the service is served by ``build_server`` (parking executor) and driven
  by ``WorkerClient`` over gRPC.

It then attaches one GPU, refuses the detach while ``spawn_holder``'s
process holds the GPU's node, detaches after it exits, checks that a
container which held the companions before keeps them, and times
``cycles`` attach/detach pairs. Every check is reported by name; the
caller decides what failing means.
"""

from __future__ import annotations

import collections
import copy
import os
import shutil
import subprocess
import sys
import threading
import time
from collections.abc import Callable

from gpumounter_tpu_torch.device.enumerator import Enumerator
from gpumounter_tpu_torch.device.model import GPUDevice
from gpumounter_tpu_torch.utils import consts

NODE = "gpu-node-0"
ACCELERATOR = "nvidia-h100-80gb"
CYCLES = 20
# A process that lives until its stdin closes.
IDLE = "import sys; sys.stdin.read()"
# A process that holds a CUDA context (and so the GPU's node) until its
# stdin closes.
CUDA_HOLDER = ("import sys, torch; torch.zeros(1, device='cuda'); "
               "torch.cuda.synchronize(); print('ready', flush=True); "
               "sys.stdin.read()")


def spawn(code: str) -> subprocess.Popen:
    """A child running ``code`` with a pipe on its stdin and stdout."""
    return subprocess.Popen([sys.executable, "-c", code],
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                            text=True)


def cuda_holder(gpu: GPUDevice) -> subprocess.Popen:
    """A child holding a CUDA context on the card; returns once it says it
    is ready (raises if it never does)."""
    del gpu
    import select
    proc = spawn(CUDA_HOLDER)
    # a child stuck in CUDA's init must not hang the caller
    if not select.select([proc.stdout], [], [], 300)[0] \
            or proc.stdout.readline().strip() != "ready":
        proc.kill()
        proc.wait(timeout=60)
        raise RuntimeError("the CUDA holder never became ready")
    return proc


def _stats(values: list[float]) -> dict:
    ordered = sorted(values)
    return {"median": ordered[len(ordered) // 2], "min": ordered[0],
            "max": ordered[-1], "n": len(ordered)}


class _RequestCounter:
    """The facade's fault hook, used to count: every HTTP request the
    apiserver receives, by (verb, resource)."""

    def __init__(self):
        self.counts: collections.Counter = collections.Counter()
        self._lock = threading.Lock()

    def fire(self, verb: str, resource: str) -> None:
        with self._lock:
            self.counts[(verb, resource)] += 1

    def snapshot(self) -> dict[tuple[str, str], int]:
        with self._lock:
            return dict(self.counts)


def _delta(before: dict, after: dict, per: int = 1) -> dict[str, float]:
    """Apiserver requests (pods and nodes) between two readings, by
    ``VERB/resource``, divided by ``per``."""
    out = {}
    for key, value in sorted(after.items()):
        if key[1] in ("pods", "nodes") and value != before.get(key, 0):
            out[f"{key[0]}/{key[1]}"] = (value - before.get(key, 0)) / per
    return out


def _phase_medians(op: str, n: int) -> dict[str, float]:
    """Median milliseconds of each span (``parent/child`` paths) over the
    last ``n`` traces of ``op`` the worker recorded (utils/trace.py)."""
    from gpumounter_tpu_torch.utils.trace import STORE
    per: dict[str, list[float]] = collections.defaultdict(list)

    def walk(span: dict, prefix: str) -> None:
        for child in span.get("children", ()):
            path = prefix + child["name"]
            per[path].append(child["duration_ms"])
            walk(child, path + "/")
    for trace in STORE.recent(op=op, limit=n):
        walk(trace["spans"], "")
    return {path: _stats(values)["median"]
            for path, values in sorted(per.items())}


def _host_majmin(path: str, major: int, minor: int) -> tuple[int, int]:
    """The host node's (major, minor) from its ``st_rdev`` where the node
    is a char device on this machine, else the device model's."""
    try:
        st = os.stat(path)
    except OSError:
        return major, minor
    import stat
    if not stat.S_ISCHR(st.st_mode):
        return major, minor
    return os.major(st.st_rdev), os.minor(st.st_rdev)


def _target_pod(box) -> dict:
    """The Pod object of a fixture container, Running on :data:`NODE`."""
    pod = copy.deepcopy(box.pod)
    pod.update(apiVersion="v1", kind="Pod")
    pod["metadata"]["labels"] = {}
    pod["spec"]["nodeName"] = NODE
    pod["status"]["phase"] = "Running"
    return pod


class _Stack:
    """The wired worker (see the module docstring); :meth:`close` stops
    every server and thread it started. ``watch_chunk_s`` shortens the
    informer's watch requests (the informer's default otherwise); ``tls``
    (a ``worker.grpc_server.TlsConfig``) serves the worker over TLS and
    dials it with the same material, as ``worker/main.py`` and
    ``master/main.py`` do from ``TPU_MOUNTER_TLS_*``."""

    def __init__(self, root: str, enumerator: Enumerator,
                 watch_chunk_s: float | None = None, tls=None):
        from gpumounter_tpu_torch.allocator import GPUAllocator
        from gpumounter_tpu_torch.k8s.client import (FakeKubeClient,
                                                     InClusterKubeClient)
        from gpumounter_tpu_torch.k8s.informer import (PodCacheReads,
                                                       PodInformer)
        from gpumounter_tpu_torch.testing.http_apiserver import HttpApiserver
        from gpumounter_tpu_torch.testing.node_fixture import FixtureNode
        from gpumounter_tpu_torch.testing.sim import ClusterSim, make_gpu_node
        from gpumounter_tpu_torch.utils.config import Settings

        self._closers: list[Callable[[], object]] = []
        self.tls = tls
        self.settings = Settings(node_name=NODE)
        self.node = FixtureNode(root)
        self.settings.host = self.node.host
        gpus = [d for d in enumerator.enumerate() if d.uuid]
        self.kube = FakeKubeClient()
        self.kube.put_node(make_gpu_node(NODE, ACCELERATOR, gpus=len(gpus)))
        self.facade = HttpApiserver(self.kube)
        self.requests = _RequestCounter()
        self.facade.faults = self.requests
        self._closers.append(self.facade.close)
        self.sa_dir = os.path.join(root, "serviceaccount")
        os.makedirs(self.sa_dir)
        with open(os.path.join(self.sa_dir, "token"), "w") as f:
            f.write("worker-attach")
        self.rest = InClusterKubeClient(host=self.facade.base,
                                        sa_dir=self.sa_dir)
        self.sim = ClusterSim(node=NODE, settings=self.settings,
                              kubelet_socket_path=True,
                              enumerator=enumerator, kube=self.kube)
        self._closers.append(self.sim.close)
        self.informer = PodInformer(
            self.rest, self.settings.pool_namespace,
            **({} if watch_chunk_s is None
               else {"watch_chunk_s": watch_chunk_s})).start()
        self._closers.append(self.informer.stop)
        self.reads = PodCacheReads(
            self.rest, [self.informer],
            fence_timeout_s=self.settings.informer_fence_timeout_s)
        self.allocator = GPUAllocator(self.sim.collector, self.rest,
                                      self.settings, reads=self.reads)
        self.enumerator = enumerator
        self.journal_path = os.path.join(root, "attach-journal.jsonl")
        self._worker_closers: list[Callable[[], object]] = []
        self.boot_replay = self.start_worker()

    def start_worker(self) -> dict[str, int]:
        """Boot the worker process's own objects over the node's surviving
        state: the journal object over the journal file, the device gate
        (``build_gate``: the v1 backend), the resident agent with the
        procroot actuator as its fallback, the mounter, the service and
        its startup replay, the gRPC server and a client. Returns the
        replay outcome counts; ``boot_ms`` splits the boot's time."""
        from gpumounter_tpu_torch.actuation.agent import (
            AgentActuator, ResidentActuationAgent)
        from gpumounter_tpu_torch.actuation.gate import build_gate
        from gpumounter_tpu_torch.actuation.mount import GPUMounter
        from gpumounter_tpu_torch.actuation.nsenter import ProcRootActuator
        from gpumounter_tpu_torch.worker.grpc_server import (WorkerClient,
                                                             build_server)
        from gpumounter_tpu_torch.worker.journal import AttachJournal
        from gpumounter_tpu_torch.worker.service import GPUMountService

        t0 = time.perf_counter()
        self.journal = AttachJournal(self.journal_path)
        self.gate = build_gate(self.settings, self.node.controller,
                               journal=self.journal)
        self.agent = ResidentActuationAgent(self.node.host, fake_nodes=True)
        self._worker_closers.append(self.agent.stop)
        actuator = AgentActuator(
            self.agent, ProcRootActuator(self.node.host, fake_nodes=True))
        self.mounter = GPUMounter(self.node.controller, actuator,
                                  self.enumerator, self.node.host,
                                  plans=self.sim.collector.plans,
                                  gate=self.gate)
        self.service = GPUMountService(self.allocator, self.mounter,
                                       self.rest, self.settings,
                                       journal=self.journal)
        t1 = time.perf_counter()
        replay = self.service.replay_journal()
        t2 = time.perf_counter()
        self.server, port = build_server(
            self.service, port=0, address="127.0.0.1",
            max_workers=self.settings.grpc_workers, mode="parking",
            max_parked=self.settings.grpc_max_parked, tls=self.tls)
        self.server.start()
        self._worker_closers.append(
            lambda server=self.server: server.stop(grace=0).wait())
        self.port = port
        self.client = WorkerClient(f"127.0.0.1:{port}", timeout_s=120.0,
                                   tls=self.tls)
        self._worker_closers.append(self.client.close)
        # host clock of the boot: the objects, the replay, the serving
        self.boot_ms = {"objects": (t1 - t0) * 1e3,
                        "replay": (t2 - t1) * 1e3,
                        "serve": (time.perf_counter() - t2) * 1e3}
        return replay

    def stop_worker(self) -> None:
        """The worker process dies: its gRPC server, client and agent
        stop; nothing is cleaned up."""
        while self._worker_closers:
            self._worker_closers.pop()()

    def add_target(self, box) -> dict:
        pod = _target_pod(box)
        self.kube.put_pod(pod)
        return pod

    def slave_pods(self) -> list[dict]:
        return self.kube.list_pods(
            self.settings.pool_namespace,
            label_selector=(f"{consts.SLAVE_POD_LABEL_KEY}="
                            f"{consts.SLAVE_POD_LABEL_VALUE}"))

    def close(self) -> None:
        self.stop_worker()
        for close in reversed(self._closers):
            close()


def run_worker_attach(root: str, enumerator: Enumerator,
                      spawn_holder: Callable[[GPUDevice], subprocess.Popen],
                      cycles: int = CYCLES) -> dict:
    """Drive the worker half of an attach under ``root`` (removed first and
    afterwards); ``spawn_holder(gpu)`` starts a process that holds the
    GPU's node open. Returns the report with its ``checks``."""
    from gpumounter_tpu_torch.actuation.agent import _fallback_total
    from gpumounter_tpu_torch.api import gpu_mount_pb2 as pb

    shutil.rmtree(root, ignore_errors=True)
    procs: list[subprocess.Popen] = []
    checks: dict[str, bool] = {}
    report: dict = {}
    stack = None
    fallbacks_before = _fallback_total()
    try:
        stack = _Stack(root, enumerator)
        gpus = [d for d in enumerator.enumerate() if d.uuid]
        checks["node_has_a_gpu"] = bool(gpus)
        idle, idle_held = spawn(IDLE), spawn(IDLE)
        procs += [idle, idle_held]
        box = stack.node.container("workload", [idle.pid],
                                   held=[("/dev/null", 1, 3)])
        pod = stack.add_target(box)

        # attach over gRPC
        before = stack.requests.snapshot()
        t0 = time.perf_counter()
        resp = stack.client.add_gpu("workload", "default", 1)
        report["first_attach_ms"] = (time.perf_counter() - t0) * 1e3
        report["round_trips_first_attach"] = _delta(
            before, stack.requests.snapshot())
        checks["add_success"] = resp.result == pb.AddGPUResponse.Success
        gpu = next((d for d in gpus if list(resp.device_ids) == [d.uuid]),
                   None)
        checks["device_ids_are_the_uuid"] = gpu is not None
        if gpu is None:
            report["device_ids"] = list(resp.device_ids)
            return report
        checks["device_paths_are_the_gpu_node"] = \
            list(resp.device_paths) == [f"/dev/nvidia{gpu.minor}"]
        slaves = stack.slave_pods()
        checks["one_slave_pod"] = len(slaves) == 1
        if slaves:
            spec, meta = slaves[0]["spec"], slaves[0]["metadata"]
            res = spec["containers"][0]["resources"]
            labels = meta["labels"]
            checks["slave_pod_spec"] = (
                res["limits"] == {consts.GPU_RESOURCE_NAME: "1"}
                and res["requests"] == {consts.GPU_RESOURCE_NAME: "1"}
                and spec["nodeSelector"] == {"kubernetes.io/hostname": NODE}
                and spec["tolerations"] == [{
                    "key": consts.GPU_RESOURCE_NAME, "operator": "Exists",
                    "effect": "NoSchedule"}]
                and labels[consts.SLAVE_POD_LABEL_KEY] == "gpu-pool"
                and labels[consts.GPU_ACCELERATOR_LABEL_KEY] == ACCELERATOR)
            # the owner: its labels always; an ownerReference only where
            # the pool namespace is the owner's (the GC ignores
            # cross-namespace references)
            checks["slave_pod_owner"] = (
                labels[consts.OWNER_POD_LABEL_KEY] == "workload"
                and labels[consts.OWNER_NAMESPACE_LABEL_KEY] == "default"
                and labels[consts.OWNER_UID_LABEL_KEY]
                == pod["metadata"]["uid"]
                and meta["ownerReferences"]
                == stack.allocator.owner_references(pod))
            report["slave_pod"] = {"name": meta["name"],
                                   "labels": labels,
                                   "owner_references":
                                       meta["ownerReferences"],
                                   "spec": spec}
        companions = {os.path.basename(c.host_path):
                      _host_majmin(c.host_path, c.major, c.minor)
                      for c in gpu.companions}
        own = _host_majmin(gpu.device_path, gpu.major, gpu.minor)
        granted = {own, *companions.values()}
        expect = {os.path.basename(gpu.device_path): own, **companions,
                  "null": (1, 3)}
        key = stack.node.controller.container_dir(pod, box.container_id)

        def gate_pairs() -> set:
            live, _opens, _denies = stack.gate.backend.read(key)
            return {(k[1], k[2]) for k in live}

        lines = sorted(f"c {a}:{b} rw" for a, b in granted)
        checks["gate_holds_gpu_and_companions"] = (
            gate_pairs() == granted
            and sorted(box.cgroup_lines("devices.allow")) == lines)
        checks["nodes_match_host_rdev"] = box.nodes() == expect
        records = stack.journal.snapshot()["records"]
        checks["journal_committed"] = (
            stack.journal.backlog() == 0
            and any(r.get("devices") == [gpu.uuid]
                    and r["state"] == "committed" for r in records))
        status = stack.client.gpu_status("workload", "default")
        checks["gpu_status"] = (
            status.mount_type == consts.MountType.SINGLE.value
            and [(g.device_id, g.device_path) for g in status.gpus]
            == [(gpu.uuid, f"/dev/nvidia{gpu.minor}")])
        node_view = {g.device_id: g for g in
                     stack.client.node_status().gpus}
        checks["node_status"] = (
            node_view[gpu.uuid].state == "ALLOCATED"
            and node_view[gpu.uuid].accelerator == ACCELERATOR)

        # busy: a process of the container holds the GPU's node
        holder = spawn_holder(gpu)
        procs.append(holder)
        box.set_pids([idle.pid, holder.pid])
        busy = stack.client.remove_gpu("workload", "default", [gpu.uuid])
        checks["busy_detach_refused"] = (
            busy.result == pb.RemoveGPUResponse.GPUBusy
            and list(busy.busy_pids) == [holder.pid])
        checks["busy_detach_left_everything"] = (
            box.nodes() == expect and gate_pairs() == granted
            and len(stack.slave_pods()) == 1)
        holder.stdin.close()
        report["holder_rc"] = holder.wait(timeout=120)
        box.set_pids([idle.pid])
        before = stack.requests.snapshot()
        done = stack.client.remove_gpu("workload", "default", [gpu.uuid])
        report["round_trips_detach"] = _delta(
            before, stack.requests.snapshot())
        checks["detach_completes_after_exit"] = (
            done.result == pb.RemoveGPUResponse.Success
            and stack.slave_pods() == [] and gate_pairs() == set()
            and box.nodes() == {"null": (1, 3)}
            and sorted(box.cgroup_lines("devices.deny")) == lines)

        # a container the runtime gave a GPU at creation keeps the
        # companions when the hot-attached GPU leaves
        other = 0 if gpu.minor else 1
        held = [(f"/dev/nvidia{other}", consts.NVIDIA_MAJOR, other)] + [
            (name, *majmin) for name, majmin in companions.items()]
        kept = stack.node.container("workload-held", [idle_held.pid],
                                    held=held)
        stack.add_target(kept)
        attach = stack.client.add_gpu("workload-held", "default", 1)
        detach = stack.client.remove_gpu("workload-held", "default")
        checks["held_companions_stay"] = (
            attach.result == pb.AddGPUResponse.Success
            and detach.result == pb.RemoveGPUResponse.Success
            and kept.nodes() == {os.path.basename(p): (a, b)
                                 for p, a, b in held}
            and kept.cgroup_lines("devices.deny") == [
                f"c {own[0]}:{own[1]} rw"])

        # timing: attach/detach pairs over gRPC on the host clock
        times: dict[str, list[float]] = {"add_gpu": [], "remove_gpu": []}
        ok = True
        before = stack.requests.snapshot()
        for _ in range(cycles):
            t0 = time.perf_counter()
            a = stack.client.add_gpu("workload", "default", 1)
            t1 = time.perf_counter()
            r = stack.client.remove_gpu("workload", "default")
            t2 = time.perf_counter()
            ok = ok and a.result == pb.AddGPUResponse.Success \
                and r.result == pb.RemoveGPUResponse.Success
            times["add_gpu"].append((t1 - t0) * 1e3)
            times["remove_gpu"].append((t2 - t1) * 1e3)
        checks["cycles_succeed"] = ok and box.nodes() == {"null": (1, 3)}
        report["round_trips_per_cycle"] = _delta(
            before, stack.requests.snapshot(), per=cycles)
        report["ms"] = {k: _stats(v) for k, v in times.items()}
        report["phase_median_ms"] = {op: _phase_medians(op, cycles)
                                     for op in ("attach", "detach")}
        report["agent_fallbacks"] = _fallback_total() - fallbacks_before
        checks["agent_no_fallback"] = report["agent_fallbacks"] == 0
        report.update(card={"uuid": gpu.uuid, "node": gpu.device_path,
                            "majmin": list(own)},
                      companions=companions,
                      gate_backend=stack.gate.backend.name,
                      agent_mode=stack.agent.status()["mode"],
                      boot_replay=stack.boot_replay)
        return report
    finally:
        report["checks"] = checks
        report["ok"] = bool(checks) and all(checks.values())
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
            proc.wait(timeout=60)
        if stack is not None:
            stack.close()
        shutil.rmtree(root, ignore_errors=True)
