"""Multi-host slice attach: one transaction across per-node workers (the
port of :mod:`gpumounter_tpu.master.slice`).

The reference has no cross-worker coordination: each AddGPU touches
exactly one node. A job that spans hosts needs every host's devices at
once — a half-attached slice is useless, since every host's process must
see its local GPUs before the distributed world can form. The master
therefore offers a slice-level transaction:

- **attach**: entire-mount every target pod (one pod per host)
  concurrently; if ANY host fails, roll back the ones that succeeded
  (txn-targeted detach) and report per-pod results. All-or-nothing at
  the slice level.
- **detach**: fan out RemoveGPU to every pod; failures reported per pod
  (no rollback — detach is already the rollback direction).

The per-host mechanism is unchanged (slave pods + actuation); this layer
is pure orchestration, so node accounting stays exact on every host.

The topology rule is the GPU one (``allocator/topology.py``): all
labelled hosts carry one ``cloud.google.com/gke-accelerator``, one pod per
host, and ``gpusPerHost`` equal to each labelled node's allocatable
``nvidia.com/gpu`` — a slice is made of whole hosts. A GPU node has no
multi-host mesh (``NodeTopology.multi_host`` is False), so ``strict`` is
accepted and adds nothing.
"""

from __future__ import annotations

import concurrent.futures
import contextvars
import dataclasses
import time
import uuid as uuid_mod

from gpumounter_tpu_torch.allocator import topology
from gpumounter_tpu_torch.k8s import objects
from gpumounter_tpu_torch.utils import consts
from gpumounter_tpu_torch.utils.errors import (K8sApiError,
                                               PodNotFoundError,
                                               TopologyError)
from gpumounter_tpu_torch.utils.log import get_logger
from gpumounter_tpu_torch.utils.metrics import REGISTRY
from gpumounter_tpu_torch.utils.trace import Trace

logger = get_logger("master.slice")

# Per-pod detach results that mean "the host holds nothing of this": the
# slice detach's done vocabulary (a repeated /removegpuslice converges to
# 200), and with POD_NOT_FOUND the rollback's clean one. Derived from the
# enum, so they follow its names.
DETACH_DONE = (consts.RemoveResult.SUCCESS.name,
               consts.RemoveResult.GPU_NOT_FOUND.name)
ROLLBACK_CLEAN = DETACH_DONE + (consts.RemoveResult.POD_NOT_FOUND.name,)
_ATTACHED = consts.AddResult.SUCCESS.name


@dataclasses.dataclass
class PodResult:
    namespace: str
    pod: str
    result: str
    device_ids: list[str] = dataclasses.field(default_factory=list)
    message: str = ""
    elapsed_ms: float = 0.0

    def to_json(self) -> dict:
        out = {"namespace": self.namespace, "pod": self.pod,
               "result": self.result}
        if self.device_ids:
            out["device_ids"] = self.device_ids
        if self.message:
            out["message"] = self.message
        if self.elapsed_ms:
            # per-host worker round-trip: the slice's slowest host sets
            # the transaction's wall time, so the straggler is
            # identifiable from the response alone
            out["elapsed_ms"] = round(self.elapsed_ms, 1)
        return out


class SliceCoordinator:
    """Runs slice transactions through a MasterGateway's worker plumbing.

    ``on_host_done(PodResult)`` fires from the fan-out thread the moment
    one host's attach resolves (the txn layer records per-host commit
    markers there). ``before_host_attach(namespace, pod)`` is a test
    seam between hosts."""

    def __init__(self, gateway, max_parallel: int = 16,
                 on_host_done=None, before_host_attach=None):
        self.gateway = gateway
        self.max_parallel = max_parallel
        self.on_host_done = on_host_done
        self.before_host_attach = before_host_attach

    # -- attach ----------------------------------------------------------------

    def attach(self, pods: list[tuple[str, str]],
               gpus_per_host: int,
               request_id: str | None = None,
               txn_id: str | None = None,
               validate: bool = True,
               strict: bool = False,
               rollback: bool = True
               ) -> tuple[bool, list[PodResult], bool]:
        """Entire-mount ``gpus_per_host`` GPUs to every (namespace, pod).
        Returns (ok, per-pod results, rollback_clean).

        The whole transaction carries a txn id that workers stamp on the
        slave pods they create. On any failure — with ``rollback=True``
        — EVERY pod gets a txn-targeted detach: a host that attached
        loses exactly this txn's slave pods, and a host that never did
        answers GPU_NOT_FOUND, which counts as clean.

        ``rollback=False`` leaves successful hosts attached (the slice
        txn manager owns resolution: gang waiters keep them as
        incremental reservations). ``rollback_clean`` is False only if a
        rollback detach itself failed.

        Raises :class:`TopologyError` before any fan-out when the target
        hosts cannot form one valid slice (mixed accelerators, two pods
        sharing a host, a per-host GPU count that isn't the hosts' whole
        size).
        """
        trace = Trace("slice_attach", request_id or "-")
        result_name = "EXCEPTION"
        try:
            if validate:
                with trace.span("validate"):
                    self.validate_slice_topology(pods, gpus_per_host,
                                                 strict=strict)
            txn_id = txn_id or ("txn-" + uuid_mod.uuid4().hex[:12])
            with trace.span("fanout"):
                results = self._fan_out(
                    pods,
                    lambda ns, name: self._attach_one(
                        ns, name, gpus_per_host, request_id, txn_id))
            ok = all(r.result == _ATTACHED for r in results)
            rollback_clean = True
            if not ok and rollback:
                logger.warning(
                    "slice %s attach failed; rolling back %d hosts",
                    txn_id, len(pods))
                with trace.span("rollback"):
                    rollback_clean, _ = self.rollback(pods, txn_id,
                                                      request_id)
            slowest = max(results, key=lambda r: r.elapsed_ms, default=None)
            if slowest is not None and slowest.elapsed_ms:
                logger.info("slice %s straggler: %s/%s at %.1fms", txn_id,
                            slowest.namespace, slowest.pod,
                            slowest.elapsed_ms)
            result_name = "SUCCESS" if ok else "FAILED"
        finally:
            # a TopologyError from validate still emits the trace; the
            # spans feed the shared attach_phase family (phase="rollback"
            # for slice-level rollbacks)
            trace.finish(result_name, REGISTRY.attach_phase)
        return ok, results, rollback_clean

    def rollback(self, pods: list[tuple[str, str]], txn_id: str,
                 request_id: str | None = None
                 ) -> tuple[bool, list[PodResult]]:
        """Txn-targeted detach of every pod — the abort direction of a
        slice transaction, also run standalone by the txn manager (gang
        hand-backs). Returns (clean, per-pod results); hosts the txn
        never touched answer GPU_NOT_FOUND, which counts as clean."""
        results = self._fan_out(
            pods,
            lambda ns, name: self._detach_one(
                ns, name, force=True, txn_id=txn_id,
                request_id=request_id))
        clean = True
        for r in results:
            if r.result not in ROLLBACK_CLEAN:
                clean = False
                logger.error("slice rollback left %s/%s attached: %s",
                             r.namespace, r.pod, r.message)
        return clean, results

    def _attach_one(self, namespace: str, pod: str, gpu_num: int,
                    request_id: str | None = None,
                    txn_id: str = "") -> PodResult:
        if self.before_host_attach is not None:
            self.before_host_attach(namespace, pod)
        t0 = time.monotonic()
        try:
            resp = self.gateway._call_worker(
                namespace, pod,
                lambda w: w.add_gpu(pod, namespace, gpu_num, True,
                                    request_id=request_id, txn_id=txn_id))
            result = consts.AddResult(resp.result)
            out = PodResult(namespace, pod, result.name,
                            device_ids=list(resp.device_ids))
        except Exception as e:
            out = PodResult(namespace, pod, "ERROR", message=str(e))
        out.elapsed_ms = (time.monotonic() - t0) * 1e3
        REGISTRY.attach_results.inc(result=f"slice_{out.result}")
        # per-host latency; the exemplar names the request
        REGISTRY.slice_host_attach.observe(
            out.elapsed_ms / 1e3,
            exemplar={"rid": request_id or txn_id,
                      "pod": f"{namespace}/{pod}"})
        if self.on_host_done is not None:
            self.on_host_done(out)
        return out

    # -- slice topology validation ---------------------------------------------

    def validate_slice_topology(self, pods: list[tuple[str, str]],
                                gpus_per_host: int,
                                strict: bool = False) -> None:
        """All labelled target hosts must carry ONE accelerator, and each
        pod must take its whole host. Pods/nodes that cannot be resolved
        are left for the per-pod attach to report precisely; pods on
        label-less nodes (test/non-GKE) are unconstrained. Raises
        :class:`TopologyError` on any violation.

        ``strict`` asks that the pod set span the advertised topology's
        full host count. A GPU node advertises no multi-host mesh, so
        there is nothing more to check: it is accepted and adds nothing.
        """
        del strict
        node_of: dict[tuple[str, str], str] = {}
        topos: dict[str, topology.NodeTopology] = {}
        for ns, name in pods:
            try:
                pod = self.gateway.kube.get_pod(ns, name)
            except PodNotFoundError:
                continue        # per-pod attach will report POD_NOT_FOUND
            except K8sApiError as e:
                logger.warning(
                    "slice topology check: pod %s/%s unreadable (%s); "
                    "skipping its checks", ns, name, e)
                continue
            node_name = objects.node_name(pod)
            if not node_name:
                continue
            node_of[(ns, name)] = node_name
            try:
                node = self.gateway.kube.get_node(node_name)
            except K8sApiError as e:
                if e.status != 404:     # 404 = unlabelled/unknown is normal
                    logger.warning(
                        "slice topology check: node %s unreadable (%s); "
                        "topology enforcement off for it", node_name, e)
                continue
            topo = topology.node_topology(node)
            if topo:
                topos[node_name] = topo

        owners: dict[str, tuple[str, str]] = {}
        for key, node_name in node_of.items():
            other = owners.setdefault(node_name, key)
            if other != key:
                raise TopologyError(
                    f"pods {other[0]}/{other[1]} and {key[0]}/{key[1]} are "
                    f"both on node {node_name}: a slice needs one pod per "
                    "host")

        if not topos:
            return
        accelerators = {t.accelerator for t in topos.values()}
        if len(accelerators) > 1:
            detail = {n: t.accelerator for n, t in sorted(topos.items())}
            raise TopologyError(
                f"target hosts carry different accelerators {detail} — "
                "they cannot form one slice")
        for node_name, topo in topos.items():
            if topo.gpus_per_node > 0 and gpus_per_host != topo.gpus_per_node:
                raise TopologyError(
                    f"slice attach needs whole hosts: node {node_name} has "
                    f"{topo.gpus_per_node} GPUs ({topo.accelerator}), got "
                    f"gpusPerHost={gpus_per_host}")

    # -- detach ----------------------------------------------------------------

    def detach(self, pods: list[tuple[str, str]], force: bool = False,
               request_id: str | None = None,
               cause: str = "") -> tuple[bool, list[PodResult]]:
        results = self._fan_out(
            pods, lambda ns, name: self._detach_one(
                ns, name, force, request_id=request_id, cause=cause))
        # GPU_NOT_FOUND counts as done: retrying a completed detach must
        # converge to success, not 409 forever.
        ok = all(r.result in DETACH_DONE for r in results)
        return ok, results

    def _detach_one(self, namespace: str, pod: str, force: bool,
                    uuids: list[str] | None = None,
                    request_id: str | None = None,
                    txn_id: str = "", cause: str = "") -> PodResult:
        t0 = time.monotonic()
        try:
            resp = self.gateway._call_worker(
                namespace, pod,
                lambda w: w.remove_gpu(pod, namespace, uuids or [], force,
                                       request_id=request_id,
                                       txn_id=txn_id, cause=cause))
            result = consts.RemoveResult(resp.result)
            out = PodResult(namespace, pod, result.name)
        except Exception as e:
            out = PodResult(namespace, pod, "ERROR", message=str(e))
        out.elapsed_ms = (time.monotonic() - t0) * 1e3
        REGISTRY.detach_results.inc(result=f"slice_{out.result}")
        return out

    # -- plumbing --------------------------------------------------------------

    def _fan_out(self, pods: list[tuple[str, str]], fn) -> list[PodResult]:
        # Each host runs under a COPY of the caller's contextvars
        # context: the per-host resolve/dial/rpc spans then attach under
        # the slice trace's fanout span (span objects are shared across
        # the copies; child appends are GIL-atomic) instead of vanishing
        # into the executor threads' empty contexts.
        parent = contextvars.copy_context()
        with concurrent.futures.ThreadPoolExecutor(
                max_workers=min(self.max_parallel, max(1, len(pods)))) as ex:
            return list(ex.map(
                lambda p: parent.copy().run(fn, p[0], p[1]), pods))
