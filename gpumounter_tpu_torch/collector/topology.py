"""Worker-side topology snapshot: GPU coordinates + occupancy (/topoz)
(the port of :mod:`gpumounter_tpu.collector.topology`).

The usage sampler (collector/usage.py) says what each GPU is *doing*;
this view says where each GPU *sits* and who holds it — the per-node map
the master's fleet topology model (master/topology.py) scores for
fragmentation:

- each GPU gets a **coordinate**. A GPU node is one NVSwitch domain
  (allocator/topology.py): any count of its GPUs forms a valid group, so
  the node's "mesh" is ``[1, N]`` and GPU ``i`` (its rank in index
  order) sits at ``[0, i]``. There is no ICI grid to fold;
- each GPU gets an **occupancy** state (free / leased) joined to its
  owner pod through the same slave → owner resolution the usage sampler
  uses (``attachment_owners`` + informer slave-pod labels).

The payload carries the node's ``accelerator`` and ``gpus_per_node``
from its GKE labels (``NodeTopology``); an unlabelled node is
unconstrained, as in the allocator, and reports its enumerated GPU
count. Per-GPU keys are the control plane's (``chip`` = the UUID,
``coord``, ``state``, ``owner``), so one reader takes both packages'
payloads.

Served as ``GET /topoz`` on the worker health port, strictly
**snapshot-only**: the handler reads the collector's cached inventory
and already-resolved ownership — no enumeration, no kubelet probe, no
uncached apiserver round trip on the request path
(tests/test_torch_topology_lint.py pins it). ``TPU_TOPOLOGY=0`` removes
the view entirely — /topoz answers ``{"enabled": false}``.
"""

from __future__ import annotations

import threading
import time

from gpumounter_tpu_torch.allocator import topology as topology_lib
from gpumounter_tpu_torch.collector.usage import resolve_owner
from gpumounter_tpu_torch.device.model import DeviceState
from gpumounter_tpu_torch.utils import consts
from gpumounter_tpu_torch.utils.log import get_logger

logger = get_logger("collector.topology")

# Node labels are effectively immutable for a node's lifetime; re-reading
# them every snapshot would put an apiserver GET on the health port's
# request path. Cache them, retrying sooner after a failed read.
DEFAULT_TOPOLOGY_TTL_S = 300.0
FAILED_TOPOLOGY_RETRY_S = 15.0


def node_topology_source(kube, node_name: str, *,
                         ttl_s: float = DEFAULT_TOPOLOGY_TTL_S):
    """TTL-cached ``() -> NodeTopology | None`` over the node's labels.

    Best-effort: an unreadable node degrades to ``None`` (the view falls
    back to the enumerated GPU count) and is retried on a shorter fuse —
    never raises into the snapshot path. An unlabelled node reads as
    ``None`` on the full TTL: its labels are read, there are none."""
    from gpumounter_tpu_torch.utils.errors import K8sApiError
    state = {"topo": None, "until": -float("inf")}
    lock = threading.Lock()

    def source() -> topology_lib.NodeTopology | None:
        with lock:
            now = time.monotonic()
            if now < state["until"]:
                return state["topo"]
            try:
                node = kube.get_node(node_name)
                state["topo"] = topology_lib.node_topology(node)
                state["until"] = now + ttl_s
            except K8sApiError:
                state["topo"] = None
                state["until"] = now + FAILED_TOPOLOGY_RETRY_S
            return state["topo"]

    return source


class NodeTopologyView:
    """The ``GET /topoz`` payload builder: cached inventory × node labels
    × ownership, assembled per request from state other components
    already maintain. Snapshot-only — see the module docstring."""

    def __init__(self, collector, *, node_name: str = "",
                 topology_fn=None, owners_fn=None,
                 pool_namespace: str = consts.DEFAULT_POOL_NAMESPACE):
        self.collector = collector
        self.node_name = node_name
        # topology_fn() -> NodeTopology | None (the TTL-cached source
        # above); None = no label source (unit rigs).
        self.topology_fn = topology_fn
        # owners_fn() -> {slave pod name: (owner ns, owner pod)}; None =
        # only directly-bound GPUs attribute.
        self.owners_fn = owners_fn
        self.pool_namespace = pool_namespace

    def snapshot(self) -> dict:
        """The /topoz payload. Reads the collector's CACHED inventory
        (attach/detach and the usage sampler already refresh it) — this
        method performs no enumeration and no kubelet probe."""
        chips = sorted(self.collector.chips, key=lambda c: c.index)
        topo = None
        if self.topology_fn is not None:
            try:
                topo = self.topology_fn()
            except Exception:    # noqa: BLE001 — labels degrade,
                logger.exception("topology source failed")  # never dies
        owners: dict[str, tuple[str, str]] = {}
        if self.owners_fn is not None:
            try:
                owners = self.owners_fn() or {}
            except Exception:    # noqa: BLE001 — attribution degrades
                logger.exception("owner resolution failed")
        chips_out = []
        free = leased = 0
        # Coordinates come from the GPU's RANK in index order, not the
        # raw nvidiaN number: a sparse inventory still tiles [1, N].
        for rank, chip in enumerate(chips):
            state = ("leased" if chip.state is DeviceState.ALLOCATED
                     else "free")
            if state == "free":
                free += 1
            else:
                leased += 1
            row = {
                "chip": chip.uuid,
                "index": chip.index,
                "coord": [0, rank],
                "device_path": chip.device_path,
                "state": state,
            }
            if chip.namespace == self.pool_namespace and chip.pod_name:
                row["slave_pod"] = chip.pod_name
            owner = resolve_owner(chip, owners, self.pool_namespace)
            if owner is not None:
                row["owner"] = f"{owner[0]}/{owner[1]}"
            chips_out.append(row)
        return {
            "enabled": True,
            "node": self.node_name,
            "accelerator": topo.accelerator if topo else "",
            "topology": "",
            "gpus_per_node": (topo.gpus_per_node
                              if topo and topo.gpus_per_node > 0
                              else len(chips)),
            "mesh": [1, len(chips)] if chips else [0, 0],
            "chips": chips_out,
            "free": free,
            "leased": leased,
        }


def build_topology_view(service, settings) -> NodeTopologyView:
    """Production wiring (worker/main.py): labels from the worker's own
    node object (TTL-cached), ownership from attachment records + the
    informer's slave-pod labels — the same resolver /utilz trusts."""
    from gpumounter_tpu_torch.collector.usage import slave_owner_resolver
    return NodeTopologyView(
        service.allocator.collector,
        node_name=settings.node_name,
        topology_fn=node_topology_source(service.kube,
                                         settings.node_name)
        if settings.node_name else None,
        owners_fn=slave_owner_resolver(service.reads,
                                       settings.pool_namespace,
                                       service=service),
        pool_namespace=settings.pool_namespace)
