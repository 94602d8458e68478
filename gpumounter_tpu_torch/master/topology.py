"""Master fleet-topology model: fragmentation, contiguity, defrag report
(the port of :mod:`gpumounter_tpu.master.topology`).

The fleet tick scrapes every worker's ``/topoz`` (collector/topology.py)
beside ``/utilz`` and assembles the fleet-wide occupancy graph this module
scores:

- **fragmentation score** = 1 − largest schedulable free block ÷ total
  free GPUs (0 = perfectly packed, approaching 1 = free capacity
  shattered across nodes). "Schedulable" means the port's allocator would
  grant the block as one entire mount (allocator/topology.py
  ``validate_entire_mount``);
- **stranded GPUs**: free GPUs in fragments no valid group can use;
- **slice contiguity** per group: do the gang's member hosts occupy
  adjacent positions in the fleet's host order;
- a **defrag candidate report**: leases (idle-preferred) whose relocation
  would grow their node's largest schedulable free block AND that fit
  somewhere else today — the input of the defragmenter (master/defrag.py);
- the **cross-shard global tenant rollup**: per-tenant in-use summed
  across master shards (peer ``/brokerz`` scrape through the election's
  lock records) — quotas stay per-shard, this is report-only.

**Departure from the control plane: the connected components.** The
control plane joins a TPU host's free chips by 4-neighbour adjacency on
its ICI grid, and a component serves only the topology-aligned group
sizes that fit inside it. A GPU node is one NVSwitch domain: any count of
its GPUs up to the node's ``nvidia.com/gpu`` is a valid group, whichever
GPUs are free. So a node's free GPUs are ONE component, a block is
schedulable exactly when ``validate_entire_mount`` accepts its size, and
``stranded`` is 0 on every GPU node. Applied to the ``[0, i]``
coordinates of /topoz, the grid rule would split free GPUs 0 and 2
around a leased GPU 1, which the allocator grants together. The numbers
therefore differ from the control plane's for the same occupancy: three
free GPUs of a 4-GPU node score capacity 3 and stranded 0, where three
free chips in an L on a 2x2 host score capacity 2 and stranded 1
(ROADMAP Queue 3). On 1- and 2-GPU nodes the two rules agree.

Scoring runs ONLY on the fleet tick thread (``tick()``; the lint pins
it); scrape threads call :meth:`ingest`, the gateway serves
:meth:`snapshot` — already-computed state, nothing on a request path.
``TPU_TOPOLOGY=0`` removes the model, the scrape, the /fleetz sections
and every series.
"""

from __future__ import annotations

import json
import os
import threading
import urllib.error
import urllib.request

from gpumounter_tpu_torch.allocator import topology as topology_lib
from gpumounter_tpu_torch.utils import consts
from gpumounter_tpu_torch.utils.events import EVENTS
from gpumounter_tpu_torch.utils.log import get_logger
from gpumounter_tpu_torch.utils.metrics import REGISTRY

logger = get_logger("master.topology")

# Sustained score above this is the doctor WARN / alert-rule threshold
# (TPUMounterFleetFragmented fires on it after its `for:` window).
FRAG_WARN_THRESHOLD = 0.5
# Report bound: the optimizer input stays readable and /fleetz bounded no
# matter how torn the fleet is.
MAX_DEFRAG_CANDIDATES = 16


def enabled(env=None) -> bool:
    """TPU_TOPOLOGY gate, default ON (tests/test_torch_topology_lint.py
    pins the default)."""
    env = os.environ if env is None else env
    return env.get(consts.ENV_TOPOLOGY, "1") != "0"


def _components(coords: set[tuple[int, int]]) -> list[set[tuple[int, int]]]:
    """The free regions of one GPU node: all its free GPUs, as one
    component (one NVSwitch domain; see the module docstring)."""
    return [set(coords)] if coords else []


def _node_topo(payload: dict) -> topology_lib.NodeTopology:
    """The node's group rule from its /topoz payload: its GPU count (the
    enumerated count on an unlabelled node)."""
    try:
        gpus = int(payload.get("gpus_per_node") or 0)
    except (TypeError, ValueError):
        gpus = 0
    return topology_lib.NodeTopology(
        accelerator=str(payload.get("accelerator") or ""),
        gpus_per_node=gpus or len(payload.get("chips") or []))


def _score_free_set(free_coords: set[tuple[int, int]],
                    aligned: list[int]) -> tuple[int, int, list[int]]:
    """(largest schedulable block, stranded GPUs, component sizes) for
    one node's free-coordinate set. Per component, the schedulable
    capacity is the largest valid group size that fits inside it;
    whatever the component holds beyond that capacity is stranded."""
    largest = 0
    stranded = 0
    sizes: list[int] = []
    for comp in _components(free_coords):
        cap = max((a for a in aligned if a <= len(comp)), default=0)
        largest = max(largest, cap)
        stranded += len(comp) - cap
        sizes.append(len(comp))
    sizes.sort(reverse=True)
    return largest, stranded, sizes


class FleetTopology:
    """Fleet occupancy graph + the scores/report derived from it.

    ``ingest`` runs on the fleet scrape threads (store only), ``tick``
    on the fleet tick thread (ALL scoring), ``snapshot`` /
    ``fleetz_section`` / ``global_tenants`` on request threads
    (already-computed state only)."""

    def __init__(self, *, leases_fn=None, groups_fn=None,
                 local_usage_fn=None, peers_fn=None, replica: str = "",
                 scrape_timeout_s: float = 1.0, node_excluded_fn=None):
        # leases_fn() -> list[Lease] (broker table; defrag candidates);
        # groups_fn() -> {group: [Lease, ...]} (slice contiguity);
        # local_usage_fn() -> {tenant: chips in use} (this shard's half
        # of the global rollup); peers_fn() -> election leaders()
        # ({shard: {holder, url, fence, expired}}) for the peer scrape;
        # node_excluded_fn(node) -> bool (cordoned/draining/suspect —
        # the gateway binds the node-health tracker) prunes candidates
        # whose node is no migration source.
        self.leases_fn = leases_fn
        self.groups_fn = groups_fn
        self.local_usage_fn = local_usage_fn
        self.peers_fn = peers_fn
        self.node_excluded_fn = node_excluded_fn
        self.replica = replica
        self.scrape_timeout_s = scrape_timeout_s
        self._lock = threading.Lock()
        self._payloads: dict[str, dict] = {}
        self._view: dict | None = None        # computed by tick()
        self._global: dict | None = None
        self._ticks = 0
        # defrag-candidate dedup: (namespace, pod, node) keys currently
        # reported; a key re-fires its metric+event only after it left
        # the report and re-entered.
        self._seen_candidates: set[tuple[str, str, str]] = set()
        # vanished-series hygiene: zero ONCE, then forget — re-zeroing
        # an ever-growing dead set never converges.
        self._exported_nodes: set[str] = set()
        self._exported_groups: set[str] = set()
        self._exported_tenants: set[str] = set()
        self._exported_fleet = False

    # -- scrape side (fleet scrape threads) ------------------------------------

    def ingest(self, node: str, payload: dict | None) -> None:
        """Store one node's latest /topoz payload. ``None`` (scrape
        failed with no prior, or the worker answered enabled=false)
        withdraws the node from the model."""
        with self._lock:
            if payload is None or not payload.get("enabled"):
                self._payloads.pop(node, None)
            else:
                self._payloads[node] = payload

    # -- tick side (fleet tick thread — ALL scoring happens here) --------------

    def tick(self, live_nodes: set[str] | None = None) -> None:
        """Recompute the fleet view from the latest ingested payloads.
        Runs on the fleet aggregator's tick thread only (request threads
        serve the result; the topology lint pins the caller set)."""
        with self._lock:
            if live_nodes is not None:
                for node in set(self._payloads) - set(live_nodes):
                    del self._payloads[node]
            payloads = dict(self._payloads)
        view = self._compute(payloads)
        global_view = self._rollup()
        with self._lock:
            self._view = view
            self._global = global_view
            self._ticks += 1
        self._export_gauges(view, global_view)

    def _compute(self, payloads: dict[str, dict]) -> dict:
        """Score every node + the fleet, judge group contiguity, build
        the defrag candidate report. Pure function of the payloads and
        the broker's lease table — called from tick() only."""
        nodes: dict[str, dict] = {}
        for node in sorted(payloads):
            payload = payloads[node]
            aligned = topology_lib.aligned_group_sizes(
                _node_topo(payload))
            free_coords = {tuple(c["coord"]) for c in payload["chips"]
                           if c["state"] == "free"}
            largest, stranded, sizes = _score_free_set(free_coords,
                                                       aligned)
            free = len(free_coords)
            nodes[node] = {
                "free": free,
                "leased": len(payload["chips"]) - free,
                "largest_free_block": largest,
                "stranded": stranded,
                "free_components": sizes,
                "frag": (round(1.0 - largest / free, 4) if free else 0.0),
                "mesh": list(payload.get("mesh") or [0, 0]),
                "topology": payload.get("topology", ""),
            }
        total_free = sum(n["free"] for n in nodes.values())
        largest = max((n["largest_free_block"] for n in nodes.values()),
                      default=0)
        score = (round(1.0 - largest / total_free, 4) if total_free
                 else 0.0)
        stranded = sum(n["stranded"] for n in nodes.values())
        view = {
            "score": score,
            "free": total_free,
            "largest_free_block": largest,
            "stranded": stranded,
            "nodes": nodes,
        }
        groups = self._group_contiguity(nodes)
        if groups:
            view["groups"] = groups
        candidates = self._defrag_candidates(payloads, nodes)
        view["defrag_candidates"] = candidates
        self._note_new_candidates(candidates)
        return view

    def _group_contiguity(self, nodes: dict[str, dict]) -> dict[str, dict]:
        """Per-group host-adjacency judgment. Host order = sorted node
        names of the ingested fleet (the order a world ranks its
        members in); a group whose member hosts are
        not all in the model is reported unknown and exports no gauge
        (a 0 would read as a REAL torn slice)."""
        if self.groups_fn is None:
            return {}
        try:
            groups = self.groups_fn() or {}
        except Exception:    # noqa: BLE001 — view degrades, never dies
            logger.exception("group listing failed")
            return {}
        host_rank = {node: i for i, node in enumerate(sorted(nodes))}
        out: dict[str, dict] = {}
        for group in sorted(groups):
            members = groups[group]
            hosts = sorted({lease.node for lease in members})
            if not hosts:
                continue
            if any(h not in host_rank for h in hosts):
                out[group] = {"hosts": hosts, "contiguous": None}
                continue
            ranks = sorted(host_rank[h] for h in hosts)
            contiguous = ranks[-1] - ranks[0] == len(ranks) - 1
            out[group] = {"hosts": hosts, "contiguous": contiguous}
        return out

    def _defrag_candidates(self, payloads: dict[str, dict],
                           nodes: dict[str, dict]) -> list[dict]:
        """Leases whose relocation would grow their node's largest
        schedulable free block AND that fit on another node today —
        idle-preferred, gain-sorted, bounded. Report-only."""
        if self.leases_fn is None:
            return []
        try:
            leases = self.leases_fn() or []
        except Exception:    # noqa: BLE001 — view degrades, never dies
            logger.exception("lease listing failed")
            return []
        # Staleness guards: a candidate computed from last tick's world
        # must not survive its group's teardown or its node's fencing —
        # a dead candidate in /fleetz would re-emit its event (and feed
        # the actuator a move against a gone group).
        live_groups: set[str] | None = None
        if self.groups_fn is not None:
            try:
                live_groups = set(self.groups_fn() or {})
            except Exception:    # noqa: BLE001 — skip the guard, not
                live_groups = None            # the whole report
        out: list[dict] = []
        for lease in leases:
            if lease.group and live_groups is not None \
                    and lease.group not in live_groups:
                continue    # group torn down between ticks
            node = lease.node
            if node not in payloads and lease.uuids:
                # re-derived leases may lack a node; join by device uuid
                for cand_node, payload in payloads.items():
                    if lease.uuids & {c["chip"] for c in payload["chips"]}:
                        node = cand_node
                        break
            if node not in payloads:
                continue
            if self.node_excluded_fn is not None:
                try:
                    if self.node_excluded_fn(node):
                        continue    # fenced/cordoned between ticks
                except Exception:    # noqa: BLE001 — guard degrades
                    pass             # open, never kills the report
            payload = payloads[node]
            owner = f"{lease.namespace}/{lease.pod}"
            freed = {tuple(c["coord"]) for c in payload["chips"]
                     if c["state"] == "free"
                     or c["chip"] in lease.uuids
                     or c.get("owner") == owner}
            aligned = topology_lib.aligned_group_sizes(
                _node_topo(payload))
            largest_after, _, _ = _score_free_set(freed, aligned)
            gain = largest_after - nodes[node]["largest_free_block"]
            if gain <= 0:
                continue
            if not any(other != node
                       and info["largest_free_block"] >= lease.chips
                       for other, info in nodes.items()):
                continue        # nowhere to move it today: not actionable
            out.append({
                "namespace": lease.namespace,
                "pod": lease.pod,
                "tenant": lease.tenant,
                "node": node,
                "chips": lease.chips,
                "gain": gain,
                "idle": lease.idle_since_unix is not None,
                "group": lease.group,
            })
        out.sort(key=lambda c: (not c["idle"], -c["gain"],
                                c["namespace"], c["pod"]))
        return out[:MAX_DEFRAG_CANDIDATES]

    def _note_new_candidates(self, candidates: list[dict]) -> None:
        keys = {(c["namespace"], c["pod"], c["node"])
                for c in candidates}
        for cand in candidates:
            if (cand["namespace"], cand["pod"],
                    cand["node"]) not in self._seen_candidates:
                self._note_candidate(cand)
        # keys that left the report may legitimately re-fire later
        self._seen_candidates = keys

    def _note_candidate(self, cand: dict) -> None:
        """The SOLE place a defrag candidate turns into telemetry: the
        counter and the event fire together or not at all (the topology
        lint pins this pairing)."""
        REGISTRY.defrag_candidates.inc(node=cand["node"])
        EVENTS.emit("defrag_candidate",
                    tenant=cand["tenant"], node=cand["node"],
                    namespace=cand["namespace"], pod=cand["pod"],
                    chips=cand["chips"], gain=cand["gain"],
                    idle=cand["idle"])

    # -- cross-shard global tenant rollup (tick thread) ------------------------

    def _rollup(self) -> dict | None:
        """Sum per-tenant in-use across master shards: this shard's
        lease table + every non-expired peer leader's /brokerz. None
        until a usage source is wired (worker-only rigs)."""
        if self.local_usage_fn is None:
            return None
        try:
            tenants: dict[str, int] = dict(self.local_usage_fn() or {})
        except Exception:    # noqa: BLE001 — rollup degrades, never dies
            logger.exception("local usage listing failed")
            tenants = {}
        peers: dict[str, dict] = {}
        if self.peers_fn is not None:
            try:
                peers = self.peers_fn() or {}
            except Exception:    # noqa: BLE001
                logger.exception("peer listing failed")
        urls: dict[str, str] = {}
        for _shard, info in sorted(peers.items()):
            if info.get("expired"):
                continue        # a dead peer's leases are being re-owned
            holder = str(info.get("holder") or "")
            url = str(info.get("url") or "").rstrip("/")
            if not url or holder == self.replica:
                continue        # ourselves, or a record with no address
            urls.setdefault(holder or url, url)
        scraped = errors = 0
        for _holder, url in sorted(urls.items()):
            try:
                with urllib.request.urlopen(
                        url + "/brokerz",
                        timeout=self.scrape_timeout_s) as resp:
                    payload = json.loads(resp.read())
                for tenant, info in (payload.get("tenants")
                                     or {}).items():
                    tenants[tenant] = (tenants.get(tenant, 0)
                                       + int(info.get("in_use") or 0))
                scraped += 1
            except (urllib.error.URLError, OSError, ValueError,
                    TypeError):
                errors += 1
        return {
            "tenants": {t: tenants[t] for t in sorted(tenants)},
            "peers_scraped": scraped,
            "peer_errors": errors,
        }

    # -- gauge export + vanished-series hygiene (tick thread) ------------------

    def _export_gauges(self, view: dict,
                       global_view: dict | None) -> None:
        nodes = view["nodes"]
        if nodes:
            REGISTRY.fleet_fragmentation_score.set(view["score"])
            REGISTRY.stranded_chips.set(view["stranded"])
            self._exported_fleet = True
        elif self._exported_fleet:
            REGISTRY.fleet_fragmentation_score.set(0.0)
            REGISTRY.stranded_chips.set(0)
            self._exported_fleet = False
        for node, info in nodes.items():
            REGISTRY.node_free_contiguous_chips.set(
                info["largest_free_block"], node=node)
        for node in self._exported_nodes - set(nodes):
            REGISTRY.node_free_contiguous_chips.set(0, node=node)
        self._exported_nodes = set(nodes)
        groups = view.get("groups") or {}
        judged = {g: info for g, info in groups.items()
                  if info["contiguous"] is not None}
        for group, info in judged.items():
            REGISTRY.slice_contiguity.set(
                1 if info["contiguous"] else 0, group=group)
        for group in self._exported_groups - set(judged):
            REGISTRY.slice_contiguity.set(0, group=group)
        self._exported_groups = set(judged)
        tenants = (global_view or {}).get("tenants") or {}
        for tenant, chips in tenants.items():
            REGISTRY.tenant_chips_in_use_global.set(chips, tenant=tenant)
        for tenant in self._exported_tenants - set(tenants):
            REGISTRY.tenant_chips_in_use_global.set(0, tenant=tenant)
        self._exported_tenants = set(tenants)

    def withdraw(self) -> None:
        """Zero every exported series once (fleet stop), so a stopped
        aggregator doesn't freeze stale topology on /metrics."""
        if self._exported_fleet:
            REGISTRY.fleet_fragmentation_score.set(0.0)
            REGISTRY.stranded_chips.set(0)
            self._exported_fleet = False
        for node in self._exported_nodes:
            REGISTRY.node_free_contiguous_chips.set(0, node=node)
        self._exported_nodes = set()
        for group in self._exported_groups:
            REGISTRY.slice_contiguity.set(0, group=group)
        self._exported_groups = set()
        for tenant in self._exported_tenants:
            REGISTRY.tenant_chips_in_use_global.set(0, tenant=tenant)
        self._exported_tenants = set()

    # -- read side (request threads: already-computed state only) --------------

    def fleetz_section(self) -> dict | None:
        """The /fleetz ``topology`` section, or None until at least one
        node's /topoz has been ingested AND a tick scored it — so a
        topology-less fleet (workers on TPU_TOPOLOGY=0, or no tick yet)
        keeps /fleetz byte-identical to the pre-topology payload."""
        with self._lock:
            view = self._view
        if view is None or not view["nodes"]:
            return None
        return json.loads(json.dumps(view))

    def global_tenants(self) -> dict | None:
        """The /fleetz ``global_tenants`` section, or None until a tick
        computed the rollup (or no usage source is wired)."""
        with self._lock:
            global_view = self._global
        if global_view is None:
            return None
        return json.loads(json.dumps(global_view))

    def snapshot(self) -> dict:
        """The master GET /topoz payload: the scored fleet view plus
        each node's raw GPU map (coordinates + occupancy).
        Already-computed state only."""
        with self._lock:
            view = self._view
            global_view = self._global
            payloads = dict(self._payloads)
            ticks = self._ticks
        out: dict = {
            "enabled": True,
            "ticks": ticks,
            "fleet": (json.loads(json.dumps(view))
                      if view is not None else None),
        }
        if global_view is not None:
            out["global_tenants"] = json.loads(json.dumps(global_view))
        out["nodes"] = {
            node: {
                "mesh": payload.get("mesh"),
                "topology": payload.get("topology", ""),
                "accelerator": payload.get("accelerator", ""),
                "chips": payload.get("chips", []),
                "free": payload.get("free", 0),
                "leased": payload.get("leased", 0),
            }
            for node, payload in sorted(payloads.items())
        }
        return out
