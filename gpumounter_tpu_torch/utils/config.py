"""Runtime configuration: the port's copies of ``HostPaths`` and
``Settings`` (``gpumounter_tpu/utils/config.py``).

Every host path the worker reads is a parameter, so each layer can run
against a fixture tree in tests. ``Settings`` keeps every field and
environment name of the control plane's, so one deployment configures
both; the fields that name a device follow the GPU (``resource_name`` is
``nvidia.com/gpu``, the pool namespace ``gpu-pool``). The master's fields
are kept for the master's port; the worker reads its own.
"""

from __future__ import annotations

import dataclasses
import os

from gpumounter_tpu_torch.utils import consts


@dataclasses.dataclass
class HostPaths:
    """Roots of every host filesystem the worker touches. Production uses
    the real roots; tests point these at fixture trees."""

    dev_root: str = "/dev"
    proc_root: str = "/proc"
    sys_root: str = "/sys"
    cgroup_root: str = "/sys/fs/cgroup"
    kubelet_socket: str = consts.KUBELET_SOCKET_PATH


def parse_warm_pool_sizes(spec: str) -> dict[str, int]:
    """``"entire:4=1,single:1=2"`` -> {"entire:4": 1, "single:1": 2}.
    Raises ValueError on malformed entries — a typo'd pool spec must fail
    the boot, not silently run with no pool."""
    sizes: dict[str, int] = {}
    for entry in filter(None, (e.strip() for e in spec.split(","))):
        key, sep, count = entry.partition("=")
        mount, csep, chips = key.partition(":")
        if (not sep or not csep or mount not in ("entire", "single")
                or not chips.isdigit() or int(chips) < 1
                or not count.isdigit()):
            raise ValueError(
                f"bad warm-pool entry {entry!r}: want "
                "'entire:<chips>=<count>' or 'single:1=<count>'")
        if mount == "single" and int(chips) != 1:
            raise ValueError(
                f"bad warm-pool entry {entry!r}: single-mount slave pods "
                "hold exactly 1 chip")
        sizes[f"{mount}:{int(chips)}"] = int(count)
    return {k: v for k, v in sizes.items() if v > 0}


def parse_tenant_quotas(spec: str) -> dict[str, int]:
    """``"teamA:16,teamB:8,*:4"`` -> {"teamA": 16, "teamB": 8, "*": 4}.
    ``*`` is the default quota for tenants not named; without it unlisted
    tenants are unlimited. Raises ValueError on malformed entries — a
    typo'd quota spec must fail the boot, not silently run open."""
    quotas: dict[str, int] = {}
    for entry in filter(None, (e.strip() for e in spec.split(","))):
        tenant, sep, chips = entry.rpartition(":")
        if not sep or not tenant or not chips.isdigit():
            raise ValueError(
                f"bad quota entry {entry!r}: want '<tenant>:<chips>' "
                "(chips a non-negative integer; '*' names the default)")
        if tenant in quotas:
            raise ValueError(f"duplicate quota for tenant {tenant!r}")
        quotas[tenant] = int(chips)
    return quotas


@dataclasses.dataclass
class Settings:
    pool_namespace: str = consts.DEFAULT_POOL_NAMESPACE
    cgroup_driver: str = "systemd"          # "systemd" | "cgroupfs"
    resource_name: str = consts.GPU_RESOURCE_NAME
    worker_grpc_port: int = consts.WORKER_GRPC_PORT
    master_http_port: int = consts.MASTER_HTTP_PORT
    worker_namespace: str = consts.WORKER_NAMESPACE
    worker_label_selector: str = consts.WORKER_LABEL_SELECTOR
    node_name: str = ""                     # downward-API injected NODE_NAME
    # Watch deadline for slave-pod create/delete state machines. Replaces the
    # reference's unbounded busy-polls (allocator.go:247-282, :296-317).
    allocation_timeout_s: float = 120.0
    # On a real node the kubelet's PodResources listing can lag a slave
    # pod's Running transition by a beat (device-plugin assignment is
    # asynchronous); chip collection retries within this bound before
    # declaring the allocation failed. The bound is per stall: a serially
    # resolving kubelet gets a fresh window after each pod that resolves,
    # so an N-slave-pod attach can wait up to N * this value in total
    # (hard-capped there by the allocator).
    kubelet_lag_timeout_s: float = 10.0
    # Accept regular files as chips (fixture nodes / process-level boot
    # tests on CPU-only hosts). Never set in the shipped DaemonSet.
    allow_fake_devices: bool = False
    # Warm slave-pod pool (worker/pool.py): how many pre-scheduled unowned
    # slave pods to keep warm per pool key ("entire:4" = one 4-chip
    # entire-mount pod). Empty dict = pool disabled; warm_pool_enabled can
    # additionally force it off without losing the sizing config. Warm pods
    # go through the normal scheduler path, so node accounting stays honest
    # — the pool only moves the scheduling wait off the attach critical
    # path.
    warm_pool_sizes: dict[str, int] = dataclasses.field(default_factory=dict)
    warm_pool_enabled: bool = False
    # Background refill/trim cadence; adoption also kicks the loop
    # immediately, so this mainly bounds how long a crashed warm pod or a
    # resize stays unreconciled.
    warm_pool_interval_s: float = 10.0
    # Shared pod informer (k8s/informer.py): serve hot-path pod reads from
    # ONE list+watch cache per scope instead of per-caller apiserver
    # LISTs. The fence timeout bounds how long a covered read waits for
    # the cache to catch up to this process's own writes before falling
    # through to a real apiserver call.
    informer_enabled: bool = True
    informer_fence_timeout_s: float = 2.0
    # Crash-safe attach journal file (worker/journal.py): intent records
    # before actuation, replayed at boot. Empty = journaling disabled
    # (direct Settings() construction, e.g. unit rigs that build their
    # own); from_env defaults it ON at consts.DEFAULT_JOURNAL_PATH so a
    # production worker always journals unless explicitly opted out with
    # TPU_JOURNAL_PATH="".
    journal_path: str = ""
    # Attach broker (master/admission.py + master/lease.py): per-tenant
    # chip quotas, work-conserving burst headroom, attachment-lease TTL
    # and the contention-queue bounds. All defaults preserve the
    # historical behavior exactly: no quotas, leases never expire, no
    # queueing (InsufficientTPU answers 503 immediately).
    tenant_quotas: dict[str, int] = dataclasses.field(default_factory=dict)
    quota_burst: float = 1.0
    lease_ttl_s: float = 0.0
    queue_timeout_s: float = 0.0
    queue_depth: int = 64
    # Elastic slice subsystem (master/slicetxn.py): how long a parked
    # gang may HOLD partially reserved hosts before handing them back
    # (anti-deadlock). Gangs only exist when queue_timeout_s > 0.
    gang_hold_s: float = consts.DEFAULT_GANG_HOLD_S
    # Re-federation barrier (master/slicetxn.py): incomplete past this
    # window = STUCK (doctor WARN naming the missing members).
    resize_barrier_timeout_s: float = \
        consts.DEFAULT_RESIZE_BARRIER_TIMEOUT_S
    # Worker-side mesh-generation notification files (worker/service.py):
    # directory stamped on every actuation; "" = disabled.
    mesh_gen_dir: str = ""
    # HA control plane (master/shardring.py HAConfig.from_settings):
    # admission sharding, per-shard leader election, and the declarative
    # intent store. ALL defaults preserve single-master semantics:
    # one shard, no election (this replica owns everything), no store
    # (state is process-resident + slave-pod re-derivation).
    master_shards: int = 1
    election_enabled: bool = False
    election_renew_s: float = consts.DEFAULT_ELECTION_RENEW_S
    election_ttl_s: float = consts.DEFAULT_ELECTION_TTL_S
    intent_store_enabled: bool = False
    replica_id: str = ""
    advertise_url: str = ""
    shard_forward: str = "proxy"            # "proxy" | "redirect"
    # Kernel-enforced device gate (actuation/gate.py): "auto" (default ON
    # — map-driven eBPF backend on cgroup v2, devices.allow/deny writes
    # on v1, journaled + audited either way) or "legacy" (byte-for-byte
    # today's semantics: direct cgroup-controller calls, no gate state).
    gate_mode: str = "auto"
    # Resident actuation agent (actuation/agent.py): cached namespace fds
    # + in-process batch execution on the attach/detach hot path, with
    # transparent fallback on any agent fault. Default ON in production;
    # TPU_AGENT=0 reverts to direct per-call actuation.
    agent_enabled: bool = True
    # PyEnumerator inventory-scan cache TTL (0 = rescan every enumerate).
    # from_env defaults it on; plain Settings() keeps the historical
    # rescan-always behavior for fixture-mutating unit rigs.
    enum_cache_ttl_s: float = 0.0
    # How long a detach may be resolved from the attachment record cached
    # at attach time (validated against the informer's slave-pod view).
    attach_cache_ttl_s: float = consts.DEFAULT_ATTACH_CACHE_TTL_S
    # Chip usage sampler (collector/usage.py): background per-chip
    # duty-cycle + device-open accounting served as GET /utilz. ON by
    # default; TPU_USAGE=0 removes the thread and every new series, so
    # existing endpoints answer exactly the pre-sampler payloads.
    usage_enabled: bool = True
    usage_interval_s: float = consts.DEFAULT_USAGE_INTERVAL_S
    # Master-side idle-lease threshold (seconds of zero observed duty
    # before the broker marks a lease idle). Only meaningful while
    # worker utilization telemetry is flowing.
    idle_lease_s: float = consts.DEFAULT_IDLE_LEASE_S
    # Fleet topology plane (collector/topology.py): snapshot-only chip
    # coordinate + occupancy view served as GET /topoz. ON by default;
    # TPU_TOPOLOGY=0 removes the endpoint payload, the fleet scrape and
    # every new series, so existing endpoints answer exactly the
    # pre-topology payloads.
    topology_enabled: bool = True
    # Fleet defragmenter (master/defrag.py): the actuator over the
    # topology plane's candidate report. "plan" (default) journals plans
    # without actuating; "act" executes grow-first migrations through
    # the slice repair seam; "0" removes the subsystem byte-for-byte.
    defrag_mode: str = "plan"               # "0" | "plan" | "act"
    defrag_hysteresis_ticks: int = consts.DEFAULT_DEFRAG_HYSTERESIS_TICKS
    defrag_idle_duty_max: float = consts.DEFAULT_DEFRAG_IDLE_DUTY_MAX
    defrag_max_inflight: int = consts.DEFAULT_DEFRAG_MAX_INFLIGHT
    defrag_budget: int = consts.DEFAULT_DEFRAG_BUDGET
    # Graceful worker drain (worker/drain.py): how long the SIGTERM /
    # /drainz sequence waits for in-flight actuation to settle before
    # the gRPC server goes down anyway.
    drain_timeout_s: float = consts.DEFAULT_DRAIN_TIMEOUT_S
    # Spot-termination watcher: path polled for the preemption notice;
    # the file appearing triggers a proactive drain. "" = no watcher.
    spot_termination_file: str = ""
    # Slice self-healing budget (master/slicetxn.py): repair txns one
    # group may consume before it is torn down as a unit instead.
    slice_repair_budget: int = consts.DEFAULT_SLICE_REPAIR_BUDGET
    # The 10k admission path (utils/parking.py, master/waiterindex.py,
    # master/store.py group commit). Plain Settings() keeps every
    # historical default for direct-construction rigs (thread-pool gRPC
    # server, per-record store CAS); from_env turns the parking executor
    # and the store coalescer ON — TPU_GRPC_ASYNC=0 /
    # TPU_STORE_GROUP_COMMIT=0 revert each byte-for-byte. The waiter
    # index defaults ON everywhere (its selection is pinned equivalent
    # to the linear scan); TPU_WAITER_INDEX=0 reverts it.
    grpc_workers: int = consts.DEFAULT_GRPC_WORKERS
    grpc_async: bool = False
    grpc_max_parked: int = consts.DEFAULT_GRPC_MAX_PARKED
    waiter_index: bool = True
    store_group_commit_s: float = 0.0
    host: HostPaths = dataclasses.field(default_factory=HostPaths)

    @classmethod
    def from_env(cls, env: dict[str, str] | None = None) -> "Settings":
        env = dict(os.environ if env is None else env)
        s = cls()
        s.pool_namespace = env.get(consts.ENV_POOL_NAMESPACE,
                                   consts.DEFAULT_POOL_NAMESPACE)
        driver = env.get(consts.ENV_CGROUP_DRIVER, "systemd")
        if driver not in ("systemd", "cgroupfs"):
            raise ValueError(
                f"unsupported cgroup driver {driver!r} "
                "(ref cgroup.go:78-84 accepts systemd|cgroupfs)")
        s.cgroup_driver = driver
        s.node_name = env.get("NODE_NAME", "")
        if t := env.get("TPU_ALLOCATION_TIMEOUT_S"):
            s.allocation_timeout_s = float(t)
        if t := env.get("TPU_KUBELET_LAG_TIMEOUT_S"):
            s.kubelet_lag_timeout_s = float(t)
        s.allow_fake_devices = env.get("TPU_ALLOW_FAKE_DEVICES") == "1"
        s.warm_pool_sizes = parse_warm_pool_sizes(
            env.get(consts.ENV_WARM_POOL, ""))
        s.warm_pool_enabled = bool(s.warm_pool_sizes)
        if t := env.get(consts.ENV_WARM_POOL_INTERVAL_S):
            s.warm_pool_interval_s = float(t)
        s.journal_path = env.get(consts.ENV_JOURNAL_PATH,
                                 consts.DEFAULT_JOURNAL_PATH)
        s.tenant_quotas = parse_tenant_quotas(env.get(consts.ENV_QUOTAS, ""))
        if t := env.get(consts.ENV_QUOTA_BURST):
            s.quota_burst = float(t)
            if s.quota_burst < 1.0:
                raise ValueError(
                    f"{consts.ENV_QUOTA_BURST} must be >= 1.0 (1.0 = hard "
                    f"cap), got {s.quota_burst}")
        if t := env.get(consts.ENV_LEASE_TTL_S):
            s.lease_ttl_s = float(t)
        if t := env.get(consts.ENV_QUEUE_TIMEOUT_S):
            s.queue_timeout_s = float(t)
        if t := env.get(consts.ENV_QUEUE_DEPTH):
            s.queue_depth = int(t)
        if t := env.get(consts.ENV_GANG_HOLD_S):
            s.gang_hold_s = float(t)
            if s.gang_hold_s <= 0:
                raise ValueError(
                    f"{consts.ENV_GANG_HOLD_S} must be > 0 (a gang that "
                    f"never hands back can deadlock a peer), got {t!r}")
        if t := env.get(consts.ENV_RESIZE_BARRIER_TIMEOUT_S):
            s.resize_barrier_timeout_s = float(t)
            if s.resize_barrier_timeout_s <= 0:
                raise ValueError(
                    f"{consts.ENV_RESIZE_BARRIER_TIMEOUT_S} must be "
                    "> 0 seconds (a barrier that can never be judged "
                    f"stuck hides dead members forever), got {t!r}")
        s.mesh_gen_dir = env.get(consts.ENV_MESH_GEN_DIR, "")
        if t := env.get(consts.ENV_MASTER_SHARDS):
            s.master_shards = int(t)
            if s.master_shards < 1:
                raise ValueError(
                    f"{consts.ENV_MASTER_SHARDS} must be >= 1, got {t!r}")
        s.election_enabled = env.get(consts.ENV_ELECTION, "0") == "1"
        if t := env.get(consts.ENV_ELECTION_RENEW_S):
            s.election_renew_s = float(t)
        if t := env.get(consts.ENV_ELECTION_TTL_S):
            s.election_ttl_s = float(t)
        if s.election_ttl_s < s.election_renew_s:
            raise ValueError(
                f"{consts.ENV_ELECTION_TTL_S} ({s.election_ttl_s}) must be "
                f">= {consts.ENV_ELECTION_RENEW_S} ({s.election_renew_s}): "
                "a lock that expires between renewals flaps leadership")
        s.intent_store_enabled = env.get(consts.ENV_INTENT_STORE, "0") == "1"
        s.replica_id = env.get(consts.ENV_REPLICA_ID, "")
        s.advertise_url = env.get(consts.ENV_ADVERTISE_URL, "")
        forward = env.get(consts.ENV_SHARD_FORWARD, "proxy")
        if forward not in ("proxy", "redirect"):
            raise ValueError(
                f"{consts.ENV_SHARD_FORWARD} must be proxy|redirect, "
                f"got {forward!r}")
        s.shard_forward = forward
        s.informer_enabled = env.get(consts.ENV_INFORMER, "1") != "0"
        gate = env.get(consts.ENV_GATE, "auto")
        # "0" is accepted as a legacy alias ("1" as auto) for symmetry
        # with the other feature knobs; unknown values fail the boot.
        gate = {"0": "legacy", "1": "auto"}.get(gate, gate)
        if gate not in ("auto", "legacy"):
            raise ValueError(
                f"{consts.ENV_GATE} must be auto|legacy (or 1|0), "
                f"got {env.get(consts.ENV_GATE)!r}")
        s.gate_mode = gate
        s.agent_enabled = env.get(consts.ENV_AGENT, "1") != "0"
        if t := env.get(consts.ENV_ENUM_CACHE_TTL_S):
            s.enum_cache_ttl_s = float(t)
        else:
            s.enum_cache_ttl_s = consts.DEFAULT_ENUM_CACHE_TTL_S
        if t := env.get(consts.ENV_ATTACH_CACHE_TTL_S):
            s.attach_cache_ttl_s = float(t)
        s.usage_enabled = env.get(consts.ENV_USAGE, "1") != "0"
        s.topology_enabled = env.get(consts.ENV_TOPOLOGY, "1") != "0"
        mode = env.get(consts.ENV_DEFRAG_MODE, "plan")
        if mode not in ("0", "plan", "act"):
            raise ValueError(
                f"{consts.ENV_DEFRAG_MODE} must be 0|plan|act, got {mode!r}")
        s.defrag_mode = mode
        if t := env.get(consts.ENV_DEFRAG_HYSTERESIS_TICKS):
            s.defrag_hysteresis_ticks = int(t)
            if s.defrag_hysteresis_ticks < 1:
                raise ValueError(
                    f"{consts.ENV_DEFRAG_HYSTERESIS_TICKS} must be >= 1 "
                    f"(a 0-tick hysteresis moves on a single noisy "
                    f"observation), got {t!r}")
        if t := env.get(consts.ENV_DEFRAG_IDLE_DUTY_MAX):
            s.defrag_idle_duty_max = float(t)
            if not 0.0 <= s.defrag_idle_duty_max <= 1.0:
                raise ValueError(
                    f"{consts.ENV_DEFRAG_IDLE_DUTY_MAX} must be within "
                    f"[0, 1] (it is a duty-cycle fraction), got {t!r}")
        if t := env.get(consts.ENV_DEFRAG_MAX_INFLIGHT):
            s.defrag_max_inflight = int(t)
            if s.defrag_max_inflight < 1:
                raise ValueError(
                    f"{consts.ENV_DEFRAG_MAX_INFLIGHT} must be >= 1; use "
                    f"{consts.ENV_DEFRAG_MODE}=plan to stop actuation, "
                    f"got {t!r}")
        if t := env.get(consts.ENV_DEFRAG_BUDGET):
            s.defrag_budget = int(t)
            if s.defrag_budget < 1:
                raise ValueError(
                    f"{consts.ENV_DEFRAG_BUDGET} must be >= 1; use "
                    f"{consts.ENV_DEFRAG_MODE}=plan to stop actuation, "
                    f"got {t!r}")
        if t := env.get(consts.ENV_USAGE_INTERVAL_S):
            s.usage_interval_s = float(t)
            if s.usage_interval_s <= 0:
                raise ValueError(
                    f"{consts.ENV_USAGE_INTERVAL_S} must be > 0 (a zero "
                    f"interval would busy-spin the sampler thread), got "
                    f"{t!r}; use {consts.ENV_USAGE}=0 to disable")
        if t := env.get(consts.ENV_IDLE_LEASE_S):
            s.idle_lease_s = float(t)
            if s.idle_lease_s <= 0:
                raise ValueError(
                    f"{consts.ENV_IDLE_LEASE_S} must be > 0, got {t!r}")
        if t := env.get(consts.ENV_DRAIN_TIMEOUT_S):
            s.drain_timeout_s = float(t)
            if s.drain_timeout_s <= 0:
                raise ValueError(
                    f"{consts.ENV_DRAIN_TIMEOUT_S} must be > 0 (a zero "
                    f"window would yank in-flight actuation), got {t!r}")
        s.spot_termination_file = env.get(
            consts.ENV_SPOT_TERMINATION_FILE, "")
        if t := env.get(consts.ENV_GRPC_WORKERS):
            s.grpc_workers = int(t)
            if s.grpc_workers < 1:
                raise ValueError(
                    f"{consts.ENV_GRPC_WORKERS} must be >= 1, got {t!r}")
        s.grpc_async = env.get(consts.ENV_GRPC_ASYNC, "1") != "0"
        if t := env.get(consts.ENV_GRPC_MAX_PARKED):
            s.grpc_max_parked = int(t)
        # validated as a PAIR regardless of which knob was set: a large
        # TPU_GRPC_WORKERS alone must fail here with the env names, not
        # later in ParkingExecutor with a generic message
        if s.grpc_max_parked < s.grpc_workers:
            raise ValueError(
                f"{consts.ENV_GRPC_MAX_PARKED} ({s.grpc_max_parked}) "
                f"must be >= {consts.ENV_GRPC_WORKERS} "
                f"({s.grpc_workers})")
        s.waiter_index = env.get(consts.ENV_WAITER_INDEX, "1") != "0"
        raw_gc = env.get(consts.ENV_STORE_GROUP_COMMIT)
        if raw_gc is None:
            s.store_group_commit_s = consts.DEFAULT_STORE_GROUP_COMMIT_S
        else:
            s.store_group_commit_s = float(raw_gc)
            if s.store_group_commit_s < 0:
                raise ValueError(
                    f"{consts.ENV_STORE_GROUP_COMMIT} must be >= 0 "
                    f"seconds (0 = per-record CAS), got {raw_gc!r}")
        if t := env.get(consts.ENV_SLICE_REPAIR_BUDGET):
            s.slice_repair_budget = int(t)
            if s.slice_repair_budget < 0:
                raise ValueError(
                    f"{consts.ENV_SLICE_REPAIR_BUDGET} must be >= 0 "
                    f"(0 = never repair, always tear down), got {t!r}")
        if t := env.get(consts.ENV_INFORMER_FENCE_TIMEOUT_S):
            s.informer_fence_timeout_s = float(t)
        if p := env.get("TPU_WORKER_GRPC_PORT"):
            s.worker_grpc_port = int(p)
        if p := env.get("TPU_MASTER_HTTP_PORT"):
            s.master_http_port = int(p)
        # Host roots are env-overridable so DaemonSets that mount the node
        # filesystem at non-standard paths (/host-sys, /host-proc) — and
        # process-level boot tests over fixture trees — can remap them.
        s.host = HostPaths(
            dev_root=env.get("TPU_DEV_ROOT", s.host.dev_root),
            proc_root=env.get("TPU_PROC_ROOT", s.host.proc_root),
            sys_root=env.get("TPU_SYS_ROOT", s.host.sys_root),
            cgroup_root=env.get("TPU_CGROUP_ROOT", s.host.cgroup_root),
            kubelet_socket=env.get("TPU_KUBELET_SOCKET",
                                   s.host.kubelet_socket))
        return s
