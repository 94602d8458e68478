"""Constants the port shares with the control plane, as its own copies.

The port imports nothing of :mod:`gpumounter_tpu`; where a value is part
of a contract between the two (a deadline both sides judge by, a format
tag both packages read), it is copied here and must stay equal to the
control plane's.
"""

import enum

# How long a re-federation barrier may sit incomplete before the control
# plane surfaces it as STUCK (``gpumounter_tpu/utils/consts.py``,
# ``DEFAULT_RESIZE_BARRIER_TIMEOUT_S``). Members poll with the same
# deadline, so the two sides never desynchronise.
DEFAULT_RESIZE_BARRIER_TIMEOUT_S = 120.0

# The sharded checkpoint's format tag (``jaxcheck/drain.py``,
# ``SHARDED_FORMAT``): a root written by either package names the same
# format, so each package's checks accept the other's commits.
SHARDED_FORMAT = "tpumounter-sharded-v1"

# --- NVIDIA GPUs (the device layer, ``device/``) ------------------------------
# The scheduler resource; the kubelet's PodResources API reports each
# allocated device by the driver's UUID (``GPU-...``).
GPU_RESOURCE_NAME = "nvidia.com/gpu"
# /dev/nvidiaN char nodes, fixed major 195, minor N.
NVIDIA_DEV_PREFIX = "/dev/nvidia"
NVIDIA_MAJOR = 195
# Nodes every GPU of a node shares, exposed with any one of them. nvidiactl
# is 195:255; the uvm major is dynamic (``/proc/devices``).
NVIDIA_CTL_NAME = "nvidiactl"
NVIDIA_CTL_MINOR = 255
NVIDIA_UVM_NAME = "nvidia-uvm"
NVIDIA_UVM_TOOLS_NAME = "nvidia-uvm-tools"
NVIDIA_COMPANION_NAMES = (NVIDIA_CTL_NAME, NVIDIA_UVM_NAME,
                          NVIDIA_UVM_TOOLS_NAME)
# Names the driver registers in /proc/devices: the GPUs' and nvidiactl's
# major (195) under the first two, the uvm module's under the last.
NVIDIA_PROC_DEVICES_NAMES = ("nvidia", "nvidiactl")
NVIDIA_UVM_PROC_DEVICES_NAME = "nvidia-uvm"

# Device node permissions inside the target container: "rw" cgroup
# permission, 0666 file mode.
DEVICE_CGROUP_PERMISSIONS = "rw"
DEVICE_FILE_MODE = 0o666

# --- Kubelet PodResources API and slave pods (the control plane's values) ----
KUBELET_SOCKET_PATH = "/var/lib/kubelet/pod-resources/kubelet.sock"
PODRESOURCES_CONNECT_TIMEOUT_S = 10.0
# The namespace of the slave pods that hold GPUs for their owners.
DEFAULT_POOL_NAMESPACE = "gpu-pool"

# --- Slave pods (ref pkg/util/gpu/allocator/allocator.go:192-231) -------------
# ``<owner>-slave-pod-<hex>``, labelled ``app: gpu-pool`` as the reference
# labels its GPU slave pods; the ownership, mount-type, request and
# transaction labels are the control plane's.
SLAVE_POD_INFIX = "-slave-pod-"
SLAVE_POD_LABEL_KEY = "app"
SLAVE_POD_LABEL_VALUE = "gpu-pool"
MOUNT_TYPE_LABEL_KEY = "tpumounter.io/mount-type"
OWNER_POD_LABEL_KEY = "tpumounter.io/owner-pod"
OWNER_NAMESPACE_LABEL_KEY = "tpumounter.io/owner-namespace"
# A same-named recreated owner must not adopt stale slave pods.
OWNER_UID_LABEL_KEY = "tpumounter.io/owner-uid"
TXN_LABEL_KEY = "tpumounter.io/txn-id"
# A retried attach adopts the slave pods its earlier attempt created.
REQUEST_ID_LABEL_KEY = "tpumounter.io/request-id"
# Warm (pre-scheduled, unowned) slave pods of the warm pool.
WARM_POD_LABEL_KEY = "tpumounter.io/warm"
WARM_POD_LABEL_VALUE = "true"
WARM_POD_NAME_PREFIX = "warm"
WARM_POD_NODE_LABEL_KEY = "tpumounter.io/node"
SLAVE_POD_IMAGE = "registry.k8s.io/pause:3.9"
# Slice-repair spares: pods the master may grow a repaired gang onto.
SLICE_SPARE_LABEL_KEY = "tpumounter.io/slice-spare"
SLICE_SPARE_LABEL_VALUE = "true"

# --- GKE GPU node labels (allocator/topology.py) ------------------------------
# The accelerator of a GKE GPU node pool (e.g. ``nvidia-h100-80gb``); the
# node's allocatable ``nvidia.com/gpu`` is the GPU count.
LABEL_GPU_ACCELERATOR = "cloud.google.com/gke-accelerator"
# Stamped on slave pods so a mount's accelerator is readable from the pool
# namespace without a node round trip.
GPU_ACCELERATOR_LABEL_KEY = "tpumounter.io/gpu-accelerator"

# --- Ports and worker discovery (ref worker main.go:24 :1200, master :8080) --
MASTER_HTTP_PORT = 8080
WORKER_GRPC_PORT = 1200
WORKER_NAMESPACE = "kube-system"
WORKER_LABEL_SELECTOR = "app=gpu-mounter-worker"


class MountType(str, enum.Enum):
    """How a pod holds its devices (ref ``pkg/util/gpu/types.go:19-26``)."""

    ENTIRE = "entire-mount"
    SINGLE = "single-mount"
    NONE = "no-mount"
    UNKNOWN = "unknown-mount"


class AddResult(enum.IntEnum):
    """Wire values of ``AddGPUResponse.result`` (ref api.proto:11-19)."""

    SUCCESS = 0
    INSUFFICIENT_GPU = 1
    POD_NOT_FOUND = 2


class RemoveResult(enum.IntEnum):
    """Wire values of ``RemoveGPUResponse.result`` (ref api.proto:32-41).
    Tag 3 is skipped, as in the reference."""

    SUCCESS = 0
    GPU_BUSY = 1
    POD_NOT_FOUND = 2
    GPU_NOT_FOUND = 4


# --- Telemetry and the device gate (environment variables) --------------------
# The names are the control plane's, so one deployment configures both.
# "0" disables lifecycle events; the JSONL sidecar and ring size are
# optional.
ENV_EVENTS = "TPU_EVENTS"
ENV_EVENT_LOG = "TPU_EVENT_LOG"
ENV_EVENT_RING = "TPU_EVENT_RING"
# Flight-recorder bundle directory (unset = disabled) and the minimum
# seconds between bundles.
ENV_FLIGHT_DIR = "TPU_FLIGHT_DIR"
ENV_FLIGHT_INTERVAL_S = "TPU_FLIGHT_INTERVAL_S"
# Device-gate mode: "auto" (the strongest backend the node supports) or
# "legacy" (direct cgroup-controller calls, no gate state).
ENV_GATE = "TPU_GATE"

# --- The worker's knobs (environment variables; utils/config.py) --------------
# The names are the control plane's, so one deployment configures both.
ENV_POOL_NAMESPACE = "TPU_POOL_NAMESPACE"
ENV_CGROUP_DRIVER = "CGROUP_DRIVER"
# Warm-pool sizing ("entire:4=1,single:1=2" keeps one 4-GPU entire-mount
# pod and two 1-GPU single-mount pods warm per node); unset = no pool.
ENV_WARM_POOL = "TPU_WARM_POOL"
ENV_WARM_POOL_INTERVAL_S = "TPU_WARM_POOL_INTERVAL_S"
# Crash-safe attach journal (worker/journal.py); "" disables it.
ENV_JOURNAL_PATH = "TPU_JOURNAL_PATH"
DEFAULT_JOURNAL_PATH = "/var/lib/tpu-mounter/attach-journal.jsonl"
# Shared pod informer (k8s/informer.py): "0" reverts reads to direct
# apiserver calls; the fence timeout bounds a read-your-writes wait.
ENV_INFORMER = "TPU_INFORMER"
ENV_INFORMER_FENCE_TIMEOUT_S = "TPU_INFORMER_FENCE_TIMEOUT_S"
# Resident actuation agent (actuation/agent.py): "0" reverts to direct
# per-call actuation.
ENV_AGENT = "TPU_AGENT"
# The enumerator's inventory cache (PyEnumerator cache_ttl_s).
ENV_ENUM_CACHE_TTL_S = "TPU_ENUM_CACHE_TTL_S"
DEFAULT_ENUM_CACHE_TTL_S = 5.0
# How long a detach may be resolved from the record cached at attach time.
ENV_ATTACH_CACHE_TTL_S = "TPU_ATTACH_CACHE_TTL_S"
DEFAULT_ATTACH_CACHE_TTL_S = 600.0
# The worker's gRPC executor: active-thread budget, parking mode ("0" =
# the fixed thread pool) and the in-flight ceiling.
ENV_GRPC_WORKERS = "TPU_GRPC_WORKERS"
DEFAULT_GRPC_WORKERS = 8
ENV_GRPC_ASYNC = "TPU_GRPC_ASYNC"
ENV_GRPC_MAX_PARKED = "TPU_GRPC_MAX_PARKED"
DEFAULT_GRPC_MAX_PARKED = 4096
# Graceful drain (worker/drain.py) and the spot-termination notice file.
ENV_DRAIN_TIMEOUT_S = "TPU_DRAIN_TIMEOUT_S"
DEFAULT_DRAIN_TIMEOUT_S = 30.0
ENV_SPOT_TERMINATION_FILE = "TPU_SPOT_TERMINATION_FILE"
# The draining refusal's gRPC detail starts with this marker.
DRAINING_DETAIL_PREFIX = "draining:"
# Detach cause (gRPC metadata, master -> worker).
DETACH_CAUSE_METADATA_KEY = "x-detach-cause"
# Per-owner-pod mesh-generation files the worker stamps on each actuation.
ENV_MESH_GEN_DIR = "TPU_MESH_GEN_DIR"
# The usage sampler and the topology view (Queue 1 item 12 of the port):
# the worker reads the knobs and serves /utilz and /topoz as disabled.
ENV_USAGE = "TPU_USAGE"
ENV_USAGE_INTERVAL_S = "TPU_USAGE_INTERVAL_S"
DEFAULT_USAGE_INTERVAL_S = 5.0
ENV_TOPOLOGY = "TPU_TOPOLOGY"

# --- The master's knobs, kept in ``Settings`` beside the worker's -------------
ENV_QUOTAS = "TPU_QUOTAS"
ENV_QUOTA_BURST = "TPU_QUOTA_BURST"
ENV_LEASE_TTL_S = "TPU_LEASE_TTL_S"
ENV_QUEUE_TIMEOUT_S = "TPU_QUEUE_TIMEOUT_S"
ENV_QUEUE_DEPTH = "TPU_QUEUE_DEPTH"
ENV_WAITER_INDEX = "TPU_WAITER_INDEX"
ENV_STORE_GROUP_COMMIT = "TPU_STORE_GROUP_COMMIT"
DEFAULT_STORE_GROUP_COMMIT_S = 0.01
ENV_MASTER_SHARDS = "TPU_MASTER_SHARDS"
ENV_ELECTION = "TPU_ELECTION"
ENV_ELECTION_RENEW_S = "TPU_ELECTION_RENEW_S"
ENV_ELECTION_TTL_S = "TPU_ELECTION_TTL_S"
DEFAULT_ELECTION_RENEW_S = 2.0
DEFAULT_ELECTION_TTL_S = 6.0
ENV_INTENT_STORE = "TPU_INTENT_STORE"
ENV_REPLICA_ID = "TPU_REPLICA_ID"
ENV_ADVERTISE_URL = "TPU_ADVERTISE_URL"
ENV_SHARD_FORWARD = "TPU_SHARD_FORWARD"
ENV_GANG_HOLD_S = "TPU_GANG_HOLD_S"
DEFAULT_GANG_HOLD_S = 15.0
ENV_RESIZE_BARRIER_TIMEOUT_S = "TPU_RESIZE_BARRIER_TIMEOUT_S"
ENV_IDLE_LEASE_S = "TPU_IDLE_LEASE_S"
DEFAULT_IDLE_LEASE_S = 300.0
ENV_DEFRAG_MODE = "TPU_DEFRAG_MODE"
ENV_DEFRAG_HYSTERESIS_TICKS = "TPU_DEFRAG_HYSTERESIS_TICKS"
DEFAULT_DEFRAG_HYSTERESIS_TICKS = 3
ENV_DEFRAG_IDLE_DUTY_MAX = "TPU_DEFRAG_IDLE_DUTY_MAX"
DEFAULT_DEFRAG_IDLE_DUTY_MAX = 0.05
ENV_DEFRAG_MAX_INFLIGHT = "TPU_DEFRAG_MAX_INFLIGHT"
DEFAULT_DEFRAG_MAX_INFLIGHT = 1
ENV_DEFRAG_BUDGET = "TPU_DEFRAG_BUDGET"
DEFAULT_DEFRAG_BUDGET = 4
ENV_SLICE_REPAIR_BUDGET = "TPU_SLICE_REPAIR_BUDGET"
DEFAULT_SLICE_REPAIR_BUDGET = 3

# --- The master gateway (master/gateway.py, master/httpfront.py) --------------
# The names are the control plane's, so one deployment configures both.
# Fleet aggregator (master/fleet.py) scrape cadence, default 5 s.
ENV_FLEET_INTERVAL_S = "TPU_FLEET_INTERVAL_S"
# "multiplexed" (default): the bounded selector + worker-pool front;
# "threaded": thread-per-request ThreadingHTTPServer.
ENV_GATEWAY_FRONT = "TPU_GATEWAY_FRONT"
# Worker threads of the multiplexed front (0/unset = min(32, 4*cores)).
ENV_GATEWAY_WORKERS = "TPU_GATEWAY_WORKERS"
# Connection admission bound; beyond it new connections get a canned 503.
ENV_GATEWAY_MAX_CONNS = "TPU_GATEWAY_MAX_CONNS"
# gRPC channels kept per worker target (round-robined per call).
ENV_GATEWAY_WORKER_CHANNELS = "TPU_GATEWAY_WORKER_CHANNELS"
# Planes the port's master does not run yet (ROADMAP Queue 1 item 12):
# the master serves as the control plane's does with both set to "0".
ENV_NODE_HEALTH = "TPU_NODE_HEALTH"

# Request headers naming the tenant/priority (query params ?tenant= /
# ?priority= take precedence; both fall back to namespace / "normal").
TENANT_HEADER = "X-Tpu-Tenant"
PRIORITY_HEADER = "X-Tpu-Priority"
# Priority vocabulary, weakest first — index is the comparison rank.
PRIORITIES = ("low", "normal", "high")
DEFAULT_PRIORITY = "normal"
