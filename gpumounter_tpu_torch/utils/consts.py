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


class MountType(str, enum.Enum):
    """How a pod holds its devices (ref ``pkg/util/gpu/types.go:19-26``)."""

    ENTIRE = "entire-mount"
    SINGLE = "single-mount"
    NONE = "no-mount"
    UNKNOWN = "unknown-mount"


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
