"""Constants the port shares with the control plane, as its own copies.

The port imports nothing of :mod:`gpumounter_tpu`; where a value is part
of a contract between the two (a deadline both sides judge by, a format
tag both packages read), it is copied here and must stay equal to the
control plane's.
"""

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
