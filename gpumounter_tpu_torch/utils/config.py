"""Runtime configuration: the port's copy of ``HostPaths``
(``gpumounter_tpu/utils/config.py``).

Every host path the device layer reads is a parameter, so each layer can
run against a fixture tree in tests.
"""

from __future__ import annotations

import dataclasses

from gpumounter_tpu_torch.utils.consts import KUBELET_SOCKET_PATH


@dataclasses.dataclass
class HostPaths:
    """Roots of every host filesystem the worker touches. Production uses
    the real roots; tests point these at fixture trees."""

    dev_root: str = "/dev"
    proc_root: str = "/proc"
    sys_root: str = "/sys"
    cgroup_root: str = "/sys/fs/cgroup"
    kubelet_socket: str = KUBELET_SOCKET_PATH
