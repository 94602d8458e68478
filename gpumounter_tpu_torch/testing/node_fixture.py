"""A node's containers on a fixture tree: the node half of an attach without
a kubelet or a container runtime.

:class:`FixtureNode` is the worker's view of a host under one root
directory: a cgroup-v1 hierarchy (cgroupfs driver), a ``proc`` tree, and the
device gate and actuator over them (:func:`build_gate` picks the v1
backend). :class:`FixtureContainer` is one Pod's container on it: a
``devices`` cgroup whose ``cgroup.procs`` lists its PIDs, and
``proc/<pid>/root`` as its root filesystem with the /dev nodes the runtime
gave it.

Device nodes are fake — regular files with ``.majmin`` sidecars, the
enumerators' fixture format — so the tree may sit on a filesystem that
refuses mknod(2). The GPUs come from whatever enumerator the caller passes:
a fake one in tests, the real ``/dev`` and NVML on a machine with a card.
The PIDs may be real processes: busy detection reads them through the
enumerator's own ``/proc``.

    node = FixtureNode("/path/to/root")
    box = node.container("workload", pids=[os.getpid()])
    mounter = node.mounter(collector.enumerator, collector.plans)
    mounter.mount_chips(box.pod, gpus, gpus)
    box.nodes()        # {"nvidia1": (195, 1), "nvidiactl": (195, 255), ...}
    side = box.add_container("sidecar", pids=[other_pid])
"""

from __future__ import annotations

import hashlib
import os

from gpumounter_tpu_torch.actuation.cgroup import CgroupDeviceController
from gpumounter_tpu_torch.actuation.gate import build_gate
from gpumounter_tpu_torch.actuation.mount import GPUMounter
from gpumounter_tpu_torch.actuation.nsenter import ProcRootActuator
from gpumounter_tpu_torch.device.enumerator import Enumerator
from gpumounter_tpu_torch.device.plan import NodePlanCache
from gpumounter_tpu_torch.utils.config import HostPaths, Settings


class FixtureContainer:
    """One container of Pod ``default/<name>`` on a :class:`FixtureNode`:
    its first, ``main``, or another that :meth:`add_container` puts in the
    same Pod, each with its own cgroup directory and root."""

    def __init__(self, node: "FixtureNode", name: str, pids: list[int],
                 held: list[tuple[str, int, int]] = (),
                 pod: dict | None = None, container: str = "main"):
        self.node = node
        self.name = name
        self.container = container
        digest = hashlib.sha256(name.encode()).hexdigest()
        if pod is None:
            self.container_id = f"containerd://{digest}"
            self.pod = {
                "metadata": {"name": name, "namespace": "default",
                             "uid": f"{digest[:8]}-{digest[8:12]}-"
                                    f"{digest[12:16]}-{digest[16:20]}-"
                                    f"{digest[20:32]}"},
                "spec": {"containers": [{"name": container}]},
                "status": {"qosClass": "BestEffort", "containerStatuses": [
                    {"name": container, "containerID": self.container_id}]},
            }
        else:
            self.container_id = "containerd://" + hashlib.sha256(
                f"{name}/{container}".encode()).hexdigest()
            self.pod = pod
            pod["spec"]["containers"].append({"name": container})
            pod["status"]["containerStatuses"].append(
                {"name": container, "containerID": self.container_id})
        self.cgroup_dir = node.controller.container_dir(self.pod,
                                                        self.container_id)
        os.makedirs(self.cgroup_dir)
        self.set_pids(pids)
        self.dev = os.path.join(node.host.proc_root, str(pids[0]), "root",
                                "dev")
        os.makedirs(self.dev)
        for path, major, minor in held:
            target = os.path.join(self.dev, os.path.basename(path))
            open(target, "w").close()
            with open(target + ".majmin", "w") as f:
                f.write(f"{major}:{minor}")

    def add_container(self, container: str, pids: list[int],
                      held: list[tuple[str, int, int]] = ()
                      ) -> "FixtureContainer":
        """Another container of this container's Pod (a sidecar): its own
        cgroup directory, processes and root."""
        return FixtureContainer(self.node, self.name, pids, held,
                                pod=self.pod, container=container)

    def set_pids(self, pids: list[int]) -> None:
        """The container's processes, the first one its root's owner."""
        with open(os.path.join(self.cgroup_dir, "cgroup.procs"), "w") as f:
            f.write("".join(f"{pid}\n" for pid in pids))

    def nodes(self) -> dict[str, tuple[int, int]]:
        """The container's /dev: node name -> (major, minor)."""
        out = {}
        for name in sorted(os.listdir(self.dev)):
            if name.endswith(".majmin"):
                continue
            with open(os.path.join(self.dev, name + ".majmin")) as f:
                major, minor = f.read().strip().split(":")
            out[name] = (int(major), int(minor))
        return out

    def cgroup_lines(self, filename: str) -> list[str]:
        """What the gate wrote to ``devices.allow`` or ``devices.deny``."""
        path = os.path.join(self.cgroup_dir, filename)
        if not os.path.exists(path):
            return []
        with open(path) as f:
            return f.read().splitlines()


class FixtureNode:
    """Host paths, cgroup controller, device gate and actuator of a node
    under ``root``."""

    def __init__(self, root: str):
        self.host = HostPaths(
            dev_root=os.path.join(root, "dev"),
            proc_root=os.path.join(root, "proc"),
            sys_root=os.path.join(root, "sys"),
            cgroup_root=os.path.join(root, "sys", "fs", "cgroup"))
        for path in (self.host.dev_root, self.host.proc_root,
                     self.host.cgroup_root):
            os.makedirs(path, exist_ok=True)
        self.controller = CgroupDeviceController(self.host, driver="cgroupfs",
                                                 version=1)
        self.gate = build_gate(Settings(node_name="fixture-node"),
                               self.controller)
        self.actuator = ProcRootActuator(self.host, fake_nodes=True)

    def container(self, name: str, pids: list[int],
                  held: list[tuple[str, int, int]] = ()) -> FixtureContainer:
        """The ``main`` container of Pod ``default/<name>``, whose first PID
        owns its root; ``held`` are the (path, major, minor) nodes its
        runtime gave it. :meth:`FixtureContainer.add_container` adds
        another container to the Pod."""
        return FixtureContainer(self, name, pids, held)

    def mounter(self, enumerator: Enumerator,
                plans: NodePlanCache | None = None) -> GPUMounter:
        """A mounter over this node; busy detection goes through
        ``enumerator`` (and its ``/proc``)."""
        return GPUMounter(self.controller, self.actuator, enumerator,
                          self.host, plans=plans, gate=self.gate)
