"""Host actuation for NVIDIA GPUs: cgroup device permissioning (v1 file /
v2 eBPF), the device gate, mount-namespace entry and the device-node
lifecycle (the port of :mod:`gpumounter_tpu.actuation`; ref ``pkg/util``,
``pkg/util/cgroup``, ``pkg/util/namespace``)."""
