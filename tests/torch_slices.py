"""Helpers of the port's slice tests: HTTP calls, slice bodies and the
port's ``MultiNodeStack`` over fixture trees. Imports no jax."""

from __future__ import annotations

import json
import os
import urllib.error
import urllib.request


def host(tmp_path, i):
    """The port's ``HostPaths`` over a fixture tree ``node<i>``."""
    from gpumounter_tpu_torch.utils.config import HostPaths
    base = os.path.join(str(tmp_path), f"node{i}")
    for sub in ("dev", "proc", "sys/fs/cgroup"):
        os.makedirs(os.path.join(base, sub), exist_ok=True)
    return HostPaths(dev_root=os.path.join(base, "dev"),
                     proc_root=os.path.join(base, "proc"),
                     sys_root=os.path.join(base, "sys"),
                     cgroup_root=os.path.join(base, "sys", "fs", "cgroup"),
                     kubelet_socket=os.path.join(base, "pr",
                                                 "kubelet.sock"))


def stack(tmp_path, hosts=2, n_chips=4, **kw):
    from gpumounter_tpu_torch.testing.sim import MultiNodeStack
    return MultiNodeStack([host(tmp_path, i) for i in range(hosts)],
                          n_chips=n_chips, **kw)


def post(url, obj):
    req = urllib.request.Request(url, data=json.dumps(obj).encode(),
                                 method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def get(url):
    try:
        with urllib.request.urlopen(url, timeout=30) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def pods(members):
    return [{"namespace": "default", "pod": f"workload-{i}"}
            for i in members]


def slice_body(n, gpus=4, **extra):
    body = {"pods": pods(range(n)), "gpusPerHost": gpus}
    body.update(extra)
    return body


def block_node(s, node_index, gpus=4, name="blocker"):
    """Occupy a node's GPUs via the per-pod route (a non-slice tenant)."""
    s.add_workload(node_index, name)
    with urllib.request.urlopen(
            f"{s.base}/addgpu/namespace/default/pod/{name}"
            f"/gpu/{gpus}/isEntireMount/true") as resp:
        assert resp.status == 200
    return name


def invariants(s):
    from gpumounter_tpu_torch.testing.chaos import assert_slice_invariants
    assert_slice_invariants(s.gateway.broker, [r.sim for r in s.rigs],
                            kube=s.master_kube)
