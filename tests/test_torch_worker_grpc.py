"""The port's worker over the wire, against the control plane's: the
``gpu_mount`` contract keeps the reference's names and tags (``AddGPU``,
``RemoveGPU``, ``gpu_num``, ``InsufficientGPU = 1``, ``GPUBusy = 1``,
``GPUNotFound = 4`` with tag 3 skipped) and ``tpu_mount``'s extensions;
both generated modules load in one process; the same requests over real
gRPC give the same answers in both packages (device ids are the GPUs'
UUIDs, device paths their own nodes, no companions); busy PIDs, policy
and actuation failures cross the wire as in the control plane. Then the
apiserver round trips of an attach, equal in both packages."""

import grpc
import pytest

from tests.torch_control_plane import BOTH, IDS, JAX, TORCH, norm_path

from gpumounter_tpu.api import tpu_mount_pb2
from gpumounter_tpu_torch.api import gpu_mount_pb2


def test_both_contracts_load_in_one_process():
    assert gpu_mount_pb2.DESCRIPTOR.package == "gpu_mount"
    assert tpu_mount_pb2.DESCRIPTOR.package == "tpu_mount"
    assert gpu_mount_pb2.DESCRIPTOR.name == "gpu_mount.proto"
    assert set(gpu_mount_pb2.DESCRIPTOR.services_by_name) == {
        "GPUMountService"}
    methods = gpu_mount_pb2.DESCRIPTOR.services_by_name[
        "GPUMountService"].methods_by_name
    assert sorted(methods) == ["AddGPU", "GPUNodeStatus", "GPUStatus",
                               "RemoveGPU"]


def test_enum_tags_are_the_references():
    add = gpu_mount_pb2.AddGPUResponse
    remove = gpu_mount_pb2.RemoveGPUResponse
    assert (add.Success, add.InsufficientGPU, add.PodNotFound) == (0, 1, 2)
    assert (remove.Success, remove.GPUBusy, remove.PodNotFound,
            remove.GPUNotFound) == (0, 1, 2, 4)
    tags = [v.number for v in
            remove.DESCRIPTOR.enum_types_by_name["RemoveGPUResult"].values]
    assert 3 not in tags
    # the service's enums carry the same numbers
    consts = TORCH.consts
    assert [int(r) for r in consts.AddResult] == [0, 1, 2]
    assert [int(r) for r in consts.RemoveResult] == [0, 1, 2, 4]
    assert consts.RemoveResult.GPU_NOT_FOUND == remove.GPUNotFound


def test_request_fields_keep_tpu_mounts_extensions():
    def fields(msg):
        return {f.name: f.number for f in msg.DESCRIPTOR.fields}
    assert fields(gpu_mount_pb2.AddGPURequest) == {
        "pod_name": 1, "namespace": 2, "gpu_num": 3, "is_entire_mount": 4,
        "txn_id": 5}
    assert fields(gpu_mount_pb2.AddGPUResponse) == {
        "result": 1, "device_ids": 2, "device_paths": 3}
    assert fields(gpu_mount_pb2.RemoveGPURequest) == fields(
        tpu_mount_pb2.RemoveTPURequest)
    assert fields(gpu_mount_pb2.RemoveGPUResponse) == {"result": 1,
                                                       "busy_pids": 2}


@pytest.fixture(params=BOTH, ids=IDS)
def pkg(request):
    return request.param


@pytest.fixture
def live(pkg, tmp_path):
    rig = pkg.rig(tmp_path)
    grpc_mod = pkg.mod("worker.grpc_server")
    server, port = grpc_mod.build_server(rig.service, port=0,
                                         address="127.0.0.1")
    server.start()
    client = grpc_mod.WorkerClient(f"127.0.0.1:{port}", timeout_s=30)
    yield rig, client
    client.close()
    server.stop(grace=0).wait()
    rig.close()


def _add(pkg, client, *args):
    return getattr(client, f"add_{pkg.dev}")(*args)


def _remove(pkg, client, *args):
    return getattr(client, f"remove_{pkg.dev}")(*args)


def test_add_and_remove_over_the_wire(pkg, live):
    rig, client = live
    resp = _add(pkg, client, "workload", "default", 2, False)
    assert resp.result == 0 and len(resp.device_ids) == 2
    assert [norm_path(p) for p in resp.device_paths] == ["dev0", "dev1"]
    if pkg is TORCH:
        assert list(resp.device_ids) == [pkg.uuid(0), pkg.uuid(1)]
        assert list(resp.device_paths) == ["/dev/nvidia0", "/dev/nvidia1"]
    out = _remove(pkg, client, "workload", "default", list(resp.device_ids),
                  False)
    assert out.result == 0


def test_not_found_answers(pkg, live):
    _, client = live
    assert _add(pkg, client, "ghost", "default", 1, False).result == 2
    assert _remove(pkg, client, "ghost", "default", [], False).result == 2
    _add(pkg, client, "workload", "default", 1, False)
    assert _remove(pkg, client, "workload", "default", ["nope"],
                   False).result == 4


def test_busy_pids_cross_the_wire(pkg, live):
    rig, client = live
    resp = _add(pkg, client, "workload", "default", 1, False)
    chip = rig.sim.collector.get_chip_by_uuid(resp.device_ids[0])
    rig.sim.enumerator.busy_pids = {chip.device_path: [rig.pid]}
    out = _remove(pkg, client, "workload", "default", list(resp.device_ids),
                  False)
    assert (out.result, list(out.busy_pids)) == (1, [rig.pid])


def test_policy_violation_is_failed_precondition(pkg, live):
    _, client = live
    _add(pkg, client, "workload", "default", 4, True)
    with pytest.raises(grpc.RpcError) as exc:
        _add(pkg, client, "workload", "default", 1, False)
    assert exc.value.code() == grpc.StatusCode.FAILED_PRECONDITION


def test_actuation_failure_is_internal_and_rolled_back(pkg, live):
    rig, client = live
    rig.actuator.fail_on_create = True
    with pytest.raises(grpc.RpcError) as exc:
        _add(pkg, client, "workload", "default", 1, False)
    assert exc.value.code() == grpc.StatusCode.INTERNAL
    assert rig.sim.slave_pods() == []


def test_draining_worker_answers_unavailable_with_the_marker(pkg, live):
    rig, client = live
    drain = pkg.mod("worker.drain").DrainController("node-a")
    rig.service.drain = drain
    drain.begin("test")
    with pytest.raises(grpc.RpcError) as exc:
        _add(pkg, client, "workload", "default", 1, False)
    assert exc.value.code() == grpc.StatusCode.UNAVAILABLE
    assert exc.value.details().startswith("draining:")


def test_status_rpcs(pkg, live):
    rig, client = live
    rig.sim.settings.node_name = "node-a"
    _add(pkg, client, "workload", "default", 2, True)
    status = getattr(client, f"{pkg.dev}_status")("workload", "default")
    entries = status.gpus if pkg is TORCH else status.chips
    assert status.mount_type == "entire-mount"
    assert [norm_path(e.device_path) for e in entries] == ["dev0", "dev1"]
    assert all(e.slave_pod for e in entries)
    node = client.node_status()
    nodes = node.gpus if pkg is TORCH else node.chips
    assert node.node == "node-a"
    assert sorted(n.state for n in nodes) == ["ALLOCATED"] * 2 + \
        ["FREE"] * 2
    with pytest.raises(grpc.RpcError) as exc:
        getattr(client, f"{pkg.dev}_status")("ghost", "default")
    assert exc.value.code() == grpc.StatusCode.NOT_FOUND


def test_wire_transcripts_agree(tmp_path):
    runs = []
    for pkg in BOTH:
        rig = pkg.rig(tmp_path / pkg.name)
        grpc_mod = pkg.mod("worker.grpc_server")
        server, port = grpc_mod.build_server(rig.service, port=0,
                                             address="127.0.0.1")
        server.start()
        client = grpc_mod.WorkerClient(f"127.0.0.1:{port}", timeout_s=30)
        try:
            a = _add(pkg, client, "workload", "default", 3, False,
                     "rid-wire")
            rig.sim.enumerator.busy_pids = {
                rig.sim.collector.get_chip_by_uuid(
                    a.device_ids[0]).device_path: [rig.pid]}
            busy = _remove(pkg, client, "workload", "default", [], False)
            rig.sim.enumerator.busy_pids = {}
            done = _remove(pkg, client, "workload", "default", [], False)
            runs.append((a.result, [norm_path(p) for p in a.device_paths],
                         busy.result, list(busy.busy_pids), done.result,
                         rig.sim.slave_pods()))
        finally:
            client.close()
            server.stop(grace=0).wait()
            rig.close()
    assert runs[0] == runs[1]


# -- apiserver round trips of an attach ---------------------------------------

def _counts(pkg):
    lat = pkg.registry.k8s_latency
    return {(d["verb"], d["resource"]): lat.count(**d)
            for d in lat.phases()}


def _delta(before, after):
    return {k: v - before.get(k, 0) for k, v in after.items()
            if k[1] in ("pods", "nodes") and v != before.get(k, 0)}


def _budget(pkg, root, informer=True) -> dict:
    """Round trips by (verb, resource): a first (cold) attach, a detach,
    and a second attach once the informer and the node cache are warm."""
    rig = pkg.rig(root, n_chips=4, informer=informer)
    try:
        out = {}
        before = _counts(pkg)
        assert pkg.add(rig.service, "workload", "default", 4, True,
                       request_id="budget-1").result.name == "SUCCESS"
        out["cold_attach"] = _delta(before, _counts(pkg))
        before = _counts(pkg)
        assert pkg.remove(rig.service, "workload", "default", [],
                          False).result.name == "SUCCESS"
        out["detach"] = _delta(before, _counts(pkg))
        before = _counts(pkg)
        assert pkg.add(rig.service, "workload", "default", 4, True,
                       request_id="budget-2").result.name == "SUCCESS"
        out["warm_attach"] = _delta(before, _counts(pkg))
        return out
    finally:
        rig.close()


def test_round_trips_per_attach_equal_the_control_planes(tmp_path):
    jax_budget = _budget(JAX, tmp_path / "jax")
    torch_budget = _budget(TORCH, tmp_path / "torch")
    assert torch_budget == jax_budget
    assert torch_budget["cold_attach"] == {("GET", "pods"): 1,
                                           ("GET", "nodes"): 1,
                                           ("POST", "pods"): 1}
    assert torch_budget["warm_attach"] == {("GET", "pods"): 1,
                                           ("POST", "pods"): 1}
    assert torch_budget["detach"] == {("GET", "pods"): 1,
                                      ("DELETE", "pods"): 1}
    assert all(k[0] != "LIST" for b in torch_budget.values() for k in b)


def test_without_the_informer_the_lists_come_back(tmp_path):
    """The contrast: with reads going straight to the client, the attach
    LISTs (adoption, mount type, the wait's seed, resolution), in both
    packages alike."""
    jax_budget = _budget(JAX, tmp_path / "jax", informer=False)
    torch_budget = _budget(TORCH, tmp_path / "torch", informer=False)
    assert torch_budget == jax_budget
    assert torch_budget["cold_attach"].get(("LIST", "pods"), 0) >= 3
