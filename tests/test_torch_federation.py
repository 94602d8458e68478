"""The port's re-federation member side (``torchcheck/federation.py``),
in process, against the JAX package's master and the port's own.

The barrier protocol lives in each master's ``master/slicetxn.py``; a
live ``MultiNodeStack`` of either package serves it here (fixture
``master``: the JAX package's, or the port's over GPU nodes of one GPU
each), and the port's ``BarrierClient`` and ``MasterSliceSignal`` meet
the same answers from both. The crash between a sharded drain and its
restore resumes from the checkpoint. The subprocess e2es are in
``tests/test_torch_federation_e2e.py``.
"""

import json
import time
import urllib.request

import numpy as np
import pytest
import torch
import torch.distributed as dist

from gpumounter_tpu.jaxcheck import federation as jfed
from gpumounter_tpu.testing.chaos import (assert_checkpoint_invariants,
                                          assert_slice_invariants)
from gpumounter_tpu.utils import consts as jconsts
from gpumounter_tpu.utils.config import HostPaths
from gpumounter_tpu_torch.torchcheck import dist as tdist
from gpumounter_tpu_torch.torchcheck import federation as fed
from gpumounter_tpu_torch.torchcheck import model as tmodel
from gpumounter_tpu_torch.torchcheck import probe
from gpumounter_tpu_torch.utils import consts

import torch_worlds

CFG = tmodel.ModelConfig(vocab=64, d_model=32, n_heads=4, n_layers=1,
                         d_ff=64)


def _host(tmp_path, i):
    base = tmp_path / f"node{i}"
    for sub in ("dev", "proc", "sys/fs/cgroup"):
        (base / sub).mkdir(parents=True)
    return HostPaths(dev_root=str(base / "dev"),
                     proc_root=str(base / "proc"),
                     sys_root=str(base / "sys"),
                     cgroup_root=str(base / "sys" / "fs" / "cgroup"),
                     kubelet_socket=str(base / "pr" / "kubelet.sock"))


def _post(url, obj):
    req = urllib.request.Request(url, data=json.dumps(obj).encode(),
                                 method="POST")
    try:
        resp = urllib.request.urlopen(req, timeout=60)
        return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


class _Master:
    """One package's master behind a live MultiNodeStack: its slice
    routes, its per-host count key and its invariants."""

    def __init__(self, name):
        self.name = name
        self.dev = "tpu" if name == "jax" else "gpu"

    def stack(self, tmp_path, hosts=2):
        if self.name == "jax":
            from gpumounter_tpu.testing.sim import MultiNodeStack
            return MultiNodeStack([_host(tmp_path, i) for i in range(hosts)],
                                  n_chips=2)
        from tests.torch_slices import stack
        # GKE GPU nodes of one GPU each: a slice takes whole hosts
        return stack(tmp_path, hosts=hosts, n_chips=1)

    def target(self, n):
        return {"pods": [{"namespace": "default", "pod": f"workload-{i}"}
                         for i in range(n)], f"{self.dev}sPerHost": 1}

    def post(self, stack, route, body):
        return _post(f"{stack.base}/{route.format(dev=self.dev)}", body)

    def registry(self):
        if self.name == "jax":
            from gpumounter_tpu.utils.metrics import REGISTRY
        else:
            from gpumounter_tpu_torch.utils.metrics import REGISTRY
        return REGISTRY

    def invariants(self, stack):
        if self.name == "jax":
            assert_slice_invariants(stack.gateway.broker,
                                    [r.sim for r in stack.rigs],
                                    kube=stack.master_kube)
        else:
            from tests.torch_slices import invariants
            invariants(stack)


@pytest.fixture(params=["jax", "torch"])
def master(request):
    return _Master(request.param)


def test_constants_match_the_control_plane():
    from gpumounter_tpu.jaxcheck import drain as jdrain
    assert consts.DEFAULT_RESIZE_BARRIER_TIMEOUT_S == \
        jconsts.DEFAULT_RESIZE_BARRIER_TIMEOUT_S == \
        fed.DEFAULT_BARRIER_TIMEOUT_S
    assert consts.SHARDED_FORMAT == jdrain.SHARDED_FORMAT


def test_barrier_client_typed_refusals(tmp_path, master):
    stack = master.stack(tmp_path, hosts=2)
    try:
        _, body = master.post(stack, "add{dev}slice", master.target(2))
        group = body["group"]
        client = fed.BarrierClient(stack.base, group, "default/workload-0")
        out = client.join(1, "127.0.0.1:4000")
        assert out["complete"] is False
        _, body = _post(f"{stack.base}/slice/resize", {
            "pods": [{"namespace": "default", "pod": "workload-0"}]})
        assert body["generation"] == 2
        with pytest.raises(fed.StaleGenerationError) as info:
            client.join(1, "127.0.0.1:4000")
        assert info.value.current == 2
        other = fed.BarrierClient(stack.base, group, "default/workload-1")
        with pytest.raises(fed.MembershipRefusedError):
            other.join(2, "127.0.0.1:5000")
        with pytest.raises(fed.UnknownGenerationError):
            client.join(9, "127.0.0.1:4000")
        with pytest.raises(fed.StaleGenerationError):
            client.wait(1, timeout_s=1.0)
        with pytest.raises(fed.BarrierTimeoutError):
            client.wait(2, timeout_s=0.3)
        # completing the barrier hands back the plan both clients read
        plan = client.join(2, "127.0.0.1:4001")["plan"]
        assert plan == {"coordinator": "127.0.0.1:4001",
                        "num_processes": 1,
                        "members": ["default/workload-0"]}
        assert client.wait(2, timeout_s=1.0) == plan
        assert jfed.BarrierClient(stack.base, group,
                                  "default/workload-0").wait(
            2, timeout_s=1.0) == plan
        master.invariants(stack)
    finally:
        stack.close()


def test_teardown_retires_the_barrier(tmp_path, master):
    stack = master.stack(tmp_path, hosts=2)
    try:
        _, body = master.post(stack, "add{dev}slice", master.target(2))
        group = body["group"]
        master.post(stack, "remove{dev}slice", master.target(2))
        stack.gateway.slices.export_gauges()
        client = fed.BarrierClient(stack.base, group, "default/workload-0")
        with pytest.raises(fed.MembershipRefusedError):
            client.join(1, "127.0.0.1:4000")
        assert client.status() is None
        master.invariants(stack)
    finally:
        stack.close()


def _barrier_record(master, **fields):
    if master.name == "jax":
        from gpumounter_tpu.master.store import SliceBarrierRecord
    else:
        from gpumounter_tpu_torch.master.store import SliceBarrierRecord
    return SliceBarrierRecord(created_unix=time.time(), **fields)


def test_barrier_record_rearms_from_the_store(tmp_path, master):
    """A failed-over leader re-arms persisted barriers with an empty
    joined set (adopt_barriers), ignores records older than what it
    already carries, and restores a completed record's plan verbatim."""
    stack = master.stack(tmp_path, hosts=2)
    try:
        _, body = master.post(stack, "add{dev}slice", master.target(2))
        group = body["group"]
        manager = stack.gateway.slices
        members = ["default/workload-0", "default/workload-1"]
        record = _barrier_record(master, group=group, generation=5,
                                 members=members)
        assert manager.adopt_barriers([record]) == 1
        client = fed.BarrierClient(stack.base, group, "default/workload-0")
        status = client.status()
        assert status["generation"] == 5 and status["joined"] == []
        stale = _barrier_record(master, group=group, generation=2,
                                members=["default/workload-0"])
        assert manager.adopt_barriers([stale]) == 0
        assert client.status()["generation"] == 5
        assert type(record).from_json(record.to_json()) == record
        plan = {"coordinator": "127.0.0.1:7777", "num_processes": 2,
                "members": members}
        done = _barrier_record(master, group=group, generation=6,
                               members=members, plan=plan,
                               completed_unix=time.time())
        assert manager.adopt_barriers([done]) == 1
        status = client.status()
        assert status["complete"] is True
        assert status["plan"] == plan
        assert client.wait(6, timeout_s=1.0) == plan
        master.invariants(stack)
    finally:
        stack.close()


def test_orphan_adopted_barrier_is_swept(tmp_path, master):
    """A barrier adopted for a group that no longer exists (torn down
    before the failover) is retired by the gauge sweep, not left to page
    the stuck alert forever."""
    stack = master.stack(tmp_path, hosts=2)
    try:
        manager = stack.gateway.slices
        ghost = _barrier_record(master, group="txn-ghost", generation=4,
                                members=["default/gone-0", "default/gone-1"])
        assert manager.adopt_barriers([ghost]) == 1
        manager.export_gauges()
        assert fed.BarrierClient(stack.base, "txn-ghost",
                                 "default/gone-0").status() is None
        assert master.registry().slice_barriers_incomplete.value() == 0
    finally:
        stack.close()


def test_master_slice_signal_reads_the_group(tmp_path, master):
    from gpumounter_tpu_torch.torchcheck import elastic
    stack = master.stack(tmp_path, hosts=2)
    try:
        _, body = master.post(stack, "add{dev}slice", master.target(2))
        signal = elastic.MasterSliceSignal(stack.base, body["group"])
        assert signal.generation() == 1 and signal.chips() == 2
        assert elastic.MasterSliceSignal(stack.base, "txn-nope") \
            .generation() is None
    finally:
        stack.close()


# -- one process ------------------------------------------------------------------

def _batch(step):
    generator = torch.Generator().manual_seed(7_000_003 + step)
    from gpumounter_tpu_torch.torchcheck import train
    return train.make_batch(generator, 4, 16, CFG.vocab)


def test_single_process_crash_between_drain_and_restore_resumes(tmp_path):
    """The sole-surviving-copy scenario: a harness crashes after its
    sharded drain committed but before restore. The next boot
    (start(resume=True), the member's resume path) restores the
    checkpoint instead of resetting the trajectory."""
    root = str(tmp_path / "ckpt")
    signal = {"gen": 1, "chips": 1}

    def harness():
        return fed.FederatedElasticHarness(
            CFG, lambda: signal["gen"], lambda: signal["chips"],
            refederator=fed.Refederator(None, device="cpu"),
            checkpoint_root=root, lr=1e-2)

    first = harness()
    first.refederator.refederate(1)           # a world of one
    try:
        first.start()
        for step in range(5):
            first.train_step(_batch(step))
        assert first.state.step == 5
        embed = first.state.model.embed.detach().clone()
        # drain for the (never-completed) transition to generation 2 —
        # then "crash": the checkpoint is the sole surviving copy
        first._drain(2)
        assert_checkpoint_invariants(root)
        reborn = harness()
        reborn._target_generation = 2
        reborn.start(resume=True)
        assert reborn.state.step == 5
        assert torch.equal(reborn.state.model.embed, embed)
        assert reborn.restored_generation == 2
        assert reborn.rolled_back is False
        # a start WITHOUT resume still inits fresh
        assert harness().start().state.step == 0
    finally:
        probe.shutdown_distributed()


def test_restore_rolls_back_to_last_good_on_a_wrong_generation(tmp_path):
    root = str(tmp_path / "ckpt")
    refederator = fed.Refederator(None, device="cpu")
    harness = fed.FederatedElasticHarness(
        CFG, lambda: 1, lambda: 1, refederator=refederator,
        checkpoint_root=root, lr=1e-2)
    refederator.refederate(1)
    try:
        harness.start()
        harness.train_step(_batch(0))
        harness._drain(1)
        harness._target_generation = 3      # the world moved past gen 1
        tree = harness._restore(fed.elastic_lib.state_specs(CFG))
        assert harness.rolled_back is True
        assert harness.restored_generation == 1
        assert int(tree["step"]) == 1
    finally:
        probe.shutdown_distributed()


def test_single_process_refederation_joins_a_fresh_world_of_one():
    refederator = fed.Refederator(None, device="cpu")
    try:
        assert refederator.refederate(1) is None
        assert dist.is_initialized() and dist.get_world_size() == 1
        first = dist.distributed_c10d._get_default_store()
        assert refederator.refederate(2) is None
        assert dist.get_world_size() == 1
        assert dist.distributed_c10d._get_default_store() is not first
        assert refederator.federated
    finally:
        assert probe.shutdown_distributed() is True
    assert not dist.is_initialized()
    assert probe.shutdown_distributed() is False


def test_world_agreement_takes_the_minimum():
    got = tdist.run_world(3, torch_worlds.agreement_world, ([5, 3, 9],),
                          device="cpu", timeout_s=120)
    assert got == [3, 3, 3]
    assert fed.WorldAgreement().agree(4) == 4      # no world: identity


def _member(local_devices, device="cpu", **kw):
    return fed.MemberRunner("http://127.0.0.1:1", "g", "default/p",
                            "/tmp/x", local_devices=local_devices,
                            device=device, **kw)


def _cli(*args):
    with pytest.raises(SystemExit) as info:
        fed.main(["--master", "http://127.0.0.1:1", "--group", "g",
                  "--member", "default/p", "--checkpoint-root", "/tmp/x",
                  *args])
    return info.value.code


@pytest.mark.parametrize("n", [0, -2])
def test_a_member_drives_at_least_one_device(n):
    with pytest.raises(ValueError, match="at least one device"):
        _member(n)
    assert _cli("--local-devices", str(n), "--device", "cpu") == 2


def test_a_cpu_member_drives_any_number_of_ranks():
    assert _member(4).local_devices == 4
    assert fed.configure_cpu_world(4) == torch.device("cpu")


@pytest.fixture
def gpu_nodes(tmp_path):
    """A pod's /dev and /proc with two GPUs' nodes and driver files."""
    from gpumounter_tpu_torch.device.fake import fake_uuid
    dev, proc = tmp_path / "dev", tmp_path / "proc"
    dev.mkdir()
    for i in range(2):
        (dev / f"nvidia{i}").touch()
        info = proc / "driver" / "nvidia" / "gpus" / f"0000:{i + 16:02x}:00.0"
        info.mkdir(parents=True)
        (info / "information").write_text(
            f"GPU UUID: \t {fake_uuid(i)}\nDevice Minor: \t {i}\n")
    return str(dev), str(proc), [fake_uuid(i) for i in range(2)]


def test_a_member_drives_no_more_gpus_than_its_pod_shows(gpu_nodes):
    dev, proc, uuids = gpu_nodes
    # counted from the device nodes: the member touches no CUDA
    assert _member(2, "cuda", dev_root=dev, proc_root=proc).local_devices \
        == 2
    assert not torch.cuda.is_initialized()
    with pytest.raises(ValueError, match="show 2 GPU"):
        _member(3, "cuda", dev_root=dev, proc_root=proc)
    assert _cli("--local-devices", "3", "--dev-root", dev) == 2
    # a pod that shares its host names its GPUs; they pin its ranks
    chosen = probe.select_gpus("cuda:1", 1, dev, proc)
    assert probe.rank_visibility(chosen) == uuids[1]
    assert probe.rank_visibility(probe.select_gpus("cuda", 2, dev, proc)) \
        == ",".join(uuids)
    with pytest.raises(ValueError, match="names 1 of the 2 GPUs"):
        _member(1, "cuda:2", dev_root=dev, proc_root=proc)


def test_member_gives_up_when_the_slice_never_appears(tmp_path):
    status = tmp_path / "status.jsonl"
    runner = fed.MemberRunner(f"http://127.0.0.1:{fed.free_port()}", "g",
                              "default/p", str(tmp_path / "ckpt"),
                              device="cpu", status_path=str(status),
                              barrier_timeout_s=0.3)
    assert runner.run() == 2
    records = [json.loads(line) for line in status.read_text().splitlines()]
    assert records[-1]["phase"] == "error"
    assert "never appeared" in records[-1]["message"]
    assert np.isfinite(records[-1]["unix"])


def test_a_node_the_driver_does_not_name_is_no_gpu_of_the_pod(gpu_nodes):
    """Where the driver names the pod's GPUs, a node it does not name
    (another card's node left in the container) is not counted: the pod's
    ranks would find no such device."""
    dev, proc, uuids = gpu_nodes
    open(f"{dev}/nvidia5", "w").close()
    assert [d.uuid for d in probe.pod_gpus(dev, proc)] == uuids
    with pytest.raises(ValueError, match="show 2 GPU"):
        _member(3, "cuda", dev_root=dev, proc_root=proc)
