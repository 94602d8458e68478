"""The port's multi-host slice transactions (master/slice.py), the cases of
tests/test_slice.py: one master, two simulated GKE GPU nodes
(``nvidia-h100-80gb``, 4 allocatable GPUs each), all-or-nothing attach
with rollback. Where the GPU rule departs from the TPU one (no multi-host
mesh, so ``strict`` adds nothing), the test pins the port's behaviour.
Every test ends on the port's ``assert_slice_invariants``."""

import urllib.request

import pytest

from gpumounter_tpu_torch.master import slice as slice_mod
from gpumounter_tpu_torch.utils import consts
from tests.torch_slices import (get, invariants, post, slice_body, stack)

SLICE = slice_body(2)


@pytest.fixture
def s(tmp_path):
    st = stack(tmp_path, hosts=2, n_chips=4)
    yield st
    try:
        invariants(st)
    finally:
        st.close()


def _relabel(s, i, accelerator="nvidia-h100-80gb", gpus=4):
    from gpumounter_tpu_torch.testing.sim import make_gpu_node
    s.master_kube.put_node(make_gpu_node(f"node-{i}", accelerator, gpus))


def test_slice_attach_all_hosts(s):
    status, body = post(f"{s.base}/addgpuslice", SLICE)
    assert status == 200
    assert body["result"] == "SUCCESS"
    assert len(body["pods"]) == 2
    for entry, rig in zip(sorted(body["pods"], key=lambda p: p["pod"]),
                          s.rigs):
        assert entry["result"] == "SUCCESS"
        assert len(entry["device_ids"]) == 4
        assert all(u.startswith("GPU-") for u in entry["device_ids"])
        assert len(rig.sim.slave_pods()) == 1   # one entire-mount per host


def test_slice_detach(s):
    post(f"{s.base}/addgpuslice", SLICE)
    status, body = post(f"{s.base}/removegpuslice", {"pods": SLICE["pods"]})
    assert status == 200
    assert body["result"] == "SUCCESS"
    for rig in s.rigs:
        assert rig.sim.slave_pods() == []


def test_slice_attach_rolls_back_on_partial_failure(s):
    status, _ = post(f"{s.base}/removegpuslice", {"pods": []})
    assert status == 400                        # empty pod list rejected
    urllib.request.urlopen(
        f"{s.base}/addgpu/namespace/default/pod/workload-1/gpu/4"
        "/isEntireMount/true")
    status, body = post(f"{s.base}/addgpuslice", SLICE)
    assert status == 503
    assert body["result"] == "SliceAttachFailed"
    assert body["rolled_back"] is True
    results = {p["pod"]: p["result"] for p in body["pods"]}
    assert results["workload-1"] in ("INSUFFICIENT_GPU", "ERROR")
    # node-0's successful attach was rolled back — GPUs free again
    assert s.rigs[0].sim.slave_pods() == []
    # node-1's pre-existing mount is untouched
    assert len(s.rigs[1].sim.slave_pods()) == 1


def test_slice_duplicate_pod_is_400(s):
    dup = {"pods": [{"namespace": "default", "pod": "workload-0"},
                    {"namespace": "default", "pod": "workload-0"}],
           "gpusPerHost": 4}
    for path in ("/addgpuslice", "/removegpuslice", "/slice/resize"):
        status, body = post(f"{s.base}{path}", dup)
        assert status == 400, (path, body)
        assert body["result"] == "BadRequest"
        assert "duplicate pod default/workload-0" in body["message"]
    for rig in s.rigs:
        assert rig.sim.slave_pods() == []


def test_strict_adds_nothing_on_gpu_nodes(s):
    """A GPU node advertises no multi-host mesh, so no pod set is a
    partial mesh: ``strict`` is accepted and the slice attaches as
    without it (the control plane's partial-mesh 412 has no analog)."""
    status, body = post(f"{s.base}/addgpuslice", dict(SLICE, strict=True))
    assert status == 200, body
    assert body["result"] == "SUCCESS"


def test_mixed_accelerator_or_partial_host_is_412(s):
    """Under strict or not: hosts of two accelerators cannot form one
    slice, and a per-host count short of the whole host is refused —
    both before any host is touched."""
    status, body = post(f"{s.base}/addgpuslice", slice_body(2, gpus=2))
    assert status == 412
    assert body["result"] == "TopologyMismatch"
    assert "whole hosts" in body["message"]
    _relabel(s, 1, accelerator="nvidia-l4")
    status, body = post(f"{s.base}/addgpuslice", dict(SLICE, strict=True))
    assert status == 412
    assert body["result"] == "TopologyMismatch"
    assert "different accelerators" in body["message"]
    for rig in s.rigs:
        assert rig.sim.slave_pods() == []


def test_resize_strict_judges_the_full_target(s):
    """Strict on /slice/resize validates the RESULTING membership: a
    target that spans two accelerators is 412 and nothing moves; a
    consistent target resizes."""
    one = {"pods": [SLICE["pods"][0]], "gpusPerHost": 4}
    status, body = post(f"{s.base}/addgpuslice", one)
    assert status == 200, body
    _relabel(s, 1, accelerator="nvidia-l4")
    status, body = post(f"{s.base}/slice/resize", dict(SLICE, strict=True))
    assert status == 412
    assert body["result"] == "TopologyMismatch"
    assert s.rigs[1].sim.slave_pods() == []     # nothing moved
    _relabel(s, 1)
    status, body = post(f"{s.base}/slice/resize", dict(SLICE, strict=True))
    assert status == 200, body
    assert body["generation"] == 2
    assert len(s.rigs[1].sim.slave_pods()) == 1


def test_strict_non_boolean_is_400(s):
    status, body = post(f"{s.base}/addgpuslice", dict(SLICE, strict="yes"))
    assert status == 400
    assert body["result"] == "BadRequest"


def test_slice_bad_body_is_400(s):
    for bad in ({"pods": "nope"}, [], None, {"pods": [{}]},
                {"pods": SLICE["pods"], "gpusPerHost": None},
                {"pods": SLICE["pods"], "gpusPerHost": 0},
                {"pods": SLICE["pods"], "gpusPerHost": "abc"}):
        status, body = post(f"{s.base}/addgpuslice", bad)
        assert status == 400, bad
        assert body["result"] == "BadRequest"


def test_slice_detach_is_idempotent(s):
    post(f"{s.base}/addgpuslice", SLICE)
    status, _ = post(f"{s.base}/removegpuslice", {"pods": SLICE["pods"]})
    assert status == 200
    # retry of a completed detach converges to 200, not 409
    status, body = post(f"{s.base}/removegpuslice", {"pods": SLICE["pods"]})
    assert status == 200
    assert {p["result"] for p in body["pods"]} == {"GPU_NOT_FOUND"}


def test_slice_rollback_preserves_preexisting_mounts(s):
    urllib.request.urlopen(f"{s.base}/addgpu/namespace/default/pod/"
                           "workload-1/gpu/2/isEntireMount/true")
    assert len(s.rigs[1].sim.slave_pods()) == 1
    # the slice wants 4 per host: node-1 has only 2 free → it fails
    status, _ = post(f"{s.base}/addgpuslice", SLICE)
    assert status == 503
    assert s.rigs[0].sim.slave_pods() == []
    assert len(s.rigs[1].sim.slave_pods()) == 1


def test_slice_results_carry_per_host_elapsed(s):
    status, body = post(f"{s.base}/addgpuslice", SLICE)
    assert status == 200
    for entry in body["pods"]:
        assert entry["elapsed_ms"] > 0
    status, body = post(f"{s.base}/removegpuslice", {"pods": SLICE["pods"]})
    assert status == 200
    for entry in body["pods"]:
        assert entry["elapsed_ms"] > 0


def test_slice_rollback_feeds_rollback_phase_metric(s):
    from gpumounter_tpu_torch.utils.metrics import REGISTRY
    before = REGISTRY.attach_phase.count(phase="rollback")
    urllib.request.urlopen(
        f"{s.base}/addgpu/namespace/default/pod/workload-1/gpu/4"
        "/isEntireMount/true")                  # exhaust node-1
    status, _ = post(f"{s.base}/addgpuslice", SLICE)
    assert status == 503
    assert REGISTRY.attach_phase.count(phase="rollback") == before + 1
    assert REGISTRY.attach_phase.count(phase="fanout") >= 1
    assert REGISTRY.attach_phase.count(phase="validate") >= 1


def test_rollback_and_detach_vocabulary_is_the_ports():
    """The control plane hard-codes ``TPU_NOT_FOUND`` in its rollback's
    clean test and its detach's done test; the port's worker answers
    ``GPU_NOT_FOUND``. A literal copy would call every clean rollback
    PARTIAL and answer a repeated /removegpuslice 409 for ever."""
    name = consts.RemoveResult.GPU_NOT_FOUND.name
    assert name == "GPU_NOT_FOUND"
    assert name in slice_mod.DETACH_DONE
    assert name in slice_mod.ROLLBACK_CLEAN
    assert not any("TPU" in r for r in slice_mod.ROLLBACK_CLEAN)
    assert set(slice_mod.DETACH_DONE) == {"SUCCESS", "GPU_NOT_FOUND"}
    assert set(slice_mod.ROLLBACK_CLEAN) == {"SUCCESS", "GPU_NOT_FOUND",
                                             "POD_NOT_FOUND"}


def test_rollback_of_untouched_hosts_is_clean(s):
    """A txn-targeted rollback over hosts the txn never touched answers
    GPU_NOT_FOUND per host, and that is clean."""
    coordinator = slice_mod.SliceCoordinator(s.gateway)
    clean, results = coordinator.rollback(
        [("default", "workload-0"), ("default", "workload-1")],
        "txn-never", "rid-1")
    assert clean is True
    assert {r.result for r in results} == {"GPU_NOT_FOUND"}
    status, body = get(f"{s.base}/slicez")
    assert status == 200 and body["groups"] == {}
