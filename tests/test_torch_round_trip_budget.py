"""Per-verb apiserver and kubelet round-trip budgets of the attach and
detach path, through both packages (the counterpart of
tests/test_round_trip_budget.py). tests/test_torch_worker_grpc.py holds
the cold attach and the informer-less contrast
(``test_round_trips_per_attach_equal_the_control_planes``,
``test_without_the_informer_the_lists_come_back``); this file holds the
warm-pool cases, the detach and the kubelet's LISTs.

Requests are counted on each package's own
``tpumounter_k8s_request_seconds`` family, which every FakeKubeClient verb
passes through inside the retry layer, so the counts are round trips."""

import pytest

from tests.torch_control_plane import BOTH, IDS, JAX, TORCH, norm_result


@pytest.fixture(params=BOTH, ids=IDS)
def pkg(request):
    return request.param


@pytest.fixture
def rig(pkg, tmp_path):
    r = pkg.rig(tmp_path, n_chips=4, informer=True,
                warm_pool={"entire:4": 1})
    yield r
    r.close()


def _counts(pkg) -> dict[tuple[str, str], int]:
    lat = pkg.registry.k8s_latency
    return {(d["verb"], d["resource"]): lat.count(**d) for d in lat.phases()}


def _delta(before, after, resources=("pods", "nodes")):
    return {k: v - before.get(k, 0) for k, v in after.items()
            if k[1] in resources and v - before.get(k, 0)}


def _attach(pkg, rig, rid=None):
    out = pkg.add(rig.service, "workload", "default", 4, True,
                  request_id=rid)
    assert norm_result(out.result) == "SUCCESS"
    return out


def _warm_attach(pkg, rig) -> dict:
    rig.fill_warm_pool()
    before = _counts(pkg)
    outcome = _attach(pkg, rig, "budget-warm")
    return {"pool_hits": outcome.pool_hits,
            "requests": _delta(before, _counts(pkg))}


def _second_warm_attach(pkg, rig) -> dict:
    rig.fill_warm_pool()
    _attach(pkg, rig, "warmup")
    assert norm_result(pkg.remove(rig.service, "workload", "default", [],
                                  False).result) == "SUCCESS"
    return _warm_attach(pkg, rig)


def _detach(pkg, rig) -> dict:
    rig.fill_warm_pool()
    _attach(pkg, rig, "budget-pre")
    before = _counts(pkg)
    out = pkg.remove(rig.service, "workload", "default", [], False)
    return {"result": norm_result(out.result),
            "requests": _delta(before, _counts(pkg))}


def _kubelet(pkg, rig) -> int:
    rig.fill_warm_pool()
    before = rig.sim.podresources.list_calls
    _attach(pkg, rig)
    return rig.sim.podresources.list_calls - before


def test_warm_attach_budget_zero_lists(pkg, rig):
    """A warm-pool attach: GET the target pod, GET the node (first attach
    only), PATCH the adoption, and no LIST."""
    assert _warm_attach(pkg, rig) == {
        "pool_hits": 1, "requests": {("GET", "pods"): 1,
                                     ("GET", "nodes"): 1,
                                     ("PATCH", "pods"): 1}}


def test_second_warm_attach_drops_the_node_get(pkg, rig):
    """Steady state: the node-topology cache removes the node GET too."""
    assert _second_warm_attach(pkg, rig) == {
        "pool_hits": 1, "requests": {("GET", "pods"): 1,
                                     ("PATCH", "pods"): 1}}


def test_detach_budget_zero_lists(pkg, rig):
    assert _detach(pkg, rig) == {
        "result": "SUCCESS", "requests": {("GET", "pods"): 1,
                                          ("DELETE", "pods"): 1}}


def test_kubelet_budget_unchanged(pkg, rig):
    """At most 3 kubelet PodResources LISTs per attach."""
    assert _kubelet(pkg, rig) <= 3


@pytest.mark.parametrize("scenario", [_warm_attach, _second_warm_attach,
                                      _detach, _kubelet],
                         ids=["warm", "second_warm", "detach", "kubelet"])
def test_budgets_agree(tmp_path, scenario):
    out = {}
    for pkg in (JAX, TORCH):
        rig = pkg.rig(tmp_path / pkg.name, n_chips=4, informer=True,
                      warm_pool={"entire:4": 1})
        try:
            out[pkg.name] = scenario(pkg, rig)
        finally:
            rig.close()
    assert out["torch"] == out["jax"]
