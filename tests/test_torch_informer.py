"""The shared pod informer, through both packages: the cases of
tests/test_informer.py that tests/test_torch_k8s.py does not hold (a
selector's coverage as a clause subset, a GET's minimum resourceVersion,
staleness from the stream's liveness, and ``wait_for`` woken by
events)."""

import threading
import time

import pytest

from tests.torch_control_plane import BOTH, IDS


@pytest.fixture(params=BOTH, ids=IDS)
def pkg(request):
    return request.param


@pytest.fixture
def informer_mod(pkg):
    return pkg.mod("k8s.informer")


def _pod(name, phase="Pending"):
    return {"metadata": {"name": name, "namespace": "pool", "labels": {}},
            "status": {"phase": phase}}


@pytest.fixture
def kube(pkg):
    class CountingKube(pkg.mod("k8s.client").FakeKubeClient):
        get_calls = 0

        def get_pod(self, namespace, name):
            self.get_calls += 1
            return super().get_pod(namespace, name)
    return CountingKube()


@pytest.fixture
def informer(informer_mod, kube):
    inf = informer_mod.PodInformer(kube, "pool", watch_chunk_s=1.0).start()
    yield inf
    inf.stop()


def _wait(predicate, timeout_s=5.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(0.01)
    return False


def test_selector_coverage_is_clause_subset(pkg, informer_mod):
    assert informer_mod._selector_clauses("a=b,c=d") == {"a=b", "c=d"}
    kube = pkg.mod("k8s.client").FakeKubeClient()
    scoped = informer_mod.PodInformer(kube, "ns", label_selector="app=x")
    wide = informer_mod.PodInformer(kube, "ns", label_selector=None)
    reads = informer_mod.PodCacheReads(kube, [scoped])
    scoped._seeded = True
    assert reads._covering("ns", "app=x,owner=o") is scoped
    assert reads._covering("ns", "owner=o") is None
    reads_wide = informer_mod.PodCacheReads(kube, [wide])
    wide._seeded = True
    assert reads_wide._covering("ns", "anything=else") is wide


def test_get_pod_min_resource_version_demand(informer_mod, kube, informer):
    kube.put_pod(_pod("s1"))
    assert _wait(lambda: informer.get("s1") is not None)
    reads = informer_mod.PodCacheReads(kube, [informer],
                                       fence_timeout_s=0.05)
    rv = informer.get("s1")["metadata"]["resourceVersion"]
    before = kube.get_calls
    reads.get_pod("pool", "s1", min_resource_version=rv)
    assert kube.get_calls == before                 # a cache hit
    reads.get_pod("pool", "s1", min_resource_version=str(int(rv) + 50))
    assert kube.get_calls == before + 1             # a real GET


def test_staleness_tracks_stream_liveness(kube, informer):
    assert _wait(informer.ready)
    kube.put_pod(_pod("s1"))
    assert _wait(lambda: informer.get("s1") is not None)
    assert informer.staleness_s() < 5.0
    status = informer.status()
    assert (status["pods"], status["watch_restarts"]) == (1, 0)
    assert status["events_seen"] >= 1


def test_wait_for_wakes_on_events(kube, informer):
    assert _wait(informer.ready)

    def make_running():
        time.sleep(0.05)
        kube.put_pod(_pod("s1", phase="Running"))
    threading.Thread(target=make_running, daemon=True).start()
    assert informer.wait_for(
        lambda: (informer._pods.get("s1") or {}).get(
            "status", {}).get("phase") == "Running", timeout_s=5.0)
