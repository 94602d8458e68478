"""The port's Kubernetes layer against the control plane's: the fake client,
each package's REST client against its own HTTP apiserver facade (CRUD,
typed errors, retries with ``Retry-After``, watch resumption after a torn
stream, the kubeconfig and in-cluster clients) and the shared pod informer
(cache reads, resourceVersion fences, resync after watch death). Every
scenario runs through both packages, and where a scenario produces a
transcript the two packages' transcripts must be equal."""

import json
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from tests.torch_control_plane import BOTH, IDS, TORCH

NS = "pool"


def _pod(name, namespace=NS, labels=None, phase="Pending"):
    return {"metadata": {"name": name, "namespace": namespace,
                         "labels": labels or {}},
            "spec": {}, "status": {"phase": phase}}


def _wait(predicate, timeout_s=5.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(0.01)
    return False


def _counting_kube(pkg):
    base = pkg.mod("k8s.client").FakeKubeClient

    class Counting(base):
        def __init__(self):
            super().__init__()
            self.list_calls = 0
            self.get_calls = 0

        def list_pods_with_version(self, namespace, label_selector=None):
            self.list_calls += 1
            return super().list_pods_with_version(namespace, label_selector)

        def get_pod(self, namespace, name):
            self.get_calls += 1
            return super().get_pod(namespace, name)
    return Counting()


@pytest.fixture(params=BOTH, ids=IDS)
def pkg(request):
    return request.param


# -- the fake client ----------------------------------------------------------

def test_fake_crud_and_typed_errors(pkg):
    c = pkg.mod("k8s.client").FakeKubeClient()
    with pytest.raises(pkg.errors.PodNotFoundError):
        c.get_pod(NS, "nope")
    c.create_pod(NS, _pod("p1", labels={"app": "x"}))
    c.create_pod(NS, _pod("p2", labels={"app": "y"}))
    assert [p["metadata"]["name"]
            for p in c.list_pods(NS, label_selector="app=x")] == ["p1"]
    with pytest.raises(pkg.errors.K8sApiError):
        c.create_pod(NS, _pod("p1"))
    c.delete_pod(NS, "p1")
    c.delete_pod(NS, "p1")              # idempotent
    assert [p["metadata"]["name"] for p in c.list_pods(NS)] == ["p2"]


def test_fake_watch_sees_past_and_future_events(pkg):
    c = pkg.mod("k8s.client").FakeKubeClient()
    c.create_pod(NS, _pod("p1"))
    seen = []

    def consume():
        for etype, pod in c.watch_pods(NS, timeout_s=2.0):
            seen.append((etype, pod["metadata"]["name"],
                         pod["status"]["phase"]))
            if etype == "MODIFIED":
                return
    t = threading.Thread(target=consume)
    t.start()
    time.sleep(0.05)
    c.set_pod_status(NS, "p1", phase="Running")
    t.join(timeout=3)
    assert not t.is_alive()
    assert seen == [("ADDED", "p1", "Pending"),
                    ("MODIFIED", "p1", "Running")]


def test_fake_list_version_seeds_watch_resume(pkg):
    kube = pkg.mod("k8s.client").FakeKubeClient()
    kube.put_pod(_pod("a"))
    _, rv = kube.list_pods_with_version(NS)
    kube.put_pod(_pod("b"))
    events = list(kube.watch_pods(NS, timeout_s=0.3, resource_version=rv))
    assert [p["metadata"]["name"] for _, p in events] == ["b"]


def test_fake_watch_resumes_after_midstream_death(pkg):
    """A watch stream killed mid-flight resumes from the last seen
    resourceVersion: every event exactly once."""
    chaos = pkg.mod("testing.chaos")
    kube = pkg.mod("k8s.client").FakeKubeClient()
    for i in range(3):
        kube.put_pod(_pod(f"p{i}"))
    kube.faults = chaos.FaultInjector([chaos.Fault(
        op="WATCH", resource="pods", status=0, cause="reset", times=2,
        after=1)])
    events = list(kube.watch_pods(NS, timeout_s=1.0))
    assert [p["metadata"]["name"] for _, p in events] == ["p0", "p1", "p2"]
    assert len(kube.faults.fired) == 2


# -- REST clients against each package's own HTTP facade ----------------------

@pytest.fixture
def facade(pkg, tmp_path):
    """(fake cluster, facade, in-cluster REST client on the facade)."""
    kube = pkg.mod("k8s.client").FakeKubeClient()
    server = pkg.mod("testing.http_apiserver").HttpApiserver(kube)
    sa = tmp_path / f"sa-{pkg.name}"
    sa.mkdir()
    (sa / "token").write_text("t")
    client = pkg.mod("k8s.client").InClusterKubeClient(host=server.base,
                                                       sa_dir=str(sa))
    client.retry_policy = _fast_policy(pkg)
    yield kube, server, client
    server.close()


def _transcript(pkg, kube, client) -> list:
    """One CRUD session through the REST client, as comparable facts."""
    errors = pkg.errors
    out = []
    kube.put_node({"metadata": {"name": "n1", "labels": {"k": "v"}},
                   "status": {"allocatable": {"x": "1"}}})
    created = client.create_pod(NS, _pod("p1", labels={"app": "x"}))
    out.append(("create", created["metadata"]["name"],
                bool(created["metadata"].get("resourceVersion"))))
    client.create_pod(NS, _pod("p2", labels={"app": "y"}))
    out.append(("get", client.get_pod(NS, "p1")["metadata"]["name"]))
    out.append(("list", sorted(p["metadata"]["name"]
                               for p in client.list_pods(NS))))
    out.append(("select", [p["metadata"]["name"] for p in
                           client.list_pods(NS, label_selector="app=y")]))
    pods, rv = client.list_pods_with_version(NS)
    out.append(("list_rv", len(pods), bool(rv)))
    out.append(("node", client.get_node("n1")["metadata"]["labels"]))
    try:
        client.create_pod(NS, _pod("p1"))
        out.append(("conflict", None))
    except errors.K8sApiError as e:
        out.append(("conflict", e.status))
    client.delete_pod(NS, "p1")
    try:
        client.get_pod(NS, "p1")
        out.append(("gone", None))
    except errors.PodNotFoundError:
        out.append(("gone", "PodNotFound"))
    client.create_event(NS, {"metadata": {"name": "e1", "namespace": NS},
                             "reason": "R", "message": "m"})
    out.append(("events", [e["reason"] for e in kube.events]))
    return out


def test_rest_crud_over_the_facade(pkg, facade):
    kube, _server, client = facade
    got = _transcript(pkg, kube, client)
    assert ("get", "p1") in got and ("gone", "PodNotFound") in got
    assert ("conflict", 409) in got


def test_rest_transcripts_agree(tmp_path):
    """The same session through both packages' clients and facades gives
    the same transcript."""
    runs = {}
    for pkg in BOTH:
        kube = pkg.mod("k8s.client").FakeKubeClient()
        server = pkg.mod("testing.http_apiserver").HttpApiserver(kube)
        try:
            sa = tmp_path / pkg.name
            sa.mkdir()
            client = pkg.mod("k8s.client").InClusterKubeClient(
                host=server.base, sa_dir=str(sa))
            runs[pkg.name] = _transcript(pkg, kube, client)
        finally:
            server.close()
    assert runs["jax"] == runs["torch"]


def test_facade_reads_a_delete_body_before_it_replies():
    """The port's facade reads a DELETE's DeleteOptions body before it
    replies and closes: a reply sent over the unread body is followed by a
    RST, which can reach the client first and read as a reset connection
    (the control plane's facade still replies at once: ROADMAP Queue 3)."""
    from gpumounter_tpu_torch.testing.http_apiserver import HttpApiserver
    kube = TORCH.mod("k8s.client").FakeKubeClient()
    kube.put_pod(_pod("p1"))
    server = HttpApiserver(kube)
    body = json.dumps({"gracePeriodSeconds": 0}).encode()
    port = int(server.base.rsplit(":", 1)[1])
    try:
        with socket.create_connection(("127.0.0.1", port), timeout=5) as s:
            s.sendall(f"DELETE /api/v1/namespaces/{NS}/pods/p1 HTTP/1.1\r\n"
                      f"Host: x\r\nContent-Length: {len(body)}\r\n"
                      "Content-Type: application/json\r\n"
                      "Connection: close\r\n\r\n".encode())
            s.settimeout(0.3)
            with pytest.raises(socket.timeout):
                s.recv(1)                   # no reply before the body
            s.settimeout(5)
            s.sendall(body)
            reply = b""
            while chunk := s.recv(65536):   # ends at the server's FIN
                reply += chunk
    finally:
        server.close()
    assert reply.startswith(b"HTTP/1.1 200"), reply
    with pytest.raises(TORCH.errors.PodNotFoundError):
        kube.get_pod(NS, "p1")


def _fast_policy(pkg):
    return pkg.mod("utils.retry").RetryPolicy(
        max_attempts=4, base_delay_s=0.01, max_delay_s=0.02, deadline_s=5.0,
        jitter=0.0)


def test_rest_retries_transient_errors_then_succeeds(pkg, facade):
    kube, server, client = facade
    client.retry_policy = _fast_policy(pkg)
    kube.put_pod(_pod("p1"))
    chaos = pkg.mod("testing.chaos")
    server.faults = chaos.FaultInjector([chaos.Fault(
        op="GET", resource="pods", status=503, times=2)])
    before = pkg.registry.retry_attempts.value(target="apiserver")
    assert client.get_pod(NS, "p1")["metadata"]["name"] == "p1"
    assert len(server.faults.fired) == 2
    assert pkg.registry.retry_attempts.value(target="apiserver") \
        == before + 2


def test_rest_never_retries_a_denial(pkg, facade):
    kube, server, client = facade
    client.retry_policy = _fast_policy(pkg)
    kube.put_pod(_pod("p1"))
    chaos = pkg.mod("testing.chaos")
    server.faults = chaos.FaultInjector([chaos.Fault(
        op="GET", resource="pods", status=403, times=5)])
    with pytest.raises(pkg.errors.K8sApiError) as exc:
        client.get_pod(NS, "p1")
    assert exc.value.status == 403
    assert len(server.faults.fired) == 1


def test_rest_survives_a_dropped_connection(pkg, facade):
    kube, server, client = facade
    client.retry_policy = _fast_policy(pkg)
    kube.put_pod(_pod("p1"))
    chaos = pkg.mod("testing.chaos")
    server.faults = chaos.FaultInjector([chaos.Fault(
        op="LIST", resource="pods", drop=True, times=1)])
    assert [p["metadata"]["name"] for p in client.list_pods(NS)] == ["p1"]
    assert [f[2] for f in server.faults.fired] == ["drop"]


def test_rest_watch_resumes_after_a_torn_stream(pkg, facade):
    """A WATCH whose connection is torn is re-opened from the last seen
    resourceVersion; the consumer sees each pod once."""
    kube, server, client = facade
    client.retry_policy = _fast_policy(pkg)
    for i in range(2):
        kube.put_pod(_pod(f"p{i}"))
    chaos = pkg.mod("testing.chaos")
    server.faults = chaos.FaultInjector([chaos.Fault(
        op="WATCH", resource="pods", drop=True, times=1)])

    def later():
        time.sleep(0.2)
        kube.put_pod(_pod("p2"))
    threading.Thread(target=later, daemon=True).start()
    names = []
    for _etype, pod in client.watch_pods(NS, timeout_s=1.0):
        names.append(pod["metadata"]["name"])
        if "p2" in names:
            break
    assert names == ["p0", "p1", "p2"]
    assert len(server.faults.fired) == 1


class _RetryAfter(BaseHTTPRequestHandler):
    """Answers the first GET with 429 and ``Retry-After``, then the pod."""

    calls: list = []

    def log_message(self, *args):
        pass

    def do_GET(self):
        type(self).calls.append(time.monotonic())
        if len(type(self).calls) == 1:
            body = b'{"message": "slow down"}'
            self.send_response(429)
            self.send_header("Retry-After", "0.3")
        else:
            body = json.dumps(_pod("p1")).encode()
            self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


def test_rest_honours_retry_after(pkg, tmp_path):
    _RetryAfter.calls = []
    server = ThreadingHTTPServer(("127.0.0.1", 0), _RetryAfter)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        client = pkg.mod("k8s.client").InClusterKubeClient(
            host=f"http://127.0.0.1:{server.server_port}",
            sa_dir=str(tmp_path))
        client.retry_policy = _fast_policy(pkg)
        assert client.get_pod(NS, "p1")["metadata"]["name"] == "p1"
        first, second = _RetryAfter.calls
        assert second - first >= 0.3
    finally:
        server.shutdown()
        server.server_close()
        t.join(timeout=5)


def test_rest_classifies_connection_refused(pkg, tmp_path):
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    client = pkg.mod("k8s.client").InClusterKubeClient(
        host=f"http://127.0.0.1:{port}", sa_dir=str(tmp_path))
    client.retry_policy = _fast_policy(pkg)
    with pytest.raises(pkg.errors.K8sApiError) as exc:
        client.get_pod(NS, "nope")
    assert (exc.value.status, exc.value.cause) == (0, "refused")


def test_kubeconfig_client_over_the_facade(pkg, tmp_path, monkeypatch):
    """The out-of-cluster path (PyYAML, deferred to it): a kubeconfig
    pointing at the facade, picked by ``default_kube_client``."""
    kube = pkg.mod("k8s.client").FakeKubeClient()
    server = pkg.mod("testing.http_apiserver").HttpApiserver(kube)
    try:
        path = pkg.mod("testing.http_apiserver").write_kubeconfig(
            str(tmp_path / "kubeconfig"), server.base)
        monkeypatch.delenv("KUBERNETES_SERVICE_HOST", raising=False)
        monkeypatch.setenv("KUBECONFIG", path)
        client = pkg.mod("k8s.client").default_kube_client()
        assert type(client).__name__ == "KubeconfigKubeClient"
        client.create_pod(NS, _pod("k1"))
        assert kube.get_pod(NS, "k1")["metadata"]["name"] == "k1"
    finally:
        server.close()


# -- the shared pod informer --------------------------------------------------

@pytest.fixture
def kube(pkg):
    return _counting_kube(pkg)


@pytest.fixture
def informer(pkg, kube):
    inf = pkg.mod("k8s.informer").PodInformer(kube, NS,
                                              watch_chunk_s=1.0).start()
    yield inf
    inf.stop()


def test_reads_served_from_cache_without_lists(pkg, kube, informer):
    kube.put_pod(_pod("s1", labels={"app": "x"}))
    assert _wait(lambda: informer.get("s1") is not None)
    reads = pkg.mod("k8s.informer").PodCacheReads(kube, [informer])
    before, before_get = kube.list_calls, kube.get_calls
    for _ in range(10):
        assert [p["metadata"]["name"]
                for p in reads.list_pods(NS, "app=x")] == ["s1"]
    assert reads.get_pod(NS, "s1")["metadata"]["name"] == "s1"
    assert (kube.list_calls, kube.get_calls) == (before, before_get)


def test_cache_follows_events_and_answers_absence(pkg, kube, informer):
    reads = pkg.mod("k8s.informer").PodCacheReads(kube, [informer])
    kube.put_pod(_pod("s1"))
    assert _wait(lambda: informer.get("s1") is not None)
    kube.set_pod_status(NS, "s1", phase="Running")
    assert _wait(lambda: (informer.get("s1") or {}).get(
        "status", {}).get("phase") == "Running")
    kube.delete_pod(NS, "s1")
    assert _wait(lambda: informer.get("s1") is None)
    with pytest.raises(pkg.errors.PodNotFoundError):
        reads.get_pod(NS, "s1")


def test_uncovered_scope_falls_through(pkg, kube, informer):
    kube.put_pod(_pod("w1", namespace="default"))
    reads = pkg.mod("k8s.informer").PodCacheReads(kube, [informer])
    before = kube.list_calls
    assert reads.list_pods("default")
    assert kube.list_calls == before + 1


def test_write_fence_forces_fallthrough_when_cache_lags(pkg, kube,
                                                        informer):
    kube.put_pod(_pod("s1"))
    assert _wait(lambda: informer.get("s1") is not None)
    reads = pkg.mod("k8s.informer").PodCacheReads(kube, [informer],
                                                  fence_timeout_s=0.05)
    informer.note_write(str(int(informer.resource_version) + 100))
    before, before_get = kube.list_calls, kube.get_calls
    reads.list_pods(NS)
    reads.get_pod(NS, "s1")
    assert (kube.list_calls, kube.get_calls) == (before + 1,
                                                 before_get + 1)


def test_observe_write_makes_reads_read_your_writes(pkg, kube, informer):
    kube.put_pod(_pod("s1"))
    assert _wait(lambda: informer.get("s1") is not None)
    reads = pkg.mod("k8s.informer").PodCacheReads(kube, [informer],
                                                  fence_timeout_s=5.0)
    reads.observe_write(kube.patch_pod(
        NS, "s1", {"metadata": {"labels": {"owner": "o1"}}}))
    before = kube.list_calls
    assert [p["metadata"]["name"]
            for p in reads.list_pods(NS, "owner=o1")] == ["s1"]
    assert kube.list_calls == before


def test_watch_death_resyncs_and_cache_recovers(pkg, kube):
    chaos = pkg.mod("testing.chaos")
    inf = pkg.mod("k8s.informer").PodInformer(kube, NS,
                                              watch_chunk_s=30.0).start()
    try:
        assert _wait(inf.ready)
        kube.faults = chaos.FaultInjector(
            [chaos.Fault(op="WATCH", resource="pods", drop=True, times=8)])
        kube.put_pod(_pod("s-new"))
        assert _wait(lambda: inf.get("s-new") is not None, timeout_s=10.0)
        assert _wait(lambda: inf.watch_restarts >= 1, timeout_s=10.0)
        assert inf.status()["seeded"]
    finally:
        kube.faults = None
        inf.stop()


def test_wait_pods_fences_before_trusting_absence(pkg, kube, informer):
    assert _wait(informer.ready)
    kube.put_pod(_pod("fresh", phase="Running"))
    reads = pkg.mod("k8s.informer").PodCacheReads(kube, [informer],
                                                  fence_timeout_s=0.05)
    informer.note_write(str(int(informer.resource_version) + 100))
    seen = []

    def step(pods):
        seen.append(set(pods))
        return "fresh" in pods
    before = kube.list_calls
    assert reads.wait_pods(NS, None, step, timeout_s=2.0)
    assert kube.list_calls > before
    assert all("fresh" in s for s in seen)


def test_handle_without_informers_is_passthrough(pkg, kube):
    kube.put_pod(_pod("s1"))
    reads = pkg.mod("k8s.informer").PodCacheReads(kube)
    before = kube.list_calls
    assert reads.list_pods(NS)
    assert kube.list_calls == before + 1
    status = reads.status()
    assert (status["enabled"], status["scopes"]) == (False, [])


def test_cachez_status_keys_agree():
    """/cachez carries the same keys in both packages."""
    shapes = []
    for pkg in BOTH:
        kube = _counting_kube(pkg)
        inf = pkg.mod("k8s.informer").PodInformer(kube, NS).start()
        try:
            assert _wait(inf.ready)
            status = pkg.mod("k8s.informer").PodCacheReads(
                kube, [inf]).status()
            shapes.append((sorted(status), sorted(status["scopes"][0])))
        finally:
            inf.stop()
    assert shapes[0] == shapes[1]


def test_informer_over_the_rest_client(pkg, facade):
    """The production read path: the informer's LIST and WATCH go through
    the REST client to the facade, and follow the cluster."""
    kube, server, client = facade
    kube.put_pod(_pod("a"))
    inf = pkg.mod("k8s.informer").PodInformer(client, NS,
                                              watch_chunk_s=1.0).start()
    try:
        assert _wait(lambda: inf.get("a") is not None)
        kube.put_pod(_pod("b"))
        assert _wait(lambda: inf.get("b") is not None)
        kube.delete_pod(NS, "a")
        assert _wait(lambda: inf.get("a") is None)
    finally:
        inf.stop()


def test_parking_executor_and_parked_seam(pkg):
    """``parked()`` releases the executor's active slot while a handler
    waits, so more handlers run than the active budget."""
    parking = pkg.mod("utils.parking")
    ex = parking.ParkingExecutor(max_active=1, max_threads=8)
    release = threading.Event()
    started = []

    def handler(i):
        started.append(i)
        with parking.parked("test"):
            release.wait(5)
        return i
    try:
        futures = [ex.submit(handler, i) for i in range(4)]
        assert _wait(lambda: len(started) == 4)
        release.set()
        assert sorted(f.result(timeout=5) for f in futures) == [0, 1, 2, 3]
    finally:
        release.set()
        ex.shutdown(wait=True)

