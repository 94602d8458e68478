"""The port's master (master/gateway.py, discovery.py, httpfront.py,
fleet.py, utils/slo.py) against the control plane's, on the single-master
path both serve with HA, node health and topology off.

- One URL sequence through both packages' ``LiveStack`` (a real gRPC
  worker and a real HTTP master over a WorkerRig): every status code and
  JSON body agrees after the rename map (result names by role, device ids
  and paths by device, the status routes' ``chips``/``gpus`` lists, times
  and request ids aside).
- The scenarios of tests/test_master.py, test_httpfront.py,
  test_fleet.py, test_slo.py and test_tracez.py that the kept planes
  cover, each through both packages with the same inputs and the same
  expected answers.
- What only the port has: the slice routes answer 501 and
  ``HAConfig(enabled=True)`` raises, each naming its ROADMAP item.

The JAX side runs under ``TPU_NODE_HEALTH=0`` and ``TPU_TOPOLOGY=0``
(fixture ``planes_off``), the states the port serves in."""

import http.client
import json
import re
import socket
import threading
import time
import urllib.error
import urllib.request
import uuid

import pytest

from tests.torch_control_plane import BOTH, IDS, JAX, TORCH, norm_result


@pytest.fixture(autouse=True)
def planes_off(monkeypatch):
    monkeypatch.setenv("TPU_NODE_HEALTH", "0")
    monkeypatch.setenv("TPU_TOPOLOGY", "0")


@pytest.fixture(params=BOTH, ids=IDS)
def pkg(request):
    return request.param


def _get(url, method="GET", body=None, headers=None):
    req = urllib.request.Request(url, data=body, method=method)
    for k, v in (headers or {}).items():
        req.add_header(k, v)
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


# -- discovery -----------------------------------------------------------------

def _kube_and_pod(pkg):
    return (pkg.mod("k8s.client").FakeKubeClient(),
            pkg.mod("testing.sim").worker_pod)


def test_directory_resolves_caches_and_rate_limits_misses(pkg):
    kube, worker_pod = _kube_and_pod(pkg)
    discovery = pkg.mod("master.discovery")
    kube.put_pod(worker_pod("node-a", "10.0.0.5"))
    directory = discovery.WorkerDirectory(kube, ttl_s=60)
    assert directory.worker_target("node-a") == "10.0.0.5:1200"
    kube.put_pod(worker_pod("node-b", "10.0.0.6", name="w2"))
    with pytest.raises(discovery.WorkerNotFoundError):
        directory.worker_target("node-b")     # inside the miss floor
    directory.MISS_REFRESH_INTERVAL_S = 0.0
    assert directory.worker_target("node-b") == "10.0.0.6:1200"
    assert directory.targets() == {"node-a": "10.0.0.5:1200",
                                   "node-b": "10.0.0.6:1200"}


def test_directory_unknown_not_ready_and_port_annotation(pkg):
    kube, worker_pod = _kube_and_pod(pkg)
    discovery = pkg.mod("master.discovery")
    pod = worker_pod("node-a", "10.0.0.5")
    pod["status"]["phase"] = "Pending"
    kube.put_pod(pod)
    kube.put_pod(worker_pod("node-c", "10.0.0.7", name="w3",
                            grpc_port=4000))
    directory = discovery.WorkerDirectory(kube)
    for node in ("node-a", "nowhere"):
        with pytest.raises(discovery.WorkerNotFoundError):
            directory.worker_target(node)
    assert directory.worker_target("node-c") == "10.0.0.7:4000"


def test_directory_invalidate_forces_reresolve(pkg):
    kube, worker_pod = _kube_and_pod(pkg)
    kube.put_pod(worker_pod("node-a", "10.0.0.5"))
    directory = pkg.mod("master.discovery").WorkerDirectory(kube,
                                                            ttl_s=3600)
    assert directory.worker_target("node-a") == "10.0.0.5:1200"
    kube.delete_pod("kube-system", "w1")
    kube.put_pod(worker_pod("node-a", "10.0.0.9"))
    directory.invalidate("node-a")
    assert directory.worker_target("node-a") == "10.0.0.9:1200"


def test_worker_pod_label_follows_the_device():
    pods = [p.mod("testing.sim").worker_pod("n", "1.2.3.4") for p in BOTH]
    assert pods[0]["metadata"]["labels"] == {"app": "tpu-mounter-worker"}
    assert pods[1]["metadata"]["labels"] == {"app": "gpu-mounter-worker"}
    assert TORCH.consts.WORKER_LABEL_SELECTOR == "app=gpu-mounter-worker"


@pytest.mark.parametrize("body,query", [
    (b'{"uuids": ["a", "b"]}', ""), (b"uuids=a&uuids=b", ""),
    (b"uuids=a,b", ""), (b"", "uuids=a,b"), (b"", ""), (b"{bad json", ""),
    (b'{"uuids": "a,b"}', ""), (b'{"uuids": null}', ""),
    (b'{"uuids": 7}', ""), (b"{}", "")])
def test_parse_uuids_variants_agree(body, query):
    got = [p.mod("master.gateway")._parse_uuids(body, query) for p in BOTH]
    assert got[0] == got[1]


@pytest.mark.parametrize("token", [
    "1", "0", "t", "f", "T", "F", "true", "false", "True", "False", "TRUE",
    "FALSE", "maybe", "yes", ""])
def test_parse_bool_is_strconv_parsebool(token):
    got = [p.mod("master.gateway")._parse_bool(token) for p in BOTH]
    assert got[0] == got[1]


# -- the gateway over a live worker -------------------------------------------

@pytest.fixture
def stack(pkg, tmp_path):
    """WorkerRig + live gRPC worker + gateway whose directory points at it
    (the master's own fake cluster holds the target pod and the worker)."""
    rig = pkg.rig(tmp_path)
    server, port = pkg.mod("worker.grpc_server").build_server(
        rig.service, port=0, address="127.0.0.1")
    server.start()
    sim = pkg.mod("testing.sim")
    master_kube = pkg.mod("k8s.client").FakeKubeClient()
    master_kube.put_pod(sim.worker_pod("node-a", "127.0.0.1"))
    master_kube.put_pod(sim.make_target_pod())
    gateway = pkg.mod("master.gateway").MasterGateway(
        master_kube, pkg.mod("master.discovery").WorkerDirectory(
            master_kube, grpc_port=port))
    yield rig, gateway
    server.stop(grace=0)
    rig.close()


ADD = "/addgpu/namespace/default/pod/{pod}/gpu/{n}/isEntireMount/{entire}"
REMOVE = "/removegpu/namespace/default/pod/workload/force/{force}"


def add(gw, n=2, entire="false", pod="workload"):
    return gw.handle("GET", ADD.format(pod=pod, n=n, entire=entire))


def test_add_route_outcomes(pkg, stack):
    rig, gw = stack
    status, body = add(gw, 9)
    assert status == 503 and norm_result(body["result"]) == "INSUFFICIENT"
    assert add(gw, 1, "true", pod="ghost")[0] == 404
    status, body = add(gw, 2)
    assert status == 200 and body["result"] == "SUCCESS"
    assert len(body["device_ids"]) == 2 and len(rig.sim.slave_pods()) == 2
    assert body["device_paths"] == [f"{pkg.consts.NVIDIA_DEV_PREFIX}0",
                                    f"{pkg.consts.NVIDIA_DEV_PREFIX}1"] \
        if pkg is TORCH else body["device_paths"] == ["/dev/accel0",
                                                      "/dev/accel1"]


def test_policy_violation_is_412(stack):
    _, gw = stack
    add(gw, 4, "true")
    assert add(gw, 1)[0] == 412


def test_remove_route_roundtrip_and_busy(stack):
    rig, gw = stack
    _, body = add(gw, 1)
    rig.sim.enumerator.busy_pids = {body["device_paths"][0]: [rig.pid]}
    status, busy = gw.handle("POST", REMOVE.format(force="false"),
                             json.dumps({"uuids": body["device_ids"]})
                             .encode())
    assert status == 409 and busy["busy_pids"] == [rig.pid]
    assert norm_result(busy["result"]) == "BUSY"
    rig.sim.enumerator.busy_pids = {}
    status, done = gw.handle("POST", REMOVE.format(force="0"),
                             b"uuids=" + ",".join(body["device_ids"])
                             .encode())
    assert status == 200 and done["result"] == "SUCCESS"
    assert rig.sim.slave_pods() == []


def test_no_worker_on_node_is_502(pkg, stack):
    _, gw = stack
    gw.directory._by_node.clear()
    gw.directory.kube = pkg.mod("k8s.client").FakeKubeClient()
    status, body = add(gw, 1)
    assert status == 502 and body["result"] == "WorkerNotFound"


def test_parsebool_variants_and_unknown_routes(stack):
    _, gw = stack
    status, body = add(gw, 1, "False")
    assert status == 200 and body["result"] == "SUCCESS"
    status, body = gw.handle("POST", REMOVE.format(force="0"),
                             b"uuids=" + body["device_ids"][0].encode())
    assert status == 200 and body["result"] == "SUCCESS"
    status, body = add(gw, 1, "maybe")
    assert status == 400 and body["result"] == "BadRequest"
    assert gw.handle("GET", "/nope")[0] == 404
    assert gw.handle("GET", "/healthz", headers={"X-Request-Id": "r1"}) \
        == (200, {"status": "ok", "request_id": "r1"})


def test_node_status_route(pkg, stack):
    rig, gw = stack
    key = "gpus" if pkg is TORCH else "chips"
    status, body = gw.handle("GET", "/nodestatus/node/node-a")
    assert status == 200 and (body["free"], body["total"]) == (4, 4)
    add(gw, 2)
    status, body = gw.handle("GET", "/nodestatus/node/node-a")
    allocated = [c for c in body[key] if c["state"] == "ALLOCATED"]
    assert body["free"] == 2 and len(allocated) == 2
    assert all(c["namespace"] == rig.sim.settings.pool_namespace
               for c in allocated)
    status, body = gw.handle("GET", "/nodestatus/node/nope")
    assert status == 404 and body["result"] == "NodeNotFound"
    gw.kube.put_node({"metadata": {"name": "workerless"}})
    status, body = gw.handle("GET", "/nodestatus/node/workerless")
    assert status == 502 and body["result"] == "WorkerNotFound"


def test_node_status_reports_the_gke_accelerator_label(tmp_path):
    rig = TORCH.rig(tmp_path)
    try:
        server, port = TORCH.mod("worker.grpc_server").build_server(
            rig.service, port=0, address="127.0.0.1")
        server.start()
        sim = TORCH.mod("testing.sim")
        rig.sim.kube.put_node(sim.make_gpu_node(name="node-a", gpus=4))
        kube = TORCH.mod("k8s.client").FakeKubeClient()
        kube.put_pod(sim.worker_pod("node-a", "127.0.0.1"))
        gw = TORCH.mod("master.gateway").MasterGateway(
            kube, TORCH.mod("master.discovery").WorkerDirectory(
                kube, grpc_port=port))
        status, body = gw.handle("GET", "/nodestatus/node/node-a")
        assert status == 200
        assert [g["accelerator"] for g in body["gpus"]] == \
            ["nvidia-h100-80gb"] * 4
        assert all("topology" not in g for g in body["gpus"])
        server.stop(grace=0)
    finally:
        rig.close()


def test_status_route_follows_the_device(pkg, stack):
    """``/tpustatus`` in the control plane, ``/gpustatus`` (listing
    ``gpus``) in the port; each answers the other's name with 404."""
    rig, gw = stack
    _, added = add(gw, 2, "true")
    other = "tpu" if pkg is TORCH else "gpu"
    status, body = gw.handle(
        "GET", f"/{pkg.dev}status/namespace/default/pod/workload")
    key = "gpus" if pkg is TORCH else "chips"
    assert status == 200 and body["mount_type"] == "entire-mount"
    assert [g["device_id"] for g in body[key]] == added["device_ids"]
    assert all(g["slave_pod"] and g["busy_pids"] == [] for g in body[key])
    assert gw.handle("GET", f"/{other}status/namespace/default/pod/"
                            "workload")[0] == 404


# -- what only the port answers ------------------------------------------------

@pytest.mark.parametrize("path", ["/addgpuslice", "/removegpuslice",
                                  "/slice/resize", "/slice/barrier",
                                  "/slicez"])
@pytest.mark.parametrize("method", ["GET", "POST"])
def test_slice_routes_answer_501_naming_the_roadmap_item(method, path):
    kube = TORCH.mod("k8s.client").FakeKubeClient()
    gw = TORCH.mod("master.gateway").MasterGateway(
        kube, TORCH.mod("master.discovery").WorkerDirectory(kube))
    status, body = gw.handle(method, path, b"{}")
    assert status == 501 and body["result"] == "NotImplemented"
    assert "ROADMAP Queue 1 item 12a" in body["message"]


@pytest.mark.parametrize("kwargs", [{"shards": 2}, {"election": True},
                                    {"store": True}])
def test_ha_config_enabled_raises_naming_the_roadmap_item(kwargs):
    ha = TORCH.mod("master.shardring").HAConfig(replica="r0", **kwargs)
    assert ha.enabled
    kube = TORCH.mod("k8s.client").FakeKubeClient()
    with pytest.raises(NotImplementedError, match="Queue 1 item 12b"):
        TORCH.mod("master.gateway").MasterGateway(
            kube, TORCH.mod("master.discovery").WorkerDirectory(kube),
            ha=ha)


def test_ha_config_defaults_agree():
    configs = [p.mod("master.shardring").HAConfig(replica="r") for p in BOTH]
    keep = ("shards", "election", "store", "forward", "renew_interval_s",
            "lease_duration_s", "group_commit_delay_s", "enabled")
    assert [{k: getattr(c, k) for k in keep} for c in configs][0] == \
        {k: getattr(configs[1], k) for k in keep}
    assert configs[1].enabled is False
    rings = [p.mod("master.shardring").ShardRing(4) for p in BOTH]
    for ns in ("default", "teamA", "kube-system", "x" * 40):
        assert rings[0].shard_of(ns) == rings[1].shard_of(ns)


def test_planes_the_port_leaves_off(tmp_path):
    """The port's gateway has no node-health tracker, topology model,
    defragmenter or slice manager; /topoz is no route, as the control
    plane's with TPU_TOPOLOGY=0 (this test's environment)."""
    out = []
    for p in BOTH:
        kube = p.mod("k8s.client").FakeKubeClient()
        gw = p.mod("master.gateway").MasterGateway(
            kube, p.mod("master.discovery").WorkerDirectory(kube))
        out.append(gw.handle("GET", "/topoz", headers={"X-Request-Id":
                                                          "topo-1"}))
        assert getattr(gw, "nodehealth", None) is None
        assert getattr(gw, "topology", None) is None
        assert getattr(gw, "defrag", None) is None
    assert out[0] == out[1] == (404, {"result": "NoSuchRoute",
                                      "message": "/topoz",
                                      "request_id": "topo-1"})


# -- one URL sequence through both LiveStacks ----------------------------------

# ``unidentified``: the port's node-chips gauge also counts GPU nodes no
# UUID names (ROADMAP Queue 3 item 19), which /fleetz relays.
SCRUB = ("unidentified", "request_id", "device_ids", "device_paths", "device_id",
         "device_path", "slave_pod", "uuids", "created_unix",
         "expires_in_s", "rid", "version", "message", "base",
         "last_scrape_age_s", "events_seq", "events", "ts", "tick_interval_s",
         "waiting_s", "oldest_age_s")


def _scrub(obj):
    if isinstance(obj, dict):
        return {("gpus" if k == "chips" and isinstance(v, list) else k):
                _scrub(v) for k, v in obj.items()
                if k not in SCRUB and k != "topology"}
    if isinstance(obj, list):
        return [_scrub(v) for v in obj]
    if isinstance(obj, str):
        obj = re.sub(r"-slave-pod-[0-9a-f]+$", "-slave-pod-*", obj)
        return norm_result(obj).replace("tpu-pool", "<pool>").replace(
            "gpu-pool", "<pool>")
    return obj


def _sequence(pkg, tmp_path) -> list:
    rig = pkg.rig(tmp_path, actuator="procroot")
    live = pkg.mod("testing.sim").LiveStack(rig)
    base = live.base
    dev = pkg.dev
    out = []
    try:
        for method, path, body in (
                ("GET", "/healthz", None),
                ("GET", "/addgpu/namespace/default/pod/workload/gpu/9"
                        "/isEntireMount/false", None),
                ("GET", "/addgpu/namespace/default/pod/workload/gpu/2"
                        "/isEntireMount/T", None),
                ("GET", f"/{dev}status/namespace/default/pod/workload",
                 None),
                ("GET", "/nodestatus/node/node-a", None),
                ("GET", "/addgpu/namespace/default/pod/workload/gpu/1"
                        "/isEntireMount/false", None),
                ("POST", "/renew/namespace/default/pod/workload?ttl=0",
                 b""),
                ("GET", "/brokerz", None),
                ("POST", "/removegpu/namespace/default/pod/workload"
                         "/force/false", b""),
                ("POST", "/removegpu/namespace/default/pod/ghost"
                         "/force/false", b""),
                ("GET", "/addgpu/namespace/default/pod/workload/gpu/4"
                        "/isEntireMount/true", None),
                ("POST", "/removegpu/namespace/default/pod/workload"
                         "/force/1", b""),
                ("GET", "/nodestatus/node/nope", None),
                ("POST", "/brokerz", b""),
                ("GET", "/no/such", None)):
            status, payload = _get(base + path, method, body)
            out.append((method, path.replace(f"/{dev}status", "/status"),
                        status, _scrub(payload)))
        live.gateway.fleet.tick()
        status, fleetz = _get(base + "/fleetz")
        out.append(("fleetz", status, _scrub(fleetz)))
    finally:
        live.close()
    return out


def test_one_url_sequence_through_both_live_stacks(tmp_path):
    jax_side = _sequence(JAX, tmp_path / "jax")
    torch_side = _sequence(TORCH, tmp_path / "torch")
    for a, b in zip(jax_side, torch_side):
        assert a == b
    assert len(jax_side) == len(torch_side)


# -- the HTTP front ------------------------------------------------------------

@pytest.fixture
def bare_gateway(pkg):
    kube = pkg.mod("k8s.client").FakeKubeClient()
    return pkg.mod("master.gateway").MasterGateway(
        kube, pkg.mod("master.discovery").WorkerDirectory(kube))


def test_default_and_threaded_fronts(pkg, bare_gateway):
    from http.server import ThreadingHTTPServer
    server = bare_gateway.serve(port=0, address="127.0.0.1")
    try:
        assert isinstance(server,
                          pkg.mod("master.httpfront").MultiplexedHTTPServer)
    finally:
        server.shutdown()
    server = bare_gateway.serve(port=0, address="127.0.0.1",
                                front="threaded")
    try:
        assert isinstance(server, ThreadingHTTPServer)
    finally:
        server.shutdown()


def test_keep_alive_routes_and_errors_through_the_front(bare_gateway):
    server = bare_gateway.serve(port=0, address="127.0.0.1")
    try:
        conn = http.client.HTTPConnection("127.0.0.1", server.server_port,
                                          timeout=10)
        for _ in range(20):
            conn.request("GET", "/healthz")
            resp = conn.getresponse()
            assert resp.version == 11
            assert json.loads(resp.read())["status"] == "ok"
        conn.request("GET", "/no/such/route")
        resp = conn.getresponse()
        assert resp.status == 404
        assert json.loads(resp.read())["result"] == "NoSuchRoute"
        conn.request("POST", "/healthz")
        resp = conn.getresponse()
        assert resp.status == 405 and resp.headers["Allow"] == "GET"
        resp.read()
        conn.close()
    finally:
        server.shutdown()


def test_pipelined_requests_all_answered_in_order(bare_gateway):
    server = bare_gateway.serve(port=0, address="127.0.0.1")
    try:
        sock = socket.create_connection(("127.0.0.1", server.server_port),
                                        timeout=10)
        sock.sendall(b"GET /healthz HTTP/1.1\r\nHost: x\r\n\r\n" * 3)
        sock.settimeout(2.0)
        data = b""
        deadline = time.monotonic() + 10
        while data.count(b"HTTP/1.1 200") < 3 \
                and time.monotonic() < deadline:
            try:
                chunk = sock.recv(65536)
            except socket.timeout:
                break
            if not chunk:
                break
            data += chunk
        assert data.count(b"HTTP/1.1 200") == 3, data
        sock.close()
    finally:
        server.shutdown()


def test_concurrent_connections_multiplex_over_bounded_workers(
        pkg, bare_gateway):
    server = bare_gateway.serve(port=0, address="127.0.0.1", workers=4)
    results = []
    try:
        def one():
            conn = http.client.HTTPConnection(
                "127.0.0.1", server.server_port, timeout=15)
            for _ in range(5):
                conn.request("GET", "/healthz")
                results.append(
                    json.loads(conn.getresponse().read())["status"])
            conn.close()
        threads = [threading.Thread(target=one) for _ in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=30)
        assert results.count("ok") == 16 * 5 and server.workers == 4
        assert server.peak_inflight >= 1
        deadline = time.monotonic() + 5
        while pkg.registry.gateway_inflight.value() != 0 \
                and time.monotonic() < deadline:
            time.sleep(0.02)
        assert pkg.registry.gateway_inflight.value() == 0
    finally:
        server.shutdown()


def test_admission_rejects_beyond_connection_bound(pkg, bare_gateway):
    server = bare_gateway.serve(port=0, address="127.0.0.1", max_conns=2)
    held = []
    try:
        for _ in range(2):
            conn = http.client.HTTPConnection(
                "127.0.0.1", server.server_port, timeout=10)
            conn.connect()
            held.append(conn)
        rejected0 = pkg.registry.gateway_rejected.value()
        deadline = time.monotonic() + 10
        status = None
        while time.monotonic() < deadline and status != 503:
            probe = http.client.HTTPConnection(
                "127.0.0.1", server.server_port, timeout=5)
            try:
                probe.request("GET", "/healthz")
                status = probe.getresponse().status
            except (http.client.HTTPException, OSError):
                status = None
            finally:
                probe.close()
            if status != 503:
                time.sleep(0.05)
        assert status == 503
        assert pkg.registry.gateway_rejected.value() > rejected0
    finally:
        for conn in held:
            conn.close()
        server.shutdown()


def test_client_disconnect_while_idle_is_reaped(bare_gateway):
    server = bare_gateway.serve(port=0, address="127.0.0.1")
    try:
        conn = http.client.HTTPConnection("127.0.0.1", server.server_port,
                                          timeout=10)
        conn.request("GET", "/healthz")
        conn.getresponse().read()
        conn.close()
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline:
            with server._conns_lock:
                if not server._conns:
                    break
            time.sleep(0.02)
        with server._conns_lock:
            assert not server._conns
    finally:
        server.shutdown()


# -- the fleet view ------------------------------------------------------------

@pytest.fixture
def two_workers(pkg):
    start = pkg.mod("worker.main").start_health_server
    servers = [start(0, ready=True) for _ in range(2)]
    bases = {f"node-{i}": f"http://127.0.0.1:{s.server_port}"
             for i, s in enumerate(servers)}
    yield servers, bases
    for server in servers:
        try:
            server.shutdown()
        except Exception:   # noqa: BLE001 — one is dead mid-test
            pass


def test_tick_scrapes_every_worker_fresh(pkg, two_workers):
    _, bases = two_workers
    fleet = pkg.mod("master.fleet").FleetAggregator(
        lambda: bases, usage_fn=lambda: {"teamA": 4}, scrape_timeout_s=2.0)
    assert fleet.tick() == {"node-0": "fresh", "node-1": "fresh"}
    snap = fleet.snapshot()
    assert snap["ticks"] == 1 and snap["tenants"] == {"teamA": 4}
    for node in ("node-0", "node-1"):
        record = snap["nodes"][node]
        assert record["state"] == "fresh" and record["missed_ticks"] == 0
        assert record["last_scrape_age_s"] is not None
    assert "node_health" not in snap and "topology" not in snap


def test_killed_worker_goes_stale_and_its_breaker_opens(pkg, two_workers):
    servers, bases = two_workers
    fleet = pkg.mod("master.fleet").FleetAggregator(lambda: bases,
                                                    scrape_timeout_s=1.0)
    assert set(fleet.tick().values()) == {"fresh"}
    servers[0].shutdown()
    t0 = time.monotonic()
    states = fleet.tick()
    assert time.monotonic() - t0 < fleet.scrape_timeout_s + 2.0
    assert states == {"node-0": "stale", "node-1": "fresh"}
    assert fleet.snapshot()["nodes"]["node-0"]["missed_ticks"] == 1
    for _ in range(3):
        fleet.tick()
    breaker = fleet._breakers["node-0"]
    assert breaker.state == breaker.OPEN
    record = fleet.snapshot()["nodes"]["node-0"]
    assert record["state"] == "stale" and "breaker open" in record["error"]
    assert fleet.snapshot()["nodes"]["node-1"]["state"] == "fresh"


def test_event_tail_is_cursor_incremental_and_node_stamped(pkg,
                                                           two_workers):
    _, bases = two_workers
    only = {"node-0": bases["node-0"]}
    fleet = pkg.mod("master.fleet").FleetAggregator(lambda: only,
                                                    scrape_timeout_s=2.0)
    pkg.mod("utils.events").EVENTS.emit("fleet_test_marker",
                                        rid="fleet-rid-1")
    fleet.tick()
    hits = [e for e in fleet._tail if e["kind"] == "fleet_test_marker"]
    assert hits and hits[-1]["node"] == "node-0"
    fleet.tick()
    assert len([e for e in fleet._tail
                if e["kind"] == "fleet_test_marker"]) == len(hits)
    assert any(e["kind"] == "fleet_test_marker"
               for e in fleet.snapshot()["events"])


def test_fleetz_live_worker_fresh_then_stale(pkg, tmp_path):
    rig = pkg.rig(tmp_path)
    live = pkg.mod("testing.sim").LiveStack(rig)
    try:
        live.gateway.fleet.tick()
        status, view = _get(live.base + "/fleetz")
        assert status == 200
        assert view["nodes"]["node-a"]["state"] == "fresh"
        assert view["masters"] == {"enabled": False}
        live.health_server.shutdown()
        live.gateway.fleet.tick()
        status, view = _get(live.base + "/fleetz?limit=5")
        assert view["nodes"]["node-a"]["state"] == "stale"
        assert len(view["events"]) <= 5
    finally:
        live.close()


# -- SLO engine ----------------------------------------------------------------

class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, s):
        self.t += s


def _engine(pkg):
    reg = pkg.mod("utils.metrics").Registry()
    clock = FakeClock()
    return pkg.mod("utils.slo").SloEngine(registry=reg, clock=clock), reg, \
        clock


@pytest.mark.parametrize("granted,denied,tenant", [
    (100, 0, "teamA"), (95, 5, "teamB"), (1, 9, "hot")])
def test_attach_success_burns_agree(granted, denied, tenant):
    burns = []
    for p in BOTH:
        eng, reg, clock = _engine(p)
        eng.tick()
        clock.advance(60)
        for _ in range(granted):
            reg.admission_decisions.inc(tenant=tenant, outcome="granted")
        for _ in range(denied):
            reg.admission_decisions.inc(tenant=tenant,
                                        outcome="over_quota")
        burns.append((eng.tick(), eng.snapshot()["top_burn"],
                      reg.slo_burn_rate.value(tenant=tenant,
                                              slo="attach_success",
                                              window="5m")))
    assert burns[0] == burns[1]


def test_overhead_slo_reads_the_attach_route(pkg):
    """The fleet-wide overhead objective judges the gateway's attach
    route: ``addtpu`` in the control plane, ``addgpu`` in the port."""
    slo = pkg.mod("utils.slo")
    eng, reg, clock = _engine(pkg)
    eng.tick()
    clock.advance(60)
    route = f"add{pkg.dev}"
    for _ in range(98):
        reg.gateway_requests.observe(0.05, route=route)
    for _ in range(2):
        reg.gateway_requests.observe(slo.OVERHEAD_SLO_S + 5.0, route=route)
    burns = eng.tick()
    assert burns[("*", "attach_overhead", "5m")] == pytest.approx(
        0.02 / (1.0 - slo.TARGETS["attach_overhead"]), rel=1e-3)


def test_windows_low_traffic_reset_and_quiet_tenants(pkg):
    slo = pkg.mod("utils.slo")
    eng, reg, clock = _engine(pkg)
    assert eng.tick() == {}
    clock.advance(60)
    reg.admission_decisions.inc(tenant="tiny", outcome="over_quota")
    reg.admission_decisions.inc(tenant="tiny", outcome="granted")
    assert ("tiny", "attach_success", "5m") not in eng.tick()
    clock.advance(60)
    for _ in range(slo.MIN_WINDOW_SAMPLES):
        reg.admission_decisions.inc(tenant="tiny", outcome="granted")
    assert ("tiny", "attach_success", "5m") in eng.tick()
    for _ in range(10):
        reg.admission_decisions.inc(tenant="t", outcome="over_quota")
    clock.advance(60)
    assert eng.tick()[("t", "attach_success", "5m")] > 0
    eng.reset()
    assert reg.slo_burn_rate.value(tenant="t", slo="attach_success",
                                   window="5m") == 0.0
    assert eng.snapshot()["top_burn"] is None


def test_fast_burn_triggers_the_flight_recorder(pkg, tmp_path):
    import importlib
    fl = importlib.import_module(f"{pkg.root}.utils.flight")
    slo = pkg.mod("utils.slo")
    eng, reg, clock = _engine(pkg)
    fl.RECORDER.configure(str(tmp_path), min_interval_s=0.0, settle_s=0.0)
    try:
        eng.tick()
        clock.advance(60)
        for _ in range(10):
            reg.admission_decisions.inc(tenant="teamC",
                                        outcome="over_quota")
        assert eng.tick()[("teamC", "attach_success", "5m")] >= \
            slo.FAST_BURN
        bundles = fl.FlightRecorder.list_bundles(str(tmp_path))
        assert len(bundles) == 1 and bundles[0]["trigger"] == "fast_burn"
    finally:
        fl.RECORDER.configure(None)


# -- request tracing -----------------------------------------------------------

@pytest.fixture
def live(pkg, tmp_path):
    stack = pkg.mod("testing.sim").LiveStack(
        pkg.rig(tmp_path, use_kubelet_socket=True))
    yield stack
    stack.close()


def _span_names(span):
    yield span["name"]
    for child in span.get("children", []):
        yield from _span_names(child)


def _attach(base, rid):
    status, body = _get(f"{base}/addgpu/namespace/default/pod/workload"
                        "/gpu/2/isEntireMount/false",
                        headers={"X-Request-Id": rid})
    assert status == 200 and body["result"] == "SUCCESS", body


def test_master_tracez_stitches_master_and_worker_spans(pkg, live):
    rid = "e2e-stitch-" + uuid.uuid4().hex[:8]
    _attach(live.base, rid)
    status, payload = _get(f"{live.base}/tracez?rid={rid}")
    assert status == 200 and payload["rid"] == rid
    assert payload.get("stitch_errors") is None
    (trace,) = [t for t in payload["traces"] if t["op"] == f"add{pkg.dev}"]
    assert trace["result"] == "SUCCESS"
    names = list(_span_names(trace["spans"]))
    for name in ("resolve", "dial", "rpc"):
        assert name in names
    (rpc,) = [s for s in trace["spans"]["children"] if s["name"] == "rpc"]
    (worker,) = [c for c in rpc.get("children", [])
                 if c["name"] == "worker:attach"]
    worker_names = list(_span_names(worker))
    for phase in ("policy", "allocate", "resolve", "actuate", "k8s.list"):
        assert phase in worker_names
    if pkg is TORCH:          # the port's broker spans (Queue 3)
        assert "admission" in names and "lease" in names


def test_tracez_unknown_rid_404_and_recent(live):
    status, payload = _get(f"{live.base}/tracez?rid=e2e-miss-1")
    assert status == 404 and payload["traces"] == []
    rid = "e2e-plain-" + uuid.uuid4().hex[:8]
    _attach(live.base, rid)
    status, payload = _get(f"{live.base}/tracez")
    assert status == 200 and "slowest" in payload
    assert any(t["rid"] == rid for t in payload["recent"])


def test_gateway_request_histogram_by_route(pkg, live):
    _attach(live.base, "e2e-hist-" + uuid.uuid4().hex[:8])
    with urllib.request.urlopen(f"{live.base}/metrics") as resp:
        text = resp.read().decode()
    assert ('tpumounter_gateway_request_seconds_count{route="add'
            f'{pkg.dev}"}}') in text
    assert "tpumounter_k8s_request_seconds" in text
    assert "tpumounter_build_info{version=" in text
    assert text.count(" # {") == 0            # no exemplars in classic


def test_worker_tracez_serves_rid_filtered_span_trees(live):
    worker = f"http://127.0.0.1:{live.health_server.server_port}"
    rid = "e2e-worker-" + uuid.uuid4().hex[:8]
    _attach(live.base, rid)
    status, payload = _get(f"{worker}/tracez?rid={rid}")
    attaches = [t for t in payload["recent"] if t["op"] == "attach"]
    assert status == 200 and len(attaches) == 1
    assert attaches[0]["result"] == "SUCCESS"
    status, payload = _get(f"{worker}/tracez?rid={rid}&result=EXCEPTION")
    assert payload["recent"] == []
