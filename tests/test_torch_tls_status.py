"""Worker TLS, the status RPC and route, and the request id, through both
packages (the counterpart of tests/test_tls_status.py).

Each package's worker is served over mTLS with a self-signed cert carrying
that package's own fixed SAN (``tpu-mounter-worker`` /
``gpu-mounter-worker``, ROADMAP Queue 3), dialed by IP. The rest runs the
same scenario through both and compares what it returns after the GPU
mapping: the status body's device list is ``chips`` in the control plane
and ``gpus`` in the port (Queue 3 item 27a)."""

import grpc
import pytest

from tests.test_tls_status import make_cert
from tests.torch_control_plane import (BOTH, IDS, JAX, TORCH, norm_path,
                                       norm_result, norm_uuid)


@pytest.fixture(params=BOTH, ids=IDS)
def pkg(request):
    return request.param


def _tls(pkg, cert, key, ca=None):
    return pkg.mod("worker.grpc_server").TlsConfig(cert_file=cert,
                                                   key_file=key, ca_file=ca)


def _tls_round_trip(pkg, tmp_path) -> dict:
    """The production scenario: the master dials the worker by pod IP and
    verifies the package's fixed SAN through ssl_target_name_override; a
    plaintext client is refused."""
    grpc_server = pkg.mod("worker.grpc_server")
    tmp_path.mkdir(parents=True, exist_ok=True)
    cert, key = make_cert(tmp_path, "server", san=pkg.san)
    rig = pkg.rig(tmp_path / "host")
    server, port = grpc_server.build_server(
        rig.service, port=0, address="127.0.0.1",
        tls=_tls(pkg, cert, key, cert))
    server.start()
    try:
        client = grpc_server.WorkerClient(f"127.0.0.1:{port}",
                                          tls=_tls(pkg, cert, key, cert))
        added = pkg.call(client, "add_{dev}", "workload", "default", 1,
                         False)
        status = pkg.call(client, "{dev}_status", "workload", "default")
        client.close()
        plain = grpc_server.WorkerClient(f"127.0.0.1:{port}", timeout_s=3)
        with pytest.raises(grpc.RpcError) as refused:
            pkg.call(plain, "add_{dev}", "workload", "default", 1, False)
        plain.close()
        return {"added": added.result, "ids": len(added.device_ids),
                "status": (status.mount_type,
                           len(getattr(status, pkg.status_key))),
                "plaintext": refused.value.code().name}
    finally:
        server.stop(grace=0)
        rig.close()


def test_tls_round_trip_dialing_by_ip(pkg, tmp_path):
    out = _tls_round_trip(pkg, tmp_path)
    assert out["added"] == 0 and out["ids"] == 1
    assert out["status"] == ("single-mount", 1)
    assert out["plaintext"] == "UNAVAILABLE"


def test_tls_round_trips_agree(tmp_path):
    assert _tls_round_trip(TORCH, tmp_path / "torch") == \
        _tls_round_trip(JAX, tmp_path / "jax")


def test_a_cert_for_the_other_san_is_refused(pkg, tmp_path):
    """The client verifies the package's SAN: a cert carrying only the
    other package's name fails the handshake."""
    grpc_server = pkg.mod("worker.grpc_server")
    other = TORCH.san if pkg is JAX else JAX.san
    cert, key = make_cert(tmp_path, "other", san=other)
    rig = pkg.rig(tmp_path / "host")
    server, port = grpc_server.build_server(
        rig.service, port=0, address="127.0.0.1",
        tls=_tls(pkg, cert, key, cert))
    server.start()
    try:
        client = grpc_server.WorkerClient(f"127.0.0.1:{port}", timeout_s=3,
                                          tls=_tls(pkg, cert, key, cert))
        with pytest.raises(grpc.RpcError):
            pkg.call(client, "add_{dev}", "workload", "default", 1, False)
        client.close()
    finally:
        server.stop(grace=0)
        rig.close()


def _load(pkg, env) -> object:
    try:
        return pkg.mod("worker.grpc_server").load_tls_config(env)
    except ValueError as e:
        return f"ValueError: {e}"


def _env_transcript(pkg, cert, key) -> list:
    """load_tls_config over the same environments, by outcome."""
    out = []
    for env in ({}, {"TPU_MOUNTER_TLS_CERT_FILE": cert},
                {"TPU_MOUNTER_TLS_KEY_FILE": key},
                {"TPU_MOUNTER_TLS_CA_FILE": cert},
                {"TPU_MOUNTER_TLS_CERT_FILE": cert,
                 "TPU_MOUNTER_TLS_KEY_FILE": key},
                {"TPU_MOUNTER_TLS_CERT_FILE": cert,
                 "TPU_MOUNTER_TLS_KEY_FILE": key,
                 "TPU_MOUNTER_TLS_CA_FILE": cert},
                {"TPU_MOUNTER_TLS_CA_FILE": cert,
                 "TPU_MOUNTER_TLS_SERVER_NAME": "w.example"}):
        cfg = _load(pkg, env)
        if cfg is None or isinstance(cfg, str):
            out.append(cfg)
            continue
        row = [cfg.cert_file, cfg.key_file, cfg.ca_file,
               cfg.server_name == pkg.san, cfg.channel_options()[0][0]]
        cfg.channel_credentials()
        try:
            cfg.server_credentials()
            row.append("serves")
        except ValueError as e:
            row.append(f"ValueError: {e}")
        out.append(row)
    return out


def test_load_tls_config_rejects_partial_pair(pkg, tmp_path):
    cert, key = make_cert(tmp_path, "x", san=pkg.san)
    rows = _env_transcript(pkg, cert, key)
    assert rows[0] is None
    assert rows[1].startswith("ValueError") and \
        rows[2].startswith("ValueError")
    # CA-only is a valid client (server-auth TLS) that cannot serve
    assert rows[3][:3] == [None, None, cert]
    assert rows[3][-1].startswith("ValueError")


def test_load_tls_config_from_env(pkg, tmp_path):
    cert, key = make_cert(tmp_path, "w", san=pkg.san)
    rows = _env_transcript(pkg, cert, key)
    assert rows[4] == [cert, key, None, True,
                       "grpc.ssl_target_name_override", "serves"]
    assert rows[5][:3] == [cert, key, cert] and rows[5][-1] == "serves"
    assert rows[6][3] is False          # the override replaces the SAN


def test_tls_env_transcripts_agree(tmp_path):
    cert, key = make_cert(tmp_path, "w")
    assert _env_transcript(TORCH, cert, key) == \
        _env_transcript(JAX, cert, key)


# -- the binaries pass the loaded config through ------------------------------

class _Stop(Exception):
    pass


def _tls_env(monkeypatch, tmp_path, san):
    cert, key = make_cert(tmp_path, "bin", san=san)
    for k, v in (("TPU_MOUNTER_TLS_CERT_FILE", cert),
                 ("TPU_MOUNTER_TLS_KEY_FILE", key),
                 ("TPU_MOUNTER_TLS_CA_FILE", cert)):
        monkeypatch.setenv(k, v)
    return cert, key


def test_master_main_dials_workers_with_the_loaded_tls(pkg, tmp_path,
                                                      monkeypatch):
    cert, key = _tls_env(monkeypatch, tmp_path, pkg.san)
    main = pkg.mod("master.main")
    kube = pkg.mod("k8s.client").FakeKubeClient()
    monkeypatch.setattr(main, "default_kube_client", lambda: kube)
    seen = {}

    def gateway(kube, directory, worker_client_factory, **kwargs):
        seen["factory"] = worker_client_factory
        raise _Stop
    monkeypatch.setattr(main, "MasterGateway", gateway)
    monkeypatch.setattr(main, "WorkerClient",
                        lambda target, tls=None: (target, tls))
    with pytest.raises(_Stop):
        main.main()
    target, tls = seen["factory"]("10.0.0.7:1200")
    assert target == "10.0.0.7:1200"
    assert (tls.cert_file, tls.key_file, tls.ca_file, tls.server_name) == \
        (cert, key, cert, pkg.san)


def test_worker_main_serves_with_the_loaded_tls(pkg, tmp_path, monkeypatch):
    cert, key = _tls_env(monkeypatch, tmp_path, pkg.san)
    for k, v in (("TPU_USAGE", "0"), ("TPU_TOPOLOGY", "0"),
                 ("TPU_WARM_POOL", "")):
        monkeypatch.setenv(k, v)
    main = pkg.mod("worker.main")
    rig = pkg.rig(tmp_path / "host")

    class _Reconciler:
        def __init__(self, *args, **kwargs):
            pass

        def start(self):
            return self
    monkeypatch.setattr(main, "start_health_server", lambda *a, **k: None)
    monkeypatch.setattr(main, "build_stack", lambda settings: rig.service)
    monkeypatch.setattr(pkg.mod("worker.reconciler"), "OrphanReconciler",
                        _Reconciler)
    seen = {}

    def build_server(service, port, tls=None, **kwargs):
        seen["tls"], seen["service"] = tls, service
        raise _Stop
    monkeypatch.setattr(main, "build_server", build_server)
    try:
        with pytest.raises(_Stop):
            main.main()
    finally:
        rig.close()
    tls = seen["tls"]
    assert seen["service"] is rig.service
    assert (tls.cert_file, tls.key_file, tls.ca_file, tls.server_name) == \
        (cert, key, cert, pkg.san)
    tls.server_credentials()            # the worker can serve with it


# -- the status route and the request id --------------------------------------

@pytest.fixture
def stack(pkg, tmp_path):
    s = pkg.mod("testing.sim").LiveStack(pkg.rig(tmp_path))
    yield s
    s.close()


def _status_transcript(pkg, stack) -> list:
    rig, gateway = stack.rig, stack.gateway
    route = pkg.fmt("/{dev}status/namespace/default/pod/workload")
    out = []
    status, body = gateway.handle("GET", route)
    out.append((status, body["mount_type"], body[pkg.status_key]))
    gateway.handle("GET", pkg.fmt(
        "/add{dev}/namespace/default/pod/workload/{dev}/2/"
        "isEntireMount/true"))
    rig.sim.enumerator.busy_pids = {pkg.node(0): [rig.pid]}
    status, body = gateway.handle("GET", route)
    out.append((status, body["mount_type"], sorted(
        (norm_uuid(d["device_id"]), norm_path(d["device_path"]),
         d["busy_pids"], d["slave_pod"].startswith("workload-slave-pod-"))
        for d in body[pkg.status_key])))
    status, body = gateway.handle(
        "GET", pkg.fmt("/{dev}status/namespace/default/pod/ghost"))
    out.append((status, norm_result(body.get("result", ""))))
    return out


def test_status_route_reports_devices_and_busy(pkg, stack):
    empty, attached, ghost = _status_transcript(pkg, stack)
    assert empty == (200, "no-mount", [])
    assert attached == (200, "entire-mount", [
        ("dev0", "dev0", [stack.rig.pid], True),
        ("dev1", "dev1", [], True)])
    assert ghost[0] == 404


def test_status_transcripts_agree(tmp_path):
    out = {}
    for pkg in BOTH:
        s = pkg.mod("testing.sim").LiveStack(pkg.rig(tmp_path / pkg.name))
        try:
            out[pkg.name] = _status_transcript(pkg, s)
        finally:
            s.close()
    assert out["torch"] == out["jax"]


def test_request_id_echoed_and_unique(pkg, stack):
    _, b1 = stack.gateway.handle("GET", "/healthz")
    _, b2 = stack.gateway.handle("GET", "/healthz")
    assert b1["request_id"] != b2["request_id"]
    _, b3 = stack.gateway.handle("GET", pkg.fmt(
        "/add{dev}/namespace/default/pod/workload/{dev}/1/"
        "isEntireMount/false"))
    assert len(b3["request_id"]) == 12
    status, b4 = stack.gateway.handle(
        "GET", "/healthz", headers={"X-Request-Id": "ops-trace-7"})
    assert (status, b4["request_id"]) == (200, "ops-trace-7")
    status, b5 = stack.gateway.handle(
        "GET", "/healthz", headers={"X-Request-Id": "not a label!"})
    assert (status, b5["result"]) == (400, "BadRequestId")
