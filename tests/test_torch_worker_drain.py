"""The worker's graceful drain, through both packages: the cases of
tests/test_worker_drain.py that tests/test_torch_worker.py and
tests/test_torch_worker_grpc.py do not hold. The drain's event sequence,
the typed 503 ``Draining`` across the gRPC and gateway hops, detaches
still served, a refusal that never trips the breaker, the health
server's /healthz, /readyz and /drainz (GET and POST), and an idle drain
that changes nothing of a normal attach and detach."""

import copy
import json
import urllib.error
import urllib.request

import grpc
import pytest

from tests.torch_control_plane import (BOTH, IDS, JAX, TORCH, norm_result,
                                       norm_uuid)


@pytest.fixture(params=BOTH, ids=IDS)
def pkg(request):
    return request.param


def test_drain_run_sequence_flushes_and_events(pkg):
    drain = pkg.mod("worker.drain").DrainController(
        f"drain-seq-{pkg.name}")
    assert drain.run(reason="unit") is True
    kinds = [e["kind"] for e in pkg.mod("utils.events").EVENTS.tail(200)
             if e.get("node") == f"drain-seq-{pkg.name}"]
    assert kinds == ["drain_begin", "drain_complete"]
    assert drain.status()["completed_unix"] is not None
    assert drain.begin("again") is False          # idempotent


@pytest.fixture
def drain_stack(pkg, tmp_path):
    """A rig with a DrainController, its live gRPC worker and a gateway."""
    sim = pkg.mod("testing.sim")
    rig = pkg.rig(tmp_path)
    rig.drain = pkg.mod("worker.drain").DrainController(rig.sim.node)
    rig.service.drain = rig.drain
    server, port = pkg.mod("worker.grpc_server").build_server(
        rig.service, port=0, address="127.0.0.1")
    server.start()
    master_kube = pkg.mod("k8s.client").FakeKubeClient()
    master_kube.put_pod(sim.worker_pod("node-a", "127.0.0.1"))
    master_kube.put_pod(sim.make_target_pod())
    gateway = pkg.mod("master.gateway").MasterGateway(
        master_kube, pkg.mod("master.discovery").WorkerDirectory(
            master_kube, grpc_port=port))
    yield rig, gateway, port
    server.stop(grace=0)
    rig.close()


ADD = "/add{dev}/namespace/default/pod/workload/{dev}/1/isEntireMount/false"
REMOVE = "/remove{dev}/namespace/default/pod/workload/force/false"


def test_draining_worker_answers_typed_503_draining(pkg, drain_stack):
    rig, gateway, port = drain_stack
    rig.drain.begin("test")
    with pkg.mod("worker.grpc_server").WorkerClient(
            f"127.0.0.1:{port}") as client:
        with pytest.raises(grpc.RpcError) as err:
            pkg.call(client, "add_{dev}", "workload", "default", 1, False,
                     request_id="rid-drain")
    assert err.value.code() == grpc.StatusCode.UNAVAILABLE
    assert err.value.details().startswith(
        pkg.consts.DRAINING_DETAIL_PREFIX)
    status, payload = gateway.handle("GET", pkg.fmt(ADD))
    assert (status, payload["result"]) == (503, "Draining")
    assert payload["retry_after_s"] > 0


def test_draining_worker_still_serves_detaches(pkg, drain_stack):
    rig, gateway, _ = drain_stack
    status, payload = gateway.handle("GET", pkg.fmt(ADD))
    assert status == 200, payload
    rig.drain.begin("test")
    status, payload = gateway.handle("POST", pkg.fmt(REMOVE))
    assert (status, payload["result"]) == (200, "SUCCESS")
    assert rig.drain.status()["refused"] == 0


def test_drain_refusal_is_not_a_breaker_failure(pkg, drain_stack):
    rig, gateway, port = drain_stack
    rig.drain.begin("test")
    for _ in range(gateway.breaker_failure_threshold + 2):
        status, payload = gateway.handle("GET", pkg.fmt(ADD))
        assert (status, payload["result"]) == (503, "Draining")
    gateway._breaker(f"127.0.0.1:{port}").allow()   # closed: no raise


def _get(base, path):
    try:
        with urllib.request.urlopen(base + path) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _post(base, path):
    req = urllib.request.Request(base + path, method="POST", data=b"")
    with urllib.request.urlopen(req) as resp:
        return resp.status, json.loads(resp.read())


def _health_transcript(pkg, tmp_path, with_drain=True) -> list:
    rig = pkg.rig(tmp_path)
    drain = None
    kwargs = {}
    if with_drain:
        drain = pkg.mod("worker.drain").DrainController("node-a")
        rig.service.drain = drain
        kwargs["drain"] = drain
    server = pkg.mod("worker.main").start_health_server(
        0, journal=rig.journal, ready=True, **kwargs)
    base = f"http://127.0.0.1:{server.server_port}"
    try:
        out = [_get(base, "/healthz"), _get(base, "/readyz")[0]]
        status, body = _get(base, "/drainz")
        body = json.loads(body)
        out.append((status, body == ({"enabled": True, **drain.status()}
                                     if drain else {"enabled": False})))
        if drain is None:
            return out
        started = _post(base, "/drainz")
        out.append((started[0], started[1]["started"],
                    started[1]["draining"]))
        out.append(_get(base, "/healthz"))
        out.append(_get(base, "/readyz")[0])
        out.append(_post(base, "/drainz")[1]["started"])
        return out
    finally:
        server.shutdown()
        rig.close()


def test_healthz_and_drainz_surfaces(pkg, tmp_path):
    assert _health_transcript(pkg, tmp_path) == [
        (200, b"ok"), 200, (200, True), (200, True, True),
        (200, b"draining"), 503, False]


def test_drainz_without_controller_answers_disabled(pkg, tmp_path):
    assert _health_transcript(pkg, tmp_path, with_drain=False) == [
        (200, b"ok"), 200, (200, True)]


def test_health_transcripts_agree(tmp_path):
    assert _health_transcript(TORCH, tmp_path / "torch") == \
        _health_transcript(JAX, tmp_path / "jax")


def _attach_detach(pkg, root, with_drain: bool):
    """One attach and detach, with the journal's records as shapes."""
    rig = pkg.rig(root)
    if with_drain:
        rig.drain = pkg.mod("worker.drain").DrainController(rig.sim.node)
        rig.service.drain = rig.drain
    try:
        add = pkg.add(rig.service, "workload", "default", 2, False,
                      request_id="rid-b4b")
        remove = pkg.remove(rig.service, "workload", "default", [], False,
                            request_id="rid-b4b2")
        records = copy.deepcopy(rig.journal.snapshot()["records"])
        for record in records:
            record.pop("ts", None)
            record.pop("jid", None)
            if "slaves" in record:
                record["slaves"] = len(record["slaves"])
        return (norm_result(add.result),
                sorted(norm_uuid(c.uuid) for c in add.chips),
                norm_result(remove.result), records)
    finally:
        rig.close()


def test_fault_free_path_with_idle_drain_is_byte_for_byte(pkg, tmp_path):
    events = pkg.mod("utils.events").EVENTS
    tail = events.tail(1)
    seq0 = tail[-1]["seq"] if tail else 0
    assert _attach_detach(pkg, tmp_path / "with", True) == \
        _attach_detach(pkg, tmp_path / "without", False)
    assert not [e for e in events.tail(300) if e["seq"] > seq0
                and e["kind"] in ("drain_begin", "drain_complete",
                                  "spot_termination")]


def test_idle_drain_outcomes_agree(tmp_path):
    jax_run = _attach_detach(JAX, tmp_path / "jax", True)
    torch_run = _attach_detach(TORCH, tmp_path / "torch", True)
    assert torch_run[:3] == jax_run[:3]
    assert [sorted(r) for r in torch_run[3]] == \
        [sorted(r) for r in jax_run[3]]       # the same record shapes
