"""gpumounterctl (the port's CLI) held against tpumounterctl: the cases of
tests/test_cli.py, each run through both packages. A live-stack case sends
the same scenario through each package's CLI to its own ``LiveStack`` (or
``MultiNodeStack``) and holds exit codes, ``--json`` keys and doctor's
checks to one expectation, after the renames below; a case over a stubbed
fetch runs both CLIs on the same payloads and compares their output whole.

The renames: the port's flags, routes, result names and device words are
the GPU's (``--gpus``, ``/addgpu``, ``INSUFFICIENT_GPU``, ``/dev/nvidiaN``,
``GPU(s)``, ``gpu-pool``, ``gpus`` in ``/gpustatus`` and ``/nodestatus``);
metric families, environment names and the ``chips`` keys of the master's
views are the control plane's in both."""

import contextlib
import io
import json
import os
import re
import stat
import subprocess
import sys

import pytest

from gpumounter_tpu import cli as jax_cli
from gpumounter_tpu_torch import cli as torch_cli
from tests.torch_control_plane import BOTH, IDS, JAX, TORCH

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLIS = {"jax": jax_cli, "torch": torch_cli}
FLAG = {"jax": "--tpus", "torch": "--gpus"}
PER_HOST = {"jax": "--tpus-per-host", "torch": "--gpus-per-host"}

# The port's words -> the control plane's, applied to the port's output
# before it is compared (longest first: "GPU(s)" before "GPU").
RENAMES = (
    ("gpumounterctl", "tpumounterctl"),
    ("INSUFFICIENT_GPU", "INSUFFICIENT_TPU"), ("InsufficientGPU",
                                               "InsufficientTPU"),
    ("GPU_NOT_FOUND", "TPU_NOT_FOUND"), ("GPUNotFound", "TPUNotFound"),
    ("GPU_BUSY", "TPU_BUSY"), ("GPUBusy", "TPUBusy"),
    ("/dev/nvidia", "/dev/accel"), ("gpu-pool", "tpu-pool"),
    ("op=addgpu", "op=addtpu"), ("op=removegpu", "op=removetpu"),
    ("gpus[", "chips["), ("gpus=", "chips="),
    ("GPU(s)", "chip(s)"), ("GPUs", "chips"), ("GPU", "chip"),
)
# JSON keys the port renamed (ROADMAP Queue 3 item 27a).
KEY_RENAMES = {"gpus": "chips", "gpus_per_host": "tpus_per_host"}


def jax_words(text: str) -> str:
    for gpu, tpu in RENAMES:
        text = text.replace(gpu, tpu)
    return text


def norm_keys(obj):
    """The nested key structure of a JSON payload, in the control plane's
    names (lists by their first element)."""
    if isinstance(obj, dict):
        return {KEY_RENAMES.get(k, k): norm_keys(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [norm_keys(obj[0])] if obj else []
    return None


def run_cli(pkg, base, *argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = CLIS[pkg.name].main(["--master", base, *argv])
    return rc, out.getvalue()


def output(pkg, base, *argv):
    """``run_cli`` with the output in the control plane's words."""
    rc, out = run_cli(pkg, base, *argv)
    return rc, (jax_words(out) if pkg is TORCH else out)


@pytest.fixture(params=BOTH, ids=IDS)
def pkg(request):
    return request.param


@pytest.fixture
def live_stack(pkg, tmp_path):
    stack = pkg.mod("testing.sim").LiveStack(
        pkg.rig(tmp_path, use_kubelet_socket=True))
    yield stack.rig, stack.base
    stack.close()


def _multinode(pkg, tmp_path):
    hosts = [pkg.host(tmp_path / f"host{i}") for i in range(2)]
    return pkg.mod("testing.sim").MultiNodeStack(hosts)


def test_add_status_remove_roundtrip(pkg, live_stack):
    rig, base = live_stack
    rc, out = output(pkg, base, "add", "workload", "-n", "default",
                     FLAG[pkg.name], "4", "--entire")
    assert rc == 0
    assert "SUCCESS" in out and "/dev/accel0" in out

    rc, out = output(pkg, base, "status", "workload")
    assert rc == 0
    assert "mount_type=entire" in out
    assert out.count("via") == 4

    _, payload = run_cli(pkg, base, "--json", "status", "workload")
    uuids = [g["device_id"] for g in
             json.loads(payload)["gpus" if pkg is TORCH else "chips"]]
    rc, out = output(pkg, base, "remove", "workload", "--uuids",
                     ",".join(uuids))
    assert rc == 0 and "SUCCESS" in out
    assert rig.sim.slave_pods() == []


def test_json_output_and_exit_codes(pkg, live_stack):
    rig, base = live_stack
    cli = CLIS[pkg.name]
    rc, out = run_cli(pkg, base, "--json", "add", "nosuchpod")
    assert rc == cli.EXIT_CODES["PodNotFound"] == 4
    assert json.loads(out)["result"] == "PodNotFound"

    rc, out = run_cli(pkg, base, "--json", "add", "workload",
                      FLAG[pkg.name], "99")
    assert rc == 3
    payload = json.loads(out)
    assert jax_words(payload["result"]) == "INSUFFICIENT_TPU"
    assert sorted(norm_keys(payload)) == [
        "device_ids", "device_paths", "request_id", "result"]

    rc, out = run_cli(pkg, base, "remove", "workload")
    assert rc == 6
    assert jax_words(out.split(":")[0]) == "TPU_NOT_FOUND"

    rc, out = run_cli(pkg, base, "health")
    assert rc == 0 and "ok" in out


def test_exit_codes_keep_the_control_plane_numbers():
    """Every result name of tpumounterctl has its GPU name in
    gpumounterctl, under the same number."""
    assert {jax_words(k): v for k, v in torch_cli.EXIT_CODES.items()} \
        == jax_cli.EXIT_CODES
    assert torch_cli.EXIT_TRANSPORT == jax_cli.EXIT_TRANSPORT == 10
    assert torch_cli.EXIT_DOCTOR_CRIT == jax_cli.EXIT_DOCTOR_CRIT == 12


def test_transport_error_exit_code(pkg):
    rc = CLIS[pkg.name].main(["--master", "http://127.0.0.1:1",
                              "--timeout", "1", "status", "x"])
    assert rc == CLIS[pkg.name].EXIT_TRANSPORT == 10


def test_retry_reuses_request_id(pkg, live_stack, monkeypatch):
    """The same X-Request-Id on the retry after a transient failure, which
    the gateway and the allocator turn into a resume: one slave pod."""
    rig, base = live_stack
    cli = CLIS[pkg.name]
    seen_rids = []
    real_request = cli._request
    calls = {"n": 0}

    def flaky(master, method, path, body=None, headers=None, timeout=60.0):
        calls["n"] += 1
        if headers and "X-Request-Id" in headers:
            seen_rids.append(headers["X-Request-Id"])
        if calls["n"] == 1:
            raise cli.TransportError("connection reset mid-reply")
        return real_request(master, method, path, body, headers, timeout)

    monkeypatch.setattr(cli, "_request", flaky)
    monkeypatch.setattr(cli.time, "sleep", lambda s: None)
    rc, out = run_cli(pkg, base, "add", "workload", FLAG[pkg.name], "2",
                      "--entire")
    assert rc == 0 and "SUCCESS" in out
    assert len(seen_rids) == 2 and seen_rids[0] == seen_rids[1]
    assert len(rig.sim.slave_pods()) == 1


def test_slice_pod_spec_parsing(pkg):
    cli = CLIS[pkg.name]
    assert cli._parse_slice_pods(["ns1/a", "b"]) == [
        {"namespace": "ns1", "pod": "a"},
        {"namespace": "default", "pod": "b"}]
    with pytest.raises(ValueError):
        cli._parse_slice_pods(["ns1/"])
    with pytest.raises(ValueError):
        cli._parse_slice_pods(["/pod"])


def test_slice_add_against_multinode(pkg, tmp_path):
    stack = _multinode(pkg, tmp_path)
    try:
        rc, out = output(pkg, stack.base, "slice", "add",
                         "-p", "default/workload-0", "-p",
                         "default/workload-1", PER_HOST[pkg.name], "4")
        assert rc == 0 and "SUCCESS" in out
        rc, out = run_cli(pkg, stack.base, "--json", "slice", "status")
        assert rc == 0
        (group,) = json.loads(out)["groups"].values()
        assert group["chips"] == 8
        rc, out = output(pkg, stack.base, "slice", "remove",
                         "-p", "default/workload-0", "-p",
                         "default/workload-1")
        assert rc == 0 and "SUCCESS" in out
    finally:
        stack.close()


def test_node_inventory_command(pkg, live_stack):
    rig, base = live_stack
    rc, out = output(pkg, base, "node", "node-a")
    assert rc == 0
    assert "4/4 chips free" in out
    run_cli(pkg, base, "add", "workload", FLAG[pkg.name], "1")
    rc, out = output(pkg, base, "node", "node-a")
    assert rc == 0 and "3/4 chips free" in out
    assert "tpu-pool/workload-slave-pod-" in out
    rc, out = run_cli(pkg, base, "node", "nope")
    assert rc == 1 and "NodeNotFound" in out and "None" not in out


def test_slice_remove_retry_converges(pkg, tmp_path):
    """A retried slice remove after a lost reply converges to SUCCESS:
    the detach counts the not-found result as done."""
    stack = _multinode(pkg, tmp_path)
    pods = ["-p", "default/workload-0", "-p", "default/workload-1"]
    try:
        rc, _ = run_cli(pkg, stack.base, "slice", "add", *pods)
        assert rc == 0
        rc, _ = run_cli(pkg, stack.base, "slice", "remove", *pods)
        assert rc == 0
        rc, out = run_cli(pkg, stack.base, "slice", "remove", *pods)
        assert rc == 0 and "SUCCESS" in out
    finally:
        stack.close()


def test_exposition_round_trip_registry_to_parser():
    """The port's Registry renders text that gpumounterctl's parser reads
    back into every series with its exact value (the control plane's
    round trip, through the port's registry and route labels)."""
    from gpumounter_tpu_torch.utils.metrics import Registry
    reg = Registry()
    reg.attach_latency.observe(0.3)
    reg.attach_latency.observe(7.5)
    reg.detach_latency.observe(0.01)
    reg.attach_results.inc(result="SUCCESS")
    reg.attach_results.inc(2, result="EXCEPTION")
    reg.chips.set(3, state="free")
    reg.chips.set(1, state="allocated")
    reg.warm_pool_size.set(2, key="entire:4")
    reg.pool_refill_latency.observe(1.25)
    reg.attach_phase.observe(0.2, phase="allocate")
    reg.attach_phase.observe(0.05, phase="actuate")
    reg.detach_phase.observe(0.1, phase="cleanup")
    reg.gateway_requests.observe(0.4, route="addgpu",
                                 exemplar={"rid": "deadbeef0001"})
    reg.attach_latency.observe(0.31, exemplar={"rid": "deadbeef0002"})
    reg.k8s_latency.observe(0.02, verb="GET", resource="pods")
    reg.k8s_errors.inc(verb="LIST", resource="pods")
    reg.events_emitted.inc(kind="attach")
    reg.events_emitted.inc(3, kind="lease_record")
    reg.queue_wait.observe(2.5, tenant="teamA")
    reg.slo_burn_rate.set(1.25, tenant="teamA", slo="attach_success",
                          window="5m")
    reg.flight_dumps.inc(trigger="fast_burn")
    reg.fleet_nodes.set(3, state="fresh")
    reg.chip_duty_cycle.set(0.93, chip="GPU-0")
    reg.lease_utilization.set(0.45, tenant="teamA")
    reg.tenant_chips_idle.set(2, tenant="teamB")
    reg.device_opens.inc(tenant="teamA", outcome="attributed")
    reg.device_opens.inc(2, tenant="", outcome="unattributed")
    reg.fleet_fragmentation_score.set(0.62)
    reg.node_free_contiguous_chips.set(2, node="node-0")
    reg.stranded_chips.set(1)
    reg.slice_contiguity.set(1, group="g1")
    reg.tenant_chips_in_use_global.set(6, tenant="teamA")
    reg.defrag_candidates.inc(node="node-1")

    plain = reg.render_text()
    assert " # {" not in plain and "deadbeef0001" not in plain
    text = reg.render_text(openmetrics=True)
    parsed = torch_cli._parse_exposition(text)
    assert "deadbeef0001" in text and " # {" in text
    assert text.rstrip().endswith("# EOF")
    assert "# TYPE tpumounter_events counter" in text
    assert "# TYPE tpumounter_events_total counter" in plain
    assert torch_cli._parse_exposition(plain)[
        "tpumounter_gateway_request_seconds_bucket"] == parsed[
        "tpumounter_gateway_request_seconds_bucket"]
    # both CLIs parse the port's text to the same series
    assert jax_cli._parse_exposition(text) == parsed

    reproduced = 0
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        line = line.split(" # ", 1)[0].rstrip()
        name = line.partition("{")[0].split()[0]
        value = float(line.rsplit(" ", 1)[1])
        labels = {}
        if "{" in line:
            inner = line.partition("{")[2].rpartition("}")[0]
            for part in inner.split(","):
                k, _, v = part.partition("=")
                labels[k] = v.strip('"')
        assert parsed[name].get(tuple(sorted(labels.items()))) == value, line
        reproduced += 1
    assert reproduced == sum(len(s) for s in parsed.values())
    assert reproduced > 60
    assert torch_cli._counter_total(parsed, "tpumounter_attach_total",
                                    result="EXCEPTION") == 2
    p50 = torch_cli._histogram_quantile(
        parsed, "tpumounter_attach_phase_seconds", 0.5, phase="allocate")
    assert p50 is not None and 0 < p50 <= 0.25
    assert torch_cli._counter_total(parsed, "tpumounter_events_total") == 4
    assert parsed["tpumounter_gateway_request_seconds_bucket"][
        (("le", "0.5"), ("route", "addgpu"))] == 1
    assert parsed["tpumounter_fleet_fragmentation_score"][()] == 0.62
    assert torch_cli._counter_total(
        parsed, "tpumounter_defrag_candidates_total", node="node-1") == 1


def _dirty(pkg) -> bool:
    """Whether the process-wide registry of ``pkg`` already holds the
    lifetime failures doctor WARNs on (earlier tests record them)."""
    reg = pkg.registry
    return (reg.attach_results.value(result="EXCEPTION")
            + reg.detach_results.value(result="EXCEPTION")
            + reg.attach_results.value(result="slice_ERROR")
            + reg.detach_results.value(result="slice_ERROR")
            + reg.attach_phase.count(phase="rollback")) > 0


def doctor_checks(pkg, base, *argv) -> tuple[int, list]:
    """doctor's --json verdict as (exit code, [(level, message)]) in the
    control plane's words, numbers and request ids masked."""
    rc, out = run_cli(pkg, base, "--json", "doctor", *argv)
    payload = json.loads(out)
    assert payload["exit_code"] == rc
    checks = []
    for check in payload["checks"]:
        message = jax_words(check["message"]) if pkg is TORCH \
            else check["message"]
        # the trace store is process-wide too: the slowest stored trace
        # may be any earlier test's
        message = re.sub(r"[0-9a-f]{12}", "<rid>", message)
        message = re.sub(r"op=\S+", "op=<op>", message)
        message = re.sub(r"dominant span \S+", "dominant span <span>",
                         message)
        checks.append((check["level"], re.sub(r"\d+(\.\d+)?", "N",
                                              message)))
    return rc, checks


# Checks whose level rests on lifetime counters and gauges of the
# process-wide registry (ROADMAP Queue 3 item 5): their level depends on
# what earlier tests in the process recorded, so live-stack parity holds
# everything else to the expectation.
HISTORY = ("exceptions:", "attach rollbacks:", "attach pN",
           "N attach(es) routed", "no attaches recorded",
           "orphaned slave pods", "journal replays", "circuit",
           "transient-fault", "fleet fragment", "stranded", "defrag",
           "SLO burn", "FAST SLO", "slow SLO", "idle leased",
           "no leased chips idle", "flight-recorder", "leadership",
           "actuation agent", "broker reclaims", "lease fences",
           "device denials", "device gate", "top burn")

DOCTOR_LIVE = [
    ("ok", "master reachable, status=ok"),
    ("ok", "target version N.N (tpumounter_build_info)"),
    ("ok", "attach queue empty"),
    ("ok", "fleet: no workers discovered yet"),
    ("ok", "slowest stored trace: op=<op> rid=<rid> Ns, dominant span "
           "<span> Nms — `tpumounterctl trace <rid>` for the tree"),
]


def _steady(checks) -> list:
    return [(lvl, msg) for lvl, msg in checks
            if not any(words in msg for words in HISTORY)]


def test_doctor_reports_version_and_slowest_trace(pkg, live_stack):
    _, base = live_stack
    run_cli(pkg, base, "add", "workload", FLAG[pkg.name], "1")
    rc, out = output(pkg, base, "doctor")
    assert f"target version {sys.modules[pkg.root].__version__}" in out
    assert "slowest stored trace" in out
    assert "dominant span" in out
    assert "tpumounterctl trace" in out
    _, checks = doctor_checks(pkg, base)
    assert _steady(checks) == DOCTOR_LIVE


def test_doctor_healthy_stack(pkg, live_stack):
    _, base = live_stack
    run_cli(pkg, base, "add", "workload", FLAG[pkg.name], "2")
    dirty = _dirty(pkg)
    rc, out = output(pkg, base, "doctor", "--node", "node-a")
    assert rc == (1 if dirty else 0), out
    for words in ("master reachable", "worker-local", "attach rollbacks:",
                  "attach p95", "chips free"):
        assert words in out
    rc, checks = doctor_checks(pkg, base, "--node", "node-a")
    assert rc == (1 if dirty else 0)
    assert _steady(checks) == DOCTOR_LIVE + [
        ("ok", "node node-a: N/N chips free")]


def test_doctor_flags_node_exhaustion_and_bad_node(pkg, live_stack):
    _, base = live_stack
    cli = CLIS[pkg.name]
    run_cli(pkg, base, "add", "workload", FLAG[pkg.name], "4", "--entire")
    rc, out = output(pkg, base, "doctor", "--node", "node-a")
    assert rc == 1
    assert "0/4 chips free" in out
    rc, out = run_cli(pkg, base, "doctor", "--node", "ghost-node")
    assert rc == cli.EXIT_DOCTOR_CRIT
    assert "NodeNotFound" in out
    _, checks = doctor_checks(pkg, base, "--node", "ghost-node")
    assert _steady(checks)[-1] == (
        "crit", "node ghost-node: NodeNotFound: node ghost-node does not "
                "exist")


def test_doctor_unreachable_master_is_crit(pkg):
    rc, out = run_cli(pkg, "http://127.0.0.1:1", "--timeout", "1",
                      "doctor")
    assert rc == CLIS[pkg.name].EXIT_DOCTOR_CRIT
    assert "master unreachable" in out


def test_histogram_quantile_estimator(pkg):
    cli = CLIS[pkg.name]
    metrics = cli._parse_exposition("\n".join([
        'h_bucket{le="0.1"} 50',
        'h_bucket{le="1"} 90',
        'h_bucket{le="+Inf"} 100',
        "h_sum 40",
        "h_count 100",
    ]))
    assert cli._histogram_quantile(metrics, "h", 0.50) == pytest.approx(0.1)
    p95 = cli._histogram_quantile(metrics, "h", 0.95)
    assert 0.1 < p95 <= 1.0
    assert cli._histogram_quantile(metrics, "h", 0.999) == \
        pytest.approx(1.0)
    assert cli._histogram_quantile(metrics, "absent", 0.5) is None
    assert p95 == jax_cli._histogram_quantile(metrics, "h", 0.95)


def test_parse_exposition_labels_and_values(pkg):
    cli = CLIS[pkg.name]
    m = cli._parse_exposition("\n".join([
        "# HELP x help",
        "# TYPE x counter",
        'x{result="SUCCESS"} 3',
        'x{result="EXCEPTION"} 1',
        "y 2.5",
    ]))
    assert cli._counter_total(m, "x") == 4
    assert cli._counter_total(m, "x", result="EXCEPTION") == 1
    assert m["y"][()] == 2.5


def test_doctor_lifetime_counters_warn_not_crit(pkg, live_stack):
    """A historical exception must not page forever: lifetime totals WARN;
    only windowed (current) activity may CRIT."""
    _, base = live_stack
    reg = pkg.registry
    expected = int(reg.attach_results.value(result="EXCEPTION")
                   + reg.detach_results.value(result="EXCEPTION")) + 1
    reg.attach_results.inc(result="EXCEPTION")
    rc, out = output(pkg, base, "doctor")
    assert rc == 1, out
    assert f"{expected} worker-local" in out
    assert "lifetime" in out
    rc, out = output(pkg, base, "doctor", "--window", "0.2")
    assert rc == 0, out
    assert "exceptions: 0 worker-local" in out
    assert "in the last 0.2s" in out


def test_parse_exposition_trailing_timestamp(pkg):
    m = CLIS[pkg.name]._parse_exposition("\n".join([
        'x{result="SUCCESS"} 3 1712345678901',
        "y 2.5 1712345678901",
        "z 7",
    ]))
    assert m["x"][(("result", "SUCCESS"),)] == 3
    assert m["y"][()] == 2.5
    assert m["z"][()] == 7


MISSING = object()     # a route the stubbed target answers 404 on


def stubbed(monkeypatch, make, pkg, *argv) -> tuple[int, str]:
    """``pkg``'s CLI on a target stubbed by ``make(cli)`` (a fresh fetch
    function per run, so every run sees the same sequence), its output in
    the control plane's words; held equal to tpumounterctl's on the same
    payloads."""
    runs = []
    for p in (pkg, JAX):
        cli = CLIS[p.name]
        monkeypatch.setattr(cli, "_fetch_text", make(cli))
        monkeypatch.setattr(cli.time, "sleep", lambda s: None)
        runs.append(output(p, "http://unused", *argv))
    assert runs[0] == runs[1]
    return runs[0]


def _scrapes(metrics: list[str], healthz='{"status": "ok"}', extra=None):
    """A target answering /healthz, ``extra`` routes and then the
    ``metrics`` scrapes in turn (the last one repeats)."""
    def make(cli):
        queue = list(metrics)

        def fake_fetch(master, path, timeout):
            if path == "/healthz":
                return healthz
            if extra and path.split("?")[0] in extra:
                value = extra[path.split("?")[0]]
                if value is MISSING:
                    raise cli.TransportError(f"GET {path}: 404")
                return value
            return queue.pop(0) if len(queue) > 1 else queue[0]
        return fake_fetch
    return make


def test_doctor_window_counter_reset_falls_back_to_lifetime(pkg,
                                                            monkeypatch):
    rc, out = stubbed(monkeypatch, _scrapes([
        'tpumounter_attach_total{result="EXCEPTION"} 5\n',
        'tpumounter_attach_total{result="EXCEPTION"} 1\n']),
        pkg, "doctor", "--window", "5")
    assert rc == 1, out
    assert "counter reset" in out
    assert "-4" not in out
    assert "exceptions: 5" in out
    assert "lifetime" in out


def test_doctor_windowed_p95_diffs_histogram(pkg, monkeypatch):
    first = "\n".join([
        'tpumounter_attach_seconds_bucket{le="0.1"} 0',
        'tpumounter_attach_seconds_bucket{le="30"} 10',
        'tpumounter_attach_seconds_bucket{le="+Inf"} 10',
        "tpumounter_attach_seconds_count 10",
    ])
    second = "\n".join([
        'tpumounter_attach_seconds_bucket{le="0.1"} 2',
        'tpumounter_attach_seconds_bucket{le="30"} 12',
        'tpumounter_attach_seconds_bucket{le="+Inf"} 12',
        "tpumounter_attach_seconds_count 12",
    ])
    rc, out = stubbed(monkeypatch, _scrapes([first, second]), pkg,
                      "doctor", "--window", "5")
    assert rc == 0, out
    assert "over 2 attach(es)" in out
    assert "in the last 5s" in out
    rc, out = stubbed(monkeypatch, _scrapes([first]), pkg, "doctor")
    assert rc == 1, out
    assert "over 10 attach(es)" in out
    assert "lifetime" in out


def test_doctor_window_gauge_decrease_is_not_a_counter_reset(pkg,
                                                             monkeypatch):
    rc, out = stubbed(monkeypatch, _scrapes([
        "\n".join(['tpumounter_node_chips{state="allocated"} 4',
                   "tpumounter_attach_total 7"]),
        "\n".join(['tpumounter_node_chips{state="allocated"} 0',
                   "tpumounter_attach_total 8"])]),
        pkg, "doctor", "--window", "5")
    assert rc == 0, out
    assert "counter reset" not in out
    assert "in the last 5s" in out


def test_doctor_reports_open_circuit_as_crit(pkg, monkeypatch):
    rc, out = stubbed(monkeypatch, _scrapes(["\n".join([
        'tpumounter_circuit_state{target="10.0.0.5:1200"} 2',
        'tpumounter_circuit_state{target="10.0.0.6:1200"} 0',
        "tpumounter_retry_attempts_total 12",
    ])], extra={"/journalz": MISSING}), pkg, "doctor")
    assert rc == CLIS[pkg.name].EXIT_DOCTOR_CRIT, out
    assert "circuit OPEN for 10.0.0.5:1200" in out
    assert "retries absorbed: 12" in out


def test_doctor_reports_closed_circuits_and_journal_backlog(pkg,
                                                            monkeypatch):
    rc, out = stubbed(monkeypatch, _scrapes(
        ['tpumounter_circuit_state{target="10.0.0.5:1200"} 0\n'],
        healthz="ok",
        extra={"/journalz": json.dumps({"backlog": 2, "incomplete": [],
                                        "records": [], "replays": {}})}),
        pkg, "doctor")
    assert rc == 1, out
    assert "all 1 circuit(s) closed" in out
    assert "attach-journal backlog: 2" in out


def test_doctor_windowed_retry_activity_warns(pkg, monkeypatch):
    missing = {"/journalz": MISSING}
    rc, out = stubbed(monkeypatch, _scrapes(
        ["tpumounter_retry_attempts_total 100\n",
         "tpumounter_retry_attempts_total 104\n"], extra=missing),
        pkg, "doctor", "--window", "5")
    assert rc == 1, out
    assert "retries absorbed: 4" in out
    assert "in the last 5s" in out
    rc, out = stubbed(monkeypatch, _scrapes(
        ["tpumounter_retry_attempts_total 104\n"], extra=missing),
        pkg, "doctor")
    assert rc == 0, out
    assert "retries absorbed: 104" in out
    assert "lifetime" in out


def _informer_stack(pkg, tmp_path, **kwargs):
    return pkg.mod("testing.sim").LiveStack(pkg.rig(
        tmp_path, use_kubelet_socket=True, **kwargs))


def test_cachez_against_informer_worker(pkg, tmp_path):
    stack = _informer_stack(pkg, tmp_path, informer=True)
    try:
        worker = f"http://127.0.0.1:{stack.health_server.server_port}"
        rc, out = output(pkg, worker, "cachez")
        assert rc == 0
        assert "scope tpu-pool/*" in out
        assert "staleness" in out and "watch restart" in out
        rc, out = run_cli(pkg, worker, "--json", "cachez")
        payload = json.loads(out)
        assert payload["enabled"] is True
        assert payload["scopes"][0]["namespace"] == \
            pkg.consts.DEFAULT_POOL_NAMESPACE
        assert sorted(norm_keys(payload["scopes"][0])) == sorted(
            ["namespace", "selector", "pods", "resource_version", "seeded",
             "running", "staleness_s", "watch_restarts", "events_seen",
             "fence_rv"])
    finally:
        stack.close()


def test_cachez_against_informerless_worker(pkg, tmp_path):
    stack = _informer_stack(pkg, tmp_path)
    try:
        worker = f"http://127.0.0.1:{stack.health_server.server_port}"
        rc, out = run_cli(pkg, worker, "cachez")
        assert rc == 0
        assert "disabled" in out
    finally:
        stack.close()


def test_renew_cli_and_doctor_broker_checks(pkg, tmp_path):
    """renew extends a live lease (a typed exit for an unknown one), and
    doctor reports quota pressure: a tenant at 100% of quota WARNs."""
    config = pkg.mod("master.admission").BrokerConfig(quotas={"*": 2},
                                                      lease_ttl_s=600.0)
    stack = pkg.mod("testing.sim").LiveStack(
        pkg.rig(tmp_path, use_kubelet_socket=True), broker_config=config)
    cli = CLIS[pkg.name]
    try:
        base = stack.base
        rc, out = run_cli(pkg, base, "add", "workload", FLAG[pkg.name], "2")
        assert rc == 0 and "SUCCESS" in out
        rc, out = run_cli(pkg, base, "renew", "workload", "--ttl", "1200")
        assert rc == 0 and "lease extended" in out
        rc, out = run_cli(pkg, base, "--json", "renew", "workload")
        payload = json.loads(out)
        assert payload["result"] == "SUCCESS"
        assert payload["lease"]["renewals"] == 2
        rc, out = run_cli(pkg, base, "renew", "ghost")
        assert rc == cli.EXIT_CODES["LeaseNotFound"] == 14
        rc, out = run_cli(pkg, base, "--json", "add", "workload",
                          FLAG[pkg.name], "1")
        assert rc == cli.EXIT_CODES["QuotaExceeded"] == 13
        assert json.loads(out)["result"] == "QuotaExceeded"
        stack.gateway.broker.tick()
        rc, out = output(pkg, base, "doctor")
        assert rc == 1
        assert ">90% quota" in out
        assert "default (2/2 chips)" in out
        assert "attach queue empty" in out
    finally:
        stack.close()


def test_doctor_reports_informer_cache_health(pkg, tmp_path):
    stack = _informer_stack(pkg, tmp_path, informer=True)
    try:
        worker = f"http://127.0.0.1:{stack.health_server.server_port}"
        rc, out = run_cli(pkg, worker, "doctor")
        assert "informer cache fresh" in out
        assert rc in (0, 1)
    finally:
        stack.close()


def test_doctor_warns_on_stale_cache(pkg, monkeypatch):
    payloads = {
        "/healthz": "ok",
        "/metrics": "",
        "/cachez": json.dumps({
            "enabled": True, "hits": 5, "misses": 1, "hit_ratio": 0.83,
            "fence_timeout_s": 2.0,
            "scopes": [{"namespace": "gpu-pool", "selector": None,
                        "pods": 3, "resource_version": "9",
                        "seeded": True, "running": True,
                        "staleness_s": 600.0, "watch_restarts": 7,
                        "events_seen": 42}]}),
    }
    rc, out = stubbed(monkeypatch, lambda cli: (
        lambda master, path, timeout: payloads.get(path.split("?")[0], "")),
        pkg, "doctor")
    assert rc == 1
    assert "informer cache stale" in out and "600s" in out


def _agent_stack(pkg, tmp_path):
    return _informer_stack(pkg, tmp_path, informer=True, agent=True,
                           actuator="procroot")


def _fallbacks(pkg) -> int:
    return pkg.mod("actuation.agent")._fallback_total()


def test_agentz_against_agent_worker(pkg, tmp_path):
    stack = _agent_stack(pkg, tmp_path)
    try:
        rig = stack.rig
        out = pkg.add(rig.service, "workload", "default", 4, True,
                      request_id="agentz-test")
        assert out.result.name == "SUCCESS"
        worker = f"http://127.0.0.1:{stack.health_server.server_port}"
        rc, out = run_cli(pkg, worker, "agentz")
        assert rc == (0 if _fallbacks(pkg) == 0 else 1), out
        assert "mode=procroot" in out and "executor=alive" in out
        assert "ns fd pid" in out
        rc, out = run_cli(pkg, worker, "--json", "agentz")
        payload = json.loads(out)
        assert payload["enabled"] is True
        assert payload["counters"]["batches"] >= 1
    finally:
        stack.close()


def test_agentz_against_agentless_worker(pkg, tmp_path):
    stack = _informer_stack(pkg, tmp_path)
    try:
        worker = f"http://127.0.0.1:{stack.health_server.server_port}"
        rc, out = run_cli(pkg, worker, "agentz")
        assert rc == 0
        assert "disabled" in out
    finally:
        stack.close()


def test_agentz_flags_fallbacks(pkg, tmp_path):
    """A fallback exits non-zero with a warning: the resident path is
    degrading."""
    stack = _agent_stack(pkg, tmp_path)
    try:
        node = "/dev/nvidia9" if pkg is TORCH else "/dev/accel9"
        stack.rig.actuator.apply_device_nodes(31337, [(node, 1, 2)], [])
        worker = f"http://127.0.0.1:{stack.health_server.server_port}"
        rc, out = run_cli(pkg, worker, "agentz")
        assert rc != 0
        assert "fallback" in out and "WARNING" in out
    finally:
        stack.close()


def test_doctor_warns_on_agent_fallbacks(pkg, tmp_path):
    stack = _agent_stack(pkg, tmp_path)
    try:
        rig = stack.rig
        assert pkg.add(rig.service, "workload", "default", 4, True,
                       request_id="doctor-agent").result.name == "SUCCESS"
        worker = f"http://127.0.0.1:{stack.health_server.server_port}"
        rc, out = run_cli(pkg, worker, "doctor")
        if _fallbacks(pkg) == 0:
            assert "actuation agent healthy" in out, out
        node = "/dev/nvidia9" if pkg is TORCH else "/dev/accel9"
        rig.actuator.apply_device_nodes(31337, [(node, 1, 2)], [])
        rc, out = run_cli(pkg, worker, "doctor")
        assert "actuation agent fallbacks" in out, out
        assert rc != 0
    finally:
        stack.close()


# -- the port's own surface ----------------------------------------------------

def _parser_surface(parser, renames: bool) -> dict:
    """{subcommand: sorted option strings and positionals}, in the control
    plane's names when ``renames``."""
    sub = parser._subparsers._group_actions[0]
    out = {}
    for name, p in sub.choices.items():
        opts = []
        for action in p._actions:
            words = action.option_strings or [action.dest]
            for word in words:
                if renames:
                    word = word.replace("gpus", "tpus")
                opts.append(word)
            if action.choices and not action.option_strings:
                opts.extend(sorted(action.choices))
        out[name] = sorted(opts)
    return out


def test_parsers_have_the_same_subcommands_and_flags():
    """The 18 subcommands, and each one's flags and positionals, are
    tpumounterctl's, with ``--gpus`` for ``--tpus`` and
    ``--gpus-per-host`` for ``--tpus-per-host``."""
    port = _parser_surface(torch_cli.build_parser(), renames=True)
    assert port == _parser_surface(jax_cli.build_parser(), renames=False)
    assert sorted(port) == sorted(
        "add remove renew status node slice health fleet nodes flight "
        "cachez agentz utilz topo defrag gatez trace doctor".split())
    top = torch_cli.build_parser()
    assert top.prog == "gpumounterctl"
    args = top.parse_args(["add", "p", "--gpus", "2"])
    assert args.gpus == 2 and args.master == os.environ.get(
        "TPU_MOUNTER_MASTER", torch_cli.DEFAULT_MASTER)
    assert torch_cli.DEFAULT_MASTER == "http://127.0.0.1:8080"


def test_import_loads_neither_torch_nor_jax():
    """The CLI runs where an operator runs it: importing it, and running
    a command that fails to connect, loads no torch, no jax and nothing
    of the control plane's package."""
    code = (
        "import sys\n"
        "import gpumounter_tpu_torch.cli as cli\n"
        "rc = cli.main(['--master', 'http://127.0.0.1:1', '--timeout', "
        "'1', 'health'])\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('torch', 'jax', 'jaxlib', 'gpumounter_tpu', 'numpy')]\n"
        "print(rc, bad)\n"
        "sys.exit(0 if rc == 10 and not bad else 1)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=REPO, env=env, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_bin_wrapper_is_executable_and_names_the_port():
    path = os.path.join(REPO, "bin", "gpumounterctl")
    assert os.stat(path).st_mode & stat.S_IXUSR
    with open(path) as f:
        assert "exec python3 -m gpumounter_tpu_torch.cli" in f.read()
    proc = subprocess.run([path, "--version"], capture_output=True,
                          text=True, cwd=REPO, timeout=120,
                          env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0
    assert proc.stdout.strip() == "gpumounterctl " + \
        __import__("gpumounter_tpu_torch").__version__
    with open(os.path.join(REPO, "pyproject.toml")) as f:
        assert 'gpumounterctl = "gpumounter_tpu_torch.cli:main"' in f.read()
