"""The port's bench (``gpumounter_tpu_torch/bench.py``) against the root
``bench.py``: the four contention, multi-master and sustained cases of
tests/test_bench_contention.py on the port's rigs, with the same shrinks
and bars; the warm-pool attach's apiserver round trips through both
packages; the summary helpers and the selftest mapping on the same
inputs; and the device rule of ``main``. CPU only."""

import dataclasses
import json
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import bench  # noqa: E402

from gpumounter_tpu_torch import bench as port_bench  # noqa: E402


def test_contention_config_measures_wakeup_not_timeout():
    out = port_bench.measure_contention(cycles=1)
    # measure_contention asserts every contender SUCCESS, no
    # queue_timeout and p50 < timeout/2; this pins the output contract
    assert out["queued_attach_samples"] >= 2
    assert 0 < out["queued_attach_wait_p50_s"] < 30.0
    assert out["preemption_e2e_p50_s"] > 0


def test_multimaster_config_scales_admission():
    """The 1.8x bar on a 2.5 s window with up to two same-run remeasures
    on a doubled window (the bar never moves), and group commit below one
    CAS per admission."""
    out = port_bench.measure_multimaster(window_s=2.5, scaling_retries=2)
    assert out["multimaster_scaling_x"] >= 1.8
    assert out["multimaster_scaling_retries"] <= 2
    assert out["multimaster_admission_cps_2"] > \
        out["multimaster_admission_cps_1"] > 0
    assert out["multimaster_store_write_rtt_s"] == \
        port_bench.MM_STORE_WRITE_RTT_S == bench.MM_STORE_WRITE_RTT_S
    assert out["multimaster_clients"] == 12
    assert out["store_cas_per_admission"] < 1.0
    assert out["multimaster_cas_per_admission_per_record"] > \
        out["store_cas_per_admission"]


def test_sustained_config_parks_the_worker_at_scale():
    """The 2k shape shrunk to 80 clients: zero errors over an 8-thread
    active budget, and the executor parked waits."""
    out = port_bench.measure_sustained(clients=80, grpc_mode="parking",
                                       grpc_workers=8,
                                       key="sustained_attach_smoke",
                                       inflight_bar=40)
    detail = out["sustained_attach_smoke"]
    assert detail["errors"] == 0
    assert detail["clients"] == 80
    assert detail["worker_active_budget"] == 8
    assert out["sustained_attach_smoke_rps"] > 0
    assert detail["worker_peak_parked"] >= 1, detail


def test_contention_config_reports_wakeup_economics():
    out = port_bench.measure_contention(cycles=1)
    assert out["wakeup_signals"] > 0
    assert 0 < out["wakeup_evaluations_per_signal"] < 20


def test_warm_pool_round_trips_equal_through_both_packages():
    """A warm-pool attach at a 0.05 s scheduler delay makes the same
    apiserver round trips per attach in both packages: two pod GETs and
    one PATCH, no LIST."""
    summaries = []
    for module in (bench, port_bench):
        attach, detach, per_attach = module.measure_attach_cycle(
            0.05, cycles=5, warm_pool=True, count_round_trips=True)
        assert len(attach) == len(detach) == len(per_attach) == 5
        summaries.append(module._round_trip_summary(per_attach))
    assert summaries[0] == summaries[1], summaries
    assert summaries[1]["total"] == 3
    assert summaries[1].get("LIST/pods", 0) == 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pct_and_round_trip_summary_agree(seed):
    rng = np.random.default_rng(seed)
    values = sorted(float(x) for x in rng.exponential(0.02, size=37))
    for q in (0.0, 0.01, 0.5, 0.9, 0.99, 1.0):
        assert port_bench._pct(values, q) == bench._pct(values, q)
    verbs = ["GET/pods", "PATCH/pods", "LIST/pods", "GET/nodes"]
    samples = [{verb: int(rng.integers(0, 3)) for verb in verbs
                if rng.random() < 0.7} for _ in range(int(rng.integers(1, 9)))]
    assert port_bench._round_trip_summary(samples) == \
        bench._round_trip_summary(samples)
    assert port_bench._round_trip_summary([]) == \
        bench._round_trip_summary([]) == {}


def test_constants_keep_their_values():
    assert (port_bench.BASELINE_P50_S, port_bench.GPUS,
            port_bench.SCHED_DELAY_S, port_bench.SUSTAINED_CLIENTS,
            port_bench.SUSTAINED_2K_CLIENTS) == (
        bench.BASELINE_P50_S, bench.CHIPS, bench.SCHED_DELAY_S,
        bench.SUSTAINED_CLIENTS, bench.SUSTAINED_2K_CLIENTS)


SELFTEST_REPORT = {
    "ok": True,
    "devices": {"backend": "cuda", "device_count": 1},
    "collectives": {"n_devices": 1, "degenerate_single_device": True,
                    "ok": True, "extra": 1},
    "training": {"step_ms": 3.5, "final_loss": 2.25, "ok": True},
    "perf": {"device_kind": "card", "config": "flagship",
             "train_step_ms": 94.0, "step_ms_incl_sync": 94.5,
             "model_tflops_per_step": 50.0, "achieved_tflops": 530.0,
             "peak_bf16_tflops": 989.0, "mfu": 0.54, "tuned": {},
             "ok": True, "unmapped": 0},
    "pallas_parity": {"err_pallas_vs_oracle": 1e-6, "ok": True},
    "attention_kernels": {"rows": [{"seq": 1024}], "ok": True},
    "long_context": {"rows": [], "ok": True},
    "roofline": {"measured_step_ms": 95.0, "gemms": [], "ok": True},
    "drain_cycle": {"abs_err": 0.0, "drain_restore_s": 1.0, "ok": True},
    "backend_reinit": {"reinit_s": 0.5, "ok": True},
}


def test_selftest_mapping_matches_the_control_planes(monkeypatch):
    """The same selftest report maps to the same summary in both packages,
    and the compact line keeps the same keys."""
    from gpumounter_tpu.jaxcheck import tpu_selftest
    from gpumounter_tpu_torch.torchcheck import gpu_selftest

    monkeypatch.setattr(tpu_selftest, "run_in_subprocess",
                        lambda *a, **k: (0, SELFTEST_REPORT, None))
    monkeypatch.setattr(gpu_selftest, "run_in_subprocess",
                        lambda *a, **k: (0, SELFTEST_REPORT, None))
    gpu = port_bench.gpu_metrics()
    assert gpu == bench.tpu_metrics()
    assert port_bench._compact_gpu(gpu) == bench._compact_tpu(gpu)


@pytest.mark.parametrize("child", [
    (3, None, None), (None, None, "selftest timed out after 1100.0s"),
    (1, dict(SELFTEST_REPORT, ok=False), None)])
def test_gpu_metrics_never_reports_an_absent_or_failed_child_as_ok(
        monkeypatch, child):
    """Where the root bench reads a child without a device as no hardware
    (None), the port reads it as a failure: on a card nothing falls
    back."""
    from gpumounter_tpu_torch.torchcheck import gpu_selftest

    monkeypatch.setattr(gpu_selftest, "run_in_subprocess",
                        lambda *a, **k: child)
    gpu = port_bench.gpu_metrics()
    assert gpu["ok"] is False
    if child[1] is None:
        assert gpu["error"]


def _no_stack(*args, **kwargs):
    raise AssertionError("a stack was built")


def test_main_without_a_gpu_raises_before_a_stack_is_built(monkeypatch):
    import torch

    from gpumounter_tpu_torch.testing import sim

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sim, "WorkerRig", _no_stack)
    monkeypatch.setattr(port_bench, "run_control_plane", _no_stack)
    for argv in ([], ["--device", "cuda"]):
        with pytest.raises(RuntimeError, match="--device cpu"):
            port_bench.main(argv)


def _small_run(sizes=port_bench.Sizes(), result=None):
    result = {} if result is None else result
    result.update(metric="hot_attach_e2e_p50_latency_4gpu_entire_mount",
                  value=1.01, overhead_p50_s=0.005,
                  overhead_p50_parking_s=0.005)
    return result, {"events_on": 0.005, "events_off": 0.005,
                    "usage_off": 0.005, "topo_off": 0.005,
                    "parking": 0.005}


def test_main_on_the_cpu_skips_the_gpu_part_and_says_so(
        monkeypatch, tmp_path, capsys):
    import torch

    detail = tmp_path / "build" / "bench" / "BENCH_DETAIL.json"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(port_bench, "DETAIL_PATH", str(detail))
    monkeypatch.setattr(port_bench, "run_control_plane", _small_run)
    monkeypatch.setattr(port_bench, "gpu_metrics", _no_stack)
    assert port_bench.main(["--device", "cpu"]) == 0
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["gpu"] == {"skipped": "device=cpu"}
    assert json.loads(detail.read_text())["gpu"] == {"skipped": "device=cpu"}


def test_main_on_a_card_exits_non_zero_when_the_selftest_fails(
        monkeypatch, tmp_path, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(port_bench, "DETAIL_PATH",
                        str(tmp_path / "BENCH_DETAIL.json"))
    monkeypatch.setattr(port_bench, "run_control_plane", _small_run)
    monkeypatch.setattr(port_bench, "gpu_metrics",
                        lambda: {"ok": False, "error": "no CUDA device"})
    with pytest.raises(RuntimeError, match="selftest failed"):
        port_bench.main([])
    assert capsys.readouterr().out == ""
    assert json.loads((tmp_path / "BENCH_DETAIL.json").read_text())[
        "gpu"]["ok"] is False


def test_main_on_a_card_reads_the_card_after_a_failed_bar_then_fails(
        monkeypatch, tmp_path, capsys):
    import torch

    def failing_run(sizes=port_bench.Sizes(), result=None):
        result.update(overhead_p50_s=0.005)
        raise AssertionError("1134 of 2000 sustained attaches failed")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(port_bench, "DETAIL_PATH",
                        str(tmp_path / "BENCH_DETAIL.json"))
    monkeypatch.setattr(port_bench, "run_control_plane", failing_run)
    monkeypatch.setattr(port_bench, "gpu_metrics",
                        lambda: {"ok": True, "device_count": 1})
    with pytest.raises(AssertionError, match="1134 of 2000"):
        port_bench.main([])
    assert capsys.readouterr().out == ""
    detail = json.loads((tmp_path / "BENCH_DETAIL.json").read_text())
    assert detail["gpu"] == {"ok": True, "device_count": 1}
    assert detail["overhead_p50_s"] == 0.005
    assert detail["error"].startswith("AssertionError: 1134 of 2000")


@pytest.mark.parametrize("p50s, held", [
    ({"events_on": 0.010, "events_off": 0.0054, "usage_off": 0.0054,
      "topo_off": 0.0054, "parking": 0.0169}, True),
    ({"events_on": 0.010, "events_off": 0.0054, "usage_off": 0.0054,
      "topo_off": 0.0054, "parking": 0.0171}, False),
    ({"events_on": 0.010, "events_off": 0.0054, "usage_off": 0.0052,
      "topo_off": 0.0054, "parking": 0.010}, False)])
def test_bars_hold_where_the_root_bench_asserts_hold(p50s, held):
    """The A/B bars at the edges of 1.5x + 2 ms."""
    result = {"overhead_p50_s": 0.009, "overhead_p50_parking_s": 0.009}
    assert all(ok for _, ok, _ in port_bench.bars(result, p50s)) is held


@pytest.mark.parametrize("field", [
    f.name for f in dataclasses.fields(port_bench.Sizes)])
def test_sizes_refuse_zero_where_a_bar_or_p50_reads_it(field):
    if field in ("single", "multi", "sustained_2k"):
        assert getattr(port_bench.Sizes(**{field: 0}), field) == 0
    else:
        with pytest.raises(ValueError, match=f"Sizes.{field} = 0"):
            port_bench.Sizes(**{field: 0})


def test_a_measured_stack_is_closed_before_the_function_returns():
    """Each configuration closes its stack inline: no thread of it (the
    informer's watch, the gRPC executors, the sampler) outlives the call.
    The worker's audit-event thread leaves by itself after 60 s idle."""
    def threads():
        return {t.ident: t.name for t in threading.enumerate()
                if t.name != "tpumounter-events"}

    before = threads()
    port_bench.measure_attach_cycle(0.0, cycles=2)
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline:
        left = {i: n for i, n in threads().items() if i not in before}
        if not left:
            break
        time.sleep(0.05)
    assert not left, sorted(left.values())
