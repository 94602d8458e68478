"""The port's real-GPU selftest (counterpart of tests/test_tpu_hardware.py).

Without a CUDA device the selftest exits 3 and callers skip; here that is
checked directly. The ``gpu``-marked tests run the whole selftest once in a
subprocess on the card (``python -m pytest tests/test_torch_selftest.py -m
gpu``) and check its nine sections. This file imports no jax: the machine
with the card has none."""

import json

import pytest

from gpumounter_tpu_torch.torchcheck import gpu_selftest


def test_run_in_subprocess_without_a_gpu_exits_3():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    assert gpu_selftest.run_in_subprocess(timeout=300) == (
        gpu_selftest.EXIT_NO_GPU, None, None)


def test_main_prints_one_skip_line_without_a_gpu(monkeypatch, capsys):
    monkeypatch.setattr(gpu_selftest, "_gpu_available", lambda: False)
    assert gpu_selftest.main([]) == gpu_selftest.EXIT_NO_GPU
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    assert json.loads(lines[0]) == {"ok": False, "skip": "no CUDA device"}


def test_run_selftest_reports_every_check_and_its_seconds(monkeypatch):
    """A check that raises is reported not ok with its error, the others
    still run, and the verdict is the conjunction of all nine."""
    import torch
    calls = []

    def ok(name):
        def run():
            calls.append(name)
            if name == "roofline":
                raise RuntimeError("boom")
            return {"ok": True}
        return run

    monkeypatch.setattr(gpu_selftest, "_checks", lambda n: {
        name: ok(name) for name in gpu_selftest.CHECKS})
    monkeypatch.setattr("gpumounter_tpu_torch.torchcheck.probe."
                        "device_summary", lambda device: {"backend": device})
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    report = gpu_selftest.run_selftest()
    assert calls == list(gpu_selftest.CHECKS)
    assert report["roofline"]["ok"] is False
    assert "boom" in report["roofline"]["error"]
    assert all(report[n]["seconds"] >= 0 for n in gpu_selftest.CHECKS)
    assert report["ok"] is False


@pytest.fixture(scope="module")
def selftest_report():
    rc, report, error = gpu_selftest.run_in_subprocess()
    if rc == gpu_selftest.EXIT_NO_GPU:
        pytest.skip("no CUDA device on this host")
    assert report is not None, error
    return report


@pytest.mark.gpu
def test_gpu_backend_enumerates(selftest_report):
    dev = selftest_report["devices"]
    assert dev["backend"] == "cuda"
    assert dev["device_count"] >= 1


@pytest.mark.gpu
def test_gpu_collectives(selftest_report):
    assert selftest_report["collectives"]["ok"], selftest_report["collectives"]


@pytest.mark.gpu
def test_gpu_training_loss_decreases(selftest_report):
    tr = selftest_report["training"]
    assert tr["ok"], tr
    assert tr["final_loss"] < tr["first_loss"]
    assert tr["step_ms"] > 0


@pytest.mark.gpu
def test_gpu_mfu_is_reported_and_plausible(selftest_report):
    """The full-width bf16 step: an analytic FLOP count, a net step time
    and an MFU in (0.2, 1] against the card's published peak; the tuned
    configuration and the full-attention entry ran."""
    perf = selftest_report["perf"]
    assert perf["ok"], perf
    assert perf["config"]["dtype"] == "bfloat16"
    assert perf["config"]["attn_impl"] == "flash"
    assert perf["model_tflops_per_step"] > 1.0
    assert perf["train_step_ms"] > 0
    if perf["peak_bf16_tflops"] is not None:
        assert 0.2 < perf["mfu"] <= 1.0, perf
        assert perf["tuned"]["ok"], perf
        assert 0.2 < perf["tuned"]["mfu"] <= 1.0, perf
    assert perf["xla_attention"]["ok"], perf


@pytest.mark.gpu
def test_gpu_kernel_parity_against_float64(selftest_report):
    pp = selftest_report["pallas_parity"]
    assert pp["ok"], pp
    assert pp["err_pallas_vs_oracle"] < pp["tol"]
    assert pp["err_pallas_vs_einsum"] < pp["tol"]


@pytest.mark.gpu
def test_gpu_backend_reinit_cycles(selftest_report):
    """NCCL teardown and re-init in one process, repeatedly, with compute
    after each cycle; nothing is re-enumerated (CUDA fixes the device set
    per process)."""
    br = selftest_report["backend_reinit"]
    assert br["ok"], br
    assert br["devices_before"] == br["devices_after"]
    assert br["devices_reenumerated"] is False
    assert br["compute_ok"]
    assert br["cycles"] >= 5, br


@pytest.mark.gpu
def test_gpu_long_context_training(selftest_report):
    """Training at seq 4096, 8192 and 16384 runs through the flash
    kernels; full attention at those lengths ran (and was slower) or ran
    out of memory, measured or predicted."""
    lc = selftest_report["long_context"]
    assert lc["ok"], lc
    by_seq = {r["seq"]: r for r in lc["rows"]}
    for seq in (4096, 8192, 16384):
        fl = by_seq[seq]["flash"]
        assert fl["ok"], fl
        assert fl["train_step_ms"] > 0
        assert 0 < fl["mfu"] <= 1.0
    full = {r["seq"]: r for r in lc["xla_full_attention"]}
    for seq in (4096, 8192, 16384):
        res = full[seq]["result"]
        assert res == "ran" or str(res).startswith("OOM"), full[seq]
        if res == "ran":
            assert (by_seq[seq]["flash"]["train_step_ms"]
                    < full[seq]["train_step_ms"]), (by_seq[seq], full[seq])


@pytest.mark.gpu
def test_gpu_roofline_explains_step_time(selftest_report):
    """The flagship step's decomposition exists for every GEMM shape, and
    the GEMMs are most of the step."""
    rf = selftest_report["roofline"]
    assert rf["ok"], rf
    assert set(rf["gemms"]) == {"qkv_proj", "out_proj", "mlp_in",
                                "mlp_out", "lm_head"}, rf
    assert rf["matmul_pred_ms"] >= 0.5 * rf["measured_step_ms"], rf
    assert rf["attention_core_ms"] >= 0 and rf["optimizer_ms"] > 0
    if rf["matmul_ceiling_mfu"] is not None:
        assert 0.3 < rf["matmul_ceiling_mfu"] <= 1.0, rf


@pytest.mark.gpu
def test_gpu_drain_cycle_loss_continuity(selftest_report):
    dc = selftest_report["drain_cycle"]
    assert dc["ok"], dc
    assert dc["abs_err"] < 1e-3
    assert dc["drain_restore_s"] > 0


@pytest.mark.gpu
def test_gpu_flash_kernel_wins_at_long_sequence(selftest_report):
    """The flash kernel is no slower than full attention from seq 4096 on
    and runs seq 8192 and 16384, where full attention may not fit."""
    ak = selftest_report["attention_kernels"]
    assert ak["ok"], ak
    by_seq = {r["seq"]: r for r in ak["rows"]}
    for seq in (4096, 8192, 16384):
        assert isinstance(by_seq[seq]["pallas_ms"], float), by_seq[seq]
        full = by_seq[seq]["xla_ms"]
        if isinstance(full, float):
            assert by_seq[seq]["pallas_ms"] <= full
        else:
            assert str(full).startswith("OOM")
