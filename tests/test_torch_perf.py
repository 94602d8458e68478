"""The port's perf module against the JAX package's, on the CPU: the
configurations, the FLOP and residual arithmetic, the retry guard, the
identity-attention ablation step, and each measurement's report at a tiny
configuration."""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpumounter_tpu.jaxcheck import model as jmodel
from gpumounter_tpu.jaxcheck import perf as jperf
from gpumounter_tpu.jaxcheck import train as jtrain
from gpumounter_tpu_torch.torchcheck import convert
from gpumounter_tpu_torch.torchcheck import model as tmodel
from gpumounter_tpu_torch.torchcheck import perf as tperf
from gpumounter_tpu_torch.torchcheck import train as ttrain

# head_dim 64 (a kernel head size); T=128 is the flash path's multiple
TINY_T = tmodel.ModelConfig(vocab=64, d_model=128, n_heads=2, n_layers=2,
                            d_ff=256, dtype=torch.float32)
TINY_J = jmodel.ModelConfig(vocab=64, d_model=128, n_heads=2, n_layers=2,
                            d_ff=256)


def _fields(cfg):
    return (cfg.vocab, cfg.d_model, cfg.n_heads, cfg.n_layers, cfg.d_ff)


@pytest.mark.parametrize("name", ["mxu_config", "tuned_config"])
def test_configs_match_jax(name):
    got, want = getattr(tperf, name)(), getattr(jperf, name)()
    assert _fields(got) == _fields(want)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16


@pytest.mark.parametrize("name,batch,t_len", [
    ("mxu_config", 8, 1024), ("tuned_config", 16, 512),
    ("mxu_config", 2, 4096)])
def test_analytic_flops_match_jax_for_both_configs(name, batch, t_len):
    assert tperf.analytic_train_flops(getattr(tperf, name)(), batch, t_len) \
        == jperf.analytic_train_flops(getattr(jperf, name)(), batch, t_len)


@pytest.mark.parametrize("message,transient", [
    ("CUDA out of memory. Tried to allocate 34.00 GiB", False),
    ("NCCL error: unhandled cuda error (run with NCCL_DEBUG=INFO)", False),
    ("CUDA error: an illegal memory access was encountered", False),
    ("CUDA error: device-side assert triggered", False),
    ("CUDA error: unspecified launch failure", False),
    ("failed to map memory region", False),
    ("NCCL error: remote process exited or there was a network error",
     True),
    ("Connection reset by peer", True),
    ("[../third_party/gloo/gloo/transport/tcp/pair.cc:534] Connection "
     "closed by peer [127.0.0.1]:41215", True),
    ("Broken pipe", True),
    ("ncclRemoteError: A call failed possibly due to a network error", True),
    ("Gloo connectFullMesh failed with ...", True),
    ("shape mismatch in matmul", False),
    ("assertion failed: loss is nan", False),
])
def test_is_transient_backend_error(message, transient):
    assert tperf.is_transient_backend_error(RuntimeError(message)) is \
        transient


def test_out_of_memory_error_is_never_transient():
    err = torch.cuda.OutOfMemoryError("connection reset while allocating")
    assert not tperf.is_transient_backend_error(err)
    assert tperf._failure_label(err, 80) == "OOM"


def test_measure_with_retry_retries_only_transient_errors(monkeypatch):
    monkeypatch.setattr(tperf.time, "sleep", lambda s: None)
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise RuntimeError("NCCL error: remote process exited")
        return "ok"

    assert tperf.measure_with_retry(flaky, attempts=3) == "ok"
    assert len(calls) == 3

    calls.clear()

    def oom():
        calls.append(1)
        raise RuntimeError("CUDA out of memory. connection reset")

    with pytest.raises(RuntimeError, match="out of memory"):
        tperf.measure_with_retry(oom, attempts=3)
    assert len(calls) == 1
    with pytest.raises(ValueError, match="attempts must be >= 1"):
        tperf.measure_with_retry(lambda: 1, attempts=0)


def test_identity_attention_step_matches_jax():
    """One train step with the attention replaced by ``v`` (the roofline's
    ablation) gives JAX's loss, and the next step's, on the same
    parameters and tokens (f32, 1e-5)."""
    tokens = np.array(jtrain.make_batch(jax.random.PRNGKey(1), 2, 128,
                                        TINY_J.vocab))
    state = jtrain.init_state(jax.random.PRNGKey(0), TINY_J)
    np_params = jax.tree.map(np.asarray, state.params)
    step = jtrain.make_train_step(TINY_J, attn_impl="identity")
    want = []
    for _ in range(2):
        state, loss = step(state, jnp.asarray(tokens))
        want.append(float(loss))

    model = convert.load_jax_params(tmodel.Transformer(TINY_T, device="cpu"),
                                    np_params)
    tstate = ttrain.TrainState(model, ttrain.make_optimizer(
        model.parameters()))
    tstep = ttrain.make_train_step(TINY_T, attn_impl="identity")
    got = []
    for _ in range(2):
        tstate, loss = tstep(tstate, torch.from_numpy(tokens).long())
        got.append(float(loss))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_identity_attention_returns_v():
    attn = tmodel.make_attention(None, TINY_T, "identity")
    q, k, v = (torch.randn(1, 128, 2, 64) for _ in range(3))
    assert attn(q, k, v) is v


@pytest.fixture
def tiny(monkeypatch):
    """Both packages' full-width configurations swapped for a tiny one, and
    the port's long-context rows for short sequences."""
    monkeypatch.setattr(tperf, "mxu_config", lambda: TINY_T)
    monkeypatch.setattr(tperf, "tuned_config", lambda: TINY_T)
    monkeypatch.setattr(tperf, "LONG_CONTEXT_ROWS", ((256, 2), (384, 1)))
    monkeypatch.setattr(jperf, "mxu_config", lambda: TINY_J)
    monkeypatch.setattr(jperf, "tuned_config", lambda: TINY_J)


def test_measure_attention_kernels_on_cpu():
    r = tperf.measure_attention_kernels(seqs=(128, 256), pallas_only_seqs=(
        384,), b=1, h=2, d=64, chain=2, device="cpu")
    # the JAX report's keys (jaxcheck/perf.py measure_attention_kernels),
    # and the yardstick column
    assert {"shape", "rows", "ok"} <= set(r)
    assert [row["seq"] for row in r["rows"]] == [128, 256, 384]
    for row in r["rows"]:
        assert {"seq", "xla_ms", "pallas_ms", "sdpa_ms"} == set(row)
        assert all(isinstance(row[k], float) and row[k] > 0
                   for k in ("xla_ms", "pallas_ms", "sdpa_ms")), row
    assert "full_attention" in r["shape"]["xla_ms"]
    assert "flash_fwd" in r["shape"]["pallas_ms"]


def test_attention_rows_judge_like_jax(monkeypatch):
    """JAX's row verdict: the kernel must run; from seq 4096 on it must be
    no slower than full attention, whose OOM (measured or predicted) is a
    result; SDPA never decides."""
    def run(flash_ms):
        times = iter([5.0, flash_ms, 100.0] * 3)     # full, flash, SDPA
        monkeypatch.setattr(tperf, "_per_call_ms",
                            lambda fn, dev, reps: next(times))
        return tperf.measure_attention_kernels(
            seqs=(128, 4096), pallas_only_seqs=(8192,), b=1, h=1, d=64,
            chain=1, device="cpu")

    assert run(1.0)["ok"]
    assert not run(6.0)["ok"]       # slower than full attention at 4096


def _short_jax_windows(monkeypatch):
    """JAX's step timing with one warm-up step and windows of 1 and 2 (its
    interpret-mode kernels are slow on the CPU); its report keys are the
    same."""
    real = jperf.measure_train_perf

    def short(cfg=None, batch=8, t_len=1024, window_a=4, window_b=12,
              warmup_steps=2, attn_impl="ring"):
        return real(cfg, batch, t_len, 1, 2, 1, attn_impl)

    monkeypatch.setattr(jperf, "measure_train_perf", short)


def test_measure_both_on_cpu(tiny, monkeypatch):
    _short_jax_windows(monkeypatch)
    r = tperf.measure_both(batch=2, t_len=128, device="cpu")
    want = jperf.measure_both(batch=2, t_len=128)
    assert set(want) <= set(r)
    assert set(want["xla_attention"]) == set(r["xla_attention"])
    assert set(want["tuned"]) == set(r["tuned"])
    assert r["config"]["attn_impl"] == "flash"
    # "ok" also needs a positive two-window difference, which a tiny CPU
    # step can miss to timer noise: the losses are what must hold here
    assert r["final_loss"] < r["first_loss"]
    assert "error" not in r["xla_attention"] and "error" not in r["tuned"]
    assert r["tuned"]["config"]["batch"] == 16
    assert r["tuned"]["config"]["seq"] == 512


def test_measure_long_context_on_cpu(tiny):
    r = tperf.measure_long_context(device="cpu")
    # the JAX report's keys (jaxcheck/perf.py measure_long_context)
    assert {"config", "rows", "xla_full_attention", "ok"} <= set(r)
    assert [(row["seq"], row["batch"], row["tokens_per_step"])
            for row in r["rows"]] == [(256, 2, 512), (384, 1, 384)]
    for row in r["rows"]:
        assert {"train_step_ms", "model_tflops_per_step", "achieved_tflops",
                "mfu", "final_loss", "ok"} <= set(row["flash"])
        assert np.isfinite(row["flash"]["final_loss"])
    for full, (seq, batch) in zip(r["xla_full_attention"],
                                  ((256, 2), (384, 1))):
        # JAX's prediction: one f32 [b, h, T, T] tensor per layer
        want = TINY_J.n_layers * batch * TINY_J.n_heads * seq * seq * 4
        assert round(full["predicted_score_residuals_gib"], 1) == \
            round(want / 2**30, 1)
        assert full["predicted_score_residuals_gib"] * 2**30 == want
        # a tiny CPU step's two-window difference can fall below zero to
        # timer noise (see test_measure_both_on_cpu): it must be a number
        assert full["result"] == "ran" and np.isfinite(full["train_step_ms"])


def test_long_context_row_times_as_the_flagship(monkeypatch):
    """Every long-context row takes the flagship's timing: 2 warm-up
    steps, then windows of 4 and 12 (a departure from JAX's 1 and 2/6:
    one slow first window of 2 steps made the seq-4096 row's two-window
    difference negative on an H100)."""
    seen = {}
    flagship = inspect.signature(tperf.measure_train_perf).parameters

    def fake(cfg, **kwargs):
        seen.update(kwargs)
        return {}

    monkeypatch.setattr(tperf, "measure_train_perf", fake)
    tperf.measure_long_context_row(4096, 2, device="cpu")
    assert (seen["warmup_steps"], seen["window_a"], seen["window_b"]) == \
        (2, 4, 12)
    assert (seen["batch"], seen["t_len"], seen["attn_impl"]) == \
        (2, 4096, "flash")
    assert (flagship["warmup_steps"].default, flagship["window_a"].default,
            flagship["window_b"].default) == (2, 4, 12)


def test_long_context_full_attention_predicted_oom_and_clean_oom(
        tiny, monkeypatch):
    """Above twice the card's memory the full-attention row is skipped
    with the arithmetic; below it an out-of-memory error is a result
    ("OOM") and the flash rows still run."""
    # predicted residuals: 2 MiB at seq 256 b2, 2.25 MiB at seq 384 b1;
    # twice this "card" lies between them
    monkeypatch.setattr(tperf, "_hbm_bytes", lambda dev: 1_150_000)
    real = tperf.measure_long_context_row

    def row(t_len, batch, device="cuda", attn_impl="flash", profile=None):
        if attn_impl == "full":
            raise torch.cuda.OutOfMemoryError("CUDA out of memory.")
        return real(t_len, batch, device=device, attn_impl=attn_impl)

    monkeypatch.setattr(tperf, "measure_long_context_row", row)
    r = tperf.measure_long_context(device="cpu")
    assert all("error" not in row["flash"] for row in r["rows"])
    results = [full["result"] for full in r["xla_full_attention"]]
    assert results[0] == "OOM"
    assert results[1].startswith("OOM(predicted: ")


def test_measure_roofline_on_cpu(tiny, monkeypatch):
    _short_jax_windows(monkeypatch)
    r = tperf.measure_roofline(batch=2, t_len=128, chain=2, device="cpu")
    want = jperf.measure_roofline(batch=2, t_len=128, chain=2)
    assert set(want) <= set(r)
    # the same GEMM shapes and counts as JAX's decomposition
    assert {name: (g["mnk"], g["count"]) for name, g in r["gemms"].items()} \
        == {name: (g["mnk"], g["count"]) for name, g in want["gemms"].items()}
    assert r["optimizer_ms"] > 0 and np.isfinite(r["measured_step_ms"])
    assert r["explained_ms"] == pytest.approx(
        r["matmul_pred_ms"] + r["attention_core_ms"] + r["optimizer_ms"])
    assert r["remainder_ms"] == pytest.approx(
        r["measured_step_ms"] - r["explained_ms"])
    assert r["matmul_ceiling_mfu"] is None          # no CPU peak
