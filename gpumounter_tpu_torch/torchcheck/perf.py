"""GPU-level performance measurement: step time, analytic FLOPs, MFU.

Counterpart of the parts of :mod:`gpumounter_tpu.jaxcheck.perf` that the
flagship train step needs: the analytic FLOP count, the published peak of
the card, the full-width configuration, the two-window step timing and the
first long-context row. Every number this module reports comes from the
run that calls it, on the device it names; the JAX module's tables were
measured on a TPU and are no target here.
"""

from __future__ import annotations

import time
from typing import Any, Callable

import numpy as np
import torch

from gpumounter_tpu_torch.torchcheck import resolve_device
from gpumounter_tpu_torch.torchcheck.model import ModelConfig

# Published dense bf16 tensor-core peak (TFLOP/s) and HBM rate (TB/s) of
# the cards the port has run on, keyed by a substring of the device name
# (matched case-insensitively). Source: NVIDIA H100 data sheet, SXM5.
GPU_PEAKS: dict[str, tuple[float, float]] = {
    "h100 80gb hbm3": (989.0, 3.35),
}


def _peaks(device_name: str) -> tuple[float, float] | None:
    name = device_name.lower()
    return next((p for needle, p in GPU_PEAKS.items() if needle in name),
                None)


def chip_peak_tflops(device_name: str) -> float | None:
    """Published bf16 peak for this card, or None when unknown (MFU is then
    unreportable — better absent than made up)."""
    peaks = _peaks(device_name)
    return peaks[0] if peaks else None


def chip_hbm_tb_per_s(device_name: str) -> float | None:
    """Published HBM rate for this card, or None when unknown."""
    peaks = _peaks(device_name)
    return peaks[1] if peaks else None


def analytic_train_flops(cfg, batch: int, t_len: int) -> float:
    """Matmul FLOPs one optimizer step executes for this model, counted
    analytically (2*M*N*K per matmul; fwd + backward = 3x fwd, the standard
    dense-transformer accounting).

    Per token per layer (d = d_model, f = d_ff, T = seq len):
    - QKV projection  d -> 3d          : 6 d^2
    - attention scores QK^T            : 2 d T   (full T x T, causal masked)
    - attention apply  PV              : 2 d T
    - output projection                : 2 d^2
    - MLP d -> f -> d                  : 4 d f
    Plus the LM head (d -> vocab): 2 d V per token. Elementwise work
    (norms, gelu, softmax, adam) is excluded.
    """
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab
    per_token_layer = 8 * d * d + 4 * d * f + 4 * d * t_len
    fwd_per_token = cfg.n_layers * per_token_layer + 2 * d * v
    return 3.0 * fwd_per_token * batch * t_len


def mxu_config() -> ModelConfig:
    """The full-width bf16 configuration: d_model 4096, 32 heads of 128,
    4 layers, 4x MLP, ~0.8B parameters — trained at batch 8 x seq 1024."""
    return ModelConfig(vocab=256, d_model=4096, n_heads=32, n_layers=4,
                       d_ff=16384, dtype=torch.bfloat16)


def measure_train_perf(cfg: ModelConfig | None = None, batch: int = 8,
                       t_len: int = 1024, window_a: int = 4,
                       window_b: int = 12, warmup_steps: int = 2,
                       attn_impl: str = "ring",
                       device: str = "cuda",
                       profile: Callable[..., dict] | None = None
                       ) -> dict[str, Any]:
    """Time the single-device train step and report {train_step_ms,
    model_tflops_per_step, achieved_tflops, mfu, losses, ...}.

    Timing: the host clock around windows of ``window_a`` and ``window_b``
    steps, each ended by ``torch.cuda.synchronize()``; the per-step time is
    the two-window difference ``(t_B - t_A) / (window_b - window_a)``, which
    cancels the constant per-window cost. ``step_ms_incl_sync`` keeps the
    uncorrected figure.

    ``profile``, when given, is called once after the timed windows as
    ``profile(step, state, tokens, train_step_ms)`` on the same step and
    state; what it returns is reported under ``"profile"``."""
    from gpumounter_tpu_torch.torchcheck import train as train_lib

    dev = resolve_device(device)
    cfg = cfg or mxu_config()
    on_gpu = dev.type == "cuda"

    def sync() -> None:
        if on_gpu:
            torch.cuda.synchronize(dev)

    if on_gpu:
        torch.cuda.reset_peak_memory_stats(dev)
    state = train_lib.init_state(cfg, seed=0, device=dev)
    step = train_lib.make_train_step(cfg, attn_impl=attn_impl)
    tokens = train_lib.make_batch(torch.Generator(dev).manual_seed(1), batch,
                                  t_len, cfg.vocab)
    losses = []
    t0 = time.perf_counter()
    for _ in range(max(warmup_steps, 1)):
        state, loss = step(state, tokens)
        losses.append(loss)
    sync()
    warmup_s = time.perf_counter() - t0

    windows: dict[int, float] = {}
    for n in (window_a, window_b):
        t0 = time.perf_counter()
        for _ in range(n):
            state, loss = step(state, tokens)
            losses.append(loss)
        sync()
        windows[n] = time.perf_counter() - t0
    losses = [float(x) for x in losses]

    step_s = (windows[window_b] - windows[window_a]) / (window_b - window_a)
    flops = analytic_train_flops(cfg, batch, t_len)
    achieved_tflops = flops / step_s / 1e12
    name = torch.cuda.get_device_name(dev) if on_gpu else "cpu"
    peak = chip_peak_tflops(name)
    report = {
        "config": {"d_model": cfg.d_model, "n_layers": cfg.n_layers,
                   "n_heads": cfg.n_heads, "d_ff": cfg.d_ff,
                   "dtype": str(cfg.dtype).replace("torch.", ""),
                   "batch": batch, "seq": t_len, "attn_impl": attn_impl},
        "device_kind": name,
        "timed_steps": window_a + window_b,
        "warmup_s": warmup_s,
        "train_step_ms": step_s * 1e3,
        "step_ms_incl_sync": windows[window_b] / window_b * 1e3,
        "model_tflops_per_step": flops / 1e12,
        "achieved_tflops": achieved_tflops,
        "peak_bf16_tflops": peak,
        "mfu": achieved_tflops / peak if peak else None,
        "first_loss": losses[0],
        "final_loss": losses[-1],
        "max_memory_allocated_bytes": (torch.cuda.max_memory_allocated(dev)
                                       if on_gpu else None),
        "ok": bool(np.isfinite(losses).all() and losses[-1] < losses[0]
                   and step_s > 0),
    }
    if profile is not None:
        report["profile"] = profile(step, state, tokens, step_s * 1e3)
    return report


def measure_long_context(device: str = "cuda",
                         profile: Callable[..., dict] | None = None
                         ) -> dict[str, Any]:
    """Long-sequence training on the full-width model through the flash
    kernels: the seq 4096 x batch 2 row (8192 tokens per step, as the
    flagship's 8 x 1024), where the forward takes its K-blocked contract.
    ``profile`` as in :func:`measure_train_perf`."""
    cfg = mxu_config()
    r = measure_train_perf(cfg, batch=2, t_len=4096, attn_impl="flash",
                           window_a=2, window_b=6, warmup_steps=1,
                           device=device, profile=profile)
    return {"config": r["config"], "rows": [
        {"seq": 4096, "batch": 2, "tokens_per_step": 8192, "flash": r}],
        "ok": r["ok"]}
