"""Real-GPU self-test: hardware evidence for the PyTorch harness.

Counterpart of :mod:`gpumounter_tpu.jaxcheck.tpu_selftest`, with the same
check names and the same one JSON line. On the CUDA device it proves:

1. **collectives**: all-reduce and ring send/recv over one process per GPU
   (NCCL) give exact integer results (degenerate on one GPU);
2. **training**: the toy model trains with finite, decreasing loss, and a
   steady-state step time (``probe.validate_training(timed_steps=16)``);
3. **perf**: the full-width bf16 step on the flash kernels, the same step
   on full attention, and the tuned configuration (``perf.measure_both``);
4. **pallas_parity** (the key is kept for readers of the report): the CUDA
   flash kernel against the port's full attention and a float64 oracle,
   f32 at b2 t256 h4 d128;
5. **attention_kernels**: the flash kernel against full attention per
   sequence length, SDPA beside them (``perf.measure_attention_kernels``);
6. **long_context**: training at seq 4096, 8192 and 16384 on the flash
   kernels, and full attention's verdict at each
   (``perf.measure_long_context``);
7. **roofline**: the flagship step's split into GEMMs, attention core,
   optimizer and remainder (``perf.measure_roofline``);
8. **drain_cycle**: the toy state drained, the NCCL world of one torn down
   and joined again in this process, restored, and the next loss equal to
   the uninterrupted one within 1e-3;
9. **backend_reinit**: that NCCL teardown and re-init, repeated, with a
   compute check after each cycle. CUDA fixes a process's device set at its
   first CUDA call, so unlike the JAX check nothing is re-enumerated
   (``"devices_reenumerated": false``).

Each check reports its ``seconds``. Run it as a subprocess
(:func:`run_in_subprocess`), so that its CUDA context and memory are its
own.

CLI: ``python -m gpumounter_tpu_torch.torchcheck.gpu_selftest [--steps N]``
prints one JSON line. Exit 0 = all ok, 1 = a check failed, 3 = no CUDA
device (callers skip).
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Any, Callable

import numpy as np
import torch

EXIT_OK = 0
EXIT_FAIL = 1
EXIT_NO_GPU = 3

CHECKS = ("collectives", "training", "perf", "pallas_parity",
          "attention_kernels", "long_context", "roofline", "drain_cycle",
          "backend_reinit")


def run_in_subprocess(timeout: float = 1100.0
                      ) -> tuple[int | None, dict | None, str | None]:
    """Run this selftest in a child process with the repository on
    ``PYTHONPATH``. Returns ``(returncode, report_or_none, error_or_none)``:

    - ``(EXIT_NO_GPU, None, None)``: no CUDA device (skip);
    - ``(0 or 1, report, None)``: the selftest ran;
    - ``(None or other, None, reason)``: timeout, crash or bad output."""
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = (repo + os.pathsep + env["PYTHONPATH"]
                         if env.get("PYTHONPATH") else repo)
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "gpumounter_tpu_torch.torchcheck.gpu_selftest"],
            capture_output=True, text=True, env=env, cwd=repo,
            timeout=timeout)
    except subprocess.TimeoutExpired:
        return None, None, f"selftest timed out after {timeout}s"
    except OSError as e:
        return None, None, f"selftest failed to launch: {e!r}"
    if proc.returncode == EXIT_NO_GPU:
        return EXIT_NO_GPU, None, None
    if not proc.stdout.strip():
        return proc.returncode, None, (
            f"selftest rc={proc.returncode}, no output; "
            f"stderr tail: {proc.stderr[-400:]!r}")
    try:
        report = json.loads(proc.stdout.strip().splitlines()[-1])
    except json.JSONDecodeError:
        return proc.returncode, None, (
            f"selftest rc={proc.returncode}, unparseable output: "
            f"{proc.stdout[-400:]!r}")
    return proc.returncode, report, None


def _gpu_available() -> bool:
    return torch.cuda.is_available() and torch.cuda.device_count() >= 1


def check_training(n_steps: int = 8) -> dict[str, Any]:
    """The toy model on the card; the loss trajectory and the steady-state
    step time come from the probe. A smoke configuration (is compute
    real?); the perf claim is the ``perf`` check."""
    from gpumounter_tpu_torch.torchcheck import probe
    report = probe.validate_training(n_steps=n_steps, device="cuda",
                                     timed_steps=16)
    report["config"] = "toy-smoke (not a perf claim; see 'perf')"
    return report


def check_perf() -> dict[str, Any]:
    from gpumounter_tpu_torch.torchcheck import perf
    return perf.measure_both(device="cuda")


def check_pallas_parity(b: int = 2, t: int = 256, h: int = 4,
                        d: int = 128) -> dict[str, Any]:
    """The flash kernel (f32 instance, through ``flash_attention``) against
    the port's full attention and a float64 oracle computed on the host,
    with TF32 off. Tolerance 2e-3, the JAX check's."""
    from gpumounter_tpu_torch.torchcheck.flash_attention import \
        flash_attention
    from gpumounter_tpu_torch.torchcheck.ring_attention import full_attention

    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((b, t, h, d), np.float32)
               for _ in range(3))
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64),
                  k.astype(np.float64)) / np.sqrt(d)
    s = np.where(np.tril(np.ones((t, t), bool))[None, None], s, -np.inf)
    p = np.exp(s - s.max(axis=-1, keepdims=True))
    p /= p.sum(axis=-1, keepdims=True)
    oracle = np.einsum("bhqk,bkhd->bqhd", p, v.astype(np.float64))

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        qc, kc, vc = (torch.from_numpy(x).cuda() for x in (q, k, v))
        with torch.no_grad():
            ref = full_attention(qc, kc, vc).double().cpu().numpy()
            out = flash_attention(qc, kc, vc).double().cpu().numpy()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    err_kernel = float(np.abs(out - oracle).max())
    err_ref = float(np.abs(ref - oracle).max())
    err_cross = float(np.abs(out - ref).max())
    tol = 2e-3
    return {"err_pallas_vs_oracle": err_kernel,
            "err_einsum_vs_oracle": err_ref,
            "err_pallas_vs_einsum": err_cross,
            "kernel": "flash_fwd (f32) through flash_attention",
            "tol": tol, "shape": [b, t, h, d],
            "ok": bool(max(err_kernel, err_ref, err_cross) < tol)}


def check_attention_kernels() -> dict[str, Any]:
    from gpumounter_tpu_torch.torchcheck import perf
    return perf.measure_attention_kernels(device="cuda")


def check_long_context() -> dict[str, Any]:
    from gpumounter_tpu_torch.torchcheck import perf
    return perf.measure_long_context(device="cuda")


def check_roofline() -> dict[str, Any]:
    from gpumounter_tpu_torch.torchcheck import perf
    return perf.measure_roofline(device="cuda")


def _join_world_of_one(device: torch.device) -> None:
    from gpumounter_tpu_torch.torchcheck import federation, probe
    probe.initialize_distributed(f"127.0.0.1:{federation.free_port()}", 1, 0,
                                 device)


def check_drain_cycle() -> dict[str, Any]:
    """Drain, then the detach/reattach window (the NCCL world of one left
    and joined again in this process), then restore: the next step's loss
    must equal the uninterrupted run's within 1e-3 (the step is
    deterministic given state and tokens)."""
    from gpumounter_tpu_torch.torchcheck import drain as drain_lib
    from gpumounter_tpu_torch.torchcheck import elastic, probe
    from gpumounter_tpu_torch.torchcheck import train as train_lib
    from gpumounter_tpu_torch.torchcheck.model import ModelConfig

    device = torch.device("cuda", torch.cuda.current_device())
    cfg = ModelConfig()         # toy: this tests the cycle, not perf
    _join_world_of_one(device)
    try:
        state = train_lib.init_state(cfg, seed=0, device=device)
        step = train_lib.make_train_step(cfg)
        tokens = train_lib.make_batch(torch.Generator(device).manual_seed(1),
                                      4, 64, cfg.vocab)
        for _ in range(3):
            state, _ = step(state, tokens)
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "drain.ckpt")
            t0 = time.perf_counter()
            drain_lib.drain(train_lib.state_tree(state), path)
            drain_s = time.perf_counter() - t0
            _, ref_loss = step(state, tokens)      # the uninterrupted step
            ref_loss = float(ref_loss)
            del state
            t0 = time.perf_counter()
            probe.shutdown_distributed()           # the detach window
            _join_world_of_one(device)
            tree = drain_lib.restore(path, elastic.state_specs(cfg),
                                     device=device)
            state = train_lib.state_from_tree(cfg, tree, device)
            drain_restore_s = drain_s + time.perf_counter() - t0
        _, loss = train_lib.make_train_step(cfg)(state, tokens)
        resumed_loss = float(loss)
    finally:
        probe.shutdown_distributed()
    err = abs(resumed_loss - ref_loss)
    return {"ref_loss": ref_loss, "resumed_loss": resumed_loss,
            "abs_err": err, "drain_restore_s": drain_restore_s,
            "ok": bool(np.isfinite(resumed_loss) and err < 1e-3)}


def check_backend_reinit(cycles: int = 5) -> dict[str, Any]:
    """The NCCL world of one left and joined again ``cycles`` times in this
    process (``probe.shutdown_distributed`` / ``initialize_distributed``),
    each cycle followed by an all-reduce and a sum on the card. The device
    count is read before and after; CUDA does not re-enumerate in a live
    process, so the report says ``devices_reenumerated: false``."""
    import torch.distributed as dist

    from gpumounter_tpu_torch.torchcheck import probe

    device = torch.device("cuda", torch.cuda.current_device())
    before = torch.cuda.device_count()
    times: list[float] = []
    compute_ok = True
    _join_world_of_one(device)
    try:
        for _ in range(cycles):
            t0 = time.perf_counter()
            probe.shutdown_distributed()
            _join_world_of_one(device)
            x = torch.arange(128.0, device=device)
            dist.all_reduce(x)
            y = float((x ** 2).sum())
            times.append(time.perf_counter() - t0)
            compute_ok = compute_ok and abs(y - 127 * 128 * 255 / 6.0) < 1e-3
            if not compute_ok:
                break
        backend = dist.get_backend()
    finally:
        probe.shutdown_distributed()
    after = torch.cuda.device_count()
    return {"devices_before": before, "devices_after": after,
            "devices_reenumerated": False, "backend": backend,
            "cycles": len(times), "reinit_s": times[0] if times else None,
            "reinit_s_per_cycle": times, "compute_ok": bool(compute_ok),
            "ok": bool(before == after and compute_ok
                       and len(times) == cycles)}


def _checks(n_steps: int) -> dict[str, Callable[[], dict[str, Any]]]:
    from gpumounter_tpu_torch.torchcheck import probe
    return {"collectives": lambda: probe.validate_collectives(device="cuda"),
            "training": lambda: check_training(n_steps),
            "perf": check_perf,
            "pallas_parity": check_pallas_parity,
            "attention_kernels": check_attention_kernels,
            "long_context": check_long_context,
            "roofline": check_roofline,
            "drain_cycle": check_drain_cycle,
            "backend_reinit": check_backend_reinit}


def run_selftest(n_steps: int = 8) -> dict[str, Any]:
    """Every check in order, each reported with its seconds; a check that
    raises is reported not ok with the error, and the rest still run."""
    from gpumounter_tpu_torch.torchcheck import probe

    report: dict[str, Any] = {"devices": probe.device_summary("cuda")}
    for name, fn in _checks(n_steps).items():
        t0 = time.perf_counter()
        try:
            report[name] = fn()
        except Exception as e:
            report[name] = {"ok": False, "error": repr(e)[:2000]}
        report[name]["seconds"] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
    report["ok"] = all(report[k]["ok"] for k in CHECKS)
    return report


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description="real-GPU selftest")
    parser.add_argument("--steps", type=int, default=8)
    args = parser.parse_args(argv)
    if not _gpu_available():
        print(json.dumps({"ok": False, "skip": "no CUDA device"}))
        return EXIT_NO_GPU
    report = run_selftest(args.steps)
    print(json.dumps(report))
    return EXIT_OK if report["ok"] else EXIT_FAIL


if __name__ == "__main__":
    sys.exit(main())
