"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Set-up builds one training state of the cell's configuration from the
seed (weights made on the device, handed to the port by the program that
the configuration names, ``benchmark/programs/<program>.py``), the
program's step and a pool of token batches, and drives the state through
its first two steps on batches 0 and 1. Those steps warm every shape the
window uses, and the program's readings of them are what the reference
is held to (:mod:`benchmark.check`).

The window then enqueues steps on the same state, cycling through the
pool, until ``--seconds`` have passed on the host's clock, and
synchronises once: ``train_tokens_per_s`` is all tokens of those steps
over the whole window. With ``--trace 1`` the profiler records the first
``trace_steps`` steps of the window instead (the traffic file's number),
and the per-layer metrics are read from that stretch.

After the window the program's state is freed and the plain reference
runs the same two steps from the same weights and batches. The last
lines of standard error give each compared number beside its limit; the
last line of standard output is the result, as one JSON object.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

from benchmark import check, counts, inputs, spec  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "gpumounter_tpu")
# The steps the reference follows. Its float32 steps take 8.5 s (1.4B at
# 16384 tokens) and 5.5 s (6.9B at 8192) on an H100, so three would
# outlast the window by more than two do.
SETUP_STEPS = 2
OUT_DIR = ("build", "benchmark")


def out_dir(root: Path) -> Path:
    path = root.joinpath(*OUT_DIR)
    path.mkdir(parents=True, exist_ok=True)
    return path


def pin_caches(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the port's own kernels already build into ``build/torch_kernels``)."""
    cache = root.joinpath(*OUT_DIR, "cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)


def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _floats(value) -> list[float]:
    return [float(x) for x in (value if isinstance(value, (list, tuple))
                               else [value])]


def check_optimizer(training: dict, optimizer) -> None:
    """The reference takes AdamW's settings from the configuration; the
    port is handed only the learning rate and fixes the rest itself. A
    configuration that states other settings than the port's optimizer
    holds is refused, not compared."""
    for key in ("lr", "betas", "eps", "weight_decay"):
        stated, held = _floats(training[key]), _floats(optimizer.defaults[key])
        if stated != held:
            raise ValueError(f"the configuration states AdamW {key} "
                             f"{stated}; the port's optimizer holds {held}")


def make_params(cell: spec.Cell, seed: int, device) -> dict:
    """The seed's weights, leaf by leaf as the cell's program lays them
    out."""
    d = cell.program.dims(cell.config)
    return inputs.make_params(cell.program.groups(d), d.dtype, seed, device)


def build_program(cell: spec.Cell, seed: int, device):
    """The cell's program: its training state holding the seed's weights
    (zero moments, step 0) and its step."""
    d = cell.program.dims(cell.config)
    state, step = cell.program.build(cell.config, d,
                                     make_params(cell, seed, device), device)
    check_optimizer(cell.config["training"], state.optimizer)
    return state, step


def program_readings(cell: spec.Cell, seed: int, state, step, pool,
                     device) -> tuple[object, dict]:
    """Drive ``state`` through its first ``SETUP_STEPS`` steps (the first
    batches of the pool) and read what the comparison needs: each step's
    loss, each leaf's first gradient as AdamW holds it after step 1 (its
    first moment over 1 - beta1), and each leaf's change over the steps
    against the seed's weights, made again."""
    import torch
    beta1 = float(cell.config["training"]["betas"][0])
    named = list(state.model.named_parameters())
    losses, grads = [], None
    for i in range(SETUP_STEPS):
        state, loss = step(state, pool[i])
        losses.append(loss)
        if i == 0:
            grads = torch.stack([
                state.optimizer.state[p]["exp_avg"].float().norm()
                for _, p in named]) / (1 - beta1)
    d = cell.program.dims(cell.config)
    groups = cell.program.groups(d)
    change, made = [], {}
    for name, p in named:
        tag = inputs.group_of(groups, name)
        if tag not in made:
            made = {tag: inputs.make_group(groups, d.dtype, seed, tag,
                                           device)}
        change.append((p.detach().float() - made[tag][name].float()).norm())
    del made
    names = [n for n, _ in named]
    return state, {
        "losses": torch.stack(losses).tolist(),
        "grad_norms": dict(zip(names, grads.tolist())),
        "change_norms": dict(zip(names, torch.stack(change).tolist()))}


def reference_readings(cell: spec.Cell, seed: int, pool, device,
                       precision: str = "fp32") -> dict:
    reference = spec.reference_module(cell.config)
    params = make_params(cell, seed, device)
    return reference.train(cell.config, params,
                           [pool[i] for i in range(SETUP_STEPS)], precision)


def _window(state, step, pool, seconds: float, device, max_steps=None):
    """Enqueue steps until ``seconds`` have passed (or ``max_steps`` are
    enqueued), then synchronise. Returns (state, losses, seconds)."""
    losses = []
    t0 = time.perf_counter()
    while True:
        state, loss = step(state, pool[(SETUP_STEPS + len(losses))
                                       % pool.shape[0]])
        losses.append(loss)
        if (time.perf_counter() - t0 >= seconds
                or (max_steps is not None and len(losses) >= max_steps)):
            break
    _sync(device)
    return state, losses, time.perf_counter() - t0


def _nvidia_smi() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device, root: Path = spec.ROOT,
             t_start: float = T_START) -> tuple[dict, dict]:
    """One run of ``cell``: (the result line's object, the run's detail
    for its file under ``build/benchmark/``)."""
    import torch
    from gpumounter_tpu_torch.torchcheck import kernels

    marks = {}

    def mark(name):
        _sync(device)
        marks[name] = time.perf_counter() - t_start

    mark("imports")
    if device.type == "cuda":
        torch.cuda.init()
        torch.empty(1, device=device)
        mark("cuda_context")
        kernels.build()
        mark("kernels")
    state, step = build_program(cell, seed, device)
    mark("state")
    d = cell.program.dims(cell.config)
    pool = inputs.token_pool(cell.traffic, d.vocab, seed, device)
    mark("tokens")
    state, prog = program_readings(cell, seed, state, step, pool, device)
    mark("setup")
    setup_s = marks["setup"]

    tokens_per_step = cell.traffic["batch"] * cell.traffic["seq"]
    detail: dict = {"cell": cell.name, "seed": seed, "trace": trace,
                    "setup_marks_s": marks}
    tr = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function
        from benchmark import trace as trace_lib
        activities = [ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            with record_function(trace_lib.WINDOW):
                state, losses, window_s = _window(
                    state, step, pool, seconds, device,
                    max_steps=int(cell.traffic["trace_steps"]))
        path = out_dir(root) / f"trace.{cell.name}.json"
        prof.export_chrome_trace(str(path))
        peaks = (counts.peaks(torch.cuda.get_device_name(device),
                              cell.config["torch_dtype"])
                 if device.type == "cuda" else None)
        tr = trace_lib.load(path, len(losses), counts.checked(
            cell.program.step_counts(d, cell.traffic["batch"],
                                     cell.traffic["seq"])), peaks)
    else:
        state, losses, window_s = _window(state, step, pool, seconds, device)
    steps = len(losses)
    loss_values = torch.stack(losses).float().tolist()
    failed = sum(not math.isfinite(x) for x in loss_values + prog["losses"])
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    detail.update(window_s=window_s, steps=steps, window_losses=loss_values,
                  program=prog)

    del state, step, losses
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = reference_readings(cell, seed, pool, device)
    detail.update(reference=ref, reference_s=time.perf_counter() - t_ref)
    numbers = check.compare(prog, ref)
    correct, shown = check.verdict(numbers, cell.limits)
    correct = correct and failed == 0

    device_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                   "kind": (torch.cuda.get_device_name(device)
                            if device.type == "cuda" else "cpu"),
                   "count": cell.chips, "memory_peak_bytes": int(peak)}
    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = spec.metric_reader(m["name"], root)(tr)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info.update(busy_s=tr.busy_s(), window_s=tr.window_s)
        breakdown = tr.breakdown()
    else:
        values = {"train_tokens_per_s": steps * tokens_per_step / window_s,
                  "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    result = {"correct": bool(correct), "attempted": steps + SETUP_STEPS,
              "failed": failed, "metrics": metrics, "device": device_info}
    if trace:
        result["breakdown"] = breakdown
    result["checks"] = {n: {k: (v if math.isfinite(v) else str(v))
                            for k, v in c.items()} for n, c in shown.items()}
    detail.update(numbers=numbers, result=result)
    return result, detail


def _forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    root = spec.ROOT
    cell = spec.load_cell(args.workload, root)
    pin_caches(root)
    import torch
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell.chips:
        print(f"benchmark: cell {cell.name} needs {cell.chips} CUDA "
              f"device(s); this machine shows {found}", file=sys.stderr)
        return 3
    result, detail = run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), torch.device("cuda", 0), root)
    detail["nvidia_smi"] = _nvidia_smi()
    name = f"{cell.name}.{args.seed}.{'trace' if args.trace else 'run'}.json"
    (out_dir(root) / name).write_text(json.dumps(detail, indent=1))
    bad = _forbidden_modules()
    if bad:
        print(f"benchmark: the run loaded {bad}", file=sys.stderr)
        return 4
    print(f"card: {detail['nvidia_smi']}", file=sys.stderr)
    for n, c in result["checks"].items():
        print(f"check {n} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
