"""In-pod post-attach probe, on PyTorch.

Counterpart of :mod:`gpumounter_tpu.jaxcheck.probe`. After an attach the
workload Pod must (1) see the GPUs — ``torch.cuda.device_count() ==
expected`` — and (2) be able to run real compute on them: an exact-integer
all-reduce and a ring send/recv over one process per device (NCCL on GPUs,
gloo with ``--cpu-devices``), then the toy flagship model training with
finite, decreasing loss — sharded over a ``(data, seq, model)`` mesh of
every device when there are two or more.

Departure from the JAX probe: CUDA fixes the set of devices a process sees
at its first CUDA call, and there is no counterpart of JAX's
``clear_backends`` to re-enumerate in place. So :func:`wait_for_devices`
polls the device count in a CHILD process each time, and this process
touches CUDA only once the count is reached — a workload must likewise not
initialise CUDA before the attach has landed. Pinning the visible devices
(``configure_visible_chips``) waits for the port's device model, which maps
minors to GPU UUIDs.

CLI:  python -m gpumounter_tpu_torch.torchcheck.probe --expect 4
      [--timeout 60] [--cpu-devices N]
      one JSON line; exit 0 iff the devices are there and validate, 1 when
      a check failed, 2 when the expected count was not reached in time.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from gpumounter_tpu_torch.torchcheck import dist as dist_lib
from gpumounter_tpu_torch.torchcheck import resolve_device
from gpumounter_tpu_torch.utils.log import get_logger

logger = get_logger("torchcheck.probe")

COLLECTIVE_TIMEOUT_S = 300.0


def device_summary(device: str | torch.device = "cuda",
                   cpu_devices: int = 1) -> dict[str, Any]:
    """What this process sees: the CUDA devices, or ``cpu_devices``
    worker processes' worth of CPU for ``device="cpu"``."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        count = torch.cuda.device_count()
        names = [torch.cuda.get_device_name(i) for i in range(count)]
    else:
        count, names = cpu_devices, ["cpu"] * cpu_devices
    return {"backend": dev.type, "device_count": count, "devices": names}


def _child_device_count() -> int:
    """``torch.cuda.device_count()`` as a fresh process sees it (this
    process's count is frozen at its first CUDA call)."""
    proc = subprocess.run(
        [sys.executable, "-c",
         "import torch; print(torch.cuda.device_count())"],
        capture_output=True, text=True, timeout=120)
    if proc.returncode != 0:
        raise RuntimeError(f"device-count child failed: {proc.stderr[-400:]}")
    return int(proc.stdout.strip().splitlines()[-1])


def wait_for_devices(expected: int, timeout_s: float = 60.0,
                     poll_s: float = 2.0, device: str = "cuda",
                     cpu_devices: int = 1) -> dict[str, Any]:
    """Poll until ``expected`` devices are visible, counting CUDA devices
    in a child process per poll (see the module docstring); with
    ``device="cpu"`` the count is ``cpu_devices``. Returns the final
    device summary; raises TimeoutError at the deadline."""
    deadline = time.monotonic() + timeout_s
    while True:
        count = (_child_device_count() if torch.device(device).type == "cuda"
                 else cpu_devices)
        if count >= expected:
            return device_summary(device, cpu_devices)
        if time.monotonic() >= deadline:
            raise TimeoutError(f"expected {expected} devices, have {count} "
                               f"after {timeout_s}s")
        logger.info("waiting for devices: %d/%d", count, expected)
        time.sleep(poll_s)


def _collective_check(device: torch.device) -> tuple[int, int]:
    """One rank of :func:`validate_collectives`: all-reduces its rank and
    passes it one step round the ring. Returns (sum, rank received)."""
    rank, world = dist.get_rank(), dist.get_world_size()
    x = torch.tensor([rank], dtype=torch.int64, device=device)
    dist.all_reduce(x)
    sent = torch.tensor([rank], dtype=torch.int64, device=device)
    received = dist_lib.permute([sent], dist.group.WORLD)[0]
    return int(x.item()), int(received.item())


def validate_collectives(n_devices: int | None = None,
                         device: str = "cuda") -> dict[str, Any]:
    """Prove every device takes part in collectives: one process per
    device (NCCL on GPUs, gloo on the CPU, ``n_devices`` processes), an
    all-reduce of the ranks and a ring send/recv, checked for exact
    integer results. One device is marked ``degenerate_single_device``:
    nothing then crossed a link."""
    dev = resolve_device(device)
    n = n_devices or (torch.cuda.device_count() if dev.type == "cuda" else 1)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    errors: list[str] = []
    try:
        got = dist_lib.run_world(n, _collective_check, device=dev,
                                 timeout_s=COLLECTIVE_TIMEOUT_S)
    except (RuntimeError, TimeoutError) as e:
        got, errors = [], [str(e)[-2000:]]
    expected_total = n * (n - 1) // 2
    allreduce_ok = (len(got) == n
                    and all(t == expected_total for t, _ in got))
    ring_ok = (len(got) == n
               and all(got[r][1] == (r - 1) % n for r in range(n)))
    report = {"n_devices": n, "backend": backend,
              "allreduce_ok": bool(allreduce_ok), "ring_ok": bool(ring_ok),
              # a 1-device group moves no bytes between devices: "ok" then
              # means the degenerate case ran, not that links work
              "degenerate_single_device": bool(n == 1),
              "ok": bool(allreduce_ok and ring_ok)}
    if errors:
        report["errors"] = errors
    return report


def _train_mesh(device: torch.device, n_steps: int) -> dict[str, Any]:
    """One rank of :func:`validate_training` over a mesh: the toy model's
    sharded step over ``make_mesh()`` (the seq dim takes every device),
    T = 16 x seq. Every rank returns the same report."""
    from gpumounter_tpu_torch.torchcheck import model as model_lib
    from gpumounter_tpu_torch.torchcheck import train as train_lib

    cfg = model_lib.ModelConfig()
    mesh = model_lib.make_mesh(device=device)
    state = train_lib.init_state(cfg, seed=0, device=device, mesh=mesh)
    step = train_lib.make_train_step(cfg, mesh)
    seq = dist_lib.axis_size(mesh, "seq")
    tokens = train_lib.make_batch(torch.Generator(device).manual_seed(1), 8,
                                  16 * seq, cfg.vocab)
    tokens = dist_lib.shard(tokens, mesh, ("data", "seq"))
    report = _train_loop(step, state, tokens, n_steps)
    report["mesh"] = dict(zip(mesh.mesh_dim_names, mesh.shape))
    return report


def _train_loop(step, state, tokens, n_steps: int) -> dict[str, Any]:
    t0 = time.monotonic()
    first_loss = float("nan")
    for i in range(n_steps):
        state, loss = step(state, tokens)
        if i == 0:
            first_loss = float(loss)
    final_loss = float(loss)
    elapsed = time.monotonic() - t0
    ok = bool(np.isfinite(final_loss) and final_loss < first_loss)
    return {"mesh": None, "first_loss": first_loss, "final_loss": final_loss,
            "steps": n_steps, "elapsed_s": round(elapsed, 3), "ok": ok}


def validate_training(n_steps: int = 4, device: str = "cuda",
                      n_devices: int = 1) -> dict[str, Any]:
    """Train the toy flagship model; loss must be finite and decreasing —
    compute is real, not just enumerable. With ``n_devices`` > 1 the step
    is sharded over a ``make_mesh()`` of that many processes (one per
    device, as the JAX probe shards it over every device) and the report
    names the mesh; with one device it runs in this process."""
    from gpumounter_tpu_torch.torchcheck import model as model_lib
    from gpumounter_tpu_torch.torchcheck import train as train_lib

    dev = resolve_device(device)
    if n_devices > 1:
        return dist_lib.run_world(n_devices, _train_mesh, (n_steps,),
                                  device=dev)[0]
    cfg = model_lib.ModelConfig()
    state = train_lib.init_state(cfg, seed=0, device=dev)
    step = train_lib.make_train_step(cfg)
    tokens = train_lib.make_batch(torch.Generator(dev).manual_seed(1), 8, 64,
                                  cfg.vocab)
    return _train_loop(step, state, tokens, n_steps)


def run_probe(expected: int | None = None, timeout_s: float = 60.0,
              device: str = "cuda", cpu_devices: int = 1) -> dict[str, Any]:
    report: dict[str, Any] = {"ok": False}
    if expected:
        report["devices"] = wait_for_devices(expected, timeout_s,
                                             device=device,
                                             cpu_devices=cpu_devices)
    else:
        report["devices"] = device_summary(device, cpu_devices)
    n = report["devices"]["device_count"]
    # A failure on a broken device or link is what the probe exists to
    # detect: it becomes {"ok": false}, never a traceback (the CLI contract
    # is one JSON line, exit 0/1/2).
    try:
        report["collectives"] = validate_collectives(n, device=device)
    except Exception as e:
        report["collectives"] = {"ok": False, "error": repr(e)}
    try:
        report["training"] = validate_training(device=device, n_devices=n)
    except Exception as e:
        report["training"] = {"ok": False, "error": repr(e)}
    report["ok"] = report["collectives"]["ok"] and report["training"]["ok"]
    return report


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--expect", type=int, default=None,
                        help="wait until this many devices are visible")
    parser.add_argument("--timeout", type=float, default=60.0)
    parser.add_argument("--cpu-devices", type=int, default=None,
                        help="hardware-free mode: N gloo CPU processes")
    args = parser.parse_args(argv)
    device = "cpu" if args.cpu_devices else "cuda"
    try:
        report = run_probe(args.expect, args.timeout, device=device,
                           cpu_devices=args.cpu_devices or 1)
    except TimeoutError as e:
        print(json.dumps({"ok": False, "error": str(e)}))
        return 2
    print(json.dumps(report))
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
