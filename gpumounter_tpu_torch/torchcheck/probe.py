"""In-pod post-attach probe, on PyTorch.

Counterpart of :mod:`gpumounter_tpu.jaxcheck.probe`. After an attach the
workload Pod must (1) see the GPUs — ``torch.cuda.device_count() ==
expected`` — and (2) be able to run real compute on them: an exact-integer
all-reduce and a ring send/recv over one process per device (NCCL on GPUs,
gloo with ``--cpu-devices``), then the flagship model training with finite,
decreasing loss.

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
import multiprocessing
import queue
import socket
import subprocess
import sys
import time
from typing import Any

import numpy as np
import torch

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


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _collective_worker(rank: int, world: int, port: int, backend: str,
                       results) -> None:
    """One process of :func:`validate_collectives`: joins the group,
    all-reduces its rank and passes it one step round the ring."""
    import torch.distributed as dist
    try:
        device = "cpu"
        if backend == "nccl":
            torch.cuda.set_device(rank)
            device = f"cuda:{rank}"
        dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                                world_size=world, rank=rank)
        try:
            x = torch.tensor([rank], dtype=torch.int64, device=device)
            dist.all_reduce(x)
            total = int(x.item())
            received = rank
            if world > 1:
                send = torch.tensor([rank], dtype=torch.int64, device=device)
                recv = torch.empty_like(send)
                ops = [dist.P2POp(dist.isend, send, (rank + 1) % world),
                       dist.P2POp(dist.irecv, recv, (rank - 1) % world)]
                for req in dist.batch_isend_irecv(ops):
                    req.wait()
                received = int(recv.item())
        finally:
            dist.destroy_process_group()
        results.put((rank, total, received, None))
    except Exception as e:   # reported to the parent, which judges the run
        results.put((rank, None, None, repr(e)))


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
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_collective_worker,
                         args=(r, n, port, backend, results))
             for r in range(n)]
    for p in procs:
        p.start()
    got: dict[int, tuple] = {}
    errors: list[str] = []
    deadline = time.monotonic() + COLLECTIVE_TIMEOUT_S
    try:
        while len(got) < n and time.monotonic() < deadline:
            try:
                rank, total, received, err = results.get(timeout=1.0)
            except queue.Empty:
                if not any(p.is_alive() for p in procs) and results.empty():
                    break
                continue
            got[rank] = (total, received)
            if err:
                errors.append(f"rank {rank}: {err}")
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    expected_total = n * (n - 1) // 2
    allreduce_ok = (len(got) == n and not errors
                    and all(t == expected_total for t, _ in got.values()))
    ring_ok = (len(got) == n and not errors
               and all(got[r][1] == (r - 1) % n for r in got))
    report = {"n_devices": n, "backend": backend,
              "allreduce_ok": bool(allreduce_ok), "ring_ok": bool(ring_ok),
              # a 1-device group moves no bytes between devices: "ok" then
              # means the degenerate case ran, not that links work
              "degenerate_single_device": bool(n == 1),
              "ok": bool(allreduce_ok and ring_ok)}
    if errors or len(got) < n:
        report["errors"] = errors or [f"{n - len(got)} rank(s) never "
                                      "reported"]
    return report


def validate_training(n_steps: int = 4, device: str = "cuda"
                      ) -> dict[str, Any]:
    """Train the toy flagship model on one device; loss must be finite and
    decreasing — compute is real, not just enumerable. (The JAX probe
    shards this step over every device; the port's mesh is a later
    slice.)"""
    from gpumounter_tpu_torch.torchcheck import model as model_lib
    from gpumounter_tpu_torch.torchcheck import train as train_lib

    dev = resolve_device(device)
    cfg = model_lib.ModelConfig()
    state = train_lib.init_state(cfg, seed=0, device=dev)
    step = train_lib.make_train_step(cfg)
    tokens = train_lib.make_batch(torch.Generator(dev).manual_seed(1), 8, 64,
                                  cfg.vocab)
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
        report["training"] = validate_training(device=device)
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
