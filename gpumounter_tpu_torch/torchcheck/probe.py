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
initialise CUDA before the attach has landed.

Partial-host visibility: :func:`configure_visible_chips` pins
``CUDA_VISIBLE_DEVICES`` to the UUIDs of the ``/dev/nvidiaN`` nodes present
in this container, read through the device layer's enumerator (minor ->
UUID from the driver). The pin takes effect at a process's first CUDA
call, so it is set before it, and re-derived between the polls of
:func:`wait_for_devices`, whose children see each poll's pin.

Multi-process bring-up: a world spans pods, and each pod's process
drives every GPU its pod holds through one rank process per GPU
(:class:`~.dist.LocalWorld`, :func:`run_local_probe`). The pod process
itself never touches CUDA — a process's device set is fixed at its first
CUDA call, so ranks spawned afresh for each world see the GPUs attached
since. :func:`initialize_distributed` joins one rank to its world and
:func:`shutdown_distributed` leaves it. The probe's checks then run over
that world, each rank checking its own part.

CLI:  python -m gpumounter_tpu_torch.torchcheck.probe --expect 4
      [--timeout 60] [--cpu-devices N] [--dev-root /dev]
      [--coordinator HOST:PORT --num-processes P --process-id I]
      one JSON line; exit 0 iff the devices are there and validate, 1 when
      a check failed, 2 when the expected count was not reached in time.
      With ``--coordinator`` this process is process I of P, each driving
      N local devices (every GPU its pod's device nodes show, or
      ``--cpu-devices N`` gloo ranks on the CPU): the world is P x N
      ranks, global rank I x N + local, and ``--expect`` counts the
      world's devices.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
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
    worker processes' worth of CPU for ``device="cpu"``. In an initialised
    world ``device_count`` is the world's, ``local_device_count`` the
    ranks its pod process drives (``LOCAL_WORLD_SIZE``), and the process
    index and count are the pod processes', as in the JAX summary."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        count = torch.cuda.device_count()
        names = [torch.cuda.get_device_name(i) for i in range(count)]
    else:
        count, names = cpu_devices, ["cpu"] * cpu_devices
    summary = {"backend": dev.type, "device_count": count,
               "local_device_count": count, "devices": names,
               "process_index": 0, "process_count": 1}
    if dist.is_initialized():
        world, local = dist.get_world_size(), dist_lib.local_world_size()
        summary.update(device_count=world, local_device_count=local,
                       process_index=dist.get_rank() // local,
                       process_count=world // local)
    return summary


def initialize_distributed(coordinator_address: str, num_processes: int,
                           process_id: int,
                           device: str | torch.device = "cuda"
                           ) -> torch.device:
    """Join this process to a ``torch.distributed`` world as rank
    ``process_id`` of ``num_processes`` (counterpart of
    ``jax.distributed.initialize``; torch has no slice auto-detection, so
    all three are required). Rank 0 serves the rendezvous at
    ``coordinator_address`` (``host:port``).

    A rank drives one device: NCCL with this rank on its device for
    ``device="cuda"`` (``cuda:N`` names the card; without an index rank r
    takes card r modulo the visible count; it becomes the current device,
    where NCCL creates its communicators at their first collective), gloo
    for ``device="cpu"``. A pod process driving N devices runs N such
    ranks (:class:`~.dist.LocalWorld` joins each; the counterpart of the
    JAX probe's ``cpu_devices_per_process``). Returns the device this rank
    computes on."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda",
                               int(process_id) % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=int(process_id),
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    return dev


def release_backend() -> None:
    """Wait for the device and free PyTorch's cached device memory: the
    port's single-process teardown between a drain and a restore. It
    does NOT re-enumerate devices as ``jaxcheck/probe.py``'s
    ``reinitialize_backend`` does — CUDA fixes a process's device set at
    its first CUDA call, so a changed set of GPUs needs a new process
    (module docstring). Tensors the caller still holds stay valid."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def shutdown_distributed() -> bool:
    """Leave this process's ``torch.distributed`` world, so that a later
    :func:`initialize_distributed` can join a NEW world of another size
    and coordinator (the elastic re-federation step: drain → THIS →
    barrier → initialize → restore resharded). Destroys every process
    group, drops every ``DeviceMesh`` the mesh registry holds (each refers
    to the groups just destroyed: build meshes anew after re-joining) and
    releases the device (:func:`release_backend`). Returns whether there
    was a world to leave."""
    from torch.distributed import device_mesh
    release_backend()
    for value in vars(device_mesh._mesh_resources).values():
        if isinstance(value, (dict, list)):
            value.clear()
    if not dist.is_initialized():
        return False
    dist.destroy_process_group()
    release_backend()
    return True


def visible_chip_indices(dev_root: str = "/dev") -> list[int] | None:
    """Indices of the ``nvidiaN`` nodes present in this container, or None
    when there are none (CPU-only hosts). After a partial-host mount only
    the mounted GPUs' nodes exist here, so presence is accessibility."""
    from gpumounter_tpu_torch.device.enumerator import PyEnumerator
    from gpumounter_tpu_torch.utils.config import HostPaths
    host = HostPaths(dev_root=dev_root)
    found = [d.index for d in PyEnumerator(host, allow_fake=True).enumerate()]
    return found or None


def pod_gpus(dev_root: str = "/dev", proc_root: str = "/proc") -> list:
    """The GPUs this container's ``nvidiaN`` nodes show, in minor order,
    each with its UUID: what a pod process counts its GPUs by without
    touching CUDA. Where the driver (or NVML) names the GPUs, a node it
    does not name is no GPU of this pod and is left out (logged), as
    :func:`configure_visible_chips` leaves it out of the pin; with no
    source of names (fixture trees) every node counts."""
    from gpumounter_tpu_torch.device.enumerator import PyEnumerator
    from gpumounter_tpu_torch.utils.config import HostPaths
    enumerator = PyEnumerator(HostPaths(dev_root=dev_root,
                                        proc_root=proc_root),
                              allow_fake=True)
    devices = enumerator.enumerate()
    if enumerator.uuid_source in (None, "none"):
        return devices
    unknown = [d.device_path for d in devices if not d.uuid]
    if unknown:
        logger.warning("no UUID for %s: not counted as this pod's GPUs",
                       unknown)
    return [d for d in devices if d.uuid]


def rank_visibility(devices: list) -> str | None:
    """``CUDA_VISIBLE_DEVICES`` for ranks that drive ``devices`` (rank r
    on the r-th): their UUIDs, or None when one has none (the ranks then
    keep the inherited setting)."""
    if not devices or not all(d.uuid for d in devices):
        return None
    return ",".join(d.uuid for d in devices)


def select_gpus(device: str, n: int, dev_root: str = "/dev",
                proc_root: str = "/proc") -> list:
    """The ``n`` GPUs a pod process's ranks drive, read from its device
    nodes (no CUDA call): ``"cuda"`` takes the first ``n`` present,
    ``"cuda:i"`` or ``"cuda:i,j,..."`` names them by their place among
    the present ones (pods that share a host in tests). Raises
    RuntimeError when no GPU node is present (never falls back to the
    CPU), ValueError when fewer than ``n`` are present or named."""
    present = pod_gpus(dev_root, proc_root)
    if not present:
        raise RuntimeError(
            f"device {device!r} requested but no CUDA device is visible "
            f"(no nvidiaN node under {dev_root}); pass device='cpu' to run "
            "on the CPU")
    _, _, named = str(device).partition(":")
    if named:
        places = [int(i) for i in named.split(",")]
        if len(places) != n or max(places) >= len(present):
            raise ValueError(
                f"{device!r} names {len(places)} of the {len(present)} GPUs "
                f"the pod's device nodes show; {n} local devices asked for")
        return [present[i] for i in places]
    if n > len(present):
        raise ValueError(f"{n} local devices asked for, the pod's device "
                         f"nodes show {len(present)} GPU(s)")
    return present[:n]


def configure_visible_chips(dev_root: str = "/dev", env: Any = None,
                            proc_root: str = "/proc") -> str | None:
    """The partial-host visibility contract: set ``CUDA_VISIBLE_DEVICES`` to
    the UUIDs of the ``nvidiaN`` nodes present, in minor order, so that
    CUDA stays inside the pod's grant. The UUIDs come from the enumerator
    (the driver's proc tree, else NVML); a node neither knows is left out
    and logged. An operator's pin is respected; with no node (or no UUID)
    nothing is set. Returns the effective value.

    CUDA reads the variable at a process's first CUDA call: a pin set in a
    process that has already touched CUDA changes only its children, one
    more reason the probe touches CUDA only after the attach."""
    from gpumounter_tpu_torch.device.enumerator import PyEnumerator
    from gpumounter_tpu_torch.utils.config import HostPaths
    if env is None:
        env = os.environ
    if env.get("CUDA_VISIBLE_DEVICES"):
        return env["CUDA_VISIBLE_DEVICES"]
    devices = PyEnumerator(HostPaths(dev_root=dev_root, proc_root=proc_root),
                           allow_fake=True).enumerate()
    unknown = [d.device_path for d in devices if not d.uuid]
    if unknown:
        logger.warning("no UUID for %s; left out of CUDA_VISIBLE_DEVICES",
                       unknown)
    uuids = [d.uuid for d in devices if d.uuid]
    if not uuids:
        return None
    value = ",".join(uuids)
    env["CUDA_VISIBLE_DEVICES"] = value
    logger.info("CUDA_VISIBLE_DEVICES=%s (from present device nodes)", value)
    return value


def _child_device_count() -> int:
    """``torch.cuda.device_count()`` as a fresh process sees it (this
    process's count is frozen at its first CUDA call), under this
    process's environment, ``CUDA_VISIBLE_DEVICES`` included."""
    proc = subprocess.run(
        [sys.executable, "-c",
         "import torch; print(torch.cuda.device_count())"],
        capture_output=True, text=True, timeout=120)
    if proc.returncode != 0:
        raise RuntimeError(f"device-count child failed: {proc.stderr[-400:]}")
    return int(proc.stdout.strip().splitlines()[-1])


def wait_for_devices(expected: int, timeout_s: float = 60.0,
                     poll_s: float = 2.0, device: str = "cuda",
                     cpu_devices: int = 1, dev_root: str = "/dev",
                     proc_root: str = "/proc",
                     auto_visible: bool | None = None) -> dict[str, Any]:
    """Poll until ``expected`` devices are visible, counting CUDA devices
    in a child process per poll (see the module docstring); with
    ``device="cpu"`` the count is ``cpu_devices``. Returns the final
    device summary; raises TimeoutError at the deadline.

    Before each poll the visibility pin is re-derived from the nodes
    present (unless operator-set), so GPUs attached since the last poll
    widen ``CUDA_VISIBLE_DEVICES`` before the child counts. ``auto_visible
    =None`` infers "not operator-set" from the environment; a caller that
    has already pinned (``run_probe``) passes the flag, or its own pin
    would be taken for an operator's."""
    deadline = time.monotonic() + timeout_s
    if auto_visible is None:
        auto_visible = not os.environ.get("CUDA_VISIBLE_DEVICES")
    on_gpu = torch.device(device).type == "cuda"
    while True:
        if auto_visible and on_gpu:
            os.environ.pop("CUDA_VISIBLE_DEVICES", None)
            configure_visible_chips(dev_root, proc_root=proc_root)
        count = _child_device_count() if on_gpu else cpu_devices
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
    errors: list[str] = []
    if dist.is_initialized():
        # one rank of a world joined by initialize_distributed: check this
        # rank's part (every rank runs the same check)
        n, rank = dist.get_world_size(), dist.get_rank()
        backend = dist.get_backend()
        got = {rank: _collective_check(_rank_device(dev))}
    else:
        n = n_devices or (torch.cuda.device_count() if dev.type == "cuda"
                          else 1)
        backend = "nccl" if dev.type == "cuda" else "gloo"
        try:
            got = dict(enumerate(dist_lib.run_world(
                n, _collective_check, device=dev,
                timeout_s=COLLECTIVE_TIMEOUT_S)))
        except (RuntimeError, TimeoutError) as e:
            got, errors = {}, [str(e)[-2000:]]
    expected_total = n * (n - 1) // 2
    allreduce_ok = bool(got) and all(t == expected_total
                                     for t, _ in got.values())
    ring_ok = bool(got) and all(received == (r - 1) % n
                                for r, (_, received) in got.items())
    report = {"n_devices": n, "backend": backend,
              "allreduce_ok": bool(allreduce_ok), "ring_ok": bool(ring_ok),
              # a 1-device group moves no bytes between devices: "ok" then
              # means the degenerate case ran, not that links work
              "degenerate_single_device": bool(n == 1),
              "ok": bool(allreduce_ok and ring_ok)}
    if errors:
        report["errors"] = errors
    return report


def _rank_device(dev: torch.device) -> torch.device:
    """This rank's device in an initialised world: the current CUDA
    device (set by :func:`initialize_distributed`), or the CPU."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def _train_mesh(device: torch.device, n_steps: int,
                timed_steps: int = 0) -> dict[str, Any]:
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
    report = _train_loop(step, state, tokens, n_steps, timed_steps)
    report["mesh"] = dict(zip(mesh.mesh_dim_names, mesh.shape))
    return report


def _train_loop(step, state, tokens, n_steps: int,
                timed_steps: int = 0) -> dict[str, Any]:
    t0 = time.monotonic()
    first_loss = float("nan")
    for i in range(n_steps):
        state, loss = step(state, tokens)
        if i == 0:
            first_loss = float(loss)
    final_loss = float(loss)
    elapsed = time.monotonic() - t0
    ok = bool(np.isfinite(final_loss) and final_loss < first_loss)
    report = {"mesh": None, "first_loss": first_loss,
              "final_loss": final_loss, "steps": n_steps,
              "elapsed_s": round(elapsed, 3), "ok": ok}
    if timed_steps > 0:
        # every step above has finished (float(loss) waited for it)
        t0 = time.perf_counter()
        for _ in range(timed_steps):
            state, loss = step(state, tokens)
        if tokens.is_cuda:
            torch.cuda.synchronize(tokens.device)
        step_ms = (time.perf_counter() - t0) / timed_steps * 1e3
        report["step_ms"] = step_ms
        report["ok"] = bool(ok and np.isfinite(float(loss))
                            and np.isfinite(step_ms))
    return report


def validate_training(n_steps: int = 4, device: str = "cuda",
                      n_devices: int = 1,
                      timed_steps: int = 0) -> dict[str, Any]:
    """Train the toy flagship model; loss must be finite and decreasing —
    compute is real, not just enumerable. With ``n_devices`` > 1 the step
    is sharded over a ``make_mesh()`` of that many processes (one per
    device, as the JAX probe shards it over every device) and the report
    names the mesh; with one device it runs in this process.

    ``timed_steps`` > 0 times that many more steps after the first
    ``n_steps`` (the host clock, ended by ``torch.cuda.synchronize``) and
    reports ``step_ms``."""
    from gpumounter_tpu_torch.torchcheck import model as model_lib
    from gpumounter_tpu_torch.torchcheck import train as train_lib

    dev = resolve_device(device)
    if dist.is_initialized():
        return _train_mesh(_rank_device(dev), n_steps, timed_steps)
    if n_devices > 1:
        return dist_lib.run_world(n_devices, _train_mesh,
                                  (n_steps, timed_steps), device=dev)[0]
    cfg = model_lib.ModelConfig()
    state = train_lib.init_state(cfg, seed=0, device=dev)
    step = train_lib.make_train_step(cfg)
    tokens = train_lib.make_batch(torch.Generator(dev).manual_seed(1), 8, 64,
                                  cfg.vocab)
    return _train_loop(step, state, tokens, n_steps, timed_steps)


def run_probe(expected: int | None = None, timeout_s: float = 60.0,
              device: str = "cuda", cpu_devices: int = 1,
              dev_root: str = "/dev", proc_root: str = "/proc"
              ) -> dict[str, Any]:
    report: dict[str, Any] = {"ok": False}
    # Partial-host contract: pin CUDA to the GPUs this pod holds before the
    # first CUDA call (no-op without nodes, or with an operator's pin).
    operator_pinned = bool(os.environ.get("CUDA_VISIBLE_DEVICES"))
    visible = configure_visible_chips(dev_root, proc_root=proc_root)
    if visible is not None:
        report["cuda_visible_devices"] = visible
    if dist.is_initialized():
        # the world is fixed once joined: nothing to wait for
        report["devices"] = device_summary(device, cpu_devices)
        if expected and report["devices"]["device_count"] < expected:
            raise TimeoutError(
                f"expected {expected} devices, the world has "
                f"{report['devices']['device_count']}")
    elif expected:
        report["devices"] = wait_for_devices(
            expected, timeout_s, device=device, cpu_devices=cpu_devices,
            dev_root=dev_root, proc_root=proc_root,
            auto_visible=not operator_pinned)
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


def _probe_rank(device: torch.device, expected: int | None,
                cpu_devices: int, dev_root: str) -> dict[str, Any]:
    """One rank of :func:`run_local_probe`: the probe over the world."""
    dist_lib.check_local_sizes()
    return run_probe(expected, 0.0, device=device.type,
                     cpu_devices=cpu_devices, dev_root=dev_root)


def run_local_probe(coordinator: str, num_processes: int, process_id: int,
                    *, expected: int | None = None, timeout_s: float = 60.0,
                    device: str = "cuda", cpu_devices: int = 1,
                    dev_root: str = "/dev", proc_root: str = "/proc"
                    ) -> dict[str, Any]:
    """This pod process's part of a probe world of ``num_processes`` pod
    processes: N local ranks — one per GPU its pod's device nodes show, or
    ``cpu_devices`` gloo ranks for ``device="cpu"`` — as global ranks
    ``process_id`` x N + local of a world of ``num_processes`` x N, rank 0
    serving the rendezvous at ``coordinator``; each rank runs
    :func:`run_probe` over the whole world. This process never touches
    CUDA: it counts the device nodes (polling them until the world would
    reach ``expected``) and pins each world's ranks to them.

    Raises TimeoutError when the expected count is not reached within
    ``timeout_s``. Returns local rank 0's report, ``ok`` only when every
    local rank's is; a world that fails is ``{"ok": false}`` with its
    ranks' errors."""
    on_gpu = torch.device(device).type == "cuda"
    deadline = time.monotonic() + timeout_s
    while True:
        gpus = pod_gpus(dev_root, proc_root) if on_gpu else []
        n_local = len(gpus) if on_gpu else cpu_devices
        world = n_local * num_processes
        if n_local >= 1 and (not expected or world >= expected):
            break
        if not on_gpu or time.monotonic() >= deadline:
            raise TimeoutError(f"expected {expected or 1} devices, a world "
                               f"of {num_processes} x {n_local} has {world}"
                               f" after {timeout_s}s")
        logger.info("waiting for devices: %d local of %s", n_local, expected)
        time.sleep(2.0)
    ranks = dist_lib.LocalWorld(
        n_local, _probe_rank, (expected, cpu_devices, dev_root),
        device=device, world_size=world, rank_offset=process_id * n_local,
        rendezvous=coordinator,
        visible=rank_visibility(gpus) if on_gpu else None)
    with ranks:
        try:
            reports = ranks.wait()
        except (RuntimeError, TimeoutError) as e:
            return {"ok": False, "devices": {
                "backend": torch.device(device).type, "device_count": world,
                "local_device_count": n_local, "process_index": process_id,
                "process_count": num_processes}, "error": str(e)[-2000:]}
    report = dict(reports[0])
    report["local_ranks_ok"] = [r["ok"] for r in reports]
    report["ok"] = all(report["local_ranks_ok"])
    return report


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--expect", type=int, default=None,
                        help="wait until this many devices are visible")
    parser.add_argument("--timeout", type=float, default=60.0)
    parser.add_argument("--cpu-devices", type=int, default=None,
                        help="hardware-free mode: N gloo CPU processes (with "
                             "--coordinator: N local ranks of this process)")
    parser.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                        help="global rank 0's rendezvous address; enables "
                             "multi-process mode")
    parser.add_argument("--num-processes", type=int, default=None)
    parser.add_argument("--process-id", type=int, default=None)
    parser.add_argument("--dev-root", default="/dev",
                        help="where nvidiaN device nodes live (fixture "
                             "trees in tests)")
    args = parser.parse_args(argv)
    distributed = args.coordinator is not None or args.process_id is not None
    if args.num_processes is not None and not distributed:
        parser.error("--num-processes requires --coordinator and "
                     "--process-id")
    if args.cpu_devices is not None and args.cpu_devices < 1:
        parser.error(f"--cpu-devices must be at least 1, got "
                     f"{args.cpu_devices}")
    if distributed:
        if None in (args.coordinator, args.num_processes, args.process_id):
            parser.error("multi-process mode needs --coordinator, "
                         "--num-processes and --process-id")
        if not 0 <= args.process_id < args.num_processes:
            parser.error(f"--process-id {args.process_id} is not one of "
                         f"{args.num_processes} processes")
    device = "cpu" if args.cpu_devices else "cuda"
    try:
        if distributed:
            report = run_local_probe(
                args.coordinator, args.num_processes, args.process_id,
                expected=args.expect, timeout_s=args.timeout, device=device,
                cpu_devices=args.cpu_devices or 1, dev_root=args.dev_root)
        else:
            report = run_probe(args.expect, args.timeout, device=device,
                               cpu_devices=args.cpu_devices or 1,
                               dev_root=args.dev_root)
    except TimeoutError as e:
        print(json.dumps({"ok": False, "error": str(e)}))
        return 2
    print(json.dumps(report))
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
