"""A pod's own ride through the port's master: the hot-attach under training.

:func:`run_elastic_attach` puts :mod:`.master_attach`'s master in front of
:mod:`.worker_attach`'s worker (an HTTP apiserver facade, a scripted
scheduler with a PodResources gRPC server, the v1 device gate, the resident
agent, a fixture container), around whatever enumerator the caller passes,
with the worker's ``mesh_gen_dir`` set (``TPU_MESH_GEN_DIR``), and starts
the Pod's CUDA-free pod process (:func:`pod_process`, an
``elastic.ElasticSupervisor``) before any attach: it waits for the worker's
file, its ``dev_root`` is the container's ``/dev``.

- ``GET /addgpu`` of one GPU: the worker's own stamp starts the first
  world, one rank on the GPU the attach returned, from a fresh state;
- while the rank holds the GPU, ``POST /removegpu`` answers ``GPU_BUSY``
  (the ranks are processes of the container);
- the bump: with ``grow``, a second ``GET /addgpu`` of one GPU stamps the
  file with both, and the pod process respawns a world of two ranks; else
  the worker's own ``_stamp_mesh_generation`` stamps the same GPU again
  (a respawn at the same width: the one actuation a one-GPU node offers
  whose chip count the ride accepts), and a fresh rank restores;
- after the stop, ``POST /removegpu`` detaches: no slave pod, no node.

The report holds the attach → first step reading and the respawn's
downtime, each in parts. Every check is reported by name; the caller
decides what failing means.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import multiprocessing
import os
import shutil
import subprocess
import sys
import time
from collections.abc import Callable

from gpumounter_tpu_torch.device.enumerator import Enumerator
from gpumounter_tpu_torch.testing.master_attach import (REMOVE, _http,
                                                         _MasterStack)
from gpumounter_tpu_torch.testing.worker_attach import IDLE, spawn
from gpumounter_tpu_torch.torchcheck import model as model_lib

SIGNAL = "default--workload.json"
# How long the rig waits for each stage of the ride.
WAIT_S = 300.0


def add_route(entire: bool) -> str:
    """The reference's attach route for one GPU. Only single mounts
    compose (the reference's ``CanMount``): a pod that grows takes both
    GPUs by single mounts."""
    return ("/addgpu/namespace/default/pod/workload/gpu/1/isEntireMount/"
            + ("true" if entire else "false"))


@dataclasses.dataclass
class Ride:
    """What the pod process trains (picklable: it goes to the spawned
    pod process). ``attn_impl`` picks the step's attention (``"flash"`` on
    the card); ``tol`` is the agreement of the first loss after a respawn
    with the old world's uninterrupted step."""
    device: str
    cfg: model_lib.ModelConfig
    batch: int
    seq_len: int
    attn_impl: str | None = None
    lr: float = 3e-4
    tol: float = 1e-3


def pod_process(ride: Ride, root: str, dev_root: str, signal_path: str,
                status_path: str, stop_path: str, result_path: str) -> None:
    """The Pod's pod process: ``ElasticSupervisor`` on the worker's file,
    one rank per GPU the container's nodes show (the Megatron split, every
    leaf digested across a respawn). Writes its exit code and whether it
    ever initialised CUDA."""
    import faulthandler
    faulthandler.enable()           # a native crash prints its stacks
    import torch

    from gpumounter_tpu_torch.torchcheck import elastic, train

    step_factory = (None if ride.attn_impl is None else functools.partial(
        train.make_train_step, attn_impl=ride.attn_impl))
    sup = elastic.ElasticSupervisor(
        ride.cfg, elastic.FileSignal(signal_path), os.path.join(root, "ckpt"),
        device=ride.device,
        batches=elastic.SeededBatches(ride.batch, ride.seq_len,
                                      ride.cfg.vocab),
        lr=ride.lr, step_factory=step_factory, status_path=status_path,
        stop_path=stop_path, verify=True, data=1, seq=1, model=None,
        dev_root=dev_root)
    rc = sup.run()
    with open(result_path, "w") as f:
        json.dump({"rc": rc, "pid": os.getpid(),
                   "cuda_initialized": torch.cuda.is_initialized()}, f)
    sys.exit(rc)


def read_records(path: str) -> list[dict]:
    """The JSONL status records at ``path`` (none while it is absent)."""
    try:
        with open(path) as f:
            return [json.loads(line) for line in f if line.strip()]
    except OSError:
        return []


def alive(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def descendants(pid: int) -> list[int]:
    """The live processes below ``pid`` (its ranks, their helpers)."""
    children: dict[int, list[int]] = {}
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if fields[0] != "Z":
            children.setdefault(int(fields[1]), []).append(int(entry))
    out, todo = [], [pid]
    while todo:
        for child in children.get(todo.pop(), []):
            out.append(child)
            todo.append(child)
    return sorted(out)


def gpu_nodes(pid: int) -> list[str]:
    """The ``/dev/nvidia*`` files process ``pid`` holds open."""
    out = set()
    try:
        fds = os.listdir(f"/proc/{pid}/fd")
    except OSError:
        return []
    for fd in fds:
        try:
            target = os.readlink(f"/proc/{pid}/fd/{fd}")
        except OSError:
            continue
        if target.startswith("/dev/nvidia"):
            out.add(target)
    return sorted(out)


def _uuid(text: str) -> str:
    return str(text).strip().lower().removeprefix("gpu-")


def run_elastic_attach(root: str, enumerator: Enumerator, ride: Ride, *,
                       grow: bool = False,
                       hold: Callable[[list, list[int]], None] | None = None
                       ) -> dict:
    """Drive the ride under ``root`` (removed first and afterwards).
    ``grow`` needs two GPUs on the node. ``hold(gpus, pids)``, where the
    ranks do not open the GPUs' nodes themselves (CPU ranks over fake
    GPUs), makes ``pids`` the GPUs' holders. Returns the report with its
    ``checks``."""
    shutil.rmtree(root, ignore_errors=True)
    on_gpu = ride.device.startswith("cuda")
    checks: dict[str, bool] = {}
    report: dict = {"grow": grow}
    procs: list[subprocess.Popen] = []
    stack = sup = None
    try:
        stack = _MasterStack(os.path.join(root, "node"), enumerator)
        worker = stack.worker
        gen_dir = os.path.join(root, "mesh-gen")
        worker.settings.mesh_gen_dir = gen_dir
        gpus = {d.uuid: d for d in enumerator.enumerate() if d.uuid}
        idle = spawn(IDLE)
        procs.append(idle)
        box = worker.node.container("workload", [idle.pid])
        worker.add_target(box)
        paths = {name: os.path.join(root, name) for name in (
            "status.jsonl", "stop", "result.json")}
        signal = os.path.join(gen_dir, SIGNAL)

        def records(phase=None):
            return [r for r in read_records(paths["status.jsonl"])
                    if phase is None or r["phase"] == phase]

        def stamped():
            with open(signal) as f:
                return json.load(f)

        def wait_for(what, predicate):
            deadline = time.monotonic() + WAIT_S
            while not (value := predicate()):
                if sup.exitcode is not None:
                    raise RuntimeError(
                        f"the pod process exited with {sup.exitcode} "
                        f"while waiting for {what}: {records('error')}")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"no {what} within {WAIT_S:.0f}s")
                time.sleep(0.05)
            return value

        # the pod process, a process of the container, starts first
        ctx = multiprocessing.get_context("spawn")
        sup = ctx.Process(target=pod_process, args=(
            ride, root, box.dev, signal, paths["status.jsonl"],
            paths["stop"], paths["result.json"]))
        sup.start()
        box.set_pids([idle.pid, sup.pid])
        wait_for("the pod process waiting", lambda: records("waiting"))
        time.sleep(0.5)
        checks["pod_process_waits_for_its_first_gpu"] = (
            sup.exitcode is None
            and [r["phase"] for r in records()] == ["waiting"]
            and not os.path.exists(signal))

        # 1. the attach: the worker's stamp starts the first world
        t0 = time.time()
        status, body = _http("GET", stack.base + add_route(not grow))
        returned = time.time()
        report["addgpu"] = body
        report["addgpu_s"] = returned - t0
        ids = body.get("device_ids") if isinstance(body, dict) else None
        checks["add_http_200_success"] = (
            status == 200 and isinstance(body, dict)
            and body.get("result") == "SUCCESS"
            and len(ids or []) == 1 and ids[0] in gpus)
        if not checks["add_http_200_success"]:
            return report
        first = ids[0]
        stamp = stamped()
        report["generation_1"] = stamp
        checks["attached_through_the_master"] = (
            stamp["chips"] == [first]
            and t0 <= stamp["generation"] <= returned)
        wait_for("the first world's steps", lambda: len(records("step")) >= 2)
        started = records("started")[0]
        first_step = records("step")[0]
        seen = records("signal")[0]
        up = started["startup"]
        report["attach_to_first_step_s"] = parts = {
            "addgpu_return_to_stamp_seen": seen["unix"] - returned,
            "stamp_seen_to_spawn": started["spawned"] - seen["unix"],
            "spawn_to_interpreter": up["main"] - started["spawned"],
            "interpreter_to_device": up["device"] - up["main"],
            "init_process_group": up["joined"] - up["device"],
            "fresh_state_built": up["built"] - up["joined"],
            "first_step": first_step["unix"] - up["built"]}
        report["attach_to_first_step_total_s"] = sum(parts.values())
        checks["first_world_on_the_stamp"] = (
            started["generation"] == stamp["generation"]
            and started["world_devices"] == 1
            and started["restored_generation"] is None)
        if on_gpu:
            checks["rank_on_the_attached_uuid"] = (
                _uuid(started.get("uuid", "")) == _uuid(first))

        # 2. the ranks are the container's: the detach is refused
        ranks = descendants(sup.pid)
        box.set_pids([idle.pid, sup.pid] + ranks)
        if hold is not None:
            hold([gpus[first]], [started["pid"]])
        status, busy = _http("POST", stack.base + REMOVE, b"")
        report["busy_detach"] = busy
        checks["busy_refused_while_riding"] = (
            status == 409 and isinstance(busy, dict)
            and busy.get("result") == "GPU_BUSY"
            and started["pid"] in (busy.get("busy_pids") or []))
        if hold is not None:
            hold([gpus[first]], [])
        apps_before = compute_app_pids() if on_gpu else []
        nodes_before = gpu_nodes(sup.pid)

        # 3. the bump: a second GPU attached, or the same one stamped anew
        if grow:
            status, body = _http("GET", stack.base + add_route(False))
            report["addgpu_grow"] = body
            second = (body.get("device_ids") or [None])[0] \
                if isinstance(body, dict) else None
            attached = sorted([first, second]) if second else [first]
            checks["grow_http_200_success"] = (
                status == 200 and second in gpus and second != first)
        else:
            worker.service._stamp_mesh_generation("default", "workload",
                                                  [first])
            attached = [first]
        stamp2 = stamped()
        report["generation_2"] = stamp2
        world = len(attached)
        checks["bump_stamped_by_the_worker"] = (
            stamp2["chips"] == attached
            and stamp2["generation"] > stamp["generation"])
        wait_for("the respawned world's steps",
                 lambda: len([r for r in records("step")
                              if r["generation"] == stamp2["generation"]])
                 >= 2)
        new_ranks = [pid for pid in descendants(sup.pid)
                     if pid not in ranks]
        report["rank_nodes"] = {str(pid): gpu_nodes(pid)
                                for pid in new_ranks}
        apps_after = compute_app_pids() if on_gpu else []
        nodes_after = gpu_nodes(sup.pid)
        with open(paths["stop"], "w") as f:
            f.write("1")
        sup.join(timeout=WAIT_S)

        # 4. the detach after the stop
        box.set_pids([idle.pid])
        status, done = _http("POST", stack.base + REMOVE, b"")
        report["detach"] = done
        checks["detached_after_stop"] = (
            status == 200 and isinstance(done, dict)
            and done.get("result") == "SUCCESS"
            and worker.slave_pods() == [] and box.nodes() == {})

        with open(paths["result.json"]) as f:
            result = json.load(f)
        begin = records("reshape_begin")[0]
        resumed = records("reshape_done")[0]
        numbers = [r["step"] for r in records("step")]
        after = [r for r in records("step")
                 if r["generation"] == stamp2["generation"]][0]
        downtime = dict(resumed["downtime_s"],
                        first_step=after["unix"] - resumed["unix"])
        err = abs(after["loss"] - resumed["reference_loss"])
        checks.update({
            "supervisor_exit_0": result["rc"] == 0 and sup.exitcode == 0,
            "steps_strictly_increase": numbers == sorted(set(numbers))
            and len(numbers) >= 4 and resumed["step"] == begin["step"],
            "respawned_world": resumed["world_devices"] == world
            and resumed["generation"] == stamp2["generation"],
            "fingerprint_bitwise":
                resumed["fingerprint"] == begin["fingerprint"],
            "leaves_bitwise": bool(begin["digests"])
            and resumed["digests"] == begin["digests"],
            "loss_within_tol": err <= ride.tol,
            "old_rank_gone": started["pid"] != resumed["pid"]
            and not alive(started["pid"]),
            "old_rank_exited_before_the_spawn":
                resumed["downtime_s"]["old_rank_exit"] >= 0,
            "supervisor_without_cuda": not result["cuda_initialized"]
            and sup.pid not in apps_before + apps_after
            and not nodes_before + nodes_after})
        if on_gpu:
            # each new rank on its own attached GPU, by the UUID CUDA
            # gives it (each rank's open nodes name every GPU it could
            # open, not the one it computes on)
            checks["new_ranks_on_the_attached_uuids"] = sorted(
                _uuid(u) for u in resumed.get("uuids") or []) == sorted(
                _uuid(u) for u in attached)
        report.update({
            "uuids": attached, "steps": numbers,
            "losses": [r["loss"] for r in records("step")],
            "reference_loss": resumed["reference_loss"],
            "resumed_loss": after["loss"], "abs_err": err, "tol": ride.tol,
            "leaves": len(begin["digests"]),
            "pids": {"supervisor": sup.pid, "old_rank": started["pid"],
                     "new_rank": resumed["pid"]},
            "compute_apps": {"before": apps_before, "after": apps_after},
            "supervisor_gpu_nodes": nodes_before + nodes_after,
            "downtime_parts_s": downtime,
            "downtime_s": sum(downtime.values()),
            "reshape_begin_to_first_step_s": after["unix"] - begin["unix"],
            "timings": resumed["timings"]})
        return report
    finally:
        report["checks"] = checks
        report["ok"] = bool(checks) and all(checks.values())
        if sup is not None and sup.is_alive():
            sup.terminate()
            sup.join(timeout=30)
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
            proc.wait(timeout=60)
        if stack is not None:
            stack.close()
        shutil.rmtree(root, ignore_errors=True)


def compute_app_pids() -> list[int]:
    """The pids ``nvidia-smi`` lists as holding a compute context."""
    proc = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return [int(x) for x in proc.stdout.split() if x.strip().isdigit()]
