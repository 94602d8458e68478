"""Crash-safe multi-process re-federation for elastic resize, on PyTorch.

Counterpart of :mod:`gpumounter_tpu.jaxcheck.federation`: the member side
of the control plane's re-federation barrier (``master/slicetxn.py``, the
same ``/slice/barrier`` and ``/slicez`` API). A resize is a coordinated
teardown of the whole ``torch.distributed`` world: every member drains its
shards, leaves the old world, and joins the new one with the NEW world
size and coordinator — and **no member restores before every member of the
new generation has re-federated**, or the restore's collectives hang
against absentees.

1. the resize actuates and bumps the mesh generation G → G+1; the master
   **arms a barrier** for G+1 naming the new membership
2. each member observes the bump, agrees on it with its peers through a
   collective (:class:`WorldAgreement`, so nobody drains while a peer is
   mid-step), drains its shards (``drain.drain_sharded``) and leaves the
   world (``probe.shutdown_distributed``)
3. each member **joins** the barrier (``POST /slice/barrier``) with the
   rendezvous address it would serve if elected; a stale-generation join
   is refused (:class:`StaleGenerationError`), a member resized out of the
   slice is refused (:class:`MembershipRefusedError`) and exits
4. the LAST join completes the barrier into the **federation plan**:
   ordered membership (= ranks), world size, coordinator (member 0's
   address)
5. members run ``probe.initialize_distributed`` with the plan and restore
   the checkpoint resharded onto the new mesh (``drain.restore_sharded``);
   a torn shard or a generation mismatch rolls back to the last-good
   generation — never a partial restore

A member SIGKILLed mid-transition never joins; the barrier stays
incomplete until the control plane moves the generation again, and the
survivors waiting on the stale barrier see it superseded, retarget and
re-form.

Processes: a member is one pod process that drives every device its pod
holds, as the JAX member does (``--local-devices N``). It is a CUDA-free
supervisor (:class:`~.elastic.RankSupervisor`): it polls ``/slicez`` once
per step of its ranks, joins the barrier once per world with the address
its local rank 0 will serve, and for each plan spawns N fresh rank
processes, global ranks ``member index x N + local`` of a world of
``num_processes x N`` (the plan's ``num_processes`` stays the member
count). The ranks build or restore, step, and on an agreed bump drain and
exit; the member then joins the next barrier and spawns the next world's
ranks, which see the GPUs attached since (CUDA fixes a process's device
set at its first CUDA call). A rank that dies takes its member with it.

CLI (one per member process)::

    python -m gpumounter_tpu_torch.torchcheck.federation \\
        --master http://MASTER --group GROUP --member ns/pod \\
        --checkpoint-root /ckpt --status-file out.jsonl \\
        [--local-devices N] [--device cuda]

``--device cpu`` is the hardware-free member mode (N gloo ranks).
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import sys
import time
import urllib.error
import urllib.request

import torch
import torch.distributed as dist

from gpumounter_tpu_torch.torchcheck import elastic as elastic_lib
from gpumounter_tpu_torch.torchcheck import model as model_lib
from gpumounter_tpu_torch.torchcheck import probe as probe_lib
from gpumounter_tpu_torch.torchcheck import resolve_device
from gpumounter_tpu_torch.torchcheck import train as train_lib
from gpumounter_tpu_torch.utils import consts
from gpumounter_tpu_torch.utils.log import get_logger

logger = get_logger("torchcheck.federation")

# THE control plane's stuck-barrier window: members poll with the same
# deadline the master judges stuckness by
DEFAULT_BARRIER_TIMEOUT_S = consts.DEFAULT_RESIZE_BARRIER_TIMEOUT_S


# -- typed protocol errors -----------------------------------------------------


class FederationError(Exception):
    """Base for re-federation protocol failures."""


class StaleGenerationError(FederationError):
    """The barrier refused this member's generation as already
    superseded — the member must retarget to ``current`` (re-observing
    the signal) instead of corrupting the newer world."""

    def __init__(self, message: str, current: int | None = None):
        super().__init__(message)
        self.current = current


class UnknownGenerationError(FederationError):
    """The barrier sits at an OLDER generation than this member
    observed (the master's view is catching up). Not a fault: the member
    keeps its target and re-joins until the master's barrier reaches it
    (or supersedes past it)."""

    def __init__(self, message: str, current: int | None = None):
        super().__init__(message)
        self.current = current


class MembershipRefusedError(FederationError):
    """This member is not part of the barrier's generation — it was
    resized out of the slice and should exit cleanly."""


class BarrierTimeoutError(FederationError):
    """The barrier did not complete within the wait window (a member
    died mid-transition, or the resize stalled)."""


# -- plumbing ------------------------------------------------------------------


def free_port(host: str = "127.0.0.1") -> int:
    """A currently-free TCP port on ``host`` — the rendezvous address a
    member proposes when enrolling (production pods advertise a fixed
    port on the pod IP instead)."""
    with socket.socket() as s:
        s.bind((host, 0))
        return s.getsockname()[1]


def check_local_devices(local_devices: int) -> None:
    """A member drives N >= 1 devices, one rank process each (on the GPU
    :func:`~.probe.select_gpus` also refuses more than its pod's device
    nodes show)."""
    if local_devices < 1:
        raise ValueError(f"a member drives at least one device (got "
                         f"--local-devices {local_devices})")


def configure_cpu_world(local_devices: int = 1) -> torch.device:
    """The hardware-free member mode: this member's ranks compute on the
    CPU and its worlds use gloo. Returns the device."""
    check_local_devices(local_devices)
    return torch.device("cpu")


WorldAgreement = elastic_lib.WorldAgreement


# -- the barrier client --------------------------------------------------------


class BarrierClient:
    """The member side of the master's re-federation barrier
    (``/slice/barrier``, master/slicetxn.py)."""

    def __init__(self, master_base: str, group: str, member: str,
                 timeout_s: float = 5.0):
        self.base = master_base.rstrip("/")
        self.group = group
        self.member = member
        self.timeout_s = timeout_s

    def _request(self, method: str, path: str,
                 body: dict | None = None) -> tuple[int, dict]:
        data = None if body is None else json.dumps(body).encode()
        req = urllib.request.Request(f"{self.base}{path}", data=data,
                                     method=method)
        try:
            with urllib.request.urlopen(req,
                                        timeout=self.timeout_s) as resp:
                return resp.status, json.loads(resp.read() or b"{}")
        except urllib.error.HTTPError as e:
            try:
                return e.code, json.loads(e.read() or b"{}")
            except ValueError:
                return e.code, {}

    def join(self, generation: int, address: str) -> dict:
        """Enroll this member in the barrier for ``generation``. Raises
        the typed refusals; transient transport trouble raises OSError
        for the caller's retry loop."""
        status, payload = self._request(
            "POST", "/slice/barrier",
            {"group": self.group, "generation": int(generation),
             "member": self.member, "address": address})
        if status == 200:
            return payload
        result = payload.get("result", "")
        if result == "StaleGeneration":
            raise StaleGenerationError(
                f"barrier refused generation {generation}: current is "
                f"{payload.get('current')}",
                current=payload.get("current"))
        if result == "UnknownGeneration":
            raise UnknownGenerationError(
                f"barrier has not reached generation {generation} yet "
                f"(at {payload.get('current')})",
                current=payload.get("current"))
        if result == "NotAMember":
            raise MembershipRefusedError(
                f"{self.member} is not in the generation-"
                f"{payload.get('generation', generation)} membership "
                f"{payload.get('members')}")
        if status == 404 and result in ("SliceNotFound",
                                        "BarrierNotFound"):
            # the group itself is gone (torn down as a unit while this
            # member was between worlds): a clean end, like any
            # resized-out member
            raise MembershipRefusedError(
                f"slice group {self.group} no longer exists "
                f"({result}): torn down while re-federating")
        raise OSError(f"barrier join failed: HTTP {status} {payload}")

    def status(self) -> dict | None:
        namespace = self.member.split("/", 1)[0]
        try:
            status, payload = self._request(
                "GET", f"/slice/barrier?group={self.group}"
                       f"&namespace={namespace}")
        except OSError:
            return None
        return payload if status == 200 else None

    def wait(self, generation: int, *, timeout_s: float,
             poll_s: float = 0.2) -> dict:
        """Poll until the barrier for ``generation`` completes; returns
        the federation plan. A barrier that moved PAST the target raises
        :class:`StaleGenerationError` (retarget); never completing
        within ``timeout_s`` raises :class:`BarrierTimeoutError`."""
        deadline = time.monotonic() + timeout_s
        while True:
            payload = self.status()
            if payload is not None:
                current = payload.get("generation")
                if current is not None and int(current) > int(generation):
                    raise StaleGenerationError(
                        f"barrier moved to generation {current} while "
                        f"waiting on {generation}", current=int(current))
                if int(current or -1) == int(generation) \
                        and payload.get("complete"):
                    return payload.get("plan") or {}
            if time.monotonic() >= deadline:
                joined = (payload or {}).get("joined")
                raise BarrierTimeoutError(
                    f"barrier for generation {generation} incomplete "
                    f"after {timeout_s:.0f}s (joined: {joined})")
            time.sleep(poll_s)


class Refederator:
    """Owns one member's transitions between ``torch.distributed``
    worlds: teardown → barrier → initialize-with-the-plan.
    ``barrier=None`` is the single-process mode: the world is torn down
    and a fresh world of one is joined on a new port (the port's
    in-process teardown and re-init; devices are not re-enumerated,
    ``probe.release_backend``). ``device`` is this member's device:
    ``cuda:N`` names its card (without an index the first world's rank
    picks it, and it is kept), ``cpu`` the gloo member mode."""

    def __init__(self, barrier: BarrierClient | None, *,
                 device: str | torch.device = "cuda",
                 bind_host: str = "127.0.0.1",
                 barrier_timeout_s: float = DEFAULT_BARRIER_TIMEOUT_S,
                 hold_dir: str | None = None):
        self.barrier = barrier
        self.device = resolve_device(device)
        self.bind_host = bind_host
        self.barrier_timeout_s = barrier_timeout_s
        # test seam: when set, the member pauses between teardown and
        # barrier join until `<hold_dir>/go-<generation>` exists, after
        # announcing itself via `<hold_dir>/<member>.ready-<generation>`
        # — how the fault-injection e2e lands a SIGKILL deterministically
        # in the mid-resize window
        self.hold_dir = hold_dir
        self.plan: dict | None = None
        self.federated = False

    # -- the transition --------------------------------------------------------

    def refederate(self, generation: int) -> dict | None:
        """Leave the old world and join the new one at ``generation``.
        Returns the federation plan (None in single-process mode).
        Raises :class:`MembershipRefusedError` when this member was
        resized out; internally retargets on supersede (the returned
        plan's ``generation`` is authoritative)."""
        if dist.is_initialized():
            probe_lib.shutdown_distributed()
        else:
            probe_lib.release_backend()
        self.federated = False
        if self.barrier is None:
            self._initialize({
                "coordinator": f"{self.bind_host}:{free_port(self.bind_host)}",
                "num_processes": 1, "members": [None]})
            return None
        plan = self.plan_for(generation)
        self._initialize(plan)
        return plan

    def plan_for(self, generation: int) -> dict:
        """The barrier protocol alone: join the barrier for
        ``generation`` with a rendezvous address on ``bind_host`` (the one
        this member's first rank serves if it is member 0), wait for it to
        complete, and return the plan with its ``generation`` — chasing a
        superseded barrier to the newest generation. Raises
        :class:`MembershipRefusedError` when this member was resized
        out."""
        target = int(generation)
        while True:
            self._hold(target)
            address = f"{self.bind_host}:{free_port(self.bind_host)}"
            try:
                payload = self.join_with_retry(target, address)
                if payload.get("complete"):
                    plan = payload.get("plan") or {}
                else:
                    plan = self.barrier.wait(
                        target, timeout_s=self.barrier_timeout_s)
            except StaleGenerationError as e:
                # the world moved while we were between worlds: chase it
                target = int(e.current) if e.current else target + 1
                logger.warning("barrier superseded mid-join; "
                               "retargeting to generation %d", target)
                continue
            except UnknownGenerationError as e:
                # the master's barrier is BEHIND what we observed: keep
                # the target and re-join until it catches up — never
                # retarget DOWN, that would drain into an old world
                logger.warning("barrier behind (at %s, want %d); "
                               "re-joining shortly", e.current, target)
                time.sleep(0.2)
                continue
            except BarrierTimeoutError:
                # a peer died mid-transition: the control plane will
                # move the generation (repair/resize); keep polling —
                # restoring without the full world would hang anyway
                logger.warning(
                    "barrier for generation %d timed out; re-checking",
                    target)
                continue
            break
        members = list(plan.get("members") or [])
        if self.barrier.member not in members:
            raise MembershipRefusedError(
                f"{self.barrier.member} missing from completed plan "
                f"{members}")
        plan = dict(plan)
        plan["generation"] = target
        self.plan = plan
        return plan

    def join_with_retry(self, generation: int, address: str,
                        attempts: int = 5) -> dict:
        for attempt in range(attempts):
            try:
                return self.barrier.join(generation, address)
            except OSError:
                if attempt == attempts - 1:
                    raise
                time.sleep(0.2 * (attempt + 1))
        raise AssertionError("unreachable")

    def _initialize(self, plan: dict) -> None:
        members = list(plan.get("members") or [])
        member = self.barrier.member if self.barrier else None
        if member not in members:
            raise MembershipRefusedError(
                f"{member} missing from completed plan {members}")
        process_id = members.index(member)
        self.device = probe_lib.initialize_distributed(
            plan["coordinator"], int(plan["num_processes"]), process_id,
            self.device)
        self.federated = True
        logger.info("re-federated as process %d/%d (coordinator %s) on %s",
                    process_id, plan["num_processes"], plan["coordinator"],
                    self.device)

    def _hold(self, generation: int) -> None:
        if not self.hold_dir or self.barrier is None:
            return
        ready = os.path.join(
            self.hold_dir,
            f"{self.barrier.member.replace('/', '--')}"
            f".ready-{generation}")
        go = os.path.join(self.hold_dir, f"go-{generation}")
        with open(ready, "w") as f:
            f.write(str(time.time()))
        while not os.path.exists(go):
            time.sleep(0.05)


# -- the federated harness -----------------------------------------------------


class FederatedElasticHarness(elastic_lib.ShardedElasticHarness):
    """The multi-process :class:`~.elastic.ElasticHarness` in one process
    per world: drain streams per-rank shards, teardown runs the
    re-federation protocol in this process (:class:`Refederator`),
    restore reshards the committed checkpoint onto the new world's mesh
    (:class:`~.elastic.ShardedElasticHarness`). A member's ranks instead
    drain and exit, and the member forms the next world
    (:class:`MemberRunner`)."""

    def __init__(self, cfg, generation_fn, chips_fn, *,
                 refederator: Refederator, checkpoint_root: str,
                 lr: float = 3e-4, step_factory=None,
                 data: int | None = 1, seq: int | None = None,
                 model: int | None = 1, seed: int = 0):
        super().__init__(cfg, generation_fn, chips_fn,
                         checkpoint_root=checkpoint_root, lr=lr,
                         step_factory=step_factory, data=data, seq=seq,
                         model=model, seed=seed,
                         device=refederator.device.type)
        self.refederator = refederator

    def _teardown(self, generation):
        plan = self.refederator.refederate(int(generation))
        self._target_generation = (int(plan["generation"])
                                   if plan else int(generation))
        return self._target_generation


# -- the member process (CLI) --------------------------------------------------


class MemberRunner(elastic_lib.RankSupervisor):
    """One slice member's pod process, end to end: wait for the slice,
    join each generation's barrier once, and run the plan's world through
    ``local_devices`` rank processes (:class:`~.elastic.RankSupervisor`):
    they build or resume, step, and drain on every agreed bump; the member
    exits cleanly when resized out. The status file (JSONL) is the
    observable the multi-process e2e asserts on: steps, losses,
    generations, world sizes (members x N), restore fingerprints.

    The mesh is ``data`` x ``seq`` x ``model`` with the dim left ``None``
    absorbing the world ("seq" by default; "model" for the Megatron
    split); ``step_factory(cfg, mesh)`` (picklable) builds the step."""

    def __init__(self, master_base: str, group: str, member: str,
                 checkpoint_root: str, *, local_devices: int = 1,
                 device: str = "cuda",
                 status_path: str | None = None,
                 stop_path: str | None = None,
                 hold_dir: str | None = None,
                 max_steps: int | None = None,
                 barrier_timeout_s: float = DEFAULT_BARRIER_TIMEOUT_S,
                 lr: float = 1e-2, seq_len: int = 48, batch: int = 4,
                 cfg=None, step_factory=None,
                 data: int | None = 1, seq: int | None = None,
                 model: int | None = 1, dev_root: str = "/dev",
                 proc_root: str = "/proc"):
        check_local_devices(local_devices)
        cfg = cfg or model_lib.ModelConfig(
            vocab=64, d_model=32, n_heads=4, n_layers=1, d_ff=64)
        super().__init__(
            member, cfg, elastic_lib.MasterSliceSignal(master_base, group),
            checkpoint_root, device=str(device),
            batches=elastic_lib.SeededBatches(batch, seq_len, cfg.vocab),
            status_path=status_path, stop_path=stop_path,
            max_steps=max_steps, lr=lr,
            step_factory=step_factory or _default_step_factory, data=data,
            seq=seq, model=model, dev_root=dev_root, proc_root=proc_root)
        if self.on_gpu:      # refuse now: no GPU, or fewer than N
            probe_lib.select_gpus(self.device, local_devices, dev_root,
                                  proc_root)
        self.master_base = master_base
        self.group = group
        self.member = member
        self.local_devices = local_devices
        self.barrier_timeout_s = barrier_timeout_s
        # the barrier protocol only: this process joins no world itself
        self.refederator = Refederator(
            BarrierClient(master_base, group, member), device="cpu",
            barrier_timeout_s=barrier_timeout_s, hold_dir=hold_dir)

    def run(self) -> int:
        """Returns the process exit code: 0 once stopped, done or resized
        out, 1 when a world failed (a rank died: ``error`` names each
        rank's exit code and signal), 2 when the slice never appeared.
        Any other exception is logged to the status file (the e2e reads
        it, not stderr) and raised."""
        try:
            return self._run()
        except elastic_lib.WorldFailedError:
            return 1
        except Exception as e:
            self._log("error", message=repr(e))
            raise

    def _run(self) -> int:
        generation = self._wait_for_generation(self.barrier_timeout_s)
        if generation is None:
            self._log("error", message="slice never appeared")
            return 2
        target = int(generation)
        n = self.local_devices
        while True:
            try:
                plan = self.refederator.plan_for(target)
            except MembershipRefusedError:
                self._log("resized_out", generation=target,
                          drain=(self._drained or {}).get("drain"))
                return 0
            index = plan["members"].index(self.member)
            world = int(plan["num_processes"]) * n
            generation = int(plan["generation"])
            spec = self._spec(generation, world,
                              expect_generation=generation)
            outcome = self._run_world(
                spec, n, world_size=world, rank_offset=index * n,
                rendezvous=plan["coordinator"])
            if outcome["outcome"] != "drained":
                self._log(outcome["outcome"], step=outcome["step"])
                return 0
            target = int(outcome["generation"])


def _default_step_factory(cfg, mesh):
    """The flagship sharded train step over the member mesh
    (``train.make_train_step``: ring attention over ``seq``)."""
    return train_lib.make_train_step(cfg, mesh)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--master", required=True,
                        help="master base URL (http://host:port)")
    parser.add_argument("--group", required=True,
                        help="slice group id (from /addtpuslice)")
    parser.add_argument("--member", required=True, metavar="NS/POD",
                        help="this member's pod key")
    parser.add_argument("--checkpoint-root", required=True,
                        help="shared sharded-checkpoint directory")
    parser.add_argument("--local-devices", type=int, default=1,
                        help="devices this member's pod drives, one rank "
                             "process each (at most the GPUs its device "
                             "nodes show)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the pod's GPUs), cuda:i[,j...] (named "
                             "by their place among them), or cpu (the "
                             "hardware-free gloo mode)")
    parser.add_argument("--dev-root", default="/dev",
                        help="where nvidiaN device nodes live")
    parser.add_argument("--status-file", default=None)
    parser.add_argument("--stop-file", default=None)
    parser.add_argument("--hold-dir", default=None,
                        help="fault-injection seam: pause before every "
                             "barrier join until go-<gen> appears here")
    parser.add_argument("--max-steps", type=int, default=None)
    parser.add_argument("--barrier-timeout", type=float,
                        default=DEFAULT_BARRIER_TIMEOUT_S)
    parser.add_argument("--lr", type=float, default=1e-2)
    parser.add_argument("--seq-len", type=int, default=48)
    args = parser.parse_args(argv)
    try:
        check_local_devices(args.local_devices)
        runner = MemberRunner(
            args.master, args.group, args.member, args.checkpoint_root,
            local_devices=args.local_devices, device=args.device,
            status_path=args.status_file, stop_path=args.stop_file,
            hold_dir=args.hold_dir, max_steps=args.max_steps,
            barrier_timeout_s=args.barrier_timeout, lr=args.lr,
            seq_len=args.seq_len, dev_root=args.dev_root)
    except ValueError as e:
        parser.error(str(e))
    return runner.run()


if __name__ == "__main__":
    sys.exit(main())
