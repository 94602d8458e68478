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

Departure from the JAX member: a port member is ONE process on ONE device
(NCCL on its card, or gloo on the CPU). A pod's device count is its
member count, so ``--local-devices`` must be 1.

CLI (one per member process)::

    python -m gpumounter_tpu_torch.torchcheck.federation \\
        --master http://MASTER --group GROUP --member ns/pod \\
        --checkpoint-root /ckpt --status-file out.jsonl [--device cuda:N]

``--device cpu`` is the hardware-free member mode (gloo).
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

from gpumounter_tpu_torch.torchcheck import drain as drain_lib
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
    """A port member is one process on one device: a pod with N devices
    runs N members."""
    if local_devices != 1:
        raise ValueError(
            f"a member drives exactly one device (got --local-devices "
            f"{local_devices}); run one member process per device")


def configure_cpu_world(local_devices: int = 1) -> torch.device:
    """The hardware-free member mode: this member computes on the CPU and
    its worlds use gloo (``probe.initialize_distributed`` with
    ``device="cpu"``). Returns the device."""
    check_local_devices(local_devices)
    return torch.device("cpu")


class WorldAgreement:
    """Collective agreement on an observed value: every process
    contributes what it read and the MINIMUM wins (an all-reduce MIN of
    an int64), so no process begins draining while a peer that has not
    yet seen the bump is about to block in a training-step collective.
    The tensor lives on the member's device (NCCL reduces CUDA tensors
    only). A world of one: the identity."""

    def agree(self, value: int) -> int:
        if not dist.is_initialized() or dist.get_world_size() <= 1:
            return int(value)
        device = (torch.device("cuda", torch.cuda.current_device())
                  if dist.get_backend() == "nccl" else torch.device("cpu"))
        x = torch.tensor([int(value)], dtype=torch.int64, device=device)
        dist.all_reduce(x, op=dist.ReduceOp.MIN)
        return int(x.item())


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
        self._initialize(plan)
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


class FederatedElasticHarness(elastic_lib.ElasticHarness):
    """The multi-process :class:`~.elastic.ElasticHarness`: drain streams
    per-process shards (``drain.drain_sharded``), teardown runs the
    re-federation protocol (:class:`Refederator`), restore reshards the
    committed checkpoint onto the new world's mesh — falling back to the
    last-good generation on any typed checkpoint failure, never a
    partial tree."""

    def __init__(self, cfg, generation_fn, chips_fn, *,
                 refederator: Refederator, checkpoint_root: str,
                 lr: float = 3e-4, step_factory=None,
                 data: int | None = 1, seq: int | None = None,
                 model: int | None = 1, seed: int = 0):
        super().__init__(cfg, generation_fn, chips_fn, lr=lr,
                         step_factory=step_factory, reinitialize=None,
                         checkpoint_path=os.path.join(
                             checkpoint_root, "legacy.ckpt"),
                         data=data, seq=seq, model=model, seed=seed,
                         device=refederator.device.type)
        self.refederator = refederator
        self.checkpoint_root = checkpoint_root
        self.restored_generation: int | None = None
        self.rolled_back = False
        self._target_generation: int | None = None
        self.timings: dict[str, dict] = {}

    # -- hooks -----------------------------------------------------------------

    def _resumable(self) -> bool:
        return drain_lib.latest_generation(self.checkpoint_root) \
            is not None

    def _sync_fn(self):
        """The world's barrier, for ``drain_sharded`` (None in a world
        of one); under NCCL on this rank's current device."""
        if not dist.is_initialized() or dist.get_world_size() <= 1:
            return None
        if dist.get_backend() != "nccl":
            return dist.barrier
        return lambda: dist.barrier(
            device_ids=[torch.cuda.current_device()])

    def _drain(self, generation) -> None:
        self.timings["drain"] = {}
        drain_lib.drain_sharded(
            train_lib.state_tree(self.state), self.checkpoint_root,
            int(generation), specs=elastic_lib.state_specs(self.cfg),
            mesh=self.mesh, sync_fn=self._sync_fn(),
            timings=self.timings["drain"])

    def _teardown(self, generation):
        plan = self.refederator.refederate(int(generation))
        self._target_generation = (int(plan["generation"])
                                   if plan else int(generation))
        return self._target_generation

    def _restore(self, specs):
        self.rolled_back = False
        self.timings["restore"] = {}
        try:
            tree = drain_lib.restore_sharded(
                self.checkpoint_root, specs, mesh=self.mesh,
                device=self.device,
                expect_generation=self._target_generation,
                timings=self.timings["restore"])
            self.restored_generation = drain_lib.latest_generation(
                self.checkpoint_root)
            return tree
        except drain_lib.NoCheckpointError:
            raise
        except drain_lib.CheckpointError as e:
            # torn shard / corrupt manifest / generation mismatch: the
            # LAST-GOOD generation is the rollback target — restored
            # whole or not at all
            logger.warning("checkpoint restore failed (%s); rolling "
                           "back to the last-good generation", e)
            tree, generation = drain_lib.restore_last_good(
                self.checkpoint_root, specs, mesh=self.mesh,
                device=self.device)
            self.restored_generation = generation
            self.rolled_back = True
            return tree


# -- the member process (CLI) --------------------------------------------------


class MemberRunner:
    """One slice member's training process, end to end: wait for the
    slice, federate, (resume-)restore, then step — reshaping through
    the full protocol on every generation bump, exiting cleanly when
    resized out. The status file (JSONL, one object per event) is the
    observable the multi-process e2e asserts on: steps, losses,
    generations, world sizes, restore fingerprints.

    The mesh is ``data`` x ``seq`` x ``model`` with the dim left ``None``
    absorbing the world ("seq" by default; "model" for the Megatron
    split); ``step_factory(cfg, mesh)`` builds the step."""

    def __init__(self, master_base: str, group: str, member: str,
                 checkpoint_root: str, *, local_devices: int = 1,
                 device: str | torch.device = "cuda",
                 status_path: str | None = None,
                 stop_path: str | None = None,
                 hold_dir: str | None = None,
                 max_steps: int | None = None,
                 barrier_timeout_s: float = DEFAULT_BARRIER_TIMEOUT_S,
                 lr: float = 1e-2, seq_len: int = 48, batch: int = 4,
                 cfg=None, step_factory=None,
                 data: int | None = 1, seq: int | None = None,
                 model: int | None = 1):
        check_local_devices(local_devices)
        self.master_base = master_base
        self.group = group
        self.member = member
        self.checkpoint_root = checkpoint_root
        self.device = resolve_device(device)
        self.status_path = status_path
        self.stop_path = stop_path
        self.hold_dir = hold_dir
        self.max_steps = max_steps
        self.barrier_timeout_s = barrier_timeout_s
        self.lr = lr
        self.seq_len = seq_len
        self.batch = batch
        self.cfg = cfg or model_lib.ModelConfig(
            vocab=64, d_model=32, n_heads=4, n_layers=1, d_ff=64)
        self.step_factory = step_factory
        self.dims = {"data": data, "seq": seq, "model": model}
        self.signal = elastic_lib.MasterSliceSignal(master_base, group)
        self.agreement = WorldAgreement()

    def _log(self, phase: str, **fields) -> None:
        record = {"member": self.member, "phase": phase,
                  "unix": round(time.time(), 3), **fields}
        if self.status_path:
            with open(self.status_path, "a") as f:
                f.write(json.dumps(record) + "\n")
                f.flush()
        logger.info("member %s: %s %s", self.member, phase, fields)

    def _fingerprint(self, state) -> float:
        # embed is replicated: every rank holds all of it
        return float(state.model.embed.detach().float().abs().sum())

    def _batch(self, step: int):
        generator = torch.Generator().manual_seed(7_000_003 + step)
        return train_lib.make_batch(generator, self.batch, self.seq_len,
                                    self.cfg.vocab)

    def _stopping(self) -> bool:
        """Whether any member saw the stop file: decided collectively, so
        every member leaves at the same loop top and none is left in a
        collective with a peer that exited."""
        seen = bool(self.stop_path and os.path.exists(self.stop_path))
        return self.agreement.agree(0 if seen else 1) == 0

    def run(self) -> int:
        """Returns the process exit code; an exception is logged to the
        status file (the e2e reads it, not stderr) and raised."""
        try:
            return self._run()
        except Exception as e:
            self._log("error", message=repr(e))
            raise
        finally:
            probe_lib.shutdown_distributed()

    def _run(self) -> int:
        deadline = time.monotonic() + self.barrier_timeout_s
        generation = None
        while generation is None:
            generation = self.signal.generation()
            if generation is None:
                if time.monotonic() >= deadline:
                    self._log("error", message="slice never appeared")
                    return 2
                time.sleep(0.2)
        refederator = Refederator(
            BarrierClient(self.master_base, self.group, self.member),
            device=self.device, barrier_timeout_s=self.barrier_timeout_s,
            hold_dir=self.hold_dir)
        harness = FederatedElasticHarness(
            self.cfg, self.signal.generation, self.signal.chips,
            refederator=refederator, checkpoint_root=self.checkpoint_root,
            lr=self.lr, step_factory=self.step_factory
            or _default_step_factory, **self.dims)
        try:
            plan = refederator.refederate(int(generation))
        except MembershipRefusedError:
            self._log("resized_out", generation=int(generation))
            return 0
        harness.generation = plan["generation"] if plan \
            else int(generation)
        harness._target_generation = int(harness.generation)
        harness._build(fresh=not harness._resumable())
        self._log("started", generation=int(harness.generation),
                  world_devices=int(harness.mesh.size()),
                  resumed=bool(harness.restored_generation is not None),
                  restored_generation=harness.restored_generation,
                  fingerprint=self._fingerprint(harness.state))
        steps = 0
        while True:
            if self._stopping():
                self._log("stopped", step=int(harness.state.step))
                return 0
            observed = self.signal.generation() or harness.generation
            agreed = self.agreement.agree(int(observed))
            if agreed > int(harness.generation):
                before = self._fingerprint(harness.state)
                self._log("reshape_begin", target=agreed,
                          step=int(harness.state.step),
                          fingerprint=before)
                try:
                    harness.reshape(agreed)
                except MembershipRefusedError:
                    self._log("resized_out", generation=agreed,
                              drain=harness.timings.get("drain"))
                    return 0
                self._log("reshape_done",
                          generation=int(harness.generation),
                          world_devices=int(harness.mesh.size()),
                          restored_generation=harness.
                          restored_generation,
                          rolled_back=harness.rolled_back,
                          step=int(harness.state.step),
                          fingerprint=self._fingerprint(harness.state),
                          timings=harness.timings)
                # re-enter at the loop top: EVERY member's first
                # collective in a new world must be the agreement — a
                # survivor jumping straight into the train step while a
                # fresh member runs its first agreement would cross
                # collectives and deadlock
                continue
            loss = harness.train_step(self._batch(int(harness.state.step)))
            steps += 1
            self._log("step", step=int(harness.state.step), loss=loss,
                      generation=int(harness.generation),
                      world_devices=int(harness.mesh.size()))
            if self.max_steps is not None and steps >= self.max_steps:
                self._log("done", step=int(harness.state.step))
                return 0


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
                        help="devices this member drives: must be 1 (one "
                             "member process per device)")
    parser.add_argument("--device", default="cuda",
                        help="this member's device: cuda, cuda:N, or cpu "
                             "(the hardware-free gloo mode)")
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
    except ValueError as e:
        parser.error(str(e))
    if torch.device(args.device).type == "cpu":
        configure_cpu_world(args.local_devices)
    runner = MemberRunner(
        args.master, args.group, args.member, args.checkpoint_root,
        local_devices=args.local_devices, device=args.device,
        status_path=args.status_file, stop_path=args.stop_file,
        hold_dir=args.hold_dir, max_steps=args.max_steps,
        barrier_timeout_s=args.barrier_timeout, lr=args.lr,
        seq_len=args.seq_len)
    return runner.run()


if __name__ == "__main__":
    sys.exit(main())
