"""Elastic mesh harness, on PyTorch: a training loop that survives live
slice resizes.

Counterpart of :mod:`gpumounter_tpu.jaxcheck.elastic`. The control plane's
``POST /slice/resize`` attaches or detaches whole hosts of a running slice
and bumps the slice's **mesh generation** once the new device set is fully
actuated. Between training steps the harness polls a generation signal,
and on a bump runs the safe reshape sequence of :mod:`.drain`:

    1. drain the state tree        — tensors → host, checkpointed
    2. teardown                    — the injected ``reinitialize`` (a
                                     process-group teardown and re-init;
                                     ``federation.py`` runs the whole
                                     multi-process protocol here)
    3. rebuild mesh + train step   — over the CURRENT world
    4. restore                     — resharded onto the new mesh

so the trajectory continues: same parameters, same AdamW moments and step
counts, same step counter, laid out over another number of devices.

Processes: a rank process drives one device, and a harness's devices
are its ``torch.distributed`` world, so inside a rank the chip count the
signal reports must equal the world size
(:meth:`ElasticHarness._current_mesh`). What the JAX harness does in one
process — growing from 4 devices to 8 and back — a pod process does as a
CUDA-free supervisor of rank processes (:class:`ElasticSupervisor`, the
barrier-less ride): on each agreed bump its ranks drain and exit, and it
spawns a rank per chip of the new count, which restore and continue.
CUDA fixes a process's device set at its first CUDA call, so only a fresh
process sees GPUs attached since; the supervisor itself never touches
CUDA. Across pods, ``federation.py`` adds the control plane's barrier.

Generation signals: :class:`MasterSliceSignal` (the master's ``/slicez``)
or :func:`read_generation_file` / :class:`FileSignal` (the file the worker
stamps on every actuation), as in the JAX package.

Resharding needs no template init: every leaf's spec is static
(:func:`state_specs`), and restore keeps each rank's slice of it.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import multiprocessing
import os
import queue
import tempfile
import time
import urllib.error
import urllib.request
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

from gpumounter_tpu_torch.torchcheck import dist as dist_lib
from gpumounter_tpu_torch.torchcheck import drain as drain_lib
from gpumounter_tpu_torch.torchcheck import model as model_lib
from gpumounter_tpu_torch.torchcheck import resolve_device
from gpumounter_tpu_torch.torchcheck import train as train_lib
from gpumounter_tpu_torch.utils.log import get_logger

logger = get_logger("torchcheck.elastic")


# -- generation signals --------------------------------------------------------


def read_generation_file(path: str) -> dict | None:
    """The worker-stamped notification file: {"generation": <unix>,
    "chips": [...]}, or None when it does not exist yet (no actuation
    has touched this pod)."""
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


class FileSignal:
    """Generation + chip count from the worker's notification file."""

    def __init__(self, path: str):
        self.path = path

    def generation(self):
        payload = read_generation_file(self.path)
        return None if payload is None else payload.get("generation")

    def chips(self) -> int:
        payload = read_generation_file(self.path) or {}
        return len(payload.get("chips") or [])


class MasterSliceSignal:
    """Generation + chip count for one slice group from the master's
    ``/slicez`` view. ``None`` generation = the group is unknown (not
    attached yet, or the master is unreachable) — the harness treats
    that as "no change"."""

    def __init__(self, master_base: str, group: str,
                 timeout_s: float = 5.0):
        self.base = master_base.rstrip("/")
        self.group = group
        self.timeout_s = timeout_s

    def _fetch(self) -> dict | None:
        try:
            with urllib.request.urlopen(f"{self.base}/slicez",
                                        timeout=self.timeout_s) as resp:
                payload = json.loads(resp.read())
        except (urllib.error.URLError, OSError, ValueError):
            return None
        return (payload.get("groups") or {}).get(self.group)

    def generation(self):
        group = self._fetch()
        return None if group is None else group.get("generation")

    def chips(self) -> int:
        group = self._fetch() or {}
        return int(group.get("chips") or 0)


# -- resharding ----------------------------------------------------------------


def state_specs(cfg: model_lib.ModelConfig) -> dict:
    """The spec of every leaf of the state tree (``train`` module
    docstring): a parameter's from :func:`~.model.param_shardings`, each
    AdamW moment its parameter's, the AdamW step counts replicated
    (``()``), and the step counter, a host integer, ``None`` (restored as
    it is). What ``drain.restore_sharded`` reshards a checkpoint onto."""
    params = model_lib.param_shardings(cfg)
    return {"params": params,
            "opt": {name: {"exp_avg": spec, "exp_avg_sq": spec, "step": ()}
                    for name, spec in params.items()},
            "step": None}


# -- the harness ---------------------------------------------------------------


class ElasticHarness:
    """Owns a train state + step over the current world's mesh and
    reshapes both when the generation signal moves.

    ``generation_fn`` / ``chips_fn``: the signal (see FileSignal /
    MasterSliceSignal). ``step_factory(cfg, mesh)`` builds the step
    (default: the flagship sharded step, ring attention over ``seq``).
    ``reinitialize``: the teardown between drain and restore (for a
    single process, ``probe.shutdown_distributed`` then
    ``probe.initialize_distributed`` of a world of one; None keeps the
    world). ``data``/``seq``/``model`` size the mesh dims; the one left
    ``None`` absorbs the chip count ("seq" by default, as in the JAX
    harness; "model" gives the Megatron split)."""

    def __init__(self, cfg: model_lib.ModelConfig,
                 generation_fn: Callable[[], Any],
                 chips_fn: Callable[[], int], *,
                 lr: float = 3e-4,
                 step_factory: Callable | None = None,
                 reinitialize: Callable[[], None] | None = None,
                 checkpoint_path: str | None = None,
                 data: int | None = 1, seq: int | None = None,
                 model: int | None = 1, seed: int = 0,
                 device: str | torch.device = "cuda"):
        if [data, seq, model].count(None) != 1:
            raise ValueError("exactly one of data/seq/model must be None "
                             "(the mesh dim that absorbs the chip count)")
        self.cfg = cfg
        self.generation_fn = generation_fn
        self.chips_fn = chips_fn
        self.lr = lr
        self.step_factory = step_factory or (
            lambda c, mesh: train_lib.make_train_step(c, mesh))
        self.reinitialize = reinitialize
        if checkpoint_path is None:
            fd, checkpoint_path = tempfile.mkstemp(suffix=".elastic.ckpt")
            os.close(fd)
        self.checkpoint_path = checkpoint_path
        self.dims = {"data": data, "seq": seq, "model": model}
        self.seed = seed
        self.device = resolve_device(device)
        self.mesh = None
        self.state: train_lib.TrainState | None = None
        self.step_fn = None
        self.generation = None
        self.reshapes = 0

    # -- lifecycle -------------------------------------------------------------

    def start(self, resume: bool = False) -> "ElasticHarness":
        """Initialise state + step over the current world; records the
        current generation as the baseline. ``resume=True`` restores from
        an existing checkpoint instead of a fresh init when one is present
        — the crash-between-drain-and-restore recovery path: the
        checkpoint was the sole surviving copy, and the next boot picks
        the restore back up rather than resetting the trajectory."""
        self.generation = self.generation_fn()
        self._build(fresh=not (resume and self._resumable()))
        return self

    def _resumable(self) -> bool:
        """Whether a checkpoint exists to resume from (subclasses with
        other formats override)."""
        return os.path.exists(self.checkpoint_path) \
            and os.path.getsize(self.checkpoint_path) > 0

    def _current_mesh(self):
        chips = int(self.chips_fn())
        world = dist.get_world_size() if dist.is_initialized() else 1
        if chips != world:
            raise RuntimeError(
                f"slice reports {chips} chips but this world has {world} "
                "process(es), one per device — attach/visibility mismatch")
        known = 1
        for size in self.dims.values():
            known *= size or 1
        if chips % known:
            raise RuntimeError(f"{chips} devices do not divide over the "
                               f"fixed mesh dims {self.dims}")
        sizes = {name: chips // known if size is None else size
                 for name, size in self.dims.items()}
        return model_lib.make_mesh(**sizes, device=self.device)

    def _build(self, fresh: bool) -> None:
        self.mesh = self._current_mesh()
        self.step_fn = self.step_factory(self.cfg, self.mesh)
        if fresh:
            self.state = train_lib.init_state(self.cfg, self.seed,
                                              self.device, self.mesh,
                                              self.lr)
        else:
            tree = self._restore(state_specs(self.cfg))
            self.state = train_lib.state_from_tree(self.cfg, tree,
                                                   self.device, self.lr)
        logger.info("elastic mesh %s over %d device(s)%s",
                    dict(zip(self.mesh.mesh_dim_names, self.mesh.shape)),
                    self.mesh.size(),
                    "" if fresh else " (restored from checkpoint)")

    # -- reshape ---------------------------------------------------------------

    def poll(self) -> bool:
        """Between-steps check: if the generation moved, run the drain →
        teardown → rebuild → restore sequence. Returns True when a
        reshape happened."""
        generation = self.generation_fn()
        if generation is None or generation == self.generation:
            return False
        self.reshape(generation)
        return True

    def reshape(self, generation=None) -> None:
        old = self.mesh.size() if self.mesh is not None else 0
        if generation is None:
            generation = self.generation_fn()
        self._drain(generation)
        # release every reference into the old world BEFORE leaving it
        self.state = None
        self.step_fn = None
        self.mesh = None
        # a teardown may retarget (the federated harness chases a
        # superseded barrier to the newest generation)
        generation = self._teardown(generation) or generation
        self._build(fresh=False)
        self.generation = generation
        self.reshapes += 1
        logger.info("reshaped %d -> %d devices at generation %r", old,
                    self.mesh.size(), self.generation)

    # -- reshape hooks (overridden by the multi-process federation
    # harness, federation.py) -------------------------------------------------

    def _drain(self, generation) -> None:
        """Checkpoint the live state before the world drops (default: the
        legacy single-file atomic pickle)."""
        drain_lib.drain(train_lib.state_tree(self.state),
                        self.checkpoint_path)

    def _teardown(self, generation) -> None:
        """Drop the old world (default: the injected ``reinitialize``;
        None keeps the world)."""
        if self.reinitialize is not None:
            self.reinitialize()

    def _restore(self, specs) -> dict:
        """Checkpoint → this rank's state tree on the CURRENT mesh."""
        return drain_lib.restore(self.checkpoint_path, specs,
                                 mesh=self.mesh, device=self.device)

    # -- training --------------------------------------------------------------

    def place_tokens(self, host_tokens) -> torch.Tensor:
        """Host token batch [B, T] → this rank's (data, seq) shard on the
        harness's device."""
        if not isinstance(host_tokens, torch.Tensor):
            host_tokens = torch.from_numpy(np.array(host_tokens))
        return dist_lib.shard(host_tokens.long(), self.mesh,
                              ("data", "seq")).to(self.device)

    def train_step(self, host_tokens) -> float:
        """One step over the current mesh (poll() first if reshapes
        should be picked up between steps — kept separate so callers
        control when a reshape may interrupt)."""
        self.state, loss = self.step_fn(self.state,
                                        self.place_tokens(host_tokens))
        return float(loss)

    def close(self) -> None:
        if os.path.exists(self.checkpoint_path):
            os.unlink(self.checkpoint_path)


# -- sharded drains and the world's agreement ---------------------------------


class WorldAgreement:
    """Collective agreement on an observed value: every process
    contributes what it read and the MINIMUM wins (an all-reduce MIN of
    an int64, or a float64 for a float such as the worker's unix-time
    generation), so no process begins draining while a peer that has not
    yet seen the bump is about to block in a training-step collective.
    The tensor lives on the rank's device (NCCL reduces CUDA tensors
    only). A world of one: the identity."""

    def agree(self, value):
        if not dist.is_initialized() or dist.get_world_size() <= 1:
            return value
        device = (torch.device("cuda", torch.cuda.current_device())
                  if dist.get_backend() == "nccl" else torch.device("cpu"))
        as_float = isinstance(value, float)
        x = torch.tensor([value], device=device,
                         dtype=torch.float64 if as_float else torch.int64)
        dist.all_reduce(x, op=dist.ReduceOp.MIN)
        return float(x.item()) if as_float else int(x.item())


class ShardedElasticHarness(ElasticHarness):
    """The :class:`ElasticHarness` of a world of ranks: drain streams
    per-rank shards (``drain.drain_sharded``, one shard file per rank of
    the world), restore reshards the committed checkpoint onto the current
    world's mesh — falling back to the last-good generation on any typed
    checkpoint failure, never a partial tree. ``_target_generation``, when
    set, is the generation a restore must find."""

    def __init__(self, cfg, generation_fn, chips_fn, *,
                 checkpoint_root: str, lr: float = 3e-4, step_factory=None,
                 data: int | None = 1, seq: int | None = None,
                 model: int | None = 1, seed: int = 0,
                 device: str | torch.device = "cuda"):
        super().__init__(cfg, generation_fn, chips_fn, lr=lr,
                         step_factory=step_factory, reinitialize=None,
                         checkpoint_path=os.path.join(checkpoint_root,
                                                      "legacy.ckpt"),
                         data=data, seq=seq, model=model, seed=seed,
                         device=device)
        self.checkpoint_root = checkpoint_root
        self.restored_generation: int | None = None
        self.rolled_back = False
        self._target_generation: int | None = None
        self.timings: dict[str, dict] = {}

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
            int(generation), specs=state_specs(self.cfg),
            mesh=self.mesh, sync_fn=self._sync_fn(),
            timings=self.timings["drain"])

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


def leaf_digests(state: train_lib.TrainState, cfg: model_lib.ModelConfig,
                 mesh) -> dict[str, str]:
    """SHA-256 of every leaf's whole value (its shards gathered over the
    mesh, so a collective: every rank calls it), by path. Equal digests
    before a drain and after a restore mean the state came back bit for
    bit, whatever the sizes of the two worlds."""
    out: dict[str, str] = {}

    def visit(node, spec, path):
        if isinstance(node, dict):
            for key in sorted(node):
                visit(node[key], spec[key], f"{path}/{key}")
            return
        if not isinstance(node, torch.Tensor):
            out[path] = hashlib.sha256(repr(node).encode()).hexdigest()
            return
        whole = dist_lib.unshard(node, mesh, spec).contiguous().cpu()
        digest = hashlib.sha256(
            f"{whole.dtype}{tuple(whole.shape)}".encode())
        bits = whole.view(torch.int16) if whole.element_size() == 2 \
            else whole
        digest.update(bits.reshape(-1).numpy().view(np.uint8))
        out[path] = digest.hexdigest()

    visit(train_lib.state_tree(state), state_specs(cfg), "")
    return out


def fingerprint(state: train_lib.TrainState) -> float:
    """A float a status record carries to compare two states: the sum of
    the absolute embedding (replicated: every rank holds all of it)."""
    return float(state.model.embed.detach().float().abs().sum())


# -- the ranks of a pod process -----------------------------------------------


@dataclasses.dataclass
class SeededBatches:
    """The token batch of step ``i``: drawn from a generator seeded with
    ``SEED + i``, so that every rank of every world draws the same."""
    SEED = 7_000_003
    batch: int
    seq_len: int
    vocab: int

    def __call__(self, step: int) -> torch.Tensor:
        generator = torch.Generator().manual_seed(self.SEED + step)
        return train_lib.make_batch(generator, self.batch, self.seq_len,
                                    self.vocab)


@dataclasses.dataclass
class RideSpec:
    """What each rank of one world needs (picklable: it goes to spawned
    processes). ``generation``: the generation the world was formed at;
    ``chips``: the device count it was formed for (its world size);
    ``expect_generation``: the checkpoint generation a restore must find
    (None: the latest); ``drain_generation``: the checkpoint generation a
    bump drains into (None: the agreed generation); ``max_steps``: the
    steps this world may take (None: no limit); ``verify``: digest every
    leaf before the drain and after the restore, and take one reference
    step after the drain (a check that costs a pass over the state)."""
    cfg: model_lib.ModelConfig
    checkpoint_root: str
    generation: Any
    chips: int
    batches: Callable[[int], Any]
    lr: float = 3e-4
    dims: dict = dataclasses.field(
        default_factory=lambda: {"data": 1, "seq": None, "model": 1})
    step_factory: Callable | None = None
    expect_generation: int | None = None
    drain_generation: int | None = None
    max_steps: int | None = None
    verify: bool = False


class RankControl:
    """The channel between a pod process and its ranks for one world.
    The ranks' lead (local rank 0) reports each step; the pod process
    answers each with ONE read of the generation and the stop request,
    and every local rank waits for that answer at its next loop top, so
    no rank reads the master or the signal file itself. Made by the pod
    process and handed to the ranks as they start (``LocalWorld``'s
    ``shared``)."""

    def __init__(self):
        ctx = multiprocessing.get_context("spawn")
        self.reports = ctx.Queue()
        # the step answered, the generation, the stop request
        self.answer = ctx.Array("d", [-1.0, 0.0, 0.0])

    # -- the ranks' side ----------------------------------------------------

    def report(self, record: dict) -> None:
        self.reports.put(record)

    def wait_answer(self, step: int):
        """Block until the pod process has answered the report of
        ``step``; returns (generation, stop)."""
        while True:
            with self.answer.get_lock():
                answered, generation, stop = self.answer[:]
            if answered >= step:
                return generation, bool(stop)
            time.sleep(0.001)

    # -- the pod process's side -----------------------------------------------

    def next_report(self, timeout_s: float) -> dict | None:
        try:
            return (self.reports.get(timeout=timeout_s) if timeout_s > 0
                    else self.reports.get_nowait())
        except queue.Empty:
            return None

    def reply(self, step: int, generation, stop: bool) -> None:
        with self.answer.get_lock():
            self.answer[:] = [float(step), float(generation),
                              1.0 if stop else 0.0]

    def close(self) -> None:
        dist_lib._close(self.reports)


def ride_rank(device: torch.device, control: RankControl,
              spec: RideSpec) -> dict:
    """One rank of a pod process's world: build the state or restore it
    resharded onto this world, then step until the world agrees on a stop,
    on a bump (drain and return) or on ``max_steps``. Every loop top waits
    for the pod process's answer to the last report; the world's first
    collectives are the check that every pod drives the same number of
    devices, and then the agreement. Returns the outcome (``stopped``,
    ``drained`` or ``done``) with the step and, after a drain, its
    timings."""
    dist_lib.check_local_sizes()
    harness = ShardedElasticHarness(
        spec.cfg, lambda: spec.generation, lambda: spec.chips,
        checkpoint_root=spec.checkpoint_root, lr=spec.lr,
        step_factory=spec.step_factory, device=device, **spec.dims)
    harness.generation = spec.generation
    harness._target_generation = spec.expect_generation
    harness._build(fresh=not harness._resumable())
    built = time.time()
    lead = os.environ.get("LOCAL_RANK", "0") == "0"
    where = {"generation": spec.generation,
             "world_devices": int(harness.mesh.size())}

    def report(phase: str, **fields) -> None:
        if lead:
            control.report({"phase": phase, "unix": time.time(), **where,
                            **fields})

    started = {"step": int(harness.state.step),
               "fingerprint": fingerprint(harness.state),
               "restored_generation": harness.restored_generation,
               "rolled_back": harness.rolled_back,
               "restore": harness.timings.get("restore"),
               "startup": dict(dist_lib.STARTUP, built=built),
               "pid": os.getpid(),
               "device": str(device)}
    if device.type == "cuda":
        started["uuid"] = str(torch.cuda.get_device_properties(device).uuid)
    if spec.verify and harness.restored_generation is not None:
        started["digests"] = leaf_digests(harness.state, spec.cfg,
                                          harness.mesh)
    report("started", **started)
    agreement = WorldAgreement()
    steps = 0
    while True:
        step = int(harness.state.step)
        generation, stop = control.wait_answer(step)
        if agreement.agree(0 if stop else 1) == 0:
            return {"outcome": "stopped", "step": step}
        if isinstance(spec.generation, int):
            generation = int(generation)
        agreed = agreement.agree(generation)
        if agreed > harness.generation:
            begin = {"target": agreed, "step": step,
                     "fingerprint": fingerprint(harness.state)}
            if spec.verify:
                begin["digests"] = leaf_digests(harness.state, spec.cfg,
                                                harness.mesh)
            report("reshape_begin", **begin)
            began = time.time()
            harness._drain(spec.drain_generation or agreed)
            outcome = {"outcome": "drained", "generation": agreed,
                       "step": step, "drain": harness.timings["drain"],
                       "drain_began": began, "drained": time.time()}
            if spec.verify:     # the uninterrupted step, for the check
                outcome["reference_loss"] = harness.train_step(
                    spec.batches(step))
            outcome["exiting"] = time.time()
            return outcome
        loss = harness.train_step(spec.batches(step))
        steps += 1
        report("step", step=int(harness.state.step), loss=loss)
        if spec.max_steps is not None and steps >= spec.max_steps:
            return {"outcome": "done", "step": int(harness.state.step)}


def supervise(world: dist_lib.LocalWorld, control: RankControl,
              answer: Callable[[dict], tuple | None]) -> list:
    """Run a started world to its end, handing each report of its lead to
    ``answer``, which returns (generation, stop) for a ``started`` or
    ``step`` report (the ranks' next loop top) and None for the others.
    Returns the ranks' results; raises as ``LocalWorld.result``."""
    while True:
        record = control.next_report(0.02)
        if record is not None:
            reply = answer(record)
            if reply is not None:
                control.reply(record["step"], *reply)
        elif world.poll(0):
            break
    while (record := control.next_report(0)) is not None:
        answer(record)
    return world.result()


class WorldFailedError(RuntimeError):
    """A world of this pod process's ranks failed: a rank raised, or
    exited or was killed without a report. Its siblings are stopped."""


class RankSupervisor:
    """What a pod process does around its ranks, never touching CUDA:
    spawns each world's ranks (:func:`ride_rank`, one per local device:
    NCCL on the GPUs the pod's device nodes show now, or gloo ranks on
    the CPU), answers their reports with one read of the signal and the
    stop file, and writes the status file (JSONL, one object per event:
    ``started``, ``step``, ``reshape_begin``, ``reshape_done``,
    ``stopped``, ``done``, ``error``; ``on_record`` sees each too).

    ``device``: ``cpu``, ``cuda`` (the first GPUs the pod's nodes show)
    or ``cuda:i[,j...]`` (named by their place among them). A rank that
    dies takes the world with it: the siblings are stopped, ``error``
    names each rank's exit code and signal, and :meth:`run` returns 1."""

    def __init__(self, name: str, cfg: model_lib.ModelConfig, signal,
                 checkpoint_root: str, *, device: str = "cuda",
                 batches: Callable[[int], Any] | None = None,
                 status_path: str | None = None,
                 stop_path: str | None = None,
                 max_steps: int | None = None, lr: float = 3e-4,
                 step_factory: Callable | None = None,
                 data: int | None = 1, seq: int | None = None,
                 model: int | None = 1, verify: bool = False,
                 dev_root: str = "/dev", proc_root: str = "/proc",
                 on_record: Callable[[dict], None] | None = None):
        if [data, seq, model].count(None) != 1:
            raise ValueError("exactly one of data/seq/model must be None "
                             "(the mesh dim that absorbs the chip count)")
        self.name = name
        self.cfg = cfg
        self.signal = signal
        self.checkpoint_root = checkpoint_root
        self.device = str(device)
        self.on_gpu = self.device.startswith("cuda")
        self.batches = batches or SeededBatches(4, 48, cfg.vocab)
        self.status_path = status_path
        self.stop_path = stop_path
        self.max_steps = max_steps
        self.steps = 0
        self.lr = lr
        self.step_factory = step_factory
        self.dims = {"data": data, "seq": seq, "model": model}
        self.verify = verify
        self.dev_root, self.proc_root = dev_root, proc_root
        self.on_record = on_record
        self.generation = None
        self._drained: dict | None = None    # the last world's drain

    def _log(self, phase: str, **fields) -> None:
        record = {"member": self.name, "phase": phase,
                  "unix": round(time.time(), 3), **fields}
        if self.status_path:
            with open(self.status_path, "a") as f:
                f.write(json.dumps(record) + "\n")
                f.flush()
        if self.on_record is not None:
            self.on_record(record)
        logger.info("%s: %s %s", self.name, phase, fields)

    def _wait_for_generation(self, timeout_s: float, poll_s: float = 0.2):
        deadline = time.monotonic() + timeout_s
        while (generation := self.signal.generation()) is None:
            if time.monotonic() >= deadline:
                return None
            time.sleep(poll_s)
        return generation

    def _spec(self, generation, chips: int, **fields) -> RideSpec:
        left = (None if self.max_steps is None
                else self.max_steps - self.steps)
        return RideSpec(self.cfg, self.checkpoint_root, generation, chips,
                        self.batches, lr=self.lr, dims=dict(self.dims),
                        step_factory=self.step_factory,
                        max_steps=left, verify=self.verify, **fields)

    def _answer(self, record: dict):
        """Log a report of the ranks' lead; answer a ``started`` or
        ``step`` one with this process's single read."""
        phase = record.pop("phase")
        record.pop("unix", None)
        if phase == "started":
            if self._drained is None:
                self._log("started", resumed=bool(
                    record["restored_generation"] is not None), **record)
            else:
                old, restore = self._drained, record.pop("restore")
                self._log("reshape_done", **record,
                          timings={"drain": old["drain"],
                                   "restore": restore},
                          reference_loss=old.get("reference_loss"),
                          downtime_s=self._downtime(record))
        elif phase == "step":
            self.steps += 1
            self._log("step", **record)
        else:
            self._log(phase, **record)
            return None
        observed = self.signal.generation()
        if observed is None:
            observed = self.generation
        return observed, bool(self.stop_path
                              and os.path.exists(self.stop_path))

    def _downtime(self, started: dict) -> dict:
        """The parts of a respawn, from the old world's drain to the new
        world's state built: drain, the old ranks' exit (after any check
        they ran), the spawn up to the new lead rank's interpreter and its
        device, the world's rendezvous and process group, and the restore
        (the state built on the new mesh); the first step is the time from
        this record to the next ``step`` record."""
        old, up = self._drained, started["startup"]
        return {"drain": old["drained"] - old["drain_began"],
                "old_rank_exit": old["exited"] - old["exiting"],
                "spawn_to_interpreter": up["main"] - old["spawned"],
                "interpreter_to_device": up["device"] - up["main"],
                "init_process_group": up["joined"] - up["device"],
                "restore": up["built"] - up["joined"]}

    def _run_world(self, spec: RideSpec, n_local: int, *,
                   world_size: int | None = None, rank_offset: int = 0,
                   rendezvous: str | None = None) -> dict:
        """Spawn this process's ranks of one world, supervise them to the
        end, and return the lead's outcome (``_drained`` keeps a drain's
        times). Raises :class:`WorldFailedError` after logging ``error``
        when the world fails."""
        from gpumounter_tpu_torch.torchcheck import probe as probe_lib
        visible = None
        if self.on_gpu:
            visible = probe_lib.rank_visibility(probe_lib.select_gpus(
                self.device, n_local, self.dev_root, self.proc_root))
        control = RankControl()
        world = dist_lib.LocalWorld(
            n_local, ride_rank, (spec,),
            device="cuda" if self.on_gpu else "cpu", world_size=world_size,
            rank_offset=rank_offset, rendezvous=rendezvous, visible=visible,
            shared=control, timeout_s=None)
        self.generation = spec.generation
        try:
            with world:
                if self._drained is not None:
                    self._drained["spawned"] = world.spawned
                try:
                    outcome = supervise(world, control, self._answer)[0]
                except (RuntimeError, TimeoutError) as e:
                    world.close()           # the siblings are stopped
                    self._log("error", message=str(e)[-4000:], ranks={
                        str(r): v for r, v in world.exits().items()})
                    raise WorldFailedError(str(e)) from e
        finally:
            control.close()
        if outcome["outcome"] == "drained":
            outcome["exited"] = time.time()
            self._drained = outcome
        return outcome


class ElasticSupervisor(RankSupervisor):
    """The barrier-less ride of one pod process (the JAX harness's 4 → 8
    → 4 in one process): a world of ``signal.chips()`` local ranks trains
    until the world agrees on a generation bump, drains into the next
    checkpoint generation and exits; this process then spawns a world of
    the new chip count, which restores and continues. ``signal`` is a
    :class:`FileSignal`, a :class:`MasterSliceSignal`, or any object with
    ``generation()`` and ``chips()``. On the GPU the chip count may not
    exceed the GPUs the pod's device nodes show."""

    # how long a pod process waits for its signal to appear
    SIGNAL_WAIT_S = 300.0

    def __init__(self, cfg, signal, checkpoint_root: str, **kwargs):
        super().__init__("pod", cfg, signal, checkpoint_root, **kwargs)

    def run(self) -> int:
        """Returns the process exit code: 0 once stopped or done, 1 when
        a world failed, 2 when the signal never appeared."""
        generation = self._wait_for_generation(self.SIGNAL_WAIT_S)
        if generation is None:
            self._log("error", message="the generation signal never "
                                       "appeared")
            return 2
        while True:
            latest = drain_lib.latest_generation(self.checkpoint_root)
            chips = int(self.signal.chips())
            spec = self._spec(generation, chips,
                              drain_generation=(latest or 0) + 1)
            try:
                outcome = self._run_world(spec, chips)
            except WorldFailedError:
                return 1
            if outcome["outcome"] != "drained":
                self._log(outcome["outcome"], step=outcome["step"])
                return 0
            generation = outcome["generation"]
