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

Departure from the JAX harness: one process drives one device, and a
harness's devices are its ``torch.distributed`` world (a world of one for
a single process, joined with ``probe.initialize_distributed``). A single
process cannot grow past its world, so the chip count the signal reports
must equal the world size (:meth:`ElasticHarness._current_mesh`); growing
and shrinking go through federation, where new member processes join and
members resized out exit.

Generation signals: :class:`MasterSliceSignal` (the master's ``/slicez``)
or :func:`read_generation_file` / :class:`FileSignal` (the file the worker
stamps on every actuation), as in the JAX package.

Resharding needs no template init: every leaf's spec is static
(:func:`state_specs`), and restore keeps each rank's slice of it.
"""

from __future__ import annotations

import json
import os
import tempfile
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
