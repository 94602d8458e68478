"""Graceful device drain for hot-detach and elastic resize, on PyTorch.

Counterpart of :mod:`gpumounter_tpu.jaxcheck.drain`, with its two formats,
its typed errors, its on-disk layout and its deletion discipline. Taking
devices away from a live process invalidates what is on them; the safe
sequence is:

    1. ``drain(tree, path)`` / ``drain_sharded(tree, root, generation)``
       — every tensor → host, checkpointed to disk
    2. control-plane RemoveGPU — the devices leave the Pod
    3. ``probe.shutdown_distributed()`` / a new process
    4. (optional) AddGPU again — the same or another device count
    5. ``restore(...)`` / ``restore_sharded(...)`` — checkpoint → the new
       world, resharded

**Legacy single-file** (``drain``/``restore``): one pickle of the tree with
its tensors copied to the CPU, written atomically (tmp + fsync + rename +
fsync of the directory).

**Sharded streaming** (``drain_sharded``/``restore_sharded``): every
process writes ONE shard file holding only the replica-0 shards it owns
(:func:`~.dist.placement`: replicas deduplicated, so across the world the
entries tile each array exactly once), then process 0 hashes every shard,
commits ``manifest.json`` (generation, world size, SHA-256 per shard) and
atomically repoints ``LATEST``. Restore validates the manifest and every
checksum BEFORE assembling anything; a torn or missing shard is a typed
error, never a partial tree, and callers roll back to the last fully-valid
generation (:func:`restore_last_good`), kept until the next generation
commits. Restore assembles the whole host array of every leaf from every
shard file, and each rank keeps its slice (:func:`~.dist.shard`) on the
current mesh: an N-process checkpoint restores onto an M-process world.

Layout under a checkpoint root (the JAX package's, byte for byte in its
JSON; each package's checks accept the other's commits)::

    root/
      LATEST                      <- "gen-7\\n" (atomic pointer, fsync'd)
      gen-7/
        manifest.json             <- committed by process 0, LAST
        shard-00000-of-00002.pkl  <- process 0's replica-0 shards
        shard-00001-of-00002.pkl
      gen-6/ ...                  <- the rollback target, pruned only
                                     when gen-8 commits

Departures from the JAX module, where PyTorch differs:

- A tensor carries no sharding of its own, so ``drain_sharded`` takes the
  mesh and a tree of specs (``elastic.state_specs`` for a train state),
  and ``restore_sharded`` takes the same to place what it assembled.
  Without specs every tensor is whole on every process and process 0
  writes it.
- numpy has no bfloat16. A bf16 leaf's data is its uint16 bits, stamped
  with the dtype name :data:`BF16_BITS`, which ``np.dtype`` rejects: the
  JAX reader then fails loudly on it rather than cast the bits by value.
- A restore without specs returns the host tree as CPU tensors (which can
  hold bf16), where the JAX module returns numpy arrays.

Deletion discipline (pinned by ``tests/test_torch_federation_lint.py``):
no restore path unlinks anything; pruning happens only in the commit
step, after the new manifest and ``LATEST`` are durable, and keeps the
new generation and its newest committed predecessor.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import pickle
import re
import tempfile
import time
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

from gpumounter_tpu_torch.torchcheck import dist as dist_lib
from gpumounter_tpu_torch.utils.consts import SHARDED_FORMAT
from gpumounter_tpu_torch.utils.log import get_logger

logger = get_logger("torchcheck.drain")

_GEN_DIR_RE = re.compile(r"gen-(\d+)$")
# dtype name of a bf16 leaf whose data is carried as uint16 bits
BF16_BITS = "bfloat16-bits-as-uint16"


# -- typed checkpoint errors ---------------------------------------------------


class CheckpointError(Exception):
    """Base for every sharded-checkpoint failure. Catching this and
    falling back to :func:`restore_last_good` is the whole rollback
    contract — a CheckpointError NEVER delivers a partial tree."""


class ManifestError(CheckpointError):
    """The generation's manifest is missing, unparsable, or names an
    unknown format — the commit never happened or was torn."""


class TornShardError(CheckpointError):
    """A shard file named by a committed manifest is missing, truncated,
    or fails its checksum — the generation cannot be trusted."""


class WrongGenerationError(CheckpointError):
    """The committed checkpoint's generation is not the one the caller
    expected to restore (the world moved on mid-transition)."""


class NoCheckpointError(CheckpointError):
    """No fully-valid generation exists under the root at all."""


# -- atomic file primitives ----------------------------------------------------


def _fsync_dir(directory: str) -> None:
    try:
        fd = os.open(directory, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _atomic_write(path: str, data: bytes) -> None:
    """tmp + fsync + rename, then fsync the directory: after this
    returns the bytes are durable AND the name flip was atomic — a crash
    at any instant leaves either the old file or the new one, never a
    truncated hybrid."""
    directory = os.path.dirname(os.path.abspath(path))
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".draining")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    _fsync_dir(directory)


def _sha256(path: str) -> str:
    digest = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            digest.update(chunk)
    return digest.hexdigest()


@contextlib.contextmanager
def _timed(timings: dict | None, key: str):
    """Add the seconds the block takes to ``timings[key]`` (a caller's
    breakdown of a drain or restore; nothing when ``timings`` is None)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if timings is not None:
            timings[key] = timings.get(key, 0.0) + time.perf_counter() - t0


# -- trees ---------------------------------------------------------------------


def _map(fn: Callable, tree: Any, *others: Any,
         is_leaf: Callable[[Any], bool] | None = None) -> Any:
    """``fn`` over the leaves of a tree of dicts, lists and tuples, with
    the matching subtrees of ``others`` (whose structure ``tree``
    drives: a spec tuple in ``others`` reaches ``fn`` whole)."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *others)
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(o[k] for o in others), is_leaf=is_leaf)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, *(o[i] for o in others),
                               is_leaf=is_leaf)
                          for i, v in enumerate(tree))
    return fn(tree, *others)


def _leaves(tree: Any) -> list:
    out: list = []
    _map(out.append, tree)
    return out


def _dtype_name(dtype: torch.dtype) -> str:
    """The dtype name a shard entry is stamped with: numpy's, and
    :data:`BF16_BITS` for bf16."""
    if dtype == torch.bfloat16:
        return BF16_BITS
    return str(torch.empty(0, dtype=dtype).numpy().dtype)


def _host(t: torch.Tensor) -> np.ndarray:
    """A tensor's values on the host as a numpy array; bf16 as its
    uint16 bits (:data:`BF16_BITS`)."""
    t = t.detach().to("cpu").contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _np_dtype(name: str) -> np.dtype:
    return np.dtype(np.uint16) if name == BF16_BITS else np.dtype(name)


def _tensor(arr: np.ndarray, name: str) -> torch.Tensor:
    """Inverse of :func:`_host`."""
    if name == BF16_BITS:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr if arr.flags.c_contiguous else arr.copy())


def _place(host: torch.Tensor, spec, mesh, device) -> Any:
    """One restored host leaf onto this rank: its slice under ``spec`` on
    ``mesh`` (the whole leaf without a mesh), on ``device``. A ``None``
    spec keeps the host value (the step counter)."""
    if spec is None:
        return host
    local = host if mesh is None else dist_lib.shard(host, mesh, spec)
    return local.to(device)


# -- legacy single-file checkpoint ---------------------------------------------


def drain(tree: Any, path: str) -> Any:
    """Tree of tensors → host tree (tensors copied to the CPU), persisted
    at ``path`` (written atomically with tmp + fsync + rename — a crash
    mid-detach must not eat the only copy OR leave a torn file where a
    good one was). Returns the host tree."""
    host_tree = _map(lambda x: x.detach().to("cpu", copy=True)
                     if isinstance(x, torch.Tensor) else x, tree)
    _atomic_write(path, pickle.dumps(host_tree,
                                     protocol=pickle.HIGHEST_PROTOCOL))
    leaves = _leaves(host_tree)
    logger.info("drained %d arrays (%.1f MB) to %s", len(leaves),
                sum(x.nbytes for x in leaves
                    if isinstance(x, torch.Tensor)) / 1e6, path)
    return host_tree


def restore(path: str, specs: Any = None, *, mesh=None,
            device: str | torch.device = "cpu") -> Any:
    """Checkpoint → tree on the CURRENT world. ``specs`` is an optional
    matching tree of specs (``elastic.state_specs`` for a train state)
    placing each leaf's slice of ``mesh`` on ``device``; without it the
    host tree comes back."""
    with open(path, "rb") as f:
        host_tree = pickle.load(f)
    if specs is None:
        return host_tree
    return _map(lambda host, spec: _place(host, spec, mesh, device),
                host_tree, specs)


def drain_restore_cycle(tree: Any, specs: Any = None, *, mesh=None,
                        device: str | torch.device = "cpu",
                        path: str | None = None) -> Any:
    """drain → device release → restore, in one call: what a sidecar
    runs around a detach+reattach when the process must survive it."""
    from gpumounter_tpu_torch.torchcheck.probe import release_backend

    own_tmp = path is None
    if own_tmp:
        fd, path = tempfile.mkstemp(suffix=".ckpt")
        os.close(fd)
    try:
        drain(tree, path)
        release_backend()
        restored = restore(path, specs, mesh=mesh, device=device)
    except BaseException:
        # The checkpoint may be the ONLY surviving copy — never delete it
        # on failure.
        logger.error("drain/restore cycle failed; checkpoint kept at %s",
                     path)
        raise
    if own_tmp and os.path.exists(path):
        os.unlink(path)
    return restored


# -- sharded checkpoint streaming ----------------------------------------------


def _gen_dir(root: str, generation: int) -> str:
    return os.path.join(root, f"gen-{int(generation)}")


def _shard_name(process_index: int, process_count: int) -> str:
    return f"shard-{process_index:05d}-of-{process_count:05d}.pkl"


def _is_shard_leaf(x) -> bool:
    return isinstance(x, dict) and "entries" in x and "shape" in x


def _leaf_to_shards(leaf, spec, mesh, process_index: int) -> dict:
    """One state leaf → this process's contribution: its replica-0 shard
    when ``leaf`` is a tensor sharded by ``spec`` over ``mesh`` (across
    every process the entries then tile the global array exactly once),
    or — for a leaf every process holds whole (no mesh or spec, or a host
    value) — the whole value from process 0 only."""
    if isinstance(leaf, torch.Tensor) and mesh is not None \
            and spec is not None:
        shape = list(leaf.shape)
        for dim, name in enumerate(spec):
            if name is not None:
                shape[dim] *= dist_lib.axis_size(mesh, name)
        index, replica0 = dist_lib.placement(mesh, spec, shape)
        entries = [{"index": index, "data": _host(leaf)}] if replica0 else []
        return {"shape": shape, "dtype": _dtype_name(leaf.dtype),
                "entries": entries}
    if isinstance(leaf, torch.Tensor):
        value, dtype = _host(leaf), _dtype_name(leaf.dtype)
    else:
        value = np.asarray(leaf)
        dtype = str(value.dtype)
    entries = [] if process_index != 0 else [
        {"index": [[0, n] for n in value.shape], "data": value}]
    return {"shape": list(value.shape), "dtype": dtype, "entries": entries}


def _world() -> tuple[int, int]:
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def drain_sharded(tree: Any, root: str, generation: int, *,
                  specs: Any = None, mesh=None,
                  process_index: int | None = None,
                  process_count: int | None = None,
                  sync_fn: Callable[[], None] | None = None,
                  timings: dict | None = None) -> str:
    """Stream this process's shards of ``tree`` (sharded by ``specs``
    over ``mesh``) into generation ``generation`` under ``root``, and on
    process 0 commit the manifest. Every member of the (still-live) world
    calls this BEFORE leaving it; ``sync_fn`` is the world's barrier
    (``dist.barrier``), called twice: once every shard is durable (then
    process 0 commits), once the commit is (then everyone proceeds). Pass
    None in a world of one.

    ``timings``, when given, gains the seconds of each part: device to
    host, pickle, write plus fsync, the barriers, and (process 0) the
    commit's sha256 and manifest plus ``LATEST`` flip.

    Returns the generation directory. The previous generation is KEPT:
    pruning keeps the new commit plus its predecessor."""
    rank, world = _world()
    process_index = rank if process_index is None else process_index
    process_count = world if process_count is None else process_count
    gen_dir = _gen_dir(root, generation)
    os.makedirs(gen_dir, exist_ok=True)
    with _timed(timings, "device_to_host_s"):
        shard_tree = _map(
            lambda leaf, spec: _leaf_to_shards(leaf, spec, mesh,
                                               process_index),
            tree, specs if specs is not None else _map(lambda _: None,
                                                       tree))
    name = _shard_name(process_index, process_count)
    with _timed(timings, "pickle_s"):
        payload = pickle.dumps({"format": SHARDED_FORMAT,
                                "process": process_index,
                                "tree": shard_tree},
                               protocol=pickle.HIGHEST_PROTOCOL)
    del shard_tree
    with _timed(timings, "write_fsync_s"):
        _atomic_write(os.path.join(gen_dir, name), payload)
    if timings is not None:
        timings["bytes"] = timings.get("bytes", 0) + len(payload)
    del payload
    logger.info("drained shard %s of generation %d to %s", name,
                generation, gen_dir)
    if sync_fn is not None:
        with _timed(timings, "sync_s"):
            sync_fn()               # every member's shard is durable
    if process_index == 0:
        commit_manifest(root, generation, process_count, timings=timings)
    if sync_fn is not None:
        with _timed(timings, "sync_s"):
            sync_fn()               # nobody proceeds before the commit
    return gen_dir


def commit_manifest(root: str, generation: int, process_count: int, *,
                    timings: dict | None = None) -> dict:
    """The commit point: hash every shard file, write the manifest, flip
    ``LATEST``, THEN prune superseded generations (keeping this one and
    its predecessor). Run by process 0 only, strictly after every
    member's shard is durable."""
    gen_dir = _gen_dir(root, generation)
    shards = {}
    with _timed(timings, "sha256_s"):
        for i in range(process_count):
            name = _shard_name(i, process_count)
            path = os.path.join(gen_dir, name)
            if not os.path.exists(path):
                raise TornShardError(
                    f"cannot commit generation {generation}: shard {name} "
                    "was never written (a member died mid-drain?)")
            shards[name] = {"sha256": _sha256(path),
                            "bytes": os.path.getsize(path)}
    manifest = {
        "format": SHARDED_FORMAT,
        "generation": int(generation),
        "process_count": int(process_count),
        "shards": shards,
    }
    with _timed(timings, "manifest_latest_s"):
        _atomic_write(os.path.join(gen_dir, "manifest.json"),
                      json.dumps(manifest, indent=1).encode())
        _atomic_write(os.path.join(root, "LATEST"),
                      f"gen-{int(generation)}\n".encode())
    with _timed(timings, "prune_s"):
        _prune_generations(root, keep=int(generation))
    logger.info("committed sharded checkpoint generation %d (%d shard "
                "file(s))", generation, process_count)
    return manifest


def _prune_generations(root: str, keep: int) -> None:
    """Delete generation dirs superseded by the just-committed ``keep``
    — called ONLY from the commit path, after the new manifest and
    LATEST are durable, and always sparing ``keep`` plus the newest
    COMMITTED generation below it (the rollback target). A torn dir a
    crashed transition left behind (shards, no manifest) is junk, not a
    rollback target. The lint pins that no restore path can reach
    here."""
    import shutil
    gens = sorted(list_generations(root))
    spare = {keep}
    for gen in sorted((g for g in gens if g < keep), reverse=True):
        try:
            _load_manifest(root, gen)
        except CheckpointError:
            continue
        spare.add(gen)
        break
    for gen in gens:
        if gen in spare:
            continue
        shutil.rmtree(_gen_dir(root, gen), ignore_errors=True)
        logger.info("pruned superseded checkpoint generation %d", gen)


def list_generations(root: str) -> list[int]:
    """Every generation directory under ``root`` (committed or not),
    ascending."""
    try:
        names = os.listdir(root)
    except OSError:
        return []
    out = []
    for name in names:
        match = _GEN_DIR_RE.fullmatch(name)
        if match and os.path.isdir(os.path.join(root, name)):
            out.append(int(match.group(1)))
    return sorted(out)


def latest_generation(root: str) -> int | None:
    """The committed generation the ``LATEST`` pointer names, or None
    when nothing has ever committed here."""
    try:
        with open(os.path.join(root, "LATEST")) as f:
            text = f.read().strip()
    except OSError:
        return None
    match = _GEN_DIR_RE.fullmatch(text)
    return int(match.group(1)) if match else None


def _load_manifest(root: str, generation: int) -> dict:
    path = os.path.join(_gen_dir(root, generation), "manifest.json")
    try:
        with open(path) as f:
            manifest = json.load(f)
    except OSError as e:
        raise ManifestError(
            f"generation {generation} has no readable manifest "
            f"({e}): the commit never happened") from e
    except ValueError as e:
        raise ManifestError(
            f"generation {generation} manifest is corrupt: {e}") from e
    if manifest.get("format") != SHARDED_FORMAT:
        raise ManifestError(
            f"generation {generation} manifest names unknown format "
            f"{manifest.get('format')!r}")
    if int(manifest.get("generation", -1)) != int(generation):
        raise ManifestError(
            f"generation dir {generation} holds a manifest stamped "
            f"{manifest.get('generation')!r}")
    return manifest


def _verify_shards(root: str, generation: int, manifest: dict) -> None:
    gen_dir = _gen_dir(root, generation)
    for name, meta in (manifest.get("shards") or {}).items():
        path = os.path.join(gen_dir, name)
        if not os.path.exists(path):
            raise TornShardError(
                f"generation {generation}: shard {name} is missing")
        if os.path.getsize(path) != int(meta.get("bytes", -1)):
            raise TornShardError(
                f"generation {generation}: shard {name} is truncated "
                f"({os.path.getsize(path)} bytes, manifest says "
                f"{meta.get('bytes')})")
        if _sha256(path) != meta.get("sha256"):
            raise TornShardError(
                f"generation {generation}: shard {name} fails its "
                "checksum")


def _assemble_leaf(parts: list[dict]) -> torch.Tensor:
    """Shard entries (across every process's shard file) → the whole
    host tensor; coverage is validated so a manifest that somehow passed
    checksums but lost entries still cannot yield a partial tree. Each
    entry's data is dropped once copied (the loaded shard files are this
    restore's own), so the host holds about one copy of the state."""
    shape = tuple(parts[0]["shape"])
    name = parts[0]["dtype"]
    dtype = _np_dtype(name)
    if shape == ():
        for part in parts:
            for entry in part["entries"]:
                return _tensor(np.asarray(entry["data"], dtype=dtype), name)
        raise TornShardError("scalar leaf has no shard entry")
    out = np.empty(shape, dtype=dtype)
    covered = 0
    for part in parts:
        for entry in part["entries"]:
            index = tuple(slice(start, stop)
                          for start, stop in entry["index"])
            data = np.asarray(entry.pop("data"), dtype=dtype)
            out[index] = data
            covered += data.size
            del data
    if covered != out.size:
        raise TornShardError(
            f"shard entries cover {covered} of {out.size} elements — "
            "replica-0 shards no longer tile the array")
    return _tensor(out, name)


def _load_generation(root: str, generation: int, specs: Any = None,
                     mesh=None, device: str | torch.device = "cpu",
                     timings: dict | None = None) -> Any:
    """Validate + assemble ONE generation, and place it when ``specs``
    is given. Raises a typed CheckpointError; never returns a partial
    tree, never deletes anything (the no-unlink lint pins this path)."""
    with _timed(timings, "read_verify_s"):
        manifest = _load_manifest(root, generation)
        _verify_shards(root, generation, manifest)
    gen_dir = _gen_dir(root, generation)
    trees = []
    with _timed(timings, "unpickle_assemble_s"):
        for name in manifest["shards"]:
            try:
                with open(os.path.join(gen_dir, name), "rb") as f:
                    payload = pickle.load(f)
            except (OSError, pickle.UnpicklingError, EOFError) as e:
                raise TornShardError(
                    f"generation {generation}: shard {name} unreadable: "
                    f"{e}") from e
            if payload.get("format") != SHARDED_FORMAT:
                raise TornShardError(
                    f"generation {generation}: shard {name} names format "
                    f"{payload.get('format')!r}")
            trees.append(payload["tree"])
        host_tree = _map(lambda *parts: _assemble_leaf(list(parts)),
                         *trees, is_leaf=_is_shard_leaf)
        del trees
    if specs is None:
        return host_tree
    with _timed(timings, "host_to_device_s"):
        placed = _map(lambda host, spec: _place(host, spec, mesh, device),
                      host_tree, specs)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
    return placed


def restore_sharded(root: str, specs: Any = None, *, mesh=None,
                    device: str | torch.device = "cpu",
                    expect_generation: int | None = None,
                    timings: dict | None = None) -> Any:
    """The committed checkpoint → tree resharded onto the CURRENT world
    (old-N shards onto a new-M world): with ``specs`` (a matching tree of
    specs) each rank gets its slice over ``mesh`` on ``device``; without
    it, the host tree (CPU tensors). ``expect_generation`` pins the
    generation a re-federated member is transitioning to; a mismatch
    raises :class:`WrongGenerationError` so the caller can fall back to
    :func:`restore_last_good` instead of restoring a stale world's state
    as the new one's. ``timings`` as in :func:`drain_sharded`: read plus
    verify, unpickle plus assemble, host to device."""
    generation = latest_generation(root)
    if generation is None:
        gens = list_generations(root)
        if not gens:
            raise NoCheckpointError(f"no checkpoint under {root}")
        raise ManifestError(
            f"{root} has generation dir(s) {gens} but no LATEST "
            "pointer: nothing ever committed")
    if expect_generation is not None \
            and int(generation) != int(expect_generation):
        raise WrongGenerationError(
            f"committed checkpoint is generation {generation}, caller "
            f"expected {expect_generation}")
    return _load_generation(root, generation, specs, mesh, device, timings)


def restore_last_good(root: str, specs: Any = None, *, mesh=None,
                      device: str | torch.device = "cpu"
                      ) -> tuple[Any, int]:
    """Walk generations newest → oldest and return ``(tree,
    generation)`` for the first fully-valid one — the rollback target
    after a torn/missing-shard or wrong-generation failure. Raises
    :class:`NoCheckpointError` when nothing valid survives anywhere."""
    last_error: CheckpointError | None = None
    for generation in sorted(list_generations(root), reverse=True):
        try:
            return _load_generation(root, generation, specs, mesh,
                                    device), generation
        except CheckpointError as e:
            logger.warning("generation %d not restorable (%s); trying "
                           "older", generation, e)
            last_error = e
    raise NoCheckpointError(
        f"no fully-valid checkpoint generation under {root}"
        + (f" (last failure: {last_error})" if last_error else ""))
