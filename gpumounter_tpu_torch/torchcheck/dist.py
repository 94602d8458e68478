"""Sharding and communication over ``torch.distributed``.

Counterpart of :mod:`gpumounter_tpu.jaxcheck.dist` (``put_global``,
``put_global_tree``), plus the communication JAX had built in: under
``shard_map`` and GSPMD, JAX places collectives and differentiates through
them itself; here each is an explicit ``torch.autograd.Function``.

The world is one process per device (NCCL on GPUs, gloo on the CPU), and
a mesh is a :class:`~torch.distributed.device_mesh.DeviceMesh` whose dims
carry names (``("data", "seq", "model")`` for the flagship model). A
*spec* is what ``P(...)`` is in JAX: one entry per tensor dim, either
``None`` (replicated) or a mesh-dim name (split evenly over that dim, in
its coordinate order). Dims past the end of a spec are replicated.

The placement rule both packages share (``dist.py:5-10`` of the JAX
package): every rank holds the same full host tensor, drawn from the same
seed, and keeps only its own slice (:func:`shard`, the port's
``put_global``); :func:`placement` says where that slice lies.

Inside a group, peers are named by their global ranks
(``dist.get_global_rank``); a group of one moves nothing, so every
collective here returns its input unchanged for it.
"""

from __future__ import annotations

import ctypes
import datetime
import faulthandler
import math
import multiprocessing
import os
import queue
import shutil
import signal
import tempfile
import time
import traceback
from typing import Any, Callable, Sequence

import torch
import torch.distributed as dist

from gpumounter_tpu_torch.torchcheck import resolve_device

Spec = Sequence[str | None]

WORLD_TIMEOUT_S = 600.0
# After one rank has failed, the others get this long to report before the
# world is torn down (they may be blocked in a collective with it).
FAILURE_GRACE_S = 5.0


# -- placement ----------------------------------------------------------------

def axis_size(mesh, name: str) -> int:
    return mesh.shape[mesh.mesh_dim_names.index(name)]


def axis_index(mesh, name: str) -> int:
    return mesh.get_local_rank(name)


def shard(full: torch.Tensor, mesh, spec: Spec) -> torch.Tensor:
    """This rank's slice of ``full`` under ``spec`` (contiguous). Every dim
    named in ``spec`` must divide evenly over its mesh dim."""
    out = full
    for dim, name in enumerate(spec):
        if name is None:
            continue
        n = axis_size(mesh, name)
        if out.shape[dim] % n:
            raise ValueError(f"dim {dim} of shape {tuple(full.shape)} does "
                             f"not divide over mesh dim {name!r} of size {n}")
        size = out.shape[dim] // n
        out = out.narrow(dim, axis_index(mesh, name) * size, size)
    return out.contiguous()


def shard_tree(tree: Any, mesh, specs: Any) -> Any:
    """:func:`shard` over a tree of dicts and lists of tensors, with a
    matching tree of specs."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, mesh, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(shard_tree(v, mesh, s) for v, s in zip(tree, specs))
    return shard(tree, mesh, specs)


def placement(mesh, spec: Spec, shape: Sequence[int]
              ) -> tuple[list[list[int]], bool]:
    """Where this rank's :func:`shard` of a global array of ``shape``
    lies under ``spec``: its global index ranges ``[[start, stop], ...]``
    (one per dim), and whether this rank is replica 0, meaning coordinate
    0 on every mesh dim ``spec`` does not name. Across a world the
    replica-0 ranks' ranges tile the array exactly once — what JAX reads
    from ``shard.index`` and ``shard.replica_id == 0``."""
    ranges = []
    for dim, n in enumerate(shape):
        name = spec[dim] if dim < len(spec) else None
        if name is None:
            ranges.append([0, int(n)])
            continue
        size = axis_size(mesh, name)
        if n % size:
            raise ValueError(f"dim {dim} of shape {tuple(shape)} does not "
                             f"divide over mesh dim {name!r} of size {size}")
        start = axis_index(mesh, name) * (n // size)
        ranges.append([start, start + n // size])
    named = {name for name in spec if name is not None}
    replica0 = all(axis_index(mesh, name) == 0
                   for name in mesh.mesh_dim_names if name not in named)
    return ranges, replica0


def unshard(local: torch.Tensor, mesh, spec: Spec) -> torch.Tensor:
    """The full tensor from every rank's slice (all-gather over each dim
    named in ``spec``); the inverse of :func:`shard`. Not differentiable:
    for reports and tests."""
    out = local.detach()
    for dim, name in enumerate(spec):
        if name is None or axis_size(mesh, name) == 1:
            continue
        group = mesh.get_group(name)
        parts = [torch.empty_like(out) for _ in range(axis_size(mesh, name))]
        dist.all_gather(parts, out.contiguous(), group=group)
        out = torch.cat(parts, dim=dim)
    return out


# -- collectives ----------------------------------------------------------------

def _size(group) -> int:
    return dist.get_world_size(group)


def permute(tensors: Sequence[torch.Tensor], group, shift: int = 1
            ) -> list[torch.Tensor]:
    """Each rank sends ``tensors`` to the group rank ``shift`` above it and
    receives the same shapes from the rank ``shift`` below it (wrapping) —
    ``lax.ppermute`` with ``perm=[(j, (j + shift) % n)]``. Not
    differentiable; :func:`ppermute` is."""
    n = _size(group)
    if n == 1 or shift % n == 0:
        return list(tensors)
    me = dist.get_rank(group)
    dst = dist.get_global_rank(group, (me + shift) % n)
    src = dist.get_global_rank(group, (me - shift) % n)
    sends = [t.contiguous() for t in tensors]
    recvs = [torch.empty_like(t) for t in sends]
    ops = []
    for s, r in zip(sends, recvs):
        ops.append(dist.P2POp(dist.isend, s, dst, group))
        ops.append(dist.P2POp(dist.irecv, r, src, group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recvs


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return permute([x], group, shift)[0]

    @staticmethod
    def backward(ctx, g):
        # the transpose of a rotation is the rotation the other way
        return permute([g], ctx.group, -ctx.shift)[0], None, None


def ppermute(x: torch.Tensor, group, shift: int = 1) -> torch.Tensor:
    """Differentiable :func:`permute` of one tensor: the backward sends the
    cotangent back the way the value came. Every rank of ``group`` must
    differentiate through it, or the backward's exchange waits forever."""
    n = _size(group)
    if n == 1 or shift % n == 0:
        return x
    return _PPermute.apply(x, group, shift)


def all_reduce_(x: torch.Tensor, group) -> torch.Tensor:
    """In-place sum over ``group`` (no autograd); returns ``x``."""
    if _size(group) > 1:
        dist.all_reduce(x, group=group)
    return x


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's *f*: identity forward, all-reduce backward. Put before a
    column-parallel product whose input is replicated over ``group``: each
    rank's gradient of the input is partial (its own columns), and the sum
    is the whole gradient."""
    if _size(group) == 1:
        return x
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's *g*: all-reduce forward, identity backward. Put after a
    row-parallel product, whose per-rank outputs are partial sums; also the
    ``psum`` of a result every rank then uses alike (an all-reduce
    backward there would count its cotangent ``n`` times)."""
    if _size(group) == 1:
        return x
    return _ReduceFromGroup.apply(x, group)


class _GatherFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        n = _size(group)
        ctx.dim, ctx.size = dim, x.shape[dim]
        ctx.rank = dist.get_rank(group)
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return (g.narrow(ctx.dim, ctx.rank * ctx.size, ctx.size).contiguous(),
                None, None)


def gather_from_group(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """All-gather forward (concatenated on ``dim`` in rank order), own-slice
    backward. For a result every rank then uses alike (the vocab-sharded
    logits before a replicated loss): each rank's cotangent of the whole is
    the same, so its slice is the gradient of its part. (A stock all-gather
    reduce-scatters in its backward and so scales it by the group size.)"""
    if _size(group) == 1:
        return x
    return _GatherFromGroup.apply(x, group, dim % x.dim())


def _all_to_all(x, group, split_dim: int, concat_dim: int):
    n = _size(group)
    if x.shape[split_dim] % n:
        raise ValueError(f"dim {split_dim} of {tuple(x.shape)} does not "
                         f"split over {n} ranks")
    send = torch.stack(x.chunk(n, dim=split_dim)).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return torch.cat(recv.unbind(0), dim=concat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.args = group, split_dim, concat_dim
        return _all_to_all(x, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        group, split_dim, concat_dim = ctx.args
        # the inverse all-to-all: split where the forward concatenated
        return _all_to_all(g, group, concat_dim, split_dim), None, None, None


def all_to_all(x: torch.Tensor, group, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """``lax.all_to_all(..., tiled=True)``: ``x`` is cut into n chunks
    along ``split_dim``, chunk j goes to group rank j, and the chunks a
    rank receives are concatenated along ``concat_dim`` in rank order.
    Differentiable; the backward is the inverse all-to-all."""
    if _size(group) == 1:
        return x
    return _AllToAll.apply(x, group, split_dim % x.dim(), concat_dim % x.dim())


def exclusive_scan(x: torch.Tensor, group) -> tuple[torch.Tensor,
                                                     torch.Tensor]:
    """(sum of ``x`` over the group ranks below this one, sum over all of
    them). Not differentiable."""
    n = _size(group)
    if n == 1:
        return torch.zeros_like(x), x
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    stacked = torch.stack(parts)
    return stacked[:dist.get_rank(group)].sum(0), stacked.sum(0)


def local_world_size() -> int:
    """How many ranks this rank's pod process drives (``LOCAL_WORLD_SIZE``,
    set by :class:`LocalWorld`; 1 for a process that joined alone)."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", "1"))


def check_local_sizes() -> list[int]:
    """Every pod process of the world drives the same number of devices
    (a rank's global rank is process index x N + local): all-gathers each
    rank's :func:`local_world_size` and raises RuntimeError naming them on
    a mismatch. A collective: every rank of the world calls it."""
    sizes: list = [None] * dist.get_world_size()
    dist.all_gather_object(sizes, local_world_size())
    if len(set(sizes)) != 1:
        raise RuntimeError(
            f"the processes of this world drive different numbers of "
            f"devices (local sizes by rank: {sizes}); every member must "
            "drive the same N")
    return sizes


# -- worlds of processes --------------------------------------------------------

# A rank still running this long before its world's deadline dumps every
# thread's stack to stderr, so a stuck rank names where it waits.
STACK_DUMP_LEAD_S = 10.0

# prctl(2): the signal a process gets when the thread that started it exits
PR_SET_PDEATHSIG = 1

# This rank process's start-up, written once by the launcher (unix times):
# ``main`` once its interpreter and torch are loaded, ``device`` once its
# device is ready (a CUDA context made on it), ``joined`` once it has joined
# the world. A supervisor reads it through the rank's own reports.
STARTUP: dict[str, float] = {}


def _die_with_parent(parent_pid: int) -> None:
    """Have the kernel SIGKILL this process when the thread that started
    it exits, so that a rank never outlives its supervisor (a SIGKILLed
    pod process would otherwise leave ranks holding GPUs and a world);
    exit at once when that parent is already gone."""
    libc = ctypes.CDLL(None, use_errno=True)
    if libc.prctl(PR_SET_PDEATHSIG, signal.SIGKILL, 0, 0, 0) != 0:
        raise OSError(ctypes.get_errno(), "prctl(PR_SET_PDEATHSIG) failed")
    if os.getppid() != parent_pid:
        os._exit(1)


def _world_main(local: int, n_local: int, offset: int, world: int,
                rendezvous: str, backend: str, visible: str | None,
                timeout_s: float | None, deadline: float | None,
                parent_pid: int, shared, inbox, results) -> None:
    """One rank process of a :class:`LocalWorld`: global rank ``offset +
    local`` of ``world``, on ``cuda:<local>`` (NCCL) or the CPU (gloo).
    ``deadline`` is the world's end as a unix time (None: no end)."""
    STARTUP["main"] = time.time()
    _die_with_parent(parent_pid)
    if deadline is not None:
        # timed from the world's deadline, not from this start: a rank
        # whose interpreter took long to load torch still dumps before
        # its parent stops it
        faulthandler.dump_traceback_later(
            max(deadline - time.time() - STACK_DUMP_LEAD_S, 1.0),
            exit=False)
    rank = offset + local
    try:
        # before the first CUDA call, in this process only: the
        # supervisor's own environment is never written
        if visible is not None:
            os.environ["CUDA_VISIBLE_DEVICES"] = visible
        os.environ.update(LOCAL_RANK=str(local),
                          LOCAL_WORLD_SIZE=str(n_local), RANK=str(rank),
                          WORLD_SIZE=str(world),
                          GROUP_RANK=str(offset // n_local))
        target, args = inbox.get(timeout=timeout_s)
        if backend == "nccl":
            torch.cuda.set_device(local)
            device = torch.device("cuda", local)
            torch.empty(1, device=device)          # the CUDA context
        else:
            device = torch.device("cpu")
            # the ranks share the host's cores (a pod's own
            # OMP_NUM_THREADS, which torch reads at start, wins)
            if not os.environ.get("OMP_NUM_THREADS"):
                torch.set_num_threads(
                    max(1, (os.cpu_count() or 1) // n_local))
        STARTUP["device"] = time.time()
        # NCCL makes its communicators lazily, at the first collective
        dist.init_process_group(
            backend, init_method=rendezvous, world_size=world, rank=rank,
            timeout=datetime.timedelta(
                seconds=timeout_s or WORLD_TIMEOUT_S))
        STARTUP["joined"] = time.time()
        try:
            result = (target(device, *args) if shared is None
                      else target(device, shared, *args))
        finally:
            dist.destroy_process_group()
        results.put((local, result, None))
    except Exception:    # reported to the parent, which raises it
        results.put((local, None, traceback.format_exc()))
    finally:
        faulthandler.cancel_dump_traceback_later()


def _close(q) -> None:
    """Take what no process took off ``q`` (its feeder thread can then
    flush), close it and join its feeder thread, so that a world leaves no
    thread or pipe behind in this process.

    Work for a rank gone before it read it may still sit in the feeder's
    buffer after the drain; larger than the pipe, its write would block the
    feeder, and the join, for ever. The join is bounded: past
    ``FAILURE_GRACE_S`` the feeder is left to the process's exit (only a
    failed world leaves one)."""
    try:
        while True:
            q.get_nowait()
    except (queue.Empty, OSError, EOFError):
        pass
    q.close()
    feeder = q._thread
    if feeder is not None:
        feeder.join(timeout=FAILURE_GRACE_S)
        if feeder.is_alive():
            q.cancel_join_thread()
    q.join_thread()


def _exit_text(exitcode: int) -> str:
    """A process's end as words: its exit code, or the signal that killed
    it (``multiprocessing`` reports signal N as exit code -N)."""
    if exitcode < 0:
        try:
            name = signal.Signals(-exitcode).name
        except ValueError:
            name = f"signal {-exitcode}"
        return f"was killed by {name} (signal {-exitcode})"
    return f"exited with code {exitcode}"


class LocalWorld:
    """``n_local`` fresh rank processes that are global ranks
    ``rank_offset`` … ``rank_offset + n_local - 1`` of a
    ``torch.distributed`` world of ``world_size``: the part of a world one
    pod process drives, one process per device. Each runs
    ``target(device, *args)`` (``target(device, shared, *args)`` when
    ``shared`` is given: an object of ``multiprocessing`` primitives, which
    reach a process only as it starts) on ``cuda:<local>`` under NCCL, or
    on the CPU under gloo, and reports its (picklable) result.

    ``rendezvous`` is ``host:port``, served by global rank 0 (whichever
    pod runs it); None gives a world of this process's ranks alone a
    file store in a directory of its own. ``visible`` is the ranks'
    ``CUDA_VISIBLE_DEVICES``, set in each child before its first CUDA call
    and never in this process, so that the next world of the same
    supervisor sees the GPUs attached since (this process need never touch
    CUDA). The ranks die with the thread that starts them
    (``PR_SET_PDEATHSIG``).

    A rank that fails, or exits without a report, fails the world within
    ``FAILURE_GRACE_S``: :meth:`result` raises with each rank's traceback,
    or its exit code or signal. ``timeout_s`` bounds the world (None: a
    world that runs until its ranks return, as a training world does).
    :meth:`close` stops every rank still running."""

    def __init__(self, n_local: int, target: Callable, args: tuple = (), *,
                 device: str | torch.device = "cuda",
                 world_size: int | None = None, rank_offset: int = 0,
                 rendezvous: str | None = None, visible: str | None = None,
                 shared=None, timeout_s: float | None = WORLD_TIMEOUT_S):
        world_size = n_local if world_size is None else world_size
        if n_local < 1:
            raise ValueError(f"a world needs at least one process, got "
                             f"{n_local}")
        if rank_offset < 0 or rank_offset + n_local > world_size:
            last = rank_offset + n_local - 1
            raise ValueError(f"ranks {rank_offset}..{last} are not in a "
                             f"world of {world_size}")
        if rendezvous is None and world_size != n_local:
            raise ValueError("a world that spans processes needs a "
                             "rendezvous address")
        self.n_local, self.world_size = n_local, world_size
        self.rank_offset = rank_offset
        self.target, self.args = target, args
        self.backend = ("nccl" if torch.device(device).type == "cuda"
                        else "gloo")
        self.rendezvous, self.visible = rendezvous, visible
        self.shared, self.timeout_s = shared, timeout_s
        self.procs: list = []
        self.pids: list[int] = []
        self.got: dict[int, Any] = {}
        self.errors: dict[int, str] = {}
        self._store_dir: str | None = None
        self._deadline = math.inf
        self._ends: dict[int, int] = {}     # exit codes of closed ranks
        self._closed = False

    def start(self) -> "LocalWorld":
        ctx = multiprocessing.get_context("spawn")
        self._inbox, self._results = ctx.Queue(), ctx.Queue()
        if self.rendezvous is None:
            # a file store in a directory of this world's own: a TCP port
            # picked before the ranks bind it could be picked by another
            # world started meanwhile, whose ranks would then join this one
            self._store_dir = tempfile.mkdtemp(prefix="run_world-")
            init = "file://" + os.path.join(self._store_dir, "store")
        else:
            init = f"tcp://{self.rendezvous}"
        # the deadline is set before the spawn, and the ranks get it as a
        # unix time (another process's monotonic clock means nothing)
        deadline = None
        if self.timeout_s is not None:
            deadline = time.time() + self.timeout_s
            self._deadline = time.monotonic() + self.timeout_s
        self.procs = [ctx.Process(target=_world_main, args=(
            r, self.n_local, self.rank_offset, self.world_size, init,
            self.backend, self.visible, self.timeout_s, deadline,
            os.getpid(), self.shared, self._inbox, self._results),
            daemon=True) for r in range(self.n_local)]
        self.spawned = time.time()
        for p in self.procs:
            p.start()
        self.pids = [p.pid for p in self.procs]
        # The work goes by queue, not in the processes' arguments: a spawned
        # child unpickles its arguments as it reads them, importing torch
        # halfway, and the parent's write of large arguments would wait for
        # each child in turn.
        for _ in self.procs:
            self._inbox.put((self.target, self.args))
        return self

    def _ended(self) -> bool:
        return (len(self.got) + len(self.errors) == self.n_local
                or time.monotonic() >= self._deadline)

    def poll(self, timeout_s: float = 1.0) -> bool:
        """Take a report that arrives within ``timeout_s`` (none waits:
        0); returns whether the world has ended — every rank reported, a
        rank failed and the others' grace is up, or the deadline passed."""
        if self._ended():
            return True
        try:
            local, result, err = (self._results.get(timeout=timeout_s)
                                  if timeout_s > 0
                                  else self._results.get_nowait())
        except queue.Empty:
            # a process gone without a report (killed, or a crash below
            # Python) leaves its peers waiting for it in a rendezvous or a
            # collective: fail now, not at the deadline
            for r, p in enumerate(self.procs):
                if p.exitcode is not None and r not in self.got \
                        and r not in self.errors and self._results.empty():
                    self._fail(r, f"{_exit_text(p.exitcode)} before "
                                  "reporting")
            return self._ended()
        if err is None:
            self.got[local] = result
        else:
            self._fail(local, err)
        return self._ended()

    def _fail(self, local: int, text: str) -> None:
        self.errors[local] = text
        self._deadline = min(self._deadline,
                             time.monotonic() + FAILURE_GRACE_S)

    def exits(self) -> dict[int, dict]:
        """Each rank's pid and end so far, by global rank: its exit code,
        and the signal that killed it (None while it runs)."""
        out = {}
        for r, p in enumerate(self.procs):
            code = self._ends.get(r) if r in self._ends else p.exitcode
            out[self.rank_offset + r] = {
                "pid": self.pids[r], "exitcode": code,
                "signal": (signal.Signals(-code).name
                           if code is not None and code < 0 else None)}
        return out

    def result(self) -> list[Any]:
        """Each rank's result in local order; raises RuntimeError with the
        failed ranks' tracebacks (or exit codes and signals), TimeoutError
        when a rank has not reported by the deadline."""
        n = self.n_local
        if self.errors:
            raise RuntimeError(
                f"{len(self.errors)} of {n} ranks failed:\n" + "\n".join(
                    f"-- rank {self.rank_offset + r}:\n{tb}"
                    for r, tb in sorted(self.errors.items())))
        missing = sorted(self.rank_offset + r for r in set(range(n))
                         - set(self.got))
        if missing:
            raise TimeoutError(
                f"ranks {missing} of a world of {self.world_size} did not "
                f"report within {self.timeout_s:.0f}s")
        return [self.got[r] for r in range(n)]

    def wait(self) -> list[Any]:
        """Block until the world ends; :meth:`result`."""
        while not self.poll(1.0):
            pass
        return self.result()

    def close(self) -> None:
        """Stop every rank still running and release the queues and the
        rendezvous directory, so that a world leaves no process, thread or
        pipe behind. Idempotent."""
        if self._closed:
            return
        self._closed = True
        for p in self.procs:
            p.join(timeout=5 if len(self.got) == self.n_local else 0.1)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        for r, p in enumerate(self.procs):
            if r not in self._ends and not p.is_alive():
                self._ends[r] = p.exitcode
                p.close()         # its sentinel pipe
        if self.procs:
            _close(self._inbox)
            _close(self._results)
        if self._store_dir is not None:
            shutil.rmtree(self._store_dir, ignore_errors=True)

    def __enter__(self) -> "LocalWorld":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()


def run_world(n: int, target: Callable, args: tuple = (),
              device: str | torch.device = "cuda",
              timeout_s: float = WORLD_TIMEOUT_S) -> list[Any]:
    """Run ``target(device, *args)`` in ``n`` fresh processes that form one
    ``torch.distributed`` world — NCCL with one GPU each (rank r on
    ``cuda:r``) for ``device="cuda"``, gloo for ``"cpu"`` — and return each
    rank's (picklable) result, in rank order: a :class:`LocalWorld` of
    ranks 0 … n - 1 of a world of n.

    ``target`` must be importable by name (a module-level function); the
    processes are spawned, so they import what it needs afresh. Raises
    RuntimeError with the tracebacks when a rank fails or exits without
    reporting, TimeoutError when a rank has not reported by the deadline;
    the processes are stopped either way, so a hung collective never hangs
    the caller."""
    dev = resolve_device(device)
    if n < 1:
        raise ValueError(f"a world needs at least one process, got {n}")
    if dev.type == "cuda" and n > torch.cuda.device_count():
        raise ValueError(f"a world of {n} GPUs asked for, "
                         f"{torch.cuda.device_count()} visible")
    with LocalWorld(n, target, args, device=dev,
                    timeout_s=timeout_s) as world:
        return world.wait()
