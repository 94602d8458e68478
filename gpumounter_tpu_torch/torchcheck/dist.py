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
seed, and keeps only its own slice (:func:`shard`).

Inside a group, peers are named by their global ranks
(``dist.get_global_rank``); a group of one moves nothing, so every
collective here returns its input unchanged for it.
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import queue
import socket
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


# -- worlds of processes --------------------------------------------------------

def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _world_main(rank: int, world: int, port: int, backend: str,
                timeout_s: float, inbox, results) -> None:
    """One process of :func:`run_world`."""
    try:
        target, args = inbox.get(timeout=timeout_s)
        if backend == "nccl":
            torch.cuda.set_device(rank)
            device = torch.device("cuda", rank)
        else:
            device = torch.device("cpu")
            # the ranks share the host's cores
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        dist.init_process_group(
            backend, init_method=f"tcp://127.0.0.1:{port}", world_size=world,
            rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
        try:
            result = target(device, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, result, None))
    except Exception:    # reported to the parent, which raises it
        results.put((rank, None, traceback.format_exc()))


def run_world(n: int, target: Callable, args: tuple = (),
              device: str | torch.device = "cuda",
              timeout_s: float = WORLD_TIMEOUT_S) -> list[Any]:
    """Run ``target(device, *args)`` in ``n`` fresh processes that form one
    ``torch.distributed`` world — NCCL with one GPU each (rank r on
    ``cuda:r``) for ``device="cuda"``, gloo for ``"cpu"`` — and return each
    rank's (picklable) result, in rank order.

    ``target`` must be importable by name (a module-level function); the
    processes are spawned, so they import what it needs afresh. Raises
    RuntimeError with the tracebacks when a rank fails, TimeoutError when a
    rank has not reported by the deadline; the processes are stopped
    either way, so a hung collective never hangs the caller."""
    dev = resolve_device(device)
    if n < 1:
        raise ValueError(f"a world needs at least one process, got {n}")
    if dev.type == "cuda" and n > torch.cuda.device_count():
        raise ValueError(f"a world of {n} GPUs asked for, "
                         f"{torch.cuda.device_count()} visible")
    backend = "nccl" if dev.type == "cuda" else "gloo"
    ctx = multiprocessing.get_context("spawn")
    inbox, results = ctx.Queue(), ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_world_main,
                         args=(r, n, port, backend, timeout_s, inbox,
                               results), daemon=True)
             for r in range(n)]
    for p in procs:
        p.start()
    # The work goes by queue, not in the processes' arguments: a spawned
    # child unpickles its arguments as it reads them, importing torch
    # halfway, and the parent's write of large arguments would wait for
    # each child in turn.
    for _ in procs:
        inbox.put((target, args))
    got: dict[int, Any] = {}
    errors: dict[int, str] = {}
    deadline = time.monotonic() + timeout_s
    try:
        while len(got) + len(errors) < n and time.monotonic() < deadline:
            try:
                rank, result, err = results.get(timeout=1.0)
            except queue.Empty:
                if not any(p.is_alive() for p in procs) and results.empty():
                    break
                continue
            if err is None:
                got[rank] = result
            else:
                errors[rank] = err
                deadline = min(deadline, time.monotonic() + FAILURE_GRACE_S)
    finally:
        for p in procs:
            p.join(timeout=5 if len(got) == n else 0.1)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    if errors:
        raise RuntimeError(
            f"{len(errors)} of {n} ranks failed:\n" + "\n".join(
                f"-- rank {r}:\n{tb}" for r, tb in sorted(errors.items())))
    missing = sorted(set(range(n)) - set(got))
    if missing:
        raise TimeoutError(f"ranks {missing} of a world of {n} did not report "
                           f"within {timeout_s:.0f}s")
    return [got[r] for r in range(n)]
