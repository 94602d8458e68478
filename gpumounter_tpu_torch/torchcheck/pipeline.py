"""GPipe-style pipeline parallelism (the ``pipe`` dim).

Counterpart of :mod:`gpumounter_tpu.jaxcheck.pipeline`. Layers are split
into contiguous stages, one per rank of the ``pipe`` mesh dim;
microbatches stream through the stages with one :func:`~.dist.ppermute`
hop per schedule step (M + n - 1 steps, the GPipe bubble). The backward is
autograd's through the schedule, as JAX's AD transposes its ``ppermute``:
each hop's backward sends the cotangent back a stage.

Each rank's autograd runs only its own graph, so every rank must reach
every hop's backward, or a neighbour waits for a send that never comes.
The schedule keeps the JAX package's ``where`` selections for that: stage
0's input and the last stage's output buffer are chosen with
``torch.where`` on every rank, which keeps each hop on every rank's path
from the loss (with a zero cotangent where the value is not used).
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.nn.functional as F

from gpumounter_tpu_torch.torchcheck import dist as dist_lib
from gpumounter_tpu_torch.torchcheck import resolve_device

Params = dict[str, Any]
PIPE_AXIS = "pipe"        # the mesh's dim name


def stack_stage_params(layer_params: list[Params], n_stages: int) -> Params:
    """[L] list of per-layer dicts -> dict of [n_stages, L/n_stages, ...]
    tensors, ready to shard over the pipe dim."""
    n_layers = len(layer_params)
    if n_layers % n_stages:
        raise ValueError(f"{n_layers} layers not divisible into {n_stages} "
                         "stages")
    per = n_layers // n_stages
    return {k: torch.stack([layer[k] for layer in layer_params]).reshape(
                (n_stages, per) + tuple(layer_params[0][k].shape))
            for k in layer_params[0]}


def make_pipeline(mesh, block_fn: Callable[[Params, torch.Tensor],
                                           torch.Tensor]):
    """Returns ``run(stage_params, microbatches) -> outputs``.

    - ``stage_params``: this rank's [1, layers_per_stage, ...] shard of the
      stacked parameters (:func:`place_stage_params`).
    - ``microbatches``: [M, mb, ...], the same on every stage (only stage
      0 consumes them).
    - returns [M, mb, ...] outputs, the same on every stage.

    ``block_fn(layer_params, x) -> x`` applies ONE layer."""
    group = mesh.get_group(PIPE_AXIS)
    n = dist_lib.axis_size(mesh, PIPE_AXIS)

    def stage_apply(stage_params, x):
        for i in range(next(iter(stage_params.values())).shape[0]):
            x = block_fn({k: v[i] for k, v in stage_params.items()}, x)
        return x

    def run(stage_params: Params, mbs: torch.Tensor) -> torch.Tensor:
        stage_params = {k: v[0] for k, v in stage_params.items()}
        p = dist_lib.axis_index(mesh, PIPE_AXIS)
        first = torch.tensor(p == 0, device=mbs.device)
        last = torch.tensor(p == n - 1, device=mbs.device)
        m = mbs.shape[0]
        steps = m + n - 1
        act = torch.zeros_like(mbs[0])
        outs = [torch.zeros_like(mbs[0]) for _ in range(m)]
        for t in range(steps):
            # stage 0 injects microbatch t (clipped: the bubble's extra
            # work never reaches an output)
            x = torch.where(first, mbs[min(t, m - 1)], act)
            y = stage_apply(stage_params, x)
            idx = t - (n - 1)           # the last stage emits microbatch idx
            if idx >= 0:
                outs[idx] = torch.where(last, y, outs[idx])
            if t < steps - 1:           # the last hop would feed no step
                act = dist_lib.ppermute(y, group, 1)
        # the buffer is non-zero only on the last stage; the sum hands it
        # to every stage, and its backward hands each stage the cotangent
        # once (a psum transposed to a psum would count it n times)
        return dist_lib.reduce_from_group(torch.stack(outs), group)

    return run


def mlp_block(layer: Params, x: torch.Tensor) -> torch.Tensor:
    """The block used by tests and the dryrun: residual MLP."""
    return x + F.gelu(x @ layer["w1"], approximate="tanh") @ layer["w2"]


def make_mlp_layers(n_layers: int, d: int,
                    generator: torch.Generator | None = None,
                    device: str | torch.device = "cuda") -> list[Params]:
    """Per-layer params matching :func:`mlp_block`, drawn from
    ``generator`` (seed 0 on ``device`` when omitted)."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    return [{"w1": torch.randn((d, 2 * d), generator=generator,
                               device=device) / d ** 0.5,
             "w2": torch.randn((2 * d, d), generator=generator,
                               device=device) / (2 * d) ** 0.5}
            for _ in range(n_layers)]


def make_pipeline_train_step(mesh):
    """Pipelined training step of :func:`mlp_block` layers for the dryrun:
    ``step(stage_params, mbs) -> (stage_params, loss)``, forward through
    the pipeline, L2 loss,
    gradients through the schedule by autograd, SGD at 0.1. Every stage
    computes the same loss and the whole gradient of its own stage."""
    pipeline = make_pipeline(mesh, mlp_block)

    def step(stage_params: Params, mbs: torch.Tensor):
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in stage_params.items()}
        out = pipeline(leaves, mbs)
        loss = torch.mean(torch.square(out - torch.roll(mbs, 1, dims=-2)))
        grads = torch.autograd.grad(loss, list(leaves.values()))
        new = {k: (p - 0.1 * g.to(p.dtype)).detach()
               for (k, p), g in zip(stage_params.items(), grads)}
        return new, loss.detach()

    return step


def place_stage_params(mesh, stage_params: Params) -> Params:
    """This rank's [1, layers_per_stage, ...] shard of the stacked
    parameters."""
    return dist_lib.shard_tree(stage_params, mesh,
                               {k: (PIPE_AXIS,) for k in stage_params})
