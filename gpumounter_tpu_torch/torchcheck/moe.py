"""Mixture-of-Experts FFN with expert parallelism (the ``expert`` dim).

Counterpart of :mod:`gpumounter_tpu.jaxcheck.moe`: top-1 ("switch")
routing with GShard capacity — each token goes to its argmax expert and
is dropped when that expert's buffer is full; a [S, E, C] one-hot
dispatch gathers the expert inputs [E, C, d], each expert runs its FFN,
and the combine, weighted by the router probability, scatters the outputs
back to [S, d].

Over a ``(data, expert)`` mesh the expert weights are split over
``expert`` and the tokens over both dims: a data shard's tokens are cut
into one contiguous slice per expert rank (the first ones a token longer
where they do not divide). Two all-to-alls over
``expert`` carry the dispatch (a rank's expert inputs to the rank owning
each expert) and the combine (the outputs back). The JAX package runs the
same function under GSPMD, where it sees the *global* token batch: the
capacity is the global one, and a token's place in its expert's buffer
counts every token before it in global order. So each rank offsets its
running counts by the per-expert counts of the ranks before it — an
exclusive scan over ``expert`` inside the data shard, then over ``data``
— and drops the same tokens JAX drops.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F

from gpumounter_tpu_torch.torchcheck import dist as dist_lib
from gpumounter_tpu_torch.torchcheck import resolve_device

Params = dict[str, Any]
DATA_AXIS, EXPERT_AXIS = "data", "expert"     # the mesh's dim names


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int = 64
    d_ff: int = 128          # per-expert hidden width
    n_experts: int = 4
    capacity_factor: float = 1.25
    dtype: torch.dtype = torch.float32

    def capacity(self, n_tokens: int) -> int:
        """Per-expert token slots (GShard: tokens/experts * factor,
        rounded up; >=1 so tiny test shapes stay legal)."""
        return max(1, math.ceil(n_tokens / self.n_experts
                                * self.capacity_factor))


def init_moe_params(cfg: MoEConfig, generator: torch.Generator | None = None,
                    device: str | torch.device = "cuda") -> Params:
    """Router [d, E], w1 [E, d, f], w2 [E, f, d] drawn from ``generator``
    (seed 0 on ``device`` when omitted) at the JAX package's scales."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)

    def normal(shape, scale):
        return (torch.randn(shape, generator=generator, device=device)
                * scale).to(cfg.dtype)

    scale = 1.0 / math.sqrt(cfg.d_model)
    return {"router": normal((cfg.d_model, cfg.n_experts), scale),
            "w1": normal((cfg.n_experts, cfg.d_model, cfg.d_ff), scale),
            "w2": normal((cfg.n_experts, cfg.d_ff, cfg.d_model),
                         1.0 / math.sqrt(cfg.d_ff))}


def moe_param_shardings() -> dict[str, tuple]:
    """Expert-sharded weights; the router is tiny and replicated."""
    return {"router": (), "w1": (EXPERT_AXIS, None, None),
            "w2": (EXPERT_AXIS, None, None)}


def with_expert_sharding(mesh, params: Params) -> Params:
    """This rank's shard of every MoE parameter (every rank holds the same
    full ``params``)."""
    return dist_lib.shard_tree(params, mesh, moe_param_shardings())


def moe_ffn(params: Params, x: torch.Tensor, cfg: MoEConfig,
            mesh=None) -> torch.Tensor:
    """x [..., S, d] -> [..., S, d] (leading dims flattened internally).
    Tokens dropped for capacity contribute zero (the residual connection
    around the FFN makes that a no-op, the switch-transformer behavior).

    With ``mesh``: ``x`` is this rank's data shard (the same on every
    expert rank of it), ``params`` its shards (:func:`with_expert_sharding`);
    the result is the whole data shard's output on every expert rank."""
    lead, (s, d) = x.shape[:-2], x.shape[-2:]
    xs = x.reshape(-1, d)
    n_tokens = xs.shape[0]
    ep = None
    if mesh is not None:
        ep = mesh.get_group(EXPERT_AXIS)
        n_ep = dist_lib.axis_size(mesh, EXPERT_AXIS)
        n_tokens *= dist_lib.axis_size(mesh, DATA_AXIS)
        # contiguous slices, the first n_tokens % n_ep one token longer
        base, rem = divmod(xs.shape[0], n_ep)
        sizes = [base + (i < rem) for i in range(n_ep)]
        e = dist_lib.axis_index(mesh, EXPERT_AXIS)
        # x is replicated over expert: its gradient is the sum of the ranks'
        xs = dist_lib.copy_to_group(xs, ep)[sum(sizes[:e]):][:sizes[e]]
    capacity = cfg.capacity(n_tokens)

    logits = xs.float() @ params["router"].float()             # [S, E]
    probs = torch.softmax(logits, dim=-1)
    expert_gate, expert_index = probs.max(dim=-1)              # [S]

    # position of each token within its expert's capacity buffer, counted
    # over the global token order
    onehot = F.one_hot(expert_index, cfg.n_experts)             # [S, E]
    position = torch.cumsum(onehot, dim=0)
    if mesh is not None:
        counts = onehot.sum(dim=0)
        before_ep, shard_total = dist_lib.exclusive_scan(counts, ep)
        before_data, _ = dist_lib.exclusive_scan(
            shard_total, mesh.get_group(DATA_AXIS))
        position = position + before_ep + before_data
    position = position * onehot - 1
    kept = (position >= 0) & (position < capacity)
    dispatch = ((position[..., None] == torch.arange(capacity,
                                                     device=xs.device))
                & kept[..., None]).to(xs.dtype)                 # [S, E, C]
    combine = dispatch * expert_gate[:, None, None].to(xs.dtype)

    expert_in = torch.einsum("sec,sd->ecd", dispatch, xs)      # [E, C, d]
    if ep is not None:   # to the experts' ranks: [E/n, n*C, d]
        expert_in = dist_lib.all_to_all(expert_in, ep, split_dim=0,
                                        concat_dim=1)
    h = F.gelu(torch.einsum("ecd,edf->ecf", expert_in, params["w1"]),
               approximate="tanh")
    expert_out = torch.einsum("ecf,efd->ecd", h, params["w2"])
    if ep is not None:   # back to the tokens' ranks: [E, C, d]
        expert_out = dist_lib.all_to_all(expert_out, ep, split_dim=1,
                                         concat_dim=0)
    out = torch.einsum("sec,ecd->sd", combine, expert_out)     # [S, d]
    if ep is not None:   # the data shard's tokens, from every expert rank
        most = max(sizes)
        out = dist_lib.gather_from_group(
            F.pad(out, (0, 0, 0, most - out.shape[0])), ep, 0)
        out = torch.cat([out[i * most:][:size]
                         for i, size in enumerate(sizes)])
    return out.reshape(*lead, s, d)


def make_moe_value_and_grad(cfg: MoEConfig, mesh=None):
    """``value_and_grad(params, x) -> (loss, grads)`` of the dryrun's loss,
    an L2 to the input shifted one token, so gradients flow through router
    and experts. With ``mesh``: ``x`` is this rank's data shard
    [B/data, S, d] and ``params`` its shards; the loss is the global mean
    and each gradient is summed over the mesh dims its parameter is not
    split over (tokens are split over both)."""
    specs = moe_param_shardings()

    def value_and_grad(params: Params, x: torch.Tensor):
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        y = moe_ffn(leaves, x, cfg, mesh)
        sq = torch.square(y - torch.roll(x, 1, dims=-2))
        if mesh is None:
            loss = sq.mean()
        else:
            loss = sq.sum() / (sq.numel()
                               * dist_lib.axis_size(mesh, DATA_AXIS))
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(
            leaves.values()))))
        if mesh is not None:
            for name, g in grads.items():
                for axis in (DATA_AXIS, EXPERT_AXIS):
                    if axis not in specs[name]:
                        dist_lib.all_reduce_(g, mesh.get_group(axis))
            loss = dist_lib.all_reduce_(loss.detach().clone(),
                                        mesh.get_group(DATA_AXIS))
        return loss.detach(), grads

    return value_and_grad


def make_moe_train_step(cfg: MoEConfig, mesh=None):
    """Minimal EP training step for the dryrun: ``step(params, x) ->
    (params, loss)``, the loss and gradients of
    :func:`make_moe_value_and_grad`, then SGD at 0.1."""
    value_and_grad = make_moe_value_and_grad(cfg, mesh)

    def step(params: Params, x: torch.Tensor):
        loss, grads = value_and_grad(params, x)
        return {k: (p - 0.1 * grads[k].to(p.dtype)).detach()
                for k, p in params.items()}, loss

    return step
