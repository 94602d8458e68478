"""Training step for the validation model.

Counterpart of :mod:`gpumounter_tpu.jaxcheck.train`: forward, next-token
cross-entropy, backward, AdamW update. PyTorch runs eagerly, so the step is
a plain function; the optimizer updates the parameters in place (JAX
builds new arrays and donates the old ones).

Over a ``(data, seq, model)`` mesh each rank steps its own shards: the
loss is the next-token cross-entropy of the *global* sequence (a seq
shard's last position predicts the first token of the next shard), the
gradients of every parameter are summed over ``data`` and ``seq`` (the
model split's operators already make them whole over ``model``), and
AdamW, elementwise, updates the local shards as it would the whole.

The *state tree* (:func:`state_tree`, :func:`state_from_tree`) is the
train state as plain data, what a checkpoint holds and what JAX's
``TrainState`` pytree is to the JAX package::

    {"params": {name: tensor},
     "opt": {name: {"exp_avg": tensor, "exp_avg_sq": tensor, "step": tensor}},
     "step": int}

``name`` is the parameter's ``state_dict`` name; on a mesh each tensor is
this rank's shard, and ``elastic.state_specs`` gives every leaf's spec
(a moment has its parameter's, the AdamW step counters are replicated).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.nn.functional as F

from gpumounter_tpu_torch.torchcheck import dist as dist_lib
from gpumounter_tpu_torch.torchcheck import model as model_lib
from gpumounter_tpu_torch.torchcheck import resolve_device
from gpumounter_tpu_torch.torchcheck.model import ModelConfig


@dataclasses.dataclass
class TrainState:
    model: model_lib.Transformer
    optimizer: torch.optim.Optimizer
    step: int = 0


def cross_entropy(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Next-token CE in f32 (stable in bf16 models)."""
    logits = logits[:, :-1].float()
    targets = tokens[:, 1:]
    logp = F.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None])
    return nll.mean()


def make_optimizer(params, lr: float = 3e-4) -> torch.optim.Optimizer:
    """``optax.adamw(lr, b1=0.9, b2=0.95, weight_decay=0.01)``: eps 1e-8,
    decoupled weight decay on every parameter (optax masks none)."""
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.95), eps=1e-8,
                             weight_decay=0.01)


def sharded_cross_entropy(logits: torch.Tensor, tokens: torch.Tensor,
                          mesh) -> tuple[torch.Tensor, int]:
    """:func:`cross_entropy` of the global [B, T] batch from this rank's
    [B/data, T/seq] shard: (this shard's sum of next-token NLL, the global
    count B * (T - 1) the mean divides by). The target of the shard's last
    position is the first token of the next seq shard; the global last
    position predicts nothing."""
    seq = mesh.get_group("seq")
    n_seq = dist_lib.axis_size(mesh, "seq")
    nxt = dist_lib.permute([tokens[:, :1]], seq, -1)[0]
    targets = torch.cat([tokens[:, 1:], nxt], dim=1)
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    if dist_lib.axis_index(mesh, "seq") == n_seq - 1:
        nll = nll[:, :-1]
    count = (tokens.shape[0] * dist_lib.axis_size(mesh, "data")
             * (tokens.shape[1] * n_seq - 1))
    return nll.sum(), count


def _sum_over(tensors: list[torch.Tensor], groups) -> None:
    """Sum ``tensors`` in place over each of ``groups``, one all-reduce of
    one flat buffer per group."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    for group in groups:
        dist_lib.all_reduce_(flat, group)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


def init_state(cfg: ModelConfig, seed: int = 0,
               device: str | torch.device = "cuda", mesh=None,
               lr: float = 3e-4) -> TrainState:
    """Weights from ``seed``; with ``mesh``, every rank draws the same full
    weights and keeps its shard (:func:`~.model.shard_model`)."""
    device = resolve_device(device)
    generator = torch.Generator(device=device).manual_seed(seed)
    model = model_lib.Transformer(cfg, generator, device)
    if mesh is not None:
        model_lib.shard_model(model, mesh)
    return TrainState(model, make_optimizer(model.parameters(), lr))


def state_tree(state: TrainState) -> dict:
    """The state tree of ``state`` (module docstring). Its tensors are the
    live ones (detached, not copied). Before AdamW's first step its state
    is empty; the tree then holds zero moments and step 0, which is what
    AdamW starts from (as optax's ``init`` state is)."""
    opt = {}
    for name, param in state.model.named_parameters():
        saved = state.optimizer.state.get(param, {})
        opt[name] = {
            "exp_avg": saved.get("exp_avg", torch.zeros_like(param)),
            "exp_avg_sq": saved.get("exp_avg_sq", torch.zeros_like(param)),
            "step": saved.get("step", torch.tensor(0.0))}
    return {"params": {name: p.detach()
                       for name, p in state.model.named_parameters()},
            "opt": opt, "step": int(state.step)}


def state_from_tree(cfg: ModelConfig, tree: dict,
                    device: str | torch.device = "cuda",
                    lr: float = 3e-4) -> TrainState:
    """A fresh :class:`TrainState` holding ``tree``'s values: the model's
    parameters, AdamW's moments and per-parameter step (so bias
    correction continues where it was), and the step counter. Each
    tensor must already be this rank's shard (``drain.restore_sharded``
    places them); the moments land on ``device`` in their parameter's
    dtype, the AdamW steps as float32 on the CPU, as AdamW keeps them."""
    device = resolve_device(device)
    # the structure only (no weights drawn); every parameter is replaced
    # by its value in the tree, which may be a shard
    model = model_lib.Transformer(cfg, torch.Generator(), "meta")
    for name, _ in list(model.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        value = tree["params"][name].detach()
        setattr(model.get_submodule(owner), leaf, torch.nn.Parameter(
            value.to(device=device, dtype=cfg.dtype).clone()))
    optimizer = make_optimizer(model.parameters(), lr)
    for name, param in model.named_parameters():
        moments = tree["opt"][name]
        optimizer.state[param] = {
            "step": torch.tensor(float(moments["step"]),
                                 dtype=torch.float32),
            **{key: moments[key].detach().to(
                device=device, dtype=param.dtype).clone()
               for key in ("exp_avg", "exp_avg_sq")}}
    return TrainState(model, optimizer, int(tree["step"]))


def make_train_step(cfg: ModelConfig, mesh=None,
                    attn_impl: str = "ring") -> Callable:
    """Returns ``step(state, tokens) -> (state, loss)``. Without a mesh:
    full attention, or the trainable flash attention on the Hopper kernels
    with ``attn_impl="flash"`` (the single-GPU long-context path). With a
    mesh: ``tokens`` is this rank's [B/data, T/seq] shard and ``state``
    holds its parameter shards (:func:`init_state`); the attention is
    ``attn_impl`` over ``seq`` and the loss is the global mean on every
    rank. The returned loss is detached; reading it synchronises with the
    device."""
    attn = model_lib.make_attention(mesh, cfg, impl=attn_impl)
    groups = (() if mesh is None else
              tuple(mesh.get_group(a) for a in ("data", "seq")))

    def step(state: TrainState, tokens: torch.Tensor):
        state.optimizer.zero_grad(set_to_none=True)
        logits = model_lib.forward(state.model, tokens, cfg, attn_fn=attn,
                                   mesh=mesh)
        if mesh is None:
            loss = cross_entropy(logits, tokens)
            loss.backward()
        else:
            nll_sum, count = sharded_cross_entropy(logits, tokens, mesh)
            (nll_sum / count).backward()
            params = list(state.model.parameters())
            _sum_over([p.grad for p in params], groups)
            loss = nll_sum.detach().clone()
            _sum_over([loss], groups)
            loss = loss / count
        state.optimizer.step()
        state.step += 1
        return state, loss.detach()

    return step


def make_batch(generator: torch.Generator, batch: int, seq: int,
               vocab: int = 256) -> torch.Tensor:
    """Synthetic next-token-predictable data: arithmetic sequences mod
    ``vocab``, so a few steps of training measurably reduce loss. Drawn
    from ``generator`` on its device (the JAX package draws from
    ``jax.random``, so the two differ for one seed)."""
    device = generator.device
    start = torch.randint(0, min(64, vocab), (batch, 1), generator=generator,
                          device=device)
    stride = torch.randint(1, 4, (batch, 1), generator=generator,
                           device=device)
    return (start + stride * torch.arange(seq, device=device)[None]) % vocab
