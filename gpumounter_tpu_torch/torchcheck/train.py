"""Training step for the validation model.

Counterpart of :mod:`gpumounter_tpu.jaxcheck.train`: forward, next-token
cross-entropy, backward, AdamW update. PyTorch runs eagerly, so the step is
a plain function; the optimizer updates the parameters in place (JAX
builds new arrays and donates the old ones).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.nn.functional as F

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


def init_state(cfg: ModelConfig, seed: int = 0,
               device: str | torch.device = "cuda") -> TrainState:
    device = resolve_device(device)
    generator = torch.Generator(device=device).manual_seed(seed)
    model = model_lib.Transformer(cfg, generator, device)
    return TrainState(model, make_optimizer(model.parameters()))


def make_train_step(cfg: ModelConfig, mesh=None,
                    attn_impl: str = "ring") -> Callable:
    """Returns ``step(state, tokens) -> (state, loss)``. Without a mesh:
    full attention, or the trainable flash attention on the Hopper kernels
    with ``attn_impl="flash"`` (the single-GPU long-context path). The
    returned loss is detached; reading it synchronises with the device."""
    attn = model_lib.make_attention(mesh, cfg, impl=attn_impl)

    def step(state: TrainState, tokens: torch.Tensor):
        state.optimizer.zero_grad(set_to_none=True)
        logits = model_lib.forward(state.model, tokens, cfg, attn_fn=attn)
        loss = cross_entropy(logits, tokens)
        loss.backward()
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
