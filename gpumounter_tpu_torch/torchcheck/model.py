"""Flagship validation model: a decoder-only transformer LM in PyTorch.

Counterpart of :mod:`gpumounter_tpu.jaxcheck.model`: the workload the
in-pod probe trains after an attach to prove the GPU genuinely computes,
and, at :func:`~.perf.mxu_config` width, the measured train step. The
parameters keep the JAX pytree's names and shapes (``embed``, ``lm_head``,
``ln_f.g``, ``layers.{i}.{ln1.g, wqkv[d, 3, H, hd], wo[H, hd, d], ln2.g,
w1, w2}``), so :mod:`.convert` carries JAX weights over one to one.

Sharded attention over a mesh (ring, Ulysses) is a later slice: a model
without a mesh runs full attention, or ``impl="flash"`` for the trainable
flash attention on the Hopper kernels.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from gpumounter_tpu_torch.torchcheck import resolve_device
from gpumounter_tpu_torch.torchcheck.ring_attention import full_attention


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    vocab: int = 256
    d_model: int = 128
    n_heads: int = 8
    n_layers: int = 2
    d_ff: int = 512
    dtype: torch.dtype = torch.float32     # bfloat16 on the GPU

    @property
    def head_dim(self) -> int:
        if self.d_model % self.n_heads:
            raise ValueError(f"d_model {self.d_model} not divisible by "
                             f"n_heads {self.n_heads}")
        return self.d_model // self.n_heads


class _Norm(nn.Module):
    """RMSNorm gain, a module of its own so its parameter is ``<name>.g``
    as in the JAX pytree."""

    def __init__(self, d: int, dtype: torch.dtype, device: torch.device):
        super().__init__()
        self.g = nn.Parameter(torch.ones(d, dtype=dtype, device=device))


class _Layer(nn.Module):
    def __init__(self, cfg: ModelConfig, dense: Callable, device):
        super().__init__()
        d, h, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
        self.ln1 = _Norm(d, cfg.dtype, device)
        self.wqkv = dense((d, 3, h, hd))
        self.wo = dense((h, hd, d), scale=1.0 / math.sqrt(d))
        self.ln2 = _Norm(d, cfg.dtype, device)
        self.w1 = dense((d, cfg.d_ff))
        self.w2 = dense((cfg.d_ff, d))


class Transformer(nn.Module):
    """The flagship LM. Weights are drawn from ``generator`` (a
    ``torch.Generator`` on ``device``; seed 0 when omitted) with the JAX
    package's scales: N(0, 1/fan_in) dense layers, 0.02 embeddings."""

    def __init__(self, cfg: ModelConfig,
                 generator: torch.Generator | None = None,
                 device: str | torch.device = "cuda"):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        self.cfg = cfg

        def dense(shape, scale=None):
            scale = scale or 1.0 / math.sqrt(shape[0])
            w = torch.randn(shape, generator=generator, dtype=torch.float32,
                            device=device) * scale
            return nn.Parameter(w.to(cfg.dtype))

        self.embed = dense((cfg.vocab, cfg.d_model), scale=0.02)
        self.lm_head = dense((cfg.d_model, cfg.vocab))
        self.ln_f = _Norm(cfg.d_model, cfg.dtype, device)
        self.layers = nn.ModuleList(
            _Layer(cfg, dense, device) for _ in range(cfg.n_layers))

    def forward(self, tokens: torch.Tensor,
                attn_fn: Callable | None = None) -> torch.Tensor:
        return forward(self, tokens, self.cfg, attn_fn)


def _rmsnorm(x, g):
    """RMSNorm with the reference's rounding: the variance in f32, its
    rsqrt cast back to x's dtype before the product."""
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + 1e-6).to(x.dtype)) * g


def _positions(t: int, d: int, dtype: torch.dtype,
               device: torch.device | str = "cpu") -> torch.Tensor:
    """Fixed sinusoidal positions — parameter-free."""
    pos = torch.arange(t, device=device, dtype=torch.float32)[:, None]
    dim = torch.arange(d // 2, device=device, dtype=torch.float32)[None, :]
    angle = pos / torch.pow(10000.0, 2 * dim / d)
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1).to(dtype)


def forward(model: Transformer, tokens: torch.Tensor, cfg: ModelConfig,
            attn_fn: Callable | None = None) -> torch.Tensor:
    """tokens [B, T] int -> logits [B, T, vocab]. ``attn_fn`` is
    ``full_attention``-shaped ([B, T, H, D] q, k, v -> [B, T, H, D])."""
    attn = attn_fn or full_attention
    x = model.embed[tokens] + _positions(
        tokens.shape[1], cfg.d_model, cfg.dtype, tokens.device)[None]
    for layer in model.layers:
        h = _rmsnorm(x, layer.ln1.g)
        qkv = torch.einsum("btd,dchk->cbthk", h, layer.wqkv)
        out = attn(qkv[0], qkv[1], qkv[2])
        x = x + torch.einsum("bthk,hkd->btd", out, layer.wo)
        h = _rmsnorm(x, layer.ln2.g)
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(h @ layer.w1, approximate="tanh") @ layer.w2
        x = x + h
    x = _rmsnorm(x, model.ln_f.g)
    return x @ model.lm_head


def make_attention(mesh, cfg: ModelConfig, impl: str = "ring") -> Callable:
    """Attention for ``impl`` without a mesh: "flash" (or "ring_pallas")
    is the trainable flash attention on the Hopper kernels; "full" and the
    sharded impls ("ring", "ulysses", ...) are full attention, as in the
    JAX package when the seq axis is 1. A mesh is not ported yet."""
    del cfg
    if mesh is not None:
        raise NotImplementedError(
            "sharded attention over a mesh (ring, Ulysses) is not ported "
            "yet: ROADMAP Queue 1, parallel schemes")
    if impl in ("flash", "ring_pallas"):
        from gpumounter_tpu_torch.torchcheck.flash_attention import \
            make_flash_attention
        return make_flash_attention()
    if impl in ("ring", "ulysses", "ulysses_flash", "full"):
        return full_attention
    raise ValueError(f"unknown attention impl {impl!r}")
