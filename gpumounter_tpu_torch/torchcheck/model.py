"""Flagship validation model: a decoder-only transformer LM in PyTorch.

Counterpart of :mod:`gpumounter_tpu.jaxcheck.model`: the workload the
in-pod probe trains after an attach to prove the GPU genuinely computes,
and, at :func:`~.perf.mxu_config` width, the measured train step. The
parameters keep the JAX pytree's names and shapes (``embed``, ``lm_head``,
``ln_f.g``, ``layers.{i}.{ln1.g, wqkv[d, 3, H, hd], wo[H, hd, d], ln2.g,
w1, w2}``), so :mod:`.convert` carries JAX weights over one to one.

Over a ``(data, seq, model)`` mesh (:func:`make_mesh`) each rank holds
its shard of every parameter (:func:`param_shardings`, the Megatron split)
and of the tokens (batch over ``data``, sequence over ``seq``), and
:func:`forward` places explicitly what GSPMD placed for the JAX package:
the Megatron pair round the column- and row-parallel products, positions
from the shard's global offset, sequence-parallel attention over ``seq``
(ring or Ulysses), and the vocab-sharded logits gathered over ``model``.
Without a mesh the model runs full attention, or ``impl="flash"`` for the
trainable flash attention on the Hopper kernels.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from gpumounter_tpu_torch.torchcheck import dist as dist_lib
from gpumounter_tpu_torch.torchcheck import resolve_device
from gpumounter_tpu_torch.torchcheck.ring_attention import full_attention

MESH_AXES = ("data", "seq", "model")


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
               device: torch.device | str = "cpu",
               start: int = 0) -> torch.Tensor:
    """Fixed sinusoidal positions ``start .. start + t - 1`` —
    parameter-free; a sequence shard starts at its global offset."""
    pos = torch.arange(start, start + t, device=device,
                       dtype=torch.float32)[:, None]
    dim = torch.arange(d // 2, device=device, dtype=torch.float32)[None, :]
    angle = pos / torch.pow(10000.0, 2 * dim / d)
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1).to(dtype)


def forward(model: Transformer, tokens: torch.Tensor, cfg: ModelConfig,
            attn_fn: Callable | None = None, mesh=None) -> torch.Tensor:
    """tokens [B, T] int -> logits [B, T, vocab]. ``attn_fn`` is
    ``full_attention``-shaped ([B, T, H, D] q, k, v -> [B, T, H, D]).

    With ``mesh``: ``model`` holds this rank's parameter shards
    (:func:`shard_model`), ``tokens`` its [B/data, T/seq] shard, ``attn_fn``
    the sharded attention (:func:`make_attention`), and the result is this
    rank's [B/data, T/seq, vocab] logits (whole vocab). Each replicated
    input of a column-parallel product (``wqkv``, ``w1``, ``lm_head``) goes
    through :func:`~.dist.copy_to_group` over ``model``, so the replicated
    parameters before it (``ln*.g``, ``embed``) get the whole gradient on
    every model rank; each row-parallel output (``wo``, ``w2``) through
    :func:`~.dist.reduce_from_group`."""
    attn = attn_fn or full_attention
    if mesh is None:
        start = 0

        def tp_in(x):
            return x

        tp_out = tp_in
    else:
        start = dist_lib.axis_index(mesh, "seq") * tokens.shape[1]
        tp = mesh.get_group("model")

        def tp_in(x):
            return dist_lib.copy_to_group(x, tp)

        def tp_out(x):
            return dist_lib.reduce_from_group(x, tp)

    x = model.embed[tokens] + _positions(
        tokens.shape[1], cfg.d_model, cfg.dtype, tokens.device, start)[None]
    for layer in model.layers:
        h = tp_in(_rmsnorm(x, layer.ln1.g))
        qkv = torch.einsum("btd,dchk->cbthk", h, layer.wqkv)
        out = attn(qkv[0], qkv[1], qkv[2])
        x = x + tp_out(torch.einsum("bthk,hkd->btd", out, layer.wo))
        h = tp_in(_rmsnorm(x, layer.ln2.g))
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(h @ layer.w1, approximate="tanh") @ layer.w2
        x = x + tp_out(h)
    logits = tp_in(_rmsnorm(x, model.ln_f.g)) @ model.lm_head
    if mesh is None:
        return logits
    # the vocab-sharded logits, whole on every model rank; the backward
    # hands each rank the slice of its own columns
    return dist_lib.gather_from_group(logits, mesh.get_group("model"), -1)


def make_mesh(data: int | None = None, seq: int | None = None,
              model: int | None = None, device: str | torch.device = "cuda"):
    """A ``(data, seq, model)`` DeviceMesh over the initialised world, one
    process per device. Unspecified dims default to 1 except ``seq``,
    which absorbs the remainder (sequence parallelism is the long-context
    headline). Ranks map to coordinates data-major, then seq, then model,
    as the JAX package reshapes its device list."""
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve_device(device)
    if not torch.distributed.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(one process per device; see dist.run_world)")
    n = torch.distributed.get_world_size()
    data = data or 1
    model = model or 1
    if seq is None:
        seq, rem = divmod(n, data * model)
        if rem:
            raise ValueError(f"{n} devices not divisible by "
                             f"data*model={data * model}")
    if data * seq * model != n:
        raise ValueError(f"mesh {data}x{seq}x{model} does not cover "
                         f"{n} devices")
    return init_device_mesh(dev.type, (data, seq, model),
                            mesh_dim_names=MESH_AXES)


def param_shardings(cfg: ModelConfig) -> dict[str, tuple]:
    """The Megatron split as a spec per parameter name (the state_dict's
    names): ``wqkv`` and ``wo`` on heads, ``w1`` and ``w2`` on d_ff,
    ``lm_head`` on vocab; the rest replicated."""
    specs: dict[str, tuple] = {"embed": (), "lm_head": (None, "model"),
                               "ln_f.g": ()}
    for i in range(cfg.n_layers):
        specs.update({
            f"layers.{i}.ln1.g": (),
            f"layers.{i}.wqkv": (None, None, "model", None),  # column-par.
            f"layers.{i}.wo": ("model", None, None),          # row-parallel
            f"layers.{i}.ln2.g": (),
            f"layers.{i}.w1": (None, "model"),                # column-par.
            f"layers.{i}.w2": ("model", None),                # row-parallel
        })
    return specs


def shard_model(model: Transformer, mesh) -> Transformer:
    """Keep only this rank's shard of every parameter, in place (every rank
    built the same full model from the same seed)."""
    specs = param_shardings(model.cfg)
    for name, param in model.named_parameters():
        param.data = dist_lib.shard(param.data, mesh, specs[name])
    return model


def make_attention(mesh, cfg: ModelConfig, impl: str = "ring") -> Callable:
    """Sequence-parallel attention over the mesh's ``seq`` dim: ``impl`` is
    "ring" (K/V rotation, einsum blocks), "ring_pallas" (the same ring,
    the whole-K flash kernel for each block), "ulysses" or "ulysses_flash"
    (all-to-all head redistribution, full or flash attention locally).
    Without a mesh, or with a seq dim of 1: "flash" and "ring_pallas" are
    the trainable flash attention on the Hopper kernels, the rest full
    attention. "identity" returns ``v``, for ``perf.measure_roofline``'s
    ablation only: step(flash) - step(identity) is the in-step cost of the
    attention core."""
    if impl == "identity":
        return lambda q, k, v: v
    if impl not in ("ring", "ring_pallas", "ulysses", "ulysses_flash",
                    "flash", "full"):
        raise ValueError(f"unknown attention impl {impl!r}")
    if mesh is None or dist_lib.axis_size(mesh, "seq") == 1:
        if impl in ("flash", "ring_pallas"):
            from gpumounter_tpu_torch.torchcheck.flash_attention import \
                make_flash_attention
            return make_flash_attention()
        return full_attention
    if impl in ("ulysses", "ulysses_flash"):
        from gpumounter_tpu_torch.torchcheck.ulysses import \
            make_ulysses_attention
        # the per-rank head count after the model split must split over seq
        per_rank = (dist_lib.axis_size(mesh, "model")
                    * dist_lib.axis_size(mesh, "seq"))
        if cfg.n_heads % per_rank:
            raise ValueError(
                f"ulysses needs n_heads ({cfg.n_heads}) divisible by "
                f"model*seq mesh dims ({per_rank})")
        return make_ulysses_attention(
            mesh, local_impl="flash" if impl == "ulysses_flash" else "full")
    if impl in ("ring", "ring_pallas"):
        from gpumounter_tpu_torch.torchcheck.ring_attention import \
            make_sharded_ring_attention
        return make_sharded_ring_attention(
            mesh, block_impl="pallas" if impl == "ring_pallas" else "einsum")
    raise ValueError(f"attention impl {impl!r} takes no mesh with a seq "
                     "dim above 1")
