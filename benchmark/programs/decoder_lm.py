"""The program of a configuration that names ``"program": "decoder_lm"``:
the port's dense decoder (``torchcheck/model.py``: multi-head attention,
RMSNorm, fixed sinusoidal positions, a tanh-GELU MLP, an untied head)
trained by ``train.make_train_step(cfg, attn_impl="flash")``.

The harness calls only :func:`dims`, :func:`groups`, :func:`build` and
:func:`step_counts` (see :mod:`benchmark.spec`).

Weights are drawn as the model draws them: N(0, 1/fan_in) dense layers,
0.02 embeddings, RMSNorm gains at 1. The leaves fall in one group for the
embedding, head and final norm, then one group a layer.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from benchmark import counts


@dataclasses.dataclass(frozen=True)
class Dims:
    vocab: int
    d_model: int
    n_heads: int
    n_layers: int
    d_ff: int
    dtype: torch.dtype

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def dims(config: dict) -> Dims:
    """The sizes of a configuration file (published ``config.json`` keys)."""
    return Dims(vocab=config["vocab_size"], d_model=config["hidden_size"],
                n_heads=config["num_attention_heads"],
                n_layers=config["num_hidden_layers"],
                d_ff=config["intermediate_size"],
                dtype=DTYPES[config["torch_dtype"]])


def groups(d: Dims) -> list[tuple[str, list[tuple[str, tuple, float | None]]]]:
    """(group tag, [(leaf name, shape, std or None for ones)]) in the order
    the leaves are drawn. Leaf names are the state tree's."""
    dm, h, hd, f = d.d_model, d.n_heads, d.head_dim, d.d_ff
    out = [("top", [("embed", (d.vocab, dm), 0.02),
                    ("lm_head", (dm, d.vocab), 1 / math.sqrt(dm)),
                    ("ln_f.g", (dm,), None)])]
    for i in range(d.n_layers):
        p = f"layers.{i}."
        out.append((f"layer{i}", [
            (p + "ln1.g", (dm,), None),
            (p + "wqkv", (dm, 3, h, hd), 1 / math.sqrt(dm)),
            (p + "wo", (h, hd, dm), 1 / math.sqrt(dm)),
            (p + "ln2.g", (dm,), None),
            (p + "w1", (dm, f), 1 / math.sqrt(dm)),
            (p + "w2", (f, dm), 1 / math.sqrt(f))]))
    return out


def model_config(d: Dims):
    from gpumounter_tpu_torch.torchcheck.model import ModelConfig
    return ModelConfig(vocab=d.vocab, d_model=d.d_model, n_heads=d.n_heads,
                       n_layers=d.n_layers, d_ff=d.d_ff, dtype=d.dtype)


def build(config: dict, d: Dims, params: dict[str, torch.Tensor], device):
    """The port's training state holding ``params`` (zero moments, step 0)
    and its flash-attention step. ``train`` is looked up here, at the
    call, so that a fault patched into it takes hold."""
    from gpumounter_tpu_torch.torchcheck import train
    cfg = model_config(d)
    zeros = {n: torch.zeros((), dtype=p.dtype, device=device).expand(p.shape)
             for n, p in params.items()}
    tree = {"params": params, "step": 0,
            "opt": {n: {"exp_avg": zeros[n], "exp_avg_sq": zeros[n],
                        "step": 0} for n in params}}
    state = train.state_from_tree(cfg, tree, device,
                                  lr=float(config["training"]["lr"]))
    return state, train.make_train_step(cfg, attn_impl="flash")


def step_counts(d: Dims, batch: int, seq: int) -> dict[str, float]:
    """The keys of :data:`benchmark.counts.KEYS` for one optimizer step.
    GEMMs: qkv, o, w1 and w2 a layer and the head. ``attn_bytes``: q, k,
    v, o, do, dq, dk and dv once each in the model's dtype, and the f32
    log-sum-exp, per layer."""
    dm, f, v, n_layers = d.d_model, d.d_ff, d.vocab, d.n_layers
    tokens = batch * seq
    per_layer = dm * 3 * dm + dm * dm + 2 * dm * f       # qkv, o, w1, w2
    gemm_fwd = 2 * tokens * (n_layers * per_layer + dm * v)
    attn_fwd = 4 * dm * counts.causal_pairs(seq) * batch * n_layers
    itemsize = d.dtype.itemsize
    attn_bytes = n_layers * (8 * tokens * dm * itemsize
                             + batch * d.n_heads * seq * 4)
    return {"gemm_flops": 3.0 * gemm_fwd, "attn_flops": 3.0 * attn_fwd,
            "attn_bytes": float(attn_bytes),
            "model_flops": 3.0 * (gemm_fwd + attn_fwd),
            "tokens": float(tokens)}
