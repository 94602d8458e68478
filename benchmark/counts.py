"""The work a training step needs, counted from its shapes, and the
published peaks it is held against. Frozen here so that a metric reads
the same work whatever implements it.

Operations are 2 per multiply-add. A GEMM's backward is twice its
forward. Attention counts only the causal (query, key) pairs, the
diagonal included: q.k and p.v are 2 * head_dim each per pair and head
forward, and the backward's dv, dp, dq and dk twice that. Recompute,
softmax, norms, GELU, the loss and AdamW are not counted.
"""

from __future__ import annotations

import json
from pathlib import Path

from benchmark.inputs import Dims

PEAKS = Path(__file__).resolve().parent / "peaks.json"


def causal_pairs(seq: int) -> int:
    return seq * (seq + 1) // 2


def step_counts(d: Dims, batch: int, seq: int) -> dict[str, float]:
    """Per optimizer step: ``gemm_flops`` (every matmul but attention's,
    forward and backward), ``attn_flops`` (attention's two products,
    forward and backward), ``attn_bytes`` (q, k, v, o, do, dq, dk and dv
    once each in the model's dtype, and the f32 log-sum-exp, per layer),
    ``model_flops`` (their sum of operations) and ``tokens``."""
    dm, f, v, n_layers = d.d_model, d.d_ff, d.vocab, d.n_layers
    tokens = batch * seq
    per_layer = dm * 3 * dm + dm * dm + 2 * dm * f       # qkv, o, w1, w2
    gemm_fwd = 2 * tokens * (n_layers * per_layer + dm * v)
    attn_fwd = 4 * dm * causal_pairs(seq) * batch * n_layers
    itemsize = d.dtype.itemsize
    attn_bytes = n_layers * (8 * tokens * dm * itemsize
                             + batch * d.n_heads * seq * 4)
    return {"gemm_flops": 3.0 * gemm_fwd, "attn_flops": 3.0 * attn_fwd,
            "attn_bytes": float(attn_bytes),
            "model_flops": 3.0 * (gemm_fwd + attn_fwd),
            "tokens": float(tokens)}


def peaks(device_name: str, dtype_name: str) -> dict[str, float] | None:
    """{"flops": FLOP/s, "bytes": bytes/s} of the named card in the dtype,
    or None for a card the table lacks (its shares are then not read)."""
    with open(PEAKS) as f:
        table = json.load(f)["devices"]
    card = table.get(device_name)
    if card is None or dtype_name not in card["tflops"]:
        return None
    return {"flops": card["tflops"][dtype_name] * 1e12,
            "bytes": card["hbm_tb_per_s"] * 1e12}
