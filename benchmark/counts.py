"""The work a training step needs, as each program counts it from its
shapes (``step_counts`` of ``benchmark/programs/<program>.py``), the keys
every count gives, and the published peaks it is held against. The
counts sit under the benchmark's own files, so that a metric reads the
same work whatever implements it.

Operations are 2 per multiply-add. A GEMM's backward is twice its
forward. Attention counts only the causal (query, key) pairs, the
diagonal included: q.k and p.v are 2 * head_dim each per pair and head
forward, and the backward's dv, dp, dq and dk twice that. Recompute,
softmax, norms, GELU, the loss and AdamW are not counted.
"""

from __future__ import annotations

import json
from pathlib import Path

PEAKS = Path(__file__).resolve().parent / "peaks.json"


def causal_pairs(seq: int) -> int:
    return seq * (seq + 1) // 2

# What every program's ``step_counts(dims, batch, seq)`` gives, per
# optimizer step; a program may add keys for metrics of its own.
KEYS = {
    "gemm_flops": "every matmul but attention's, forward and backward",
    "attn_flops": "attention's two products, forward and backward",
    "attn_bytes": "what the attention kernels read and write at least, "
                  "forward and backward",
    "model_flops": "gemm_flops + attn_flops",
    "tokens": "tokens a step trains on",
}


def checked(step_counts: dict[str, float]) -> dict[str, float]:
    """``step_counts`` if it gives every key of :data:`KEYS`."""
    missing = sorted(set(KEYS) - set(step_counts))
    if missing:
        raise ValueError(f"the program's step_counts lacks {missing}")
    return step_counts


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
