"""Plain attention references shared by the port: the unsharded causal
attention and the online-softmax merge of one block's flash statistics.

Counterpart of :mod:`gpumounter_tpu.jaxcheck.ring_attention`. The ring
itself (K/V rotating over ``torch.distributed`` point-to-point) is a later
slice; until then a model without a mesh runs :func:`full_attention`.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30  # large-negative instead of -inf: avoids NaNs in exp


def merge_block(acc, m, l, pv_blk, m_blk, l_blk):
    """Online-softmax merge of one block's flash statistics into the running
    state — the flash-attention recurrence. acc/pv_blk: [B, T, H, D] f32;
    m/l/m_blk/l_blk: [B, H, T] f32. A fully-masked block arrives with
    m_blk == NEG_INF, so its contribution is scaled by exp(NEG_INF - m) = 0
    and annihilates regardless of its (garbage) pv/l values."""
    m_new = torch.maximum(m, m_blk)
    scale_old = torch.exp(m - m_new)
    scale_blk = torch.exp(m_blk - m_new)
    l_new = l * scale_old + l_blk * scale_blk
    acc_new = (acc * scale_old.transpose(1, 2)[..., None]
               + pv_blk * scale_blk.transpose(1, 2)[..., None])
    return acc_new, m_new, l_new


def full_attention(q, k, v):
    """Unsharded causal attention, [B, T, H, D] -> [B, T, H, D]: scores in
    the input dtype, softmax in f32, probabilities cast back to v's dtype
    for the PV product (the reference's rounding points)."""
    d = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / torch.sqrt(
        torch.tensor(d, dtype=q.dtype, device=q.device))
    t = q.shape[1]
    mask = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
    s = torch.where(mask, s.float(), NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)
