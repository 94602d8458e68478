"""Trainable causal flash attention on hand-written Hopper kernels.

Counterpart of the non-kernel half of
:mod:`gpumounter_tpu.jaxcheck.pallas_attention`. The forward is
:func:`flash_block`, whose statistics contract

    pv = exp(s - m) . v    m = rowmax(s)    l = rowsum(exp(s - m))

(f32, unnormalised, causal mask in global coordinates) the ring body and
:func:`make_flash_attention` both consume; the backward is
:func:`flash_backward_fused`, which recomputes the scores from q and k so
no [T, T] tensor reaches device memory in either direction.

On CUDA tensors these run the kernels of :mod:`.kernels` (one CUDA
kernel, ``flash_fwd``, for both forward contracts; ``flash_bwd_dq`` and
``flash_bwd_dkdv`` for the backward) or raise. On CPU tensors they run the
plain PyTorch version of each kernel, kept here: ``_flash_fwd_plain``,
``_flash_dq_plain``, ``_flash_dkdv_plain``. The plain versions repeat the
kernels' arithmetic (f32 scores, p cast to v's dtype before PV, ds cast to
the input dtype before the dq and dk products) on whole tensors.

Public functions keep the JAX package's [B, T, H, D] layout; the kernels
take [B*H, T, D].
"""

from __future__ import annotations

import torch

from gpumounter_tpu_torch.torchcheck import kernels
from gpumounter_tpu_torch.torchcheck.ring_attention import NEG_INF

TILE_Q = 128       # the sequence-length multiple every path takes

# The forward's tiling: the whole-K contract at T <= FWD_K_BLOCK, the
# K-blocked contract (FWD_TILE_Q rows over FWD_K_BLOCK keys, strictly-future
# blocks skipped) beyond it — the rule of pallas_attention.flash_block.
FWD_TILE_Q, FWD_K_BLOCK = 512, 1024


def _fit_tile(preferred: int, total: int, floor: int = TILE_Q) -> int:
    """Largest power-of-two tile <= ``preferred`` that divides ``total``
    (down to ``floor``) — keeps the tuned defaults while preserving the
    multiple-of-TILE_Q sequence contract for in-between lengths."""
    tile = min(preferred, total)
    while tile > floor and total % tile:
        tile //= 2
    return tile


def _masked_scores(q, k, q_start: int, k_start: int, scale: float):
    """Scaled q.kᵀ scores in f32 with the causal mask in GLOBAL
    coordinates. q: [BH, TQ, D]; k: [BH, TK, D] -> [BH, TQ, TK]."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    q_pos = q_start + torch.arange(q.shape[1], device=q.device)
    k_pos = k_start + torch.arange(k.shape[1], device=q.device)
    return torch.where(q_pos[:, None] >= k_pos[None, :], s, NEG_INF)


def _flash_fwd_plain(q, k, v, q_offset: int, k_offset: int, scale: float,
                     skip_tq: int = 0, skip_tk: int = 0):
    """Plain version of ``kernels.flash_fwd``, both contracts: whole-K when
    ``skip_tq == 0``, else K-blocked over (skip_tq rows, skip_tk keys) with
    the online-softmax recurrence and strictly-future blocks skipped.
    Returns (pv [BH,TQ,D], m [BH,1,TQ], l [BH,1,TQ]) in f32."""
    if not skip_tq:
        s = _masked_scores(q, k, q_offset, k_offset, scale)
        m = s.amax(dim=-1)
        p = torch.exp(s - m[..., None])
        pv = torch.matmul(p.to(v.dtype).float(), v.float())
        return pv, m[:, None], p.sum(dim=-1)[:, None]
    bh, tq, d = q.shape
    tk = k.shape[1]
    pv = torch.zeros((bh, tq, d), dtype=torch.float32, device=q.device)
    m = torch.full((bh, tq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((bh, tq), dtype=torch.float32, device=q.device)
    for i in range(tq // skip_tq):
        rows = slice(i * skip_tq, (i + 1) * skip_tq)
        q_max = q_offset + (i + 1) * skip_tq - 1
        for j in range(tk // skip_tk):
            if q_max < k_offset + j * skip_tk:
                break            # this and every later block is future
            cols = slice(j * skip_tk, (j + 1) * skip_tk)
            s = _masked_scores(q[:, rows], k[:, cols], q_offset + i * skip_tq,
                               k_offset + j * skip_tk, scale)
            m_new = torch.maximum(m[:, rows], s.amax(dim=-1))
            corr = torch.exp(m[:, rows] - m_new)
            p = torch.exp(s - m_new[..., None])
            l[:, rows] = l[:, rows] * corr + p.sum(dim=-1)
            pv[:, rows] = pv[:, rows] * corr[..., None] + torch.matmul(
                p.to(v.dtype).float(), v[:, cols].float())
            m[:, rows] = m_new
    return pv, m[:, None], l[:, None]


def _on_cpu(x: torch.Tensor) -> bool:
    """True for CPU tensors (plain version), False for CUDA tensors
    (kernel); raises for any other device."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    return x.device.type == "cpu"


def flash_block(q, k, v, q_offset: int, k_offset: int,
                tile_q: int | None = None, k_block: int | None = None):
    """Flash statistics of q against one K/V block, causally masked in
    global coordinates.

    q: [BH, TQ, D]; k, v: [BH, TK, D]; integer offsets. Returns
    (pv [BH, TQ, D], m [BH, 1, TQ], l [BH, 1, TQ]) in f32. The softmax
    temperature is 1/sqrt(D). With ``k_block`` given and
    TK > k_block the K-blocked contract runs (tiles fitted to the lengths,
    strictly-future blocks skipped); otherwise the whole-K contract."""
    bh, tq, d = q.shape
    tk = k.shape[1]
    tile = _fit_tile(tile_q or TILE_Q, tq)
    if tq % tile:
        raise ValueError(f"TQ={tq} not a multiple of {TILE_Q}")
    scale = 1.0 / (d ** 0.5)
    skip_tq = skip_tk = 0
    if k_block is not None and tk > k_block:
        skip_tq, skip_tk = tile, _fit_tile(k_block, tk)
    q_offset, k_offset = int(q_offset), int(k_offset)
    if _on_cpu(q):
        return _flash_fwd_plain(q, k, v, q_offset, k_offset, scale,
                                skip_tq, skip_tk)
    return kernels.flash_fwd(q, k, v, q_offset, k_offset, scale,
                             skip_tq, skip_tk)


def _to_bhd(x):
    b, t, h, d = x.shape
    return x.transpose(1, 2).reshape(b * h, t, d).contiguous()


def _from_bhd(x, b: int, h: int):
    _, t, d = x.shape
    return x.reshape(b, h, t, d).transpose(1, 2)


def flash_block_bthd(q, k, v, q_offset: int, k_offset: int,
                     tile_q: int | None = None, k_block: int | None = None):
    """[B, T, H, D]-layout wrapper matching the ring body's tensors.
    Returns (pv [B, TQ, H, D], m [B, H, TQ], l [B, H, TQ]) in f32."""
    b, tq, h, _ = q.shape
    pv, m, l = flash_block(_to_bhd(q), _to_bhd(k), _to_bhd(v), q_offset,
                           k_offset, tile_q=tile_q, k_block=k_block)
    return _from_bhd(pv, b, h), m.reshape(b, h, tq), l.reshape(b, h, tq)


def normalize_flash_stats(pv, l):
    """Final softmax normalization of the block statistics:
    pv [B,TQ,H,D] / l [B,H,TQ] -> attention output [B,TQ,H,D]."""
    return pv / l.transpose(1, 2)[..., None]


def flash_attention(q, k, v):
    """Complete causal flash attention through :func:`flash_block`
    (forward only; the trainable path is :func:`make_flash_attention`)."""
    pv, _, l = flash_block_bthd(q, k, v, 0, 0, tile_q=FWD_TILE_Q,
                                k_block=FWD_K_BLOCK)
    return normalize_flash_stats(pv, l)


# -- backward -----------------------------------------------------------------

def flash_bwd_block(q, k_blk, v_blk, do, drow, lse, q_offset: int,
                    k_offset: int):
    """One key block of the flash-attention backward, in GLOBAL
    coordinates. q/do: [B, Tq, H, D] (model dtype); k_blk/v_blk:
    [B, Tk, H, D]; drow and lse: [B, H, Tq] f32. Returns
    (dq_partial, dk_blk, dv_blk) f32.

    Math (s in global coordinates, scale = 1/sqrt(D)):
        p  = exp(s - lse)            dv_j = pᵀ·do
        dp = do·v_jᵀ                 ds   = p ⊙ (dp - drow)
        dq += ds·k_j·scale           dk_j = dsᵀ·q·scale
    """
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k_blk.float()) * scale
    q_pos = q_offset + torch.arange(q.shape[1], device=q.device)
    k_pos = k_offset + torch.arange(k_blk.shape[1], device=q.device)
    s = torch.where(q_pos[:, None] >= k_pos[None, :], s, NEG_INF)
    p = torch.exp(s - lse[..., None])                       # [B,H,Tq,Tk]
    dv_blk = torch.einsum("bhqk,bqhd->bkhd", p.to(v_blk.dtype).float(),
                          do.float())
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v_blk.float())
    ds = (p * (dp - drow[..., None])).to(q.dtype).float()
    dq_p = torch.einsum("bhqk,bkhd->bqhd", ds, k_blk.float()) * scale
    dk_blk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale
    return dq_p, dk_blk, dv_blk


def softmax_jacobian_diag(do, out):
    """rowsum(do * out) in f32, [B, T, H, D] -> [B, H, T] — the ``drow``
    term of the backward."""
    return (do.float() * out.float()).sum(dim=-1).transpose(1, 2)


def _flash_backward(q, k, v, out, lse, do, block: int):
    """Blockwise flash-attention backward (causal, offsets 0) as a loop of
    :func:`flash_bwd_block` over key blocks — the independent oracle of the
    kernels. q/k/v/out/do: [B, T, H, D]; lse: [B, H, T] f32. Returns
    (dq, dk, dv) in the input dtype. ``block`` must divide T."""
    t = q.shape[1]
    if t % block:
        raise ValueError(f"T={t} not a multiple of bwd block {block}")
    drow = softmax_jacobian_diag(do, out)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dks, dvs = [], []
    for j in range(0, t, block):
        dq_p, dk_blk, dv_blk = flash_bwd_block(
            q, k[:, j:j + block], v[:, j:j + block], do, drow, lse, 0, j)
        dq += dq_p
        dks.append(dk_blk)
        dvs.append(dv_blk)
    return (dq.to(q.dtype), torch.cat(dks, dim=1).to(k.dtype),
            torch.cat(dvs, dim=1).to(v.dtype))


def _recompute_p(q, k, lse, scale: float):
    """p = exp(s - lse) [BH, T, T] f32, the probabilities both backward
    kernels recompute from q and k."""
    return torch.exp(_masked_scores(q, k, 0, 0, scale)
                     - lse.transpose(1, 2))


def _flash_dq_plain(q, k, v, do, lse, drow, scale: float):
    """Plain version of ``kernels.flash_bwd_dq``: dq [BH,T,D] f32."""
    p = _recompute_p(q, k, lse, scale)
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    ds = (p * (dp - drow.transpose(1, 2))).to(q.dtype).float()
    return torch.matmul(ds, k.float()) * scale


def _flash_dkdv_plain(q, k, v, do, lse, drow, scale: float):
    """Plain version of ``kernels.flash_bwd_dkdv``: (dk, dv) [BH,T,D]
    f32."""
    p = _recompute_p(q, k, lse, scale)
    dv = torch.matmul(p.to(v.dtype).float().transpose(-1, -2), do.float())
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    ds = (p * (dp - drow.transpose(1, 2))).to(q.dtype).float()
    dk = torch.matmul(ds.transpose(-1, -2), q.float()) * scale
    return dk, dv


def flash_backward_fused(q, k, v, lse, drow, do):
    """Fused flash backward on [BH, T, D] tensors (causal, offsets 0).
    lse/drow: [BH, 1, T] f32. Returns (dq, dk, dv) f32. The temperature is
    1/sqrt(D), as in the reference's backward: D is never padded."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    if _on_cpu(q):
        return (_flash_dq_plain(q, k, v, do, lse, drow, scale),
                *_flash_dkdv_plain(q, k, v, do, lse, drow, scale))
    return (kernels.flash_bwd_dq(q, k, v, do, lse, drow, scale),
            *kernels.flash_bwd_dkdv(q, k, v, do, lse, drow, scale))


class _FlashAttention(torch.autograd.Function):
    """Causal attention [B, T, H, D] -> [B, T, H, D] whose forward is
    :func:`flash_block` and whose backward is :func:`flash_backward_fused`."""

    @staticmethod
    def forward(ctx, q, k, v):
        b, t, h, _ = q.shape
        qh, kh, vh = _to_bhd(q), _to_bhd(k), _to_bhd(v)
        pv, m, l = flash_block(qh, kh, vh, 0, 0, tile_q=FWD_TILE_Q,
                               k_block=FWD_K_BLOCK)
        out = _from_bhd(pv / l.transpose(1, 2), b, h).to(q.dtype)
        lse = (m + torch.log(l)).reshape(b, h, t)
        # the [BH, T, D] copies are what the backward kernels read; the
        # [B, T, H, D] views die with the projection output
        ctx.save_for_backward(qh, kh, vh, out, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        qh, kh, vh, out, lse = ctx.saved_tensors
        b, t, h, _ = out.shape
        drow = softmax_jacobian_diag(do, out)               # [B, H, T]
        dq, dk, dv = flash_backward_fused(
            qh, kh, vh, lse.reshape(b * h, 1, t),
            drow.reshape(b * h, 1, t).contiguous(), _to_bhd(do))
        return (_from_bhd(dq, b, h).to(out.dtype),
                _from_bhd(dk, b, h).to(out.dtype),
                _from_bhd(dv, b, h).to(out.dtype))


def make_flash_attention():
    """Trainable causal flash attention, a drop-in for
    :func:`~.ring_attention.full_attention` ([B, T, H, D] -> [B, T, H, D]);
    T must be a multiple of TILE_Q. The backward is the fused dq and dk/dv
    kernels, whose score temps never leave shared memory."""
    return _FlashAttention.apply
