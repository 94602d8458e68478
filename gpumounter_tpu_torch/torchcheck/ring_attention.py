"""Ring attention: causal attention with the sequence sharded over a
process group, K/V blocks rotating round the ring by point-to-point sends.

Counterpart of :mod:`gpumounter_tpu.jaxcheck.ring_attention`. Each rank
holds [B, T_local, H, D] shards of q, k and v for global positions
``rank * T_local ...``. After i rotations a rank holds the K/V block of
rank ``(my - i) mod n`` (blocks move to the next-higher rank each step);
one *ring step* is that block's flash statistics at the global offsets
``(q_offset, k_offset)`` merged into the running online-softmax state
(:func:`ring_step`). The backward (:func:`make_ring_attention`) is a second
ring pass: dk and dv travel with their K/V block and dq accumulates at
home (:func:`ring_bwd_step`). Both steps are functions of their own so a
single card can replay the ring's schedule, block by block.

Also here: the unsharded causal attention (:func:`full_attention`) and the
online-softmax merge (:func:`merge_block`) every blockwise path shares.
"""

from __future__ import annotations

import torch

from gpumounter_tpu_torch.torchcheck import dist as dist_lib

NEG_INF = -1e30  # large-negative instead of -inf: avoids NaNs in exp


def _block_attend(q, k, q_offset: int, k_offset: int):
    """Scores of one block pair in q's dtype with the causal mask in
    *global* coordinates. q: [B, Tq, H, D]; k: [B, Tk, H, D] -> [B, H, Tq,
    Tk]."""
    d = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / torch.sqrt(
        torch.tensor(d, dtype=q.dtype, device=q.device))
    q_pos = q_offset + torch.arange(q.shape[1], device=q.device)
    k_pos = k_offset + torch.arange(k.shape[1], device=q.device)
    return torch.where(q_pos[:, None] >= k_pos[None, :], s,
                       torch.tensor(NEG_INF, dtype=s.dtype, device=s.device))


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


def _einsum_block(q, k_blk, v_blk, q_offset: int, k_offset: int):
    """Block statistics (pv [B,Tq,H,D], m [B,H,Tq], l [B,H,Tq], f32) from
    PyTorch einsums — the plain path; the ``"pallas"`` path computes the
    same with the whole-K ``flash_fwd`` kernel."""
    s = _block_attend(q, k_blk, q_offset, k_offset).float()
    m_blk = s.amax(dim=-1)
    p = torch.exp(s - m_blk[..., None])
    l_blk = p.sum(dim=-1)
    pv = torch.einsum("bhqk,bkhd->bqhd", p.to(v_blk.dtype), v_blk).float()
    return pv, m_blk, l_blk


def _block_stats(block_impl: str):
    if block_impl == "einsum":
        return _einsum_block
    if block_impl == "pallas":
        # the name the JAX package gives its kernel path: on CUDA tensors
        # this is the whole-K flash_fwd kernel at ring offsets
        from gpumounter_tpu_torch.torchcheck.flash_attention import \
            flash_block_bthd
        return flash_block_bthd
    raise ValueError(f"unknown block_impl {block_impl!r}")


def ring_state(q):
    """The online-softmax state before any block: (acc, m, l) f32."""
    b, t, h, d = q.shape
    return (torch.zeros((b, t, h, d), dtype=torch.float32, device=q.device),
            torch.full((b, h, t), NEG_INF, dtype=torch.float32,
                       device=q.device),
            torch.zeros((b, h, t), dtype=torch.float32, device=q.device))


def ring_step(state, q, k_blk, v_blk, q_offset: int, k_offset: int,
              block_impl: str = "einsum"):
    """One step of the ring forward: the statistics of q against the K/V
    block at global ``(q_offset, k_offset)``, merged into ``state``."""
    stats = _block_stats(block_impl)(q, k_blk, v_blk, q_offset, k_offset)
    return merge_block(*state, *stats)


def ring_output(state, dtype):
    """(out [B,T,H,D] in ``dtype``, lse [B,H,T] f32) of a finished state;
    lse = m + log(l) is the row statistic the backward needs."""
    acc, m, l = state
    return (acc / l.transpose(1, 2)[..., None]).to(dtype), m + torch.log(l)


def _ring_forward(q, k, v, group, block_impl: str):
    n = dist_lib._size(group)
    me = torch.distributed.get_rank(group) if n > 1 else 0
    t_local = q.shape[1]
    state = ring_state(q)
    k_blk, v_blk = k, v
    for i in range(n):
        src = (me - i) % n
        state = ring_step(state, q, k_blk, v_blk, me * t_local,
                          src * t_local, block_impl)
        if i < n - 1:          # the last rotation would only bring k, v home
            k_blk, v_blk = dist_lib.permute([k_blk, v_blk], group)
    return ring_output(state, q.dtype)


def ring_attention(q, k, v, group, block_impl: str = "einsum"):
    """Causal multi-head attention of sequence shards over ``group``:
    [B, T_local, H, D] -> [B, T_local, H, D] on every rank. ``block_impl``:
    ``"einsum"`` or ``"pallas"`` (the whole-K flash kernel on CUDA tensors;
    T_local must be a multiple of 128). Not differentiable; see
    :func:`make_ring_attention`."""
    return _ring_forward(q, k, v, group, block_impl)[0]


def ring_bwd_step(grads, q, k_blk, v_blk, do, drow, lse, q_offset: int,
                  k_offset: int):
    """One step of the ring backward: adds this block pair's (dq, dk_blk,
    dv_blk) to ``grads`` (f32, the dk/dv of the block held now)."""
    from gpumounter_tpu_torch.torchcheck.flash_attention import \
        flash_bwd_block
    dq, dk, dv = grads
    dq_p, dk_p, dv_p = flash_bwd_block(q, k_blk, v_blk, do, drow, lse,
                                       q_offset, k_offset)
    return dq + dq_p, dk + dk_p, dv + dv_p


class _RingAttention(torch.autograd.Function):
    """Ring attention whose backward is a second ring pass: (k, v, dk, dv)
    rotate together while each rank computes per-block gradients against
    the lse rows it saved in the forward — memory O(shard) both ways, and
    the kernel forward (no autograd rule of its own) becomes trainable."""

    @staticmethod
    def forward(ctx, q, k, v, group, block_impl):
        out, lse = _ring_forward(q, k, v, group, block_impl)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.group = group
        return out

    @staticmethod
    def backward(ctx, do):
        from gpumounter_tpu_torch.torchcheck.flash_attention import \
            softmax_jacobian_diag
        q, k, v, out, lse = ctx.saved_tensors
        group = ctx.group
        n = dist_lib._size(group)
        me = torch.distributed.get_rank(group) if n > 1 else 0
        t_local = q.shape[1]
        drow = softmax_jacobian_diag(do, out)
        grads = tuple(torch.zeros(x.shape, dtype=torch.float32,
                                  device=x.device) for x in (q, k, v))
        k_blk, v_blk = k, v
        for i in range(n):
            src = (me - i) % n
            dq, dk, dv = ring_bwd_step(grads, q, k_blk, v_blk, do, drow, lse,
                                       me * t_local, src * t_local)
            # dk/dv travel WITH their block: after n hops each rank holds
            # its own block's finished gradient
            if i < n - 1:
                k_blk, v_blk, dk, dv = dist_lib.permute(
                    [k_blk, v_blk, dk, dv], group)
            else:
                dk, dv = dist_lib.permute([dk, dv], group)
            grads = dq, dk, dv
        dq, dk, dv = grads
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None


def make_ring_attention(group, block_impl: str = "einsum"):
    """Trainable ring attention over ``group`` (see :class:`_RingAttention`),
    [B, T_local, H, D] shards -> [B, T_local, H, D]."""
    _block_stats(block_impl)           # reject an unknown impl now

    def attn(q, k, v):
        return _RingAttention.apply(q, k, v, group, block_impl)
    return attn


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


def make_sharded_ring_attention(mesh, block_impl: str = "einsum"):
    """Trainable ring attention over the mesh's ``seq`` dim. Each rank
    passes its own [B, T_local, H, D] shards (split over ``seq`` as
    :func:`sequence_sharding` says, and over any other mesh dims on batch
    or heads: those are independent inside the ring)."""
    return make_ring_attention(mesh.get_group("seq"), block_impl)


def sequence_sharding() -> tuple:
    """The spec of [B, T, H, D] tensors sequence-sharded over the mesh's
    ``seq`` dim (``P(None, "seq", None, None)``)."""
    return (None, "seq", None, None)
