"""Ulysses-style sequence parallelism: all-to-all head redistribution.

Counterpart of :mod:`gpumounter_tpu.jaxcheck.ulysses` (DeepSpeed Ulysses).
Instead of rotating K/V round a ring, redistribute once: an all-to-all
turns sequence-sharded [B, T/n, H, D] tensors into head-sharded
[B, T, H/n, D], each rank runs ordinary causal attention over the whole
sequence for its heads, and the inverse all-to-all restores sequence
sharding. Two all-to-alls in all, against the ring's n neighbour hops: it
exercises the all-to-all traffic pattern the ring does not.
"""

from __future__ import annotations

from gpumounter_tpu_torch.torchcheck import dist as dist_lib
from gpumounter_tpu_torch.torchcheck.ring_attention import full_attention


def _ulysses_attention(q, k, v, group, local_attention=None):
    """Per-rank body. q/k/v: [B, T_local, H, D] sequence shards over
    ``group``; H must divide by the group size. ``local_attention`` runs
    over the gathered sequence for this rank's heads (default: full
    attention)."""
    n = dist_lib._size(group)
    heads = q.shape[2]
    if heads % n:
        raise ValueError(f"Ulysses needs heads ({heads}) divisible by the "
                         f"group size ({n})")
    local_attention = local_attention or full_attention

    def seq_to_heads(x):      # [B, T/n, H, D] -> [B, T, H/n, D]
        return dist_lib.all_to_all(x, group, split_dim=2, concat_dim=1)

    def heads_to_seq(x):      # [B, T, H/n, D] -> [B, T/n, H, D]
        return dist_lib.all_to_all(x, group, split_dim=1, concat_dim=2)

    out = local_attention(seq_to_heads(q), seq_to_heads(k), seq_to_heads(v))
    return heads_to_seq(out)


def make_ulysses_attention(mesh, local_impl: str = "full"):
    """Ulysses attention over the mesh's ``seq`` dim, with the call
    signature of :func:`~.ring_attention.make_sharded_ring_attention`:
    each rank passes its [B, T_local, H, D] shards. ``local_impl="flash"``
    runs the gathered-sequence attention through the trainable flash
    attention (all three Hopper kernels on CUDA tensors, the K-blocked
    forward once the gathered T is above 1024); its backward composes with
    the all-to-alls' through autograd."""
    if local_impl == "flash":
        from gpumounter_tpu_torch.torchcheck.flash_attention import \
            make_flash_attention
        local = make_flash_attention()
    elif local_impl == "full":
        local = None
    else:
        raise ValueError(f"unknown local_impl {local_impl!r}")
    group = mesh.get_group("seq")

    def attn(q, k, v):
        return _ulysses_attention(q, k, v, group, local)
    return attn
