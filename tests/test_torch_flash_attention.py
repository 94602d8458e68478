"""The port's flash attention against the JAX package's Pallas kernels.

On the CPU the port runs each kernel's plain PyTorch version and JAX runs
its Pallas kernels in interpret mode; the same numpy inputs go through both
(f32, tolerance 3e-5 as in tests/test_jaxcheck.py). The Hopper kernels
themselves are held against these plain versions on a card by
tests/test_torch_kernels.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpumounter_tpu.jaxcheck import pallas_attention as jpa
from gpumounter_tpu.jaxcheck import ring_attention as jra
from gpumounter_tpu_torch.torchcheck import flash_attention as tfa
from gpumounter_tpu_torch.torchcheck import kernels
from gpumounter_tpu_torch.torchcheck import ring_attention as tra

TOL = 3e-5


def _qkv(seed, b=1, t=256, h=2, d=64, n=3):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, t, h, d), dtype=np.float32)
                 for _ in range(n))


def _torch(*xs):
    return tuple(torch.from_numpy(np.asarray(x)) for x in xs)


def _jax(*xs):
    return tuple(jnp.asarray(x) for x in xs)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("offsets", [(0, 0), (1024, 1024), (0, 4096)])
@pytest.mark.parametrize("contract", ["whole_k", "k_blocked"])
def test_flash_block_matches_pallas(contract, offsets):
    """Both forward contracts, at ring offsets and for a block wholly in
    the future: (pv, m, l) agree with the Pallas kernels."""
    q, k, v = _qkv(0, t=512)
    kw = {"tile_q": 128, "k_block": 128} if contract == "k_blocked" else {}
    want = jpa.flash_block_bthd(*_jax(q, k, v), *offsets, interpret=True,
                                **kw)
    got = tfa.flash_block_bthd(*_torch(q, k, v), *offsets, **kw)
    for g, w in zip(got, want):
        _close(g, w)


def test_fully_masked_block_is_annihilated():
    q, k, v = _torch(*_qkv(4, t=128))
    pv0, m0, l0 = tfa.flash_block_bthd(q, k, v, 0, 0)
    pv1, m1, l1 = tfa.flash_block_bthd(q, k, v, 0, 4096)
    assert float(m1.max()) <= -1e29
    assert torch.all(l1 == 128)       # whole-K: p = exp(0) on every key
    acc, m, l = tra.merge_block(pv0, m0, l0, pv1, m1, l1)
    _close(acc, pv0, 1e-6)
    _close(l, l0, 1e-6)


def test_kblocked_skips_future_blocks():
    """K-blocked contract: blocks wholly in the future are skipped, so a
    block at offset 4096 leaves m = NEG_INF, l = 0, pv = 0."""
    q, k, v = _torch(*_qkv(5, t=256))
    pv, m, l = tfa.flash_block_bthd(q, k, v, 0, 4096, tile_q=128,
                                    k_block=128)
    assert torch.all(m == tra.NEG_INF)
    assert torch.all(l == 0) and torch.all(pv == 0)


def test_merge_block_matches_jax():
    acc, pv = _qkv(6, t=128, n=2)
    rng = np.random.default_rng(7)
    m, l, mb, lb = (rng.standard_normal((1, 2, 128), dtype=np.float32)
                    for _ in range(4))
    l, lb = np.abs(l) + 1, np.abs(lb) + 1
    want = jra.merge_block(*_jax(acc, m, l, pv, mb, lb))
    got = tra.merge_block(*_torch(acc, m, l, pv, mb, lb))
    for g, w in zip(got, want):
        _close(g, w)


def test_full_attention_matches_jax():
    q, k, v = _qkv(8, t=64, h=4, d=16)
    _close(tra.full_attention(*_torch(q, k, v)),
           jra.full_attention(*_jax(q, k, v)))


@pytest.mark.parametrize("t", [256, 768])
def test_flash_attention_forward_matches_jax(t):
    q, k, v = _qkv(9, t=t)
    _close(tfa.flash_attention(*_torch(q, k, v)),
           jpa.flash_attention(*_jax(q, k, v), interpret=True))


@pytest.mark.parametrize("preferred,total", [(512, 1024), (512, 768),
                                             (1024, 1536), (1024, 128),
                                             (128, 384)])
def test_fit_tile_matches_jax(preferred, total):
    assert tfa._fit_tile(preferred, total) == jpa._fit_tile(preferred, total)


# flash_fwd's tiling (csrc/flash_fwd.cu, flash_fwd_wgmma_kernel): one block
# per 128 q rows, K tiles of 128 keys.
KERNEL_BQ = KERNEL_BK = 128


def _kernel_loop_end(tk, q0, q_offset, k_offset, skip_tq, skip_tk,
                     exact=True):
    """Keys [0, end) that flash_fwd's block at row ``q0`` visits: the
    Pallas skip of the K-blocked contract, then (``exact``) the causal stop
    when every row of the block sees key ``k_offset``."""
    end = tk
    if skip_tq:
        q_tile_last = q_offset + (q0 // skip_tq + 1) * skip_tq - 1
        blocks = (0 if q_tile_last < k_offset
                  else (q_tile_last - k_offset) // skip_tk + 1)
        end = min(end, blocks * skip_tk)
    if exact and q_offset + q0 >= k_offset:
        seen = q_offset + q0 + KERNEL_BQ - k_offset
        end = min(end, -(-seen // KERNEL_BK) * KERNEL_BK)
    return end


def _kernel_recurrence(q, k, v, q_offset, k_offset, scale, skip_tq, skip_tk,
                       exact=True):
    """flash_fwd's online softmax in plain torch at the kernel's tiling and
    loop bounds, with the arithmetic of _flash_fwd_plain's K-blocked loop.
    Returns (pv, m, l, K tiles visited)."""
    bh, tq, d = q.shape
    pv = torch.zeros((bh, tq, d))
    m = torch.full((bh, tq), tra.NEG_INF)
    l = torch.zeros((bh, tq))
    tiles = 0
    for q0 in range(0, tq, KERNEL_BQ):
        rows = slice(q0, q0 + KERNEL_BQ)
        end = _kernel_loop_end(k.shape[1], q0, q_offset, k_offset, skip_tq,
                               skip_tk, exact)
        for k0 in range(0, end, KERNEL_BK):
            cols = slice(k0, k0 + KERNEL_BK)
            s = tfa._masked_scores(q[:, rows], k[:, cols], q_offset + q0,
                                   k_offset + k0, scale)
            m_new = torch.maximum(m[:, rows], s.amax(dim=-1))
            corr = torch.exp(m[:, rows] - m_new)
            p = torch.exp(s - m_new[..., None])
            l[:, rows] = l[:, rows] * corr + p.sum(dim=-1)
            pv[:, rows] = pv[:, rows] * corr[..., None] + torch.matmul(
                p.to(v.dtype).float(), v[:, cols].float())
            m[:, rows] = m_new
            tiles += 1
    return pv, m[:, None], l[:, None], tiles


@pytest.mark.parametrize("offsets", [(0, 0), (1024, 1024), (0, 4096)])
@pytest.mark.parametrize("skip", [(0, 0), (128, 128), (256, 512)])
def test_fwd_kernel_loop_bound_is_exact(skip, offsets):
    """The forward kernel's loop bound, both contracts (whole-K, K-blocked
    at the kernel's tiles and at coarser Pallas tiles): stopping at the
    causal edge changes no bit, runs exactly the causal tiles at offsets
    where every row sees the first key, and does not fire at (0, 4096)."""
    t = 512
    q, k, v = _torch(*(x.transpose(0, 2, 1, 3).reshape(2, t, 64)
                       for x in _qkv(16, t=t)))
    scale = 64 ** -0.5
    got = _kernel_recurrence(q, k, v, *offsets, scale, *skip)
    every = _kernel_recurrence(q, k, v, *offsets, scale, *skip, exact=False)
    for g, w in zip(got[:3], every[:3]):
        assert torch.equal(g, w)        # a skipped tile adds exactly 0
    plain = tfa._flash_fwd_plain(q, k, v, *offsets, scale, *skip)
    for g, w in zip(got[:3], plain):
        if skip == (KERNEL_BQ, KERNEL_BK):   # the same tiles, the same ops
            assert torch.equal(g, w)
        else:
            _close(g, w, 1e-5)
    n = t // KERNEL_BK
    if offsets == (0, 4096):
        assert got[3] == every[3]       # the causal stop does not fire
        if skip == (0, 0):
            assert torch.all(got[2] == t)
    else:
        assert got[3] == n * (n + 1) // 2   # exactly the causal tiles
        assert every[3] > got[3] or skip == (KERNEL_BQ, KERNEL_BK)


def _bwd_inputs(seed, t):
    """[BH, T, D] q, k, v, do and the lse, drow the forward gives."""
    q, k, v, do = (x.transpose(0, 2, 1, 3).reshape(2, t, 64)
                   for x in _qkv(seed, t=t, n=4))
    pv, m, l = (np.asarray(x) for x in jpa.flash_block(
        *_jax(q, k, v), 0, 0, interpret=True))
    lse = m + np.log(l)
    out = pv / l.transpose(0, 2, 1)
    drow = (do * out).sum(-1)[:, None, :]
    return q, k, v, do, lse, drow


@pytest.mark.parametrize("t", [256, 512])
def test_plain_backward_matches_pallas_fused(t):
    """_flash_dq_plain / _flash_dkdv_plain (the CPU path of
    flash_backward_fused) against the fused Pallas dq and dk/dv kernels."""
    q, k, v, do, lse, drow = _bwd_inputs(10, t)
    want = jpa.flash_backward_fused(*_jax(q, k, v, lse, drow, do),
                                    interpret=True, tile_acc=128,
                                    tile_red=128)
    got = tfa.flash_backward_fused(*_torch(q, k, v, lse, drow, do))
    for g, w in zip(got, want):
        _close(g, w)


# flash_bwd_dq's tiling (csrc/flash_bwd.cu, flash_bwd_dq_wgmma_kernel): one
# block per 128 queries, a warpgroup per 64 of them, K/V tiles of 128 keys.
DQ_BQ, DQ_WG, DQ_BK = 128, 64, 128


def _dq_kernel_recurrence(q, k, v, do, lse, drow, scale, stop=True):
    """flash_bwd_dq in plain torch at the kernel's tiling: each warpgroup's
    64 rows accumulate dS.K tile by tile over the block's loop, key 0 to the
    block's causal edge (to the end of the sequence when not ``stop``), with
    ds rounded to the input dtype per tile. Returns (dq, the (first row,
    first key) tiles visited)."""
    bh, t, d = q.shape
    dq = torch.zeros((bh, t, d))
    visited = []
    for q0 in range(0, t, DQ_BQ):
        for qw in range(q0, q0 + DQ_BQ, DQ_WG):
            rows = slice(qw, qw + DQ_WG)
            for k0 in range(0, q0 + DQ_BQ if stop else t, DQ_BK):
                cols = slice(k0, k0 + DQ_BK)
                s = tfa._masked_scores(q[:, rows], k[:, cols], qw, k0, scale)
                p = torch.exp(s - lse[:, 0, rows, None])
                dp = torch.matmul(do[:, rows].float(),
                                  v[:, cols].float().transpose(-1, -2))
                ds = (p * (dp - drow[:, 0, rows, None])).to(q.dtype).float()
                dq[:, rows] += torch.matmul(ds, k[:, cols].float())
                visited.append((qw, k0))
    return dq * scale, visited


@pytest.mark.parametrize("t", [128, 256, 384, 512, 640, 768, 896])
def test_dq_kernel_tiling_is_exact(t):
    """The dq kernel's loop: stopping at each block's causal edge changes
    no bit against visiting every key tile, each warpgroup visits exactly
    the tiles holding a key it sees, and the result matches the plain
    version and the Pallas fused backward."""
    q, k, v, do, lse, drow = _torch(*_bwd_inputs(17, t))
    scale = 64 ** -0.5
    got, visited = _dq_kernel_recurrence(q, k, v, do, lse, drow, scale)
    every, visited_all = _dq_kernel_recurrence(q, k, v, do, lse, drow, scale,
                                               stop=False)
    assert torch.equal(got, every)      # a tile past the edge adds exactly 0
    causal = [(qw, k0) for qw in range(0, t, DQ_WG)
              for k0 in range(0, qw + DQ_WG, DQ_BK)]
    assert sorted(visited) == sorted(causal)
    past_edge = sum(2 * (t - q0 - DQ_BQ) // DQ_BK
                    for q0 in range(0, t, DQ_BQ))   # 2 warpgroups per block
    assert len(visited_all) - len(visited) == past_edge
    _close(got, tfa._flash_dq_plain(q, k, v, do, lse, drow, scale), 1e-5)
    want = jpa.flash_backward_fused(*_jax(*(x.numpy() for x in (
        q, k, v, lse, drow, do))), interpret=True, tile_acc=128,
        tile_red=128)[0]
    _close(got, want)


def _grads(attn, q, k, v, w):
    q, k, v = (x.clone().requires_grad_(True) for x in (q, k, v))
    (attn(q, k, v) * w).sum().backward()
    return q.grad, k.grad, v.grad


def _jax_grads(attn, q, k, v, w):
    def loss(q, k, v):
        return jnp.sum(attn(q, k, v) * w)
    return jax.grad(loss, argnums=(0, 1, 2))(q, k, v)


@pytest.mark.parametrize("t", [256, 768])
@pytest.mark.parametrize("jax_impl", ["pallas", "xla"])
def test_flash_attention_grads_match_jax(jax_impl, t):
    """The autograd Function (plain kernels on the CPU) against the JAX
    custom VJP, with its fused Pallas backward and its XLA oracle; T=768 is
    a multiple of 128 that the 512/1024 tile defaults do not divide."""
    q, k, v, w = _qkv(11 + t, t=t, n=4)
    want = _jax_grads(jpa.make_flash_attention(
        interpret=True, bwd_block=128, bwd_impl=jax_impl), *_jax(q, k, v, w))
    got = _grads(tfa.make_flash_attention(), *_torch(q, k, v, w))
    for g, r in zip(got, want):
        _close(g, r, 5e-5)


@pytest.mark.parametrize("t", [256, 768])
def test_flash_grads_match_blockwise_oracle(t):
    """The autograd Function against the port's own blockwise backward
    (_flash_backward, the einsum loop over key blocks), fed the same
    forward statistics."""
    q, k, v, w = _torch(*_qkv(14 + t, t=t, n=4))
    got = _grads(tfa.make_flash_attention(), q, k, v, w)
    pv, m, l = tfa.flash_block_bthd(q, k, v, 0, 0)
    out = tfa.normalize_flash_stats(pv, l)
    want = tfa._flash_backward(q, k, v, out, m + torch.log(l), w, 128)
    for g, r in zip(got, want):
        _close(g, r, 5e-5)


def test_flash_grads_match_full_attention_autograd():
    """The kernel backward against autograd through plain full attention
    (no JAX involved): the two are independent derivations."""
    q, k, v, w = _torch(*_qkv(12, t=256, n=4))
    got = _grads(tfa.make_flash_attention(), q, k, v, w)
    want = _grads(tra.full_attention, q, k, v, w)
    for g, r in zip(got, want):
        _close(g, r, 5e-5)


def test_flash_attention_is_causal():
    q, k, v = _torch(*_qkv(13, t=256))
    out1 = tfa.flash_attention(q, k, v)
    k2, v2 = k.clone(), v.clone()
    k2[:, -1] = 99.0
    v2[:, -1] = 99.0
    out2 = tfa.flash_attention(q, k2, v2)
    _close(out1[:, :-1], out2[:, :-1], 1e-6)
    assert not torch.allclose(out1[:, -1], out2[:, -1])


def test_kernel_wrappers_take_cuda_tensors_only():
    """The CPU path is chosen by flash_block from the tensor's device; the
    kernel wrappers themselves refuse CPU tensors rather than fall back."""
    q, k, v = (torch.zeros(2, 128, 64) for _ in range(3))
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.flash_fwd(q, k, v, 0, 0, 0.125)
    lse = torch.zeros(2, 1, 128)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.flash_bwd_dq(q, k, v, q, lse, lse, 0.125)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.flash_bwd_dkdv(q, k, v, q, lse, lse, 0.125)


def test_flash_block_rejects_other_devices():
    q = torch.zeros(2, 128, 64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tfa.flash_block(q, q, q, 0, 0)


def test_kernel_library_is_keyed_on_source_hash():
    """The build cache key changes with the sources and names one library
    per source under build/torch_kernels/."""
    paths = {src: kernels._library_path(src) for src in kernels.SOURCES}
    assert len(set(paths.values())) == len(kernels.SOURCES)
    for src, path in paths.items():
        assert path.parent == kernels.BUILD_DIR
        assert path.name.startswith(f"lib{src.split('.')[0]}-")
