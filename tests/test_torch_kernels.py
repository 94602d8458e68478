"""The Hopper kernels against their plain PyTorch versions, on a card.

Every test here is marked ``gpu`` and skips without a CUDA device; this
file imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest tests/test_torch_kernels.py -m gpu -q

Tolerances: f32 1e-4 (the f32 kernels use CUDA-core FMAs in full f32, TF32
off on the plain side); bf16 1e-2 on normalised outputs and on the relative
Frobenius error of gradients, 1e-3 on m (p is rounded to bf16 at other
points of the online recurrence than in the whole-K plain version)."""

import pytest
import torch

from gpumounter_tpu_torch.torchcheck import flash_attention as tfa
from gpumounter_tpu_torch.torchcheck import kernels
from gpumounter_tpu_torch.torchcheck.ring_attention import NEG_INF


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel_fro(got, want):
    return float((got - want).norm() / want.norm())


def _bwd_args(device, dtype, bh, t, d, seed):
    """(q, k, v, do, lse, drow, scale) with lse and drow from the plain
    forward, as the trainable attention forms them."""
    g = torch.Generator(device).manual_seed(seed)
    q, k, v, do = (torch.randn(bh, t, d, generator=g, device=device)
                   .to(dtype) for _ in range(4))
    scale = d ** -0.5
    pv, m, l = tfa._flash_fwd_plain(q, k, v, 0, 0, scale)
    lse = m + torch.log(l)
    drow = (do.float() * (pv / l.transpose(1, 2))).sum(-1)[:, None]
    return q, k, v, do, lse, drow, scale


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,d", [(torch.float32, 64),
                                     (torch.bfloat16, 64),
                                     (torch.bfloat16, 128)])
@pytest.mark.parametrize("skip", ["whole_k", "kblocked_128", "kblocked_main"])
@pytest.mark.parametrize("t", [384, 512, 1536])
def test_kernel_fwd_matches_plain(cuda, dtype, d, skip, t):
    """Both contracts at ring offsets; the K-blocked one at the finest skip
    tiles and at the main path's (512 x 1024 fitted to T, where the exact
    causal stop removes tiles the Pallas skip keeps). T = 384 and 1536 are
    odd multiples of 128. The offsets are every block pair a 4-rank ring of
    T_local = T meets — diagonal, wholly visible (q_offset > k_offset: the
    loop's end clamps to TK) and wholly future — and three more."""
    skip = {"whole_k": (0, 0), "kblocked_128": (128, 128),
            "kblocked_main": (tfa._fit_tile(tfa.FWD_TILE_Q, t),
                              tfa._fit_tile(tfa.FWD_K_BLOCK, t))}[skip]
    g = torch.Generator(cuda).manual_seed(0)
    q, k, v = (torch.randn(4, t, d, generator=g, device=cuda).to(dtype)
               for _ in range(3))
    scale = d ** -0.5
    ring = [(r * t, src * t) for r in range(4) for src in range(4)]
    for offsets in ((1024, 1024), (0, 4096), *ring):
        got = kernels.flash_fwd(q, k, v, *offsets, scale, *skip)
        want = tfa._flash_fwd_plain(q, k, v, *offsets, scale, *skip)
        tol = 1e-4 if dtype == torch.float32 else 1e-2
        assert float((got[1] - want[1]).abs().max()) <= 1e-3
        norm_got = got[0] / got[2].transpose(1, 2).clamp_min(1e-30)
        norm_want = want[0] / want[2].transpose(1, 2).clamp_min(1e-30)
        assert float((norm_got - norm_want).abs().max()) <= tol
        if offsets == (0, 4096) and skip == (0, 0):
            # every row fully masked: m stays NEG_INF, p = exp(0) = 1
            assert torch.all(got[1] == NEG_INF)
            assert torch.all(got[2] == t)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,d", [(torch.float32, 64),
                                     (torch.bfloat16, 64),
                                     (torch.bfloat16, 128)])
@pytest.mark.parametrize("bh,t", [(4, 128), (4, 384), (4, 768), (4, 1536),
                                  (2, 4096)])
def test_kernel_bwd_matches_plain(cuda, dtype, d, bh, t):
    """T = 128 is one dq block (a single 128-key tile, masked in both
    warpgroups); T = 4096 is the long-context length."""
    args = _bwd_args(cuda, dtype, bh, t, d, 1)
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    got = (kernels.flash_bwd_dq(*args), *kernels.flash_bwd_dkdv(*args))
    want = (tfa._flash_dq_plain(*args), *tfa._flash_dkdv_plain(*args))
    for a, b in zip(got, want):
        assert _rel_fro(a, b) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 128])
def test_kernel_bwd_dq_is_deterministic(cuda, d):
    """dq is written once from registers, without atomics: two launches on
    the same inputs agree bit for bit."""
    args = _bwd_args(cuda, torch.bfloat16, 4, 1024, d, 2)
    assert torch.equal(kernels.flash_bwd_dq(*args),
                       kernels.flash_bwd_dq(*args))


@pytest.mark.gpu
def test_kernel_wrappers_refuse_misaligned_tensors(cuda):
    """TMA needs 16-byte aligned bases: a contiguous view one element into
    its storage is refused before any launch."""
    flat = torch.zeros(2 * 128 * 64 + 1, dtype=torch.bfloat16, device=cuda)
    q = flat[1:].view(2, 128, 64)
    k = torch.zeros(2, 128, 64, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="16-byte aligned"):
        kernels.flash_fwd(q, k, k, 0, 0, 0.125)
    rows = torch.zeros(2 * 128 + 1, device=cuda)
    lse = torch.zeros(2, 1, 128, device=cuda)
    with pytest.raises(ValueError, match="16-byte aligned"):
        kernels.flash_bwd_dq(q, k, k, k, lse, lse, 0.125)
    with pytest.raises(ValueError, match="16-byte aligned"):
        kernels.flash_bwd_dq(k, k, k, k, rows[1:].view(2, 1, 128), lse,
                             0.125)


@pytest.mark.gpu
def test_kernel_launch_counters(cuda):
    q, k, v = (torch.randn(1, 256, 2, 64, device=cuda, requires_grad=True)
               for _ in range(3))
    kernels.reset_launch_counts()
    tfa.make_flash_attention()(q, k, v).sum().backward()
    assert kernels.LAUNCHES == {"flash_fwd_whole_k": 1,
                                "flash_fwd_kblocked": 0,
                                "flash_bwd_dq": 1, "flash_bwd_dkdv": 1}
