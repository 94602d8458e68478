"""The frozen work counts against a hand count, the peaks table, and the
inputs a seed makes."""

import math

import pytest
import torch

from benchmark import counts, inputs

TINY = inputs.Dims(vocab=10, d_model=4, n_heads=2, n_layers=3, d_ff=8,
                   dtype=torch.bfloat16)


def test_step_counts_by_hand():
    """d 4, d_ff 8, vocab 10, 3 layers, batch 2 x seq 4 (8 tokens)."""
    c = counts.step_counts(TINY, batch=2, seq=4)
    # per token and layer: qkv 4x12, o 4x4, w1 4x8, w2 8x4 = 128 MACs;
    # the head 4x10 = 40 MACs a token; 2 flops a MAC, x3 with backward
    assert c["gemm_flops"] == 3 * 2 * 8 * (3 * 128 + 40)
    # causal pairs of 4 positions: 4 + 3 + 2 + 1 = 10, not 16; per pair
    # q.k and p.v over both heads: 2 x 2 x d_model = 16 flops, x3
    assert counts.causal_pairs(4) == 10
    assert c["attn_flops"] == 3 * 16 * 10 * 2 * 3
    # q, k, v, o, do, dq, dk, dv: 8 x 8 tokens x 4 x 2 bytes; lse 2 x 2 x
    # 4 x 4 bytes; per layer
    assert c["attn_bytes"] == 3 * (8 * 8 * 4 * 2 + 2 * 2 * 4 * 4)
    assert c["model_flops"] == c["gemm_flops"] + c["attn_flops"]
    assert c["tokens"] == 8


def test_causal_halving_at_a_long_sequence():
    """At 16384 positions the causal count is just over half the square
    (the full square overstates the 1.4B step's work by about 1.38x)."""
    d = inputs.Dims(50304, 2048, 16, 24, 8192, torch.bfloat16)
    c = counts.step_counts(d, 1, 16384)
    full = c["gemm_flops"] + 3 * 4 * 2048 * 16384 ** 2 * 24
    assert counts.causal_pairs(16384) / 16384 ** 2 == pytest.approx(
        0.5, rel=1e-4)
    assert full / c["model_flops"] == pytest.approx(1.38, abs=0.01)


def test_peaks_of_the_card_and_of_an_unknown_one():
    p = counts.peaks("NVIDIA H100 80GB HBM3", "bfloat16")
    assert p == {"flops": 989e12, "bytes": 3.35e12}
    assert counts.peaks("NVIDIA A100-SXM4-80GB", "bfloat16") is None


def test_weights_are_the_seeds_and_made_again_by_group():
    d = inputs.Dims(64, 32, 2, 2, 64, torch.bfloat16)
    a = inputs.make_params(d, 2**31 + 7, "cpu")
    b = inputs.make_params(d, 2**31 + 7, "cpu")
    c = inputs.make_params(d, 2**31 + 8, "cpu")
    assert [n for n, _ in inputs.groups(d)] == ["top", "layer0", "layer1"]
    assert all(torch.equal(a[n], b[n]) for n in a)
    assert not torch.equal(a["layers.1.w1"], c["layers.1.w1"])
    again = inputs.make_group(d, 2**31 + 7, "layer1", "cpu")
    assert all(torch.equal(again[n], a[n]) for n in again)
    assert a["layers.0.wqkv"].shape == (32, 3, 2, 16)
    assert a["layers.0.wo"].shape == (2, 16, 32)
    assert torch.equal(a["ln_f.g"], torch.ones(32, dtype=torch.bfloat16))
    assert a["embed"].float().std().item() == pytest.approx(0.02, rel=0.1)
    assert a["layers.0.w2"].float().std().item() == pytest.approx(
        1 / math.sqrt(64), rel=0.1)


def test_token_pool_is_zipf_and_the_same_size_for_every_seed():
    traffic = {"batch": 2, "seq": 2048, "pool": 4, "zipf_exponent": 1.0}
    a = inputs.token_pool(traffic, 1000, 12345678901, "cpu")
    b = inputs.token_pool(traffic, 1000, 12345678901, "cpu")
    c = inputs.token_pool(traffic, 1000, 5, "cpu")
    assert a.shape == c.shape == (4, 2, 2048)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert 0 <= int(a.min()) and int(a.max()) < 1000
    # Zipf(1) over 1000 ids: id 0 takes 1/H(1000) ~ 13.4% of draws
    share = (a == 0).float().mean().item()
    assert share == pytest.approx(1 / sum(1 / k for k in range(1, 1001)),
                                  abs=0.01)
    rows = a.reshape(-1, 2048)
    assert len({tuple(r.tolist()) for r in rows}) == rows.shape[0]
