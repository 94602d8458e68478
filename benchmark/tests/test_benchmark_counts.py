"""The frozen work counts against a hand count, the peaks table, and the
inputs a seed makes; the dense decoder's program against what the harness
made before it was a program of its own."""

import hashlib
import json
import math

import pytest
import torch

from benchmark import counts, inputs, spec

DECODER = spec.program_module({"program": "decoder_lm"})
TINY = DECODER.Dims(vocab=10, d_model=4, n_heads=2, n_layers=3, d_ff=8,
                    dtype=torch.bfloat16)


def test_step_counts_by_hand():
    """d 4, d_ff 8, vocab 10, 3 layers, batch 2 x seq 4 (8 tokens)."""
    c = DECODER.step_counts(TINY, batch=2, seq=4)
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
    d = DECODER.Dims(50304, 2048, 16, 24, 8192, torch.bfloat16)
    c = DECODER.step_counts(d, 1, 16384)
    full = c["gemm_flops"] + 3 * 4 * 2048 * 16384 ** 2 * 24
    assert counts.causal_pairs(16384) / 16384 ** 2 == pytest.approx(
        0.5, rel=1e-4)
    assert full / c["model_flops"] == pytest.approx(1.38, abs=0.01)


def test_peaks_of_the_card_and_of_an_unknown_one():
    p = counts.peaks("NVIDIA H100 80GB HBM3", "bfloat16")
    assert p == {"flops": 989e12, "bytes": 3.35e12}
    assert counts.peaks("NVIDIA A100-SXM4-80GB", "bfloat16") is None


def test_weights_are_the_seeds_and_made_again_by_group():
    d = DECODER.Dims(64, 32, 2, 2, 64, torch.bfloat16)
    groups = DECODER.groups(d)
    a = inputs.make_params(groups, d.dtype, 2**31 + 7, "cpu")
    b = inputs.make_params(groups, d.dtype, 2**31 + 7, "cpu")
    c = inputs.make_params(groups, d.dtype, 2**31 + 8, "cpu")
    assert [n for n, _ in groups] == ["top", "layer0", "layer1"]
    assert all(torch.equal(a[n], b[n]) for n in a)
    assert not torch.equal(a["layers.1.w1"], c["layers.1.w1"])
    again = inputs.make_group(groups, d.dtype, 2**31 + 7, "layer1", "cpu")
    assert inputs.group_of(groups, "layers.1.w2") == "layer1"
    assert inputs.group_of(groups, "lm_head") == "top"
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


# Recorded with the harness as it was before the dense decoder became a
# program of its own (inputs.make_params(inputs.Dims(...), seed, "cpu"),
# leaves in order: name, shape, dtype, raw bytes).
PARENT_WEIGHTS = {
    torch.bfloat16:
        "cda060b74b0d34fa8f3819f1ab1c53aa786a4c34296ab80ed093f47ceb1ebc27",
    torch.float32:
        "c1feec6224c65a97a81a09f773982d46ff60fc938de87d7f50a61faa5b38879c",
}


def _digest(params: dict[str, torch.Tensor]) -> str:
    h = hashlib.sha256()
    for name, p in params.items():
        h.update(name.encode())
        h.update(str(tuple(p.shape)).encode())
        h.update(str(p.dtype).encode())
        raw = {2: torch.int16, 4: torch.int32}[p.element_size()]
        h.update(p.contiguous().view(raw).numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("dtype", sorted(PARENT_WEIGHTS, key=str), ids=str)
def test_the_decoder_program_draws_the_weights_the_harness_drew(dtype):
    d = DECODER.Dims(64, 32, 2, 2, 64, dtype)
    params = inputs.make_params(DECODER.groups(d), d.dtype, 2**31 + 7, "cpu")
    assert _digest(params) == PARENT_WEIGHTS[dtype]


# counts.step_counts of the harness before the move, at both cells' shapes
# and the left-out 1.4B cell's.
PARENT_COUNTS = {
    ("pythia-6.9b", 1, 8192): (168482977087488.0, 26391500292096.0,
                                8606711808.0, 194874477379584.0, 8192.0),
    ("pythia-6.9b", 4, 2048): (168482977087488.0, 6600290992128.0,
                                8606711808.0, 175083268079616.0, 8192.0),
    ("pythia-1.4b", 1, 16384): (128874788683776.0, 79169669038080.0,
                                 12910067712.0, 208044457721856.0, 16384.0),
}


@pytest.mark.parametrize("config,batch,seq", sorted(PARENT_COUNTS))
def test_the_decoder_program_counts_what_the_harness_counted(config, batch,
                                                             seq):
    body = json.loads((spec.ROOT / spec.PACKAGE / "configs"
                       / f"{config}.json").read_text())
    program = spec.program_module(body)
    c = counts.checked(program.step_counts(program.dims(body), batch, seq))
    want = dict(zip(("gemm_flops", "attn_flops", "attn_bytes",
                     "model_flops", "tokens"),
                    PARENT_COUNTS[config, batch, seq]))
    assert c == want and set(c) == set(counts.KEYS)


def test_counts_without_a_key_are_refused():
    c = DECODER.step_counts(TINY, 2, 4)
    del c["attn_bytes"]
    with pytest.raises(ValueError, match="attn_bytes"):
        counts.checked(c)
