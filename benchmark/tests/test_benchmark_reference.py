"""The plain reference against the port's training step on the CPU (the
port's plain flash path), and its blocked attention against attention
written out whole."""

import math

import pytest
import torch

from benchmark import check, inputs, run, spec
from benchmark.reference import decoder_lm
from benchmark.tests.tiny import TINY, tiny_root


def _naive_attention(q, k, v):
    t, d = q.shape[1], q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(d)
    mask = torch.ones(t, t, dtype=torch.bool).tril()
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


@pytest.mark.parametrize("q_block,elements", [(2048, 1 << 27), (64, 64 * 200),
                                              (32, 1)])
def test_blocked_attention_matches_attention_written_out(monkeypatch,
                                                         q_block, elements):
    """One block, several blocks of rows, and one head per block."""
    monkeypatch.setattr(decoder_lm, "Q_BLOCK", q_block)
    monkeypatch.setattr(decoder_lm, "BLOCK_ELEMENTS", elements)
    gen = torch.Generator().manual_seed(0)
    q, k, v, do = (torch.randn(2, 192, 3, 16, generator=gen,
                               dtype=torch.float64).float()
                   .requires_grad_(i < 3) for i in range(4))
    num = decoder_lm.Numerics("fp32")
    cache = {}
    with torch.no_grad():
        first = decoder_lm._Attention.apply(q, k, v, num, cache)
    out = decoder_lm._Attention.apply(q, k, v, num, cache)
    assert cache == {} and torch.equal(first, out)
    grads = torch.autograd.grad(out, (q, k, v), do)
    want = _naive_attention(q, k, v)
    want_grads = torch.autograd.grad(want, (q, k, v), do)
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
    for g, w in zip(grads, want_grads):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)


def test_fp8_numerics_round_to_three_mantissa_bits():
    num = decoder_lm.Numerics("fp8")
    x = torch.tensor([1.0, 1.0625, 448.0, -3.3])
    q = num.q(x)
    assert q[0] == 1.0 and q[2] == 448.0
    assert q[1] == 1.0          # 1 + 2^-4 is a tie below e4m3's 1 + 2^-3
    assert abs(q[3] + 3.3) < 3.3 / 8
    assert torch.equal(decoder_lm.Numerics("fp32").q(x), x)


def test_reference_agrees_with_the_ports_step_in_float32(tmp_path):
    """At tiny widths in float32 the port's flash step (plain kernels on
    the CPU) and the reference give the same steps to rounding."""
    root = tiny_root(tmp_path, dtype="float32")
    cell = spec.load_cell(TINY, root)
    device = torch.device("cpu")
    pool = inputs.token_pool(cell.traffic, 512, 11, device)
    state, step = run.build_program(cell, 11, device)
    _, prog = run.program_readings(cell, 11, state, step, pool, device)
    ref = run.reference_readings(cell, 11, pool, device)
    numbers = check.compare(prog, ref)
    assert numbers["loss_gap"] < 1e-6
    assert numbers["grad_gap"] < 1e-5
    assert numbers["change_gap"] < 1e-4
    assert len(ref["losses"]) == run.SETUP_STEPS
    assert ref["losses"][-1] < ref["losses"][0]


def test_reference_state_keeps_the_configured_dtype(tmp_path):
    """In bfloat16 a norm gain at 1 takes no AdamW step of 2e-4 (half its
    spacing below 1 is 2^-9), in the reference as in the port."""
    root = tiny_root(tmp_path)
    cell = spec.load_cell(TINY, root)
    device = torch.device("cpu")
    pool = inputs.token_pool(cell.traffic, 512, 3, device)
    ref = run.reference_readings(cell, 3, pool, device)
    state, step = run.build_program(cell, 3, device)
    _, prog = run.program_readings(cell, 3, state, step, pool, device)
    for name in ("ln_f.g", "layers.0.ln1.g", "layers.1.ln2.g"):
        assert ref["grad_norms"][name] > 0
        assert ref["change_norms"][name] == prog["change_norms"][name] == 0
    assert ref["change_norms"]["layers.0.w1"] > 0
