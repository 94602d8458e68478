"""The port's model, train step and perf helpers against the JAX package.

The JAX parameters are carried into the port with ``params_from_jax`` and
the JAX ``make_batch`` tokens are fed to both (``jax.random`` and
``torch.Generator`` differ for one seed). f32 on the CPU; the flash path
runs the Pallas kernels in interpret mode on the JAX side and the plain
kernel versions on the port's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from gpumounter_tpu.jaxcheck import model as jmodel
from gpumounter_tpu.jaxcheck import perf as jperf
from gpumounter_tpu.jaxcheck import train as jtrain
from gpumounter_tpu.jaxcheck.pallas_attention import make_flash_attention
from gpumounter_tpu_torch.torchcheck import convert
from gpumounter_tpu_torch.torchcheck import model as tmodel
from gpumounter_tpu_torch.torchcheck import perf as tperf
from gpumounter_tpu_torch.torchcheck import train as ttrain

# head_dim 64; T=128 is one TILE_Q, the flash path's sequence multiple
JCFG = jmodel.ModelConfig(vocab=64, d_model=128, n_heads=2, n_layers=2,
                          d_ff=256)
TCFG = tmodel.ModelConfig(vocab=64, d_model=128, n_heads=2, n_layers=2,
                          d_ff=256)


def _jax_params(seed=0):
    params = jmodel.init_params(jax.random.PRNGKey(seed), JCFG)
    return params, jax.tree.map(np.asarray, params)


def _tokens(batch=2, seq=128):
    return np.array(jtrain.make_batch(jax.random.PRNGKey(1), batch, seq,
                                       JCFG.vocab))


def _port_model(np_params):
    model = tmodel.Transformer(TCFG, device="cpu")
    return convert.load_jax_params(model, np_params)


def _jax_attn(impl):
    return (make_flash_attention(interpret=True) if impl == "flash"
            else None)


def test_state_dict_names_and_shapes_match_jax_pytree():
    _, np_params = _jax_params()
    state = convert.params_from_jax(np_params)
    own = tmodel.Transformer(TCFG, device="cpu").state_dict()
    assert set(state) == set(own)
    for name, value in state.items():
        assert tuple(value.shape) == tuple(own[name].shape), name
    assert tuple(own["layers.1.wqkv"].shape) == (128, 3, 2, 64)
    assert tuple(own["layers.0.wo"].shape) == (2, 64, 128)


def test_params_from_jax_carries_bfloat16_bits():
    x = jnp.asarray([1.0, -2.5, 3.140625], jnp.bfloat16)
    tree = {"embed": np.asarray(x), "lm_head": np.asarray(x),
            "ln_f": {"g": np.asarray(x)}, "layers": []}
    state = convert.params_from_jax(tree)
    assert state["embed"].dtype == torch.bfloat16
    assert state["embed"].float().tolist() == [1.0, -2.5, 3.140625]


@pytest.mark.parametrize("impl", ["full", "flash"])
def test_logits_match_jax(impl):
    params, np_params = _jax_params()
    tokens = _tokens()
    want = jmodel.forward(params, jnp.asarray(tokens), JCFG,
                          attn_fn=_jax_attn(impl))
    model = _port_model(np_params)
    attn = tmodel.make_attention(None, TCFG, impl)
    with torch.no_grad():
        got = model(torch.from_numpy(tokens).long(), attn)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("impl", ["full", "flash"])
def test_loss_trajectory_matches_jax(impl):
    """Four AdamW steps on identical weights and tokens give the same
    losses in both packages (relative 1e-4)."""
    tokens = _tokens()
    jax_impl = "flash" if impl == "flash" else "ring"   # ring -> full, no mesh
    state = jtrain.init_state(jax.random.PRNGKey(0), JCFG)
    np_params = jax.tree.map(np.asarray, state.params)
    step = jtrain.make_train_step(JCFG, attn_impl=jax_impl)
    want = []
    for _ in range(4):
        state, loss = step(state, jnp.asarray(tokens))
        want.append(float(loss))

    model = _port_model(np_params)
    tstate = ttrain.TrainState(model, ttrain.make_optimizer(
        model.parameters()))
    tstep = ttrain.make_train_step(TCFG, attn_impl=impl)
    got = []
    for _ in range(4):
        tstate, loss = tstep(tstate, torch.from_numpy(tokens).long())
        got.append(float(loss))
    assert tstate.step == 4
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0]


def test_forward_is_causal():
    model = tmodel.Transformer(TCFG, torch.Generator().manual_seed(3),
                               device="cpu")
    tokens = torch.from_numpy(_tokens(1, 128)).long()
    attn = tmodel.make_attention(None, TCFG, "flash")
    with torch.no_grad():
        a = model(tokens, attn)
        tokens2 = tokens.clone()
        tokens2[0, -1] = (tokens2[0, -1] + 1) % TCFG.vocab
        b = model(tokens2, attn)
    np.testing.assert_allclose(a[:, :-1].numpy(), b[:, :-1].numpy(),
                               atol=1e-5)
    assert not torch.allclose(a[:, -1], b[:, -1])


def test_gelu_is_the_tanh_approximation():
    """jax.nn.gelu defaults to approximate=True; the port must use the tanh
    form, which differs from the exact erf form."""
    x = np.linspace(-4, 4, 257, dtype=np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    tanh = F.gelu(torch.from_numpy(x), approximate="tanh").numpy()
    exact = F.gelu(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(tanh, want, atol=1e-6)
    assert np.abs(exact - want).max() > 1e-4


def test_rmsnorm_casts_rsqrt_to_input_dtype():
    """The variance is f32 but its rsqrt is cast back to x's dtype: a bf16
    model stays bf16 (an f32 factor would promote the activations)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 64), dtype=np.float32)
    g = rng.standard_normal(64, dtype=np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    gb = torch.from_numpy(g).to(torch.bfloat16)
    got = tmodel._rmsnorm(xb, gb)
    assert got.dtype == torch.bfloat16
    want = jmodel._rmsnorm(jnp.asarray(x, jnp.bfloat16),
                           jnp.asarray(g, jnp.bfloat16))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=1e-2,
                               atol=1e-2)
    np.testing.assert_allclose(
        tmodel._rmsnorm(torch.from_numpy(x), torch.from_numpy(g)).numpy(),
        np.asarray(jmodel._rmsnorm(jnp.asarray(x), jnp.asarray(g))),
        atol=1e-6)


def _norm_inputs(shape, dtype, seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=gen, dtype=torch.float64) * 2
    g = torch.randn(shape[-1], generator=gen, dtype=torch.float64)
    dy = torch.randn(shape, generator=gen, dtype=torch.float64)
    return x.to(dtype), g.to(dtype), dy.to(dtype)


def _rstd(x):
    """Each row's f32 rsqrt, as the forward kernel saves it."""
    return torch.rsqrt(x.float().square().mean(-1) + 1e-6).reshape(-1)


@pytest.mark.parametrize("shape", [(1, 8), (3, 5, 64), (33, 96), (4, 4096)])
def test_plain_norm_backward_matches_autograd_in_f64(shape):
    """The backward kernel's arithmetic, written out, is the derivative of
    the plain norm: in f64 it matches autograd to 1e-6 relative Frobenius,
    the f32 variance branch both take."""
    x, g, dy = _norm_inputs(shape, torch.float64)
    xl, gl = x.clone().requires_grad_(True), g.clone().requires_grad_(True)
    tmodel._rmsnorm_plain(xl, gl).backward(dy)
    dx, dg = tmodel._rmsnorm_bwd_plain(x, g, _rstd(x), dy)
    assert dx.shape == x.shape and dg.shape == g.shape
    for got, want in ((dx, xl.grad), (dg, gl.grad)):
        assert float((got - want).norm() / want.norm()) <= 1e-6


@pytest.mark.parametrize("shape", [(256, 64), (64, 1024), (16, 4096)])
def test_plain_norm_backward_in_bf16_is_nearer_the_truth_than_autograd(
        shape):
    """In bf16 the kernel's arithmetic (f32 sums, each output rounded
    once) lands no further from the f64 derivative than the plain path's
    bf16 autograd, and within 1e-2 relative Frobenius."""
    x, g, dy = _norm_inputs(shape, torch.bfloat16, seed=1)
    xt, gt = (t.double().requires_grad_(True) for t in (x, g))
    (xt * torch.rsqrt(xt.square().mean(-1, keepdim=True) + 1e-6)
     * gt).backward(dy.double())
    xl, gl = x.clone().requires_grad_(True), g.clone().requires_grad_(True)
    tmodel._rmsnorm_plain(xl, gl).backward(dy)
    dx, dg = tmodel._rmsnorm_bwd_plain(x, g, _rstd(x), dy)
    assert dx.dtype == dg.dtype == torch.bfloat16

    def err(got, want):
        return float((got.double() - want).norm() / want.norm())

    assert err(dx, xt.grad) <= min(err(xl.grad, xt.grad), 1e-2)
    assert err(dg, gt.grad) <= min(err(gl.grad, gt.grad), 1e-2)


def test_cpu_norm_takes_the_plain_path():
    """A CPU x runs the plain lines (the numbers the JAX parity tests
    hold) and launches no kernel."""
    from gpumounter_tpu_torch.torchcheck import kernels
    x, g, dy = _norm_inputs((2, 8, 64), torch.bfloat16)
    kernels.reset_launch_counts()
    xl, gl = x.clone().requires_grad_(True), g.clone().requires_grad_(True)
    y = tmodel._rmsnorm(xl, gl)
    y.backward(dy)
    xp, gp = x.clone().requires_grad_(True), g.clone().requires_grad_(True)
    want = tmodel._rmsnorm_plain(xp, gp)
    want.backward(dy)
    assert torch.equal(y, want)
    assert torch.equal(xl.grad, xp.grad) and torch.equal(gl.grad, gp.grad)
    assert not any(kernels.LAUNCHES.values())


def test_norm_function_wires_the_kernels_into_autograd(monkeypatch):
    """``_RMSNormFn`` with the kernels' plain twins in their place: the
    forward's rsqrt reaches the backward, dy arrives contiguous, and both
    gradients are the backward's."""
    from gpumounter_tpu_torch.torchcheck import kernels
    seen = {}

    def fwd(x, g):
        return tmodel._rmsnorm_plain(x, g), _rstd(x)

    def bwd(x, g, rstd, dy):
        seen.update(rstd=rstd, contiguous=dy.is_contiguous())
        return tmodel._rmsnorm_bwd_plain(x, g, rstd, dy)

    monkeypatch.setattr(kernels, "rmsnorm_fwd", fwd)
    monkeypatch.setattr(kernels, "rmsnorm_bwd", bwd)
    x, g, dy = _norm_inputs((4, 6, 32), torch.bfloat16, seed=2)
    wide = torch.cat([dy, dy], dim=-1)[..., ::2]     # not contiguous
    assert not wide.is_contiguous()
    xl, gl = x.clone().requires_grad_(True), g.clone().requires_grad_(True)
    y = tmodel._RMSNormFn.apply(xl, gl)
    assert torch.equal(y, tmodel._rmsnorm_plain(x, g))
    y.backward(wide)
    assert seen["contiguous"] and torch.equal(seen["rstd"], _rstd(x))
    dx, dg = tmodel._rmsnorm_bwd_plain(x, g, _rstd(x), wide.contiguous())
    assert torch.equal(xl.grad, dx) and torch.equal(gl.grad, dg)


def test_positions_match_jax():
    np.testing.assert_allclose(
        tmodel._positions(128, 64, torch.float32).numpy(),
        np.asarray(jmodel._positions(128, 64, jnp.float32)), atol=1e-6)


def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((2, 16, 64), dtype=np.float32)
    tokens = rng.integers(0, 64, (2, 16))
    want = jtrain.cross_entropy(jnp.asarray(logits), jnp.asarray(tokens))
    got = ttrain.cross_entropy(torch.from_numpy(logits),
                               torch.from_numpy(tokens))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_make_batch_is_arithmetic_mod_vocab():
    """Same data family as the JAX make_batch (which draws from
    jax.random, so the parity tests above feed JAX's tokens instead)."""
    tokens = ttrain.make_batch(torch.Generator().manual_seed(1), 8, 64, 256)
    assert tokens.shape == (8, 64) and tokens.dtype == torch.int64
    diffs = (tokens[:, 1:] - tokens[:, :-1]) % 256
    assert torch.all(diffs == diffs[:, :1])
    assert torch.all((diffs[:, 0] >= 1) & (diffs[:, 0] <= 3))
    assert torch.all(tokens[:, 0] < 64)


def test_make_attention_without_mesh():
    for impl in ("ring", "ulysses", "ulysses_flash", "full"):
        assert tmodel.make_attention(None, TCFG, impl) is \
            tmodel.full_attention
    with pytest.raises(ValueError, match="unknown"):
        tmodel.make_attention(None, TCFG, "nope")


def test_entry_points_raise_without_a_gpu(monkeypatch):
    """Entry points default to the GPU and never fall back to the CPU."""
    from gpumounter_tpu_torch.torchcheck import probe
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: tmodel.Transformer(TCFG),
                 lambda: ttrain.init_state(TCFG),
                 lambda: tperf.measure_train_perf(TCFG, 2, 128),
                 lambda: probe.device_summary(),
                 lambda: probe.validate_training(),
                 lambda: probe.run_probe()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_analytic_flops_match_jax():
    for cfg_t, cfg_j in ((TCFG, JCFG),
                         (tperf.mxu_config(), jperf.mxu_config())):
        for batch, t in ((8, 1024), (2, 4096)):
            assert tperf.analytic_train_flops(cfg_t, batch, t) == \
                jperf.analytic_train_flops(cfg_j, batch, t)


def test_mxu_config_matches_jax():
    t, j = tperf.mxu_config(), jperf.mxu_config()
    for field in ("vocab", "d_model", "n_heads", "n_layers", "d_ff"):
        assert getattr(t, field) == getattr(j, field)
    assert t.dtype == torch.bfloat16 and t.head_dim == 128


def test_chip_peak_lookup():
    assert tperf.chip_peak_tflops("NVIDIA H100 80GB HBM3") == 989.0
    assert tperf.chip_hbm_tb_per_s("NVIDIA H100 80GB HBM3") == 3.35
    assert tperf.chip_peak_tflops("NVIDIA H100 PCIe") is None
    assert tperf.chip_hbm_tb_per_s("cpu") is None
    assert tperf.chip_peak_tflops("cpu") is None


def test_measure_train_perf_smoke_cpu():
    r = tperf.measure_train_perf(TCFG, batch=2, t_len=128, window_a=1,
                                 window_b=3, warmup_steps=1,
                                 attn_impl="flash", device="cpu")
    # window differencing can hit timer noise on a small CPU step; the
    # uncorrected per-step time is the robust positivity check
    assert r["step_ms_incl_sync"] > 0 and r["model_tflops_per_step"] > 0
    assert r["device_kind"] == "cpu" and r["mfu"] is None
    assert r["final_loss"] < r["first_loss"]


def test_measure_train_perf_profile_runs_once_on_its_own_state():
    """The profile hook runs once, after the timed windows, on the step and
    state that were timed, and its result is reported."""
    calls = []

    def profile(step, state, tokens, step_ms):
        calls.append((state.step, tuple(tokens.shape), step_ms))
        step(state, tokens)
        return {"seen": len(calls)}

    r = tperf.measure_train_perf(TCFG, batch=2, t_len=128, window_a=1,
                                 window_b=2, warmup_steps=1,
                                 attn_impl="flash", device="cpu",
                                 profile=profile)
    assert r["profile"] == {"seen": 1}
    (steps_done, shape, step_ms), = calls
    assert steps_done == 1 + 1 + 2 and shape == (2, 128)
    assert step_ms == r["train_step_ms"]
