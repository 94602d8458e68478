"""The port's expert-parallel MoE, GPipe pipeline and multi-scheme dryrun
against the JAX package.

The port's sharded side runs in gloo worlds of 8 processes
(``torch_worlds.moe_pipeline_world`` and the dryrun's own), one after
another in a background thread while the JAX side computes on the
8-device virtual CPU mesh. Inputs are drawn from a seed with numpy; the
JAX package's parameter trees go to the port through
``convert.tensors_from_jax``. Tolerances are those of
``tests/test_moe_pipeline.py``: forward 2e-5, gradients 2e-4."""

import concurrent.futures
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.sharding import Mesh

import __graft_entry__
from gpumounter_tpu.jaxcheck import model as jmodel
from gpumounter_tpu.jaxcheck import moe as jmoe
from gpumounter_tpu.jaxcheck import pipeline as jpipe
from gpumounter_tpu.jaxcheck import train as jtrain
from gpumounter_tpu_torch import entry
from gpumounter_tpu_torch.torchcheck import convert
from gpumounter_tpu_torch.torchcheck import dist as tdist
from gpumounter_tpu_torch.torchcheck import moe as tmoe
from gpumounter_tpu_torch.torchcheck import pipeline as tpipe

import torch_worlds

WORLD_DEADLINE_S = 300
# capacity 6 of 28 tokens over 4 experts: tokens are dropped, so the
# sharded run must count buffer places over the global batch; a data
# shard's 14 tokens split 4, 4, 3, 3 over the expert ranks
SHARDED_MOE = dict(d_model=16, d_ff=32, n_experts=4, capacity_factor=0.75)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _normal(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape,
                                                       dtype=np.float32)


def _moe_loss(params, x, cfg):
    y = jmoe.moe_ffn(params, x, cfg)
    return jnp.mean(jnp.square(y - jnp.roll(x, 1, axis=-2)))


def _seq_loss(layers, mbs):
    h = mbs
    for layer in layers:
        h = jpipe.mlp_block(layer, h)
    return jnp.mean(jnp.square(h - jnp.roll(mbs, 1, axis=-2)))


def _pipe_inputs(n_stages, n_layers, m, seed):
    return {"n_stages": n_stages,
            "layers": _np(jpipe.make_mlp_layers(n_layers, 8,
                                                jax.random.PRNGKey(seed))),
            "mbs": _normal(seed + 1, (m, 2, 8))}


def _dryrun_inputs():
    """The JAX dryrun's own draws at n = 8 (``__graft_entry__``)."""
    cfg = __graft_entry__._tiny_cfg()
    moe_cfg = jmoe.MoEConfig(d_model=32, d_ff=64, n_experts=4)
    return {
        "params": _np(jmodel.init_params(jax.random.PRNGKey(0), cfg)),
        "tokens": np.asarray(jtrain.make_batch(jax.random.PRNGKey(1), 4, 32,
                                               cfg.vocab)),
        "moe_params": _np(jmoe.init_moe_params(jax.random.PRNGKey(2),
                                               moe_cfg)),
        "moe_x": np.asarray(jax.random.normal(jax.random.PRNGKey(3),
                                              (4, 16, 32))),
        "pp_layers": _np(jpipe.make_mlp_layers(8, 16,
                                               jax.random.PRNGKey(10))),
        "pp_mbs": np.asarray(jax.random.normal(jax.random.PRNGKey(4),
                                               (4, 2, 16))),
    }


@pytest.fixture(scope="module")
def inputs():
    cfg = jmoe.MoEConfig(**SHARDED_MOE)
    return {"moe_params": _np(jmoe.init_moe_params(jax.random.PRNGKey(0),
                                                   cfg)),
            "moe_x": _normal(1, (4, 7, 16)),
            # the cases of the JAX package's pipeline tests
            "pipelines": {"pipe4": _pipe_inputs(4, 8, 6, 0),
                          "pipe4_train": _pipe_inputs(4, 4, 4, 4),
                          "pipe2": _pipe_inputs(2, 4, 4, 2)},
            "dryrun": _dryrun_inputs()}


class _Worlds:
    """The port's worlds, run one after another in the background; a read
    waits for its world."""

    def __init__(self, futures):
        self._futures = futures

    def __getitem__(self, name):
        return self._futures[name].result(timeout=3 * WORLD_DEADLINE_S)


@pytest.fixture(scope="module")
def port(inputs):
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        world = {k: v for k, v in inputs.items() if k != "dryrun"}
        yield _Worlds({
            "moe_pipeline": pool.submit(
                lambda: tdist.run_world(
                    8, torch_worlds.moe_pipeline_world, (world, SHARDED_MOE),
                    device="cpu", timeout_s=WORLD_DEADLINE_S)[0]),
            "dryrun_jax_inputs": pool.submit(entry._dryrun, 8, "cpu",
                                             inputs["dryrun"]),
            "dryrun": pool.submit(entry.dryrun_multichip, 8, "cpu")})


def _close(got, want, rtol, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


# -- MoE, unsharded (this process) --------------------------------------------

def test_moe_identical_experts_match_dense_ffn():
    """Every expert given expert 0's weights and room for every token: the
    mixture is the dense FFN scaled by the router probability, in both
    packages."""
    jcfg = jmoe.MoEConfig(d_model=16, d_ff=32, n_experts=4,
                          capacity_factor=4.0)
    params = jmoe.init_moe_params(jax.random.PRNGKey(0), jcfg)
    params["w1"] = jnp.broadcast_to(params["w1"][0], params["w1"].shape)
    params["w2"] = jnp.broadcast_to(params["w2"][0], params["w2"].shape)
    x = _normal(3, (2, 8, 16))
    want = jmoe.moe_ffn(params, x, jcfg)
    tparams = convert.tensors_from_jax(_np(params))
    got = tmoe.moe_ffn(tparams, torch.from_numpy(x),
                       tmoe.MoEConfig(d_model=16, d_ff=32, n_experts=4,
                                      capacity_factor=4.0))
    dense = F.gelu(torch.from_numpy(x) @ tparams["w1"][0],
                   approximate="tanh") @ tparams["w2"][0]
    gate = torch.softmax(torch.from_numpy(x) @ tparams["router"], -1).amax(
        -1, keepdim=True)
    _close(got.numpy(), (dense * gate).numpy(), 2e-5)
    _close(got.numpy(), want, 2e-5)


def test_moe_capacity_drops_to_zero_output():
    """Over-capacity tokens contribute exactly zero (switch semantics), the
    same tokens in both packages."""
    fields = dict(d_model=8, d_ff=16, n_experts=2, capacity_factor=0.01)
    params = jmoe.init_moe_params(jax.random.PRNGKey(0),
                                  jmoe.MoEConfig(**fields))
    x = _normal(4, (1, 6, 8))
    want = np.asarray(jmoe.moe_ffn(params, x, jmoe.MoEConfig(**fields)))
    got = tmoe.moe_ffn(convert.tensors_from_jax(_np(params)),
                       torch.from_numpy(x), tmoe.MoEConfig(**fields)).numpy()
    nonzero = np.abs(got).reshape(6, 8).sum(-1) > 1e-9
    assert nonzero.sum() <= 2
    _close(got, want, 2e-5)


# -- MoE, expert-sharded over (data 2, expert 4) ------------------------------

def test_moe_expert_sharded_matches_jax(inputs, port):
    cfg = jmoe.MoEConfig(**SHARDED_MOE)
    want = np.asarray(jmoe.moe_ffn(inputs["moe_params"], inputs["moe_x"],
                                   cfg))
    dropped = np.abs(want).reshape(-1, 16).sum(-1) == 0
    assert dropped.any(), "the case must drop tokens"
    _close(port["moe_pipeline"]["moe_out"], want, 2e-5)


def test_moe_sharded_grads_match_jax_unsharded(inputs, port):
    cfg = jmoe.MoEConfig(**SHARDED_MOE)
    loss, grads = jax.value_and_grad(_moe_loss)(inputs["moe_params"],
                                                inputs["moe_x"], cfg)
    got = port["moe_pipeline"]
    _close(got["moe_loss"], loss, 2e-5)
    for name, g in grads.items():
        _close(got["moe_grads"][name], g, 2e-4)


def test_moe_train_step_losses_match_jax(inputs, port):
    """Four SGD steps, expert-sharded in both packages: the same losses
    (relative 1e-4), falling."""
    cfg = jmoe.MoEConfig(**SHARDED_MOE)
    mesh = Mesh(np.array(jax.devices()).reshape(2, 4), ("data", "expert"))
    params = jmoe.with_expert_sharding(mesh, inputs["moe_params"])
    step = jmoe.make_moe_train_step(cfg, mesh)
    want = []
    for _ in range(4):
        params, loss = step(params, inputs["moe_x"])
        want.append(float(loss))
    got = port["moe_pipeline"]["moe_losses"]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0]


# -- pipeline -------------------------------------------------------------------

def test_pipeline_matches_sequential_and_jax(inputs, port):
    """4 stages of 2 layers, 6 microbatches."""
    layers, mbs = (inputs["pipelines"]["pipe4"][k] for k in ("layers",
                                                             "mbs"))
    ref = mbs
    for layer in layers:
        ref = jpipe.mlp_block(layer, ref)
    mesh = Mesh(np.array(jax.devices()[:4]), ("pipe",))
    run = jpipe.make_pipeline(mesh, jpipe.mlp_block)
    stacked = jpipe.place_stage_params(mesh,
                                       jpipe.stack_stage_params(layers, 4))
    got = port["moe_pipeline"]["pipe4"]["out"]
    _close(got, ref, 2e-5)
    _close(got, jax.jit(run)(stacked, mbs), 2e-5)


@pytest.mark.parametrize("key", ["pipe2", "pipe4_train"])
def test_pipeline_gradients_match_sequential(inputs, port, key):
    """The gradients through the schedule's hops and final sum hold the
    sequential model's scale: no stage counts its cotangent twice."""
    case = inputs["pipelines"][key]
    layers, mbs, n_stages = case["layers"], case["mbs"], case["n_stages"]
    ref = jax.grad(_seq_loss)(layers, mbs)
    got = port["moe_pipeline"][key]["grads"]
    per = len(layers) // n_stages
    for i, layer in enumerate(ref):
        stage, idx = divmod(i, per)
        for name in ("w1", "w2"):
            np.testing.assert_allclose(got[name][stage, idx], layer[name],
                                       rtol=2e-4, atol=1e-6,
                                       err_msg=f"layer {i} {name}")


def test_pipeline_train_step_matches_jax(inputs, port):
    """4 stages of 1 layer: three SGD steps, the same losses, falling."""
    layers, mbs = (inputs["pipelines"]["pipe4_train"][k]
                   for k in ("layers", "mbs"))
    mesh = Mesh(np.array(jax.devices()[:4]), ("pipe",))
    stacked = jpipe.place_stage_params(mesh,
                                       jpipe.stack_stage_params(layers, 4))
    step = jpipe.make_pipeline_train_step(mesh)
    want = []
    for _ in range(3):
        stacked, loss = step(stacked, mbs)
        want.append(float(loss))
    got = port["moe_pipeline"]["pipe4_train"]["losses"]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0]


def test_stack_and_place_stage_params_shapes():
    layers = tpipe.make_mlp_layers(4, 8, torch.Generator().manual_seed(0),
                                   device="cpu")
    stacked = tpipe.stack_stage_params(layers, 2)
    assert tuple(stacked["w1"].shape) == (2, 2, 8, 16)
    assert torch.equal(stacked["w2"][1, 0], layers[2]["w2"])
    with pytest.raises(ValueError, match="not divisible"):
        tpipe.stack_stage_params(layers, 3)


# -- the dryrun -----------------------------------------------------------------

def _printed_losses(text):
    line = [s for s in text.splitlines()
            if s.startswith("dryrun_multichip ok:")][-1]
    return line, [float(v) for v in re.findall(r"loss=([0-9.]+)", line)]


def test_dryrun_multichip_matches_jax(port, capsys):
    """The three schemes' first-step losses of the port's dryrun, fed the
    JAX dryrun's own draws, against the JAX dryrun's printed losses (four
    decimals)."""
    __graft_entry__.dryrun_multichip(8)
    line, want = _printed_losses(capsys.readouterr().out)
    got = port["dryrun_jax_inputs"]
    np.testing.assert_allclose([got["loss"], got["moe_loss"],
                                got["pp_loss"]], want, atol=1e-4)
    # the same line but for the losses' last digits
    assert (re.sub(r"loss=[0-9.]+", "loss=", entry._ok_line(got))
            == re.sub(r"loss=[0-9.]+", "loss=", line))


def test_dryrun_multichip_on_cpu(port):
    """The entry point itself, seeded draws, 8 gloo processes."""
    r = port["dryrun"]
    assert r["mesh"] == {"data": 2, "seq": 2, "model": 2}
    assert r["ep_mesh"] == {"data": 2, "expert": 4}
    assert r["pp_stages"] == 4 and not r["degenerate_single_device"]
    for loss in (r["loss"], r["moe_loss"], r["pp_loss"]):
        assert np.isfinite(loss) and loss > 0


def test_mesh_dims_match_jax():
    for n in (1, 2, 3, 4, 6, 8, 12):
        assert entry._mesh_dims(n) == __graft_entry__._mesh_dims(n)
