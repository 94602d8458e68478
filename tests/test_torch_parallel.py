"""The port's ring and Ulysses attention and its (data, seq, model) train
step against the JAX package.

The port side runs in one world of 8 gloo processes
(``torch_worlds.parallel_world``, started once for the module); the JAX
side on the 8-device virtual CPU mesh, with Pallas in interpret mode where
the JAX package's own tests use it. Inputs are drawn from a seed with
numpy and handed to both; the JAX model's weights go to the port through
``convert``. The world starts when the first test asks for it and runs
while the JAX side computes. Each tolerance is that of the JAX test making
the same comparison (``tests/test_jaxcheck.py``)."""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from gpumounter_tpu.jaxcheck import model as jmodel
from gpumounter_tpu.jaxcheck import train as jtrain
from gpumounter_tpu.jaxcheck.ring_attention import (
    full_attention, make_sharded_ring_attention)
from gpumounter_tpu.jaxcheck.ulysses import make_ulysses_attention
from gpumounter_tpu_torch.torchcheck import dist as tdist
from gpumounter_tpu_torch.torchcheck import model as tmodel
from gpumounter_tpu_torch.torchcheck import ring_attention as tring

import torch_worlds

TINY = dict(vocab=64, d_model=64, n_heads=8, n_layers=2, d_ff=128)
JTINY = jmodel.ModelConfig(**TINY)
WORLD_DEADLINE_S = 300


def make_qkv(seed, b=2, t=64, h=4, d=16, with_w=False):
    """(q, k, v[, w]) [B, T, H, D] f32 from ``seed``."""
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, t, h, d), dtype=np.float32)
                 for _ in range(4 if with_w else 3))


def make_tokens(seed, batch, seq, vocab=TINY["vocab"]):
    """Arithmetic sequences mod ``vocab``, as ``make_batch`` draws them."""
    rng = np.random.default_rng(seed)
    start = rng.integers(0, min(64, vocab), (batch, 1))
    stride = rng.integers(1, 4, (batch, 1))
    return ((start + stride * np.arange(seq)[None]) % vocab).astype(np.int32)


def _seq_mesh():
    return Mesh(np.array(jax.devices()).reshape(8), ("seq",))


def _grads(attn, q, k, v, w):
    return jax.grad(lambda *a: jnp.sum(attn(*a) * w), argnums=(0, 1, 2))(
        q, k, v)


@pytest.fixture(scope="module")
def inputs():
    q, k, v = make_qkv(2, t=32)
    k2, v2 = k.copy(), v.copy()
    k2[:, -1] = v2[:, -1] = 99.0
    return {
        "ring8": make_qkv(0),
        "causal": ((q, k, v), (q, k2, v2)),
        "ring8_grad": make_qkv(9, t=64, with_w=True),
        # T_local = 1024 / 8 = 128, the flash path's sequence multiple
        "pallas8": make_qkv(5, b=1, t=1024, h=2, d=64),
        "pallas8_grad": make_qkv(11, b=1, t=1024, h=2, d=64, with_w=True),
        "uly": make_qkv(6, b=2, t=128, h=8, d=32),
        "uly_flash": make_qkv(14, b=1, t=256, h=8, d=32, with_w=True),
        "composed": make_qkv(1, b=4, t=32, h=4, d=8),
        "train": (jax.tree.map(np.asarray, jmodel.init_params(
            jax.random.PRNGKey(0), JTINY)), make_tokens(1, 4, 32)),
        "logits": (jax.tree.map(np.asarray, jmodel.init_params(
            jax.random.PRNGKey(3), JTINY)), make_tokens(2, 4, 32)),
        "logits_t256": (jax.tree.map(np.asarray, jmodel.init_params(
            jax.random.PRNGKey(4), JTINY)), make_tokens(4, 2, 256)),
    }


class _World:
    """The port's world, started in the background; the first read waits
    for it (rank 0's results: every rank returns the same unsharded
    arrays)."""

    def __init__(self, future):
        self._future = future

    def __getitem__(self, key):
        return self._future.result(timeout=WORLD_DEADLINE_S)[0][key]


@pytest.fixture(scope="module")
def port(inputs):
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        yield _World(pool.submit(
            tdist.run_world, 8, torch_worlds.parallel_world, (inputs, TINY),
            device="cpu", timeout_s=WORLD_DEADLINE_S))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=tol)


def test_ring_matches_jax_ring_8way(inputs, port):
    q, k, v = inputs["ring8"]
    want = make_sharded_ring_attention(_seq_mesh())(q, k, v)
    _close(port["ring8"]["out"], want, 2e-5)
    _close(port["ring8"]["out"], full_attention(q, k, v), 2e-5)


def test_ring_composes_with_data_and_model_axes(inputs, port):
    mesh = jmodel.make_mesh(data=2, model=2)
    ring = make_sharded_ring_attention(mesh, "seq",
                                       spec=P("data", "seq", "model", None))
    q, k, v = inputs["composed"]
    _close(port["composed"]["out"], ring(q, k, v), 2e-5)


def test_ring_is_causal(port):
    """Changing the last key and value must not change earlier outputs."""
    out1, out2 = port["causal"]
    np.testing.assert_allclose(out1[:, :-1], out2[:, :-1], atol=1e-5)
    assert not np.allclose(out1[:, -1], out2[:, -1])


def test_ring_custom_backward_grads_match_jax(inputs, port):
    """The second ring pass (dk/dv travelling with their block) against the
    JAX ring's custom VJP, 8-way."""
    q, k, v, w = inputs["ring8_grad"]
    want = _grads(make_sharded_ring_attention(_seq_mesh()), q, k, v, w)
    for name, g in zip(("dq", "dk", "dv"), want):
        _close(port["ring8_grad"][name], g, 3e-5)


def test_pallas_ring_matches_jax(inputs, port):
    q, k, v = inputs["pallas8"]
    want = make_sharded_ring_attention(_seq_mesh(), block_impl="pallas",
                                       interpret=True)(q, k, v)
    _close(port["pallas8"]["out"], want, 3e-5)


def test_pallas_ring_grads_match_jax(inputs, port):
    q, k, v, w = inputs["pallas8_grad"]
    ring = make_sharded_ring_attention(_seq_mesh(), block_impl="pallas",
                                       interpret=True)
    for name, g in zip(("dq", "dk", "dv"), _grads(ring, q, k, v, w)):
        _close(port["pallas8_grad"][name], g, 5e-5)


def test_ulysses_matches_jax(inputs, port):
    q, k, v = inputs["uly"]
    _close(port["uly"]["out"], make_ulysses_attention(_seq_mesh())(q, k, v),
           2e-5)


def test_ulysses_flash_local_grads_match_jax(inputs, port):
    q, k, v, w = inputs["uly_flash"]
    uly = make_ulysses_attention(_seq_mesh(), local_impl="flash",
                                 interpret=True)
    _close(port["uly_flash"]["out"], uly(q, k, v), 3e-5)
    for name, g in zip(("dq", "dk", "dv"), _grads(uly, q, k, v, w)):
        _close(port["uly_flash"][name], g, 5e-5)


def test_mesh_train_step_matches_jax(inputs, port):
    """Three steps on the (2, 2, 2) mesh: losses within 1e-4 of the JAX
    mesh step's, decreasing, and the first within 5e-3 of the single-device
    step's."""
    _, tokens = inputs["train"]
    mesh = jmodel.make_mesh(data=2, model=2)
    state = jtrain.init_state(jax.random.PRNGKey(0), JTINY, mesh)
    step = jtrain.make_train_step(JTINY, mesh)
    want = []
    for _ in range(3):
        state, loss = step(state, jnp.asarray(tokens))
        want.append(float(loss))
    got = port["train_losses"]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert all(np.isfinite(got)) and got[-1] < got[0]
    single = jtrain.make_train_step(JTINY)
    _, loss1 = single(jtrain.init_state(jax.random.PRNGKey(0), JTINY),
                      jnp.asarray(tokens))
    assert abs(got[0] - float(loss1)) < 5e-3


def test_ulysses_logits_match_ring_and_jax(inputs, port):
    params, tokens = inputs["logits"]
    mesh = jmodel.make_mesh(data=2, model=2)
    want = jmodel.forward(params, jnp.asarray(tokens), JTINY,
                          attn_fn=jmodel.make_attention(mesh, JTINY,
                                                        impl="ulysses"))
    got = port["logits"]
    _close(got["ulysses"], got["ring"], 5e-4)
    _close(got["ulysses"], want, 5e-4)


@pytest.mark.parametrize("impl", ["ring_pallas", "ulysses_flash",
                                  "seq1_ring"])
def test_make_attention_over_a_mesh_matches_jax_forward(inputs, port, impl):
    """``make_attention`` takes a mesh for every sharded impl: the flash
    block ring and flash-local Ulysses on (2, 2, 2), and a seq dim of 1 on
    (2, 1, 4), against the JAX model's unsharded forward (T = 256, so each
    ring shard is 128 long)."""
    params, tokens = inputs["logits_t256"]
    want = jmodel.forward(params, jnp.asarray(tokens), JTINY)
    _close(port["logits_t256"][impl], want, 1e-4)


class _StubMesh:
    """What make_attention reads of a DeviceMesh, for its argument checks."""
    mesh_dim_names = ("data", "seq", "model")

    def __init__(self, shape):
        self.shape = shape

    def get_group(self, name):
        return None


def test_make_attention_checks_its_arguments():
    cfg = tmodel.ModelConfig(**dict(TINY, n_heads=6, d_model=48))
    with pytest.raises(ValueError, match="divisible by model"):
        tmodel.make_attention(_StubMesh((1, 2, 2)), cfg, "ulysses")
    with pytest.raises(ValueError, match="unknown"):
        tmodel.make_attention(_StubMesh((1, 2, 1)), cfg, "nope")
    with pytest.raises(ValueError, match="takes no mesh"):
        tmodel.make_attention(_StubMesh((1, 2, 1)), cfg, "flash")
    assert tmodel.make_attention(_StubMesh((2, 1, 2)), cfg, "ring") is \
        tring.full_attention
    assert tring.sequence_sharding() == (None, "seq", None, None)
