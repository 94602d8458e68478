"""A bf16 train state on the card survives the sharded drain and restore
bitwise, in a world of one over NCCL, and its root meets the checkpoint
invariants of ``testing/chaos.py`` (the card's side of
``tests/test_torch_drain.py``; this file imports no jax)."""

import pytest
import torch

from gpumounter_tpu_torch.testing.chaos import assert_checkpoint_invariants
from gpumounter_tpu_torch.torchcheck import drain as drain_lib
from gpumounter_tpu_torch.torchcheck import elastic
from gpumounter_tpu_torch.torchcheck import federation as fed
from gpumounter_tpu_torch.torchcheck import model as tmodel
from gpumounter_tpu_torch.torchcheck import probe
from gpumounter_tpu_torch.torchcheck import train as ttrain


@pytest.fixture
def cuda_world_of_one():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    probe.initialize_distributed(f"127.0.0.1:{fed.free_port()}", 1, 0,
                                 "cuda:0")
    yield torch.device("cuda", 0)
    probe.shutdown_distributed()


@pytest.mark.gpu
def test_bf16_cuda_state_survives_sharded_drain_and_restore(
        cuda_world_of_one, tmp_path):
    device = cuda_world_of_one
    cfg = tmodel.ModelConfig(vocab=64, d_model=128, n_heads=2, n_layers=1,
                             d_ff=256, dtype=torch.bfloat16)
    mesh = tmodel.make_mesh(device=device)
    state = ttrain.init_state(cfg, seed=0, device=device, mesh=mesh)
    step = ttrain.make_train_step(cfg, mesh, attn_impl="flash")
    tokens = ttrain.make_batch(torch.Generator(device).manual_seed(1), 2,
                               128, cfg.vocab)
    for _ in range(2):
        state, _ = step(state, tokens)
    specs = elastic.state_specs(cfg)
    root = str(tmp_path / "ckpt")
    drain_lib.drain_sharded(ttrain.state_tree(state), root, 1, specs=specs,
                            mesh=mesh)
    assert_checkpoint_invariants(root)
    # the drained values (the live tensors move on with the next step)
    tree = drain_lib._map(lambda x: x.clone() if isinstance(
        x, torch.Tensor) else x, ttrain.state_tree(state))
    _, want = step(state, tokens)
    del state
    # leave the world and join a new one in this process
    assert probe.shutdown_distributed() is True
    probe.initialize_distributed(f"127.0.0.1:{fed.free_port()}", 1, 0,
                                 device)
    mesh = tmodel.make_mesh(device=device)
    restored = drain_lib.restore_sharded(root, specs, mesh=mesh,
                                         device=device, expect_generation=1)
    for name, value in tree["params"].items():
        got = restored["params"][name]
        assert got.dtype == torch.bfloat16 and got.device == device
        assert torch.equal(got.view(torch.int16), value.view(torch.int16))
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(restored["opt"][name][key],
                               tree["opt"][name][key])
        assert float(restored["opt"][name]["step"]) == 2.0
    again = ttrain.state_from_tree(cfg, restored, device)
    step = ttrain.make_train_step(cfg, mesh, attn_impl="flash")
    _, loss = step(again, tokens)
    assert abs(float(loss) - float(want)) < 1e-3
