"""Entry points of the port, beside the JAX package's ``__graft_entry__``.

``entry()``                — the flagship model's forward on tiny shapes,
                             with its example arguments.
``dryrun_multichip(n)``    — full sharded training steps over one world
                             of n processes (one per device), covering the
                             five parallel schemes: dp x sp x tp (the
                             flagship transformer, ring attention over
                             ``seq``, the Megatron split over ``model``,
                             the batch over ``data``), ep (expert-parallel
                             MoE, all-to-all dispatch and combine) and pp
                             (GPipe pipeline, gradients through the
                             schedule).

Both run on the GPU unless the caller passes ``device="cpu"`` (then the
world is n gloo processes).
"""

from __future__ import annotations

from typing import Any

import torch

from gpumounter_tpu_torch.torchcheck import resolve_device


def _tiny_cfg():
    from gpumounter_tpu_torch.torchcheck.model import ModelConfig
    return ModelConfig(vocab=64, d_model=64, n_heads=8, n_layers=2, d_ff=128)


def entry(device: str | torch.device = "cuda"):
    """Returns (fn, example_args): the tiny flagship forward
    ``fn(model, tokens) -> logits``."""
    from gpumounter_tpu_torch.torchcheck import model as model_lib
    from gpumounter_tpu_torch.torchcheck import train as train_lib

    dev = resolve_device(device)
    cfg = _tiny_cfg()
    model = model_lib.Transformer(cfg, torch.Generator(dev).manual_seed(0),
                                  dev)
    tokens = train_lib.make_batch(torch.Generator(dev).manual_seed(1), 2, 32,
                                  cfg.vocab)

    def fn(model, tokens):
        return model_lib.forward(model, tokens, cfg)

    return fn, (model, tokens)


def _mesh_dims(n: int) -> tuple[int, int, int]:
    """Factor n into (data, seq, model) using as many distinct parallel
    dims as the device count allows — the dryrun should exercise real
    dp/sp/tp shardings, not degenerate 1-dim meshes."""
    data = 2 if n % 2 == 0 else 1
    model = 2 if n % 4 == 0 else 1
    seq = n // (data * model)
    return data, seq, model


def _dryrun_rank(device: torch.device, n: int,
                 inputs: dict[str, Any] | None) -> dict[str, Any]:
    """One rank of the dryrun. ``inputs`` (numpy trees in the JAX
    package's layout: ``params``, ``tokens``, ``moe_params``, ``moe_x``,
    ``pp_layers``, ``pp_mbs``) replaces the seeded draws, so a test can
    feed both packages one set of weights."""
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    from gpumounter_tpu_torch.torchcheck import convert
    from gpumounter_tpu_torch.torchcheck import dist as dist_lib
    from gpumounter_tpu_torch.torchcheck import model as model_lib
    from gpumounter_tpu_torch.torchcheck import moe as moe_lib
    from gpumounter_tpu_torch.torchcheck import pipeline as pipe_lib
    from gpumounter_tpu_torch.torchcheck import train as train_lib

    def seeded(seed):
        return torch.Generator(device).manual_seed(seed)

    def given(key):
        return convert.tensors_from_jax(inputs[key], device)

    # -- dp x sp x tp: the flagship transformer ---------------------------------
    data, seq, model = _mesh_dims(n)
    mesh = model_lib.make_mesh(data, seq, model, device)
    cfg = _tiny_cfg()
    if inputs is None:
        state = train_lib.init_state(cfg, seed=0, device=device, mesh=mesh)
        tokens = train_lib.make_batch(seeded(1), 2 * data, 16 * seq,
                                      cfg.vocab)
    else:
        net = convert.load_jax_params(
            model_lib.Transformer(cfg, device=device), inputs["params"])
        model_lib.shard_model(net, mesh)
        state = train_lib.TrainState(net, train_lib.make_optimizer(
            net.parameters()))
        tokens = given("tokens").long()
    step = train_lib.make_train_step(cfg, mesh)
    state, loss = step(state, dist_lib.shard(tokens, mesh, ("data", "seq")))
    loss = float(loss)
    if not loss > 0:
        raise RuntimeError(f"bad loss {loss}")

    # -- ep: expert-parallel MoE over (data, expert) ----------------------------
    ep_data = 2 if n % 2 == 0 else 1
    n_experts = max(1, n // ep_data)
    ep_mesh = init_device_mesh(device.type, (ep_data, n_experts),
                               mesh_dim_names=(moe_lib.DATA_AXIS,
                                               moe_lib.EXPERT_AXIS))
    moe_cfg = moe_lib.MoEConfig(d_model=32, d_ff=64, n_experts=n_experts)
    if inputs is None:
        moe_params = moe_lib.init_moe_params(moe_cfg, seeded(2), device)
        moe_x = torch.randn((2 * ep_data, 16, moe_cfg.d_model),
                            generator=seeded(3), device=device)
    else:
        moe_params, moe_x = given("moe_params"), given("moe_x")
    moe_step = moe_lib.make_moe_train_step(moe_cfg, ep_mesh)
    _, moe_loss = moe_step(moe_lib.with_expert_sharding(ep_mesh, moe_params),
                           dist_lib.shard(moe_x, ep_mesh,
                                          (moe_lib.DATA_AXIS,)))
    moe_loss = float(moe_loss)
    if not moe_loss > 0:
        raise RuntimeError(f"bad moe loss {moe_loss}")

    # -- pp: GPipe pipeline over the first n_stages ranks -----------------------
    n_stages = 4 if n % 4 == 0 else (2 if n % 2 == 0 else 1)
    pp_loss = None
    if n_stages > 1:
        # every rank takes part in making the group; its stages run it
        pp_mesh = DeviceMesh(device.type, torch.arange(n_stages),
                             mesh_dim_names=(pipe_lib.PIPE_AXIS,))
        if torch.distributed.get_rank() < n_stages:
            if inputs is None:
                layers = pipe_lib.make_mlp_layers(2 * n_stages, 16,
                                                  seeded(10), device)
                mbs = torch.randn((4, 2, 16), generator=seeded(4),
                                  device=device)
            else:
                layers, mbs = given("pp_layers"), given("pp_mbs")
            stacked = pipe_lib.place_stage_params(
                pp_mesh, pipe_lib.stack_stage_params(layers, n_stages))
            _, pp_loss = pipe_lib.make_pipeline_train_step(pp_mesh)(stacked,
                                                                    mbs)
            pp_loss = float(pp_loss)
            if not pp_loss > 0:
                raise RuntimeError(f"bad pp loss {pp_loss}")
    return {"mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)), "loss": loss,
            "ep_mesh": dict(zip(ep_mesh.mesh_dim_names, ep_mesh.shape)),
            "moe_loss": moe_loss, "pp_stages": n_stages, "pp_loss": pp_loss}


def _dryrun(n_devices: int, device: str | torch.device = "cuda",
            inputs: dict[str, Any] | None = None) -> dict[str, Any]:
    from gpumounter_tpu_torch.torchcheck import dist as dist_lib

    # run_world raises when more GPUs are asked for than are visible
    result = dist_lib.run_world(n_devices, _dryrun_rank, (n_devices, inputs),
                                device=device)[0]
    result["degenerate_single_device"] = n_devices == 1
    return result


def dryrun_multichip(n_devices: int, device: str | torch.device = "cuda"
                     ) -> dict[str, Any]:
    """Full sharded training steps of the five parallel schemes over one
    world of ``n_devices`` processes (NCCL, one GPU each; gloo for
    ``device="cpu"``), weights drawn from fixed seeds. Prints the JAX
    dryrun's ``dryrun_multichip ok: ...`` line and returns its numbers; a
    world of one is marked ``degenerate_single_device`` (nothing crossed a
    link)."""
    r = _dryrun(n_devices, device)
    print(_ok_line(r))
    return r


def _ok_line(r: dict[str, Any]) -> str:
    pp = "skipped" if r["pp_loss"] is None else f"{r['pp_loss']:.4f}"
    return (f"dryrun_multichip ok: dp/sp/tp mesh={r['mesh']} "
            f"loss={r['loss']:.4f} | ep mesh={r['ep_mesh']} "
            f"moe_loss={r['moe_loss']:.4f} | pp stages={r['pp_stages']} "
            f"pp_loss={pp}")
